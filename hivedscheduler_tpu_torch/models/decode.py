"""Autoregressive decoding: KV-cache prefill, incremental step and the
``generate`` loop.

Counterpart of ``hivedscheduler_tpu/models/decode.py``, with its choices
kept:

- **Static shapes**: the cache is allocated at ``max_len`` up front and
  attention scores the whole cache under a position mask, so every decode
  step has one shape.
- **Compact GQA cache**: k/v are cached at ``cfg.kv_heads`` ([L, B, M,
  H_kv, D], model dtype) and read by grouped einsums (the group is a
  reshape of q, not a repeat of k/v), so GQA cuts cache memory and bytes
  by H/H_kv.
- **One program for prefill and decode**: ``advance`` takes [B, S] tokens
  at any position; prefill is S = prompt length, decoding S = 1. The
  prefill attends through the same ``_cached_attention`` as the decode
  step, never through the flash kernel, whatever ``attn_impl`` says.

Where the JAX package returns a new cache from ``dynamic_update_slice``,
``advance`` writes the new keys and values into the cache's tensors in
place and returns a ``KVCache`` over the same tensors with the new
``length``; setting ``length`` back (speculative rollback) leaves the
stale entries to the position mask, as in JAX. The loop of ``generate``
runs eagerly on the host, one ``advance`` per token; it syncs with the
device only when its caller reads the tokens.

**Sharded decode** (:func:`make_sharded_generate`, the JAX package's; one
process a GPU): over a ``("dp", "tp")`` serving mesh
(``topology.serving_mesh``), each rank holds its local leaves by
:func:`serving_shardings` and takes a ``shards``
(``parallel.sharding.ServingShards``) through ``advance``: its heads and
the kv cache's kv-head axis stay local, the attention output projection
and the MLP's down projection add their partial sums over tp
(``tp_sum``), MoE experts run their tp slice of the hidden dim (ep = 1:
the serving mesh has no ep), and ``lm_head`` is vocab-sharded: each rank
computes its [B, S, V/tp] logits and the whole logits are all-gathered
(``vocab_gather``), never the weight. The prompt rows split over dp and
the tokens are gathered back; sampled draws are taken over the gathered
batch, so a mesh samples as one device does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from hivedscheduler_tpu_torch.models.transformer import (
    TransformerConfig,
    _moe_mlp,
    _rms_norm,
    _rope,
    check_supported,
    is_quantized_leaf,
    load_weight,
)
from hivedscheduler_tpu_torch.ops.attention import NEG_INF


class KVCache(NamedTuple):
    """Per-layer key/value cache and the number of tokens already absorbed.

    k/v: [n_layers, B, max_len, kv_heads, head_dim] in the model dtype;
    length: a Python int, the same for every sequence of the batch (decode
    assumes an unpadded, position-aligned batch)."""

    k: torch.Tensor
    v: torch.Tensor
    length: int


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  device: str | torch.device = "cpu",
                  kv_heads: Optional[int] = None) -> KVCache:
    """A zero cache; ``kv_heads`` (default ``cfg.kv_heads``) is a tp rank's
    local count on a serving mesh."""
    shape = (cfg.n_layers, batch, max_len, kv_heads or cfg.kv_heads, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=cfg.dtype, device=device),
        v=torch.zeros(shape, dtype=cfg.dtype, device=device),
        length=0,
    )


def embed_tokens(params: Dict[str, Any], tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Token embedding lookup, int8-aware: an int8 table gathers its rows,
    then scales each by its row's scale, so the gather moves int8 bytes."""
    emb = params["embed"]
    if is_quantized_leaf(emb):
        return emb["qi8"][tokens].to(dtype) * emb["scale"][tokens].to(dtype)
    return emb[tokens].to(dtype)


def qkv_proj(lp: Dict[str, Any], h: torch.Tensor, positions: torch.Tensor,
             theta: float, dtype):
    """q/k/v projections and RoPE for one layer."""
    q = torch.einsum("bsd,dhk->bshk", h, load_weight(lp["wq"], dtype))
    k = torch.einsum("bsd,dhk->bshk", h, load_weight(lp["wk"], dtype))
    v = torch.einsum("bsd,dhk->bshk", h, load_weight(lp["wv"], dtype))
    return _rope(q, positions, theta), _rope(k, positions, theta), v


def dense_mlp(lp: Dict[str, Any], h: torch.Tensor, dtype) -> torch.Tensor:
    """SwiGLU MLP for one layer."""
    gate = torch.einsum("bsd,df->bsf", h, load_weight(lp["w_gate"], dtype))
    up = torch.einsum("bsd,df->bsf", h, load_weight(lp["w_up"], dtype))
    return torch.einsum("bsf,fd->bsd", F.silu(gate) * up,
                        load_weight(lp["w_down"], dtype))


def mlp_block(lp: Dict[str, Any], h: torch.Tensor, cfg: TransformerConfig,
              shards=None) -> torch.Tensor:
    """One layer's MLP: SwiGLU, or the MoE layer routed with ``cfg``'s
    capacity (the decode and serving paths pass :func:`inference_moe_cfg`'s
    no-drop one); the MoE aux loss is dropped. int8 expert leaves
    dequantize per expert (``load_weight`` broadcasts the [E, 1, F] scale).
    Under ``shards`` the leaves hold this rank's slice of the hidden dim
    (every expert's), routing runs whole on every rank, and the partial
    outputs are summed over tp."""
    if cfg.n_experts > 0:
        out = _moe_mlp(h, lambda name: load_weight(lp[name], cfg.dtype), cfg)[0]
    else:
        out = dense_mlp(lp, h, cfg.dtype)
    return out if shards is None else shards.tp_sum(out)


def attn_out(lp: Dict[str, Any], attn: torch.Tensor, dtype, shards=None) -> torch.Tensor:
    """The attention output projection; under ``shards`` the local heads'
    partial sums are added over tp."""
    out = torch.einsum("bshk,hkd->bsd", attn, load_weight(lp["wo"], dtype))
    return out if shards is None else shards.tp_sum(out)


def final_logits(params: Dict[str, Any], x: torch.Tensor, dtype,
                 shards=None) -> torch.Tensor:
    """Final RMSNorm and lm_head; the logits come back in f32. Under
    ``shards`` ``lm_head`` holds this rank's vocabulary slice: the local
    logits are computed and the whole ones all-gathered over tp."""
    x = _rms_norm(x, params["final_norm"])
    logits = torch.einsum("bsd,dv->bsv", x,
                          load_weight(params["lm_head"], dtype)).float()
    return logits if shards is None else shards.vocab_gather(logits)


def _cached_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      pos0: int, scale: float) -> torch.Tensor:
    """q: [B, S, H, D] at absolute positions pos0..pos0+S-1; ck/cv: [B, M,
    H_kv, D], the whole cache (entries past the live length sit at
    positions > pos0 + s and are masked by the causal test). Scores and
    p·v are computed in f32, as JAX's ``preferred_element_type=f32`` does.
    Returns [B, S, H, D] in q's dtype."""
    b, s_len, h, d = q.shape
    m_len, h_kv = ck.shape[1], ck.shape[2]
    qg = q.reshape(b, s_len, h_kv, h // h_kv, d)
    s = torch.einsum("bshgd,bmhd->bhgsm", qg.float(), ck.float()) * scale
    key_pos = torch.arange(m_len, device=q.device)
    q_pos = pos0 + torch.arange(s_len, device=q.device)
    mask = key_pos[None, :] <= q_pos[:, None]  # [S, M]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgsm,bmhd->bshgd", p, cv.float())
    return o.reshape(b, s_len, h, d).to(q.dtype)


def inference_moe_cfg(cfg: TransformerConfig) -> TransformerConfig:
    """The JAX package's no-drop inference capacity for MoE: a capacity
    factor of E gives ceil(S k E / E) = S k slots per expert, which holds
    the worst routing skew, so no inference path drops a token (a dropped
    token would change the stream). The one home of the rule for
    ``advance``, ``advance_ragged`` and ``advance_paged``; a dense config
    comes back unchanged."""
    if cfg.n_experts <= 0:
        return cfg
    return dataclasses.replace(
        cfg, expert_capacity_factor=float(max(cfg.n_experts, 1)))


def _layer_params(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of the stacked ``[n_layers]`` leaves, int8 pairs included."""
    return {name: ({k: t[i] for k, t in leaf.items()} if is_quantized_leaf(leaf)
                   else leaf[i])
            for name, leaf in layers.items()}


@torch.no_grad()
def advance(
    params: Dict[str, Any],
    cache: KVCache,
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    shards=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Absorb ``tokens`` [B, S] starting at position ``cache.length`` and
    return (logits [B, S, vocab] f32, the cache with its new length). The
    cache's tensors are written in place. S = prompt length for prefill,
    S = 1 while decoding. MoE layers route with :func:`inference_moe_cfg`'s
    no-drop capacity. ``shards``: the rank's local leaves and cache on a
    serving mesh (module docstring); the logits come back whole."""
    dtype = cfg.dtype
    b, s_len = tokens.shape
    pos0 = cache.length
    if pos0 + s_len > cache.k.shape[2]:
        raise ValueError(f"cache of {cache.k.shape[2]} positions cannot take "
                         f"{s_len} tokens at position {pos0}")
    check_supported(cfg)
    cfg = inference_moe_cfg(cfg)
    x = embed_tokens(params, tokens, dtype)  # [B, S, D]
    positions = (pos0 + torch.arange(s_len, dtype=torch.int32,
                                     device=tokens.device))[None, :]
    scale = 1.0 / math.sqrt(cfg.head_dim)
    for i in range(cfg.n_layers):
        lp = _layer_params(params["layers"], i)
        h = _rms_norm(x, lp["attn_norm"])
        q, k_new, v_new = qkv_proj(lp, h, positions, cfg.rope_theta, dtype)
        ck, cv = cache.k[i], cache.v[i]
        ck[:, pos0:pos0 + s_len] = k_new
        cv[:, pos0:pos0 + s_len] = v_new
        attn = _cached_attention(q, ck, cv, pos0, scale)
        x = x + attn_out(lp, attn, dtype, shards)
        x = x + mlp_block(lp, _rms_norm(x, lp["mlp_norm"]), cfg, shards)
    logits = final_logits(params, x, dtype, shards)
    return logits, KVCache(cache.k, cache.v, pos0 + s_len)


def filter_logits(logits: torch.Tensor, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Top-k then nucleus (top-p) filtering of ``logits`` [..., V]: entries
    outside the top k (``top_k`` > 0) and outside the smallest prefix of
    the sorted distribution whose probability reaches ``top_p`` (``top_p``
    < 1) become NEG_INF. The JAX package's tie rules: every entry equal to
    the k-th value survives top-k, and the most likely entry always
    survives top-p."""
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep every entry up to and including the one that crosses top_p
        keep = (cum - probs) < top_p
        keep[..., 0] = True
        cutoff = torch.where(keep, sorted_logits, math.inf).amin(dim=-1, keepdim=True)
        logits = torch.where(logits < cutoff, NEG_INF, logits)
    return logits


def sample(probs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row of ``probs`` [B, V] (rows need not be normalised)."""
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(
    params: Dict[str, Any],
    prompt: torch.Tensor,
    cfg: TransformerConfig,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
    max_len: Optional[int] = None,
    decode_steps: int = 1,
    shards=None,
) -> torch.Tensor:
    """Greedy (``temperature`` 0) or sampled continuation of ``prompt``
    [B, T], with optional top-k / top-p filtering of the sampled
    distribution. Returns [B, max_new_tokens] in the prompt's dtype.
    Sampling draws from ``generator``, which lives on the prompt's device.

    ``decode_steps`` (>= 1) unrolls the JAX package's decode scan; the
    tokens do not depend on it. Here each token step is its own eager
    ``advance``, so it has no effect.

    ``shards``: on a serving mesh, ``params`` are this rank's local leaves
    and ``prompt`` its dp block of rows; the result is every rank's rows,
    gathered. Each draw is taken over the gathered batch with the same
    generator on every rank, so the stream is the one-device stream."""
    if decode_steps < 1:
        raise ValueError(f"decode_steps must be >= 1, got {decode_steps}")
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) needs a torch.Generator")
    b, t = prompt.shape
    total = t + max_new_tokens
    max_len = total if max_len is None else max_len
    if max_len < total:
        raise ValueError(f"max_len {max_len} < prompt + new tokens {total}")
    kv_heads = cfg.kv_heads // shards.tp if shards is not None else None
    cache = init_kv_cache(cfg, b, max_len, prompt.device, kv_heads)
    logits, cache = advance(params, cache, prompt, cfg, shards)
    last = logits[:, -1]
    toks = []
    for i in range(max_new_tokens):
        if temperature == 0.0:
            tok = torch.argmax(last, dim=-1)
        else:
            tok = draw_rows(torch.softmax(
                filter_logits(last / temperature, top_k, top_p), dim=-1),
                generator, shards)
        toks.append(tok)
        if i + 1 < max_new_tokens:  # the last token's logits are never read
            logits, cache = advance(params, cache, tok[:, None].to(prompt.dtype),
                                    cfg, shards)
            last = logits[:, -1]
    if not toks:
        out = prompt.new_zeros((b, 0))
    else:
        out = torch.stack(toks, dim=1).to(prompt.dtype)
    return out if shards is None else shards.gather_rows(out)


def draw_rows(probs: torch.Tensor, generator: torch.Generator,
              shards=None) -> torch.Tensor:
    """:func:`sample` of this rank's rows: on a mesh with dp above 1 the
    draw is taken over every rank's rows (the same generator state on each
    rank) and this rank keeps its own, so the draw does not depend on dp."""
    if shards is None or shards.dp == 1:
        return sample(probs, generator)
    return shards.local_rows(sample(shards.gather_rows(probs), generator))


def serving_shardings(cfg: TransformerConfig, mesh, *, require: bool = True,
                      quantized: bool = False):
    """Validate ``cfg`` against the serving mesh's tp axis and return the
    layout of the param tree (``transformer.sharding_specs`` laid over
    ``mesh``; ``quantized`` takes ``quant.sharding_specs`` for int8 trees),
    a ``parallel.sharding.ServingLayout`` that gives each rank its local
    leaves of the whole tree. The one home of the serving shard contract:
    heads, vocab and d_ff must divide tp. ``require=False`` returns None
    instead of raising (the speculative draft's replicated fallback)."""
    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.parallel import sharding

    shards = sharding.ServingShards(mesh)
    tp = shards.tp
    if cfg.n_heads % tp or cfg.kv_heads % tp:
        if not require:
            return None
        raise ValueError(
            f"head counts must divide the tp axis: n_heads={cfg.n_heads}, "
            f"kv_heads={cfg.kv_heads}, tp={tp}"
        )
    if cfg.vocab_size % tp or cfg.d_ff % tp:
        if not require:
            return None
        raise ValueError(
            f"vocab_size ({cfg.vocab_size}) and d_ff ({cfg.d_ff}) must "
            f"divide the tp axis ({tp})"
        )
    if quantized:
        from hivedscheduler_tpu_torch.models import quant

        specs = quant.sharding_specs(cfg)
    else:
        specs = tm.sharding_specs(cfg)
    return sharding.ServingLayout(shards, specs)


def make_sharded_generate(
    cfg: TransformerConfig,
    mesh,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    quantized: bool = False,
    decode_steps: int = 1,
):
    """Sharded decode over a ``("dp", "tp")`` serving mesh: returns (run,
    param_layout, prompt_layout), as the JAX package returns (jitted,
    param_shardings, prompt_sharding). ``param_layout(params)`` gives this
    rank's leaves of the whole tree (``quantized``: an int8 tree from
    ``quant.quantize_params``), ``prompt_layout(prompt)`` its dp block of
    the [B, T] prompt rows, and ``run(local_params, local_prompt,
    generator=None)`` the whole [B, max_new_tokens] tokens on every rank
    (``generator`` for temperature > 0, seeded alike on every rank)."""
    param_layout = serving_shardings(cfg, mesh, quantized=quantized)
    shards = param_layout.shards

    def run(params, prompt, generator=None):
        return generate(params, prompt, cfg, max_new_tokens,
                        temperature=temperature, top_k=top_k, top_p=top_p,
                        generator=generator, decode_steps=decode_steps,
                        shards=shards)

    return run, param_layout, shards.local_rows
