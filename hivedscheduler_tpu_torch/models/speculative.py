"""Speculative decoding: a small draft model proposes ``gamma`` tokens a
round, the target verifies them in one ``S = gamma + 1`` step, and
rejection sampling keeps the output distribution the target's.

Counterpart of ``hivedscheduler_tpu/models/speculative.py``, with its rule:
draft token t_j is accepted iff u < p_target(t_j) / p_draft(t_j); on
rejection the replacement is drawn from norm(max(p_target - p_draft, 0));
when all gamma are accepted a bonus token comes from the target's
gamma+1-th distribution. Temperature, top-k and top-p apply to both
models' logits. Greedy output equals greedy ``decode.generate``'s.

The whole batch moves by the round's smallest accepted prefix n; tokens a
sequence accepted past n are still emitted as they were drafted. Both
caches roll back by setting ``length``: the stale entries stay, masked by
position. The rounds are a host loop; reading n is the one device sync a
round (the counterpart of JAX's ``while_loop`` condition).

On a ``("dp", "tp")`` serving mesh (:func:`make_sharded_speculative`) the
target runs tensor-parallel as ``decode.make_sharded_generate``'s model
does; the draft shards the same way when its head counts divide tp
(:func:`draft_serving_shardings`) and is replicated otherwise, so its
steps issue no collective. Each rank holds its dp block of rows; n is the
least over every rank's rows (an all-reduce over dp), and every random
draw is taken over the gathered batch, so the output does not depend on
the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from hivedscheduler_tpu_torch.models.decode import (
    KVCache,
    advance,
    draw_rows,
    filter_logits,
    init_kv_cache,
    serving_shardings,
)
from hivedscheduler_tpu_torch.models.transformer import TransformerConfig


@dataclasses.dataclass(frozen=True)
class SpecDecodeConfig:
    """A draft model and its proposals per verify round, as the serving
    engine takes them."""

    draft_params: Any
    draft_cfg: TransformerConfig
    gamma: int = 4


class SpecStats(NamedTuple):
    """Counters of one run: verification rounds, draft tokens proposed,
    draft tokens accepted (acceptance rate = accepted / drafted)."""

    rounds: int
    drafted: int
    accepted: int


def derive_draft_config(
    cfg: TransformerConfig, draft_layers: int, draft_d_model: int = 0
) -> TransformerConfig:
    """The CLIs' draft model: about half the target's width, rounded up so
    head_dim stays even (RoPE rotates pairs), dense MLP at 2x width (an MoE
    target gets a dense draft), MHA.
    Raises ValueError when an explicit ``draft_d_model`` gives an odd
    head_dim."""
    quantum = 2 * cfg.n_heads
    d_model = draft_d_model or max(64, cfg.d_model // 2)
    if not draft_d_model:
        d_model = -(-d_model // quantum) * quantum
    if d_model % quantum:
        raise ValueError(
            f"draft d_model {d_model} must be a multiple of 2*n_heads "
            f"({quantum}): RoPE needs an even head_dim"
        )
    return dataclasses.replace(
        cfg, n_layers=draft_layers, d_model=d_model, d_ff=2 * d_model,
        n_experts=0, n_kv_heads=0,
    )


@torch.no_grad()
def generate_speculative(
    target_params: Dict[str, Any],
    draft_params: Dict[str, Any],
    prompt: torch.Tensor,
    target_cfg: TransformerConfig,
    draft_cfg: TransformerConfig,
    max_new_tokens: int,
    *,
    gamma: int = 4,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
    shards=None,
    draft_shards=None,
) -> Tuple[torch.Tensor, SpecStats]:
    """Speculative continuation of ``prompt`` [B, T] -> ([B,
    max_new_tokens], SpecStats). ``temperature`` 0 decodes greedily;
    sampling draws from ``generator`` (on the prompt's device). The two
    configs must share the vocab. ``shards``: on a serving mesh, the
    target's local leaves and this rank's dp block of prompt rows;
    ``draft_shards`` is ``shards`` for a sharded draft and None for a
    replicated one. The tokens come back whole on every rank."""
    if target_cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError(f"vocabs must match: target {target_cfg.vocab_size}, "
                         f"draft {draft_cfg.vocab_size}")
    if gamma < 1:
        raise ValueError(f"gamma must be >= 1, got {gamma}")
    greedy = temperature == 0.0
    if not greedy and generator is None:
        raise ValueError("sampling (temperature > 0) needs a torch.Generator")
    b, t = prompt.shape
    device = prompt.device
    # headroom: a round absorbs gamma+1 tokens past the accepted prefix
    # before it rolls back
    max_len = t + max_new_tokens + gamma + 1

    def probs_of(logits):
        if greedy:
            return torch.softmax(logits, dim=-1)
        return torch.softmax(filter_logits(logits / temperature, top_k, top_p), dim=-1)

    def pick(p):
        return torch.argmax(p, dim=-1) if greedy else draw_rows(p, generator, shards)

    def uniforms(shape):
        # drawn for every rank's rows, this rank keeping its own
        if shards is None or shards.dp == 1:
            return torch.rand(shape, generator=generator, device=device)
        full = torch.rand((shape[0] * shards.dp,) + shape[1:], generator=generator,
                          device=device)
        return shards.local_rows(full)

    def local_kv(cfg, sh):
        return cfg.kv_heads // sh.tp if sh is not None else None

    def tgt_step(cache, toks):
        return advance(target_params, cache, toks, target_cfg, shards)

    def dft_step(cache, toks):
        return advance(draft_params, cache, toks, draft_cfg, draft_shards)

    # both caches absorb the prompt; from here on both hold the same prefix
    # and last_tok is not absorbed yet
    tgt_cache = init_kv_cache(target_cfg, b, max_len, device,
                              local_kv(target_cfg, shards))
    dft_cache = init_kv_cache(draft_cfg, b, max_len, device,
                              local_kv(draft_cfg, draft_shards))
    tgt_logits, tgt_cache = tgt_step(tgt_cache, prompt)
    _, dft_cache = dft_step(dft_cache, prompt)
    last_tok = pick(probs_of(tgt_logits[:, -1]))

    buf = torch.zeros((b, max_new_tokens + gamma + 1), dtype=torch.int64, device=device)
    buf[:, 0] = last_tok
    cols = torch.arange(gamma + 1, device=device)[None, :]
    n_out, rounds, accepted = 1, 0, 0
    while n_out < max_new_tokens:
        # draft: gamma single-token steps, then one more so that the draft
        # cache absorbs its own last proposal (needed when all are accepted)
        tok, drafted_toks, p_d = last_tok, [], []
        for _ in range(gamma):
            logits, dft_cache = dft_step(dft_cache, tok[:, None])
            p = probs_of(logits[:, -1])
            tok = pick(p)
            drafted_toks.append(tok)
            p_d.append(p)
        _, dft_cache = dft_step(dft_cache, tok[:, None])
        t_draft = torch.stack(drafted_toks, dim=1)  # [B, gamma]
        p_d = torch.stack(p_d, dim=1)  # [B, gamma, V]

        # target: verify every proposal in one S = gamma+1 step
        tgt_in = torch.cat([last_tok[:, None], t_draft], dim=1)
        tgt_logits, tgt_cache = tgt_step(tgt_cache, tgt_in)
        p_t = probs_of(tgt_logits)  # [B, gamma+1, V]

        # acceptance: n_i accepted prefix per sequence, n the batch's least
        if greedy:
            acc = t_draft == torch.argmax(p_t[:, :gamma], dim=-1)
        else:
            pt_tok = torch.gather(p_t[:, :gamma], -1, t_draft[..., None])[..., 0]
            pd_tok = torch.gather(p_d, -1, t_draft[..., None])[..., 0]
            u = uniforms(tuple(t_draft.shape))
            acc = u * pd_tok < pt_tok
        n_i = torch.cumprod(acc.to(torch.int32), dim=1).sum(dim=1)  # [B]
        n_min = n_i.min().reshape(1)
        if shards is not None:
            n_min = shards.min_over_dp(n_min)  # the least over every rank's rows
        n = int(n_min)  # the round's host sync

        # emit n accepted draft tokens and one correction or bonus token
        if greedy:
            emit = torch.argmax(p_t, dim=-1)  # [B, gamma+1]
        else:
            # residual draw at column n for sequences rejected there; those
            # whose own acceptance went past n keep their draft token. p_d
            # padded with a zero row makes the residual at n == gamma the
            # plain bonus distribution p_t[gamma]
            p_t_n = p_t[:, n]
            residual = torch.clamp_min(p_t_n - F.pad(p_d, (0, 0, 0, 1))[:, n], 0.0)
            # a draft equal to the target leaves an empty residual; fall
            # back to the target (a rejection there has probability 0)
            residual = torch.where(residual.sum(-1, keepdim=True) > 0, residual, p_t_n)
            resample = draw_rows(residual, generator, shards)
            t_pad = F.pad(t_draft, (0, 1))
            at_n = torch.where(n_i > n, t_pad[:, n], resample)
            emit = torch.where(cols < n, t_pad, at_n[:, None])
        buf[:, n_out:n_out + gamma + 1] = emit
        last_tok = emit[:, n]

        # roll both caches back to the accepted prefix (last_tok and
        # t_0..t_{n-1}); stale entries past length are masked by position
        length = tgt_cache.length - (gamma + 1) + (n + 1)
        tgt_cache = KVCache(tgt_cache.k, tgt_cache.v, length)
        dft_cache = KVCache(dft_cache.k, dft_cache.v, length)
        rounds += 1
        accepted += n
        n_out += n + 1
    stats = SpecStats(rounds=rounds, drafted=gamma * rounds, accepted=accepted)
    out = buf[:, :max_new_tokens].to(prompt.dtype)
    return (out if shards is None else shards.gather_rows(out)), stats


def draft_serving_shardings(draft_cfg: TransformerConfig, mesh):
    """The one home of the draft's shard-or-replicate policy: the (small)
    draft shards tensor-parallel when its head counts (and vocab and d_ff)
    divide tp, and is replicated otherwise, which costs its small weights
    on every rank but keeps each draft step free of collectives. Returns
    (layout, sharded)."""
    from hivedscheduler_tpu_torch.parallel import sharding

    layout = serving_shardings(draft_cfg, mesh, require=False)
    if layout is not None:
        return layout, True
    return sharding.ServingLayout(sharding.ServingShards(mesh), None), False


def make_sharded_speculative(
    target_cfg: TransformerConfig,
    draft_cfg: TransformerConfig,
    mesh,
    max_new_tokens: int,
    *,
    gamma: int = 4,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    quantized_target: bool = False,
):
    """Speculative decoding over a ``("dp", "tp")`` serving mesh: returns
    (run, target_layout, draft_layout, prompt_layout), as the JAX package
    returns (jitted_run, target_shardings, draft_shardings,
    prompt_sharding). The target (an int8 tree with ``quantized_target``)
    is laid out as ``decode.make_sharded_generate``'s model; the draft by
    :func:`draft_serving_shardings`. ``run(target_local, draft_local,
    prompt_local, generator=None)`` -> (the whole [B, max_new_tokens]
    tokens, SpecStats) on every rank."""
    target_layout = serving_shardings(target_cfg, mesh, quantized=quantized_target)
    draft_layout, sharded = draft_serving_shardings(draft_cfg, mesh)
    shards = target_layout.shards

    def run(target_params, draft_params, prompt, generator=None):
        return generate_speculative(
            target_params, draft_params, prompt, target_cfg, draft_cfg,
            max_new_tokens, gamma=gamma, temperature=temperature, top_k=top_k,
            top_p=top_p, generator=generator, shards=shards,
            draft_shards=shards if sharded else None)

    return run, target_layout, draft_layout, shards.local_rows
