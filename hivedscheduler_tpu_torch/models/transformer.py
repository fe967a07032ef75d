"""Flagship workload: the decoder-only transformer LM, in PyTorch.

Counterpart of ``hivedscheduler_tpu/models/transformer.py``: RoPE (on
interleaved even/odd pairs), RMSNorm, SwiGLU, grouped-query attention, bf16
matmuls with f32 master weights. The model state is a plain dict of tensors
with the JAX package's tree: ``embed``, ``final_norm``, ``lm_head`` and
``layers``, whose leaves carry a leading ``[n_layers]`` axis, so
``bridge.py`` carries weights across unchanged and both packages compute
with the same numbers.

Ported: the dense forward with every ``attn_impl`` (``xla``, ``flash``
and the sequence-parallel family of ``parallel/ring_attention.py``),
differentiable, with the ``remat`` policies of the layer loop, on one
device or over a six-axis ``DeviceMesh`` with dp, fsdp, tp and sp above 1
(``sharding_specs`` gives each leaf's layout; ``parallel/sharding.py``
holds the collectives). The ring family needs a mesh, as in the JAX
package; a mesh of one device is enough. MoE, LoRA, pipelining (pp),
expert parallelism (ep) and the overlapped tensor-parallel stack raise
"not yet ported".
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from hivedscheduler_tpu_torch.parallel import sharding


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's ``TransformerConfig``, field for field (a test
    pins the names); ``dtype`` is a torch dtype."""

    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 1408
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16
    # "xla" | "flash" | the ring family (RING_FAMILY, which needs a mesh)
    attn_impl: str = "xla"
    n_experts: int = 0
    expert_capacity_factor: float = 1.25
    moe_top_k: int = 1
    moe_aux_weight: float = 0.01
    moe_zloss_weight: float = 0.0
    pipeline_microbatches: int = 0
    # what a backward pass recomputes (the layer loop's checkpointing):
    # "full" whole layers, "dots" all but the matmul outputs, "none" nothing
    remat: str = "full"
    # decide, as in the JAX package, which shapes take the flash kernel
    attn_block_q: int = 128
    attn_block_k: int = 128
    overlap: Optional[bool] = None
    # grouped-query attention: shared k/v heads (0 = n_heads); q head i
    # attends with k/v head i // (n_heads // n_kv_heads)
    n_kv_heads: int = 0
    lora_rank: int = 0
    lora_alpha: float = 16.0
    lora_mlp: bool = False

    @property
    def head_dim(self) -> int:
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model {self.d_model} not divisible by n_heads {self.n_heads}"
            )
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        n_kv = self.n_kv_heads or self.n_heads
        if self.n_heads % n_kv:
            raise ValueError(
                f"n_heads {self.n_heads} not divisible by n_kv_heads {n_kv}"
            )
        return n_kv


ATTN_IMPLS = ("xla", "flash", "ring", "ring_flash", "ring_zigzag",
              "ring_zigzag_flash", "ulysses")
RING_FAMILY = ("ring", "ring_flash", "ring_zigzag", "ring_zigzag_flash",
               "ulysses")
REMAT_POLICIES = ("full", "dots", "none")


def _not_yet_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not yet ported to hivedscheduler_tpu_torch"
    )


def check_supported(cfg: TransformerConfig) -> None:
    """Raise for every configuration the port does not run yet."""
    if cfg.n_experts > 0:
        raise _not_yet_ported("MoE (n_experts > 0)")
    if cfg.lora_rank > 0 or cfg.lora_mlp:
        raise _not_yet_ported("LoRA")
    if cfg.pipeline_microbatches > 0:
        raise _not_yet_ported("pipelining")
    if cfg.overlap:
        raise _not_yet_ported("the overlapped tensor-parallel stack")
    if cfg.attn_impl not in ATTN_IMPLS:
        # a typo must not silently run dense attention
        raise ValueError(
            f"unknown attn_impl {cfg.attn_impl!r}; expected one of {ATTN_IMPLS}"
        )
    if cfg.remat not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat policy {cfg.remat!r}; expected 'full', 'dots' or 'none'"
        )


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: str | torch.device = "cpu") -> Dict[str, Any]:
    """Stacked-layer f32 params with the JAX package's shapes, drawn from
    ``generator`` (which must live on ``device``). The numbers differ from
    JAX's for the same seed; carry weights across with ``bridge.py``."""
    check_supported(cfg)
    d, h, hd, f, L = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.n_layers
    h_kv = cfg.kv_heads

    def norm_init(shape, fan_in):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return x.div_(math.sqrt(fan_in))

    def ones(shape):
        return torch.ones(shape, device=device, dtype=torch.float32)

    embed = norm_init((cfg.vocab_size, d), d)
    layers = {
        "attn_norm": ones((L, d)),
        "wq": norm_init((L, d, h, hd), d),
        "wk": norm_init((L, d, h_kv, hd), d),
        "wv": norm_init((L, d, h_kv, hd), d),
        "wo": norm_init((L, h, hd, d), d),
        "mlp_norm": ones((L, d)),
        "w_gate": norm_init((L, d, f), d),
        "w_up": norm_init((L, d, f), d),
        "w_down": norm_init((L, f, d), f),
    }
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": ones((d,)),
        "lm_head": norm_init((d, cfg.vocab_size), d),
    }


def sharding_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    """The JAX package's ``sharding_specs`` for the dense model, mirroring
    ``init_params``' tree: one entry per tensor dim (None, an axis name or
    a tuple of names). tp shards heads and the MLP hidden dim, fsdp the
    complementary axis; the leading layer axis is not sharded. The
    pipeline (pp), expert (ep) and LoRA layouts are not yet ported."""
    check_supported(cfg)
    fsdp, tp = "fsdp", "tp"
    return {
        "embed": (None, fsdp),
        "layers": {
            "attn_norm": (None, None),
            "wq": (None, fsdp, tp, None),
            "wk": (None, fsdp, tp, None),
            "wv": (None, fsdp, tp, None),
            "wo": (None, tp, None, fsdp),
            "mlp_norm": (None, None),
            "w_gate": (None, fsdp, tp),
            "w_up": (None, fsdp, tp),
            "w_down": (None, tp, fsdp),
        },
        "final_norm": (None,),
        "lm_head": (fsdp, tp),
    }


def activation_spec() -> tuple:
    """[batch, seq, ...]: batch over dp(+fsdp), sequence over sp."""
    return (("dp", "fsdp"), "sp")


def check_mesh(cfg: TransformerConfig, sizes: Dict[str, int]) -> None:
    """Raise for a mesh the port does not run the model on: pp or ep above
    1 (not yet ported), sp above 1 without a ring-family ``attn_impl`` (each
    rank holds only its slice of the sequence), heads that do not divide tp
    (the JAX package's ``_shardings`` check), or Ulysses' tp-local heads
    that do not divide sp (its ``overlap_applicable`` check)."""
    for axis, what in (("pp", "pipelining (pp > 1)"),
                       ("ep", "expert parallelism (ep > 1)")):
        if sizes.get(axis, 1) > 1:
            raise _not_yet_ported(what)
    tp, sp = sizes.get("tp", 1), sizes.get("sp", 1)
    if sp > 1 and cfg.attn_impl not in RING_FAMILY:
        raise ValueError(
            f"sp={sp} needs a ring-family attn_impl {RING_FAMILY}, got "
            f"{cfg.attn_impl!r}")
    if cfg.n_heads % tp or cfg.kv_heads % tp:
        raise ValueError(
            f"head counts must divide the tp axis: n_heads={cfg.n_heads}, "
            f"kv_heads={cfg.kv_heads}, tp={tp}"
        )
    if cfg.attn_impl == "ulysses" and (cfg.n_heads // tp) % sp:
        raise ValueError(
            f"ulysses needs tp-local heads divisible by sp: {cfg.n_heads} "
            f"heads / tp={tp} vs sp={sp}")


def is_quantized_leaf(leaf) -> bool:
    """The int8 ``{"qi8", "scale"}`` leaf encoding of the JAX package."""
    return isinstance(leaf, dict) and "qi8" in leaf


def load_weight(leaf, dtype) -> torch.Tensor:
    """Cast a weight leaf to the compute dtype, dequantizing an int8
    ``{"qi8", "scale"}`` pair."""
    if is_quantized_leaf(leaf):
        return leaf["qi8"].to(dtype) * leaf["scale"].to(dtype)
    return leaf.to(dtype)


def cast_params(params: Dict[str, Any], dtype) -> Dict[str, Any]:
    """Cast float weight leaves to ``dtype`` once, up front; int8 leaves and
    non-float leaves pass through."""

    def cast(node):
        if is_quantized_leaf(node):
            return node
        if isinstance(node, dict):
            return {k: cast(v) for k, v in node.items()}
        if isinstance(node, torch.Tensor) and node.is_floating_point():
            return node.to(dtype)
        return node

    return cast(params)


def _rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    norm = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (norm * w).to(x.dtype)


def _rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [B, T, H, D]; rotate pairs (even, odd) by position-dependent angles."""
    d = x.shape[-1]
    freqs = torch.exp(
        -math.log(theta)
        * (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    )  # [D/2]
    angles = positions[..., None].float() * freqs  # [1, T, D/2]
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1 = x[..., 0::2].float()
    x2 = x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def _dispatch_attention(q, k, v, cfg: TransformerConfig, attn_fn):
    """The JAX package's ``_dispatch_attention``: ``flash`` and the ring
    family take compact GQA k/v as they are (the kernels read kv head
    i // group themselves, the rings and Ulysses rotate or exchange H_kv
    heads, their grouped einsums read them in place); ``xla`` gets each
    shared head repeated for its contiguous q-head group, after RoPE,
    exactly as the reference does.

    Under a mesh q, k and v are the rank's local batch rows and head
    shard, so this is the counterpart of ``_flash_gspmd``: the kernel runs
    on the local shard with no communication. ``check_mesh`` refuses kv
    heads that do not divide tp, so the compact k/v always split with
    their q-head groups (the local q head i reads local kv head i //
    group); a batch that does not split over dp x fsdp arrives as whole
    rows on every rank (``parallel/train.py``), which is JAX's replicated
    fallback."""
    if k.shape[2] != q.shape[2] and cfg.attn_impl not in _COMPACT_GQA:
        rep = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return attn_fn(q, k, v, causal=True)


# attn_impls that read compact GQA k/v (check_mesh has kv heads divide tp)
_COMPACT_GQA = ("flash",) + RING_FAMILY


def _identity(x):
    return x


def _apply_layer(x, lp, positions, cfg: TransformerConfig, attn_fn,
                 shards: Optional[sharding.MeshShards] = None):
    """One dense transformer block; ``lp`` leaves have no layer axis.

    Under a mesh (``shards``) the leaves are the rank's shards: each
    weight is gathered over fsdp where it is used, heads and the MLP
    hidden dim stay tp-local, and the two row-parallel projections (``wo``,
    ``w_down``) sum over tp, Megatron-style."""
    dtype = cfg.dtype
    if shards is None:
        def w(name):
            return lp[name].to(dtype)

        to_tp = from_tp = _identity
    else:
        specs = _LAYER_SPECS

        def w(name):
            return shards.weight(lp[name], specs[name], dtype)

        to_tp, from_tp = shards.to_tp, shards.from_tp
    h = to_tp(_rms_norm(x, lp["attn_norm"]))
    q = torch.einsum("btd,dhk->bthk", h, w("wq"))
    k = torch.einsum("btd,dhk->bthk", h, w("wk"))
    v = torch.einsum("btd,dhk->bthk", h, w("wv"))
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    attn = _dispatch_attention(q, k, v, cfg, attn_fn)
    x = x + from_tp(torch.einsum("bthk,hkd->btd", attn, w("wo")))
    h = to_tp(_rms_norm(x, lp["mlp_norm"]))
    gate = torch.einsum("btd,df->btf", h, w("w_gate"))
    up = torch.einsum("btd,df->btf", h, w("w_up"))
    mid = F.silu(gate) * up
    return x + from_tp(torch.einsum("btf,fd->btd", mid, w("w_down")))


# each layer leaf's spec without the stacked layer axis
_LAYER_SPECS = {name: spec[1:] for name, spec in
                sharding_specs(TransformerConfig())["layers"].items()}


def _resolve_attn_fn(cfg: TransformerConfig, mesh=None):
    """``attn_fn(q, k, v, causal)`` of ``cfg.attn_impl``, the JAX package's
    table; the ring family attends over ``mesh``'s sp axis and raises
    ``ValueError`` without a mesh (JAX asserts one)."""
    check_supported(cfg)
    from hivedscheduler_tpu_torch.ops import attention

    blocks = dict(block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
    if cfg.attn_impl == "flash":
        return functools.partial(attention.flash_attention, **blocks)
    if cfg.attn_impl in RING_FAMILY:
        if mesh is None:
            raise ValueError(f"attn_impl {cfg.attn_impl!r} requires a mesh")
        from hivedscheduler_tpu_torch.parallel import ring_attention as ra

        fn = {
            "ring": ra.ring_attention,
            "ring_flash": functools.partial(ra.ring_flash_attention, **blocks),
            "ring_zigzag": ra.zigzag_ring_attention,
            "ring_zigzag_flash": functools.partial(ra.zigzag_ring_flash_attention,
                                                   **blocks),
            "ulysses": ra.ulysses_attention,
        }[cfg.attn_impl]
        return functools.partial(fn, mesh=mesh)
    return attention.xla_attention


# the matmul ops whose outputs "dots" keeps for the backward, like the JAX
# package's dots_with_no_batch_dims_saveable policy; everything else in a
# layer is recomputed
_SAVED_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                  torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_MATMULS:
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, cfg: TransformerConfig):
    """Apply ``cfg.remat`` to a layer body, as the JAX package's
    ``_remat_wrap`` does to its layer scan: "none" saves everything, "full"
    recomputes the whole layer in the backward, "dots" saves the matmul
    outputs and recomputes the rest. Only changes what the backward
    recomputes, so it applies only where autograd records. ``cfg.remat``
    is checked by ``check_supported``."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts, _dots_policy)

    def wrapped(*args):
        return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


def mesh_shards(mesh, cfg: TransformerConfig) -> Optional[sharding.MeshShards]:
    """The collectives of ``mesh`` (None for none), after ``check_mesh``."""
    if mesh is None:
        return None
    check_mesh(cfg, dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)))
    return sharding.MeshShards(mesh)


def lm_head_weight(params: Dict[str, Any], cfg: TransformerConfig,
                   shards: Optional[sharding.MeshShards] = None) -> torch.Tensor:
    """The whole ``lm_head`` in the compute dtype: under a mesh gathered
    over fsdp and tp (vocab-sharded ``P("fsdp", "tp")``), so every rank
    takes the softmax over the full vocab as the JAX package's loss does."""
    if shards is None:
        return load_weight(params["lm_head"], cfg.dtype)
    return shards.weight(sharding.local(params["lm_head"]),
                         sharding_specs(cfg)["lm_head"], cfg.dtype,
                         axes=("fsdp", "tp"))


def forward_with_aux(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    mesh=None,
    return_hidden: bool = False,
):
    """tokens [B, T] int -> (logits [B, T, vocab] f32, aux loss f32 scalar,
    always 0 for the dense model).

    ``return_hidden=True`` returns the final-norm hidden states [B, T, D]
    (model dtype) instead of logits, for the chunked cross-entropy loss.
    ``mesh``: a six-axis ``DeviceMesh`` over which ``params`` are DTensors
    laid out by ``sharding_specs`` and ``tokens`` are this rank's rows,
    whole sequences (a DTensor or its local tensor); the result is then
    this rank's rows at its sp slice of the positions
    (``MeshShards.seq_part``), replicated over tp."""
    attn_fn = _resolve_attn_fn(cfg, mesh)
    shards = mesh_shards(mesh, cfg)
    tokens = sharding.local(tokens)
    if shards is not None:
        tokens = shards.seq_part(tokens)
    dtype = cfg.dtype
    t = tokens.shape[1]
    # RoPE at each position's place in the whole sequence
    start = 0 if shards is None else shards.seq_index * t
    if shards is None:
        embed = params["embed"]
    else:
        embed = shards.weight(sharding.local(params["embed"]),
                              sharding_specs(cfg)["embed"], None)
    x = F.embedding(tokens, embed).to(dtype)  # [B, T, D]
    positions = torch.arange(start, start + t, dtype=torch.int32,
                             device=tokens.device)[None, :]
    # one unbind per stacked leaf: indexing leaf[i] per layer would make
    # each backward write a zero gradient of the whole stack per layer
    per_layer = {name: torch.unbind(sharding.local(leaf))
                 for name, leaf in params["layers"].items()}
    layer = _remat_wrap(_apply_layer, cfg)
    for i in range(cfg.n_layers):
        lp = {name: leaves[i] for name, leaves in per_layer.items()}
        x = layer(x, lp, positions, cfg, attn_fn, shards)
    x = _rms_norm(x, sharding.local(params["final_norm"]))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    logits = torch.einsum("btd,dv->btv", x, lm_head_weight(params, cfg, shards))
    return logits.float(), aux


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, vocab] (f32)."""
    return forward_with_aux(params, tokens, cfg, mesh)[0]
