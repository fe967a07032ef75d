"""Flagship workload: the decoder-only transformer LM, in PyTorch.

Counterpart of ``hivedscheduler_tpu/models/transformer.py``: RoPE (on
interleaved even/odd pairs), RMSNorm, SwiGLU, grouped-query attention, bf16
matmuls with f32 master weights. The model state is a plain dict of tensors
with the JAX package's tree: ``embed``, ``final_norm``, ``lm_head`` and
``layers``, whose leaves carry a leading ``[n_layers]`` axis, so
``bridge.py`` carries weights across unchanged and both packages compute
with the same numbers.

Ported: the dense single-device forward with ``attn_impl`` ``xla`` or
``flash``, differentiable, with the ``remat`` policies of the layer loop.
MoE, LoRA, the ring/Ulysses family, pipelining and the overlapped
tensor-parallel stack raise "not yet ported".
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint


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
    # "xla" | "flash" here; the ring family is not yet ported
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
    if cfg.attn_impl in RING_FAMILY:
        raise _not_yet_ported(f"attn_impl {cfg.attn_impl!r}")
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
    """Single-device branch of the JAX package's ``_dispatch_attention``:
    ``flash`` takes compact GQA k/v as they are (the kernel reads kv head
    i // group itself); ``xla`` gets each shared head repeated for its
    contiguous q-head group, after RoPE, exactly as the reference does."""
    if k.shape[2] != q.shape[2] and cfg.attn_impl != "flash":
        rep = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return attn_fn(q, k, v, causal=True)


def _apply_layer(x, lp, positions, cfg: TransformerConfig, attn_fn):
    """One dense transformer block; ``lp`` leaves have no layer axis."""
    dtype = cfg.dtype
    h = _rms_norm(x, lp["attn_norm"])
    q = torch.einsum("btd,dhk->bthk", h, lp["wq"].to(dtype))
    k = torch.einsum("btd,dhk->bthk", h, lp["wk"].to(dtype))
    v = torch.einsum("btd,dhk->bthk", h, lp["wv"].to(dtype))
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    attn = _dispatch_attention(q, k, v, cfg, attn_fn)
    x = x + torch.einsum("bthk,hkd->btd", attn, lp["wo"].to(dtype))
    h = _rms_norm(x, lp["mlp_norm"])
    gate = torch.einsum("btd,df->btf", h, lp["w_gate"].to(dtype))
    up = torch.einsum("btd,df->btf", h, lp["w_up"].to(dtype))
    mid = F.silu(gate) * up
    return x + torch.einsum("btf,fd->btd", mid, lp["w_down"].to(dtype))


def _resolve_attn_fn(cfg: TransformerConfig):
    check_supported(cfg)
    from hivedscheduler_tpu_torch.ops import attention

    if cfg.attn_impl == "flash":
        def attn_fn(q, k, v, causal=True):
            return attention.flash_attention(
                q, k, v, causal=causal,
                block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)

        return attn_fn
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
    ``mesh`` must be None: the distributed paths are not yet ported."""
    if mesh is not None:
        raise _not_yet_ported("forward over a device mesh")
    attn_fn = _resolve_attn_fn(cfg)
    dtype = cfg.dtype
    t = tokens.shape[1]
    x = F.embedding(tokens, params["embed"]).to(dtype)  # [B, T, D]
    positions = torch.arange(t, dtype=torch.int32, device=tokens.device)[None, :]
    # one unbind per stacked leaf: indexing leaf[i] per layer would make
    # each backward write a zero gradient of the whole stack per layer
    per_layer = {name: torch.unbind(leaf) for name, leaf in params["layers"].items()}
    layer = _remat_wrap(_apply_layer, cfg)
    for i in range(cfg.n_layers):
        lp = {name: leaves[i] for name, leaves in per_layer.items()}
        x = layer(x, lp, positions, cfg, attn_fn)
    x = _rms_norm(x, params["final_norm"])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    logits = torch.einsum("btd,dv->btv", x, params["lm_head"].to(dtype))
    return logits.float(), aux


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, vocab] (f32)."""
    return forward_with_aux(params, tokens, cfg, mesh)[0]
