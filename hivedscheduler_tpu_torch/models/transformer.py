"""Flagship workload: the decoder-only transformer LM, in PyTorch.

Counterpart of ``hivedscheduler_tpu/models/transformer.py``: RoPE (on
interleaved even/odd pairs), RMSNorm, SwiGLU, grouped-query attention, bf16
matmuls with f32 master weights. The model state is a plain dict of tensors
with the JAX package's tree: ``embed``, ``final_norm``, ``lm_head`` and
``layers``, whose leaves carry a leading ``[n_layers]`` axis, so
``bridge.py`` carries weights across unchanged and both packages compute
with the same numbers.

Ported: the dense and the mixture-of-experts forward (``n_experts > 0``:
top-1 switch or renormalised top-k routing, capacity-based dense
dispatch, the Switch load-balance loss and the ST-MoE z-loss) with every
``attn_impl`` (``xla``, ``flash`` and the sequence-parallel family of
``parallel/ring_attention.py``), differentiable, with the ``remat``
policies of the layer loop, on one device or over a six-axis
``DeviceMesh`` with dp, fsdp, pp, ep, tp and sp above 1 (``sharding_specs``
gives each leaf's layout; ``parallel/sharding.py`` holds the
collectives). At sp above 1, ``xla`` and ``flash`` gather the sequence
and attend over all of it, as the JAX package's GSPMD layer does, and MoE
keeps the unsharded routing (capacity on the global length); the ring
family needs a mesh, as in the JAX package; a mesh of one device is
enough. With ``pipeline_microbatches > 0`` the layers run as GPipe stages
over pp (``parallel/pipeline.py``), which also needs a mesh.

LoRA (``lora_rank > 0``): rank-r adapters on the attention projections
and, with ``lora_mlp``, on the dense MLP's, each scaled by ``lora_alpha /
lora_rank``; ``split_lora_params`` and ``combine_lora_params`` part the
tree for the adapter-only train step (``parallel/train.py``) and
``merge_lora`` folds the adapters back into the base weights for
serving.

Overlapped tensor parallelism (``cfg.overlap``, ``HIVED_OVERLAP``): at tp
above 1 a dense, unpipelined model without adapters runs its layers as
the JAX package's collective-matmul stack (``_overlapped_stack``) wherever
``overlap_applicable`` holds: the residual stream sequence-sharded over
(sp, tp), QKV and gate/up through ``shard_utils.allgather_matmul``, the
attention output and the MLP down projection through
``matmul_reducescatter``. ``overlap=None`` takes it whenever it applies,
``False`` never, ``True`` raises when it cannot; ``HIVED_OVERLAP=0``
forces the reference layer body regardless.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from hivedscheduler_tpu_torch.common import envflags
from hivedscheduler_tpu_torch.parallel import shard_utils, sharding


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
    # the collective-matmul stack at tp > 1: None on whenever it applies,
    # False never, True required (raises where it cannot serve the config)
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


def check_supported(cfg: TransformerConfig) -> None:
    """Raise for every configuration the port does not run yet, and for
    the ones the JAX package's ``init_params`` refuses."""
    if cfg.lora_mlp and cfg.n_experts > 0:
        raise ValueError("lora_mlp adapts the dense MLP only (MoE experts "
                         "are not adapted)")
    if cfg.lora_mlp and cfg.lora_rank <= 0:
        # training every parameter when MLP adapters were asked for would
        # defeat the flag
        raise ValueError("lora_mlp requires lora_rank > 0")
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
    JAX's for the same seed; carry weights across with ``bridge.py``.

    With ``lora_rank > 0`` the adapter leaves follow: ``lora_<w>_a`` drawn
    like the base projections (N(0, 1/fan_in)) and ``lora_<w>_b`` zero, so
    the adapted model starts equal to the base. They are drawn after every
    base leaf, so the base is the same for any rank."""
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
    }
    if cfg.n_experts > 0:
        E = cfg.n_experts
        layers.update(
            router=norm_init((L, d, E), d),
            w_gate=norm_init((L, E, d, f), d),
            w_up=norm_init((L, E, d, f), d),
            w_down=norm_init((L, E, f, d), f),
        )
    else:
        layers.update(
            w_gate=norm_init((L, d, f), d),
            w_up=norm_init((L, d, f), d),
            w_down=norm_init((L, f, d), f),
        )
    lm_head = norm_init((d, cfg.vocab_size), d)
    if cfg.lora_rank > 0:
        r = cfg.lora_rank

        def zeros(shape):
            return torch.zeros(shape, device=device, dtype=torch.float32)

        lora = {
            "lora_wq_a": norm_init((L, d, r), d), "lora_wq_b": zeros((L, r, h, hd)),
            "lora_wk_a": norm_init((L, d, r), d), "lora_wk_b": zeros((L, r, h_kv, hd)),
            "lora_wv_a": norm_init((L, d, r), d), "lora_wv_b": zeros((L, r, h_kv, hd)),
            "lora_wo_a": norm_init((L, h, hd, r), d), "lora_wo_b": zeros((L, r, d)),
        }
        if cfg.lora_mlp:
            lora.update(
                lora_w_gate_a=norm_init((L, d, r), d), lora_w_gate_b=zeros((L, r, f)),
                lora_w_up_a=norm_init((L, d, r), d), lora_w_up_b=zeros((L, r, f)),
                lora_w_down_a=norm_init((L, f, r), f), lora_w_down_b=zeros((L, r, d)),
            )
        layers.update(lora)
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": ones((d,)),
        "lm_head": lm_head,
    }


def split_lora_params(params: Dict[str, Any]):
    """(base, adapters): the tree without its ``lora_*`` leaves, and
    ``{"layers": {the lora_* leaves}}``, the same tensors. Inverse:
    :func:`combine_lora_params`."""
    layers = params["layers"]
    base = dict(params)
    base["layers"] = {k: v for k, v in layers.items() if not k.startswith("lora_")}
    return base, {"layers": {k: v for k, v in layers.items() if k.startswith("lora_")}}


def combine_lora_params(base: Dict[str, Any], lora: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    out["layers"] = {**base["layers"], **lora["layers"]}
    return out


def merge_lora(params: Dict[str, Any], cfg: TransformerConfig) -> Dict[str, Any]:
    """Fold the adapters into the base weights, W + (alpha / r) A B, and
    drop the ``lora_*`` leaves: a tree of the base's shape, for decode and
    serving, that computes the same function in exact arithmetic. Each
    merged leaf keeps its base dtype."""
    if cfg.lora_rank <= 0:
        raise ValueError("merge_lora needs a LoRA config (lora_rank > 0)")
    s = cfg.lora_alpha / cfg.lora_rank
    layers = dict(params["layers"])
    names = [k[len("lora_"):-len("_a")] for k in layers
             if k.startswith("lora_") and k.endswith("_a")]
    for name in names:
        a = layers.pop(f"lora_{name}_a").detach()
        b = layers.pop(f"lora_{name}_b").detach()
        if name == "wo":
            delta = torch.einsum("lhkr,lrd->lhkd", a, b)
        elif name in ("wq", "wk", "wv"):
            delta = torch.einsum("ldr,lrhk->ldhk", a, b)
        else:  # the MLP projections: plain 2-D factors
            delta = torch.einsum("lxr,lry->lxy", a, b)
        base = layers[name].detach()
        layers[name] = (base + s * delta).to(base.dtype)
    out = dict(params)
    out["layers"] = layers
    return out


def sharding_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    """The JAX package's ``sharding_specs``, mirroring ``init_params``'
    tree: one entry per tensor dim (None, an axis name or a tuple of
    names). tp shards heads and the MLP hidden dim (each expert's too),
    fsdp the complementary axis, ep the expert axis; the router is
    replicated over ep and tp. The leading layer axis is sharded over pp
    when the model is pipelined (``pipeline_microbatches > 0``: stage s
    holds its contiguous block of layers), else not. The LoRA rank axis is
    replicated; each adapter's other axes mirror its base projection's, so
    the adapter products stay tp-local."""
    check_supported(cfg)
    pl = "pp" if cfg.pipeline_microbatches > 0 else None
    fsdp, tp = "fsdp", "tp"
    layers = {
        "attn_norm": (pl, None),
        "wq": (pl, fsdp, tp, None),
        "wk": (pl, fsdp, tp, None),
        "wv": (pl, fsdp, tp, None),
        "wo": (pl, tp, None, fsdp),
        "mlp_norm": (pl, None),
    }
    if cfg.n_experts > 0:
        layers.update(
            router=(pl, fsdp, None),
            w_gate=(pl, "ep", fsdp, tp),
            w_up=(pl, "ep", fsdp, tp),
            w_down=(pl, "ep", tp, fsdp),
        )
    else:
        layers.update(
            w_gate=(pl, fsdp, tp),
            w_up=(pl, fsdp, tp),
            w_down=(pl, tp, fsdp),
        )
    if cfg.lora_rank > 0:
        layers.update(
            lora_wq_a=(pl, fsdp, None), lora_wq_b=(pl, None, tp, None),
            lora_wk_a=(pl, fsdp, None), lora_wk_b=(pl, None, tp, None),
            lora_wv_a=(pl, fsdp, None), lora_wv_b=(pl, None, tp, None),
            lora_wo_a=(pl, tp, None, None), lora_wo_b=(pl, None, fsdp),
        )
        if cfg.lora_mlp:
            layers.update(
                lora_w_gate_a=(pl, fsdp, None), lora_w_gate_b=(pl, None, tp),
                lora_w_up_a=(pl, fsdp, None), lora_w_up_b=(pl, None, tp),
                lora_w_down_a=(pl, tp, None), lora_w_down_b=(pl, None, fsdp),
            )
    return {
        "embed": (None, fsdp),
        "layers": layers,
        "final_norm": (None,),
        "lm_head": (fsdp, tp),
    }


def activation_spec() -> tuple:
    """[batch, seq, ...]: batch over dp(+fsdp), sequence over sp."""
    return (("dp", "fsdp"), "sp")


def _check_pipeline(cfg: TransformerConfig, sizes: Dict[str, int]) -> None:
    """The JAX package's checks of a pipelined model's mesh
    (``forward_with_aux``'s pipeline branch), with its messages, and a
    layer count that the stages split evenly."""
    tp, sp, ep, pp = (sizes.get(a, 1) for a in ("tp", "sp", "ep", "pp"))
    if sp > 1 and cfg.attn_impl not in RING_FAMILY:
        raise ValueError(
            f"pipeline with mesh sp > 1 requires one of attn_impl "
            f"{RING_FAMILY} (got {cfg.attn_impl}): the sequence axis "
            "is sharded inside the stage"
        )
    if cfg.kv_heads % tp:
        raise ValueError(
            f"GQA in pipeline needs kv heads divisible by tp: "
            f"{cfg.kv_heads} kv heads, tp={tp}"
        )
    if cfg.n_experts > 0 and cfg.n_experts % ep:
        raise ValueError(
            f"n_experts {cfg.n_experts} not divisible by mesh "
            f"ep={ep} inside the pipeline"
        )
    if cfg.attn_impl == "ulysses" and sp > 1 and (cfg.n_heads // tp) % sp:
        raise ValueError(
            f"ulysses in pipeline needs local heads divisible by sp: "
            f"{cfg.n_heads} heads / tp={tp} not divisible by sp={sp}"
        )
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers {cfg.n_layers} does not split over "
                         f"pp={pp} pipeline stages")


def check_mesh(cfg: TransformerConfig, sizes: Dict[str, int]) -> None:
    """Raise for a mesh the port does not run the model on: a pipelined
    model's mesh that the JAX package's pipeline refuses
    (:func:`_check_pipeline`, with its messages), pp above 1 for a model
    that is not pipelined, experts that do not split over ep, heads that do
    not divide tp (the JAX package's ``_shardings`` check), or Ulysses'
    tp-local heads that do not divide sp (its ``overlap_applicable``
    check). Every ``attn_impl`` runs at sp above 1: ``xla`` and ``flash``
    gather the sequence (``_dispatch_attention``), and MoE keeps the
    unsharded routing (``_moe_route``)."""
    if cfg.pipeline_microbatches > 0:
        _check_pipeline(cfg, sizes)
    elif sizes.get("pp", 1) > 1:
        raise ValueError(f"a mesh with pp={sizes['pp']} needs a pipelined "
                         "model (pipeline_microbatches > 0)")
    tp, sp, ep = sizes.get("tp", 1), sizes.get("sp", 1), sizes.get("ep", 1)
    if cfg.n_experts > 0 and cfg.n_experts % ep:
        raise ValueError(f"n_experts {cfg.n_experts} does not split over "
                         f"ep={ep}")
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


def _dispatch_attention(q, k, v, cfg: TransformerConfig, attn_fn,
                        shards: Optional[sharding.MeshShards] = None):
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
    fallback.

    At sp above 1 q, k and v hold this rank's slice of the sequence. The
    ring family attends across the slices itself; ``xla`` and ``flash``
    gather the whole sequence over sp (``MeshShards.seq_gather``, heads
    still tp-local, as ``_flash_gspmd``'s spec ``P(("dp", "fsdp"), None,
    "tp", None)`` gathers it), attend over it with the causal mask and keep
    this rank's rows. The slice's backward puts the gradient on those rows
    and zeros elsewhere, and the gather's backward reduce-scatters it, so
    dq, dk and dv sum every rank's part."""
    gathered = (shards is not None and "sp" in shards.groups
                and cfg.attn_impl not in RING_FAMILY)
    if gathered:
        q, k, v = (shards.seq_gather(t) for t in (q, k, v))
    if k.shape[2] != q.shape[2] and cfg.attn_impl not in _COMPACT_GQA:
        rep = q.shape[2] // k.shape[2]
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    out = attn_fn(q, k, v, causal=True)
    return shards.seq_part(out) if gathered else out


# attn_impls that read compact GQA k/v (check_mesh has kv heads divide tp)
_COMPACT_GQA = ("flash",) + RING_FAMILY


def _identity(x):
    return x


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest entries along the last dim,
    in ``lax.top_k``'s order: descending, the lower index first among equal
    values. A stable descending sort keeps that rule; ``torch.topk``
    promises no order among ties on CUDA."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _moe_route(h: torch.Tensor, router: torch.Tensor, cfg: TransformerConfig,
               shards: Optional[sharding.MeshShards] = None):
    """The routing of ``_moe_mlp``: ``h`` [B, T, D] and ``router`` [D, E] in
    the compute dtype -> (combine [B, T, E, C] f32, each kept token's gate
    at its expert's slot; dispatch, ``combine > 0`` in ``h``'s dtype; the
    chosen experts [B, T, K]; the layer's weighted aux loss, an f32
    scalar).

    Top-1 keeps the raw switch gate, top-k > 1 renormalises the gates over
    the chosen experts. Capacity is ``ceil(T k / E x
    expert_capacity_factor)`` slots per expert and row; each choice's
    tokens queue after all tokens of the earlier choices, in sequence
    order, and a token past its expert's capacity is dropped, as is one
    whose gate is 0 (subnormal probabilities count as 0). The aux is
    ``moe_aux_weight`` times the Switch load-balance term E x sum_e
    (first-choice share_e x mean prob_e), plus ``moe_zloss_weight`` times
    the ST-MoE z-loss mean(logsumexp(logits)^2).
    Under a mesh the means are over every rank's rows (in a pipeline
    stage, over the sp slices of the microbatch's rows only:
    ``MeshShards.stat_axes``), and the gates enter the experts' region
    (``MeshShards.to_experts``) before they are laid into ``combine``.

    At sp above 1 ``h`` is this rank's slice of T / sp positions and the
    routing is the unsharded one, the JAX package's ``manual_sp_axis``
    form: capacity is taken on the whole length, and a token's slot adds
    the counts of its choice on the earlier sp slices and every slice's
    counts of the earlier choices (``MeshShards.seq_counts``), so a token
    overflows its expert iff it would on one device. Shapes are static and
    nothing reads the device from the host, so a CUDA graph captures it."""
    b, t, _ = h.shape
    n_exp = router.shape[-1]
    top_k = max(1, min(cfg.moe_top_k, n_exp))
    sp = 1 if shards is None or "sp" not in shards.groups else shards.sizes["sp"]
    capacity = max(1, int(math.ceil(t * sp * top_k / n_exp * cfg.expert_capacity_factor)))
    logits = torch.einsum("btd,de->bte", h, router).float()
    # XLA flushes subnormal f32 results to 0 (as does the TPU): so that a
    # gate that underflows there is 0 here too, and is dropped
    probs = torch.softmax(logits, dim=-1)
    probs = probs.masked_fill(probs < torch.finfo(torch.float32).tiny, 0.0)
    top_gates, top_idx = _top_k(probs, top_k)  # [B, T, K]
    if top_k > 1:
        top_gates = top_gates / torch.sum(top_gates, dim=-1, keepdim=True)
    masks = F.one_hot(top_idx, n_exp).float()  # [B, T, K, E]
    # the load balance counts first choices only (standard Switch)
    stats = [masks[:, :, 0, :], probs]
    if cfg.moe_zloss_weight > 0.0:
        stats.append(torch.square(torch.logsumexp(logits, dim=-1, keepdim=True)))
    # token means; under a mesh over every rank's rows, as GSPMD takes the
    # JAX package's batch means
    sums = torch.sum(torch.cat(stats, dim=-1), dim=(0, 1))
    means = sums / (b * t) if shards is None else shards.data_mean(sums, b * t)
    aux = cfg.moe_aux_weight * (n_exp * torch.sum(means[:n_exp] * means[n_exp:2 * n_exp]))
    if cfg.moe_zloss_weight > 0.0:
        aux = aux + cfg.moe_zloss_weight * means[2 * n_exp]
    if shards is not None:
        top_gates = shards.to_experts(top_gates)
    # slot positions: choice 0's tokens queue first, then choice 1's
    combine = probs.new_zeros((b, t, n_exp, capacity))
    counts = probs.new_zeros((b, n_exp))  # slots taken by earlier choices
    if sp > 1:
        # [sp, B, K, E]: each slice's tokens per choice and expert
        slice_counts = shards.seq_counts(torch.sum(masks, dim=1))
        earlier = torch.sum(slice_counts[:shards.seq_index], dim=0)
    for i in range(top_k):
        m = masks[:, :, i, :]  # [B, T, E]
        if sp > 1:
            pos = ((torch.cumsum(m, dim=1) + earlier[:, None, i, :]) * m - 1.0
                   + counts[:, None, :] * m)
            counts = counts + torch.sum(slice_counts[:, :, i, :], dim=0)
        else:
            pos = torch.cumsum(m, dim=1) * m - 1.0 + counts[:, None, :] * m
            counts = counts + torch.sum(m, dim=1)
        keep = m * ((pos >= 0) & (pos < capacity)).float()
        slot = torch.clamp(pos, 0, capacity - 1).long()[..., None]
        combine = combine.scatter_add(
            -1, slot, (keep * top_gates[:, :, i, None])[..., None])
    return combine, (combine > 0.0).to(h.dtype), top_idx, aux


def _moe_mlp(h: torch.Tensor, w, cfg: TransformerConfig,
             shards: Optional[sharding.MeshShards] = None):
    """Top-k MoE with capacity-based dense dispatch, the JAX package's
    ``_moe_mlp``: ``h`` [B, T, D] -> (out [B, T, D], this layer's weighted
    aux loss). ``w(name)`` is the layer's weight ``name`` in the compute
    dtype: ``router`` [D, E] and the stacked experts ``w_gate`` / ``w_up``
    [E', D, F'] and ``w_down`` [E', F', D]. Routing, drops and the aux are
    :func:`_moe_route`'s.

    Under a mesh (``shards``) every rank routes its rows over all E
    experts (the router is whole). The experts are Megatron's region over
    ep and tp: each rank holds E' = E/ep experts and its tp slice F' of
    their hidden dim, so ``h`` and the gates enter through f
    (``MeshShards.to_experts``) and the combined output leaves through g
    (``from_experts``). Routing and the aux stay outside the region,
    computed once per rank, so their gradients are whole on every rank.

    At sp above 1 each rank's tokens fill their own slots, so the
    experts' inputs are summed over sp before the experts and, where
    that sum was scattered over the capacity dim, their outputs gathered
    back before each rank combines its tokens (``MeshShards.slots_sum``,
    ``slots_gather``): the JAX package's order, dispatch, sp sum,
    experts, sp gather, combine, then the sum over ep and tp. The expert
    weights' gradients are then partial over sp and ``sync_grad`` sums
    them."""
    combine, dispatch, _, aux = _moe_route(h, w("router"), cfg, shards)
    if shards is not None:
        h = shards.to_experts(h)
        dispatch, combine = shards.local_experts(dispatch), shards.local_experts(combine)
    expert_in = torch.einsum("btec,btd->ebcd", dispatch, h)
    scattered = False
    if shards is not None and "sp" in shards.groups:
        expert_in, scattered = shards.slots_sum(expert_in)
    g = torch.einsum("ebcd,edf->ebcf", expert_in, w("w_gate"))
    u = torch.einsum("ebcd,edf->ebcf", expert_in, w("w_up"))
    expert_out = torch.einsum("ebcf,efd->ebcd", F.silu(g) * u, w("w_down"))
    if scattered:
        expert_out = shards.slots_gather(expert_out)
    # combine already carries each token's gate at its slot
    out = torch.einsum("btec,ebcd->btd", combine.to(h.dtype), expert_out)
    if shards is not None:
        out = shards.from_experts(out)
    return out, aux


def _apply_layer(x, lp, positions, cfg: TransformerConfig, attn_fn,
                 shards: Optional[sharding.MeshShards] = None):
    """One transformer block; ``lp`` leaves have no layer axis. Returns
    (x, the layer's weighted MoE aux loss, None for a dense layer).

    Under a mesh (``shards``) the leaves are the rank's shards: each
    weight is gathered over fsdp where it is used, heads and the MLP
    hidden dim stay tp-local, and the two row-parallel projections (``wo``,
    ``w_down``) sum over tp, Megatron-style; the experts sum over ep and
    tp (``_moe_mlp``).

    LoRA adapters (``lora_<w>_a``, ``lora_<w>_b`` leaves) add (alpha / r)
    (h A) B to the projection ``w``. Under tp the rank-r bottleneck is the
    Megatron boundary: ``A`` of a column-parallel projection reads the
    whole input and its output enters the tp region through ``to_tp``;
    ``A`` of a row-parallel projection reads the local heads (or hidden
    slice) and its partial product leaves through ``from_tp``. So every
    adapter's gradient is whole on each rank, the replicated leaves' as
    well as the tp shards'. Each delta is added after its base product, so
    with ``B`` zero the layer computes the base's values bit for bit."""
    dtype = cfg.dtype
    if shards is None:
        def w(name):
            return lp[name].to(dtype)

        to_tp = from_tp = _identity
    else:
        specs = _layer_specs(cfg.n_experts > 0)

        def w(name):
            return shards.weight(lp[name], specs[name], dtype)

        to_tp, from_tp = shards.to_tp, shards.from_tp
    scale = cfg.lora_alpha / cfg.lora_rank if cfg.lora_rank > 0 else 0.0

    def lora_in(h_whole, name, eq):
        """The adapter delta of a column-parallel projection ``name``."""
        z = to_tp(torch.einsum("btd,dr->btr", h_whole, w(f"lora_{name}_a")))
        return torch.einsum(eq, z, w(f"lora_{name}_b")) * scale

    def lora_out(h_local, name, eq):
        """The adapter delta of a row-parallel projection ``name``."""
        z = from_tp(torch.einsum(eq, h_local, w(f"lora_{name}_a")))
        return torch.einsum("btr,rd->btd", z, w(f"lora_{name}_b")) * scale

    h_whole = _rms_norm(x, lp["attn_norm"])
    h = to_tp(h_whole)
    q = torch.einsum("btd,dhk->bthk", h, w("wq"))
    k = torch.einsum("btd,dhk->bthk", h, w("wk"))
    v = torch.einsum("btd,dhk->bthk", h, w("wv"))
    if "lora_wq_a" in lp:
        q = q + lora_in(h_whole, "wq", "btr,rhk->bthk")
        k = k + lora_in(h_whole, "wk", "btr,rhk->bthk")
        v = v + lora_in(h_whole, "wv", "btr,rhk->bthk")
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    attn = _dispatch_attention(q, k, v, cfg, attn_fn, shards)
    out = from_tp(torch.einsum("bthk,hkd->btd", attn, w("wo")))
    if "lora_wo_a" in lp:
        out = out + lora_out(attn, "wo", "bthk,hkr->btr")
    x = x + out
    if cfg.n_experts > 0:
        out, aux = _moe_mlp(_rms_norm(x, lp["mlp_norm"]), w, cfg, shards)
        return x + out, aux
    h_whole = _rms_norm(x, lp["mlp_norm"])
    h = to_tp(h_whole)
    gate = torch.einsum("btd,df->btf", h, w("w_gate"))
    up = torch.einsum("btd,df->btf", h, w("w_up"))
    if "lora_w_gate_a" in lp:
        gate = gate + lora_in(h_whole, "w_gate", "btr,rf->btf")
        up = up + lora_in(h_whole, "w_up", "btr,rf->btf")
    mid = F.silu(gate) * up
    out = from_tp(torch.einsum("btf,fd->btd", mid, w("w_down")))
    if "lora_w_down_a" in lp:
        out = out + lora_out(mid, "w_down", "btf,fr->btr")
    return x + out, None


def _apply_layer_overlapped(x, lp, positions, cfg: TransformerConfig, attn_fn,
                            shards: sharding.MeshShards, tp: shard_utils.RingAxis):
    """One dense block on the overlapped tensor-parallel path, the JAX
    package's ``_apply_layer_overlapped``.

    ``x`` [B, T / (sp tp), D] is this rank's block of the residual stream
    (``MeshShards.tp_part``), so the norms and residual adds are
    token-local. QKV and gate/up take ``allgather_matmul``, one rotation
    of the block feeding the fused weights, and give this rank's heads
    (or hidden slice) over the sp slice's T / sp positions, ``positions``
    (RoPE's); attention runs on the tp-local heads through
    ``_dispatch_attention`` (``flash`` launches K1-K3, the ring family
    attends over sp); the attention output and the MLP down projection
    take ``matmul_reducescatter`` back to the rank's block. The norm
    weights see the rank's tokens only, so their gradients are summed over
    tp (``MeshShards.to_tp``). Each output element comes from the local
    dot of the reference body; only the row-parallel sums' order differs
    (JAX's ring order), the same bits at tp = 2."""
    dtype = cfg.dtype
    specs = _layer_specs(False)

    def w(name):
        return shards.weight(lp[name], specs[name], dtype)

    h = _rms_norm(x, shards.to_tp(lp["attn_norm"]))
    q, k, v = shard_utils.allgather_matmul(h, [w("wq"), w("wk"), w("wv")], tp,
                                           "btd,dhk->bthk")
    q = _rope(q, positions, cfg.rope_theta)
    k = _rope(k, positions, cfg.rope_theta)
    attn = _dispatch_attention(q, k, v, cfg, attn_fn, shards)
    x = x + shard_utils.matmul_reducescatter(attn, w("wo"), tp, "bthk,hkd->btd")
    h = _rms_norm(x, shards.to_tp(lp["mlp_norm"]))
    gate, up = shard_utils.allgather_matmul(h, [w("w_gate"), w("w_up")], tp,
                                            "btd,df->btf")
    mid = F.silu(gate) * up
    return x + shard_utils.matmul_reducescatter(mid, w("w_down"), tp, "btf,fd->btd")


# forward passes that ran the overlapped stack (``_overlapped_stack``), so
# that tests and ``chip_smoke.py`` can tell which path a run took
OVERLAPPED_STACKS = 0


def _mesh_sizes(mesh) -> Dict[str, int]:
    """Each axis' size of a ``DeviceMesh`` or a ``topology.MeshAxes``."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return dict(zip(mesh.names, mesh.shape))


def overlap_applicable(cfg: TransformerConfig, mesh, seq_len=None, batch=None):
    """Can the overlapped collective-matmul stack serve (cfg, mesh)? ->
    (ok, reason), the JAX package's gate with its reasons word for word.
    ``mesh`` is a six-axis ``DeviceMesh`` or a ``topology.MeshAxes``;
    ``seq_len`` and ``batch`` (the global batch) add the call shape's
    divisibility checks when given."""
    if mesh is None:
        return False, "no mesh"
    shape = _mesh_sizes(mesh)
    tp = shape.get("tp", 1)
    sp = shape.get("sp", 1)
    if tp <= 1:
        return False, "tp axis is 1: no tensor collectives to overlap"
    if cfg.pipeline_microbatches > 0:
        return False, "pipelined stacks run the pipeline's own manual path"
    if cfg.n_experts > 0:
        return False, "MoE dispatch is not on the overlapped path"
    if cfg.lora_rank > 0:
        return False, "LoRA adapters are not on the overlapped path"
    if cfg.n_heads % tp or cfg.kv_heads % tp or cfg.d_ff % tp:
        return False, (
            f"heads/kv/ff must divide tp: n_heads={cfg.n_heads}, "
            f"kv_heads={cfg.kv_heads}, d_ff={cfg.d_ff}, tp={tp}"
        )
    if sp > 1 and cfg.attn_impl not in RING_FAMILY:
        return False, (
            f"sp={sp} needs a ring-family attn_impl, got {cfg.attn_impl!r}"
        )
    if cfg.attn_impl == "ulysses" and sp > 1 and (cfg.n_heads // tp) % sp:
        return False, (
            f"ulysses needs tp-local heads divisible by sp: "
            f"{cfg.n_heads} heads / tp={tp} vs sp={sp}"
        )
    if seq_len is not None and seq_len % (sp * tp):
        return False, (
            f"sequence {seq_len} must divide sp*tp={sp * tp} to "
            "sequence-shard the residual stream"
        )
    if batch is not None and batch % (shape.get("dp", 1) * shape.get("fsdp", 1)):
        return False, (
            f"batch {batch} must divide dp*fsdp="
            f"{shape.get('dp', 1) * shape.get('fsdp', 1)}"
        )
    return True, ""


def _use_overlap(cfg: TransformerConfig, mesh, seq_len, batch) -> bool:
    """The ``HIVED_OVERLAP`` / ``cfg.overlap`` gate, the JAX package's:
    ``HIVED_OVERLAP=0`` always forces the reference path (the
    differential-parity contract); ``cfg.overlap`` False opts out, True
    requires the stack (raising ``ValueError`` where it cannot serve the
    config), None takes it whenever it applies."""
    if envflags.get("HIVED_OVERLAP", "") == "0":
        return False
    if cfg.overlap is False:
        return False
    ok, reason = overlap_applicable(cfg, mesh, seq_len, batch)
    if cfg.overlap is True and not ok:
        raise ValueError(
            f"cfg.overlap=True but the overlapped path cannot serve this "
            f"config: {reason}"
        )
    return ok


def _overlapped_stack(x: torch.Tensor, lps: list, positions: torch.Tensor,
                      cfg: TransformerConfig, attn_fn,
                      shards: sharding.MeshShards) -> torch.Tensor:
    """Run the layers ``lps`` (:func:`layer_leaves`) as the JAX package's
    ``_overlapped_stack``, each under ``cfg.remat``: the stream ``x`` (this
    rank's sp slice, the same on every tp rank) enters sequence-sharded
    over (sp, tp), sp-major, so rank (sp i, tp j) holds token block i tp +
    j; fsdp shards are gathered where each layer uses them; and the result
    leaves in the reference layout again, the rank's sp slice whole over
    tp, so the final norm, the head and the loss run as on the reference
    path."""
    global OVERLAPPED_STACKS
    OVERLAPPED_STACKS += 1
    tp = shard_utils.RingAxis.from_mesh(shards.mesh, "tp")
    layer = _remat_wrap(_apply_layer_overlapped, cfg)
    x = shards.tp_part(x)
    for lp in lps:
        x = layer(x, lp, positions, cfg, attn_fn, shards, tp)
    return shards.tp_gather(x)


@functools.lru_cache(maxsize=None)
def _layer_specs(moe: bool) -> Dict[str, tuple]:
    """Each layer leaf's spec without the stacked layer axis, the adapters'
    included."""
    cfg = TransformerConfig(n_experts=2 if moe else 0, lora_rank=1, lora_mlp=not moe)
    return {name: spec[1:] for name, spec in sharding_specs(cfg)["layers"].items()}


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
    """The collectives of ``mesh`` (None for none), after ``check_mesh``; a
    pipelined model needs a mesh, as in the JAX package."""
    if mesh is None:
        if cfg.pipeline_microbatches > 0:
            raise ValueError(f"{cfg.attn_impl}/pipeline requires a mesh")
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


def embed_tokens(params: Dict[str, Any], tokens: torch.Tensor,
                 cfg: TransformerConfig,
                 shards: Optional[sharding.MeshShards] = None) -> torch.Tensor:
    """tokens [B, T] -> their embeddings [B, T, D] in the compute dtype
    (under a mesh the table is gathered over fsdp where it is used)."""
    if shards is None:
        embed = params["embed"]
    else:
        embed = shards.weight(sharding.local(params["embed"]),
                              sharding_specs(cfg)["embed"], None)
    return F.embedding(tokens, embed).to(cfg.dtype)


def token_positions(tokens: torch.Tensor,
                    shards: Optional[sharding.MeshShards] = None) -> torch.Tensor:
    """[1, T]: each of ``tokens``' positions in the whole sequence (over sp
    the rank's slice starts at its index times its length), for RoPE."""
    t = tokens.shape[1]
    start = 0 if shards is None else shards.seq_index * t
    return torch.arange(start, start + t, dtype=torch.int32,
                        device=tokens.device)[None, :]


def layer_leaves(layers: Dict[str, Any]) -> list:
    """The per-layer leaves of a stacked ``layers`` tree (this rank's local
    layers under a mesh): one unbind per stacked leaf, since indexing
    leaf[i] per layer would make each backward write a zero gradient of the
    whole stack per layer."""
    per_layer = {name: torch.unbind(sharding.local(leaf))
                 for name, leaf in layers.items()}
    n = len(next(iter(per_layer.values())))
    return [{name: leaves[i] for name, leaves in per_layer.items()}
            for i in range(n)]


def apply_layers(x: torch.Tensor, lps: list, positions: torch.Tensor,
                 cfg: TransformerConfig, attn_fn,
                 shards: Optional[sharding.MeshShards] = None):
    """Run ``x`` through the layers ``lps`` (:func:`layer_leaves`), each
    under ``cfg.remat`` -> (x, the layers' MoE aux losses summed, an f32
    scalar)."""
    layer = _remat_wrap(_apply_layer, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in lps:
        x, layer_aux = layer(x, lp, positions, cfg, attn_fn, shards)
        if layer_aux is not None:
            aux = aux + layer_aux
    return x, aux


def forward_with_aux(
    params: Dict[str, Any],
    tokens: torch.Tensor,
    cfg: TransformerConfig,
    mesh=None,
    return_hidden: bool = False,
    batch: Optional[int] = None,
):
    """tokens [B, T] int -> (logits [B, T, vocab] f32, aux loss f32 scalar:
    the MoE layers' weighted aux losses summed over layers, 0 for the dense
    model).

    ``return_hidden=True`` returns the final-norm hidden states [B, T, D]
    (model dtype) instead of logits, for the chunked cross-entropy loss.
    ``mesh``: a six-axis ``DeviceMesh`` over which ``params`` are DTensors
    laid out by ``sharding_specs`` and ``tokens`` are this rank's rows,
    whole sequences (a DTensor or its local tensor); the result is then
    this rank's rows at its sp slice of the positions
    (``MeshShards.seq_part``), replicated over tp.

    A pipelined model (``pipeline_microbatches > 0``) needs a mesh, as in
    the JAX package, and runs the layers as GPipe stages over its pp axis
    (``parallel/pipeline.forward``): the result is the last stage's, on
    every pp rank, and the aux the JAX package's pipelined one (each
    microbatch's and data shard's statistics, averaged). Above one stage
    this forward is not differentiable by autograd (the stages meet
    through sends); training differentiates the schedule itself
    (``parallel/pipeline.value_and_grad``).

    At tp above 1 the layers take the overlapped stack where
    :func:`_use_overlap` says so, for the whole sequence and ``batch``,
    the global batch these rows belong to (default: the rows times the
    data-parallel ranks, ``activation_spec``'s split)."""
    attn_fn = _resolve_attn_fn(cfg, mesh)
    shards = mesh_shards(mesh, cfg)
    tokens = sharding.local(tokens)
    seq_len = tokens.shape[1]
    if batch is None:
        batch = tokens.shape[0]
        if shards is not None:
            batch *= shards.sizes["dp"] * shards.sizes["fsdp"]
    if shards is not None:
        tokens = shards.seq_part(tokens)
    if cfg.pipeline_microbatches > 0:
        from hivedscheduler_tpu_torch.parallel import pipeline

        x, aux = pipeline.forward(params, tokens, cfg, attn_fn, shards)
    elif _use_overlap(cfg, mesh, seq_len, batch):
        # dense only (the gate refuses MoE), so there is no aux
        x = _overlapped_stack(embed_tokens(params, tokens, cfg, shards),
                              layer_leaves(params["layers"]),
                              token_positions(tokens, shards), cfg, attn_fn, shards)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        x, aux = apply_layers(embed_tokens(params, tokens, cfg, shards),
                              layer_leaves(params["layers"]),
                              token_positions(tokens, shards), cfg, attn_fn, shards)
    x = _rms_norm(x, sharding.local(params["final_norm"]))
    if return_hidden:
        return x, aux
    logits = torch.einsum("btd,dv->btv", x, lm_head_weight(params, cfg, shards))
    return logits.float(), aux


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            cfg: TransformerConfig, mesh=None) -> torch.Tensor:
    """tokens [B, T] int -> logits [B, T, vocab] (f32)."""
    return forward_with_aux(params, tokens, cfg, mesh)[0]
