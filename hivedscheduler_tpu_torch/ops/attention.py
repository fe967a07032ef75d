"""Attention for the port: the plain reference and flash attention, whose
forward and backward are hand-written CUDA kernels for Hopper.

Counterpart of ``hivedscheduler_tpu/ops/attention.py``. Layouts are the JAX
package's: q ``[B, T, H, D]``, k/v ``[B, T, H_kv, D]`` with ``H_kv``
dividing ``H`` and q heads grouped contiguously (q head i attends with kv
head ``i // (H // H_kv)``).

- :func:`xla_attention` is the plain reference; ``attn_impl="xla"``
  selects it, as in the JAX package.
- :func:`flash_attention_plain` and :func:`flash_backward_plain` are the
  plain PyTorch versions of the kernels: the same o and lse, and the same
  dq, dk and dv, with the same masking constants.
- :func:`flash_forward` runs ``csrc/flash_fwd.cu`` (K1) and
  :func:`flash_backward` runs ``csrc/flash_bwd.cu`` (K2 for dq, then K3 for
  dk and dv) on CUDA tensors, or raises; on CPU tensors they run the plain
  versions.
- ``out_dtype=torch.float32`` (forward) and ``grad_dtype=torch.float32``
  (backward) are the JAX package's ``_flash_forward(out_dtype=)`` and
  ``_flash_backward(grad_dtype=)``: the kernels' f32 forms
  (``hived_flash_fwd_f32``, ``hived_flash_bwd_dq_f32``,
  ``hived_flash_bwd_dkv_f32``), which the sequence-parallel ring
  (``parallel/ring_attention.py``) calls once a hop and merges in f32.
- :class:`FlashAttention` joins them as one differentiable op, the
  counterpart of the JAX package's ``_flash_core`` custom_vjp, and
  :func:`flash_attention` is what ``attn_impl="flash"`` calls: on a CUDA
  tensor the kernels, for every shape (they tile a ragged T themselves), or
  an error; on a CPU tensor the JAX package's shape rules choose between
  the plain versions and the reference.

The kernels replace ``hivedscheduler_tpu/ops/attention.py::_fwd_kernel``,
``::_bwd_dq_kernel`` and ``::_bwd_dkv_kernel``. All three run wgmma on
TMA-fed shared tiles with a producer warpgroup and two consumer warpgroups
(``csrc/hopper.cuh``). The wrappers
keep their C entry points: pointers, dims, [B, T, H] element strides and
the stream; the tensor maps are encoded inside. On an H100 the tensor cores
bound all three: at the flagship shape (B=8, T=2048, H=16, H_kv=8, D=128,
causal) K1 does 137.5 GFLOP (0.139 ms at 989 TFLOP/s; its 202 MB would
take 0.060 ms at 3.35 TB/s), K2 206.3 GFLOP (0.209 ms) and K3 275.0 GFLOP
(0.278 ms). Their measured times are in ``PERF.md``.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
_CLAMP = -0.5 * abs(NEG_INF)  # the m_safe clamp: masked rows exp() to 0

# launches of the CUDA kernels, each counted where it launches: the
# forward (K1), the dq backward (K2) and the dk/dv backward (K3)
FLASH_FWD_LAUNCHES = 0
FLASH_BWD_DQ_LAUNCHES = 0
FLASH_BWD_DKV_LAUNCHES = 0
# launches of their f32 forms (o, or dq, dk and dv, stored in f32), counted
# apart: only the sequence-parallel ring calls them
FLASH_FWD_F32_LAUNCHES = 0
FLASH_BWD_DQ_F32_LAUNCHES = 0
FLASH_BWD_DKV_F32_LAUNCHES = 0
# calls of flash_attention on the CPU that took the reference (shapes that
# don't tile, by the JAX package's rules)
FLASH_REFERENCE_ROUTES = 0

KERNEL_DTYPES = (torch.bfloat16,)
KERNEL_HEAD_DIMS = (64, 128)
# the output dtypes of the kernels' two forms (None: the input's bf16)
KERNEL_OUT_DTYPES = (None, torch.float32)


def _check_gqa(h: int, h_kv: int) -> None:
    if h % h_kv:
        raise ValueError(
            f"GQA needs n_heads divisible by kv heads: {h} % {h_kv} != 0"
        )


def _causal_mask(t_q: int, t_k: int, device) -> torch.Tensor:
    rows = torch.arange(t_q, device=device)[:, None]
    cols = torch.arange(t_k, device=device)[None, :]
    return rows >= cols


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """Reference attention: q [B, T, H, D], k/v [B, T, H_kv, D] ->
    [B, T, H, D] in q's dtype. Scores and softmax in f32; GQA through
    grouped einsums, without repeating k/v heads."""
    b, t_q, h, d = q.shape
    h_kv = k.shape[2]
    _check_gqa(h, h_kv)
    scale = 1.0 / (d**0.5)
    g = h // h_kv
    qg = q.float().reshape(b, t_q, h_kv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if causal:
        s = s.masked_fill(~_causal_mask(t_q, k.shape[1], q.device), NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, t_q, h, d).to(q.dtype)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, out_dtype=None):
    """Plain PyTorch version of the flash forward kernel -> (o [B, T, H, D]
    in ``out_dtype`` (default q's dtype), lse [B*H, T] f32).

    Same arithmetic as ``_fwd_kernel`` taken over the whole row at once:
    q scaled by 1/sqrt(D) in f32, masked scores at NEG_INF, the max clamped
    at -0.5e30 so a fully masked row gives p = 0, l == 0 guarded, and
    lse = max(m, -0.5e30) + log(l)."""
    b, t, h, d = q.shape
    h_kv = k.shape[2]
    _check_gqa(h, h_kv)
    g = h // h_kv
    qg = q.float().reshape(b, t, h_kv, g, d) * (1.0 / (d**0.5))
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if causal:
        s = s.masked_fill(~_causal_mask(t, k.shape[1], q.device), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.clamp(m, min=_CLAMP)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    o = o / l_safe.permute(0, 3, 1, 2, 4)  # [b,h_kv,g,t,1] -> [b,t,h_kv,g,1]
    lse = (m_safe + torch.log(l_safe)).reshape(b * h, t)
    return o.reshape(b, t, h, d).to(out_dtype or q.dtype), lse


def flash_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                         causal: bool = True, grad_dtype=None):
    """Plain PyTorch version of the flash backward kernels -> (dq, dk, dv)
    in ``grad_dtype`` (default q's, k's and v's dtypes), from the forward's
    o and lse [B*H, T] f32 and the output gradient do [B, T, H, D].

    Same arithmetic as ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` taken
    over whole rows: scores from q scaled by 1/sqrt(D) in f32, masked
    scores at NEG_INF, p = exp(s - lse), delta = sum_d do * o in f32 from o
    in its own dtype, ds = p (dp - delta), and the sum over a kv head's
    q-head group in f32."""
    b, t, h, d = q.shape
    h_kv = k.shape[2]
    _check_gqa(h, h_kv)
    g = h // h_kv
    scale = 1.0 / (d**0.5)
    qs = q.float().reshape(b, t, h_kv, g, d) * scale
    s = torch.einsum("bqhgd,bkhd->bhgqk", qs, k.float())
    if causal:
        s = s.masked_fill(~_causal_mask(t, k.shape[1], q.device), NEG_INF)
    p = torch.exp(s - lse.reshape(b, h_kv, g, t, 1))
    dof = do.float().reshape(b, t, h_kv, g, d)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dof, v.float())
    delta = (dof * o.float().reshape(b, t, h_kv, g, d)).sum(-1)  # [b,t,h_kv,g]
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qs)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dof)
    return (dq.reshape(b, t, h, d).to(grad_dtype or q.dtype),
            dk.to(grad_dtype or k.dtype), dv.to(grad_dtype or v.dtype))


# C entry points of the kernels: (library, pointer, int and stride argument
# counts); every call ends with the stream
_KERNELS = {
    "hived_flash_fwd": ("flash_fwd", 5, 6, 12),
    "hived_flash_bwd_dq": ("flash_bwd", 8, 6, 18),
    "hived_flash_bwd_dkv": ("flash_bwd", 8, 6, 18),
    "hived_flash_fwd_f32": ("flash_fwd", 5, 6, 12),
    "hived_flash_bwd_dq_f32": ("flash_bwd", 8, 6, 18),
    "hived_flash_bwd_dkv_f32": ("flash_bwd", 8, 6, 18),
}


def _launch(symbol: str, ptrs, dims, strided, stream, libs=None) -> None:
    """Launch a kernel on ``stream``: data pointers of ``ptrs``, the int
    ``dims``, and the [B, T, H] element strides of each of ``strided``.
    ``libs`` maps library names to loaded libraries (another checkout's,
    to compare kernels); by default this tree's, built at first use."""
    from hivedscheduler_tpu_torch.ops import _build

    lib, n_ptr, n_int, n_stride = _KERNELS[symbol]
    fn = getattr(libs[lib] if libs is not None else _build.load(lib), symbol)
    if fn.argtypes is None:
        # without argtypes ctypes passes Python ints as 32-bit C ints and
        # would cut every pointer
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_int64] * n_stride + [ctypes.c_void_p])
    err = fn(*(x.data_ptr() for x in ptrs), *dims,
             *(s for x in strided for s in x.stride()[:3]), stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")


def _check_kernel_inputs(q, k, v) -> None:
    """What the CUDA kernels take; anything else raises."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype not in KERNEL_DTYPES:
            raise TypeError(
                f"flash kernel takes {KERNEL_DTYPES}, {name} is {x.dtype}"
            )
        if not x.is_contiguous():
            raise ValueError(f"flash kernel needs contiguous inputs; {name} is not")
        if x.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                f"{name} requires grad: a raw kernel call is not "
                "differentiable; flash_attention (FlashAttention) is"
            )
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    b, t, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[1] != t or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    _check_gqa(h, k.shape[2])
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel head dims are {KERNEL_HEAD_DIMS}, got {d}")


def _kernel_readable(x: torch.Tensor) -> torch.Tensor:
    """``x`` if the kernels can read it through its strides (D contiguous,
    every row 16-byte aligned, and every other stride positive, as a TMA
    tensor map needs), else a contiguous copy: an output gradient arrives in
    whatever layout autograd made, an expanded one with strides of 0."""
    if (x.stride(-1) == 1 and all(s > 0 and s % 8 == 0 for s in x.stride()[:-1])
            and x.data_ptr() % 16 == 0):
        return x
    return x.contiguous()


def _is_f32(out_dtype, like: torch.Tensor) -> bool:
    """Whether the kernels store their outputs in f32 (the ``_f32`` entry
    points) rather than in the inputs' bf16; raises on any other dtype."""
    if out_dtype not in KERNEL_OUT_DTYPES:
        raise TypeError(f"flash kernels store the inputs' dtype (None) or {torch.float32}, "
                        f"not {out_dtype}")
    return out_dtype is not None


def _dims(q, k, causal: bool):
    b, t, h, d = q.shape
    return (b, t, h, k.shape[2], d, int(causal))


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _flash_forward_cuda(q, k, v, causal: bool, out_dtype=None):
    global FLASH_FWD_LAUNCHES, FLASH_FWD_F32_LAUNCHES
    _check_kernel_inputs(q, k, v)
    f32 = _is_f32(out_dtype, q)
    b, t, h, _ = q.shape
    o = torch.empty(q.shape, dtype=torch.float32 if f32 else q.dtype, device=q.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch("hived_flash_fwd_f32" if f32 else "hived_flash_fwd", (q, k, v, o, lse),
                _dims(q, k, causal), (q, k, v, o), _stream(q))
    if f32:
        FLASH_FWD_F32_LAUNCHES += 1
    else:
        FLASH_FWD_LAUNCHES += 1
    return o, lse


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, out_dtype=None):
    """-> (o [B, T, H, D] in ``out_dtype`` (default q's dtype; bf16 or
    f32), lse [B*H, T] f32). A CUDA tensor runs the kernel (or raises on
    what it does not take); a CPU tensor runs the plain version."""
    if q.device.type == "cuda":
        return _flash_forward_cuda(q, k, v, causal, out_dtype)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, out_dtype)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


def _check_backward_inputs(q, k, v, lse, **like_q) -> None:
    """The kernel inputs, lse, and the named tensors shaped like q."""
    _check_kernel_inputs(q, k, v)
    b, t, h, _ = q.shape
    for name, x in like_q.items():
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} {tuple(x.shape)} {x.dtype} on {x.device} "
                             f"does not match q {tuple(q.shape)} {q.dtype}")
    if (lse.shape != (b * h, t) or lse.dtype != torch.float32
            or lse.device != q.device or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous [B*H, T] f32 tensor, got "
                         f"{tuple(lse.shape)} {lse.dtype}")


def flash_backward_dq_cuda(q, k, v, o, lse, do, causal: bool = True, grad_dtype=None):
    """K2 alone on CUDA tensors -> (dq [B, T, H, D] in ``grad_dtype``
    (default q's dtype; bf16 or f32), delta [B*H, T] f32, the rowsum(do *
    o) that K3 reads). :func:`flash_backward` runs it."""
    global FLASH_BWD_DQ_LAUNCHES, FLASH_BWD_DQ_F32_LAUNCHES
    _check_backward_inputs(q, k, v, lse, o=o, do=do)
    f32 = _is_f32(grad_dtype, q)
    o, do = _kernel_readable(o), _kernel_readable(do)
    delta = torch.empty_like(lse)
    dq = torch.empty(q.shape, dtype=torch.float32 if f32 else q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _launch("hived_flash_bwd_dq_f32" if f32 else "hived_flash_bwd_dq",
                (q, k, v, o, do, lse, delta, dq), _dims(q, k, causal),
                (q, k, v, o, do, dq), _stream(q))
    if f32:
        FLASH_BWD_DQ_F32_LAUNCHES += 1
    else:
        FLASH_BWD_DQ_LAUNCHES += 1
    return dq, delta


def flash_backward_dkv_cuda(q, k, v, lse, delta, do, causal: bool = True, grad_dtype=None):
    """K3 alone on CUDA tensors -> (dk, dv [B, T, H_kv, D] in
    ``grad_dtype``, default k's dtype; bf16 or f32), with the GQA group
    sum done inside the kernel. :func:`flash_backward` runs it."""
    global FLASH_BWD_DKV_LAUNCHES, FLASH_BWD_DKV_F32_LAUNCHES
    _check_backward_inputs(q, k, v, lse, do=do)
    if delta.shape != lse.shape or delta.dtype != torch.float32:
        raise ValueError(f"delta must match lse, got {tuple(delta.shape)}")
    f32 = _is_f32(grad_dtype, k)
    do = _kernel_readable(do)
    dk = torch.empty(k.shape, dtype=torch.float32 if f32 else k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    with torch.cuda.device(q.device):
        _launch("hived_flash_bwd_dkv_f32" if f32 else "hived_flash_bwd_dkv",
                (q, k, v, do, lse, delta, dk, dv), _dims(q, k, causal),
                (q, k, v, do, dk, dv), _stream(q))
    if f32:
        FLASH_BWD_DKV_F32_LAUNCHES += 1
    else:
        FLASH_BWD_DKV_LAUNCHES += 1
    return dk, dv


def flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                   causal: bool = True, grad_dtype=None):
    """-> (dq, dk, dv) from the forward's o and lse and the output gradient
    do, in ``grad_dtype`` (default the inputs' dtypes; bf16 or f32). CUDA
    tensors run K2 then K3 (or raise on what they do not take); CPU tensors
    run the plain version."""
    if q.device.type == "cuda":
        dq, delta = flash_backward_dq_cuda(q, k, v, o, lse, do, causal, grad_dtype)
        return (dq, *flash_backward_dkv_cuda(q, k, v, lse, delta, do, causal, grad_dtype))
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, o, lse, do, causal, grad_dtype)
    raise ValueError(f"flash attention runs on cuda or cpu, not {q.device}")


def _refuse_dtensor(q, k, v) -> None:
    """The kernels read ``data_ptr()``; a DTensor's is its wrapper's, not
    its shard's. Under a mesh the model hands the op each rank's local
    shard (``models/transformer.py`` ``_dispatch_attention``)."""
    from torch.distributed.tensor import DTensor

    for name, x in (("q", q), ("k", k), ("v", v)):
        if isinstance(x, DTensor):
            raise TypeError(
                f"flash attention takes plain local tensors; {name} is a "
                f"DTensor (pass its to_local() shard)")


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention, the counterpart of the JAX package's
    ``_flash_core`` custom_vjp: the forward runs :func:`flash_forward` and
    keeps q, k, v, o and lse; the backward runs :func:`flash_backward`.
    A DTensor input raises ``TypeError``."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True):
        _refuse_dtensor(q, k, v)
        o, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_backward(q, k, v, o, lse, do, ctx.causal), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Differentiable flash attention: q [B, T, H, D], k/v [B, T, H_kv, D]
    -> [B, T, H, D], through :class:`FlashAttention`.

    A CUDA tensor always goes to the kernels, which tile any T themselves
    (K1 and K2 in 128-row q tiles, K3 in 64-key tiles) and raise on what
    they do not take (dtype, head dim, layout, a k length other than q's).
    A CPU tensor follows the JAX package's ``flash_attention``:
    :func:`xla_attention`, counted, where T is not divisible by ``block_q``
    or ``block_k``, D is not a multiple of 8, H is not divisible by H_kv, or
    k's length differs from q's; the plain versions of the kernels
    otherwise. A DTensor input raises ``TypeError``: the op takes each
    rank's local shard."""
    global FLASH_REFERENCE_ROUTES
    _refuse_dtensor(q, k, v)
    if q.device.type == "cpu":
        _, t, h, d = q.shape
        h_kv = k.shape[2]
        if (t % block_q or t % block_k or d % 8 or (h_kv and h % h_kv)
                or k.shape[1] != t):
            FLASH_REFERENCE_ROUTES += 1
            return xla_attention(q, k, v, causal=causal)
    return FlashAttention.apply(q, k, v, causal)


def attention_flops(b: int, t: int, h: int, d: int, causal: bool,
                    products: int = 2) -> int:
    """Multiply-add flops of ``products`` [row, D] x [D, key] products over
    the (row, key) pairs the mask leaves: the work a kernel must do on these
    shapes. The forward (K1) does 2 products."""
    pairs = t * (t + 1) // 2 if causal else t * t
    return 2 * products * b * h * d * pairs


def attention_bwd_flops(b: int, t: int, h: int, d: int, causal: bool) -> dict:
    """Flops of K2 (3 products: q k^T, do v^T, ds k), of K3 (4: q k^T and
    do v^T again, p^T do, ds^T q) and the least a backward can do (5: each
    product once)."""
    return {name: attention_flops(b, t, h, d, causal, products=n)
            for name, n in (("dq", 3), ("dkv", 4), ("least", 5))}


def attention_bytes(b: int, t: int, h: int, h_kv: int, d: int, out_bytes: int = 2) -> int:
    """Bytes the bf16 forward must move: q, k, v read once, o (of
    ``out_bytes`` an element: 2, or 4 for the f32 form) and the f32 lse
    written once."""
    return (b * t * h * d + 2 * b * t * h_kv * d) * 2 + b * t * h * d * out_bytes + b * h * t * 4


def attention_bwd_bytes(b: int, t: int, h: int, h_kv: int, d: int,
                        out_bytes: int = 2) -> dict:
    """Bytes each bf16 backward kernel must move, each input read once and
    each output written once (gradients of ``out_bytes`` an element: 2, or
    4 for the f32 forms): K2 reads q, k, v, o, do and lse and writes dq and
    the f32 delta; K3 reads q, k, v, do, lse and delta and writes dk and
    dv."""
    q_el, kv_el, row_bytes = b * t * h * d, b * t * h_kv * d, 4 * b * h * t
    return {"dq": 3 * 2 * q_el + q_el * out_bytes + 2 * 2 * kv_el + 2 * row_bytes,
            "dkv": 2 * 2 * q_el + 2 * 2 * kv_el + 2 * kv_el * out_bytes + 2 * row_bytes}


# -- paged KV reads ----------------------------------------------------------
# The serving engine's paged cache (models/serving.py) stores KV as a block
# pool [n_blocks, block, ...] shared by every stream; a per-row block table
# maps logical token positions to pool blocks. These two helpers are the one
# home of the position <-> (block, offset) mapping, as in the JAX package.


def gather_block_kv(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Per-row KV view of a paged block pool: ``pool`` [n_blocks, block,
    ...tail], ``table`` int [B, nbs] of block ids (entry j backs logical
    positions [j*block, (j+1)*block)). Returns a gathered copy [B,
    nbs*block, ...tail] whose axis 1 is the logical position, so a causal
    position mask applies unchanged; unassigned entries point at the trash
    block 0, whose garbage only sits at masked positions."""
    g = pool[table.long()]  # [B, nbs, block, ...tail]
    return g.reshape(g.shape[0], g.shape[1] * g.shape[2], *g.shape[3:])


def block_coords(positions: torch.Tensor, table: torch.Tensor, block: int):
    """(block id, in-block offset) coordinates for writing new KV at
    ``positions`` [B, S] through ``table`` [B, nbs] (a prefill passes a [1,
    nbs] row). Positions are clamped to the table's range [0, nbs*block):
    idle and parked rows sit at the clamp and write into their last table
    entry (the trash block, or a position at or past the row's live
    length), which no query attends before the row itself rewrites it."""
    nbs = table.shape[-1]
    pos = torch.clamp(positions.long(), max=nbs * block - 1)
    blk = torch.gather(table.long(), 1, pos // block)
    return blk, pos % block
