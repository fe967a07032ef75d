"""Sequence-parallel attention: the ring family and Ulysses.

Counterpart of ``hivedscheduler_tpu/parallel/ring_attention.py``. Every
function takes one rank's local tensors: q ``[B, T/sp, H, D]`` and compact
GQA k/v ``[B, T/sp, H_kv, D]``, this rank's contiguous slice of the
sequence (the model's layout), and an :class:`SeqAxis`, the rank's place
on the ``sp`` axis of the mesh (``shard_utils.RingAxis``, whose tagged
transfers the collective matmuls and the pipeline share too). Where the
JAX package rotates k/v with ``lax.ppermute`` inside ``shard_map``, the
port posts ``isend``/``irecv`` pairs to the next and previous ranks of the
``sp`` process group, the next hop's transfer before the current hop's
compute (XLA overlaps the ppermute likewise). At sp = 1 no transfer is
made: the ring is one diagonal hop.

- :func:`ring_attention`: online softmax over einsum blocks, with a
  hand-written backward ring (``_RingCore``, the counterpart of
  ``_make_vjp_core``): q, do and the softmax statistics stay put while
  k/v travel with their f32 dk/dv accumulators, which take one last hop
  home.
- :func:`ring_flash_attention`: the same schedule with every hop through
  the flash kernels' f32 forms (``ops/attention.py`` ``flash_forward(...,
  out_dtype=f32)``, ``flash_backward(..., grad_dtype=f32)``): K1 gives a
  hop's partial o and lse, :func:`_merge_flash_partial` merges them, and
  K2/K3 take the merged o and lse. A hop from an earlier rank is unmasked,
  the rank's own hop is the causal diagonal, a later rank's is skipped.
- :func:`zigzag_ring_attention` and :func:`zigzag_ring_flash_attention`:
  the balanced causal schedule. Rank i holds sequence chunks (i, 2n-1-i)
  after a relayout (``_ZigzagRelayout``, whose backward is the inverse
  permutation), and every hop costs every rank the same quarter-blocks.
- :func:`ulysses_attention`: a differentiable all-to-all swaps the
  sharded axis from sequence to heads, the plain attention runs on the
  whole sequence, and a second all-to-all swaps back.

Routing, as the JAX package's: on any device a head dim that is not a
multiple of 8 takes the einsum ring (counted in ``RING_REFERENCE_ROUTES``),
as JAX's rings do on every backend. Otherwise on a CUDA tensor the flash
rings launch the f32 kernels at every hop, or raise. On a CPU tensor they
run the kernels' plain versions where JAX's interpret-mode kernels would
run, and the einsum ring where JAX falls back: shapes that do not tile,
or inside a mesh context (a non-empty ``mesh_axes``), where the Pallas
interpreter cannot run under the vma checker.

The per-hop functions (``_flash_block``, ``_merge_flash_partial``,
``_flash_block_grad``, ``_ring_hop``, ``_zigzag_hops``) are module-level,
so a single process can replay a whole ring's hop schedule.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from hivedscheduler_tpu_torch.ops import attention
from hivedscheduler_tpu_torch.parallel.shard_utils import RingAxis as SeqAxis
from hivedscheduler_tpu_torch.parallel.shard_utils import Transfer as _Transfer
from hivedscheduler_tpu_torch.parallel.shard_utils import rotate as _rotate

NEG_INF = -1e30
_CLAMP = -0.5 * abs(NEG_INF)  # the m_safe clamp of fully masked rows

# calls of the flash rings that took the einsum ring, by the JAX package's
# route rules (a head dim not a multiple of 8; on the CPU also shapes that
# do not tile, or a mesh context)
RING_REFERENCE_ROUTES = 0


def _ring_blocks(axis: SeqAxis, *tensors):
    """Yield (src, blocks) for each of the axis' ring steps: at step s this
    rank holds the blocks that started on rank ``index - s``. The next
    step's transfer is posted before a step's blocks are yielded, so it
    overlaps the caller's compute; none trails the last step."""
    cur = list(tensors)
    for step in range(axis.size):
        nxt = _rotate(axis, cur) if step < axis.size - 1 else None
        yield (axis.index - step) % axis.size, cur
        if nxt is not None:
            cur = nxt.wait()


def _pass_on(axis: SeqAxis, *grads) -> List[torch.Tensor]:
    """Send gradient accumulators one hop along the ring with their k/v
    (after the step's compute has added to them); the last call brings
    them home. Tags 2.. keep them apart from the k/v transfer in flight."""
    if axis.size == 1:
        return list(grads)
    return _rotate(axis, grads, tag=2).wait()


class _RingCore(torch.autograd.Function):
    """A ring schedule with its hand-written backward, the counterpart of
    the JAX package's ``_make_vjp_core``: ``forward_fn(q, k, v) -> (out,
    *stats)`` and ``backward_fn(q, k, v, out, *stats, g) -> (dq, dk, dv)``.
    Only (q, k, v, out, stats) are kept, never a score block, so the
    backward's memory is that of one local block."""

    @staticmethod
    def forward(ctx, q, k, v, forward_fn, backward_fn):
        out, *stats = forward_fn(q, k, v)
        ctx.save_for_backward(q, k, v, out, *stats)
        ctx.backward_fn = backward_fn
        return out

    @staticmethod
    def backward(ctx, g):
        return (*ctx.backward_fn(*ctx.saved_tensors, g), None, None)


# -- the einsum ring ---------------------------------------------------------


def _positions(start: int, n: int, device) -> torch.Tensor:
    return start + torch.arange(n, device=device)


def _block_attention_pos(q, k, v, q_pos, k_pos, scale, masked: bool):
    """Online-softmax attention of a q block against one k/v block, with
    explicit per-row positions (zigzag chunks are not contiguous);
    ``masked=False`` skips the mask of a block known fully visible.

    q [B, Tq, H, D], k/v [B, Tk, H_kv, D] with H_kv dividing H (q head i
    reads kv head i // (H/H_kv) through grouped einsums). Returns (o [B, H,
    Tq, D], m [B, H, Tq], l [B, H, Tq]) in f32."""
    b, t_q, h, d = q.shape
    h_kv = k.shape[2]
    qg = q.float().reshape(b, t_q, h_kv, h // h_kv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if masked:
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
    # fully masked rows: exp(NEG_INF - NEG_INF) would be 1, so clamp
    m_safe = torch.clamp(s.amax(dim=-1), min=_CLAMP)
    p = torch.exp(s - m_safe[..., None])
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return (o.reshape(b, h, t_q, d), m_safe.reshape(b, h, t_q),
            p.sum(dim=-1).reshape(b, h, t_q))


def _block_grad(qh, doh, mh, lh, dh, kf, vf, q_pos, k_pos, scale, masked: bool):
    """Gradients of one attention block (the ring and zigzag backwards).
    qh/doh [B, H, Tq, D], mh/lh/dh [B, H, Tq], kf/vf [B, H_kv, Tk, D] f32.
    Returns (dq [B, H, Tq, D], dk/dv [B, H_kv, Tk, D]), dk/dv summed over
    each kv head's q group."""
    b, h, t_q, d = qh.shape
    h_kv = kf.shape[1]
    g = h // h_kv
    qg = qh.reshape(b, h_kv, g, t_q, d)
    dog = doh.reshape(b, h_kv, g, t_q, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * scale
    if masked:
        s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
    p = (torch.exp(s - mh.reshape(b, h_kv, g, t_q, 1))
         / lh.reshape(b, h_kv, g, t_q, 1))
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vf)
    ds = p * (dp - dh.reshape(b, h_kv, g, t_q, 1))
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf).reshape(b, h, t_q, d) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * scale
    return dq, dk, dv


def _merge_partial(acc, blk):
    """Merge one (o, m, l) online-softmax partial into an accumulator."""
    o_acc, m_acc, l_acc = acc
    o_blk, m_blk, l_blk = blk
    m_new = torch.maximum(m_acc, m_blk)
    corr_acc = torch.exp(m_acc - m_new)
    corr_blk = torch.exp(m_blk - m_new)
    return (o_acc * corr_acc[..., None] + o_blk * corr_blk[..., None], m_new,
            l_acc * corr_acc + l_blk * corr_blk)


def _zero_partial(b, h, t, d, device):
    return (torch.zeros((b, h, t, d), device=device),
            torch.full((b, h, t), NEG_INF, device=device),
            torch.zeros((b, h, t), device=device))


def _finish(acc, dtype) -> torch.Tensor:
    """The accumulated rows divided by their sums -> [B, T, H, D]."""
    o_acc, _, l_acc = acc
    l_safe = torch.where(l_acc == 0.0, torch.ones_like(l_acc), l_acc)
    return (o_acc / l_safe[..., None]).to(dtype).permute(0, 2, 1, 3)


def _ring_hop(src: int, index: int, causal: bool) -> Optional[bool]:
    """What rank ``index`` computes against the block of rank ``src``:
    None (skipped: every key is in the future), True (the causal
    diagonal) or False (unmasked)."""
    if not causal:
        return False
    if src > index:
        return None
    return src == index


def _ring_forward(q, k, v, axis: SeqAxis, causal: bool):
    """Forward ring: rotate k/v, accumulate the online softmax. Returns
    (out [B, Tq, H, D] in q's dtype, m and l [B, H, Tq] f32)."""
    b, t_q, h, d = q.shape
    t_k = k.shape[1]
    scale = 1.0 / (d**0.5)
    q_pos = _positions(axis.index * t_q, t_q, q.device)
    acc = _zero_partial(b, h, t_q, d, q.device)
    for src, (k_cur, v_cur) in _ring_blocks(axis, k, v):
        hop = _ring_hop(src, axis.index, causal)
        if hop is None:
            continue
        k_pos = _positions(src * t_k, t_k, q.device)
        acc = _merge_partial(acc, _block_attention_pos(
            q, k_cur, v_cur, q_pos, k_pos, scale, masked=causal))
    return _finish(acc, q.dtype).contiguous(), acc[1], acc[2]


def _ring_backward(q, k, v, out, m, l, g, axis: SeqAxis, causal: bool):
    """Backward ring: q, do and delta stay put while k/v travel with their
    dk/dv accumulators, which arrive home after a full rotation."""
    b, t_q, h, d = q.shape
    t_k, h_kv = k.shape[1], k.shape[2]
    scale = 1.0 / (d**0.5)
    qf = q.float().permute(0, 2, 1, 3)
    do = g.float().permute(0, 2, 1, 3)
    delta = torch.sum(do * out.float().permute(0, 2, 1, 3), dim=-1)
    m_safe = torch.clamp(m, min=_CLAMP)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    q_pos = _positions(axis.index * t_q, t_q, q.device)
    dq = torch.zeros((b, h, t_q, d), device=q.device)
    dk = torch.zeros((b, h_kv, t_k, d), device=q.device)
    dv = torch.zeros_like(dk)
    for src, (k_cur, v_cur) in _ring_blocks(axis, k, v):
        if _ring_hop(src, axis.index, causal) is not None:
            k_pos = _positions(src * t_k, t_k, q.device)
            dq_blk, dk_blk, dv_blk = _block_grad(
                qf, do, m_safe, l_safe, delta, k_cur.float().permute(0, 2, 1, 3),
                v_cur.float().permute(0, 2, 1, 3), q_pos, k_pos, scale, masked=causal)
            dq, dk, dv = dq + dq_blk, dk + dk_blk, dv + dv_blk
        dk, dv = _pass_on(axis, dk, dv)
    return (dq.permute(0, 2, 1, 3).to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def _ring_attention_local(q, k, v, axis: SeqAxis, causal: bool = True):
    """One rank's ring attention with its hand-written backward (memory of
    one local block, not of every ring step's saved scores)."""
    return _RingCore.apply(
        q, k, v, functools.partial(_ring_forward, axis=axis, causal=causal),
        functools.partial(_ring_backward, axis=axis, causal=causal))


# -- the ring over the flash kernels -----------------------------------------


def _flash_block(q, k, v, diag: bool):
    """One hop through K1's f32 form -> (o [B, H, Tq, D] f32, lse [B, H,
    Tq] f32). ``diag``: the aligned causal diagonal, else unmasked."""
    o, lse = attention.flash_forward(q, k, v, causal=diag, out_dtype=torch.float32)
    b, t_q, h, _ = q.shape
    return o.permute(0, 2, 1, 3), lse.reshape(b, h, t_q)


def _merge_flash_partial(acc, blk):
    """Merge (o, lse) partials: each o is normalised within its own hop, so
    the merged rows need no final division."""
    o_acc, lse_acc = acc
    o_blk, lse_blk = blk
    lse_new = torch.logaddexp(lse_acc, lse_blk)
    return (o_acc * torch.exp(lse_acc - lse_new)[..., None]
            + o_blk * torch.exp(lse_blk - lse_new)[..., None], lse_new)


def _flash_block_grad(q, k, v, out, lse, do, diag: bool):
    """One hop of the backward through K2's and K3's f32 forms, from the
    merged out (q's dtype) and the merged lse [B*H, Tq] -> (dq [B, Tq, H,
    D], dk, dv [B, Tk, H_kv, D]), all f32: exact partials that sum over the
    hops, since the kernels take the global lse."""
    return attention.flash_backward(q, k, v, out, lse, do, causal=diag,
                                    grad_dtype=torch.float32)


def _zero_flash_partial(b, h, t, d, device):
    return (torch.zeros((b, h, t, d), device=device),
            torch.full((b, h, t), NEG_INF, device=device))


def _ring_flash_forward(q, k, v, axis: SeqAxis, causal: bool):
    """Forward ring over flash blocks -> (out [B, Tq, H, D] in q's dtype,
    lse [B, H, Tq] f32, the one residual the backward kernels need)."""
    b, t_q, h, d = q.shape
    acc = _zero_flash_partial(b, h, t_q, d, q.device)
    for src, (k_cur, v_cur) in _ring_blocks(axis, k, v):
        hop = _ring_hop(src, axis.index, causal)
        if hop is not None:
            acc = _merge_flash_partial(acc, _flash_block(q, k_cur, v_cur, hop))
    return acc[0].permute(0, 2, 1, 3).to(q.dtype).contiguous(), acc[1]


def _ring_flash_backward(q, k, v, out, lse, g, axis: SeqAxis, causal: bool):
    """Backward ring over the flash backward kernels: q, out, lse and do
    stay put, k/v travel with their f32 dk/dv accumulators, which take one
    last hop home."""
    b, t_q, h, _ = q.shape
    lse_rows = lse.reshape(b * h, t_q).contiguous()
    dq = torch.zeros(q.shape, device=q.device)
    dk = torch.zeros(k.shape, device=q.device)
    dv = torch.zeros_like(dk)
    for src, (k_cur, v_cur) in _ring_blocks(axis, k, v):
        hop = _ring_hop(src, axis.index, causal)
        if hop is not None:
            dq_blk, dk_blk, dv_blk = _flash_block_grad(q, k_cur, v_cur, out, lse_rows, g, hop)
            dq += dq_blk
            dk += dk_blk
            dv += dv_blk
        dk, dv = _pass_on(axis, dk, dv)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _kernels_tile(q, k, block_q: int, block_k: int) -> bool:
    """The JAX package's condition for its flash ring: the local block
    tiles into ``block_q`` x ``block_k``, D is a multiple of 8 and H_kv
    divides H."""
    _, t, h, d = q.shape
    h_kv = k.shape[2]
    return not (t % min(block_q, t) or t % min(block_k, t) or d % 8 or h % h_kv)


def _einsum_route(q, k, mesh_axes, block_q: int, block_k: int) -> bool:
    """Whether a flash ring on these tensors takes the einsum ring instead,
    counted: on any device where D is not a multiple of 8, as JAX's ring
    does on every backend; on a CPU tensor also where JAX's interpret-mode
    kernels would not run (shapes that do not tile, or a mesh context). A
    CUDA tensor otherwise runs the kernels, which tile any T, or raises."""
    global RING_REFERENCE_ROUTES
    if q.device.type == "cpu":
        kernels = _kernels_tile(q, k, block_q, block_k) and not mesh_axes
    else:
        kernels = q.shape[3] % 8 == 0
    if kernels:
        return False
    RING_REFERENCE_ROUTES += 1
    return True


def _ring_flash_attention_local(q, k, v, axis: SeqAxis, causal: bool = True,
                                mesh_axes: Tuple[str, ...] = (), block_q: int = 128,
                                block_k: int = 128):
    """One rank's ring attention with every hop through the flash
    kernels' f32 forms (their plain versions on the CPU), or the einsum
    ring by JAX's route rules (see :func:`_einsum_route`)."""
    if _einsum_route(q, k, mesh_axes, block_q, block_k):
        return _ring_attention_local(q, k, v, axis, causal)
    return _RingCore.apply(
        q, k, v, functools.partial(_ring_flash_forward, axis=axis, causal=causal),
        functools.partial(_ring_flash_backward, axis=axis, causal=causal))


# -- the zigzag rings (balanced causal load) ---------------------------------
#
# With contiguous blocks the causal skip makes rank 0 compute 1 block and
# rank n-1 n blocks. In the zigzag layout rank i owns the half-chunks (i,
# 2n-1-i), and each ring step costs every rank the same quarter-blocks:
#   (hi_q, lo_k): always fully visible            -> unmasked
#   (hi_q, hi_k): src == i diagonal, src > i visible, else skipped
#   (lo_q, lo_k): src == i diagonal, i > src visible, else skipped
#   (lo_q, hi_k): never visible                   -> never computed


def _check_zigzag(q) -> None:
    if q.shape[1] % 2:
        raise ValueError(
            f"zigzag ring attention needs an even per-shard block to split "
            f"into two chunks; got {q.shape[1]} rows per shard "
            f"(require T % (2 * sp) == 0)")


def _zigzag_chunk_pos(chunk: int, half: int, device) -> torch.Tensor:
    return _positions(chunk * half, half, device)


def _zigzag_hops(src: int, index: int) -> List[Tuple[int, int, bool]]:
    """The quarter-blocks rank ``index`` computes against the k/v of rank
    ``src``, in order: (q half, k half, diagonal), halves 0 (lo) and 1
    (hi)."""
    hops = [(1, 0, False)]
    if src >= index:
        hops.append((1, 1, src == index))
    if index >= src:
        hops.append((0, 0, src == index))
    return hops


def _halves(x, half: int):
    return x[:, :half], x[:, half:]


def _zigzag_forward(q, k, v, axis: SeqAxis):
    """Forward zigzag ring (causal) over einsum blocks; the local rows are
    [chunk i, chunk 2n-1-i]. Returns (out, m, l) as ``_ring_forward``."""
    n, i = axis.size, axis.index
    b, t, h, d = q.shape
    half = t // 2
    scale = 1.0 / (d**0.5)
    q_halves = _halves(q.float(), half)
    pos = (_zigzag_chunk_pos(i, half, q.device),
           _zigzag_chunk_pos(2 * n - 1 - i, half, q.device))
    acc = [_zero_partial(b, h, half, d, q.device) for _ in range(2)]
    for src, (k_cur, v_cur) in _ring_blocks(axis, k, v):
        k_halves, v_halves = _halves(k_cur.float(), half), _halves(v_cur, half)
        k_pos = (_zigzag_chunk_pos(src, half, q.device),
                 _zigzag_chunk_pos(2 * n - 1 - src, half, q.device))
        for qh, kh, _ in _zigzag_hops(src, i):
            acc[qh] = _merge_partial(acc[qh], _block_attention_pos(
                q_halves[qh], k_halves[kh], v_halves[kh], pos[qh], k_pos[kh], scale,
                masked=qh == kh))
    out = torch.cat([_finish(a, q.dtype) for a in acc], dim=1).contiguous()
    return out, torch.cat([a[1] for a in acc], dim=2), torch.cat([a[2] for a in acc], dim=2)


def _zigzag_backward(q, k, v, out, m, l, g, axis: SeqAxis):
    """Backward zigzag ring: the same quarter-blocks; dk/dv travel with
    their k/v halves and arrive home after a full rotation."""
    n, i = axis.size, axis.index
    b, t, h, d = q.shape
    t_k, h_kv = k.shape[1], k.shape[2]
    half = t // 2
    scale = 1.0 / (d**0.5)
    qf = q.float().permute(0, 2, 1, 3)
    do = g.float().permute(0, 2, 1, 3)
    delta = torch.sum(do * out.float().permute(0, 2, 1, 3), dim=-1)
    m_safe = torch.clamp(m, min=_CLAMP)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    rows = (slice(0, half), slice(half, t))
    pos = (_zigzag_chunk_pos(i, half, q.device),
           _zigzag_chunk_pos(2 * n - 1 - i, half, q.device))
    dq = torch.zeros((b, h, t, d), device=q.device)
    dk = torch.zeros((b, h_kv, t_k, d), device=q.device)
    dv = torch.zeros_like(dk)
    for src, (k_cur, v_cur) in _ring_blocks(axis, k, v):
        kf = k_cur.float().permute(0, 2, 1, 3)
        vf = v_cur.float().permute(0, 2, 1, 3)
        k_pos = (_zigzag_chunk_pos(src, half, q.device),
                 _zigzag_chunk_pos(2 * n - 1 - src, half, q.device))
        for qh, kh, _ in _zigzag_hops(src, i):
            qs, ks = rows[qh], rows[kh]
            dq_blk, dk_blk, dv_blk = _block_grad(
                qf[:, :, qs], do[:, :, qs], m_safe[:, :, qs], l_safe[:, :, qs],
                delta[:, :, qs], kf[:, :, ks], vf[:, :, ks], pos[qh], k_pos[kh], scale,
                masked=qh == kh)
            dq[:, :, qs] += dq_blk
            dk[:, :, ks] += dk_blk
            dv[:, :, ks] += dv_blk
        dk, dv = _pass_on(axis, dk, dv)
    return (dq.permute(0, 2, 1, 3).to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


def _zigzag_exchange(x, axis: SeqAxis, inverse: bool) -> torch.Tensor:
    """Permute [B, T_loc, ...] rows between the contiguous layout (rank s
    holds half-chunks 2s, 2s+1) and the zigzag layout (rank s holds chunks
    s, 2n-1-s); ``inverse`` goes back. Each rank sends and receives two
    half-chunks, tagged with their chunk number."""
    n, i = axis.size, axis.index
    if n == 1:
        return x
    half = x.shape[1] // 2
    lo, hi = _halves(x, half)

    def owner(c):  # zigzag owner of half-chunk c; its contiguous owner is c // 2
        return c if c < n else 2 * n - 1 - c

    mine_zz = (i, 2 * n - 1 - i)  # this rank's chunks in the zigzag layout
    mine_ct = (2 * i, 2 * i + 1)  # and in the contiguous one
    if not inverse:
        sends = [(owner(c), c, part) for c, part in zip(mine_ct, (lo, hi))]
        recvs = [(c // 2, c, lo) for c in mine_zz]
    else:
        sends = [(c // 2, c, part) for c, part in zip(mine_zz, (lo, hi))]
        recvs = [(owner(c), c, lo) for c in mine_ct]
    return torch.cat(_Transfer(axis, sends, recvs).wait(), dim=1)


class _ZigzagRelayout(torch.autograd.Function):
    """``_zigzag_exchange`` as a differentiable op: a permutation of rows
    across ranks, so its backward sends the gradient back by the inverse
    permutation."""

    @staticmethod
    def forward(ctx, x, axis, inverse):
        ctx.axis, ctx.inverse = axis, inverse
        return _zigzag_exchange(x, axis, inverse)

    @staticmethod
    def backward(ctx, g):
        return _zigzag_exchange(g, ctx.axis, not ctx.inverse), None, None


def _zigzag_wrap(q, k, v, axis: SeqAxis, forward_fn, backward_fn):
    """Relayout to zigzag, run a zigzag core, relayout the output back (at
    sp = 1 both layouts are the same)."""
    if axis.size == 1:
        return _RingCore.apply(q, k, v, forward_fn, backward_fn)
    qz, kz, vz = (_ZigzagRelayout.apply(x, axis, False) for x in (q, k, v))
    out = _RingCore.apply(qz, kz, vz, forward_fn, backward_fn)
    return _ZigzagRelayout.apply(out, axis, True)


def _zigzag_ring_attention_local(q, k, v, axis: SeqAxis):
    """One rank's zigzag ring attention over einsum blocks; q/k/v in the
    model's contiguous layout."""
    _check_zigzag(q)
    return _zigzag_wrap(q, k, v, axis, functools.partial(_zigzag_forward, axis=axis),
                        functools.partial(_zigzag_backward, axis=axis))


def _zigzag_flash_forward(q, k, v, axis: SeqAxis):
    """Forward zigzag over flash blocks -> (out [B, T, H, D] in q's dtype,
    lse [B, H, T] f32), rows in the zigzag order [chunk i, chunk 2n-1-i].
    The halves are copied contiguous for the kernels."""
    b, t, h, d = q.shape
    half = t // 2
    q_halves = [x.contiguous() for x in _halves(q, half)]
    acc = [_zero_flash_partial(b, h, half, d, q.device) for _ in range(2)]
    for src, (k_cur, v_cur) in _ring_blocks(axis, k, v):
        kv = [(kh.contiguous(), vh.contiguous())
              for kh, vh in zip(_halves(k_cur, half), _halves(v_cur, half))]
        for qh, kh, diag in _zigzag_hops(src, axis.index):
            acc[qh] = _merge_flash_partial(acc[qh], _flash_block(q_halves[qh], *kv[kh], diag))
    out = torch.cat([a[0].permute(0, 2, 1, 3) for a in acc], dim=1)
    return out.to(q.dtype).contiguous(), torch.cat([a[1] for a in acc], dim=2)


def _zigzag_flash_backward(q, k, v, out, lse, g, axis: SeqAxis):
    """Backward zigzag over the flash backward kernels: the same
    quarter-blocks; dk/dv accumulate in f32 on the travelling k/v and take
    the last hop home."""
    b, t, h, _ = q.shape
    half = t // 2
    rows = (slice(0, half), slice(half, t))
    per_half = [(q[:, r].contiguous(), out[:, r].contiguous(),
                 lse[:, :, r].reshape(b * h, half).contiguous(), g[:, r].contiguous())
                for r in rows]
    dq = torch.zeros(q.shape, device=q.device)
    dk = torch.zeros(k.shape, device=q.device)
    dv = torch.zeros_like(dk)
    for src, (k_cur, v_cur) in _ring_blocks(axis, k, v):
        kv = [(kh.contiguous(), vh.contiguous())
              for kh, vh in zip(_halves(k_cur, half), _halves(v_cur, half))]
        for qh, kh, diag in _zigzag_hops(src, axis.index):
            q_h, out_h, lse_h, g_h = per_half[qh]
            dq_blk, dk_blk, dv_blk = _flash_block_grad(q_h, *kv[kh], out_h, lse_h, g_h, diag)
            dq[:, rows[qh]] += dq_blk
            dk[:, rows[kh]] += dk_blk
            dv[:, rows[kh]] += dv_blk
        dk, dv = _pass_on(axis, dk, dv)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _zigzag_flash_attention_local(q, k, v, axis: SeqAxis, mesh_axes: Tuple[str, ...] = (),
                                  block_q: int = 128, block_k: int = 128):
    """One rank's zigzag ring with every quarter-block through the flash
    kernels' f32 forms, or the einsum zigzag by JAX's route rules (the
    tiles are per half-chunk)."""
    _check_zigzag(q)
    half = q.shape[1] // 2
    if _einsum_route(q[:, :half], k[:, :half], mesh_axes, block_q, block_k):
        return _zigzag_ring_attention_local(q, k, v, axis)
    return _zigzag_wrap(q, k, v, axis, functools.partial(_zigzag_flash_forward, axis=axis),
                        functools.partial(_zigzag_flash_backward, axis=axis))


# -- Ulysses -----------------------------------------------------------------


def _all_to_all(x, group, split: int, concat: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``x`` cut into the group's size along
    ``split``, piece j to rank j, the pieces received concatenated along
    ``concat`` in rank order."""
    n = dist.get_world_size(group)
    send = torch.stack(x.chunk(n, dim=split)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat)


class _AllToAll(torch.autograd.Function):
    """Differentiable ``_all_to_all``: its transpose is the all-to-all with
    ``split`` and ``concat`` swapped."""

    @staticmethod
    def forward(ctx, x, group, split, concat):
        ctx.group, ctx.split, ctx.concat = group, split, concat
        return _all_to_all(x, group, split, concat)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group, ctx.concat, ctx.split), None, None, None


def _ulysses_local(q, k, v, axis: SeqAxis, causal: bool = True):
    """All-to-all swap [B, T/sp, H, D] -> [B, T, H/sp, D], the plain
    attention, and the swap back. Compact GQA k/v travel on their own H_kv
    axis when H_kv divides by sp (contiguous head groups survive the
    split); otherwise each shared head is repeated for its group first."""
    sp = axis.size
    h, h_kv = q.shape[2], k.shape[2]
    if h % sp:
        raise ValueError(f"ulysses needs local heads divisible by sp: {h} heads, sp={sp}")
    if h_kv != h and h_kv % sp:
        k = torch.repeat_interleave(k, h // h_kv, dim=2)
        v = torch.repeat_interleave(v, h // h_kv, dim=2)
    if sp == 1:
        return attention.xla_attention(q, k, v, causal=causal)
    # split the heads, gather the sequence
    q, k, v = (_AllToAll.apply(x, axis.group, 2, 1) for x in (q, k, v))
    out = attention.xla_attention(q, k, v, causal=causal)
    return _AllToAll.apply(out, axis.group, 1, 2)


# -- public entry points -----------------------------------------------------


def _refuse_non_causal_zigzag(causal: bool, other: str) -> None:
    if not causal:
        raise ValueError(
            f"the zigzag schedule balances the CAUSAL skip; use {other} for "
            "non-causal attention")


def ring_attention(q, k, v, mesh, *, seq_axis: str = "sp",
                   causal: bool = True) -> torch.Tensor:
    """Exact attention of this rank's sequence block over the ``seq_axis``
    ring of ``mesh`` (a ``DeviceMesh``); q/k/v are the rank's local
    [B, T/sp, H(_kv), D] tensors, already sliced over the batch and head
    axes."""
    return _ring_attention_local(q, k, v, SeqAxis.from_mesh(mesh, seq_axis), causal)


def ring_flash_attention(q, k, v, mesh, *, seq_axis: str = "sp", causal: bool = True,
                         block_q: int = 128, block_k: int = 128) -> torch.Tensor:
    """:func:`ring_attention`'s contract with every hop through the flash
    kernels (memory O(T_loc x D) a rank, not O(T_loc^2)). It runs in the
    mesh's context, so on the CPU it takes the einsum ring, as JAX's
    interpret mode does."""
    return _ring_flash_attention_local(q, k, v, SeqAxis.from_mesh(mesh, seq_axis), causal,
                                       (seq_axis,), block_q, block_k)


def zigzag_ring_attention(q, k, v, mesh, *, seq_axis: str = "sp",
                          causal: bool = True) -> torch.Tensor:
    """Causal ring attention with the zigzag-balanced schedule (contiguous
    layout in and out; T/sp rows split into two chunks)."""
    _refuse_non_causal_zigzag(causal, "ring_attention")
    return _zigzag_ring_attention_local(q, k, v, SeqAxis.from_mesh(mesh, seq_axis))


def zigzag_ring_flash_attention(q, k, v, mesh, *, seq_axis: str = "sp",
                                causal: bool = True, block_q: int = 128,
                                block_k: int = 128) -> torch.Tensor:
    """The zigzag schedule with every quarter-block through the flash
    kernels (in the mesh's context: on the CPU the einsum zigzag)."""
    _refuse_non_causal_zigzag(causal, "ring_flash_attention")
    return _zigzag_flash_attention_local(q, k, v, SeqAxis.from_mesh(mesh, seq_axis),
                                         (seq_axis,), block_q, block_k)


def ulysses_attention(q, k, v, mesh, *, seq_axis: str = "sp",
                      causal: bool = True) -> torch.Tensor:
    """DeepSpeed-Ulysses sequence parallelism through all-to-all."""
    return _ulysses_local(q, k, v, SeqAxis.from_mesh(mesh, seq_axis), causal)
