"""Ring transport and the collective matmuls of overlapped tensor
parallelism.

Counterpart of ``hivedscheduler_tpu/parallel/shard_utils.py``. The JAX
package decomposes the all-gather and the reduce-scatter around a column-
or row-parallel projection into ``lax.ppermute``-pipelined chunks inside
``shard_map``, so that each hop transfers while the previous chunk
multiplies, and autodiff gives it the mirrored pipelines as the backward.
The port runs one process per GPU and writes both out:

- :class:`RingAxis`, :class:`Transfer` and :func:`rotate`: one rank's
  place on a ring of a mesh axis and tagged ``batch_isend_irecv``
  point-to-point transfers along it (gloo on the CPU, NCCL on the card),
  shared with the sequence-parallel rings (``ring_attention``) and the
  pipeline;
- :func:`allgather_matmul`: ``einsum(all_gather(x), w)`` for one or more
  column-parallel weights from ONE rotation of the sequence chunk;
- :func:`matmul_reducescatter`: ``reduce_scatter(einsum(x, w))`` for a
  row-parallel weight through a travelling accumulator.

Both are ``torch.autograd.Function``s with hand-written backwards, the
transposes JAX's autodiff derives: the dx of the all-gather pipeline is a
reduce-scatter pipeline sent the other way, and the dx of the
reduce-scatter pipeline an all-gather pipeline of the output gradient.
The one-hop steps (:func:`place_hop`, :func:`place_hop_grad`,
:func:`accumulate_hop`, :func:`accumulate_hop_grad`) are module-level, so
one process can replay a whole ring's schedule (``chip_smoke.py`` [w]).

Every transfer is posted before the hop's products and waited after them,
so at most one is in flight per rank and function; both sides issue the
same transfers in the same order (NCCL matches by order of issue, gloo by
tag). At size 1 both functions are the plain einsum, with no transfer.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class RingAxis:
    """One rank's place on a ring of a mesh axis: the process group (None
    at size 1, where nothing is sent), its size, the rank's index along it,
    and the global ranks of its neighbours."""

    def __init__(self, group=None, index: int = 0):
        self.group = group
        self.size = 1 if group is None else dist.get_world_size(group)
        self.index = index
        if not 0 <= index < self.size:
            raise ValueError(f"ring index {index} outside an axis of {self.size}")

    @classmethod
    def from_mesh(cls, mesh, name: str = "sp") -> "RingAxis":
        """The ``name`` axis of a ``DeviceMesh`` (its group only when the
        axis is above 1)."""
        size = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))[name]
        if size == 1:
            return cls()
        return cls(mesh.get_group(name), mesh.get_local_rank(name))

    def global_rank(self, index: int) -> int:
        return dist.get_global_rank(self.group, index)


class Transfer:
    """Point-to-point transfers within ``axis``, in flight until
    :meth:`wait`: ``sends`` are (peer index, tag, tensor), ``recvs`` (peer
    index, tag, a tensor shaped like the one to receive). A transfer to
    this rank itself is a copy. The tags tell apart two messages between
    one pair of ranks (gloo matches by tag, NCCL by the order of issue,
    the same on both sides)."""

    def __init__(self, axis: RingAxis, sends, recvs):
        own = {tag: x for peer, tag, x in sends if peer == axis.index}
        # the ops hold the sent tensors until the transfer completes
        self.ops = [dist.P2POp(dist.isend, x.contiguous(), axis.global_rank(peer),
                               axis.group, tag)
                    for peer, tag, x in sends if peer != axis.index]
        self.received = []
        for peer, tag, like in recvs:
            if peer == axis.index:
                self.received.append(own[tag].clone())
                continue
            buf = torch.empty(like.shape, dtype=like.dtype, device=like.device)
            self.received.append(buf)
            self.ops.append(dist.P2POp(dist.irecv, buf, axis.global_rank(peer),
                                       axis.group, tag))
        self.works = dist.batch_isend_irecv(self.ops) if self.ops else []

    def wait(self) -> List[torch.Tensor]:
        """The received tensors, in ``recvs``' order."""
        for work in self.works:
            work.wait()
        self.ops = None
        return self.received


def rotate(axis: RingAxis, tensors: Sequence[torch.Tensor], tag: int = 0,
           step: int = 1) -> Transfer:
    """Each tensor sent ``step`` ranks along the ring (+1: to the next
    rank, -1: to the previous one, JAX's ``i -> i - 1`` permutation), its
    counterpart received from ``step`` ranks back."""
    to, frm = (axis.index + step) % axis.size, (axis.index - step) % axis.size
    return Transfer(axis, [(to, tag + j, x) for j, x in enumerate(tensors)],
                    [(frm, tag + j, x) for j, x in enumerate(tensors)])


def _operands(eq: str) -> Tuple[str, str, str]:
    """(x, w, out) subscripts of ``"x,w->out"``."""
    ins, out = eq.replace(" ", "").split("->")
    x, w = ins.split(",")
    return x, w, out


def _rows(t: torch.Tensor, chunk: int, n: int) -> torch.Tensor:
    """Sequence (dim 1) block ``chunk`` of length ``n``."""
    return t[:, chunk * n:(chunk + 1) * n]


# -- the per-hop steps ----------------------------------------------------------


def place_hop(outs: Optional[List[torch.Tensor]], chunk: torch.Tensor,
              ws: Sequence[torch.Tensor], eq: str, src: int,
              size: int) -> List[torch.Tensor]:
    """One hop of :func:`allgather_matmul`: multiply the sequence chunk
    that started on rank ``src`` by every weight and place each product at
    its gathered position ``src`` of ``size`` (``outs`` None: allocate
    them). Returns ``outs``."""
    parts = [torch.einsum(eq, chunk, w) for w in ws]
    n = chunk.shape[1]
    if outs is None:
        outs = [p.new_empty((p.shape[0], n * size) + tuple(p.shape[2:])) for p in parts]
    for o, p in zip(outs, parts):
        _rows(o, src, n).copy_(p)
    return outs


def place_hop_grad(dys: Sequence[torch.Tensor], chunk: torch.Tensor,
                   ws: Sequence[torch.Tensor], eq: str, src: int):
    """The transpose of :func:`place_hop` for one chunk: (this rank's part
    of the chunk's gradient, the sum over the weights of dy_src w^T; each
    weight's part of its gradient, chunk^T dy_src)."""
    x_s, w_s, o_s = _operands(eq)
    n = chunk.shape[1]
    dx = None
    dws = []
    for dy, w in zip(dys, ws):
        dy_c = _rows(dy, src, n)
        part = torch.einsum(f"{o_s},{w_s}->{x_s}", dy_c, w)
        dx = part if dx is None else dx + part
        dws.append(torch.einsum(f"{x_s},{o_s}->{w_s}", chunk, dy_c))
    return dx, dws


def accumulate_hop(acc, x: torch.Tensor, w: torch.Tensor, eq: str, chunk: int,
                   size: int) -> torch.Tensor:
    """One hop of :func:`matmul_reducescatter`: this rank's partial product
    of output chunk ``chunk`` (of ``size``), added to the accumulator that
    arrived (``acc`` None: the first hop; a :class:`Transfer` still in
    flight is waited for after the product is issued)."""
    part = torch.einsum(eq, _rows(x, chunk, x.shape[1] // size), w)
    if acc is None:
        return part
    if isinstance(acc, Transfer):
        acc = acc.wait()[0]
    return acc + part


def accumulate_hop_grad(dy_chunk: torch.Tensor, w: torch.Tensor, eq: str) -> torch.Tensor:
    """The transpose of :func:`accumulate_hop`: the gradient of this rank's
    rows of chunk ``c`` of ``x`` from the output gradient of chunk ``c``."""
    x_s, w_s, o_s = _operands(eq)
    return torch.einsum(f"{o_s},{w_s}->{x_s}", dy_chunk, w)


# -- the pipelines --------------------------------------------------------------


class _AllGatherMatmul(torch.autograd.Function):
    """:func:`allgather_matmul` on a ring above 1. The backward keeps the
    chunks the forward received (the gathered input, as the unoverlapped
    path keeps it) and does not rotate them again: its dx is a
    reduce-scatter pipeline of dy w^T sent ``i -> i + 1``, the inverse of
    the forward's permutation, accumulated in JAX's transposed order, and
    each weight's dw is the sum over the hops of chunk^T dy_chunk."""

    @staticmethod
    def forward(ctx, x, axis, eq, *ws):
        size, idx = axis.size, axis.index
        chunk, chunks, outs = x, [], None
        for s in range(size):
            # the next hop before this chunk's products: it does not depend
            # on them, so the transfer runs under the GEMMs
            nxt = rotate(axis, [chunk], step=-1) if s + 1 < size else None
            outs = place_hop(outs, chunk, ws, eq, (idx + s) % size, size)
            chunks.append(chunk)
            if nxt is not None:
                chunk = nxt.wait()[0]
        ctx.axis, ctx.eq = axis, eq
        ctx.save_for_backward(*chunks, *ws)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *dys):
        axis, eq = ctx.axis, ctx.eq
        size, idx = axis.size, axis.index
        saved = ctx.saved_tensors
        chunks, ws = saved[:size], saved[size:]
        dx, dws = None, None
        for s in reversed(range(size)):
            pending = rotate(axis, [dx], step=1) if dx is not None else None
            part, parts = place_hop_grad(dys, chunks[s], ws, eq, (idx + s) % size)
            dws = parts if dws is None else [a + b for a, b in zip(dws, parts)]
            dx = part if pending is None else part + pending.wait()[0]
        return (dx, None, None, *dws)


class _MatmulReduceScatter(torch.autograd.Function):
    """:func:`matmul_reducescatter` on a ring above 1. The backward is the
    all-gather pipeline of the output gradient, sent ``i -> i + 1``: each
    hop gives the rows of one chunk of dx, and dw is x^T against the
    gathered dy."""

    @staticmethod
    def forward(ctx, x, w, axis, eq):
        size, idx = axis.size, axis.index
        acc = None
        for s in range(size):
            # the accumulator's hop rides under this step's GEMM
            pending = rotate(axis, [acc], step=-1) if acc is not None else None
            acc = accumulate_hop(pending, x, w, eq, (idx + s + 1) % size, size)
        ctx.axis, ctx.eq = axis, eq
        ctx.save_for_backward(x, w)
        return acc

    @staticmethod
    def backward(ctx, dy):
        axis, eq = ctx.axis, ctx.eq
        size, idx = axis.size, axis.index
        x, w = ctx.saved_tensors
        x_s, w_s, o_s = _operands(eq)
        n = dy.shape[1]
        g = dy
        dx = x.new_empty(x.shape)
        dy_all = dy.new_empty((dy.shape[0], n * size) + tuple(dy.shape[2:]))
        for s in reversed(range(size)):
            nxt = rotate(axis, [g], step=1) if s > 0 else None
            c = (idx + s + 1) % size
            _rows(dx, c, n).copy_(accumulate_hop_grad(g, w, eq))
            _rows(dy_all, c, n).copy_(g)
            if nxt is not None:
                g = nxt.wait()[0]
        dw = torch.einsum(f"{x_s},{o_s}->{w_s}", x, dy_all)
        return dx, dw, None, None


def allgather_matmul(x: torch.Tensor, ws, axis: RingAxis, eq: str):
    """Column-parallel collective matmul: ``einsum(eq, all_gather(x), w)``
    for each weight of ``ws`` with the gather decomposed into a ring
    pipeline, the JAX package's ``allgather_matmul``.

    ``x`` [B, T_loc, ...] is this rank's block of the sequence (dim 1) and
    each ``w`` its column shard. Every rank sends its current chunk to the
    previous rank (JAX's ``i -> i - 1``), so after s hops rank i holds the
    chunk of rank (i + s) % size; the next hop is posted before the
    current chunk's products. Each product lands at its gathered position,
    so every output element comes from the same local dot as the
    unoverlapped ``einsum(all_gather(x), w)``. Several weights share ONE
    rotation (the QKV and gate/up fusions). Returns one output [B,
    T_loc * size, ...] per weight; a bare weight gives a bare output."""
    single = not isinstance(ws, (list, tuple))
    ws_l = [ws] if single else list(ws)
    if axis.size == 1:
        outs = [torch.einsum(eq, x, w) for w in ws_l]
    else:
        outs = list(_AllGatherMatmul.apply(x, axis, eq, *ws_l))
    return outs[0] if single else outs


def matmul_reducescatter(x: torch.Tensor, w: torch.Tensor, axis: RingAxis,
                         eq: str) -> torch.Tensor:
    """Row-parallel collective matmul: ``reduce_scatter(einsum(eq, x, w))``
    over the sequence (dim 1) with the reduction decomposed into a
    travelling accumulator, the JAX package's ``matmul_reducescatter``.

    ``eq`` contracts the dim ``w`` is sharded on, so each rank holds a
    partial sum of the whole output. At step s rank i multiplies its rows
    of output chunk (i + s + 1) % size and adds them to the accumulator
    that arrived from rank i + 1, which then moves one hop on (``i -> i -
    1``); after ``size`` steps rank i holds its own chunk [B, T / size,
    ...] with every rank's contribution, added in JAX's ring order, so the
    port rounds each sum as JAX does."""
    if axis.size == 1:
        return torch.einsum(eq, x, w)
    if x.shape[1] % axis.size:
        raise ValueError(f"sequence {x.shape[1]} does not split over a ring "
                         f"of {axis.size}")
    return _MatmulReduceScatter.apply(x, w, axis, eq)
