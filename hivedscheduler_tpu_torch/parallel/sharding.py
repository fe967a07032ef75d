"""Shardings and the collectives of the port's data-, fully-sharded-,
expert-, tensor- and sequence-parallel paths.

In the JAX package GSPMD inserts the collectives that a ``PartitionSpec``
implies. The port runs one process per GPU and writes them out, as
Megatron-LM does, so that every rank computes on plain local tensors (the
flash kernels take nothing else):

- a spec is a tuple with one entry per tensor dim: ``None``, a mesh axis
  name, or a tuple of names (``("dp", "fsdp")``), as ``jax.sharding.
  PartitionSpec`` holds them; :func:`placements` turns it into DTensor
  placements over a mesh of the same axis names;
- parameters live on :func:`param_mesh`, the ``("fsdp", "ep", "tp")``
  submesh of the six-axis mesh: the only axes the parameter specs shard.
  Each data-parallel replica holds the same DTensor on its own submesh, as
  FSDP2's hybrid sharding does. In torch 2.13 DTensor's sharding
  propagation enumerates strategies over every mesh dim at once, so its
  cost grows exponentially with the mesh's rank: the first AdamW step
  over five small DTensor leaves took 112.4 s on a mesh of six size-1
  dims against 0.084 s on two (torch 2.11: 0.05 s on six;
  ``tests/torch_mesh_probe.py``), and 0.33 s on three;
- fsdp (ZeRO-3): a weight is all-gathered over ``fsdp`` where it is used,
  and the gradient of that gather is a reduce-scatter, since the fsdp
  ranks read different rows;
- tp: heads and the MLP hidden dim stay local. The input of the
  column-parallel projections passes :meth:`MeshShards.to_tp` (identity
  forward, all-reduce of the gradient over ``tp``) and the outputs of the
  row-parallel ones :meth:`MeshShards.from_tp` (all-reduce forward,
  identity backward), so the residual stream and its gradient are the same
  on every tp rank;
- ep: the ep ranks read the same rows and each holds E/ep experts (and
  its tp slice of their hidden dim). Routing runs on every rank over all
  experts; the experts are a Megatron region over ``("ep", "tp")``: their
  input and gates pass :meth:`MeshShards.to_experts` (f) and their
  combined output :meth:`MeshShards.from_experts` (g), so everything
  outside the region, the router and the aux loss included, is computed
  the same way on every ep and tp rank, with the whole gradient;
- a weight gathered whole over ``tp`` (the vocab-sharded ``lm_head``) is
  used the same way on every tp rank, so the gradient of that gather is
  the rank's own slice, not a sum;
- sp: each rank holds its rows' whole token ids and computes one
  contiguous slice of every sequence (:meth:`MeshShards.seq_part`);
  attention crosses the slices (``parallel/ring_attention.py``),
  everything else is position-local. Parameters are replicated along sp;
- the loss is the global mean: each rank divides its part of the sum (its
  rows, its slice of the sequence) by the global count, and
  :meth:`MeshShards.data_sum` adds the ranks' parts over ``GRAD_AXES``
  with an identity backward, so each rank's gradients are its part's
  contribution; :meth:`MeshShards.sync_grad` then sums them over the axes
  the fsdp reduce-scatter has not already summed.

On a mesh axis of size 1 every operation here is the identity and no
collective is issued, so a one-GPU mesh computes exactly what the
single-device path does.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# the data-parallel axes: ranks along them read different rows
DATA_AXES = ("dp", "fsdp")
# the axes along which ranks compute different parts of the loss (rows over
# the data axes, slices of the sequence over sp): the loss and the
# gradients of the parameters replicated along them are summed over these
GRAD_AXES = DATA_AXES + ("sp",)
# the axes the parameter specs shard: parameters live on this submesh
PARAM_AXES = ("fsdp", "ep", "tp")
# the axes of the experts' Megatron region (``MeshShards.to_experts``)
EXPERT_AXES = ("ep", "tp")


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name, or a tuple)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: Sequence, mesh) -> list:
    """DTensor placements over ``mesh`` for a spec: ``Shard(i)`` on every
    mesh axis named by entry i, ``Replicate()`` on the others. DTensor
    nests the shards of one dim in mesh order, so ``("dp", "fsdp")`` puts
    fsdp inside dp, as JAX lays the rows out."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, entry in enumerate(spec) if name in spec_axes(entry)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def param_mesh(mesh):
    """The ``("fsdp", "ep", "tp")`` submesh of a six-axis mesh (in the
    mesh's order, as ``DeviceMesh`` slices), on which the parameters and
    their optimizer moments live."""
    return mesh[PARAM_AXES]


def check_divisible(shape: Sequence[int], spec: Sequence, sizes: Dict[str, int],
                    what: str) -> None:
    """Raise ``ValueError`` when a sharded dim does not split evenly: the
    collectives here move equal shards."""
    for dim, entry in zip(shape, spec):
        n = 1
        for axis in spec_axes(entry):
            n *= sizes.get(axis, 1)
        if dim % n:
            raise ValueError(f"{what}: dim of size {dim} does not split over "
                             f"{spec_axes(entry)} ({n} ranks)")


def _quiet(fn, *args, **kwargs):
    # newer torch renames the tensor collectives and warns on every call
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return fn(*args, **kwargs)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((n * x0.shape[0],) + tuple(x0.shape[1:]))
    _quiet(dist.all_gather_into_tensor, out, x0, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    x0 = x.movedim(dim, 0).contiguous()
    out = x0.new_empty((x0.shape[0] // n,) + tuple(x0.shape[1:]))
    _quiet(dist.reduce_scatter_tensor, out, x0, group=group)
    return out.movedim(0, dim).contiguous()


def _own_slice(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    return x.chunk(n, dim)[dist.get_rank(group)].contiguous()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


class _Gather(torch.autograd.Function):
    """All-gather ``x`` along ``dim`` over each group of ``gathers`` in
    turn (cast to ``dtype`` first, so the gather moves compute-dtype
    bytes); the backward brings the gradient back to ``x``'s dtype and
    reduce-scatters it over a group whose ranks read different rows
    (``summed``) or keeps the rank's slice over one whose ranks compute
    the same thing."""

    @staticmethod
    def forward(ctx, x, dtype, gathers):
        ctx.gathers, ctx.in_dtype = gathers, x.dtype
        y = x.to(dtype)
        for dim, group, _ in gathers:
            y = _all_gather(y, dim, group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.to(ctx.in_dtype)
        for dim, group, summed in reversed(ctx.gathers):
            g = (_reduce_scatter if summed else _own_slice)(g, dim, group)
        return g, None, None


class _AllReduceForward(torch.autograd.Function):
    """Sum over ``groups`` in the forward; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, groups):
        for group in groups:
            x = _all_reduce(x, group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceBackward(torch.autograd.Function):
    """The identity in the forward; the gradient is summed over ``groups``."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        for group in ctx.groups:
            g = _all_reduce(g, group)
        return g, None


class MeshShards:
    """The collectives of one mesh. ``sizes`` maps each axis to its size;
    only the axes above 1 have a group, and an operation over an axis of
    size 1 is the identity."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
        self.groups = {name: mesh.get_group(name)
                       for name, size in self.sizes.items() if size > 1}
        # the slice of every sequence this rank computes, along sp
        self.seq_index = mesh.get_local_rank("sp") if "sp" in self.groups else 0
        # this rank's block of experts, along ep
        self.ep_index = mesh.get_local_rank("ep") if "ep" in self.groups else 0
        self._expert_groups = tuple(self.groups[a] for a in EXPERT_AXES
                                    if a in self.groups)

    def weight(self, local: torch.Tensor, spec: Sequence,
               dtype: Optional[torch.dtype], axes: Tuple[str, ...] = ("fsdp",)):
        """The weight whole along the dims that ``spec`` shards over
        ``axes`` (cast to ``dtype`` unless None), differentiable: summed
        back over fsdp, sliced back over tp."""
        gathers = tuple(
            (i, self.groups[axis], axis in DATA_AXES)
            for i, entry in enumerate(spec) for axis in spec_axes(entry)
            if axis in axes and axis in self.groups)
        if not gathers:
            return local if dtype is None else local.to(dtype)
        return _Gather.apply(local, dtype or local.dtype, gathers)

    def to_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f: the input of the column-parallel projections."""
        if "tp" not in self.groups:
            return x
        return _AllReduceBackward.apply(x, (self.groups["tp"],))

    def from_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's g: the partial sums of a row-parallel projection."""
        if "tp" not in self.groups:
            return x
        return _AllReduceForward.apply(x, (self.groups["tp"],))

    def to_experts(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's f over ep and tp: an input of the experts' region."""
        if not self._expert_groups:
            return x
        return _AllReduceBackward.apply(x, self._expert_groups)

    def from_experts(self, x: torch.Tensor) -> torch.Tensor:
        """Megatron's g over ep and tp: the experts' combined output, partial
        over this rank's experts and its tp slice of their hidden dim."""
        if not self._expert_groups:
            return x
        return _AllReduceForward.apply(x, self._expert_groups)

    def local_experts(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """This rank's block ``ep_index`` of the experts along ``dim``, one of
        ``sizes["ep"]`` equal blocks."""
        n = x.shape[dim] // self.sizes["ep"]
        return x.narrow(dim, self.ep_index * n, n)

    def data_mean(self, sums: torch.Tensor, count: int) -> torch.Tensor:
        """The mean over every rank's part along ``GRAD_AXES`` of this rank's
        ``sums`` over ``count`` items: sums and counts are added over the
        axes in one all-reduce whose gradient passes unchanged, so each
        rank's gradient is its own part's contribution (as in
        :meth:`data_sum`). Rows held whole on every data rank (the
        replicated fallback of ``parallel/train.py``) count once per rank
        in both, so the mean is the same."""
        groups = tuple(self.groups[a] for a in GRAD_AXES if a in self.groups)
        if not groups:
            return sums / count
        packed = torch.cat([sums.reshape(-1), sums.new_full((1,), float(count))])
        packed = _AllReduceForward.apply(packed, groups)
        return packed[:-1].reshape(sums.shape) / packed[-1]

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over ``GRAD_AXES``; the gradient passes unchanged, so each
        rank's gradient is its own part's contribution."""
        groups = tuple(self.groups[a] for a in GRAD_AXES if a in self.groups)
        return _AllReduceForward.apply(x, groups) if groups else x

    def seq_part(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous slice ``seq_index`` of the sequence (dim 1)
        of whole rows, one of ``sizes["sp"]`` equal slices."""
        sp = self.sizes["sp"]
        if x.shape[1] % sp:
            raise ValueError(f"seq len {x.shape[1]} does not split over sp={sp}")
        t = x.shape[1] // sp
        return x[:, self.seq_index * t:(self.seq_index + 1) * t]

    def whole_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch on every rank, from each rank's rows (dp-major,
        fsdp-minor, as ``activation_spec`` lays them out)."""
        for axis in ("fsdp", "dp"):
            if axis in self.groups:
                x = _all_gather(x, 0, self.groups[axis])
        return x

    def sync_grad(self, grad_local: torch.Tensor, param) -> None:
        """Sum a parameter's local gradient, in place, over the
        ``GRAD_AXES`` along which the DTensor ``param`` is replicated (along
        fsdp, where it is sharded, the gather's reduce-scatter has already
        summed it; along sp it never is)."""
        placed = dict(zip(param.device_mesh.mesh_dim_names, param.placements))
        for name in GRAD_AXES:
            sharded = name in placed and placed[name].is_shard()
            if name in self.groups and not sharded:
                dist.all_reduce(grad_local, group=self.groups[name])


def local(t: Any):
    """A DTensor's local shard (differentiable); a plain tensor as is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t
