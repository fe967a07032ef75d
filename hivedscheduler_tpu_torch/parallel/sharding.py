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
  submesh of the six-axis mesh, or ``("fsdp", "pp", "ep", "tp")`` when pp
  is above 1: the only axes the parameter specs shard. Each data-parallel
  replica holds the same DTensor on its own submesh, as FSDP2's hybrid
  sharding does. In torch 2.13 DTensor's sharding propagation enumerates
  strategies over every mesh dim at once, so its cost grows exponentially
  with the mesh's rank: the first AdamW step over five small DTensor
  leaves took 112.4 s on a mesh of six size-1 dims against 0.084 s on two
  (torch 2.11: 0.05 s on six; ``tests/torch_mesh_probe.py``), 0.40 s on
  three and 2.26 s on four (CPU, torch 2.13). Four dims stay in seconds,
  so the pipeline shards the stacked layer axis over pp as a DTensor
  (``Shard(0)`` on pp) and ``torch.distributed.checkpoint`` reshards the
  ``[L, ...]`` stacks across pp layouts by itself; at pp = 1 the submesh
  keeps its three dims;
- fsdp (ZeRO-3): a weight is all-gathered over ``fsdp`` where it is used,
  and the gradient of that gather is a reduce-scatter, since the fsdp
  ranks read different rows;
- tp: heads and the MLP hidden dim stay local. The input of the
  column-parallel projections passes :meth:`MeshShards.to_tp` (identity
  forward, all-reduce of the gradient over ``tp``) and the outputs of the
  row-parallel ones :meth:`MeshShards.from_tp` (all-reduce forward,
  identity backward), so the residual stream and its gradient are the same
  on every tp rank;
- tp, overlapped (``models/transformer.py`` ``_overlapped_stack``, the
  JAX package's collective-matmul path): the residual stream enters
  sequence-sharded over tp (:meth:`MeshShards.tp_part`, this rank's block
  of its sp slice; the backward all-gathers, since the stream before is
  the same on every tp rank) and leaves whole again
  (:meth:`MeshShards.tp_gather`; the backward keeps the rank's block,
  since the loss after is computed the same way on every tp rank). A
  reduce-scatter in either place would scale every gradient by tp. Inside,
  the projections are ``shard_utils``' collective matmuls over the tp
  ring, and the norm weights, used on the rank's tokens
  only, pass :meth:`MeshShards.to_tp`, so their partial gradients are
  summed over tp in the backward (never in :meth:`MeshShards.sync_grad`,
  which leaves tp alone: the tp-sharded leaves' gradients are the rank's
  own);
- ep: the ep ranks read the same rows and each holds E/ep experts (and
  its tp slice of their hidden dim). Routing runs on every rank over all
  experts; the experts are a Megatron region over ``("ep", "tp")``: their
  input and gates pass :meth:`MeshShards.to_experts` (f) and their
  combined output :meth:`MeshShards.from_experts` (g), so everything
  outside the region, the router and the aux loss included, is computed
  the same way on every ep and tp rank, with the whole gradient;
- a frozen leaf (LoRA's base, which does not require grad) gets no
  gradient: its gather records no backward, so no reduce-scatter runs for
  it, and the step sums only the gradients it takes (the adapters');
- a weight gathered whole over ``tp`` (the vocab-sharded ``lm_head``) is
  used the same way on every tp rank, so the gradient of that gather is
  the rank's own slice, not a sum;
- sp: each rank holds its rows' whole token ids and computes one
  contiguous slice of every sequence (:meth:`MeshShards.seq_part`);
  attention crosses the slices (``parallel/ring_attention.py``, or the
  whole sequence gathered by :meth:`MeshShards.seq_gather` for ``xla``
  and ``flash``), everything else is position-local. Parameters are
  replicated along sp;
- MoE at sp above 1 keeps the unsharded routing (global capacity): the
  slot positions add the earlier sp ranks' per-expert counts
  (:meth:`MeshShards.seq_counts`, no gradient), and the experts' inputs,
  partial sums of each sp rank's tokens, are summed over sp before the
  experts and the outputs gathered after (:meth:`MeshShards.slots_sum`,
  :meth:`MeshShards.slots_gather`). These move partial sums of different
  tokens, so each backward is the collective's transpose (an all-reduce
  for an all-reduce, an all-gather for a reduce-scatter and the reverse),
  not Megatron's identity;
- pp (``parallel/pipeline.py``): stage s holds layers [s L/pp, (s+1)
  L/pp); ``embed``, ``final_norm`` and ``lm_head`` are replicated along pp
  and used by one stage each, the others giving them a zero gradient, so
  :meth:`MeshShards.sync_grad` sums them over pp as well;
- the loss is the global mean: each rank divides its part of the sum (its
  rows, its slice of the sequence) by the global count, and
  :meth:`MeshShards.data_sum` adds the ranks' parts over ``GRAD_AXES``
  with an identity backward, so each rank's gradients are its part's
  contribution; :meth:`MeshShards.sync_grad` then sums them over the axes
  the fsdp reduce-scatter has not already summed.

On a mesh axis of size 1 every operation here is the identity and no
collective is issued, so a one-GPU mesh computes exactly what the
single-device path does.

Decode and serving run on a mesh of their own, the two-axis ``("dp",
"tp")`` serving mesh: :class:`ServingShards` holds its collectives and
:class:`ServingLayout` a param tree's layout over it.
"""

from __future__ import annotations

import copy
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
    their optimizer moments live; with pp above 1, ``("fsdp", "pp", "ep",
    "tp")``, over which the pipeline shards the stacked layers."""
    axes = PARAM_AXES
    if dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)).get("pp", 1) > 1:
        axes += ("pp",)
    return mesh[tuple(a for a in mesh.mesh_dim_names if a in axes)]


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


class _OwnSlice(torch.autograd.Function):
    """This rank's block of ``dim`` over ``group``, from a tensor that is
    the same on every rank of it; the backward all-gathers the blocks'
    gradients, each rank's whole."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _own_slice(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group).contiguous(), None, None


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


class _AllReduceBoth(torch.autograd.Function):
    """Sum over ``group`` in the forward and in the backward: the
    transpose of a sum of partial sums that every rank then uses for its
    own part of the loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    """Sum over ``group`` and keep this rank's block of ``dim``; the
    backward all-gathers the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _reduce_scatter(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group).contiguous(), None, None


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

    # the axes over which the MoE routing statistics are meaned: every
    # rank's rows and slice, as GSPMD takes the JAX package's batch means;
    # a pipeline stage means over sp only (:meth:`in_stage`)
    stat_axes = GRAD_AXES

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

    def tp_part(self, x: torch.Tensor) -> torch.Tensor:
        """The overlapped stack's entry: this rank's tp block of the
        sequence (dim 1) of ``x``, which is the same on every tp rank (so
        rank (sp i, tp j) holds token block i tp + j); the backward
        all-gathers the blocks' gradients."""
        if "tp" not in self.groups:
            return x
        return _OwnSlice.apply(x, 1, self.groups["tp"])

    def tp_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The overlapped stack's exit: the sequence (dim 1) whole over tp
        from every tp rank's block, contiguous; the backward keeps this
        rank's block of the gradient, which every tp rank computes the
        same."""
        if "tp" not in self.groups:
            return x
        return _Gather.apply(x, x.dtype, ((1, self.groups["tp"], False),)).contiguous()

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

    def in_stage(self) -> "MeshShards":
        """These collectives inside a pipeline stage: the MoE statistics are
        meaned over sp only, per microbatch and data shard, as the JAX
        package's manual stage body takes them."""
        stage = copy.copy(self)
        stage.stat_axes = ("sp",)
        return stage

    def sum_over(self, x: torch.Tensor, axes: Tuple[str, ...]) -> torch.Tensor:
        """Sum over those of ``axes`` above 1; the gradient passes
        unchanged."""
        groups = tuple(self.groups[a] for a in axes if a in self.groups)
        return _AllReduceForward.apply(x, groups) if groups else x

    def data_mean(self, sums: torch.Tensor, count: int) -> torch.Tensor:
        """The mean over every rank's part along :attr:`stat_axes`
        (``GRAD_AXES``) of this rank's ``sums`` over ``count`` items: sums
        and counts are added over the axes in one all-reduce whose gradient
        passes unchanged, so each rank's gradient is its own part's
        contribution (as in :meth:`data_sum`). Rows held whole on every
        data rank (the replicated fallback of ``parallel/train.py``) count
        once per rank in both, so the mean is the same."""
        groups = tuple(self.groups[a] for a in self.stat_axes if a in self.groups)
        if not groups:
            return sums / count
        packed = torch.cat([sums.reshape(-1), sums.new_full((1,), float(count))])
        packed = _AllReduceForward.apply(packed, groups)
        return packed[:-1].reshape(sums.shape) / packed[-1]

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over ``GRAD_AXES``; the gradient passes unchanged, so each
        rank's gradient is its own part's contribution."""
        return self.sum_over(x, GRAD_AXES)

    def seq_part(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous slice ``seq_index`` of the sequence (dim 1)
        of whole rows, one of ``sizes["sp"]`` equal slices."""
        sp = self.sizes["sp"]
        if x.shape[1] % sp:
            raise ValueError(f"seq len {x.shape[1]} does not split over sp={sp}")
        t = x.shape[1] // sp
        return x[:, self.seq_index * t:(self.seq_index + 1) * t]

    def seq_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole sequence (dim 1) from every sp rank's slice, contiguous
        (the flash kernels take nothing else), differentiable: the ranks
        compute different parts of the loss, so the gradient is
        reduce-scattered back, each rank's slice summed over every rank."""
        return _Gather.apply(x, x.dtype, ((1, self.groups["sp"], True),)).contiguous()

    def seq_counts(self, counts: torch.Tensor) -> torch.Tensor:
        """[sp, ...]: every sp rank's ``counts``, in sp order (integer
        counts from one-hot masks; no gradient)."""
        return _all_gather(counts.detach()[None], 0, self.groups["sp"])

    def slots_sum(self, expert_in: torch.Tensor):
        """(the experts' inputs [E', B, C', D] summed over sp, whether they
        were scattered): each sp rank's tokens fill their own slots of
        ``expert_in`` [E', B, C, D], so the sum over sp is every expert's
        whole input. When sp divides the capacity C it is a reduce-scatter
        over C (each sp rank runs the experts on C / sp slots, C' = C / sp;
        the backward all-gathers), otherwise an all-reduce (C' = C; the
        backward all-reduces)."""
        group = self.groups["sp"]
        if expert_in.shape[2] % self.sizes["sp"] == 0:
            return _ReduceScatter.apply(expert_in, 2, group), True
        return _AllReduceBoth.apply(expert_in, group), False

    def slots_gather(self, expert_out: torch.Tensor) -> torch.Tensor:
        """The experts' outputs over every slot from each sp rank's block of
        the capacity dim (after a scattered :meth:`slots_sum`); each rank
        combines its own tokens from them, so the backward reduce-scatters."""
        return _Gather.apply(expert_out, expert_out.dtype,
                             ((2, self.groups["sp"], True),)).contiguous()

    def whole_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch on every rank, from each rank's rows (dp-major,
        fsdp-minor, as ``activation_spec`` lays them out)."""
        for axis in ("fsdp", "dp"):
            if axis in self.groups:
                x = _all_gather(x, 0, self.groups[axis])
        return x

    def sync_grad(self, grad_local: torch.Tensor, param) -> None:
        """Sum a parameter's local gradient, in place, over the
        ``GRAD_AXES`` and pp along which the DTensor ``param`` is replicated
        (along fsdp, where it is sharded, the gather's reduce-scatter has
        already summed it; along sp it never is; along pp the stacked
        layers are sharded, and the leaves replicated along it have their
        gradient on one stage)."""
        placed = dict(zip(param.device_mesh.mesh_dim_names, param.placements))
        for name in GRAD_AXES + ("pp",):
            sharded = name in placed and placed[name].is_shard()
            if name in self.groups and not sharded:
                dist.all_reduce(grad_local, group=self.groups[name])


def local(t: Any):
    """A DTensor's local shard (differentiable); a plain tensor as is."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def like_param(local_t: torch.Tensor, param) -> Any:
    """``local_t``, this rank's shard of a tensor laid out as the DTensor
    ``param`` (its gradient, say), as that DTensor; as is for a plain
    ``param``. No data moves."""
    from torch.distributed.tensor import DTensor

    if not isinstance(param, DTensor):
        return local_t
    return DTensor.from_local(local_t, param.device_mesh, param.placements,
                              run_check=False, shape=param.shape,
                              stride=param.stride())


# -- the serving mesh ---------------------------------------------------------
# the two axes of the decode and serving mesh, the JAX package's
# ``MeshAxes(dp=, tp=)``: rows over dp, heads, the MLP hidden dim and the
# vocabulary over tp. It is its own two-axis DeviceMesh, never laid over the
# six-axis training mesh (see the DTensor note above)
SERVING_AXES = ("dp", "tp")


def _local_leaf(leaf, spec, sizes: Dict[str, int], index: Dict[str, int]):
    """The slice of ``leaf`` this rank holds under ``spec``: each dim that
    names a serving axis above 1 is cut into equal blocks, the rank keeping
    its block in mesh order; other axes (fsdp, ep) are not on the serving
    mesh and leave their dims whole. A cut leaf is a copy with storage of
    its own, so the whole leaf can be freed once every rank has its block
    (a view would keep the whole storage alive)."""
    cut = leaf
    for dim, entry in enumerate(spec):
        for axis in spec_axes(entry):
            n = sizes.get(axis, 1)
            if n > 1:
                cut = cut.chunk(n, dim)[index[axis]]
    return leaf if cut is leaf else cut.clone(memory_format=torch.contiguous_format)


class ServingShards:
    """The collectives of a ``("dp", "tp")`` serving mesh that spans the
    whole process group. Decode and serving run under ``torch.no_grad``,
    so these are plain collectives, not autograd functions:

    - tp: each rank holds its heads (q, k, v and the kv cache's kv-head
      axis), its slice of the MLP hidden dim (each expert's too) and its
      slice of the vocabulary (``lm_head``); :meth:`tp_sum` adds the
      partial sums of the row-parallel projections (attention's output
      projection, the MLP's down projection) and :meth:`vocab_gather`
      joins the local logits [..., V/tp] into the whole [..., V], the same
      bytes on every tp rank, so argmax ties and sampling decide alike;
    - dp: each rank computes its block of rows (:meth:`row_range`);
      :meth:`gather_rows` joins the ranks' rows and :meth:`broadcast_from`
      sends a row's result from the rank that holds it;
    - :meth:`agree` gives every rank rank 0's reading of a host value (the
      engine's clock) and any rank's flag (a drain request) in one
      collective, so that host decisions are the same on every rank.

    On an axis of size 1 every operation is the identity and issues no
    collective, so a world-1 mesh runs exactly the single-device code (and
    a CUDA graph captures it as it does that code)."""

    def __init__(self, mesh):
        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        if names != SERVING_AXES:
            raise ValueError(f"the serving mesh has the axes {SERVING_AXES}, "
                             f"got {names}")
        self.mesh = mesh
        self.sizes = dict(zip(names, mesh.mesh.shape))
        self.dp, self.tp = self.sizes["dp"], self.sizes["tp"]
        self.groups = {name: mesh.get_group(name)
                       for name, size in self.sizes.items() if size > 1}
        self.index = {name: mesh.get_local_rank(name) for name in names}
        self.dp_index, self.tp_index = self.index["dp"], self.index["tp"]
        self.world = self.dp * self.tp
        if mesh.device_type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device(mesh.device_type)

    def local(self, tree: Any, specs: Any) -> Any:
        """This rank's leaves of a whole tree laid out by ``specs`` (the
        spec tree mirrors the tree; an int8 leaf's spec is a ``{"qi8",
        "scale"}`` dict like the leaf). ``specs`` None replicates the tree.
        With tp = 1 every leaf comes back as the same tensor; otherwise a
        tp-sharded leaf is a copy of this rank's block, so a caller that
        drops the whole tree holds ~1/tp of the sharded leaves' bytes."""
        if specs is None or self.tp == 1:
            return tree

        def walk(node, spec):
            if isinstance(node, dict):
                return {k: walk(v, spec[k]) for k, v in node.items()}
            return _local_leaf(node, spec, self.sizes, self.index)

        return walk(tree, specs)

    def tp_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The partial sums of a row-parallel projection, added in place
        over tp."""
        if "tp" in self.groups:
            dist.all_reduce(x, group=self.groups["tp"])
        return x

    def vocab_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[..., V/tp] local logits -> [..., V], tp ranks in mesh order."""
        if "tp" not in self.groups:
            return x
        return _all_gather(x, x.dim() - 1, self.groups["tp"]).contiguous()

    def row_range(self, n: int) -> Tuple[int, int]:
        """[lo, hi): this rank's block of ``n`` rows (n divides dp)."""
        per = n // self.dp
        return self.dp_index * per, (self.dp_index + 1) * per

    def row_owner(self, row: int, n: int) -> int:
        """The dp index that holds row ``row`` of ``n``."""
        return row // (n // self.dp)

    def local_rows(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.row_range(x.shape[0])
        return x[lo:hi]

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every dp rank's rows, in dp order, on every rank."""
        if "dp" not in self.groups:
            return x
        return _all_gather(x, 0, self.groups["dp"])

    def broadcast_from(self, x: torch.Tensor, owner: int) -> torch.Tensor:
        """``x`` as dp rank ``owner`` holds it, in place on every dp rank."""
        if "dp" in self.groups:
            group = self.groups["dp"]
            dist.broadcast(x, src=dist.get_global_rank(group, owner), group=group)
        return x

    def min_over_dp(self, x: torch.Tensor) -> torch.Tensor:
        if "dp" in self.groups:
            dist.all_reduce(x, op=dist.ReduceOp.MIN, group=self.groups["dp"])
        return x

    def agree(self, value: float, flag: bool = False) -> Tuple[float, bool]:
        """Rank 0's ``value``, and whether ``flag`` is set on any rank, on
        every rank of the mesh: one all-reduce (max) of [``value`` on rank
        0, -inf elsewhere; ``flag``] and one host sync."""
        if self.world == 1:
            return value, flag
        lead = self.dp_index == 0 and self.tp_index == 0
        t = torch.tensor([value if lead else float("-inf"), float(flag)],
                         dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        value, flag = t.tolist()
        return value, flag > 0


class ServingLayout:
    """How a whole tree's leaves lie over a serving mesh, the port's
    counterpart of a tree of JAX ``NamedSharding``: calling it on the whole
    tree gives this rank's local leaves (``specs`` None: replicated)."""

    def __init__(self, shards: ServingShards, specs: Any):
        self.shards = shards
        self.specs = specs

    def __call__(self, tree: Any) -> Any:
        return self.shards.local(tree, self.specs)
