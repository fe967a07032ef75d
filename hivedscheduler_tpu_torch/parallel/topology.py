"""Device meshes for the port's workloads, from the scheduler's handoff.

Counterpart of ``hivedscheduler_tpu/parallel/topology.py``. The JAX package
holds all of a host's chips in one process and lays a ``jax.sharding.Mesh``
over them; the port runs one process per GPU (PyTorch's idiom) and lays a
``torch.distributed`` ``DeviceMesh`` over the ranks of its process group,
with the JAX package's six axis names, so that a parameter's placements
line up with ``models.transformer.sharding_specs`` index for index.

Rank r sits at the row-major coordinate of r in ``(dp, fsdp, pp, ep, tp,
sp)``: the innermost axes (sp, then tp) vary fastest, so a tensor-parallel
group is made of neighbouring ranks, the GPUs of one NVSwitch node, as
JAX's ``make_mesh`` puts them on neighbouring ICI links.

``visible_chip_indices`` reads ``NVIDIA_VISIBLE_DEVICES``: the physical GPU
indices that HiveD's GPU handoff writes from the pod-leaf-cell-isolation
annotation (``CUDA_VISIBLE_DEVICES`` is renumbered from 0 inside a
container, so it cannot name the cells the scheduler granted).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

# the environment variable of the GPU handoff (the device plugin writes the
# isolation annotation's indices into it)
ENV_NVIDIA_VISIBLE_DEVICES = "NVIDIA_VISIBLE_DEVICES"
# values of NVIDIA_VISIBLE_DEVICES that name no index list
_NO_INDEX_LIST = ("", "all", "none", "void")


@dataclass(frozen=True)
class MeshAxes:
    """Logical parallelism axes: data, fully-sharded-data, pipeline,
    expert, tensor, sequence. Sizes multiply to the device count."""

    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    ep: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def names(self) -> Tuple[str, ...]:
        return ("dp", "fsdp", "pp", "ep", "tp", "sp")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.dp, self.fsdp, self.pp, self.ep, self.tp, self.sp)

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.pp * self.ep * self.tp * self.sp


def visible_chip_indices() -> Optional[List[int]]:
    """The physical GPU indices this pod was granted (the
    ``NVIDIA_VISIBLE_DEVICES`` handoff), or None when the variable names
    no index list (unset, empty, ``all``, ``none`` or ``void``)."""
    raw = os.environ.get(ENV_NVIDIA_VISIBLE_DEVICES, "").strip()
    if raw.lower() in _NO_INDEX_LIST:
        return None
    try:
        return [int(x) for x in raw.split(",") if x.strip() != ""]
    except ValueError:
        raise ValueError(
            f"{ENV_NVIDIA_VISIBLE_DEVICES}={raw!r} is not a list of GPU "
            f"indices (the scheduler's handoff writes indices, not UUIDs)"
        ) from None


def mesh_axes(mesh) -> MeshAxes:
    """The :class:`MeshAxes` of a six-axis ``DeviceMesh``."""
    return MeshAxes(**dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)))


def make_mesh(axes: MeshAxes, device_type: str = "cuda"):
    """A ``DeviceMesh`` with the six logical axes over the ranks of the
    default process group (which must exist: see
    ``parallel/distributed.initialize_from_gang``). Raises ``ValueError``
    when the axes do not multiply to the world size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group; call "
                           "initialize_from_gang first")
    world = dist.get_world_size()
    if axes.size != world:
        raise ValueError(
            f"mesh axes {axes.shape} require {axes.size} devices, have {world}"
        )
    return init_device_mesh(device_type, axes.shape, mesh_dim_names=axes.names)


def mesh_from_slice(slice_shape: Sequence[int], axes: MeshAxes,
                    device_type: str = "cuda"):
    """A mesh for a scheduler-allocated slice of the given shape (``(2,
    8)`` for two 8-GPU nodes): checks that the slice holds exactly the
    axes' devices and delegates to :func:`make_mesh`."""
    n = math.prod(slice_shape)
    if axes.size != n:
        raise ValueError(
            f"slice {tuple(slice_shape)} has {n} chips but mesh axes {axes.shape} "
            f"need {axes.size}"
        )
    return make_mesh(axes, device_type)


def infer_axes(n_devices: int, tp: int = 1, sp: int = 1, fsdp: int = 1,
               pp: int = 1, ep: int = 1) -> MeshAxes:
    """Fill the dp axis with whatever is left over."""
    rest = tp * sp * fsdp * pp * ep
    if n_devices % rest != 0:
        raise ValueError(
            f"{n_devices} devices not divisible by tp*sp*fsdp*pp*ep={rest}"
        )
    return MeshAxes(dp=n_devices // rest, fsdp=fsdp, pp=pp, ep=ep, tp=tp, sp=sp)


def _divisors_desc(k: int):
    return sorted((d for d in range(1, k + 1) if k % d == 0), reverse=True)


def elastic_axes(
    n_devices: int,
    *,
    tp: int = 1,
    sp: int = 1,
    fsdp: int = 1,
    pp: int = 1,
    ep: int = 1,
    n_heads: int = 0,
    n_kv_heads: int = 0,
    global_batch: int = 0,
    seq_len: int = 0,
) -> MeshAxes:
    """A valid mesh for whatever slice the scheduler offered: the requested
    degrees are preferences, shrunk only as far as the offered device count
    forces. Each axis takes the largest divisor of its requested degree
    that fits and dp absorbs the remainder. Sacrifice order when the full
    product does not fit: fsdp, then sp, then tp, then ep, then pp.
    ``n_heads``/``n_kv_heads`` must divide tp, ``global_batch`` dp*fsdp and
    ``seq_len`` sp where given. The same inputs always derive the same
    mesh."""
    if n_devices < 1:
        raise ValueError(f"need at least 1 device, offered {n_devices}")

    def fits(t: int, s: int, f: int, p: int, e: int) -> bool:
        rest = t * s * f * p * e
        if rest > n_devices or n_devices % rest:
            return False
        dp = n_devices // rest
        if n_heads and n_heads % t:
            return False
        if n_kv_heads and n_kv_heads % t:
            return False
        if global_batch and global_batch % (dp * f):
            return False
        if seq_len and seq_len % s:
            return False
        return True

    for p in _divisors_desc(pp):
        for e in _divisors_desc(ep):
            for t in _divisors_desc(tp):
                for s in _divisors_desc(sp):
                    for f in _divisors_desc(fsdp):
                        if fits(t, s, f, p, e):
                            return MeshAxes(
                                dp=n_devices // (t * s * f * p * e),
                                fsdp=f, pp=p, ep=e, tp=t, sp=s,
                            )
    raise ValueError(
        f"no valid mesh for {n_devices} offered device(s) within the "
        f"requested degrees tp={tp} sp={sp} fsdp={fsdp} pp={pp} ep={ep} "
        f"(n_heads={n_heads}, global_batch={global_batch}, seq_len={seq_len})"
    )
