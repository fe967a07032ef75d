"""Logical parallelism axes of the port's workloads.

A copy of ``MeshAxes`` from ``hivedscheduler_tpu/parallel/topology.py``
only: checkpoint metadata records the source mesh in it. The port trains
on one device, so every axis is 1; building a device mesh is not yet
ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


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
