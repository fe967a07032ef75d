"""The scheduler's bind-info record, as the workload reads it.

A copy of ``PodPlacementInfo``, ``AffinityGroupMemberBindInfo`` and
``PodBindInfo.from_dict`` from ``hivedscheduler_tpu/api/types.py``, with
only the fields a gang member needs to find its rank: each member's node
and physical leaf-cell (GPU) indices. The annotation is machine-written
JSON (``hivedscheduler_tpu/runtime/utils.py`` ``_encode_bind_info``), so
:func:`parse_pod_bind_info` reads it with ``json``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List

# the pod annotation the bind info is read from (downward API: the
# POD_BIND_INFO environment variable)
ANNOTATION_POD_BIND_INFO = "hivedscheduler.microsoft.com/pod-bind-info"


@dataclass
class PodPlacementInfo:
    """One gang pod's node and its physical leaf-cell indices."""

    physical_node: str
    physical_leaf_cell_indices: List[int] = field(default_factory=list)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "PodPlacementInfo":
        return PodPlacementInfo(
            physical_node=d.get("physicalNode", ""),
            physical_leaf_cell_indices=[
                int(i) for i in d.get("physicalLeafCellIndices", [])],
        )


@dataclass
class AffinityGroupMemberBindInfo:
    pod_placements: List[PodPlacementInfo] = field(default_factory=list)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "AffinityGroupMemberBindInfo":
        return AffinityGroupMemberBindInfo(pod_placements=[
            PodPlacementInfo.from_dict(p) for p in d.get("podPlacements", [])])


@dataclass
class PodBindInfo:
    """This pod's node and isolation, and every gang member's placement."""

    node: str
    leaf_cell_isolation: List[int] = field(default_factory=list)
    affinity_group_bind_info: List[AffinityGroupMemberBindInfo] = field(
        default_factory=list)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "PodBindInfo":
        return PodBindInfo(
            node=d.get("node", ""),
            leaf_cell_isolation=[int(i) for i in d.get("leafCellIsolation", [])],
            affinity_group_bind_info=[
                AffinityGroupMemberBindInfo.from_dict(m)
                for m in d.get("affinityGroupBindInfo", [])
            ],
        )


def parse_pod_bind_info(text: str) -> PodBindInfo:
    """The bind-info annotation's JSON -> :class:`PodBindInfo`; anything
    that is not a JSON object raises ``ValueError`` naming the
    annotation."""
    try:
        d = json.loads(text)
    except ValueError as err:
        raise ValueError(
            f"the {ANNOTATION_POD_BIND_INFO} annotation is not JSON ({err}); "
            f"the scheduler writes it as JSON"
        ) from None
    if not isinstance(d, dict):
        raise ValueError(
            f"the {ANNOTATION_POD_BIND_INFO} annotation is a JSON "
            f"{type(d).__name__}, not an object"
        )
    return PodBindInfo.from_dict(d)
