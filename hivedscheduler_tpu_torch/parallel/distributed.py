"""Process-group initialization for gangs scheduled by tpu-hive.

Counterpart of ``hivedscheduler_tpu/parallel/distributed.py``. Each pod of
a gang holds some GPUs of one node; the port runs one process per GPU, so
a gang of P pods of G GPUs is a process group of P x G ranks. The process
topology comes from the scheduler's bind-info annotation, which carries
every member's node and GPU indices, so every rank derives the same
coordinator, world size and a distinct rank with no outside coordination:

- :func:`gang_process_info` is the JAX package's, unchanged: (coordinator
  node, pod index, pod count), one index per pod in the sorted member
  order;
- :func:`gang_rank` expands it to one rank per GPU: the GPUs of the
  members before this pod in that order, plus ``LOCAL_RANK``, the GPU's
  index within the pod (set by every per-GPU launcher; 0 by default);
- :func:`initialize_from_gang` opens the process group over an explicit
  ``tcp://`` address: NCCL on ``cuda``, gloo on ``cpu``. A run with no
  gang, or a gang of one GPU, gets a one-rank group on a local address,
  so the single-GPU path is the same code as the N-GPU one.
"""

from __future__ import annotations

import logging
import os
import socket
from typing import List, Optional, Tuple

from hivedscheduler_tpu_torch.api import types as api

log = logging.getLogger(__name__)

DEFAULT_COORDINATOR_PORT = 8476
# the per-GPU launcher's index of this process within its pod
ENV_LOCAL_RANK = "LOCAL_RANK"


def _members(bind_info: api.PodBindInfo) -> List[Tuple[str, tuple]]:
    """The gang's pods as sorted, distinct (node, sorted chip indices)."""
    return sorted({
        (p.physical_node, tuple(sorted(p.physical_leaf_cell_indices)))
        for m in bind_info.affinity_group_bind_info for p in m.pod_placements
    })


def gang_process_info(
    bind_info: api.PodBindInfo,
    my_node: str,
    my_chip_indices: Optional[List[int]] = None,
) -> Tuple[str, int, int]:
    """(coordinator_node, pod_index, pod_count) for this pod's gang.

    Member identity is (node, sorted chip indices), so several pods on one
    node get distinct indices; indices follow the sorted member order and
    the coordinator is index 0's node. ``my_chip_indices`` (from
    ``NVIDIA_VISIBLE_DEVICES``) is required when several gang pods run on
    ``my_node``."""
    members = _members(bind_info)
    if my_chip_indices is not None:
        key = (my_node, tuple(sorted(my_chip_indices)))
        if key not in members:
            raise ValueError(f"pod {key} not part of the gang placement {members}")
        process_id = members.index(key)
    else:
        candidates = [i for i, (n, _) in enumerate(members) if n == my_node]
        if not candidates:
            raise ValueError(f"node {my_node} not part of the gang placement {members}")
        if len(candidates) > 1:
            raise ValueError(
                f"multiple gang pods on node {my_node}; pass my_chip_indices "
                f"(NVIDIA_VISIBLE_DEVICES) to disambiguate"
            )
        process_id = candidates[0]
    return members[0][0], process_id, len(members)


def gang_rank(
    bind_info: api.PodBindInfo,
    my_node: str,
    my_chip_indices: Optional[List[int]] = None,
    local_rank: int = 0,
) -> Tuple[str, int, int]:
    """(coordinator_node, rank, world) of this process, one rank per GPU:
    rank = the GPUs of the members before this pod + ``local_rank``,
    world = the GPUs of the whole gang."""
    coordinator, pod, _ = gang_process_info(bind_info, my_node, my_chip_indices)
    # a member granted no leaf cell runs one process
    gpus = [max(1, len(chips)) for _, chips in _members(bind_info)]
    if not 0 <= local_rank < gpus[pod]:
        raise ValueError(
            f"{ENV_LOCAL_RANK}={local_rank} but this pod holds {gpus[pod]} GPU(s)"
        )
    return coordinator, sum(gpus[:pod]) + local_rank, sum(gpus)


def local_rank() -> int:
    """``LOCAL_RANK`` (0 when unset): which of the pod's GPUs this process
    drives, as ``cuda:{LOCAL_RANK}`` within what the container sees."""
    raw = os.environ.get(ENV_LOCAL_RANK, "").strip()
    return int(raw) if raw else 0


def gang_from_env(bind_info_json: Optional[str] = None,
                  my_node: Optional[str] = None) -> Optional[Tuple[str, int, int]]:
    """(coordinator_node, rank, world) from the pod's bind-info annotation
    (``POD_BIND_INFO``), node name (``NODE_NAME``), ``NVIDIA_VISIBLE_DEVICES``
    and ``LOCAL_RANK``; None for a run the scheduler did not place. Pure:
    it opens no process group."""
    from hivedscheduler_tpu_torch.parallel.topology import visible_chip_indices

    bind_info_json = bind_info_json or os.environ.get("POD_BIND_INFO", "")
    my_node = my_node or os.environ.get("NODE_NAME", "")
    if not bind_info_json or not my_node:
        return None
    bind_info = api.parse_pod_bind_info(bind_info_json)
    return gang_rank(bind_info, my_node, my_chip_indices=visible_chip_indices(),
                     local_rank=local_rank())


def _free_local_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# tries of a one-rank group at ports it picks itself: between the probe that
# finds a port free and the store's bind, another socket can take it
_OWN_PORT_TRIES = 3


def initialize_from_gang(
    bind_info_json: Optional[str] = None,
    my_node: Optional[str] = None,
    coordinator_port: Optional[int] = None,
    node_to_address=None,
    device: str = "cuda",
) -> Tuple[int, int]:
    """Open the default process group from the pod's bind-info annotation
    and return (rank, world).

    The address is ``tcp://{node_to_address(coordinator)}:{coordinator_port}``
    (port 8476 by default; ``node_to_address`` defaults to the last path
    element of the node name, as the JAX package's does). A run with no
    bind info or a gang of one GPU opens a one-rank group on
    ``tcp://127.0.0.1`` (a free port unless ``coordinator_port`` is given;
    if another socket takes that port before the group binds it, another
    free port). The backend follows ``device``: NCCL for ``cuda``, after selecting
    ``cuda:{LOCAL_RANK}``, and gloo for ``cpu``; it never changes because
    a card is missing."""
    import torch
    import torch.distributed as dist

    from hivedscheduler_tpu_torch import resolve_device

    dev = resolve_device(device)
    if dist.is_initialized():
        raise RuntimeError("a process group is already open; close it with "
                           "shutdown() first")
    gang = gang_from_env(bind_info_json, my_node)
    own_port = False
    if gang is None or gang[2] == 1:
        rank, world = 0, 1
        address = "127.0.0.1"
        own_port = not coordinator_port
        port = coordinator_port or _free_local_port()
    else:
        coordinator, rank, world = gang
        address = (node_to_address or (lambda n: n.split("/")[-1]))(coordinator)
        port = coordinator_port or DEFAULT_COORDINATOR_PORT
    device_id = None
    if dev.type == "cuda":
        device_id = torch.device("cuda", local_rank())
        torch.cuda.set_device(device_id)
    tries = _OWN_PORT_TRIES if own_port else 1
    for attempt in range(tries):
        try:
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo",
                init_method=f"tcp://{address}:{port}", world_size=world, rank=rank,
                device_id=device_id)
            break
        except dist.DistNetworkError as err:
            if attempt == tries - 1 or "EADDRINUSE" not in str(err):
                raise
            log.warning("port %s was taken before the process group bound it; "
                        "trying another", port)
            port = _free_local_port()
    log.info("process group initialized: rank %s/%s, coordinator %s:%s, %s",
             rank, world, address, port, dist.get_backend())
    return rank, world


def any_rank(flag: bool, device) -> bool:
    """True on every rank when ``flag`` is true on any rank, so that a
    decision one rank takes alone (a preemption signal) is taken by all at
    the same step. Without a gang it is ``flag``."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return flag
    t = torch.tensor([int(flag)], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def shutdown() -> None:
    """Close the default process group, if one is open."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
