"""Time AdamW's first steps over DTensors by the rank of their mesh.

    python tests/torch_mesh_probe.py --dims 2 6 [--device cpu]

The reason the port keeps its parameters on the ``("fsdp", "ep", "tp")``
submesh (``("fsdp", "pp", "ep", "tp")`` when pipelined) and not on the
six-axis mesh (``parallel/sharding.py``): in torch 2.13 DTensor's sharding
propagation enumerates strategies over every mesh dim at once, so the
first step over a new set of shapes costs time exponential in the mesh's
rank (torch 2.11 does not). ``--dims 3 4 --device cpu`` read 0.400 s and
2.260 s for the first step. For each rank
asked for, the probe lays a few small leaves (every other one sharded
over its last dim, as ``wq`` is over tp) on a mesh of that many size-1
dims in a one-rank process group, and prints the seconds of the first
AdamW step and of the next one. It runs on the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = ((2, 64, 4, 16), (2, 64, 2, 16), (2, 4, 16, 64), (2, 64), (256, 64))


def probe(ndim: int, device: str) -> tuple:
    """(first step s, second step s) of AdamW over DTensors on a mesh of
    ``ndim`` size-1 dims."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = init_device_mesh(device, (1,) * ndim,
                            mesh_dim_names=tuple(f"d{i}" for i in range(ndim)))
    params = []
    for i, shape in enumerate(SHAPES):
        placements = [Replicate()] * ndim
        if i % 2 == 0:
            placements[-1] = Shard(len(shape) - 1)
        t = torch.randn(shape, device=device)
        params.append(distribute_tensor(t, mesh, placements,
                                        src_data_rank=None).requires_grad_(True))
    opt = torch.optim.AdamW(params, lr=1e-3)
    seconds = []
    for _ in range(2):
        for p in params:
            p.grad = p.detach() * 0.1
        t0 = time.perf_counter()
        opt.step()
        if device == "cuda":
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return tuple(seconds)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="mesh-probe")
    parser.add_argument("--dims", type=int, nargs="+", default=[2, 6])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    import torch

    from hivedscheduler_tpu_torch import resolve_device
    from hivedscheduler_tpu_torch.parallel import distributed

    device = resolve_device(args.device).type
    torch.set_num_threads(1)
    distributed.initialize_from_gang(device=device)
    try:
        for ndim in args.dims:
            first, second = probe(ndim, device)
            print(f"mesh of {ndim} dims ({device}): first AdamW step "
                  f"{first:.3f} s, second {second:.4f} s", flush=True)
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
