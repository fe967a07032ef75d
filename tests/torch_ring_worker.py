"""One rank of a gloo process group for the port's sequence-parallel
attention tests.

    python tests/torch_ring_worker.py JOB.json RANK

``JOB.json`` names the world size (all of it the ``sp`` axis), the
coordinator port, an ``.npz`` of the whole q, k, v and a cotangent w
(``[B, T, H(_kv), D]``), and the attentions to run. Each rank joins the
gang through ``initialize_from_gang`` (``torch_mesh_worker.gang_env``),
runs every attention on its contiguous slice of the sequence with the
gradient of ``sum(out * w)``, and rank 0 writes the gathered outputs,
gradients and route counts to the job's ``out`` file. This file imports no
JAX.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from torch_mesh_worker import gang_env  # noqa: E402

torch.set_num_threads(1)


def attention_fns(ra, mesh, block: int):
    """name -> fn(q, k, v) of one rank's local tensors. The ``*_kernels``
    entries force the flash schedule (no mesh context: ``mesh_axes=()``),
    as the JAX tests run the interpret-mode kernels; the public flash
    entries run inside the mesh context and take JAX's einsum route."""
    axis = ra.SeqAxis.from_mesh(mesh)
    kw = dict(block_q=block, block_k=block)
    return {
        "ring": lambda q, k, v: ra.ring_attention(q, k, v, mesh),
        "ring_noncausal": lambda q, k, v: ra.ring_attention(q, k, v, mesh, causal=False),
        "ring_flash": lambda q, k, v: ra.ring_flash_attention(q, k, v, mesh, **kw),
        "ring_flash_kernels": lambda q, k, v: ra._ring_flash_attention_local(
            q, k, v, axis, True, (), block, block),
        "ring_flash_kernels_noncausal": lambda q, k, v: ra._ring_flash_attention_local(
            q, k, v, axis, False, (), block, block),
        "zigzag": lambda q, k, v: ra.zigzag_ring_attention(q, k, v, mesh),
        "zigzag_flash": lambda q, k, v: ra.zigzag_ring_flash_attention(q, k, v, mesh, **kw),
        "zigzag_flash_kernels": lambda q, k, v: ra._zigzag_flash_attention_local(
            q, k, v, axis, (), block // 2, block // 2),
        "ulysses": lambda q, k, v: ra.ulysses_attention(q, k, v, mesh),
    }


def main(job_path: str, rank: int) -> None:
    with open(job_path) as f:
        job = json.load(f)
    os.environ.update(gang_env(job["world"], rank))

    from hivedscheduler_tpu_torch.parallel import distributed, topology
    from hivedscheduler_tpu_torch.parallel import ring_attention as ra
    from hivedscheduler_tpu_torch.parallel.sharding import _all_gather

    got_rank, world = distributed.initialize_from_gang(
        coordinator_port=job["port"], device="cpu")
    assert (got_rank, world) == (rank, job["world"]), (got_rank, world)
    try:
        mesh = topology.make_mesh(topology.MeshAxes(sp=world), "cpu")
        group = mesh.get_group("sp")
        with np.load(job["qkv"]) as f:
            q, k, v, w = (torch.from_numpy(f[n]) for n in ("q", "k", "v", "w"))
        t = q.shape[1] // world
        rows = slice(rank * t, (rank + 1) * t)
        fns = attention_fns(ra, mesh, job["block"])
        out = {}
        for name in job["impls"]:
            routes = ra.RING_REFERENCE_ROUTES
            ql, kl, vl = (x[:, rows].clone().requires_grad_(True) for x in (q, k, v))
            o = fns[name](ql, kl, vl)
            torch.sum(o * w[:, rows]).backward()
            for key, x in (("out", o), ("dq", ql.grad), ("dk", kl.grad), ("dv", vl.grad)):
                out[f"{name}/{key}"] = _all_gather(x.detach(), 1, group).numpy()
            out[f"{name}/reference_routes"] = np.array(ra.RING_REFERENCE_ROUTES - routes)
        if rank == 0:
            np.savez(job["out"], **out)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
