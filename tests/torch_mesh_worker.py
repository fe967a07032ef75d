"""One rank of a gloo process group for the port's multi-rank CPU tests.

    python tests/torch_mesh_worker.py JOB.json RANK

``JOB.json`` names the world size, the coordinator port, the mesh degrees
(``tp``, ``sp``, ``fsdp``, ``ep``; dp takes the rest), the model config and a list of
tasks run in order on one process group. The rank joins the gang as a
scheduled pod would: a bind info of one pod holding ``world`` GPUs on the
node ``test/127.0.0.1``, ``NVIDIA_VISIBLE_DEVICES`` and ``LOCAL_RANK``, read
by ``initialize_from_gang``. Rank 0 writes what the tasks return to the
job's ``out`` file (an ``.npz``). Inputs come as ``.npz`` files of named
leaves (``layers.wq``) and token batches. This file imports no JAX.
"""

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)


def gang_env(world: int, rank: int) -> dict:
    """The environment of gang member ``rank`` of a one-pod gang."""
    bind_info = {
        "node": "test/127.0.0.1",
        "leafCellIsolation": list(range(world)),
        "cellChain": "h100-rack",
        "affinityGroupBindInfo": [{"podPlacements": [{
            "physicalNode": "test/127.0.0.1",
            "physicalLeafCellIndices": list(range(world)),
        }]}],
    }
    return {"POD_BIND_INFO": json.dumps(bind_info), "NODE_NAME": "test/127.0.0.1",
            "NVIDIA_VISIBLE_DEVICES": ",".join(map(str, range(world))),
            "LOCAL_RANK": str(rank)}


def unflatten(named: dict) -> dict:
    """{"layers.wq": a} -> {"layers": {"wq": a}}."""
    tree: dict = {}
    for name, value in named.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def main(job_path: str, rank: int) -> None:
    with open(job_path) as f:
        job = json.load(f)
    os.environ.update(gang_env(job["world"], rank))

    from hivedscheduler_tpu_torch import bridge
    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.ops import attention
    from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt
    from hivedscheduler_tpu_torch.parallel import data as data_lib
    from hivedscheduler_tpu_torch.parallel import distributed, topology
    from hivedscheduler_tpu_torch.parallel import ring_attention as ring
    from hivedscheduler_tpu_torch.parallel import train as ptrain

    got_rank, world = distributed.initialize_from_gang(
        coordinator_port=job["port"], device="cpu")
    assert (got_rank, world) == (rank, job["world"]), (got_rank, world)
    try:
        axes = topology.infer_axes(world, tp=job.get("tp", 1), sp=job.get("sp", 1),
                                   fsdp=job.get("fsdp", 1), ep=job.get("ep", 1))
        mesh = topology.make_mesh(axes, "cpu")
        cfg = tm.TransformerConfig(dtype=torch.float32, **job["cfg"])
        step, init_fn, token_sharding = ptrain.make_sharded_train_step(
            cfg, mesh, grad_accum=job.get("grad_accum", 1),
            ce_chunk=job.get("ce_chunk", 0))
        eval_step, _, _ = ptrain.make_sharded_eval_step(
            cfg, mesh, ce_chunk=job.get("ce_chunk", 0))
        part, n_parts = data_lib.data_split(mesh)
        batches = np.load(job["batches"])["tokens"]  # [steps, batch, seq]
        rows = batches.shape[1] // n_parts

        def tokens(i):
            return data_lib.device_put_global(
                batches[i, part * rows:(part + 1) * rows], token_sharding,
                batches.shape[1])

        with np.load(job["init"]) as f:
            init = unflatten(dict(f))
        params = bridge.distribute_tree(init, mesh, tm.sharding_specs(cfg))
        for leaf in ptrain._leaves(params):
            leaf.requires_grad_(True)
        opt = ptrain.make_optimizer()(ptrain._leaves(params))
        out = {"data_part": np.array([part, n_parts])}

        def state_out(prefix, params, opt):
            for name, t in ckpt.named_leaves(params).items():
                out[f"{prefix}params/{name}"] = _full(t.detach()).numpy()
                for key, m in opt.state.get(t, {}).items():
                    out[f"{prefix}opt/{name}.{key}"] = _full(m).numpy()

        for task in job["tasks"]:
            if task == "eval":
                out["eval_loss"] = np.array(float(eval_step(params, tokens(0))))
                with torch.no_grad():
                    for aux in (True, False):
                        out[f"loss_aux_{aux}"] = np.array(float(ptrain.loss_fn(
                            params, tokens(0), cfg, mesh, ce_chunk=job.get("ce_chunk", 0),
                            include_aux=aux)))
            elif task == "train":
                routes = attention.FLASH_REFERENCE_ROUTES
                ring_routes = ring.RING_REFERENCE_ROUTES
                losses = []
                for i in range(batches.shape[0]):
                    params, opt, loss = step(params, opt, tokens(i))
                    losses.append(float(loss))
                out["losses"] = np.array(losses)
                out["reference_routes"] = np.array(
                    attention.FLASH_REFERENCE_ROUTES - routes)
                out["ring_reference_routes"] = np.array(
                    ring.RING_REFERENCE_ROUTES - ring_routes)
                state_out("", params, opt)
            elif task == "save":
                meta = ckpt.train_metadata(axes, cfg,
                                           global_batch=batches.shape[1],
                                           seq_len=batches.shape[2])
                ckpt.save(job["ckpt_dir"], batches.shape[0], params, opt,
                          extra=meta)
            elif task == "restore":
                params_r, opt_r = init_fn(torch.Generator().manual_seed(1))
                restored, _, _ = ckpt.restore(job["ckpt_dir"], params_r, opt_r)
                out["restored_step"] = np.array(restored)
                state_out("restored/", params_r, opt_r)
            else:
                raise ValueError(f"unknown task {task!r}")
        if rank == 0:
            np.savez(job["out"], **out)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
