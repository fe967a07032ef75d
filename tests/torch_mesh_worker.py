"""One rank of a gloo process group for the port's multi-rank CPU tests.

    python tests/torch_mesh_worker.py JOB.json RANK

``JOB.json`` names the world size, the coordinator port, the mesh degrees
(``tp``, ``sp``, ``fsdp``, ``ep``, ``pp``; dp takes the rest), the model config and a list of
tasks run in order on one process group. Besides training, eval and
checkpoints (``restore`` reads ``ckpt_dir``, ``save`` writes ``save_dir``
or else ``ckpt_dir``), ``forward`` records the whole batch's logits and
the aux (every rank's part, replicas checked equal) and ``grads`` one
step's loss and whole gradients, before the optimizer. The rank joins the gang as a
scheduled pod would: a bind info of one pod holding ``world`` GPUs on the
node ``test/127.0.0.1``, ``NVIDIA_VISIBLE_DEVICES`` and ``LOCAL_RANK``, read
by ``initialize_from_gang``. A config with ``lora_rank`` trains through
``make_sharded_lora_train_step``: the adapters alone, the base frozen. Rank 0 writes what the tasks return to the
job's ``out`` file (an ``.npz``). Inputs come as ``.npz`` files of named
leaves (``layers.wq``) and token batches. This file imports no JAX.

A job with ``serve`` runs decode and serving cases instead, on a ``("dp",
"tp")`` serving mesh (``dp``, ``tp``): ``make_sharded_generate``,
``make_sharded_speculative`` and ``ServingEngine(mesh=)`` (plain or
speculative, with an optional injected clock skewed per rank), each rank
writing its results as JSON to ``{out}.{rank}.json``.
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


class TickClock:
    """An injected engine clock that advances ``tick`` seconds a read,
    offset by ``skew`` (a rank's skewed clock)."""

    def __init__(self, tick: float, skew: float = 0.0):
        self.t, self.tick, self.skew = 0.0, tick, skew

    def __call__(self) -> float:
        self.t += self.tick
        return self.t + self.skew


def drive_engine(eng, requests):
    """Serve ``requests`` ([prompt, budget, submit_at_step]) with
    ``eng.step()`` until every request is done ->
    [[tokens, finish_reason]] in submit order."""
    pending = sorted(requests, key=lambda r: r[2])
    reqs, step = [], 0
    while pending or any(not r.done for r in reqs):
        while pending and pending[0][2] <= step:
            prompt, budget, _ = pending.pop(0)
            reqs.append(eng.submit(list(prompt), budget))
        eng.step()
        step += 1
    return [[r.tokens_out, r.finish_reason] for r in reqs]


def _load_params(path: str, dtype):
    from hivedscheduler_tpu_torch import bridge
    from hivedscheduler_tpu_torch.models import transformer as tm

    with np.load(path) as f:
        tree = unflatten(dict(f))
    return tm.cast_params(bridge.from_numpy_tree(tree), dtype)


def serve_case(case: dict, mesh, rank: int):
    """One decode or serving case on the serving mesh; what it returns is
    JSON (token lists, finish reasons, an error's text)."""
    from hivedscheduler_tpu_torch.models import decode, quant, serving, speculative
    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.parallel import sharding

    cfg = tm.TransformerConfig(dtype=torch.float32, **case["cfg"])
    params = _load_params(case["params"], cfg.dtype) if "params" in case else None
    if case.get("lora"):
        lcfg = tm.TransformerConfig(dtype=torch.float32, **dict(case["cfg"], **case["lora"]))
        params = tm.merge_lora(params, lcfg)
    if case.get("quantize"):
        params = quant.quantize_params(params, cfg)
    sampling = {k: case[k] for k in ("temperature", "top_k", "top_p") if k in case}
    gen = None
    if case.get("temperature", 0.0) > 0:
        gen = torch.Generator().manual_seed(case["seed"])
    kind = case["kind"]
    try:
        if kind == "generate":
            run, layout, rows = decode.make_sharded_generate(
                cfg, mesh, case["new"], quantized=bool(case.get("quantize")), **sampling)
            out = run(layout(params), rows(torch.tensor(case["prompt"])), gen)
            return out.tolist()
        if kind == "param-bytes":
            # each leaf: its bytes in the whole tree, the bytes of the
            # storage the engine keeps, whether the layout cuts it over tp,
            # and whether the engine's leaf still holds the whole storage
            layout = decode.serving_shardings(cfg, mesh)
            eng = serving.ServingEngine(params, cfg, mesh=mesh, **case["engine"])
            out = {}

            def walk(name, whole, local, spec):
                if isinstance(whole, dict):
                    for k in whole:
                        walk(f"{name}.{k}" if name else k, whole[k], local[k], spec[k])
                    return
                cut = any("tp" in sharding.spec_axes(e) for e in spec)
                out[name] = [whole.nbytes, local.untyped_storage().nbytes(), cut,
                             local.untyped_storage().data_ptr()
                             == whole.untyped_storage().data_ptr()]

            walk("", params, eng.params, layout.specs)
            return out
        if kind == "layout":
            # the error of laying the config over the mesh, or None
            decode.serving_shardings(cfg, mesh, quantized=bool(case.get("quantize")))
            return None
        dcfg = dparams = None
        if "draft_cfg" in case:
            dcfg = tm.TransformerConfig(dtype=torch.float32, **case["draft_cfg"])
            dparams = _load_params(case["draft_params"], dcfg.dtype)
        if kind == "speculative":
            run, tl, dl, rows = speculative.make_sharded_speculative(
                cfg, dcfg, mesh, case["new"], gamma=case["gamma"],
                quantized_target=bool(case.get("quantize")), **sampling)
            out, _ = run(tl(params), dl(dparams), rows(torch.tensor(case["prompt"])), gen)
            return out.tolist()
        if kind == "engine":
            kw = dict(case.get("engine", {}))
            if "clock" in case:
                c = case["clock"]
                kw["clock"] = TickClock(c["tick"] * c.get("rate", {}).get(str(rank), 1.0),
                                        c.get("skew", {}).get(str(rank), 0.0))
            if dcfg is not None:
                kw["spec_decode"] = speculative.SpecDecodeConfig(
                    draft_params=dparams, draft_cfg=dcfg, gamma=case["gamma"])
            eng = serving.ServingEngine(params, cfg, mesh=mesh, **kw)
            return drive_engine(eng, case["requests"])
        raise ValueError(f"unknown case kind {kind!r}")
    except ValueError as err:
        if not case.get("expect_error"):
            raise
        return {"error": str(err)}


def serve_main(job: dict, rank: int) -> None:
    """The serving job: every case on one ("dp", "tp") mesh; each rank
    writes what its cases returned to ``{out}.{rank}.json``."""
    from hivedscheduler_tpu_torch.parallel import distributed, topology

    got_rank, world = distributed.initialize_from_gang(
        coordinator_port=job["port"], device="cpu")
    assert (got_rank, world) == (rank, job["world"]), (got_rank, world)
    try:
        mesh = topology.serving_mesh(job["dp"], job["tp"], "cpu")
        out = {case["name"]: serve_case(case, mesh, rank) for case in job["cases"]}
        with open(f"{job['out']}.{rank}.json", "w") as f:
            json.dump(out, f)
    finally:
        distributed.shutdown()


def run_case(job: dict, rank: int, world: int) -> None:
    """One mesh, config and task list on the open process group; rank 0
    writes what the tasks return to the case's ``out``."""
    from hivedscheduler_tpu_torch import bridge
    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.ops import attention
    from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt
    from hivedscheduler_tpu_torch.parallel import data as data_lib
    from hivedscheduler_tpu_torch.parallel import topology
    from hivedscheduler_tpu_torch.parallel import ring_attention as ring
    from hivedscheduler_tpu_torch.parallel import train as ptrain

    axes = topology.infer_axes(world, tp=job.get("tp", 1), sp=job.get("sp", 1),
                               fsdp=job.get("fsdp", 1), ep=job.get("ep", 1),
                               pp=job.get("pp", 1))
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
    if cfg.lora_rank > 0:
        lora_step, _, _ = ptrain.make_sharded_lora_train_step(
            cfg, mesh, grad_accum=job.get("grad_accum", 1),
            ce_chunk=job.get("ce_chunk", 0))
        base, lora = tm.split_lora_params(params)
        trained = ptrain._leaves(lora)

        def step(params, opt, tokens):
            _, opt, loss = lora_step(base, lora, opt, tokens)
            return params, opt, loss
    else:
        trained = ptrain._leaves(params)
    for leaf in trained:
        leaf.requires_grad_(True)
    opt = ptrain.make_optimizer()(trained)
    out = {"data_part": np.array([part, n_parts])}

    def state_out(prefix, params, opt):
        for name, t in ckpt.named_leaves(params).items():
            out[f"{prefix}params/{name}"] = _full(t.detach()).numpy()
            for key, m in opt.state.get(t, {}).items():
                out[f"{prefix}opt/{name}.{key}"] = _full(m).numpy()

    for task in job["tasks"]:
        if task == "forward":
            with torch.no_grad():
                logits, aux = tm.forward_with_aux(params, tokens(0), cfg, mesh)
            seq = mesh.get_local_rank("sp") if axes.sp > 1 else 0
            parts = [None] * world
            torch.distributed.all_gather_object(parts, (part, seq, logits.numpy()))
            t = logits.shape[1]
            whole = np.full((batches.shape[1], batches.shape[2], logits.shape[2]),
                            np.nan, np.float32)
            spread = 0.0
            for p, q, x in parts:
                block = whole[p * rows:(p + 1) * rows, q * t:(q + 1) * t]
                if not np.isnan(block).any():
                    spread = max(spread, float(np.abs(block - x).max()))
                block[...] = x
            out["logits"], out["replica_spread"] = whole, np.array(spread)
            out["aux"] = np.array(float(aux))
        elif task == "grads":
            loss, grads = ptrain.value_and_grad(
                params, tokens(0), cfg, mesh, grad_accum=job.get("grad_accum", 1),
                ce_chunk=job.get("ce_chunk", 0), trainable=trained)
            out["grad_loss"] = np.array(float(loss))
            names = {id(t): n for n, t in ckpt.named_leaves(params).items()}
            for leaf, g in zip(trained, grads):
                out[f"grads/{names[id(leaf)]}"] = _full(g).numpy()
        elif task == "eval":
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
            ckpt.save(job.get("save_dir", job["ckpt_dir"]), batches.shape[0],
                      params, opt, extra=meta)
        elif task == "restore":
            params_r, opt_r = init_fn(torch.Generator().manual_seed(1))
            restored, _, _ = ckpt.restore(job["ckpt_dir"], params_r, opt_r)
            out["restored_step"] = np.array(restored)
            state_out("restored/", params_r, opt_r)
        else:
            raise ValueError(f"unknown task {task!r}")
    if rank == 0:
        np.savez(job["out"], **out)


def main(job_path: str, rank: int) -> None:
    with open(job_path) as f:
        job = json.load(f)
    os.environ.update(gang_env(job["world"], rank))
    if job.get("serve"):
        return serve_main(job, rank)

    from hivedscheduler_tpu_torch.parallel import distributed

    got_rank, world = distributed.initialize_from_gang(
        coordinator_port=job["port"], device="cpu")
    assert (got_rank, world) == (rank, job["world"]), (got_rank, world)
    try:
        # a job's ``cases`` run one after another on this process group,
        # each with its own mesh, config, tasks and output
        for case in job.get("cases", [{}]):
            run_case(dict(job, **case), rank, world)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
