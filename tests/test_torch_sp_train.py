"""The port's sequence-parallel training and eval (``--sp``) on the CPU, in
gloo process groups, against the JAX package.

Each port run is a gang of processes (``tests/torch_mesh_worker.py``, or
the ``train`` CLI itself) that join through ``initialize_from_gang``, each
rank holding a contiguous slice of every sequence. The JAX reference is
``make_sharded_train_step`` on the matching mesh of the CPU devices that
``tests/conftest.py`` forces, from the same numpy weights, with the same
``attn_impl``, gradient accumulation and chunked cross-entropy. The port's
runs start first and the JAX references are built while they run.

Tolerances (f32, the tiny config of ``test_torch_sharded_train.py``):
losses atol 1e-5 and parameters after three AdamW steps atol 3e-5, as for
dp, fsdp and tp: sp adds only summation order (the ring's merges, the
loss and gradient sums over sp). The eval loss at sp=2 against one device:
atol 1e-6. A checkpoint saved at sp=2 restores on one device bit for bit.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu.parallel import checkpoint as jckpt
from hivedscheduler_tpu.parallel import ring_attention as jra
from hivedscheduler_tpu.parallel import topology as jtopo
from hivedscheduler_tpu.parallel import train as jtrain
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.parallel import checkpoint as tckpt
from hivedscheduler_tpu_torch.parallel import train as ttrain

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from test_torch_sharded_train import (  # noqa: E402
    BATCH, CFG, EVAL_ATOL, LOSS_ATOL, PARAM_ATOL, SEQ, STEPS, Gang, _assert_params_close,
    _free_port, _named, _result, _worker_gang)
from torch_mesh_worker import gang_env  # noqa: E402

# each run: attn_impl, mesh degrees, worker options; every one at sp=2 over
# a gang of 2 (tier-1), the slow ones at world 4
SP2_RUNS = {
    "ring": dict(attn="ring", tasks=["eval", "train", "save"]),
    "ring_flash": dict(attn="ring_flash", tasks=["train"]),
    # two grad-accumulation slices, each rank's 2 rows of its slice, under
    # the "dots" remat: the ring's transfers run again in the recompute
    "ring_zigzag": dict(attn="ring_zigzag", tasks=["train"], grad_accum=2,
                        remat="dots"),
    "ulysses": dict(attn="ulysses", tasks=["train"], ce_chunk=16),
}
WORLD4_RUNS = {
    "sp4-ring_zigzag": dict(attn="ring_zigzag", sp=4),
    "sp2-tp2-ring_flash": dict(attn="ring_flash", sp=2, tp=2),
}
# the train CLI's own flags at sp=2: --attn defaults to ring
CLI_ARGS = ["--vocab-size", "256", "--d-model", "64", "--n-layers", "2",
            "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "128", "--seq-len", "64",
            "--batch", "4", "--device", "cpu", "--steps", "2", "--log-every", "1",
            "--sp", "2", "--ce-chunk", "16"]


def _start(tmp, name, world, run, common, **extra):
    cfg = dict(CFG, attn_impl=run["attn"], remat=run.get("remat", "full"))
    return _worker_gang(tmp, name, world, sp=run.get("sp", 2), tp=run.get("tp", 1),
                        grad_accum=run.get("grad_accum", 1),
                        ce_chunk=run.get("ce_chunk", 0), cfg=cfg,
                        tasks=run.get("tasks", ["train"]), **common, **extra)


def _jax_run(run, init, batches):
    """JAX's sharded step of ``run`` from ``init`` -> (losses, final named
    params)."""
    axes = jtopo.MeshAxes(sp=run.get("sp", 2), tp=run.get("tp", 1))
    mesh = jtopo.make_mesh(axes, jax.devices("cpu")[:axes.size])
    cfg = jtm.TransformerConfig(dtype=jnp.float32, attn_impl=run["attn"], **CFG)
    step, init_fn, tok_sh = jtrain.make_sharded_train_step(
        cfg, mesh, grad_accum=run.get("grad_accum", 1), ce_chunk=run.get("ce_chunk", 0))
    params, opt = init_fn(jax.random.PRNGKey(0))
    params = jax.device_put(init, jax.tree.map(lambda a: a.sharding, params))
    losses = []
    for tokens in batches:
        params, opt, loss = step(params, opt, jax.device_put(tokens, tok_sh))
        losses.append(float(loss))
    return losses, _named(jax.device_get(params))


def _count_einsum_routes(monkeypatch, routes):
    real = jra._ring_attention_local

    def counting(*a, **kw):
        routes["einsum"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(jra, "_ring_attention_local", counting)


def _inputs(tmp):
    init = jax.device_get(jtm.init_params(
        jtm.TransformerConfig(dtype=jnp.float32, **CFG), jax.random.PRNGKey(0)))
    np.savez(os.path.join(tmp, "init.npz"), **_named(init))
    batches = np.random.default_rng(7).integers(
        0, CFG["vocab_size"], (STEPS, BATCH, SEQ)).astype(np.int32)
    np.savez(os.path.join(tmp, "batches.npz"), tokens=batches)
    return init, batches, dict(init=os.path.join(tmp, "init.npz"),
                               batches=os.path.join(tmp, "batches.npz"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every sp=2 port run, the train CLI's gang, and the JAX references."""
    tmp = str(tmp_path_factory.mktemp("sp"))
    init, batches, common = _inputs(tmp)
    ckpt_dir = os.path.join(tmp, "ckpt-sp2")
    port = {name: _start(tmp, name, 2, run, common, ckpt_dir=ckpt_dir)
            for name, run in SP2_RUNS.items()}
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "from hivedscheduler_tpu_torch.parallel import distributed; "
            f"distributed.DEFAULT_COORDINATOR_PORT = {_free_port()}; "
            "from hivedscheduler_tpu_torch import train; "
            f"sys.exit(train.main({CLI_ARGS!r}))")
    cli = Gang(tmp, "cli-sp2", 2, lambda rank: [sys.executable, "-c", code],
               lambda rank: gang_env(2, rank))
    ref, routes = {}, {}
    with pytest.MonkeyPatch.context() as mp:
        for name, run in SP2_RUNS.items():
            routes[name] = {"einsum": 0}
            _count_einsum_routes(mp, routes[name])
            ref[name] = _jax_run(run, init, batches)
            mp.undo()
    out = {name: _result(job) for name, job in port.items()}
    return dict(init=init, batches=batches, ref=ref, routes=routes, out=out,
                ckpt_dir=ckpt_dir, cli=cli.wait())


@pytest.mark.parametrize("name", sorted(SP2_RUNS))
def test_three_steps_at_sp2_match_jax(runs, name):
    j_losses, j_params = runs["ref"][name]
    out = runs["out"][name]
    assert list(out["data_part"]) == [0, 1]  # sp ranks read the same rows
    np.testing.assert_allclose(out["losses"], j_losses, atol=LOSS_ATOL, rtol=0)
    _assert_params_close(out, j_params, PARAM_ATOL)
    init = _named(runs["init"])
    assert np.abs(j_params["layers.wq"] - init["layers.wq"]).max() > 20 * PARAM_ATOL


def test_ring_flash_at_sp2_takes_jax_route(runs):
    # inside the model's mesh context JAX's interpret-mode kernels cannot
    # run under the vma checker: its ring_flash takes the einsum ring, and
    # so does the port's on CPU tensors (counted); no flash reference route
    assert runs["routes"]["ring_flash"]["einsum"] >= 1
    out = runs["out"]["ring_flash"]
    assert int(out["ring_reference_routes"]) > 0
    assert int(out["reference_routes"]) == 0
    # the einsum impls never count a route
    assert int(runs["out"]["ring"]["ring_reference_routes"]) == 0


def test_eval_at_sp2_equals_one_device(runs):
    cfg = ttm.TransformerConfig(dtype=torch.float32, attn_impl="xla", **CFG)
    eval_step, _ = ttrain.make_eval_step(cfg, "cpu")
    want = float(eval_step(bridge.from_numpy_tree(runs["init"]),
                           torch.from_numpy(runs["batches"][0])))
    got = float(runs["out"]["ring"]["eval_loss"])
    assert abs(got - want) <= EVAL_ATOL, (got, want)


def test_checkpoint_saved_at_sp2_restores_at_sp1(runs):
    saved = runs["out"]["ring"]
    cfg = ttm.TransformerConfig(dtype=torch.float32, attn_impl="xla", **CFG)
    _, init_fn = ttrain.make_train_step(cfg, "cpu")
    params, opt = init_fn(torch.Generator().manual_seed(1))
    step, _, _ = tckpt.restore(runs["ckpt_dir"], params, opt)
    assert step == STEPS
    for name, t in tckpt.named_leaves(params).items():
        np.testing.assert_array_equal(t.detach().numpy(), saved[f"params/{name}"])
        for key, m in opt.state[t].items():
            np.testing.assert_array_equal(m.numpy(), saved[f"opt/{name}.{key}"])
    meta = jckpt.read_metadata(runs["ckpt_dir"])
    assert meta == tckpt.read_metadata(runs["ckpt_dir"])
    assert meta["mesh"] == {"dp": 1, "fsdp": 1, "pp": 1, "ep": 1, "tp": 1, "sp": 2}


def test_train_cli_runs_at_sp2(runs):
    rcs, outs = runs["cli"]
    assert rcs == [0, 0], "\n".join(outs)
    assert "step 1 loss" in outs[0] and "step 2 loss" in outs[0]
    assert "step 1 loss" not in outs[1]  # rank 0 alone logs
    assert "sp=2" in outs[0] and "attn_impl='ring'" in outs[0]


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(WORLD4_RUNS))
def test_world_4_matches_jax(name, tmp_path):
    run = WORLD4_RUNS[name]
    init, batches, common = _inputs(str(tmp_path))
    job = _start(str(tmp_path), name, 4, run, common)
    j_losses, j_params = _jax_run(run, init, batches)
    out = _result(job)
    np.testing.assert_allclose(out["losses"], j_losses, atol=LOSS_ATOL, rtol=0)
    _assert_params_close(out, j_params, PARAM_ATOL)
