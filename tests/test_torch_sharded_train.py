"""The port's dp, fsdp and tp training, eval and multi-rank checkpoints on
the CPU, in gloo process groups, against the JAX package.

Each port run is a gang of processes (``tests/torch_mesh_worker.py``,
or the ``train`` CLI itself) that join through ``initialize_from_gang``
from a bind info, as scheduled pods would. The JAX reference is
``make_sharded_train_step`` on the matching mesh of the CPU devices that
``tests/conftest.py`` forces, started from the same numpy weights. The
port's runs start first and the JAX references are built while they run.

Tolerances (f32, the tiny config below): losses atol 1e-5 and parameters
after three AdamW steps atol 3e-5, those of the one-device parity test
(``test_torch_train.py``): the mesh adds only summation order (the tp
all-reduce, the fsdp reduce-scatter, the data-parallel sum). The eval
loss at world 2 against one device: atol 1e-6, the same reordering of one
mean over 252 positions. A checkpoint restored onto another mesh is held
bit for bit.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu.ops import attention as jattn
from hivedscheduler_tpu.parallel import checkpoint as jckpt
from hivedscheduler_tpu.parallel import topology as jtopo
from hivedscheduler_tpu.parallel import train as jtrain
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.parallel import checkpoint as tckpt
from hivedscheduler_tpu_torch.parallel import topology as ttopo
from hivedscheduler_tpu_torch.parallel import train as ttrain

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")
sys.path.insert(0, os.path.join(ROOT, "tests"))

from torch_mesh_worker import gang_env  # noqa: E402

LOSS_ATOL = 1e-5
PARAM_ATOL = 3e-5
EVAL_ATOL = 1e-6
CFG = dict(vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=128, max_seq_len=64, attn_block_q=32, attn_block_k=32)
BATCH, SEQ, STEPS = 4, 64, 3
CLI_MODEL = ["--vocab-size", "256", "--d-model", "64", "--n-layers", "2",
             "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "128",
             "--seq-len", "64", "--batch", "4", "--attn", "xla",
             "--device", "cpu"]
# the eval CLI's windows: the synthetic corpus, bf16
EVAL_ARGS = [a for a in CLI_MODEL if a not in ("--attn", "xla")] + ["--max-steps", "2"]
# its loss at tp=2 against one device: bf16 activations round at other
# points once the heads are split, over 2 x 252 positions
EVAL_BF16_ATOL = 5e-3
JOB_TIMEOUT = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _named(tree) -> dict:
    return {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


class Gang:
    """The processes of one port run, started at once."""

    def __init__(self, tmp, name, world, argv_of_rank, env_of_rank=None):
        self.name, self.logs, self.procs = name, [], []
        for rank in range(world):
            log = open(os.path.join(tmp, f"{name}.{rank}.log"), "w+")
            env = dict(os.environ, **(env_of_rank(rank) if env_of_rank else {}))
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                argv_of_rank(rank), cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT))

    def wait(self):
        """The exit codes; each rank's output."""
        rcs = []
        for p in self.procs:
            try:
                rcs.append(p.wait(timeout=JOB_TIMEOUT))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append(p.wait())
        outs = []
        for log in self.logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
        return rcs, outs


def _worker_gang(tmp, name, world, **job):
    job = dict(world=world, port=_free_port(), out=os.path.join(tmp, f"{name}.npz"),
               **job)
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(job, f)
    return Gang(tmp, name, world,
                lambda rank: [sys.executable, WORKER, path, str(rank)]), job["out"]


def _result(gang_and_out):
    gang, out = gang_and_out
    rcs, outs = gang.wait()
    assert rcs == [0] * len(rcs), f"{gang.name} exited {rcs}:\n" + "\n".join(outs)
    with np.load(out) as f:
        return dict(f)


def _cli_gang(tmp, name, argv, module="train"):
    """``train.main`` (or ``eval.main``) in each of two processes of a
    gang. The CLI reaches its coordinator on the default port; each gang
    here patches that to a free one, so that gangs running at once do not
    meet."""
    if module == "train":
        argv = CLI_MODEL + ["--steps", "2", "--log-every", "1"] + argv
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "from hivedscheduler_tpu_torch.parallel import distributed; "
            f"distributed.DEFAULT_COORDINATOR_PORT = {_free_port()}; "
            f"from hivedscheduler_tpu_torch import {module}; "
            f"sys.exit({module}.main({argv!r}))")
    return Gang(tmp, name, 2, lambda rank: [sys.executable, "-c", code],
                lambda rank: gang_env(2, rank))


def _jax_cfg(attn):
    return jtm.TransformerConfig(dtype=jnp.float32, attn_impl=attn, **CFG)


def _jax_run(attn, axes, init, batches, monkeypatch, grad_accum=1):
    """JAX's sharded step from ``init`` on ``axes`` of the CPU devices ->
    (losses, final named params, routes its attention took)."""
    routes = {"reference": 0, "flash_backward": 0}
    real_xla, real_bwd = jattn.xla_attention, jattn._flash_backward

    def xla(*a, **kw):
        routes["reference"] += 1
        return real_xla(*a, **kw)

    def bwd(*a, **kw):
        routes["flash_backward"] += 1
        return real_bwd(*a, **kw)

    monkeypatch.setattr(jattn, "xla_attention", xla)
    monkeypatch.setattr(jattn, "_flash_backward", bwd)
    mesh = jtopo.make_mesh(axes, jax.devices("cpu")[:axes.size])
    step, init_fn, tok_sh = jtrain.make_sharded_train_step(
        _jax_cfg(attn), mesh, grad_accum=grad_accum)
    params, opt = init_fn(jax.random.PRNGKey(0))
    shardings = jax.tree.map(lambda a: a.sharding, params)
    params = jax.device_put(init, shardings)
    losses = []
    for tokens in batches:
        params, opt, loss = step(params, opt, jax.device_put(tokens, tok_sh))
        losses.append(float(loss))
    monkeypatch.undo()
    return losses, _named(jax.device_get(params)), routes


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world-2 port run and its JAX reference."""
    tmp = str(tmp_path_factory.mktemp("mesh"))
    init = jax.device_get(jtm.init_params(_jax_cfg("xla"), jax.random.PRNGKey(0)))
    np.savez(os.path.join(tmp, "init.npz"), **_named(init))
    rng = np.random.default_rng(7)
    batches = rng.integers(0, CFG["vocab_size"], (STEPS, BATCH, SEQ)).astype(np.int32)
    np.savez(os.path.join(tmp, "batches.npz"), tokens=batches)
    common = dict(init=os.path.join(tmp, "init.npz"),
                  batches=os.path.join(tmp, "batches.npz"))
    ckpt_dir = os.path.join(tmp, "ckpt-fsdp2")
    port = {
        "tp2": _worker_gang(tmp, "tp2", 2, tp=2, cfg=dict(CFG, attn_impl="xla"),
                            tasks=["eval", "train"], **common),
        # each fsdp rank on its own 2 rows
        "fsdp2": _worker_gang(tmp, "fsdp2", 2, fsdp=2, cfg=dict(CFG, attn_impl="xla"),
                              tasks=["train", "save"], ckpt_dir=ckpt_dir, **common),
        # 2 local rows in 4 grad_accum slices: each slice runs replicated
        # over the data axes, JAX's fallback for a slice that does not split
        "fsdp2-accum4": _worker_gang(tmp, "fsdp2-accum4", 2, fsdp=2, grad_accum=4,
                                     cfg=dict(CFG, attn_impl="xla"),
                                     tasks=["train"], **common),
        "dp2": _worker_gang(tmp, "dp2", 2, cfg=dict(CFG, attn_impl="xla"),
                            tasks=["train"], **common),
    }
    cli_dir = os.path.join(tmp, "ckpt-cli")
    cli = {
        "eval-tp2": _cli_gang(tmp, "cli-eval-tp2", EVAL_ARGS + ["--tp", "2"],
                              module="eval"),
        "tp2": _cli_gang(tmp, "cli-tp2", ["--tp", "2"]),
        "fsdp2": _cli_gang(tmp, "cli-fsdp2", ["--fsdp", "2", "--checkpoint-dir",
                                              cli_dir, "--checkpoint-every", "2"]),
    }
    mp = pytest.MonkeyPatch()
    ref = {
        "tp2": _jax_run("xla", jtopo.MeshAxes(tp=2), init, batches, mp),
        "fsdp2": _jax_run("xla", jtopo.MeshAxes(fsdp=2), init, batches, mp),
        "fsdp2-accum4": _jax_run("xla", jtopo.MeshAxes(fsdp=2), init, batches, mp,
                                 grad_accum=4),
        "dp2": _jax_run("xla", jtopo.MeshAxes(dp=2), init, batches, mp),
    }
    out = {name: _result(job) for name, job in port.items()}
    # the flash run restores the fsdp=2 checkpoint onto tp=2 at its end
    flash = _worker_gang(tmp, "flash-tp2", 2, tp=2, cfg=dict(CFG, attn_impl="flash"),
                         tasks=["train", "restore"], ckpt_dir=ckpt_dir, **common)
    ref["flash-tp2"] = _jax_run("flash", jtopo.MeshAxes(tp=2), init, batches, mp)
    out["flash-tp2"] = _result(flash)
    cli_out = {name: gang.wait() for name, gang in cli.items()}
    return dict(tmp=tmp, init=init, batches=batches, ref=ref, out=out,
                ckpt_dir=ckpt_dir, cli=cli_out, cli_dir=cli_dir)


def _assert_params_close(got: dict, want: dict, atol: float):
    got = {k[len("params/"):]: v for k, v in got.items() if k.startswith("params/")}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, atol=atol, rtol=0, err_msg=name)


@pytest.mark.parametrize("mode", ["tp2", "fsdp2", "fsdp2-accum4", "dp2"])
def test_three_steps_match_jax_on_the_matching_mesh(runs, mode):
    j_losses, j_params, routes = runs["ref"][mode]
    out = runs["out"][mode]
    np.testing.assert_allclose(out["losses"], j_losses, atol=LOSS_ATOL, rtol=0)
    _assert_params_close(out, j_params, PARAM_ATOL)
    # the steps moved the parameters by far more than the tolerance
    init = _named(runs["init"])
    assert np.abs(j_params["layers.wq"] - init["layers.wq"]).max() > 20 * PARAM_ATOL
    assert routes["reference"] > 0  # attn xla on both sides


def test_flash_at_tp2_matches_jax_and_its_route(runs):
    j_losses, j_params, routes = runs["ref"]["flash-tp2"]
    out = runs["out"]["flash-tp2"]
    # at tp=2 JAX's flash_attention, in interpret mode under shard_map's
    # vma context, falls back to its reference for the traced layer (at
    # fsdp=2 or on one device it takes the Pallas kernels): the reference
    # here is xla attention. The port's ranks ran the plain versions of
    # their kernels, never the reference; in f32 both are exact attention
    assert routes == {"reference": 1, "flash_backward": 0}
    assert int(out["reference_routes"]) == 0
    np.testing.assert_allclose(out["losses"], j_losses, atol=LOSS_ATOL, rtol=0)
    _assert_params_close(out, j_params, PARAM_ATOL)


def test_eval_at_world_2_equals_one_device(runs):
    cfg = ttm.TransformerConfig(dtype=torch.float32, attn_impl="xla", **CFG)
    eval_step, _ = ttrain.make_eval_step(cfg, "cpu")
    want = float(eval_step(bridge.from_numpy_tree(runs["init"]),
                           torch.from_numpy(runs["batches"][0])))
    got = float(runs["out"]["tp2"]["eval_loss"])
    assert abs(got - want) <= EVAL_ATOL, (got, want)


def test_checkpoint_saved_at_fsdp2_restores_at_tp2_and_on_one_device(runs):
    saved = runs["out"]["fsdp2"]
    at_tp2 = runs["out"]["flash-tp2"]
    assert int(at_tp2["restored_step"]) == STEPS
    keys = sorted(k for k in saved if k.startswith(("params/", "opt/")))
    assert any(k.endswith(".exp_avg_sq") for k in keys)
    for k in keys:
        np.testing.assert_array_equal(at_tp2["restored/" + k], saved[k], err_msg=k)
    # on one device, plain tensors, no process group
    cfg = ttm.TransformerConfig(dtype=torch.float32, attn_impl="xla", **CFG)
    _, init_fn = ttrain.make_train_step(cfg, "cpu")
    params, opt = init_fn(torch.Generator().manual_seed(1))
    step, _, _ = tckpt.restore(runs["ckpt_dir"], params, opt)
    assert step == STEPS
    for name, t in tckpt.named_leaves(params).items():
        np.testing.assert_array_equal(t.detach().numpy(), saved[f"params/{name}"])
        for key, m in opt.state[t].items():
            np.testing.assert_array_equal(m.numpy(), saved[f"opt/{name}.{key}"])
    # the serving path's loader takes it into plain tensors on one device
    served, step = tckpt.restore_serving_params(cfg, runs["ckpt_dir"],
                                                torch.Generator().manual_seed(2))
    assert step == STEPS
    for name, t in tckpt.named_leaves(served).items():
        np.testing.assert_array_equal(t.numpy(), saved[f"params/{name}"])
    # the marker records the real mesh, and the JAX package reads it
    meta = jckpt.read_metadata(runs["ckpt_dir"])
    assert meta == tckpt.read_metadata(runs["ckpt_dir"])
    assert meta["mesh"] == {"dp": 1, "fsdp": 2, "pp": 1, "ep": 1, "tp": 1, "sp": 1}
    for validate in (tckpt.validate_resume_metadata, jckpt.validate_resume_metadata):
        source = validate(meta, ttopo.MeshAxes(tp=2), cfg, global_batch=BATCH,
                          seq_len=SEQ)
        assert source == meta["mesh"]  # a cross-topology resume, accepted


def test_eval_cli_at_world_2_equals_one_device(runs, capsys):
    from hivedscheduler_tpu_torch import eval as teval

    rcs, outs = runs["cli"]["eval-tp2"]
    assert rcs == [0, 0], "\n".join(outs)
    # rank 0 alone prints the result
    lines = [[l for l in out.splitlines() if l.startswith("loss ")] for out in outs]
    assert len(lines[0]) == 1 and lines[1] == []
    assert teval.main(EVAL_ARGS) == 0
    want = float(capsys.readouterr().out.split()[1])
    got = float(lines[0][0].split()[1])
    assert abs(got - want) <= EVAL_BF16_ATOL, (got, want)


@pytest.mark.parametrize("mode", ["tp2", "fsdp2"])
def test_train_cli_runs_at_world_2(runs, mode):
    rcs, outs = runs["cli"][mode]
    assert rcs == [0, 0], "\n".join(outs)
    # rank 0 alone logs the step lines
    assert "step 2 loss" in outs[0] and "step 1 loss" in outs[0]
    assert "step 1 loss" not in outs[1]
    assert "rank 0/2: mesh MeshAxes" in outs[0]
    if mode == "fsdp2":
        assert tckpt.latest_step(runs["cli_dir"]) == 2
        assert tckpt.read_metadata(runs["cli_dir"])["mesh"]["fsdp"] == 2


@pytest.mark.slow
@pytest.mark.parametrize("degrees,grad_accum", [(dict(fsdp=2, tp=2), 1),
                                                (dict(tp=2), 2)])
def test_world_4_matches_jax(degrees, grad_accum, tmp_path, monkeypatch):
    # fsdp=2 x tp=2, and dp=2 x tp=2 with each rank's 2 rows in 2 slices
    init = jax.device_get(jtm.init_params(_jax_cfg("xla"), jax.random.PRNGKey(0)))
    np.savez(tmp_path / "init.npz", **_named(init))
    batches = np.random.default_rng(7).integers(
        0, CFG["vocab_size"], (STEPS, BATCH, SEQ)).astype(np.int32)
    np.savez(tmp_path / "batches.npz", tokens=batches)
    job = _worker_gang(str(tmp_path), "w4", 4, cfg=dict(CFG, attn_impl="xla"),
                       tasks=["train"], init=str(tmp_path / "init.npz"),
                       batches=str(tmp_path / "batches.npz"),
                       grad_accum=grad_accum, **degrees)
    axes = jtopo.infer_axes(4, **degrees)
    j_losses, j_params, _ = _jax_run("xla", axes, init, batches, monkeypatch,
                                     grad_accum=grad_accum)
    out = _result(job)
    np.testing.assert_allclose(out["losses"], j_losses, atol=LOSS_ATOL, rtol=0)
    _assert_params_close(out, j_params, PARAM_ATOL)
