"""Resume of the port's training (hivedscheduler_tpu_torch): against the JAX
package's uninterrupted run on the same weights, then through the train
CLI (resume, rollback, warm start, preemption, the fault ladder's fast
in-process cousins) and the eval CLI's ``--checkpoint-dir``.

Against JAX, weights are made by the JAX package and carried across with
``bridge``; both run f32. JAX's ``make_sharded_train_step`` takes 4 steps;
the port takes 2, saves, restores into fresh tensors and a fresh AdamW,
and takes 2 more. The tolerances are ``test_torch_train.py``'s for f32
(losses atol 1e-5, parameters atol 3e-5): the two differ by summation
order only. On the CPU the port's own resume is bit-exact.

The subprocess fault ladder (kill -9, SIGTERM, hang in one seeded plan,
through the port's ``chaos/workload.py``) takes ~40 s alone and is marked
slow; its cousins here keep each episode kind in tier-1.
"""

import json
import logging
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu.parallel import checkpoint as jck
from hivedscheduler_tpu.parallel import topology as jtopo
from hivedscheduler_tpu.parallel import train as jtrain
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch import eval as teval_cli
from hivedscheduler_tpu_torch import train as ttrain_cli
from hivedscheduler_tpu_torch.chaos import workload as tchaos
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.obs import goodput as tgp
from hivedscheduler_tpu_torch.parallel import checkpoint as tck
from hivedscheduler_tpu_torch.parallel import data as tdata
from hivedscheduler_tpu_torch.parallel import supervisor as tsup
from hivedscheduler_tpu_torch.parallel import train as ttrain

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_ATOL = 1e-5
PARAM_ATOL = 3e-5

SMALL = dict(vocab_size=96, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
             d_ff=128, max_seq_len=64, attn_impl="xla")
BATCH, SEQ = 2, 64


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, SMALL["vocab_size"], (BATCH, SEQ)).astype(np.int32)
            for _ in range(n)]


def _jax_reference(batches):
    """JAX's uninterrupted run -> (losses, final numpy params, initial
    numpy params)."""
    jcfg = jtm.TransformerConfig(dtype=jax.numpy.float32, **SMALL)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        mesh = jtopo.make_mesh(jtopo.MeshAxes(), jax.devices("cpu")[:1])
        step, init_fn, tok_sh = jtrain.make_sharded_train_step(jcfg, mesh)
        params, opt = init_fn(jax.random.PRNGKey(0))
        init = jax.device_get(params)
        losses = []
        for tokens in batches:
            params, opt, loss = step(params, opt, jax.device_put(tokens, tok_sh))
            losses.append(float(loss))
        return losses, jax.device_get(params), init


def _port_state(init_np):
    params = bridge.from_numpy_tree(init_np)
    leaves = list(tck.named_leaves(params).values())
    for leaf in leaves:
        leaf.requires_grad_(True)
    return params, ttrain.make_optimizer()(leaves)


def _port_resumed(init_np, batches, ckdir, tamper=None):
    """2 steps, save, restore into fresh tensors and a fresh AdamW,
    ``tamper`` with the restored optimizer, the remaining steps."""
    step, _ = ttrain.make_train_step(
        ttm.TransformerConfig(dtype=torch.float32, **SMALL), "cpu")
    params, opt = _port_state(init_np)
    losses = []
    for tokens in batches[:2]:
        params, opt, loss = step(params, opt, torch.from_numpy(tokens))
        losses.append(float(loss))
    tck.save(ckdir, 2, params, opt)
    del params, opt
    fresh_np = bridge.map_tree(np.zeros_like, init_np)
    params, opt = _port_state(fresh_np)
    assert tck.restore(ckdir, params, opt)[0] == 2
    if tamper is not None:
        tamper(opt)
    for tokens in batches[2:]:
        params, opt, loss = step(params, opt, torch.from_numpy(tokens))
        losses.append(float(loss))
    return losses, bridge.to_numpy_tree(params)


def _max_param_err(got, want):
    g = jax.tree_util.tree_leaves(got)
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    return max(float(np.abs(a - b).max()) for a, b in zip(g, w))


@pytest.fixture(scope="module")
def jax_reference():
    batches = _batches(4)
    return batches, _jax_reference(batches)


def test_resumed_port_run_matches_jax_uninterrupted(jax_reference, tmp_path):
    batches, (j_losses, j_params, init) = jax_reference
    t_losses, t_params = _port_resumed(init, batches, str(tmp_path))
    np.testing.assert_allclose(t_losses, j_losses, atol=LOSS_ATOL, rtol=0)
    assert _max_param_err(t_params, j_params) <= PARAM_ATOL
    # four steps moved the parameters by far more than the tolerance
    assert _max_param_err(init, j_params) > 30 * PARAM_ATOL


def test_a_resume_that_resets_adamw_step_is_caught(jax_reference, tmp_path):
    # planted fault: the moments restored but every parameter's step count
    # back at 0, so bias correction restarts
    batches, (j_losses, j_params, init) = jax_reference

    def reset_steps(opt):
        for state in opt.state.values():
            state["step"].zero_()

    t_losses, t_params = _port_resumed(init, batches, str(tmp_path),
                                       tamper=reset_steps)
    err = _max_param_err(t_params, j_params)
    assert err > PARAM_ATOL, f"a reset AdamW step went unseen (max err {err})"
    np.testing.assert_allclose(t_losses[:3], j_losses[:3], atol=LOSS_ATOL, rtol=0)


# -- the train CLI ------------------------------------------------------------

CLI_MODEL = ["--vocab-size", "96", "--d-model", "64", "--n-layers", "2",
             "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "128",
             "--seq-len", "128", "--batch", "2", "--block-q", "64",
             "--block-k", "64", "--ce-chunk", "64", "--device", "cpu",
             "--attn", "flash", "--log-every", "100"]
TCFG = ttm.TransformerConfig(vocab_size=96, d_model=64, n_layers=2, n_heads=4,
                             n_kv_heads=2, d_ff=128, max_seq_len=128,
                             attn_impl="flash", attn_block_q=64, attn_block_k=64)


@pytest.fixture(autouse=True)
def _fresh_goodput():
    """The goodput ledger is a process singleton: each test starts with it
    off and leaves it off."""
    tgp.disable()
    tgp.GOODPUT.clear()
    yield
    tgp.disable()
    tgp.GOODPUT.clear()


def _train(tmp_path, name, *extra):
    tl = tmp_path / f"{name}.jsonl"
    rc = ttrain_cli.main(CLI_MODEL + ["--timeline", str(tl)] + list(extra))
    recs = [json.loads(line) for line in tl.read_text().splitlines()] if tl.exists() else []
    return rc, recs


def _losses(recs):
    out = {}
    for r in recs:
        out[r["step"]] = r["loss"]  # the last record of a step wins
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The uninterrupted 4-step CLI run's losses."""
    rc, recs = _train(tmp_path_factory.mktemp("ref"), "ref", "--steps", "4")
    assert rc == 0
    return _losses(recs)


def test_cli_resume_is_bit_exact(tmp_path, reference):
    ck = str(tmp_path / "ck")
    gp = str(tmp_path / "goodput.jsonl")
    rc, first = _train(tmp_path, "b1", "--steps", "2", "--checkpoint-dir", ck,
                       "--checkpoint-every", "2", "--goodput-file", gp)
    assert rc == 0
    tgp.GOODPUT.close()  # what the process's exit does
    tgp.disable()
    tgp.GOODPUT.clear()
    meta = tck.read_metadata(ck)
    assert meta["loader"]["step"] == 2 and meta["loader"]["bitgen"] is not None
    assert meta["model"]["d_model"] == 64 and meta["data"] == {"global_batch": 2, "seq_len": 128}
    rc, second = _train(tmp_path, "b2", "--steps", "4", "--checkpoint-dir", ck,
                        "--checkpoint-every", "2", "--goodput-file", gp)
    assert rc == 0
    tgp.GOODPUT.close()
    assert [r["step"] for r in first] == [1, 2] and [r["step"] for r in second] == [3, 4]
    assert [r["compile"] for r in second] == [True, False]
    assert {**_losses(first), **_losses(second)} == reference  # bit for bit
    assert tck._committed_steps(ck) == jck._committed_steps(ck) == [4, 2]
    assert jck.read_metadata(ck) == tck.read_metadata(ck)
    assert tck.read_metadata(ck)["loader"]["step"] == 4
    # the goodput spool of both incarnations passes the JAX package's audit
    from hivedscheduler_tpu.obs import goodput as jgp

    assert jgp.check_spool(gp) == []
    recs = jgp.read_spool(gp)
    assert jgp.check_rework_classification(recs) == []
    agg = jgp.aggregate_spool(recs)
    assert (agg["incarnations"], agg["torn"], agg["steps"], agg["rework_steps"]) == (2, 0, 4, 0)
    for phase in ("checkpoint_save", "checkpoint_restore", "compile", "step_compute"):
        assert agg["phases"][phase] > 0.0, phase


def test_cli_resume_refuses_another_geometry_or_stream(tmp_path):
    ck = str(tmp_path / "ck")
    assert _train(tmp_path, "a", "--steps", "2", "--checkpoint-dir", ck)[0] == 0
    for flag, value, what in (("--d-model", "32", "geometry"),
                              ("--batch", "4", "data stream")):
        args = list(CLI_MODEL)
        args[args.index(flag) + 1] = value
        with pytest.raises(ValueError) as err:
            ttrain_cli.main(args + ["--steps", "4", "--checkpoint-dir", ck])
        assert what in str(err.value)


def test_cli_kill_cousin_resumes_bit_exact(tmp_path, reference, monkeypatch):
    # the process dies in step 4 (kill -9 between two commits), after a save
    # of step 4 was begun but never committed
    ck = str(tmp_path / "ck")
    calls = []
    real = ttrain.loss_fn

    class Killed(Exception):
        pass

    def dying(*a, **kw):
        calls.append(1)
        if len(calls) == 4:
            raise Killed
        return real(*a, **kw)

    monkeypatch.setattr(ttrain, "loss_fn", dying)
    with pytest.raises(Killed):
        _train(tmp_path, "k1", "--steps", "4", "--checkpoint-dir", ck,
               "--checkpoint-every", "2")
    monkeypatch.setattr(ttrain, "loss_fn", real)
    os.makedirs(os.path.join(ck, "4"))  # the uncommitted save
    assert tck.latest_step(ck) == 2
    rc, recs = _train(tmp_path, "k2", "--steps", "4", "--checkpoint-dir", ck,
                      "--checkpoint-every", "2")
    assert rc == 0 and [r["step"] for r in recs] == [3, 4]
    assert all(reference[s] == loss for s, loss in _losses(recs).items())
    assert tck.latest_step(ck) == 4


def test_cli_sigterm_cousin_checkpoints_exits_0_and_resumes(tmp_path, reference,
                                                            monkeypatch):
    import signal

    ck = str(tmp_path / "ck")
    calls = []
    real = ttrain.loss_fn

    def preempted(*a, **kw):
        calls.append(1)
        if len(calls) == 3:  # SIGTERM lands during step 3
            os.kill(os.getpid(), signal.SIGTERM)
        return real(*a, **kw)

    monkeypatch.setattr(ttrain, "loss_fn", preempted)
    rc, recs = _train(tmp_path, "t1", "--steps", "4", "--checkpoint-dir", ck,
                      "--checkpoint-every", "100", "--grace-secs", "60")
    monkeypatch.setattr(ttrain, "loss_fn", real)
    assert rc == 0
    assert [r["step"] for r in recs] == [1, 2, 3]  # stopped at the boundary
    assert tck.latest_step(ck) == 3
    assert tck.read_metadata(ck)["loader"]["step"] == 3
    rc, recs2 = _train(tmp_path, "t2", "--steps", "4", "--checkpoint-dir", ck,
                       "--checkpoint-every", "100")
    assert rc == 0 and [r["step"] for r in recs2] == [4]
    assert {**_losses(recs), **_losses(recs2)} == reference


def test_cli_hang_cousin_watchdog_exits_43_with_a_stall_record(tmp_path):
    ck = tmp_path / "ck"
    cmd = [sys.executable, "-m", "hivedscheduler_tpu_torch.train", "--device", "cpu",
           "--steps", "3", "--batch", "2", "--seq-len", "16", "--vocab-size", "64",
           "--d-model", "16", "--n-layers", "1", "--n-heads", "2", "--d-ff", "32",
           "--checkpoint-dir", str(ck), "--checkpoint-every", "1",
           "--watchdog-secs", "1"]
    env = tchaos.cpu_only_env(**{tsup.ENV_FAULT_HANG_AT: "2"})
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == tsup.EXIT_STALLED, proc.stderr[-2000:]
    record = json.loads((ck / tsup.STALL_RECORD).read_text())
    assert record["kind"] == "watchdog_stall" and record["last_step"] == 1
    assert tck.latest_step(str(ck)) == 1  # the step before the hang committed


def test_cli_rollback_recovers_from_injected_nan(tmp_path, monkeypatch):
    import math

    monkeypatch.setenv(tsup.ENV_FAULT_NAN_AT, "4")
    ck = str(tmp_path / "ck")
    rc, recs = _train(tmp_path, "r", "--steps", "6", "--checkpoint-dir", ck,
                      "--checkpoint-every", "2", "--on-nan", "rollback")
    assert rc == 0
    # the diverged step was recorded (NaN), then replayed clean after the
    # rollback to step 2, with the poisoned data position skipped
    assert any(r["step"] == 4 and math.isnan(r["loss"]) for r in recs)
    final = _losses(recs)
    assert set(final) == set(range(1, 7))
    assert all(math.isfinite(v) for v in final.values())
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 3, 4, 5, 6]
    assert tck.read_metadata(ck)["loader"]["step"] == 7  # one batch skipped


def test_cli_halt_and_exhausted_rollback_budget_exit_44(tmp_path, monkeypatch):
    for policy, extra in (("halt", []), ("rollback", ["--max-rollbacks", "0"])):
        monkeypatch.setenv(tsup.ENV_FAULT_NAN_AT, "4")
        ck = str(tmp_path / policy)
        rc, recs = _train(tmp_path, policy, "--steps", "6", "--checkpoint-dir", ck,
                          "--checkpoint-every", "2", "--on-nan", policy, *extra)
        assert rc == tsup.EXIT_DIVERGED
        assert tck.latest_step(ck) == 2  # the poisoned step never committed


def test_cli_init_from_warm_starts_params_with_a_fresh_optimizer(tmp_path):
    base = str(tmp_path / "base")
    assert _train(tmp_path, "base", "--steps", "3", "--checkpoint-dir", base)[0] == 0
    ck = str(tmp_path / "ck")
    rc, recs = _train(tmp_path, "warm", "--steps", "1", "--init-from", base,
                      "--checkpoint-dir", ck)
    assert rc == 0
    # the same step on the restored weights with a fresh AdamW and a fresh
    # loader
    step, init_fn = ttrain.make_train_step(TCFG, "cpu", ce_chunk=64)
    params, opt = init_fn(torch.Generator().manual_seed(0))
    tck.restore_params(base, params)
    loader = tdata.CheckpointableBatches(tdata.synthetic_dataset(96), 2, 128)
    _, opt, loss = step(params, opt, torch.from_numpy(next(loader)))
    assert recs[0]["loss"] == float(loss)
    # the warm-started run's optimizer counted one step, not four
    _, init_fn2 = ttrain.make_train_step(TCFG, "cpu", ce_chunk=64)
    params2, opt2 = init_fn2(torch.Generator().manual_seed(0))
    tck.restore(ck, params2, opt2)
    assert {float(s["step"]) for s in opt2.state.values()} == {1.0}


def test_eval_checkpoint_dir_equals_eval_of_the_params_in_memory(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    assert _train(tmp_path, "t", "--steps", "2", "--checkpoint-dir", ck)[0] == 0
    # the same two steps in memory, then the eval windows on those params
    step, init_fn = ttrain.make_train_step(TCFG, "cpu", ce_chunk=64)
    params, opt = init_fn(torch.Generator().manual_seed(0))
    loader = tdata.CheckpointableBatches(tdata.synthetic_dataset(96), 2, 128)
    for _ in range(2):
        params, opt, _ = step(params, opt, torch.from_numpy(next(loader)))
    eval_step, _ = ttrain.make_eval_step(TCFG, "cpu", ce_chunk=64)
    corpus = tdata.synthetic_dataset(96).tokens
    windows = [np.asarray(corpus[i * 256:(i + 1) * 256], np.int32).reshape(2, 128)
               for i in range(2)]
    want = sum(float(eval_step(params, torch.from_numpy(w))) for w in windows) / 2
    drop = {"--block-q", "--block-k", "--log-every"}  # train-only flags
    eval_args = [a for i, a in enumerate(CLI_MODEL)
                 if a not in drop and CLI_MODEL[i - 1] not in drop]
    capsys.readouterr()
    gp = str(tmp_path / "eval-goodput.jsonl")
    assert teval_cli.main(eval_args + ["--max-steps", "2", "--checkpoint-dir", ck,
                                       "--goodput-file", gp]) == 0
    tgp.GOODPUT.close()
    line = [l for l in capsys.readouterr().out.splitlines() if l.startswith("loss ")][-1]
    assert float(line.split()[1]) == pytest.approx(want, abs=1e-6)
    assert teval_cli.main(eval_args + ["--max-steps", "2"]) == 0
    fresh = [l for l in capsys.readouterr().out.splitlines() if l.startswith("loss ")][-1]
    assert abs(float(fresh.split()[1]) - want) > 1e-3  # the restore mattered
    phases = tgp.aggregate_spool(tgp.read_spool(gp))["phases"]
    assert phases["checkpoint_restore"] > 0.0 and phases["eval"] > 0.0
    assert tgp.check_spool(gp) == []


@pytest.mark.slow  # ~40 s alone: five CPU training processes
def test_chaos_seed_kill9_sigterm_hang_is_bit_exact(tmp_path):
    harness = tchaos.WorkloadChaosHarness(
        seed=94, workdir=str(tmp_path),
        plan=tchaos.WorkloadFaultPlan(episodes=3))
    assert sorted(k for k, _ in harness.episodes) == ["hang", "sigkill", "sigterm"]
    report = harness.run()
    assert report["violations"] == [], report
    gp = report["goodput"]
    assert gp["incarnations"] == 4 and gp["torn"] == 2  # kill -9 and the hang
    assert gp["steps"] >= harness.steps and gp["phases"]["checkpoint_save"] > 0.0


def test_chaos_plan_and_env_match_jax_harness(monkeypatch):
    import random

    from hivedscheduler_tpu.chaos import workload as jchaos

    assert tchaos.EPISODE_KINDS == jchaos.EPISODE_KINDS
    for seed in (0, 7, 94):
        assert tchaos.WorkloadFaultPlan(episodes=3).draw(random.Random(seed), 8) == \
            jchaos.WorkloadFaultPlan(episodes=3).draw(random.Random(seed), 8)
    monkeypatch.setenv("HIVED_FAULT_NAN_AT", "3")
    env = tchaos.cpu_only_env(HIVED_FAULT_HANG_AT="5")
    assert env["CUDA_VISIBLE_DEVICES"] == "" and env["HIVED_FAULT_HANG_AT"] == "5"
    assert "HIVED_FAULT_NAN_AT" not in env
    cmd = tchaos.WorkloadChaosHarness(0, "/w").train_cmd("ck", "tl")
    assert cmd[1:5] == ["-m", "hivedscheduler_tpu_torch.train", "--device", "cpu"]
