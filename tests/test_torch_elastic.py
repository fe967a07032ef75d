"""The port's elastic training (``train --elastic/--min-chips``) and its
``ElasticWorkloadHarness`` on the CPU, against the JAX package's.

- ``--min-chips`` without ``--elastic`` is the JAX CLI's usage error; an
  offer below the floor exits nonzero with JAX's message, on every rank of
  a gang, before any weight is built.
- An elastic run at world 1 asked for ``--tp 2`` derives the one-device
  mesh (with JAX's warning) and then resumes as a 2-rank gloo gang at
  ``--tp 2``: each commit's mesh and ``elastic`` metadata equal what JAX's
  ``train --elastic`` writes for the same device count (run as a
  subprocess on 1 and 2 forced CPU devices), the gang's commit records tp
  2, the resume is counted as cross-topology in the journal, and the
  losses after the resume equal an uninterrupted port run at rtol/atol
  1e-5, JAX's ``TestResumeMatrix`` tolerance. The CLI computes in bf16;
  these runs patch the config's dtype to f32 (``F32_CLI``), so that the
  comparison is one of summation order alone.
- ``ElasticWorkloadHarness`` draws JAX's ``kill_step`` and
  ``preempt_step`` for seeds 0-9, and one whole episode (kill -9 on a
  2-rank gang, a 1-rank shrunk resume, a 2-rank grown resume; ~25 s) ends
  with no violation.
"""

import functools
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hivedscheduler_tpu.chaos import workload as jchaos
from hivedscheduler_tpu.parallel import checkpoint as jckpt
from hivedscheduler_tpu_torch import train as ttrain_cli
from hivedscheduler_tpu_torch.chaos import workload as tchaos
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.obs import goodput as tgp
from hivedscheduler_tpu_torch.obs import journal as tjournal
from hivedscheduler_tpu_torch.parallel import distributed as tdist
from hivedscheduler_tpu_torch.parallel import checkpoint as tckpt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOB_TIMEOUT = 240
MODEL = ["--batch", "2", "--seq-len", "16", "--vocab-size", "64", "--d-model", "16",
         "--n-layers", "1", "--n-heads", "2", "--d-ff", "32", "--log-every", "100"]
PORT_MODEL = MODEL + ["--device", "cpu"]
ELASTIC = ["--elastic", "--min-chips", "1", "--tp", "2"]
STEPS, FIRST = 4, 2  # the resumed gang trains steps 3 and 4
# the train CLI in f32: its config's dtype patched before main runs
F32_CLI = ("import functools, sys, torch\n"
           "from hivedscheduler_tpu_torch.models import transformer as tm\n"
           "tm.TransformerConfig = functools.partial(tm.TransformerConfig, "
           "dtype=torch.float32)\n")


def _gang(tmp, name, world, argv, f32=False):
    """``train.main(argv)`` in each rank of a one-pod gloo gang (the
    harness's launch, with the config patched to f32 when asked); returns
    the processes, each rank's stderr in ``{name}.{rank}.err``."""
    code = tchaos._GANG_LAUNCH
    if f32:
        code = F32_CLI + code
    port = str(tdist._free_local_port())
    procs = []
    for rank in range(world):
        err = open(os.path.join(tmp, f"{name}.{rank}.err"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, port] + argv, cwd=ROOT,
            env=tchaos.cpu_only_env(gang=(world, rank)),
            stdout=subprocess.DEVNULL, stderr=err))
    return procs


def _wait(procs):
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=JOB_TIMEOUT))
        except subprocess.TimeoutExpired:
            p.kill()
            rcs.append(p.wait())
    return rcs


def _jax_train(tmp, name, devices, argv):
    """JAX's ``train`` CLI as a subprocess on ``devices`` forced CPU
    devices."""
    return subprocess.Popen(
        [sys.executable, "-m", "hivedscheduler_tpu.train"] + argv, cwd=ROOT,
        env=jchaos.cpu_only_env(devices=devices), stdout=subprocess.DEVNULL,
        stderr=open(os.path.join(tmp, f"{name}.err"), "w"))


class _Warnings(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _obs_off():
    tgp.GOODPUT.close()
    tgp.disable()
    tgp.GOODPUT.clear()
    tjournal.disable()
    tjournal.JOURNAL.clear()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("elastic"))
    ck = os.path.join(tmp, "ck")
    ref_ck = os.path.join(tmp, "ref-ck")
    # started first: the floor on a 2-rank gang, and JAX's elastic runs on 1
    # and 2 devices
    floor = _gang(tmp, "floor", 2, PORT_MODEL + ["--elastic", "--min-chips", "3",
                                                 "--steps", "1"])
    jax_runs = {n: _jax_train(tmp, f"jax-{n}", n, MODEL + ELASTIC + [
        "--steps", "2", "--checkpoint-dir", os.path.join(tmp, f"jax-{n}"),
        "--checkpoint-every", "2"]) for n in (1, 2)}

    # one rank: an elastic run asked for tp 2 derives the one-device mesh
    mp = pytest.MonkeyPatch()
    mp.setattr(ttm, "TransformerConfig",
               functools.partial(ttm.TransformerConfig, dtype=torch.float32))
    disabled = logging.root.manager.disable
    logging.disable(logging.NOTSET)
    warnings = _Warnings()
    logging.getLogger(ttrain_cli.__name__).addHandler(warnings)
    try:
        tl1 = os.path.join(tmp, "world1.jsonl")
        assert ttrain_cli.main(PORT_MODEL + ELASTIC + [
            "--steps", str(FIRST), "--checkpoint-dir", ck, "--checkpoint-every", "2",
            "--timeline", tl1]) == 0
        world1_meta = tckpt.read_metadata(ck)
        ref_tl = os.path.join(tmp, "ref.jsonl")
        assert ttrain_cli.main(PORT_MODEL + ELASTIC + [
            "--steps", str(STEPS), "--checkpoint-dir", ref_ck, "--checkpoint-every", "2",
            "--timeline", ref_tl]) == 0
    finally:
        logging.getLogger(ttrain_cli.__name__).removeHandler(warnings)
        logging.disable(disabled)
        mp.undo()
    # then the same checkpoint directory on a 2-rank gang at --tp 2
    tl2 = os.path.join(tmp, "gang.jsonl")
    journal = os.path.join(tmp, "journal.jsonl")
    resumed = _gang(tmp, "resume", 2, PORT_MODEL + ELASTIC + [
        "--steps", str(STEPS), "--checkpoint-dir", ck, "--checkpoint-every", "2",
        "--timeline", tl2, "--journal-file", journal], f32=True)
    out = dict(
        floor=(_wait(floor), [open(os.path.join(tmp, f"floor.{r}.err")).read()
                              for r in range(2)]),
        resume=(_wait(resumed), [open(os.path.join(tmp, f"resume.{r}.err")).read()
                                 for r in range(2)]),
        world1_meta=world1_meta, warnings=warnings.lines,
        world1=tchaos.read_timeline(tl1), gang=tchaos.read_timeline(tl2),
        ref=tchaos.read_timeline(ref_tl), ck=ck, journal=journal)
    out["jax"] = {}
    for n, proc in jax_runs.items():
        assert proc.wait(timeout=JOB_TIMEOUT) == 0, open(
            os.path.join(tmp, f"jax-{n}.err")).read()
        out["jax"][n] = jckpt.read_metadata(os.path.join(tmp, f"jax-{n}"))
    return out


def test_min_chips_without_elastic_is_a_usage_error(capsys):
    with pytest.raises(SystemExit) as exc:
        ttrain_cli.main(PORT_MODEL + ["--min-chips", "2"])
    assert exc.value.code == 2
    assert "--min-chips requires --elastic" in capsys.readouterr().err


def test_floor_exits_before_any_weight_is_built(monkeypatch):
    def no_weights(*a, **kw):
        raise AssertionError("a weight was built below the floor")

    monkeypatch.setattr(ttm, "init_params", no_weights)
    with pytest.raises(SystemExit) as exc:
        ttrain_cli.main(PORT_MODEL + ["--elastic", "--min-chips", "2"])
    assert str(exc.value.code) == ("elastic job floor not met: offered 1 chip(s), "
                                   "--min-chips 2")
    assert not torch.distributed.is_initialized()


def test_floor_exits_every_gang_rank(runs):
    rcs, errs = runs["floor"]
    assert all(rc != 0 for rc in rcs), rcs
    for err in errs:
        assert "elastic job floor not met: offered 2 chip(s), --min-chips 3" in err


def test_world_1_derives_jax_mesh_and_metadata(runs):
    meta, want = runs["world1_meta"], runs["jax"][1]
    assert meta["mesh"] == want["mesh"] == dict(dp=1, fsdp=1, pp=1, ep=1, tp=1, sp=1)
    assert meta["elastic"] == want["elastic"] == {
        "min_chips": 1, "requested": dict(tp=2, sp=1, fsdp=1, pp=1, ep=1)}
    assert meta["data"] == want["data"]
    assert any("elastic: requested (tp, sp, fsdp, pp, ep)=(2, 1, 1, 1, 1) does not "
               "fit the offered 1-chip slice" in w for w in runs["warnings"])


def test_gang_resume_records_tp2_and_jax_metadata(runs):
    rcs, errs = runs["resume"]
    assert rcs == [0, 0], errs
    meta, want = tckpt.read_metadata(runs["ck"]), runs["jax"][2]
    assert tckpt.latest_step(runs["ck"]) == STEPS
    assert meta["mesh"] == want["mesh"] == dict(dp=1, fsdp=1, pp=1, ep=1, tp=2, sp=1)
    assert meta["elastic"] == want["elastic"]
    # rank 0 spooled the resume, across meshes
    with open(runs["journal"]) as f:
        events = [json.loads(line) for line in f if line.strip()]
    resumes = [e for e in events if e.get("type") == "train_resume"]
    assert len(resumes) == 1 and resumes[0]["args"]["crossTopology"] is True
    assert resumes[0]["args"]["step"] == FIRST


def test_cross_topology_resume_matches_the_uninterrupted_run(runs):
    ref, world1, gang = runs["ref"], runs["world1"], runs["gang"]
    assert sorted(world1) == list(range(1, FIRST + 1))
    assert sorted(gang) == list(range(FIRST + 1, STEPS + 1))
    assert [world1[s] for s in sorted(world1)] == [ref[s] for s in sorted(world1)]
    np.testing.assert_allclose([gang[s] for s in sorted(gang)],
                               [ref[s] for s in sorted(gang)], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", range(10))
def test_harness_draws_jax_plan(seed, tmp_path):
    got = tchaos.ElasticWorkloadHarness(seed, str(tmp_path))
    want = jchaos.ElasticWorkloadHarness(seed, str(tmp_path))
    assert (got.kill_step, got.preempt_step) == (want.kill_step, want.preempt_step)


def test_elastic_episode_on_gloo_gangs_has_no_violations(tmp_path):
    _obs_off()
    report = tchaos.ElasticWorkloadHarness(0, str(tmp_path)).run()
    assert report["violations"] == []
    assert report["goodput"]["incarnations"] == 3 and report["goodput"]["torn"] == 1
    assert report["goodput"]["phases"]["checkpoint_save"] > 0.0
