"""The port's ``train --pp/--microbatches`` against the JAX package's CLI,
on the CPU.

- ``train --pp 2 --microbatches 2`` as a 2-rank gloo gang trains two steps
  and commits; the checkpoint resumes on one process at pp = 1 (a
  cross-topology resume, journaled as such) for steps 3 and 4. JAX's
  ``train --pp 2 --microbatches 2`` on 2 forced CPU devices runs all four
  steps uninterrupted. Both CLIs compute in f32 from the same weights
  (their config's dtype and ``init_params`` patched before ``main``), so
  the four losses are held at atol 1e-5, JAX's ``TestResumeMatrix``
  tolerance; the commit records the pp 2 mesh as JAX's does.
- JAX's two usage errors, ``--pp > 1`` without ``--microbatches`` and
  ``--microbatches`` without ``--pp > 1``, with its texts.
- ``--elastic`` on one device shrinks pp away with JAX's warning (JAX's
  CLI on 1 forced CPU device logs the same line) and trains unpipelined.
"""

import functools
import json
import logging
import os
import sys

import jax
import numpy as np
import pytest
import torch

from hivedscheduler_tpu import train as jtrain_cli
from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu.parallel import checkpoint as jckpt
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch import train as ttrain_cli
from hivedscheduler_tpu_torch.chaos import workload as tchaos
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.obs import journal as tjournal
from hivedscheduler_tpu_torch.parallel import checkpoint as tckpt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from test_torch_moe_sp import jax_cli, port_cli_gang, wait_all  # noqa: E402
from test_torch_sharded_train import _named  # noqa: E402
from torch_mesh_worker import unflatten  # noqa: E402

MODEL = ["--batch", "4", "--seq-len", "16", "--vocab-size", "64", "--d-model", "32",
         "--n-layers", "4", "--n-heads", "4", "--d-ff", "64", "--log-every", "1"]
PIPE = ["--pp", "2", "--microbatches", "2"]
STEPS, FIRST = 4, 2
LOSS_ATOL = 1e-5


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _run_port_f32(init_path, argv):
    """``train.main(argv)`` in this process, in f32 from ``init_path``'s
    weights -> (exit code, the train logger's lines from INFO up)."""
    with np.load(init_path) as f:
        tree = unflatten(dict(f))
    real_init = ttm.init_params

    def loaded(cfg, generator, device="cpu"):
        if str(device) == "meta":
            return real_init(cfg, generator, device)
        return bridge.from_numpy_tree(tree, device)

    mp = pytest.MonkeyPatch()
    mp.setattr(ttm, "TransformerConfig",
               functools.partial(ttm.TransformerConfig, dtype=torch.float32))
    mp.setattr(ttm, "init_params", loaded)
    disabled = logging.root.manager.disable
    logging.disable(logging.NOTSET)
    lines = _Lines()
    logging.getLogger(ttrain_cli.__name__).addHandler(lines)
    try:
        return ttrain_cli.main(argv), lines.lines
    finally:
        logging.getLogger(ttrain_cli.__name__).removeHandler(lines)
        logging.disable(disabled)
        mp.undo()
        tjournal.disable()
        tjournal.JOURNAL.clear()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pipeline-cli"))
    init = jax.device_get(jtm.init_params(
        jtm.TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64,
                              max_seq_len=16), jax.random.PRNGKey(0)))
    init_path = os.path.join(tmp, "init.npz")
    np.savez(init_path, **_named(init))
    ck = os.path.join(tmp, "ck")
    gang = port_cli_gang(tmp, "pp2", "train", 2, MODEL + PIPE + [
        "--device", "cpu", "--steps", str(FIRST), "--checkpoint-dir", ck,
        "--checkpoint-every", str(FIRST), "--timeline", os.path.join(tmp, "pp2.jsonl")],
        init_path)
    jax_runs = [
        jax_cli(tmp, "jax-pp2", "train", 2, MODEL + PIPE + [
            "--steps", str(STEPS), "--timeline", os.path.join(tmp, "jax-pp2.jsonl"),
            "--checkpoint-dir", os.path.join(tmp, "jax-ck"),
            "--checkpoint-every", str(FIRST)], init_path),
        jax_cli(tmp, "jax-elastic", "train", 1, MODEL + PIPE + [
            "--elastic", "--min-chips", "1", "--steps", "1"], init_path),
    ]
    rcs, logs = wait_all(gang + jax_runs, tmp,
                         ["pp2.0.log", "pp2.1.log", "jax-pp2.log", "jax-elastic.log"])
    assert rcs == [0, 0, 0, 0], "\n".join(logs)
    pp2_meta = tckpt.read_metadata(ck)
    # the pp 2 commit resumed on one process, pp 1
    journal = os.path.join(tmp, "journal.jsonl")
    rc, resume_warnings = _run_port_f32(init_path, MODEL + [
        "--device", "cpu", "--steps", str(STEPS), "--checkpoint-dir", ck,
        "--checkpoint-every", str(FIRST), "--timeline", os.path.join(tmp, "pp1.jsonl"),
        "--journal-file", journal])
    assert rc == 0
    with open(journal) as f:
        resumes = [e for e in map(json.loads, f) if e["type"] == "train_resume"]
    rc, elastic_warnings = _run_port_f32(init_path, MODEL + PIPE + [
        "--device", "cpu", "--elastic", "--min-chips", "1", "--steps", "1"])
    assert rc == 0
    return dict(
        port={**tchaos.read_timeline(os.path.join(tmp, "pp2.jsonl")),
              **tchaos.read_timeline(os.path.join(tmp, "pp1.jsonl"))},
        jax=tchaos.read_timeline(os.path.join(tmp, "jax-pp2.jsonl")),
        pp2_meta=pp2_meta, jax_meta=jckpt.read_metadata(os.path.join(tmp, "jax-ck"),
                                                        FIRST),
        after=tckpt.read_metadata(ck), resumes=resumes, resume_warnings=resume_warnings,
        elastic_warnings=elastic_warnings, jax_elastic_log=logs[3], gang_log=logs[0])


def test_pp2_gang_and_its_pp1_resume_match_jax_cli(runs):
    assert sorted(runs["port"]) == list(range(1, STEPS + 1))
    assert sorted(runs["jax"]) == list(range(1, STEPS + 1))
    got = [runs["port"][s] for s in range(1, STEPS + 1)]
    want = [runs["jax"][s] for s in range(1, STEPS + 1)]
    np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0)
    assert "pipeline_microbatches=2" in runs["gang_log"]


def test_pp2_commit_records_jax_metadata_and_resumes_cross_topology(runs):
    assert runs["pp2_meta"]["mesh"] == runs["jax_meta"]["mesh"] == dict(
        dp=1, fsdp=1, pp=2, ep=1, tp=1, sp=1)
    assert runs["pp2_meta"]["model"] == runs["jax_meta"]["model"]
    assert runs["after"]["mesh"]["pp"] == 1
    assert [e["args"] for e in runs["resumes"]] == [
        {"step": FIRST, "crossTopology": True}]
    assert any(w.startswith("cross-topology resume") for w in runs["resume_warnings"])


def test_elastic_shrinks_pp_away_with_jax_warning(runs):
    derived = [w for w in runs["elastic_warnings"] if w.startswith("elastic: requested")]
    want = [line[line.index("elastic: requested"):] for line in
            runs["jax_elastic_log"].splitlines() if "elastic: requested" in line]
    assert derived == want == [
        "elastic: requested (tp, sp, fsdp, pp, ep)=(1, 1, 1, 2, 1) does not fit the "
        "offered 1-chip slice; derived mesh MeshAxes(dp=1, fsdp=1, pp=1, ep=1, tp=1, "
        "sp=1)"]
    configs = [w for w in runs["elastic_warnings"] if "config TransformerConfig" in w]
    assert len(configs) == 1 and "pipeline_microbatches=0" in configs[0]


@pytest.mark.parametrize("argv,message", [
    (["--pp", "2"], "--pp > 1 requires --microbatches"),
    (["--microbatches", "2"], "--microbatches requires --pp > 1"),
])
def test_usage_errors_are_jax_cli_errors(argv, message, capsys):
    for main in (jtrain_cli.main, ttrain_cli.main):
        with pytest.raises(SystemExit) as exc:
            main(MODEL + argv)
        assert exc.value.code == 2
        assert f"error: {message}" in capsys.readouterr().err
