"""The port's serve CLI (hivedscheduler_tpu_torch.serve) on the CPU.

Each run is held to the library it stands for: the ``[rid] tokens`` lines
equal a ``ServingEngine`` run on the same seeded weights, trace and
arrivals, token for token, and the dense, paged and fused-window runs of
one trace print the same streams. The summary lines are checked by their
content (tokens/s, fused windows, prefix hits, the paged pool, the
speculative acceptance), the preempt-at fault drains and exits 0,
``--tp/--dp`` above 1 in one process (a usage error) exit non-zero, and
``--device cuda`` without a card raises. ``--spec-decode`` serves the speculative engine's
streams with the CLI's draft, and ``--lora-rank`` a LoRA run's merged
model, each equal to the library run on the same weights.
"""

import logging

import pytest
import torch

from hivedscheduler_tpu_torch import serve as tserve
from hivedscheduler_tpu_torch.common import envflags
from hivedscheduler_tpu_torch.models import serving as tsrv
from hivedscheduler_tpu_torch.models import speculative as tspec
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.obs import goodput as tgp
from hivedscheduler_tpu_torch.parallel import checkpoint as tck
from hivedscheduler_tpu_torch.parallel import supervisor as tsup

torch.set_num_threads(1)

MODEL = dict(vocab_size=96, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=128)
RUN = dict(requests=5, max_batch=2, max_len=64, max_new_tokens=6, arrival_every=2, seed=3)
CLI = [a for k, v in {**MODEL, **RUN}.items()
       for a in (f"--{k.replace('_', '-')}", str(v))] + ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _fresh_goodput():
    tgp.disable()
    tgp.GOODPUT.clear()
    yield
    tgp.disable()
    tgp.GOODPUT.clear()


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture
def log_lines():
    """The CLI's log messages, with logging enabled while it runs (a
    module another test imports may have disabled it process-wide)."""
    disabled = logging.root.manager.disable
    logging.disable(logging.NOTSET)
    handler = _Messages()
    logger = logging.getLogger(tserve.__name__)
    logger.addHandler(handler)
    yield handler.lines
    logger.removeHandler(handler)
    logging.disable(disabled)


def _run(capsys, *extra):
    capsys.readouterr()
    rc = tserve.main(CLI + list(extra))
    out = capsys.readouterr().out
    streams = {}
    for line in out.splitlines():
        rid, _, toks = line.partition("] ")
        streams[int(rid.lstrip("["))] = [int(t) for t in toks.split()]
    return rc, streams


def _engine_streams(system_len=0, checkpoint_dir="", lora=None, draft=None, **kw):
    """The same run through the library: weights from --seed (restored from
    ``checkpoint_dir``, LoRA adapters of ``lora`` merged), the trace from
    --seed + 1, one arrival every --arrival-every steps; ``draft`` = (draft
    layers, gamma) serves speculatively with the CLI's draft."""
    cfg = ttm.TransformerConfig(max_seq_len=RUN["max_len"], **MODEL)
    params, _ = tck.restore_serving_params(cfg, checkpoint_dir,
                                           torch.Generator().manual_seed(RUN["seed"]),
                                           **(lora or {}))
    params = ttm.cast_params(params, cfg.dtype)
    if draft is not None:
        dcfg = tspec.derive_draft_config(cfg, draft[0])
        dparams = ttm.cast_params(ttm.init_params(
            dcfg, torch.Generator().manual_seed(RUN["seed"] + 3)), dcfg.dtype)
        kw["spec_decode"] = tspec.SpecDecodeConfig(dparams, dcfg, gamma=draft[1])
    eng = tsrv.ServingEngine(params, cfg, max_batch=RUN["max_batch"],
                             max_len=RUN["max_len"], seed=RUN["seed"], **kw)
    pending = tserve.synthetic_trace(RUN["seed"] + 1, RUN["requests"], cfg.vocab_size,
                                     RUN["max_new_tokens"], system_len)
    reqs, step = [], 0
    while pending or not all(r.done for r in reqs):
        if pending and step % RUN["arrival_every"] == 0:
            reqs.append(eng.submit(*pending.pop(0)))
        eng.step()
        step += 1
    return {r.rid: r.tokens_out for r in reqs}


@pytest.fixture(scope="module")
def reference():
    return _engine_streams()


def test_cli_prints_the_engines_streams(capsys, log_lines, reference):
    rc, streams = _run(capsys)
    assert rc == 0 and streams == reference
    assert len(streams) == RUN["requests"]
    assert any("tok/s" in line and "occupancy" in line for line in log_lines)
    assert any(line.startswith("time-to-first-token: p50") for line in log_lines)


@pytest.mark.parametrize("extra, line", [
    (["--page-size", "8"], "paged KV: 0/"),
    (["--decode-steps", "4"], "fused decode:"),
    (["--page-size", "8", "--decode-steps", "3", "--kv-quantize", "none"], "fused decode:"),
    (["--prefill-chunk", "4"], "tok/s"),
])
def test_cli_variants_print_the_same_streams(capsys, log_lines, reference, extra, line):
    rc, streams = _run(capsys, *extra)
    assert rc == 0 and streams == reference
    assert any(line in msg for msg in log_lines), log_lines


def test_cli_prefix_cache_hits_and_stays_exact(capsys, log_lines):
    rc, streams = _run(capsys, "--prefix-cache", "4", "--system-prompt-len", "8",
                       "--page-size", "8")
    assert rc == 0 and streams == _engine_streams(system_len=8)
    hits = [m for m in log_lines if m.startswith("prefix cache:")]
    assert hits and int(hits[0].split()[2]) > 0, hits


def test_cli_int8_kv_matches_the_engine(capsys):
    rc, streams = _run(capsys, "--kv-quantize", "int8", "--page-size", "8")
    assert rc == 0 and streams == _engine_streams(kv_dtype="int8")


def test_cli_preempt_at_drains_and_exits_zero(capsys, log_lines, monkeypatch):
    monkeypatch.setenv("HIVED_FAULT_SERVE_PREEMPT_AT", "3")
    rc, streams = _run(capsys, "--page-size", "8", "--drain-deadline", "30")
    assert rc == 0
    report = [m for m in log_lines if m.startswith("preemption drain:")]
    assert report and "fully drained" in report[0], log_lines
    assert "rejected 3 " in report[0]  # 2 of 5 arrived by step 3
    assert len(streams) == 2


@pytest.mark.parametrize("flag", [
    ["--tp", "2"], ["--dp", "2"],
    # --tp/--dp are ported (tests/test_torch_sharded_serving.py), MoE, LoRA
    # and speculative serving on the mesh too: one process cannot lay a
    # mesh of two ranks, a usage error; the fleet does not compose with a
    # mesh, the JAX CLI's message
    ["--spec-decode", "--tp", "2"], ["--draft-layers", "1", "--dp", "2"],
    ["--n-experts", "4", "--tp", "2"], ["--lora-rank", "4", "--tp", "2"],
    ["--fleet", "2", "--tp", "2"],
])
def test_cli_refuses_unported_flags(capsys, flag):
    with pytest.raises(SystemExit) as exc:
        tserve.main(CLI + flag)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not yet ported" not in err
    if "--fleet" in flag:
        assert "--fleet does not compose with --tp/--dp" in err
    else:
        assert "1 devices not divisible by dp*tp=2" in err


def test_cli_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError) as err:
        tserve.main([a for a in CLI if a != "cpu"][:-1] + ["--device", "cuda"])
    assert "no CUDA device" in str(err.value)


def test_serve_preempt_fault_fires_once(monkeypatch):
    assert "HIVED_FAULT_SERVE_PREEMPT_AT" in envflags.REGISTRY
    monkeypatch.setenv(tsup.ENV_FAULT_SERVE_PREEMPT_AT, "2")
    faults = tsup.FaultInjection.from_env()
    assert [faults.take_serve_preempt(s) for s in range(5)] == [False, False, True, False, False]
    monkeypatch.delenv(tsup.ENV_FAULT_SERVE_PREEMPT_AT)
    assert not any(tsup.FaultInjection.from_env().take_serve_preempt(s) for s in range(5))


@pytest.mark.parametrize("extra, draft", [
    (["--spec-decode", "--decode-steps", "4"], (2, 4)),
    (["--draft-layers", "1", "--gamma", "2", "--page-size", "8", "--prefill-chunk", "4"],
     (1, 2)),
])
def test_cli_spec_decode_serves_the_speculative_engines_streams(capsys, log_lines, extra,
                                                                draft):
    rc, streams = _run(capsys, *extra)
    kw = {"page_size": 8, "prefill_chunk": 4} if "--page-size" in extra else {}
    assert rc == 0 and streams == _engine_streams(draft=draft, **kw)
    said = [m for m in log_lines if m.startswith("speculation: ")]
    assert said and "draft tokens accepted" in said[0], log_lines
    assert ("--decode-steps is ignored by the speculative engine" in " ".join(log_lines)) == (
        "--decode-steps" in extra)
    assert not any(m.startswith("fused decode:") for m in log_lines)


def test_cli_serves_a_lora_checkpoint_merged(capsys, log_lines, tmp_path):
    from hivedscheduler_tpu_torch import train as ttrain_cli

    ck = str(tmp_path / "lora")
    lora = ["--lora-rank", "4", "--lora-alpha", "8", "--lora-mlp"]
    train = [a for k, v in MODEL.items() for a in (f"--{k.replace('_', '-')}", str(v))] + [
        "--seq-len", "32", "--batch", "2", "--device", "cpu", "--steps", "2",
        "--checkpoint-dir", ck]
    assert ttrain_cli.main(train + lora) == 0
    rc, streams = _run(capsys, "--checkpoint-dir", ck, *lora, "--spec-decode")
    want = _engine_streams(checkpoint_dir=ck, draft=(2, 4),
                           lora=dict(lora_rank=4, lora_alpha=8.0, lora_mlp=True))
    assert rc == 0 and streams == want
    assert "merged rank-4 LoRA adapters into the base weights" in log_lines
    # the merge moved the weights (two steps move the streams of this
    # random model too little to see)
    cfg = ttm.TransformerConfig(max_seq_len=RUN["max_len"], **MODEL)
    merged, _ = tck.restore_serving_params(cfg, ck, torch.Generator().manual_seed(0),
                                           lora_rank=4, lora_alpha=8.0, lora_mlp=True)
    base, _ = tck.restore_serving_params(cfg, ck, torch.Generator().manual_seed(0))
    assert all(not torch.equal(merged["layers"][k], base["layers"][k])
               for k in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"))
