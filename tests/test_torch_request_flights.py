"""The port's serving engine under observation (metrics, request flights,
spans) against the JAX package's on the same weights, carried across by
hivedscheduler_tpu_torch.bridge, and the serve CLI's observability flags.

Both engines serve one plan (arrival step, prompt, budget, priority) on one
injected clock that the test loop sets before each submit and each step: two
priorities, a queue-wait deadline that sheds, a paged pool small enough
that decode growth preempts streams and that shared prefix blocks are
copied on write, and prefix hits. Required exactly: every counter's value
and label set, each histogram's sample count, the pool gauge, and each
request's leg sequence, terminal and finish reason. Times are held to the
flight invariants: the legs tile each request's TTFT with zero gap (each
leg starts where the previous ended, the first at submit), one terminal a
request, and each request's spans ordered queued <= prefill <= decode.
The same once with speculative serving (a weak draft, gamma 3).
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import serving as jsrv
from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu.obs import journal as jjournal
from hivedscheduler_tpu.obs import trace as jtrace
from hivedscheduler_tpu.runtime import metrics as jmetrics
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch import serve as tserve
from hivedscheduler_tpu_torch.chaos import invariants as tinv
from hivedscheduler_tpu_torch.models import serving as tsrv
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.obs import journal as tjournal
from hivedscheduler_tpu_torch.obs import trace as ttrace
from hivedscheduler_tpu_torch.runtime import metrics as tmetrics

torch.set_num_threads(1)

MODEL = dict(vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
             d_ff=128, max_seq_len=128)
DRAFT = dict(MODEL, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64)
SYSTEM = [7, 11, 23, 42, 5, 9, 81, 2, 64, 33]
# (arrival step, prompt, budget, priority)
PLAN = [(0, SYSTEM + [100, 101], 4, 0), (1, SYSTEM + [120, 90, 3], 16, 10),
        (1, [9] * 10, 18, 10), (3, [4, 4], 3, 0), (4, SYSTEM + [100, 101, 55], 4, 10)]
ENGINE = dict(max_batch=2, max_len=32, page_size=4, num_blocks=9, prefix_cache_size=4,
              queue_timeout_s=3.0)
SPEC_PLAN = [(0, SYSTEM + [100, 101], 3, 0), (0, [9] * 6, 12, 10), (1, [4, 4], 3, 0),
             (4, SYSTEM + [120, 90, 3], 5, 10), (5, [5, 17, 3], 7, 0)]
SPEC_ENGINE = dict(max_batch=2, max_len=40, page_size=4, prefix_cache_size=4,
                   queue_timeout_s=2.0, gamma=3)


def _reset():
    for journal, trace in ((jjournal, jtrace), (tjournal, ttrace)):
        journal.disable()
        journal.JOURNAL.clear()
        trace.disable()
        trace.TRACER.clear()


@pytest.fixture(autouse=True)
def _obs_isolation():
    _reset()
    yield
    _reset()


@pytest.fixture(scope="module")
def models():
    """{package: (cfg, params, draft cfg, draft params)}, f32."""
    target = jax.device_get(jtm.init_params(jtm.TransformerConfig(dtype=jnp.float32, **MODEL),
                                            jax.random.PRNGKey(0)))
    draft = jax.device_get(jtm.init_params(jtm.TransformerConfig(dtype=jnp.float32, **DRAFT),
                                           jax.random.PRNGKey(7)))
    return {
        "jax": (jtm.TransformerConfig(dtype=jnp.float32, **MODEL),
                jax.tree.map(jnp.asarray, target),
                jtm.TransformerConfig(dtype=jnp.float32, **DRAFT),
                jax.tree.map(jnp.asarray, draft)),
        "port": (ttm.TransformerConfig(dtype=torch.float32, **MODEL),
                 bridge.from_numpy_tree(target),
                 ttm.TransformerConfig(dtype=torch.float32, **DRAFT),
                 bridge.from_numpy_tree(draft)),
    }


class Clock:
    t = 0.0

    def __call__(self):
        return self.t


def registry_state(registry):
    """Counter values and histogram sample counts by (name, labels)."""
    with registry._lock:
        out = {("counter",) + k: v for k, v in registry._counters.items()}
        out.update({("count",) + k: c for k, (_, _, c) in registry._histograms.items()})
    return out


def changed(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k)}


POOL_GAUGE = ("tpu_hive_serve_block_pool_occupancy", ())


def serve(package, models, plan, spec=False, **kw):
    """Serve ``plan`` through ``package``'s engine with the journal (request
    flights on) and the tracer enabled -> (requests, engine, what the
    run changed in the registry's counters and histogram counts, the pool
    gauge after the run, the journal's flights). The gauges are reset, so
    a value left by an earlier test cannot pass for this run's."""
    cfg, params, dcfg, dparams = models[package]
    mod, journal, trace, registry = {
        "jax": (jsrv, jjournal, jtrace, jmetrics.REGISTRY),
        "port": (tsrv, tjournal, ttrace, tmetrics.REGISTRY)}[package]
    journal.enable()
    trace.enable()
    clock = Clock()
    registry._gauges.pop(POOL_GAUGE, None)
    before = registry_state(registry)
    if spec:
        eng = mod.SpeculativeServingEngine(params, cfg, dparams, dcfg, clock=clock, **kw)
    else:
        eng = mod.ServingEngine(params, cfg, clock=clock, **kw)
    eng.record_flights = True
    pending, reqs, step = sorted(plan, key=lambda p: p[0]), [], 0
    while pending or any(not r.done for r in reqs):
        clock.t = float(step)
        while pending and pending[0][0] <= step:
            _, prompt, budget, prio = pending.pop(0)
            reqs.append(eng.submit(prompt, budget, priority=prio))
        clock.t = step + 0.5
        eng.step()
        step += 1
        assert step < 300
    flights = journal.JOURNAL.flights()
    metrics = changed(before, registry_state(registry))
    metrics["pool gauge"] = registry._gauges.get(POOL_GAUGE)
    return reqs, eng, metrics, flights


def assert_flight_invariants(reqs, flights):
    """Each request: one terminal naming its finish reason; legs that start
    at submit, are contiguous, and tile the TTFT with zero gap."""
    for r in reqs:
        fl = flights[f"serve/{r.rid}"]
        assert fl["terminals"] == 1 and fl["terminal"] == r.finish_reason
        assert fl["t0"] == r.submitted_at
        mark = fl["t0"]
        for _leg, start, end in fl["legs"]:
            assert start == mark and end >= start
            mark = end
        if r.first_token_at is not None:
            assert fl["ttft_gap"] == 0.0
            ttft_legs = sum(e - s for _, s, e in fl["legs"] if e <= r.first_token_at)
            assert ttft_legs == pytest.approx(r.ttft_s, abs=1e-12)


def assert_span_order(reqs):
    """Each finished request's spans on its lane: queued <= prefill <=
    decode, and one done instant; a shed request never ran and has none."""
    events = ttrace.TRACER.snapshot()
    for r in reqs:
        lane = {e["name"]: e for e in events if e.get("tid") == r.rid
                and e.get("cat") == "serving"}
        if r.finish_reason == "shed":
            assert not lane
            continue
        assert "request/done" in lane
        if r.first_token_at is None:
            continue
        queued, prefill, decode = (lane[f"request/{n}"] for n in ("queued", "prefill",
                                                                  "decode"))
        assert queued["ts"] <= prefill["ts"] <= decode["ts"]
        assert queued["ts"] + queued["dur"] == pytest.approx(prefill["ts"])
        assert prefill["ts"] + prefill["dur"] == pytest.approx(decode["ts"])


def compare(models, plan, spec=False, **kw):
    ref_reqs, ref_eng, ref_metrics, ref_flights = serve("jax", models, plan, spec, **kw)
    reqs, eng, metrics, flights = serve("port", models, plan, spec, **kw)
    assert [(r.tokens_out, r.finish_reason) for r in reqs] == \
        [(r.tokens_out, r.finish_reason) for r in ref_reqs]
    assert metrics == ref_metrics
    legs = {k: ([leg for leg, _, _ in f["legs"]], f["terminal"], f["terminals"])
            for k, f in flights.items()}
    assert legs == {k: ([leg for leg, _, _ in f["legs"]], f["terminal"], f["terminals"])
                    for k, f in ref_flights.items()}
    assert_flight_invariants(reqs, flights)
    assert_span_order(reqs)
    tinv.check_block_pool(eng)
    return reqs, eng, metrics


def test_plain_engine_metrics_and_flights_match_jax(models):
    reqs, eng, metrics = compare(models, PLAN, **ENGINE)
    reasons = [r.finish_reason for r in reqs]
    # the plan exercises what it is meant to
    assert {"length", "preempted", "shed"} <= set(reasons)
    assert eng.pool_preempted >= 1 and eng.blocks_cow >= 1 and eng.prefix_block_hits >= 1
    assert metrics[("counter", "tpu_hive_serve_pool_preempted_total", ())] == eng.pool_preempted
    assert metrics[("counter", "tpu_hive_serve_block_cow_total", ())] == eng.blocks_cow
    assert metrics[("counter", "tpu_hive_serve_prefix_block_hits_total", ())] == \
        eng.prefix_block_hits
    assert metrics[("counter", "tpu_hive_serve_shed_total", (("priority", "0"),))] == \
        reasons.count("shed")
    finished = sum(metrics.get(("counter", "tpu_hive_serve_requests_total",
                                (("priority", p),)), 0) for p in ("0", "10"))
    assert finished == len(reqs) - reasons.count("shed")
    assert metrics["pool gauge"] == eng.blocks_in_use / (eng.num_blocks - 1)


def test_fused_windows_count_once_a_window(models):
    """decode_steps 4: one fused-window count for each window the engine
    ran, as in JAX."""
    plan = [(0, [5, 9, 2], 12, 0), (0, [17, 3, 88, 41, 7], 9, 10), (6, [1, 2], 6, 0)]
    reqs, eng, metrics = compare(models, plan, max_batch=2, max_len=32, decode_steps=4)
    assert eng.fused_windows > 0
    assert metrics[("counter", "tpu_hive_serve_fused_decode_windows_total", ())] == \
        eng.fused_windows


def test_speculative_engine_metrics_and_flights_match_jax(models):
    reqs, eng, metrics = compare(models, SPEC_PLAN, spec=True, **SPEC_ENGINE)
    assert eng.drafted > 0 and eng.prefix_block_hits >= 1
    assert "shed" in [r.finish_reason for r in reqs]
    rounds = metrics[("count", "tpu_hive_serve_spec_acceptance_ratio", ())]
    assert rounds * SPEC_ENGINE["gamma"] == eng.drafted


def test_drain_preempts_with_one_terminal_and_rejects(models):
    """A drain deadline truncates the in-flight flights to one
    ``preempted`` terminal; a submit while draining is counted."""
    cfg, params = models["port"][:2]
    before = registry_state(tmetrics.REGISTRY)
    tjournal.enable()
    eng = tsrv.ServingEngine(params, cfg, max_batch=2, max_len=32)
    eng.record_flights = True
    busy = [eng.submit([5, 9, 2], 20), eng.submit([7], 20), eng.submit([8, 8], 20)]
    eng.step()
    assert eng.drain(deadline_s=0.0) is False
    with pytest.raises(tsrv.EngineDraining):
        eng.submit([1, 2], 2)
    flights = tjournal.JOURNAL.flights()
    for r in busy:
        fl = flights[f"serve/{r.rid}"]
        assert r.finish_reason == "preempted"
        assert fl["terminal"] == "preempted" and fl["terminals"] == 1
    after = changed(before, registry_state(tmetrics.REGISTRY))
    assert after[("counter", "tpu_hive_serve_drain_rejected_total", ())] == 1
    tinv.check_journal()


def test_a_dropped_leg_and_a_second_terminal_are_caught():
    """The checks see the planted faults: a flight whose prefill leg was
    never noted has a TTFT gap, and a second terminal is counted and
    breaks the journal's lifecycle check."""
    tjournal.enable()
    tjournal.note_request_submit("serve/0", at=0.0)
    tjournal.note_leg("serve/0", "admission_wait", at=1.0)
    tjournal.note_request_done("serve/0", "length", first_token_at=2.5, at=4.0)
    assert tjournal.JOURNAL.flights()["serve/0"]["ttft_gap"] == -1.5
    tjournal.emit("serve_submit", "serve/1", at=0.0)
    tjournal.emit("serve_finish", "serve/1", at=1.0)
    tjournal.emit("serve_finish", "serve/1", at=1.0)
    tjournal.note_request_done("serve/1", "length", at=1.0)
    tjournal.note_request_done("serve/1", "length", at=1.0)
    assert tjournal.JOURNAL.flights()["serve/1"]["terminals"] == 2
    with pytest.raises(tinv.InvariantViolation) as err:
        tinv.check_journal()
    assert "duplicate terminal" in str(err.value)


# -- the serve CLI ------------------------------------------------------------------
CLI = ["--vocab-size", "64", "--d-model", "32", "--n-heads", "4", "--n-layers", "2",
       "--d-ff", "64", "--requests", "4", "--max-batch", "2", "--max-len", "64",
       "--max-new-tokens", "4", "--high-priority-every", "2", "--device", "cpu"]


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture
def log_lines():
    disabled = logging.root.manager.disable
    logging.disable(logging.NOTSET)
    handler = _Messages()
    logger = logging.getLogger(tserve.__name__)
    logger.addHandler(handler)
    yield handler.lines
    logger.removeHandler(handler)
    logging.disable(disabled)


def _streams(capsys):
    return [line for line in capsys.readouterr().out.splitlines() if line.startswith("[")]


def validate_chrome_trace(obj):
    """``obj`` is a Chrome trace Perfetto loads: a traceEvents array of
    events with name, ph, numeric ts, int pid and tid, and a non-negative
    dur on complete events. Returns the events."""
    assert isinstance(obj, dict) and isinstance(obj.get("traceEvents"), list)
    for ev in obj["traceEvents"]:
        assert isinstance(ev.get("name"), str) and ev["name"]
        assert isinstance(ev.get("ph"), str) and ev["ph"]
        assert isinstance(ev.get("ts"), (int, float))
        assert isinstance(ev.get("pid"), int) and isinstance(ev.get("tid"), int)
        if ev["ph"] == "X":
            assert isinstance(ev.get("dur"), (int, float)) and ev["dur"] >= 0
        if "args" in ev:
            assert isinstance(ev["args"], dict)
    return obj["traceEvents"]


def test_serve_metrics_dump_writes_exposition_and_trace(tmp_path, capsys):
    dump = tmp_path / "metrics.txt"
    assert tserve.main(CLI + ["--metrics-dump", str(dump)]) == 0
    text = dump.read_text()
    assert '# TYPE tpu_hive_serve_ttft_seconds histogram' in text
    assert 'tpu_hive_serve_ttft_seconds_bucket{priority="0",le=' in text
    assert 'tpu_hive_serve_ttft_seconds_bucket{priority="10",le=' in text
    assert 'tpu_hive_serve_queue_wait_seconds_count{priority="0"}' in text
    assert 'tpu_hive_serve_requests_total{priority="0"}' in text
    events = validate_chrome_trace(json.loads((tmp_path / "metrics.txt.trace.json").read_text()))
    names = [e["name"] for e in events]
    assert names.count("request/decode") == 4  # one lane per request
    assert "request/queued" in names and "request/prefill" in names
    decode = next(e for e in events if e["name"] == "request/decode")
    assert {"rid", "priority", "prompt_tokens", "new_tokens"} <= set(decode["args"])


def test_serve_journal_file_spools_one_flight_a_request(tmp_path, capsys):
    spool = tmp_path / "journal.jsonl"
    assert tserve.main(CLI + ["--journal-file", str(spool)]) == 0
    streams = _streams(capsys)
    records = [json.loads(line) for line in spool.read_text().splitlines()]
    done = [r for r in records if r["type"] == "request_done"]
    assert sorted(r["gang"] for r in done) == [f"serve/{i}" for i in range(4)]
    assert all(r["args"]["ttftGapS"] == 0.0 for r in done)
    legs = [r["bucket"] for r in records if r["type"] == "request_leg"]
    assert legs.count("admission_wait") == legs.count("prefill") == 4
    _reset()
    assert tserve.main(CLI) == 0  # the flags change no token
    assert _streams(capsys) == streams


def test_serve_slo_ttft_p99_logs_the_objective(tmp_path, capsys, log_lines):
    assert tserve.main(CLI + ["--slo-ttft-p99", "0.000001", "--journal-file",
                              str(tmp_path / "journal.jsonl")]) == 0
    slo = [m for m in log_lines if m.startswith("slo")]
    assert slo[0].startswith("slo: ttft p50") and "over 4 requests (window 60.0s)" in slo[0]
    objective = [m for m in slo if m.startswith("slo objective ttft_p99: ceiling 0 ms")]
    # every request breaks a 1 us ceiling; each is attributed to a leg
    assert objective and "compliance 0.0000" in objective[0]
    assert "burn rate 100.00" in objective[0] and "prefill" in objective[0]


def test_serve_slo_window_s_sets_the_window(capsys, log_lines):
    assert tserve.main(CLI + ["--slo-window-s", "0"]) == 0
    slo = [m for m in log_lines if m.startswith("slo")]
    assert len(slo) == 1 and "(window 0.0s)" in slo[0]  # no objective declared


def test_serve_cli_parses_slo_flags(capsys):
    with pytest.raises(SystemExit) as exc:
        tserve.main(["--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "--slo-ttft-p99" in out and "--slo-window-s" in out


def test_serve_slo_lines_match_jax(models, log_lines):
    """The same snapshot logs the same lines in both CLIs."""
    from hivedscheduler_tpu import serve as jserve
    from hivedscheduler_tpu.obs import slo as jslo
    from hivedscheduler_tpu_torch.obs import slo as tslo

    out = {}
    for name, cli, slo in (("jax", jserve, jslo), ("port", tserve, tslo)):
        tr = slo.SLOTracker(slo.objectives_from_knobs(ttft_p99_s=0.5), window_s=0,
                            metrics=False)
        for i, v in enumerate(np.linspace(0.1, 0.9, 7)):
            tr.observe("ttft", float(v), leg="prefill" if i % 2 else "", at=float(i))
        handler = _Messages()
        logger = logging.getLogger(cli.__name__)
        logger.addHandler(handler)
        try:
            cli._log_slo(tr)
        finally:
            logger.removeHandler(handler)
        out[name] = handler.lines
    assert out["port"] == out["jax"] and len(out["port"]) == 2
