"""The port's observability modules (hivedscheduler_tpu_torch: the metrics
registry, obs.trace, obs.journal, obs.slo, obs.goodput's lane and counter,
common.lockcheck, the chaos checks and the supervisor's counters) against
the JAX package's, and the train CLI's ``--journal-file`` and
``--profile-dir``.

The same calls with explicit times go to both packages; the spool
records, the ``render()`` text, the Chrome events and the SLO snapshots
must be equal exactly (each is a pure function of those calls). Both
packages keep process-wide singletons, so every test starts and ends with
both journals, tracers and goodput ledgers disabled and cleared; the
registries are never cleared, so counts are read as differences.
"""

import json
import logging

import pytest
import torch

from hivedscheduler_tpu.chaos import invariants as jinv
from hivedscheduler_tpu.common import lockcheck as jlock
from hivedscheduler_tpu.obs import goodput as jgp
from hivedscheduler_tpu.obs import journal as jjournal
from hivedscheduler_tpu.obs import slo as jslo
from hivedscheduler_tpu.obs import trace as jtrace
from hivedscheduler_tpu.parallel import supervisor as jsup
from hivedscheduler_tpu.runtime import metrics as jmetrics
from hivedscheduler_tpu_torch import train as ttrain_cli
from hivedscheduler_tpu_torch.chaos import invariants as tinv
from hivedscheduler_tpu_torch.common import lockcheck as tlock
from hivedscheduler_tpu_torch.obs import goodput as tgp
from hivedscheduler_tpu_torch.obs import journal as tjournal
from hivedscheduler_tpu_torch.obs import slo as tslo
from hivedscheduler_tpu_torch.obs import trace as ttrace
from hivedscheduler_tpu_torch.parallel import supervisor as tsup
from hivedscheduler_tpu_torch.runtime import metrics as tmetrics

torch.set_num_threads(1)

PACKAGES = {"jax": (jjournal, jtrace, jgp), "port": (tjournal, ttrace, tgp)}


def _reset_obs():
    for journal, trace, goodput in PACKAGES.values():
        journal.disable()
        # a fresh journal: clear() keeps the request lanes' tid counter,
        # which an earlier test file in the same process may have moved
        journal.JOURNAL = journal.Journal()
        trace.disable()
        trace.TRACER.clear()
        goodput.GOODPUT.close()
        goodput.disable()
        goodput.GOODPUT.clear()


@pytest.fixture(autouse=True)
def _obs_isolation():
    _reset_obs()
    yield
    _reset_obs()


def counts(registry):
    """Counter values and histogram sample counts by (name, labels)."""
    with registry._lock:
        out = dict(registry._counters)
        out.update({(f"{n}_count", labels): c
                    for (n, labels), (_, _, c) in registry._histograms.items()})
    return out


def delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


# -- the metrics registry -----------------------------------------------------
def _registry_calls(reg):
    reg.inc("tpu_hive_serve_requests_total", priority="0")
    reg.inc("tpu_hive_serve_requests_total", priority="10")
    reg.inc("tpu_hive_serve_requests_total", 2.0, priority="0")
    reg.inc("tpu_hive_goodput_seconds_total", amount=0.125, phase="step_compute")
    reg.inc("tpu_hive_goodput_seconds_total", amount=1e7 + 0.5, phase="idle")
    reg.set_gauge("tpu_hive_serve_block_pool_occupancy", 0.375)
    reg.set_gauge("tpu_hive_slo_burn_rate", 2.0)
    for s in (0.0004, 0.001, 0.02, 0.7, 9.0):
        reg.observe("tpu_hive_serve_ttft_seconds", s, priority="0")
    reg.observe("tpu_hive_serve_ttft_seconds", 0.3, priority="10")
    reg.observe("tpu_hive_request_leg_seconds", 0.05, leg="prefill")
    reg.observe("tpu_hive_serve_spec_acceptance_ratio", 0.75)


def test_registry_renders_the_same_exposition():
    regs = {"jax": jmetrics.Registry(), "port": tmetrics.Registry()}
    regs["jax"]._help = dict(jmetrics.REGISTRY._help)
    regs["port"]._help = dict(tmetrics.REGISTRY._help)
    for reg in regs.values():
        _registry_calls(reg)
    text = regs["port"].render()
    assert text == regs["jax"].render()
    assert '# HELP tpu_hive_serve_ttft_seconds Serving time-to-first-token' in text
    assert 'tpu_hive_serve_ttft_seconds_bucket{priority="0",le="+Inf"} 5' in text
    assert "tpu_hive_goodput_seconds_total{phase=\"idle\"} 10000000.5" in text


def test_described_families_are_the_references():
    """Every family the port describes has the reference's help text, and
    every family the port emits is described."""
    port, ref = tmetrics.REGISTRY._help, jmetrics.REGISTRY._help
    assert {k: ref[k] for k in port} == port
    emitted = {
        "tpu_hive_serve_queue_wait_seconds", "tpu_hive_serve_ttft_seconds",
        "tpu_hive_serve_tpot_seconds", "tpu_hive_serve_requests_total",
        "tpu_hive_serve_shed_total", "tpu_hive_serve_drain_rejected_total",
        "tpu_hive_serve_fused_decode_windows_total",
        "tpu_hive_serve_block_pool_occupancy", "tpu_hive_serve_prefix_block_hits_total",
        "tpu_hive_serve_block_cow_total", "tpu_hive_serve_pool_preempted_total",
        "tpu_hive_serve_spec_acceptance_ratio", "tpu_hive_train_resumes_total",
        "tpu_hive_train_cross_topology_resumes_total", "tpu_hive_train_rollbacks_total",
        "tpu_hive_watchdog_stalls_total", "tpu_hive_gang_wait_seconds",
        "tpu_hive_request_leg_seconds", "tpu_hive_slo_violations_total",
        "tpu_hive_slo_ttft_p99_seconds", "tpu_hive_slo_burn_rate",
        "tpu_hive_goodput_seconds_total", "tpu_hive_fleet_requests_total",
        "tpu_hive_fleet_retries_total", "tpu_hive_fleet_handoffs_total",
        "tpu_hive_fleet_prefix_affinity_hits_total", "tpu_hive_fleet_replicas",
        "tpu_hive_fleet_target_replicas", "tpu_hive_fleet_scale_events_total"}
    assert set(port) == emitted


# -- the journal ----------------------------------------------------------------
def _journal_calls(journal):
    """One scripted history with explicit times: two request flights (one
    finished, one shed), a gang episode with a wait re-attributed, a
    duplicate bind (idempotent) and train events."""
    journal.note_request_submit("serve/0", at=1.0, priority=10, promptTokens=5)
    journal.emit("serve_submit", "serve/0", at=1.0, priority=10, promptTokens=5)
    journal.note_request_submit("serve/1", at=1.5, priority=0, promptTokens=3)
    journal.emit("serve_admit", "serve/0", at=2.0, slot=0, priority=10)
    journal.note_leg("serve/0", "admission_wait", at=2.0, slot=0)
    journal.note_leg("serve/0", "prefill", at=2.75)
    journal.note_request_done("serve/0", "length", first_token_at=2.75, at=4.0,
                              tokensOut=6)
    journal.note_phase("serve/0", "closed", "serve_finish", at=4.0,
                       finishReason="length", tokensOut=6)
    journal.note_request_done("serve/1", "shed", at=5.0, priority=0)
    journal.note_wait("g", "vc_quota", detail="quota", at=0.5)
    journal.note_wait("g", "vc_quota", at=0.75)  # same bucket: no event
    journal.note_wait("g", "fragmentation", at=1.25)
    journal.note_phase("g", "running", "bind", at=3.0)
    journal.note_phase("g", "running", "bind", at=3.5)  # idempotent repeat
    journal.note_phase("g", "closed", "released", at=6.0)
    journal.emit("train_resume", "train", at=7.0, step=2, crossTopology=False)
    with journal.suppress():
        journal.emit("train_rollback", "train", at=8.0, rollbacks=1)


def _both_journals(tmp_path):
    """Each package's singleton journal after the scripted history, spooled
    to its own file: {package: (spool lines, journal)}."""
    out = {}
    for name, (journal, _, _) in PACKAGES.items():
        spool = tmp_path / f"{name}.jsonl"
        journal.enable(spool_path=str(spool))
        _journal_calls(journal)
        journal.disable()
        out[name] = (spool.read_text().splitlines(), journal.JOURNAL)
    return out


def test_journal_spool_and_reads_match_jax(tmp_path):
    (jlines, jj), (tlines, tj) = _both_journals(tmp_path).values()
    assert tlines == jlines and len(tlines) == 13
    records = [json.loads(line) for line in tlines]
    assert all(r["ts"] == 0.0 for r in records)  # explicit times: virtual
    assert [e.to_dict() for e in tj.snapshot()] == [e.to_dict() for e in jj.snapshot()]
    assert tj.flights() == jj.flights()
    assert tj.requests() == jj.requests()
    for req in ("serve/0", "serve/1"):
        assert tj.request_timeline(req) == jj.request_timeline(req)
        assert tj.request_dominant_leg(req) == jj.request_dominant_leg(req)
    assert tj.chrome_events(0.25) == jj.chrome_events(0.25)
    fl = tj.flights()["serve/0"]
    assert [leg for leg, _, _ in fl["legs"]] == ["admission_wait", "prefill"]
    assert fl["ttft_gap"] == 0.0 and fl["terminals"] == 1
    assert tj.request_dominant_leg("serve/0") == "admission_wait"


def test_journal_metrics_match_jax(tmp_path):
    before = counts(tmetrics.REGISTRY), counts(jmetrics.REGISTRY)
    _both_journals(tmp_path)
    port = delta(before[0], counts(tmetrics.REGISTRY))
    assert port == delta(before[1], counts(jmetrics.REGISTRY))
    assert port[("tpu_hive_request_leg_seconds_count", (("leg", "prefill"),))] == 1
    assert port[("tpu_hive_gang_wait_seconds_count", (("reason", "fragmentation"),))] == 1


def test_journal_refuses_unregistered_names():
    tjournal.enable()
    for call in (lambda: tjournal.emit("not_a_type", "g"),
                 lambda: tjournal.note_wait("g", "not_a_bucket"),
                 lambda: tjournal.note_leg("r", "not_a_leg")):
        with pytest.raises(ValueError) as err:
            call()
        assert "is not a registered" in str(err.value)


def test_disabled_path_takes_no_lock_and_allocates_nothing():
    """Disabled, every emit path is one attribute check: it returns before
    ever touching the lock or the records."""
    j = tjournal.JOURNAL
    saved = j._lock
    j._lock = None  # any lock acquisition would raise AttributeError
    try:
        for _ in range(1000):
            assert tjournal.emit("bind", "g") is None
            assert tjournal.note_wait("g", "vc_quota") is None
            assert tjournal.note_phase("g", "running", "bind") is None
            assert tjournal.note_request_submit("serve/0") is None
            assert tjournal.note_leg("serve/0", "prefill") is None
            assert tjournal.note_request_done("serve/0", "length") is None
    finally:
        j._lock = saved
    assert len(j) == 0 and j.flights() == {}
    ttrace.instant("x")
    ttrace.complete("x", 0.0, 1.0)
    assert len(ttrace.TRACER) == 0


def test_rings_stay_bounded():
    j = tjournal.Journal(capacity=4096, metrics=False)
    j.enabled = True
    for i in range(20000):
        # each visit to a gang flips its bucket, so every call is an event
        j.note_wait(f"g{i % 64}", "vc_quota" if (i // 64) % 2 else "fragmentation",
                    at=float(i))
    assert len(j) == 4096 and j.evicted == 20000 - 4096
    tr = ttrace.Tracer(capacity=8)
    for i in range(20):
        tr.instant("x", at=float(i))
    assert len(tr) == 8 and tr.dropped == 12


# -- the tracer ------------------------------------------------------------------
def test_chrome_trace_matches_jax():
    """Spans, instants and the merged journal and goodput lanes: the same
    calls give the same Chrome trace in both packages."""
    traces = {}
    for name, (journal, trace, goodput) in PACKAGES.items():
        trace.enable()
        trace.TRACER._t0 = 100.0
        journal.enable()
        goodput.enable()
        goodput.GOODPUT.clear()
        goodput.GOODPUT.start(at=100.0)
        goodput.phase("step_compute", at=100.5)
        goodput.phase("idle", at=101.0)
        goodput.GOODPUT.close(at=102.0)
        trace.complete("train/step", 100.25, 100.75, cat="train", tid=7, step=1,
                       compile=True)
        trace.instant("request/done", cat="serving", tid=3, rid=4)
        trace.TRACER.complete("request/queued", 100.0, 100.5, cat="serving", tid=3,
                              args={"rid": 3})
        trace.TRACER.instant("request/done", cat="serving", tid=3, at=101.5,
                             args={"rid": 3})
        journal.note_request_submit("serve/3", at=100.0)
        journal.note_leg("serve/3", "admission_wait", at=100.5)
        journal.note_request_done("serve/3", "length", first_token_at=100.5, at=101.5)
        out = trace.to_chrome_trace()
        for ev in out["traceEvents"]:
            if ev["name"] == "request/done" and ev["args"] == {"rid": 4}:
                ev["ts"] = 0.0  # stamped now: the one time not given
        traces[name] = out
    assert traces["port"] == traces["jax"]
    names = [e["name"] for e in traces["port"]["traceEvents"]]
    assert {"train/step", "leg:admission_wait", "phase:step_compute",
            "phase:idle"} <= set(names)
    lanes = {e["args"]["name"] for e in traces["port"]["traceEvents"] if e["ph"] == "M"}
    assert {"tpu-hive", "request serve/3", "workload goodput"} <= lanes


def test_write_chrome_trace_and_resize(tmp_path):
    ttrace.enable()
    ttrace.complete("load", 1.0, 1.5, cat="serving", tid=2, rid=1)
    path = tmp_path / "t.json"
    ttrace.write_chrome_trace(str(path))
    obj = json.loads(path.read_text())
    assert obj["otherData"] == {"producer": "tpu-hive obs.trace", "dropped_events": 0}
    assert [e["name"] for e in obj["traceEvents"]] == ["process_name", "load"]
    old = ttrace.TRACER
    try:
        ttrace.enable(capacity=4)  # a fresh ring
        assert ttrace.TRACER is not old and len(ttrace.TRACER) == 1
    finally:
        ttrace.TRACER = old


# -- the SLO tracker ----------------------------------------------------------------
OBSERVATIONS = [("ttft", 0.2, 0, "prefill", 1.0), ("ttft", 0.9, 10, "admission_wait", 2.0),
                ("tpot", 0.01, 0, "", 2.5), ("ttft", 0.6, 0, "", 3.0),
                ("ttft", 0.4, 10, "prefill", 70.0), ("tpot", 0.05, 10, "prefill", 71.0)]


@pytest.mark.parametrize("window", [None, 0.0, 60.0])
def test_slo_snapshot_matches_jax(window):
    objectives = {
        name: mod.objectives_from_knobs(ttft_p99_s=0.5, tpot_p95_s=0.02,
                                        per_priority_ttft_p99={10: 0.3})
        for name, mod in (("jax", jslo), ("port", tslo))}
    before = counts(tmetrics.REGISTRY), counts(jmetrics.REGISTRY)
    snaps = {}
    for name, mod in (("jax", jslo), ("port", tslo)):
        tr = mod.SLOTracker(objectives=objectives[name], window_s=window,
                            clock=lambda: 0.0)
        for series, value, prio, leg, at in OBSERVATIONS:
            tr.observe(series, value, priority=prio, leg=leg, at=at)
        snaps[name] = (tr.snapshot(now=71.0), tr.snapshot(now=5.0),
                       tr.quantile(0.5, "ttft", now=71.0),
                       tr.burn_rate(objectives[name][0], now=71.0))
    assert snaps["port"] == snaps["jax"]
    assert [o["name"] for o in snaps["port"][0]["objectives"]] == [
        "ttft_p99", "tpot_p95", "ttft_p99/p10"]
    port = delta(before[0], counts(tmetrics.REGISTRY))
    assert port == delta(before[1], counts(jmetrics.REGISTRY))
    assert port[("tpu_hive_slo_violations_total",
                 (("leg", "admission_wait"), ("objective", "ttft_p99")))] == 1
    assert tmetrics.REGISTRY._gauges[("tpu_hive_slo_burn_rate", ())] == \
        jmetrics.REGISTRY._gauges[("tpu_hive_slo_burn_rate", ())]


def test_slo_window_default_and_objective_validation(monkeypatch):
    monkeypatch.setenv("HIVED_SLO_WINDOW_S", "12.5")
    assert tslo.default_window_s() == jslo.default_window_s() == 12.5
    assert tslo.SLOTracker(metrics=False).window_s == 12.5
    for kw in (dict(series="x", ceiling_s=1.0), dict(quantile=1.0, ceiling_s=1.0),
               dict(ceiling_s=0.0)):
        with pytest.raises(ValueError):
            tslo.SLObjective(**kw)
    assert tslo.objectives_from_knobs() == ()


# -- goodput: the lane, the counter and suppression -------------------------------
def test_goodput_lane_and_counter_match_jax():
    before = counts(tmetrics.REGISTRY), counts(jmetrics.REGISTRY)
    lanes = {}
    for name, mod in (("jax", jgp), ("port", tgp)):
        led = mod.GoodputLedger()
        led.enabled = True
        led.start(at=10.0)
        led.phase("data_wait", at=10.5)
        led.note_step(1, is_compile=True, at=10.75)
        led.note_step_done(1, at=12.0)
        led.note_step(2, at=12.0)
        led.note_step_done(2, at=12.25)
        led.close(at=13.0)
        lanes[name] = led.chrome_events(9.0)
    assert lanes["port"] == lanes["jax"]
    assert [e["name"] for e in lanes["port"]][:2] == ["thread_name", "phase:init"]
    port = delta(before[0], counts(tmetrics.REGISTRY))
    assert port == delta(before[1], counts(jmetrics.REGISTRY))
    assert port[("tpu_hive_goodput_seconds_total", (("phase", "compile"),))] == 1.25


def test_goodput_records_nothing_inside_suppress():
    led = tgp.GoodputLedger(metrics=False)
    led.enabled = True
    led.start(at=0.0)
    with tjournal.suppress():
        led.phase("eval", at=1.0)
        assert tjournal.suppressed()
    assert not tjournal.suppressed()
    assert led.current_phase() == "init"


# -- the chaos checks ----------------------------------------------------------------
def _check_both(calls):
    """Run ``calls`` on both packages' journals; each package's
    check_journal must agree (None = clean, else the error)."""
    results = []
    for journal, check, exc in ((jjournal, jinv.check_journal, jinv.InvariantViolation),
                                (tjournal, tinv.check_journal, tinv.InvariantViolation)):
        journal.enable()
        calls(journal)
        try:
            check()
            results.append(None)
        except exc as err:
            results.append(str(err))
        journal.disable()
        journal.JOURNAL.clear()
    assert results[0] == results[1]
    return results[1]


def test_check_journal_matches_jax():
    def clean(j):
        j.emit("serve_submit", "serve/0", at=0.0)
        j.emit("serve_finish", "serve/0", at=1.0)
        j.emit("serve_submit", "serve/0", at=2.0)
        j.emit("serve_finish", "serve/0", at=3.0)

    def duplicate(j):
        j.emit("serve_submit", "serve/0", at=0.0)
        j.emit("serve_finish", "serve/0", at=1.0)
        j.emit("serve_finish", "serve/0", at=2.0)

    def orphan(j):
        j.emit("serve_submit", "serve/0", at=0.0)
        j.emit("serve_admit", "serve/0", cause=1, at=0.5)
        j.emit("serve_finish", "serve/0", cause=5, at=1.0)

    def unopened(j):
        j.emit("released", "g", at=1.0)

    assert _check_both(clean) is None
    assert "duplicate terminal" in _check_both(duplicate)
    assert "non-backward cause" in _check_both(orphan)
    assert "no opening event" in _check_both(unopened)
    tinv.check_journal()  # disabled: a no-op


def test_check_goodput_catches_a_lost_interval():
    led = tgp.GoodputLedger(metrics=False)
    led.enabled = True
    led.start(at=0.0)
    led.phase("step_compute", at=1.0)
    tinv.check_goodput(led, at=2.0)
    led._acc["step_compute"] = 5.0  # an interval counted twice
    with pytest.raises(tinv.InvariantViolation) as err:
        tinv.check_goodput(led, at=2.0)
    assert "conservation broken" in str(err.value)
    led._acc = {"not_a_phase": 2.0}
    with pytest.raises(tinv.InvariantViolation) as err:
        tinv.check_goodput(led, at=2.0)
    assert "unregistered step phase" in str(err.value)


# -- lockcheck -----------------------------------------------------------------------
def test_lock_levels_are_the_references():
    assert {k: jlock.LOCK_HIERARCHY[k] for k in tlock.LOCK_HIERARCHY} == \
        tlock.LOCK_HIERARCHY


def test_lockcheck_raises_on_an_inverted_order(monkeypatch):
    monkeypatch.setenv("HIVED_LOCKCHECK", "1")
    outer = tlock.make_lock("metrics_lock")
    inner = tlock.make_lock("journal_lock")
    assert isinstance(outer, tlock.CheckedLock)
    with inner:
        with outer:  # journal (78) then metrics (80): legal
            assert outer.locked()
    with outer:
        with pytest.raises(tlock.LockOrderError) as err:
            inner.acquire()
    assert "lock-order violation" in str(err.value)
    with pytest.raises(tlock.LockOrderError):
        inner.release()
    # a singleton's late lock honours the flag per acquisition
    late = tlock.make_lock("trace_lock", late=True)
    with outer:
        with late:
            pass
    with late:
        with pytest.raises(tlock.LockOrderError):
            outer.acquire()
    monkeypatch.setenv("HIVED_LOCKCHECK", "0")
    assert not isinstance(tlock.make_lock("metrics_lock"), tlock.CheckedLock)
    with pytest.raises(tlock.LockOrderError):
        tlock.make_lock("unregistered", late=True)


# -- the supervisor's counters and events -----------------------------------------------
def test_supervisor_counts_stalls_and_rollbacks_like_jax(tmp_path):
    before = counts(tmetrics.REGISTRY), counts(jmetrics.REGISTRY)
    lines = {}
    for name, sup, journal in (("jax", jsup, jjournal), ("port", tsup, tjournal)):
        journal.enable(spool_path=str(tmp_path / f"{name}.jsonl"))
        fired = []
        dog = sup.Watchdog(deadline_s=1.0, on_stall=fired.append)
        dog._fire(3, 2.0, 1.0)
        assert fired and fired[0]["last_step"] == 3
        s = sup.Supervisor(max_rollbacks=1)
        assert s.note_rollback() is True
        assert s.note_rollback() is False
        journal.disable()
        lines[name] = [{k: v for k, v in json.loads(x).items() if k not in ("t", "ts")}
                       for x in (tmp_path / f"{name}.jsonl").read_text().splitlines()]
    assert lines["port"] == lines["jax"]
    assert [r["args"] for r in lines["port"]] == [{"rollbacks": 1}, {"rollbacks": 2}]
    port = delta(before[0], counts(tmetrics.REGISTRY))
    assert port == delta(before[1], counts(jmetrics.REGISTRY))
    assert port == {("tpu_hive_watchdog_stalls_total", ()): 1,
                    ("tpu_hive_train_rollbacks_total", ()): 2}


# -- the train CLI -------------------------------------------------------------------------
CLI_MODEL = ["--vocab-size", "96", "--d-model", "64", "--n-layers", "2",
             "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "128",
             "--seq-len", "64", "--batch", "8"]
PORT_ONLY = ["--device", "cpu", "--attn", "flash", "--remat", "dots", "--block-q", "64",
             "--block-k", "64"]


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture
def logs_on():
    """The train CLI's log messages. Another test file in this process may
    have disabled logging (bench.py does, at import): lift that meanwhile."""
    disabled = logging.root.manager.disable
    logging.disable(logging.NOTSET)
    handler = _Messages()
    logger = logging.getLogger(ttrain_cli.__name__)
    logger.addHandler(handler)
    yield handler.lines
    logger.removeHandler(handler)
    logging.disable(disabled)


def _resume_events(cli, tmp_path, name, extra=()):
    """Two incarnations of ``cli`` (2 steps, then 4) over one checkpoint
    directory and one journal spool -> the spool's records, without times."""
    ck, spool = tmp_path / f"{name}-ck", tmp_path / f"{name}.jsonl"
    args = CLI_MODEL + list(extra) + ["--checkpoint-dir", str(ck), "--checkpoint-every",
                                      "2", "--journal-file", str(spool)]
    before = counts(tmetrics.REGISTRY if cli is ttrain_cli else jmetrics.REGISTRY)
    for steps in ("2", "4"):
        assert cli.main(args + ["--steps", steps]) == 0
    after = counts(tmetrics.REGISTRY if cli is ttrain_cli else jmetrics.REGISTRY)
    records = [{k: v for k, v in json.loads(x).items() if k not in ("t", "ts")}
               for x in spool.read_text().splitlines()]
    return records, delta(before, after)


def test_train_journal_file_records_the_resume_like_jax(tmp_path, logs_on):
    from hivedscheduler_tpu import train as jtrain_cli

    ref, ref_counts = _resume_events(jtrain_cli, tmp_path, "jax")
    _reset_obs()
    out, out_counts = _resume_events(ttrain_cli, tmp_path, "port", PORT_ONLY)
    assert out == ref == [{"id": 1, "gang": "train", "type": "train_resume",
                           "cause": None, "bucket": "", "detail": "",
                           "args": {"step": 2, "crossTopology": False}}]
    assert out_counts[("tpu_hive_train_resumes_total", ())] == 1
    assert ref_counts[("tpu_hive_train_resumes_total", ())] == 1
    assert ("tpu_hive_train_cross_topology_resumes_total", ()) not in out_counts


def _trace_file(path):
    files = list(path.glob("rank0.*.pt.trace.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())["traceEvents"]


def test_train_profile_dir_traces_steps_two_to_four(tmp_path, logs_on):
    prof = tmp_path / "prof"
    timeline = tmp_path / "timeline.jsonl"
    ttrace.enable()
    assert ttrain_cli.main(CLI_MODEL + PORT_ONLY + [
        "--steps", "5", "--profile-dir", str(prof), "--timeline", str(timeline)]) == 0
    ranges = sorted(e["name"] for e in _trace_file(prof)
                    if e.get("cat") == "user_annotation" and e["name"].startswith("train/"))
    assert ranges == ["train/step 2", "train/step 3", "train/step 4"]
    # --timeline: one train/step span a step on the tracer
    spans = [e for e in ttrace.TRACER.snapshot() if e["name"] == "train/step"]
    assert [e["args"]["step"] for e in spans] == [1, 2, 3, 4, 5]
    assert [e["args"]["compile"] for e in spans] == [True] + [False] * 4


def test_train_profile_dir_stops_after_the_loop_and_warns(tmp_path, logs_on):
    prof = tmp_path / "prof"
    assert ttrain_cli.main(CLI_MODEL + PORT_ONLY + [
        "--steps", "1", "--profile-dir", str(prof)]) == 0
    assert any("--profile-dir needs at least 2 steps" in m for m in logs_on)
    assert not prof.exists()
    assert ttrain_cli.main(CLI_MODEL + PORT_ONLY + [
        "--steps", "3", "--profile-dir", str(prof)]) == 0
    ranges = sorted(e["name"] for e in _trace_file(prof)
                    if e.get("cat") == "user_annotation" and e["name"].startswith("train/"))
    assert ranges == ["train/step 2", "train/step 3"]


def test_profile_check_refuses_a_trace_without_kernels(tmp_path):
    """On the card a trace without a CUDA kernel event is an error: a
    profile recorded without CUDA activity (here, the CPU's) fails it."""
    prof = ttrain_cli.start_profile(str(tmp_path), 0, torch.device("cpu"))
    torch.ones(8) * 2
    ttrain_cli.stop_profile(prof, torch.device("cpu"))  # the CPU: no check
    assert ttrain_cli.kernel_events(prof) == 0

    class Card:
        type = "cuda"

    prof = ttrain_cli.start_profile(str(tmp_path), 0, torch.device("cpu"))
    torch.ones(8) * 2
    sync = torch.cuda.synchronize
    torch.cuda.synchronize = lambda *a: None
    try:
        with pytest.raises(RuntimeError) as err:
            ttrain_cli.stop_profile(prof, Card())
    finally:
        torch.cuda.synchronize = sync
    assert "no CUDA kernel event" in str(err.value)
