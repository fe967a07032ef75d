"""Workload goodput ledger: step-phase badput attribution with a
wallclock conservation invariant.

A copy of ``hivedscheduler_tpu/obs/goodput.py`` for the port. At any
instant the workload process is in exactly one phase of
:data:`STEP_PHASES`; transitions close intervals into per-phase second
accumulators, so that

    sum over STEP_PHASES seconds  ==  process wallclock since start()

holds by construction. ``rework`` is classified exactly across
incarnations: the high-water mark of completed steps is replayed from the
shared ``--goodput-file`` spool, and a step at or below it is work paid for
twice. The spool's JSONL records (``start``, ``phase``, ``step``,
``summary``) are the interface to the cluster's capacity ledger and are
record for record the JAX package's, so its ``check_spool`` and
``aggregate_spool`` read a spool the port wrote.

Served as ``tpu_hive_goodput_seconds_total{phase=}`` counters, the
``--goodput-file`` spool, and a ``workload goodput`` Perfetto lane merged
into every ``trace.to_chrome_trace()`` export. A thread inside the
journal's ``suppress()`` records nothing here either.

Disabled by default, at the cost of one attribute load per call. Enable
with ``goodput.enable(spool_path=...)``, the CLIs' ``--goodput-file``, or
``HIVED_GOODPUT=1`` in the environment.
"""

from __future__ import annotations

import atexit
import json
import os
import time
from typing import Any, Dict, IO, List, Optional, Tuple

from hivedscheduler_tpu_torch.common import envflags, lockcheck
from hivedscheduler_tpu_torch.obs import journal as _journal

# ---------------------------------------------------------------------------
# step-phase taxonomy. At any instant the workload process is in exactly
# ONE of these; transitions close intervals, and the per-phase seconds
# sum to the process wallclock (the conservation invariant). The keys are
# the JAX package's; the runtime raises on unregistered phases.
# ---------------------------------------------------------------------------
STEP_PHASES: Dict[str, str] = {
    "init": "process bring-up: imports, mesh/model construction, "
            "supervisor wiring — everything before the first phase "
            "transition",
    "compile": "an incarnation's first step: on the card the kernels' "
               "build when it is cold and the first launches (train.py's "
               "compile detection; the watchdog keys off the second "
               "heartbeat for the same reason)",
    "step_compute": "forward/backward/optimizer work advancing the run "
                    "past its previous high-water mark — the ONE "
                    "goodput phase; everything else is badput",
    "data_wait": "the step loop blocked on the prefetch consumer "
                 "(next(batches) on data.CheckpointableBatches)",
    "checkpoint_save": "checkpoint.save (periodic commits and the "
                       "supervisor's SIGTERM checkpoint-and-exit path)",
    "checkpoint_restore": "checkpoint.restore/restore_params (resume, "
                          "divergence rollback, warm start, eval's "
                          "weight load)",
    "rework": "re-training steps between a resume point (the committed "
              "LoaderState position) and the previously-reached max "
              "step — work paid for twice",
    "eval": "held-out evaluation windows (eval.py)",
    "drain": "a ServingEngine finishing admitted work while refusing "
             "new (elastic preemption handshake)",
    "idle": "enabled but no work in flight (post-loop wrap-up, an "
            "empty serving loop)",
}

# the one phase that counts toward goodput_fraction's numerator
GOODPUT_PHASES = ("step_compute",)

_MAX_LANE_SPANS = 2048
# Perfetto tid for the phase lane; journal lanes start at 1000
_LANE_TID = 30000


class GoodputLedger:
    """Per-process phase state machine + phase-second accumulators.

    Instantiable for tests; the module singleton :data:`GOODPUT` is what
    the live stack shares. ``metrics`` gates counter emission so a test
    instance never pollutes the process registry.
    """

    def __init__(self, metrics: bool = True):
        self._lock = lockcheck.make_lock("goodput_lock", late=True)
        self.enabled = False
        self.metrics = metrics
        self._t0: Optional[float] = None
        self._phase: Optional[str] = None
        self._since: float = 0.0
        self._acc: Dict[str, float] = {}
        self._lane: List[Tuple[str, float, float]] = []
        self._steps = 0
        self._rework_steps = 0
        self._max_step = 0  # high-water mark: largest step ever completed
        self._spool: Optional[IO[str]] = None
        self._spool_path = ""
        self._closed = False

    # -- internals --------------------------------------------------------
    @staticmethod
    def _now(at: Optional[float]) -> float:
        return time.perf_counter() if at is None else at

    @staticmethod
    def _check_phase(phase: str) -> None:
        if phase not in STEP_PHASES:
            raise ValueError(
                f"{phase!r} is not a registered step phase — add it to "
                f"obs/goodput.py STEP_PHASES")

    def _emit(self, rec: Dict[str, Any]) -> None:
        """Append one JSONL record (caller holds the lock). Flushed per
        line so a kill -9 incarnation keeps every closed interval; a
        dead spool must never fail a transition."""
        spool = self._spool
        if spool is None:
            return
        try:
            spool.write(json.dumps(rec) + "\n")
            spool.flush()
        except Exception:
            self._spool = None

    def _close_interval(self, at: float) -> None:
        """Close the open phase interval into the accumulator (caller
        holds the lock)."""
        phase = self._phase
        if phase is None:
            return
        dur = at - self._since
        if dur < 0:
            dur = 0.0
        self._acc[phase] = self._acc.get(phase, 0.0) + dur
        if len(self._lane) < _MAX_LANE_SPANS:
            self._lane.append((phase, self._since, at))
        self._emit({"kind": "phase", "pid": os.getpid(), "phase": phase,
                    "start": self._since, "end": at})
        if self.metrics and dur > 0:
            from hivedscheduler_tpu_torch.runtime.metrics import REGISTRY
            REGISTRY.inc("tpu_hive_goodput_seconds_total", amount=dur,
                         phase=phase)
        self._since = at

    # -- mutators (the instrumentation surface) ---------------------------
    def start(self, phase: str = "init", at: Optional[float] = None) -> None:
        """Anchor the process wallclock and open the first phase.
        Idempotent — the first call wins (conservation is measured from
        it)."""
        if not self.enabled or _journal.suppressed():
            return
        self._check_phase(phase)
        t = self._now(at)
        with self._lock:
            if self._t0 is not None:
                return
            self._t0 = t
            self._phase = phase
            self._since = t
            self._emit({"kind": "start", "pid": os.getpid(), "t0": t,
                        "phase": phase})

    def phase(self, phase: str, at: Optional[float] = None) -> None:
        """Transition into ``phase`` (closing the open interval). Same
        phase is a no-op — the interval just continues."""
        if not self.enabled or _journal.suppressed():
            return
        self._check_phase(phase)
        t = self._now(at)
        with self._lock:
            if self._t0 is None:
                self._t0 = t
                self._phase = phase
                self._since = t
                self._emit({"kind": "start", "pid": os.getpid(), "t0": t,
                            "phase": phase})
                return
            if self._closed or self._phase == phase:
                return
            self._close_interval(t)
            self._phase = phase

    def span(self, phase: str, at: Optional[float] = None) -> "_PhaseSpan":
        """``with goodput.span("checkpoint_save"): ...`` — enter the
        phase, restore the surrounding phase on exit. A shared no-op
        when disabled."""
        if not self.enabled or _journal.suppressed():
            return _NOOP_SPAN
        self._check_phase(phase)
        with self._lock:
            prev = self._phase
        self.phase(phase, at=at)
        return _PhaseSpan(self, prev)

    def seed_max_step(self, step: int) -> None:
        """Carry the high-water mark across incarnations (replayed from
        the shared spool's per-step records at enable time, or seeded by
        a harness). Steps at or below it classify as rework."""
        if not self.enabled:
            return
        with self._lock:
            if step > self._max_step:
                self._max_step = step

    def note_step(self, step: int, is_compile: bool = False,
                  at: Optional[float] = None) -> None:
        """The step loop is starting compute for ``step`` (1-based, the
        step number it will commit). Classifies the phase: ``rework`` iff
        ``step <= max_step_ever_completed`` — with precedence over
        ``compile``, because a resumed incarnation's recompile only exists
        to re-reach the old high-water mark, so ALL wallclock until then
        is fault-caused badput — then ``compile`` for the incarnation's
        first step (XLA trace+compile dominates), else ``step_compute``."""
        if not self.enabled or _journal.suppressed():
            return
        with self._lock:
            rework = step <= self._max_step
        if rework:
            self.phase("rework", at=at)
        elif is_compile:
            self.phase("compile", at=at)
        else:
            self.phase("step_compute", at=at)

    def note_step_done(self, step: int, at: Optional[float] = None) -> None:
        """The step's loss is materialized (the host sync). Advances the
        high-water mark and spools a per-step record so the NEXT
        incarnation can classify rework exactly."""
        if not self.enabled or _journal.suppressed():
            return
        with self._lock:
            self._steps += 1
            rework = step <= self._max_step
            if rework:
                self._rework_steps += 1
            else:
                self._max_step = step
            self._emit({"kind": "step", "pid": os.getpid(), "step": step,
                        "rework": rework})

    def close(self, at: Optional[float] = None) -> None:
        """Close the open interval and spool the incarnation summary
        (registered atexit by :func:`enable`; idempotent; not reached by
        kill -9 — torn incarnations keep only their flushed records)."""
        if not self.enabled:
            return
        t = self._now(at)
        with self._lock:
            if self._closed or self._t0 is None:
                return
            self._close_interval(t)
            self._phase = None
            self._closed = True
            self._emit({
                "kind": "summary", "pid": os.getpid(),
                "wallclock_s": t - self._t0,
                "phases": {p: round(s, 9) for p, s in self._acc.items()},
                "steps": self._steps, "rework_steps": self._rework_steps,
                "max_step": self._max_step,
            })
            if self._spool is not None:
                try:
                    self._spool.close()
                except Exception:
                    pass
                self._spool = None

    def open_spool(self, path: str) -> None:
        with self._lock:
            self._spool = open(path, "a", encoding="utf-8")
            self._spool_path = path

    def clear(self) -> None:
        with self._lock:
            self._t0 = None
            self._phase = None
            self._acc = {}
            self._lane = []
            self._steps = 0
            self._rework_steps = 0
            self._max_step = 0
            self._closed = False
            if self._spool is not None:
                try:
                    self._spool.close()
                except Exception:
                    pass
            self._spool = None
            self._spool_path = ""

    # -- read API (copy-on-read) ------------------------------------------
    def totals(self, at: Optional[float] = None) -> Dict[str, float]:
        """Closed + open phase-seconds as of ``at`` — the conservation
        check's left-hand side."""
        t = self._now(at)
        with self._lock:
            out = dict(self._acc)
            if self._phase is not None:
                dur = max(0.0, t - self._since)
                out[self._phase] = out.get(self._phase, 0.0) + dur
            return out

    def wallclock(self, at: Optional[float] = None) -> float:
        """Seconds since :meth:`start` — the conservation check's
        right-hand side (frozen at close)."""
        t = self._now(at)
        with self._lock:
            if self._t0 is None:
                return 0.0
            if self._closed:
                return self._since - self._t0
            return max(0.0, t - self._t0)

    def conservation_gap(self, at: Optional[float] = None) -> float:
        t = self._now(at)
        return sum(self.totals(t).values()) - self.wallclock(t)

    def goodput_fraction(self, at: Optional[float] = None
                         ) -> Optional[float]:
        """goodput seconds / wallclock (None before start)."""
        t = self._now(at)
        wall = self.wallclock(t)
        if wall <= 0:
            return None
        totals = self.totals(t)
        return sum(totals.get(p, 0.0) for p in GOODPUT_PHASES) / wall

    def current_phase(self) -> Optional[str]:
        with self._lock:
            return self._phase

    def snapshot(self, at: Optional[float] = None) -> Dict[str, Any]:
        t = self._now(at)
        totals = self.totals(t)
        wall = self.wallclock(t)
        frac = self.goodput_fraction(t)
        with self._lock:
            steps, rework = self._steps, self._rework_steps
            max_step = self._max_step
        return {
            "enabled": self.enabled,
            "phases": {p: round(totals.get(p, 0.0), 6)
                       for p in STEP_PHASES},
            "wallclockS": round(wall, 6),
            "conservationGapS": round(sum(totals.values()) - wall, 6),
            "goodputFraction": (round(frac, 6)
                                if frac is not None else None),
            "steps": steps, "reworkSteps": rework, "maxStep": max_step,
        }


    def chrome_events(self, t0: float) -> List[Dict[str, Any]]:
        """One named ``workload goodput`` Perfetto lane: an X span per
        closed phase interval (the open phase is drawn to the export
        instant). ``t0`` is the tracer's perf_counter anchor."""
        now = time.perf_counter()
        with self._lock:
            spans = list(self._lane)
            if self._phase is not None:
                spans.append((self._phase, self._since, now))
        if not spans:
            return []
        out: List[Dict[str, Any]] = [
            {"name": "thread_name", "ph": "M", "pid": 1, "tid": _LANE_TID,
             "ts": 0, "args": {"name": "workload goodput"}}]
        for phase, start, end in spans:
            out.append({"name": f"phase:{phase}", "ph": "X",
                        "cat": "goodput", "ts": (start - t0) * 1e6,
                        "dur": max(0.0, (end - start) * 1e6),
                        "pid": 1, "tid": _LANE_TID, "args": {}})
        return out


class _PhaseSpan:
    """Restore the surrounding phase on exit (``goodput.span(...)``)."""

    def __init__(self, ledger: GoodputLedger, prev: Optional[str]):
        self._ledger = ledger
        self._prev = prev

    def __enter__(self) -> "_PhaseSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._prev is not None:
            self._ledger.phase(self._prev)
        return False


class _NoopSpan:
    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()

GOODPUT = GoodputLedger()


def enabled() -> bool:
    return GOODPUT.enabled


def enable(spool_path: Optional[str] = None) -> None:
    """Turn the ledger on, optionally opening (appending to) a JSONL
    spool. When the spool already holds records from a previous
    incarnation (the harnesses share one ``--goodput-file`` across a
    fault episode), the step high-water mark is replayed from them so
    rework classification is exact across kills."""
    GOODPUT.enabled = True
    if spool_path:
        prev_max = spool_max_step(spool_path)
        GOODPUT.open_spool(spool_path)
        if prev_max:
            GOODPUT.seed_max_step(prev_max)
    GOODPUT.start()
    atexit.register(GOODPUT.close)


def disable() -> None:
    GOODPUT.enabled = False


# module-level wrappers: the instrumentation sites' one-liner surface
# (each gates on the singleton's enabled bit before doing anything)
def phase(phase: str, at: Optional[float] = None) -> None:
    GOODPUT.phase(phase, at=at)


def span(phase: str, at: Optional[float] = None):
    return GOODPUT.span(phase, at=at)


def note_step(step: int, is_compile: bool = False,
              at: Optional[float] = None) -> None:
    GOODPUT.note_step(step, is_compile=is_compile, at=at)


def note_step_done(step: int, at: Optional[float] = None) -> None:
    GOODPUT.note_step_done(step, at=at)


# -- spool readers (harness / bench aggregation side) -----------------------
def read_spool(path: str) -> List[Dict[str, Any]]:
    """Parse a goodput spool, tolerating a torn trailing line (the
    writer may have been kill -9'd mid-write)."""
    records: List[Dict[str, Any]] = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except ValueError:
                    continue  # torn line
    except OSError:
        return []
    return records


def spool_max_step(path: str) -> int:
    """Largest completed step recorded in a spool (0 when absent) — the
    cross-incarnation rework high-water mark."""
    best = 0
    for rec in read_spool(path):
        if rec.get("kind") == "step":
            best = max(best, int(rec.get("step", 0)))
        elif rec.get("kind") == "summary":
            best = max(best, int(rec.get("max_step", 0)))
    return best


def aggregate_spool(records: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Merge a multi-incarnation spool into per-phase totals plus
    per-incarnation bookkeeping. Incarnations are keyed by (start
    record, pid); one with a ``start`` but no ``summary`` is *torn*
    (kill -9 / watchdog os._exit) — its flushed phase records still
    count toward the breakdown, but it has no conservation claim."""
    phases: Dict[str, float] = {}
    observed_by_pid: Dict[int, float] = {}
    summaries: List[Dict[str, Any]] = []
    starts = 0
    steps = rework_steps = 0
    for rec in records:
        kind = rec.get("kind")
        if kind == "start":
            starts += 1
        elif kind == "phase":
            dur = max(0.0, float(rec.get("end", 0.0))
                      - float(rec.get("start", 0.0)))
            ph = str(rec.get("phase", ""))
            phases[ph] = phases.get(ph, 0.0) + dur
            pid = int(rec.get("pid", 0))
            observed_by_pid[pid] = observed_by_pid.get(pid, 0.0) + dur
        elif kind == "step":
            # counted from step records, not summaries, so torn (kill -9)
            # incarnations' completed steps are still attributed
            steps += 1
            if rec.get("rework"):
                rework_steps += 1
        elif kind == "summary":
            summaries.append(rec)
    wall = sum(float(s.get("wallclock_s", 0.0)) for s in summaries)
    goodput_s = sum(phases.get(p, 0.0) for p in GOODPUT_PHASES)
    return {
        "phases": phases,
        "incarnations": starts,
        "summaries": summaries,
        "torn": starts - len(summaries),
        "steps": steps,
        "rework_steps": rework_steps,
        "summarized_wallclock_s": wall,
        "observed_s": sum(observed_by_pid.values()),
        "goodput_fraction": (goodput_s / wall) if wall > 0 else None,
    }


def check_rework_classification(records: List[Dict[str, Any]]
                                ) -> List[str]:
    """Replay the merged spool's ``step`` records in file order against a
    fresh high-water mark: each record's recorded ``rework`` flag must
    match the replay (covers torn incarnations too — a mismatch means
    the cross-incarnation seed replay or the in-process classification
    drifted). Returns violation strings."""
    violations: List[str] = []
    hwm = 0
    for rec in records:
        if rec.get("kind") != "step":
            continue
        step = int(rec.get("step", 0))
        expected = step <= hwm
        got = bool(rec.get("rework", False))
        if got != expected:
            violations.append(
                f"goodput rework misclassified: step {step} (pid "
                f"{rec.get('pid')}) recorded rework={got} but the merged "
                f"high-water mark ({hwm}) implies {expected} — the spool "
                f"seed replay or note_step classification drifted")
        if step > hwm:
            hwm = step
    return violations


def check_spool(path: str, rel_tol: float = 1e-6) -> List[str]:
    """Conservation + registry violations for every summarized
    incarnation in a spool (the chaos harnesses call this after each
    soak). Returns human-readable violation strings, empty when clean."""
    violations: List[str] = []
    records = read_spool(path)
    for rec in records:
        if rec.get("kind") == "phase":
            ph = str(rec.get("phase", ""))
            if ph not in STEP_PHASES:
                violations.append(
                    f"goodput spool {path}: unregistered phase {ph!r} "
                    f"(OBS003)")
    for rec in records:
        if rec.get("kind") != "summary":
            continue
        wall = float(rec.get("wallclock_s", 0.0))
        got = sum(float(v) for v in rec.get("phases", {}).values())
        tol = rel_tol * max(1.0, wall)
        if abs(got - wall) > tol:
            violations.append(
                f"goodput conservation violated (pid {rec.get('pid')}): "
                f"sum(phases)={got:.6f}s != wallclock={wall:.6f}s "
                f"(|gap|={abs(got - wall):.6f}s > tol={tol:.6f}s)")
        for ph in rec.get("phases", {}):
            if ph not in STEP_PHASES:
                violations.append(
                    f"goodput spool {path}: unregistered phase {ph!r} "
                    f"in summary (OBS003)")
    return violations


def reconcile_busy(busy_s: float, observed_s: float,
                   slack_s: float) -> Optional[str]:
    """The workload↔capacity-ledger bridge check: the scheduler-side
    ``busy_guaranteed`` interval for a gang must COVER the workload's
    self-observed phase seconds (a workload can never observe more time
    than the cluster charged for it — that is a clock or accounting
    bug), and the uncovered remainder (interpreter startup/teardown
    plus intervals lost to kill -9) must stay under ``slack_s``.
    Returns a violation string or None."""
    gap = busy_s - observed_s
    if gap < -1e-3:
        return (f"goodput bridge: workload observed {observed_s:.3f}s > "
                f"scheduler busy_guaranteed {busy_s:.3f}s "
                f"(gap {gap:.3f}s) — workload time must be covered by "
                f"the capacity ledger")
    if gap > slack_s:
        return (f"goodput bridge: busy_guaranteed {busy_s:.3f}s exceeds "
                f"workload observed {observed_s:.3f}s by {gap:.3f}s "
                f"(> slack {slack_s:.1f}s) — unattributed busy time")
    return None


if envflags.get("HIVED_GOODPUT") == "1":  # ad-hoc opt-in, like HIVED_LEDGER
    enable()
