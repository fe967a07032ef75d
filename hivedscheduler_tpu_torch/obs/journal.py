"""Event journal: a bounded, crash-safe, causally linked record of
lifecycle events, with wait attribution and request flights.

A copy of ``hivedscheduler_tpu/obs/journal.py`` for the port's workloads.
Each :class:`Event` carries its gang or request key, a **cause** (the
parent event id, auto-chained to the key's previous event unless given)
and, for waits, a bucket from :data:`WAIT_BUCKETS`. The serving engine
emits ``serve_*`` events under ``serve/<rid>``; the train CLI and the
supervisor emit ``train_resume`` and ``train_rollback`` under ``train``.

**Request flights**: a single-engine request (``serve/<rid>``, with
``ServingEngine.record_flights``) is a sequence of exclusive,
non-overlapping **legs** (:data:`REQUEST_LEGS`) opened by
``note_request_submit``, advanced by ``note_leg`` and closed by one
``note_request_done``. The legs ending at or before the first token sum to
the measured TTFT (the stored ``ttft_gap`` is ~0); each closed leg is
observed into ``tpu_hive_request_leg_seconds{leg=}``, and
:func:`Journal.request_dominant_leg` is the SLO tracker's attribution key.

Served as copy-on-read snapshots (``snapshot``, ``flights``, ``requests``,
``request_timeline``), as Perfetto lanes merged into the Chrome-trace
export (:meth:`Journal.chrome_events`, folded in by ``obs.trace``), and as
an optional ``--journal-file`` JSONL spool (one event per line, flushed
per append) for replay after a crash. The spool's records are the JAX
package's, record for record.

- **Zero overhead when disabled** (the default): every emit path gates on
  one attribute load (``JOURNAL.enabled``) and returns before the lock.
- **Bounded**: a ``deque(maxlen=...)`` ring; per-key records and their
  intervals and legs are capped, the oldest closed key evicted first.
- **Thread-safe leaf**: ``journal_lock``; only the metrics leaf is ever
  acquired under it.
- **Schema-checked**: event types, wait buckets and legs must be rows of
  :data:`SCHEMA`, :data:`WAIT_BUCKETS` and :data:`REQUEST_LEGS`; the
  runtime raises otherwise.

``last_id`` gives a key's newest event id: the fleet router names a
serving leg's last event as the cause of its handoff and retry events.
Not copied: the scheduler's ladder helpers, which nothing in the port
calls: ``classify_wait``, the gang summaries ``gangs`` and ``timeline``,
and the replay helpers ``wait_intervals``, ``wait_totals`` and
``close_all``.

Enable with ``journal.enable()``, the CLIs' ``--journal-file``, or
``HIVED_JOURNAL=1``.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from hivedscheduler_tpu_torch.common import envflags, lockcheck

_DEFAULT_CAPACITY = 16384
_MAX_GANGS = 4096
_MAX_INTERVALS_PER_GANG = 64
_MAX_LEGS_PER_REQUEST = 64

# ---------------------------------------------------------------------------
# wait-attribution taxonomy. Buckets are monotonic accounting categories:
# at any instant a waiting gang is in exactly ONE bucket, transitions close
# the previous interval, and the per-bucket time sums to the gang's total
# wait. The rows are the reference's, so either package reads the other's
# spool.
# ---------------------------------------------------------------------------
WAIT_BUCKETS: Dict[str, str] = {
    "vc_quota": "the gang's VC has no free guaranteed cells left (quota "
                "stranding; backfill/promotion is the unblocking arm)",
    "fragmentation": "enough capacity exists but no contiguous placement "
                     "(defrag migration is the unblocking arm)",
    "capacity": "fewer free chips than the gang needs anywhere: pure "
                "queueing, no scheduler can help",
    "bad_hardware": "placement forced onto bad/doomed nodes; waiting on "
                    "node recovery",
    "reservation_hold": "blocked by cells held for a defrag waiter or a "
                        "mid-migration re-placement",
    "priority": "waiting on preemption of lower-priority victims to "
                "complete",
    "elastic_degraded": "running on a degraded elastic slice, waiting for "
                        "grow-promotion back to full shape",
    "unknown": "wait reason not classified (classifier fallback — a "
               "growing share here is a bug)",
}

# ---------------------------------------------------------------------------
# request-leg taxonomy: the serving tier's analogue of WAIT_BUCKETS. A
# request flight is a contiguous sequence of exclusive, non-overlapping
# legs — each ``note_leg(req, leg, at=t)`` attributes the interval from
# the flight's previous mark to ``t`` to exactly one leg, so the legs up
# to the first-token mark SUM to the measured TTFT (``note_request_done``
# stores the deficit as the flight's ``ttft_gap``).
# ---------------------------------------------------------------------------
REQUEST_LEGS: Dict[str, str] = {
    "route": "router dispatch: fleet submit (or retry re-dispatch) to the "
             "chosen replica engine's own submit timestamp",
    "router_queue": "a completed prefill leg waiting for the router step "
                    "that advances its KV handoff",
    "retry": "a shed/preempted/lost leg's whole wasted attempt, up to the "
             "moment the router abandons it (re-attribution: no time is "
             "lost between shed and retry)",
    "admission_wait": "engine queue wait: engine submit to slot admission "
                      "(the strict-priority / block-availability gate)",
    "prefill": "slot admission to the leg's first emitted token on a "
               "prefill-role or unified replica (prompt prefill)",
    "handoff_ship": "host-side export of the prefill replica's prefix-"
                    "cache payload (HIVED_FLEET_KV_SHIP=1)",
    "handoff_import": "importing the shipped payload into the decode "
                      "replica's block pool as refcounted prefix blocks",
    "first_decode": "decode-leg admission to its first token after a KV "
                    "handoff (imported-prefix restore + tail prefill + "
                    "the first decode window)",
}

# ---------------------------------------------------------------------------
# event schema registry: the journal event types, the reference's rows
# (the scheduler's and the fleet's included, so a spool of either package
# names the same types); the runtime raises on any other.
# ---------------------------------------------------------------------------
SCHEMA: Dict[str, str] = {
    # scheduler core lifecycle (algorithm/hived.py)
    "queued": "gang is waiting; bucket = wait attribution (re-emitted only "
              "on bucket transition)",
    "bind": "gang's placement committed (first member bind of an "
            "incarnation opens its running episode)",
    "preempt_planned": "preemption decided for this gang; victims listed "
                       "(opens/continues a `priority` wait)",
    "released": "gang's allocation fully released (complete, evicted, or "
                "preempted — the cause chain says which)",
    # defrag executor (runtime/scheduler.py, under the scheduler lock)
    "defrag_planned": "migration plan accepted for this waiting gang; "
                      "moves + reserved slice in args",
    "migration_evict": "a mover gang's pods are being evicted (cause = the "
                       "waiter's defrag_planned / grow plan event)",
    "migration_rebound": "a mover re-placed on its reserved target "
                         "(work-preserving: resumed from checkpoint)",
    "migration_done": "every move rebound; the waiter's slice is free",
    "migration_failed": "a move could not re-place; holds released, the "
                        "evicted job resubmits from its checkpoint",
    "migration_aborted": "the job died mid-migration or an operator "
                         "cancelled; holds released",
    "reservation_expired": "a TTL sweep released a hold whose partner "
                           "never came back",
    "backfill_admitted": "a gang rode reserved/idle cells (outcome: "
                         "admitted = preemptible rider, fits-window = "
                         "duration-bounded guaranteed rider)",
    # elastic arm (runtime/scheduler.py)
    "elastic_offer": "a blocked elastic waiter is offered its largest "
                     "feasible shrink rung",
    "elastic_grow_planned": "a degraded gang's full shape fits again; "
                            "grow-migration planned",
    "elastic_grow_done": "grow-promotion landed: the gang runs at full "
                         "shape (closes its elastic_degraded wait)",
    # serving admission/preemption (models/serving.py)
    "serve_submit": "request entered the serving queue",
    "serve_admit": "request admitted to a decode slot (queue wait closed)",
    "serve_shed": "request shed on the queue-wait deadline before it ran",
    "serve_preempt": "stream truncated to relieve KV block-pool exhaustion",
    "serve_finish": "request finished (finish_reason in args)",
    # serving fleet tier (fleet/router.py + fleet/autoscaler.py)
    "fleet_route": "a fleet request leg was routed to a replica (leg = "
                   "prefill/decode; policy in args)",
    "fleet_handoff": "disaggregated prefill->decode KV handoff (mode = "
                     "ship/miss/reprefill; cause = the prefill leg's last "
                     "serve event)",
    "fleet_retry": "a shed/preempted/lost leg was re-routed to another "
                   "replica (the stream restarts from scratch, "
                   "token-exactly for greedy)",
    "fleet_scale": "autoscaler decision (direction, phase = "
                   "pending/added/draining/removed, replica, reason)",
    # request flight recorder (fleet/router.py + models/serving.py):
    # request-scoped, cause-chained TTFT decomposition — note_request_*
    # and note_leg emit these
    "request_submit": "a request flight opened (the TTFT clock's zero "
                      "mark; fleet/<fid> or serve/<rid>)",
    "request_leg": "one closed flight leg (bucket = the REQUEST_LEGS "
                   "name; legs tile the flight, TTFT legs sum to ttft_s)",
    "request_done": "the flight's single terminal: finish reason, "
                    "measured TTFT and the leg-sum gap in args",
    # wait-ETA estimator (obs/eta.py): forecast annotation on a waiting
    # gang's timeline, scored against the realized wait by later PRs
    "eta_forecast": "capacity-without-a-move forecast for a waiting gang "
                    "(etaS/basis/needChips in args; obs/eta.py)",
    # workload supervisor (train.py / parallel/supervisor.py)
    "train_resume": "a training incarnation resumed from a committed "
                    "checkpoint (preemption/crash restart)",
    "train_rollback": "divergence-guard rollback to the last good "
                      "checkpoint",
}

# event types that close a gang's open wait interval when emitted through
# note_phase (bind ends the queue wait; grow ends the degraded wait;
# released ends whatever was open)
_PHASE_CLOSED = "closed"


@dataclass
class Event:
    """One journal event. ``t`` is the monotonic timestamp used for
    durations (``perf_counter`` seconds, or the caller's virtual clock in
    sim contexts); ``ts`` is the wall epoch (0.0 when virtual)."""

    id: int
    gang: str
    type: str
    cause: Optional[int] = None
    bucket: str = ""
    detail: str = ""
    t: float = 0.0
    ts: float = 0.0
    args: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "gang": self.gang,
            "type": self.type,
            "cause": self.cause,
            "bucket": self.bucket,
            "detail": self.detail,
            "t": round(self.t, 6),
            "ts": self.ts,
            "args": self.args,
        }


class Journal:
    """Bounded ring of lifecycle events + per-gang wait accounting.

    Instantiable for tests; the module singleton :data:`JOURNAL` is what
    the workload shares. ``metrics`` gates the wait and leg histograms so a
    virtual-clock instance never pollutes the process registry.
    """

    def __init__(self, capacity: int = _DEFAULT_CAPACITY,
                 max_gangs: int = _MAX_GANGS, metrics: bool = True,
                 intervals_per_gang: int = _MAX_INTERVALS_PER_GANG):
        self._lock = lockcheck.make_lock("journal_lock", late=True)
        self._ring: deque = deque(maxlen=capacity)
        # gang -> record; insertion-ordered so eviction drops the oldest
        # closed gang first
        self._gangs: Dict[str, Dict[str, Any]] = {}
        self._max_gangs = max_gangs
        self._intervals_per_gang = intervals_per_gang
        self._seq = 0
        self._next_tid = 1000  # stable Perfetto lane per gang
        self.enabled = False
        self.metrics = metrics
        self.evicted = 0  # events displaced by the ring bound
        self._spool = None
        self._spool_path = ""

    # -- internal (caller holds self._lock) -----------------------------
    def _record(self, gang: str, at: float) -> Dict[str, Any]:
        rec = self._gangs.get(gang)
        if rec is None:
            if len(self._gangs) >= self._max_gangs:
                # evict the oldest CLOSED gang; live gangs are never dropped
                for name, r in list(self._gangs.items()):
                    if r["phase"] == _PHASE_CLOSED:
                        del self._gangs[name]
                        break
            self._next_tid += 1
            rec = {
                "tid": self._next_tid,
                "phase": "new",
                "wait": None,  # (bucket, start_t) while a wait is open
                "waits": {},  # bucket -> closed seconds
                "intervals": [],  # (bucket, start, end), capped
                "last": None,  # last event id (the auto-chain cause)
                "last_type": "",
                "first_t": at,
                "last_t": at,
                "events": 0,
                "flight": None,  # request-flight record (see _flight)
            }
            self._gangs[gang] = rec
        return rec

    def _append(self, etype: str, gang: str, cause: Optional[int],
                bucket: str, detail: str, at: Optional[float],
                args: Dict[str, Any]) -> int:
        if etype not in SCHEMA:
            raise ValueError(
                f"{etype!r} is not a registered journal event type — add it "
                f"to obs/journal.py SCHEMA")
        virtual = at is not None
        t = time.perf_counter() if at is None else at
        with self._lock:
            rec = self._record(gang, t)
            self._seq += 1
            if cause is None:
                cause = rec["last"]
            ev = Event(id=self._seq, gang=gang, type=etype, cause=cause,
                       bucket=bucket, detail=detail, t=t,
                       ts=0.0 if virtual else time.time(), args=args)
            if len(self._ring) == self._ring.maxlen:
                self.evicted += 1
            self._ring.append(ev)
            rec["last"] = ev.id
            rec["last_type"] = etype
            rec["last_t"] = t
            rec["events"] += 1
            spool = self._spool
            if spool is not None:
                try:
                    spool.write(json.dumps(ev.to_dict()) + "\n")
                    spool.flush()  # crash-safe: every line survives kill -9
                except OSError:
                    self._spool = None  # a dead spool must not fail emit
            return ev.id

    def _close_wait(self, rec: Dict[str, Any], at: float) -> None:
        open_wait = rec["wait"]
        if open_wait is None:
            return
        bucket, start = open_wait
        rec["wait"] = None
        dur = max(0.0, at - start)
        rec["waits"][bucket] = rec["waits"].get(bucket, 0.0) + dur
        if len(rec["intervals"]) < self._intervals_per_gang:
            rec["intervals"].append((bucket, start, at))
        if self.metrics:
            from hivedscheduler_tpu_torch.runtime.metrics import REGISTRY
            REGISTRY.observe("tpu_hive_gang_wait_seconds", dur,
                             reason=bucket)

    # -- emit API --------------------------------------------------------
    def emit(self, etype: str, gang: str, cause: Optional[int] = None,
             bucket: str = "", detail: str = "", at: Optional[float] = None,
             **args: Any) -> Optional[int]:
        """Append one event (no phase bookkeeping). Returns the event id,
        or None when disabled — the single-check contract — or while this
        thread is inside ``suppress()``."""
        if not self.enabled or suppressed():
            return None
        return self._append(etype, gang, cause, bucket, detail, at, args)

    def note_wait(self, gang: str, bucket: str, detail: str = "",
                  cause: Optional[int] = None, at: Optional[float] = None,
                  etype: str = "queued", **args: Any) -> Optional[int]:
        """Open (or re-attribute) a gang's wait. Same bucket: no event, the
        interval continues. Bucket change: the previous interval closes
        (accumulated + observed) and a new one opens at ``at``."""
        if not self.enabled or suppressed():
            return None
        if bucket not in WAIT_BUCKETS:
            raise ValueError(
                f"{bucket!r} is not a registered wait-attribution bucket — "
                f"add it to obs/journal.py WAIT_BUCKETS")
        t = time.perf_counter() if at is None else at
        with self._lock:
            rec = self._record(gang, t)
            open_wait = rec["wait"]
            if open_wait is not None and open_wait[0] == bucket:
                return rec["last"]
            self._close_wait(rec, t)
            rec["wait"] = (bucket, t)
            if rec["phase"] != "running":
                rec["phase"] = "waiting"
        return self._append(etype, gang, cause, bucket, detail, at, args)

    def note_phase(self, gang: str, phase: str, etype: str,
                   cause: Optional[int] = None, at: Optional[float] = None,
                   **args: Any) -> Optional[int]:
        """Transition a gang's lifecycle phase (``running`` / ``closed``),
        closing any open wait interval. Idempotent: a repeat transition to
        the current phase emits nothing (so every member pod of a gang can
        report the bind and only the first opens the episode)."""
        if not self.enabled or suppressed():
            return None
        t = time.perf_counter() if at is None else at
        with self._lock:
            rec = self._gangs.get(gang)
            if rec is None:
                if phase == _PHASE_CLOSED:
                    # release of a gang the journal never saw open (e.g.
                    # enabled mid-flight): nothing to close, keep the
                    # open->close invariant vacuously true
                    return None
                rec = self._record(gang, t)
            if rec["phase"] == phase and rec["wait"] is None:
                # idempotent repeat (e.g. every member pod reporting the
                # gang bind) — but a same-phase transition that closes an
                # open wait (elastic_grow_done while running-degraded)
                # still emits
                return rec["last"]
            self._close_wait(rec, t)
            rec["phase"] = phase
        return self._append(etype, gang, cause, "", "", at, args)

    # -- request flight recorder (TTFT leg attribution) ------------------
    def _flight(self, rec: Dict[str, Any], at: float,
                opened: bool) -> Dict[str, Any]:
        fl = rec["flight"]
        if fl is None:
            fl = rec["flight"] = {
                "t0": at,       # flight zero mark (= submit time when opened)
                "mark": at,     # end of the last attributed leg
                "legs": [],     # (leg, start, end), contiguous, capped
                "dropped_legs": 0,
                "terminals": 0,
                "terminal": None,       # finish reason once terminal
                "first_token_t": None,
                "done_t": None,
                "ttft_gap": None,       # ttft-leg sum minus measured ttft
                # False when the recorder was enabled mid-flight (first
                # contact was a leg, not the submit): the TTFT gap is then
                # unknowable and note_request_done skips the accounting
                "opened": opened,
            }
        return fl

    def note_request_submit(self, req: str, at: Optional[float] = None,
                            cause: Optional[int] = None,
                            **args: Any) -> Optional[int]:
        """Open (or re-open — a fresh incarnation resets the record) a
        request flight at ``at``: the zero mark every later leg and the
        measured TTFT are anchored to."""
        if not self.enabled or suppressed():
            return None
        t = time.perf_counter() if at is None else at
        with self._lock:
            rec = self._record(req, t)
            rec["flight"] = None  # re-submission = a fresh incarnation
            self._flight(rec, t, opened=True)
        return self._append("request_submit", req, cause, "", "", at, args)

    def note_leg(self, req: str, leg: str, at: Optional[float] = None,
                 cause: Optional[int] = None, **args: Any) -> Optional[int]:
        """Attribute the interval from the flight's previous mark to
        ``at`` to ``leg`` (one of :data:`REQUEST_LEGS`) and advance the
        mark — legs are exclusive and non-overlapping by construction, so
        instrument *coverage* is what the sum-to-TTFT assertion checks."""
        if not self.enabled or suppressed():
            return None
        if leg not in REQUEST_LEGS:
            raise ValueError(
                f"{leg!r} is not a registered request leg — add it to "
                f"obs/journal.py REQUEST_LEGS")
        t = time.perf_counter() if at is None else at
        with self._lock:
            rec = self._record(req, t)
            fl = self._flight(rec, t, opened=False)
            start = fl["mark"]
            if t < start:  # defensive: a late-arriving mark never
                t = start  # produces an overlapping/negative leg
            if len(fl["legs"]) < _MAX_LEGS_PER_REQUEST:
                fl["legs"].append((leg, start, t))
            else:
                fl["dropped_legs"] += 1
            fl["mark"] = t
            if self.metrics:
                from hivedscheduler_tpu_torch.runtime.metrics import REGISTRY
                REGISTRY.observe("tpu_hive_request_leg_seconds",
                                 max(0.0, t - start), leg=leg)
        return self._append("request_leg", req, cause, leg, "", at,
                            dict(args, durS=round(t - start, 6)))

    def note_request_done(self, req: str, reason: str,
                          first_token_at: Optional[float] = None,
                          at: Optional[float] = None,
                          cause: Optional[int] = None,
                          **args: Any) -> Optional[int]:
        """The flight's single terminal. ``first_token_at`` (the same
        clock value the caller's ``ttft_s`` derives from) closes the TTFT
        accounting: the legs ending at or before it must sum to
        ``first_token_at - t0`` — the stored ``ttft_gap`` is the deficit,
        and a non-zero gap means an uninstrumented segment on the request
        path."""
        if not self.enabled or suppressed():
            return None
        t = time.perf_counter() if at is None else at
        with self._lock:
            rec = self._record(req, t)
            fl = self._flight(rec, t, opened=False)
            fl["terminals"] += 1
            fl["terminal"] = reason
            fl["done_t"] = t
            gap = None
            if first_token_at is not None:
                fl["first_token_t"] = first_token_at
                if fl["opened"]:
                    ttft = first_token_at - fl["t0"]
                    sum_legs = sum(
                        e - s for _l, s, e in fl["legs"]
                        if e <= first_token_at + 1e-9)
                    gap = fl["ttft_gap"] = sum_legs - ttft
            rec["phase"] = _PHASE_CLOSED  # eviction-eligible, no extra event
        extra = dict(args, finishReason=reason)
        if gap is not None:
            extra["ttftGapS"] = round(gap, 9)
        return self._append("request_done", req, cause, "", "", at, extra)

    @staticmethod
    def _dominant_leg_of(fl: Dict[str, Any]) -> str:
        """The leg holding the most TTFT time (all legs when the flight
        never emitted a token) — the SLO violation-attribution key."""
        ft = fl["first_token_t"]
        totals: Dict[str, float] = {}
        for leg, s, e in fl["legs"]:
            if ft is None or e <= ft + 1e-9:
                totals[leg] = totals.get(leg, 0.0) + (e - s)
        if not totals:
            return ""
        return max(totals.items(), key=lambda kv: (kv[1], kv[0]))[0]

    def request_dominant_leg(self, req: str) -> str:
        with self._lock:
            rec = self._gangs.get(req)
            if rec is None or rec["flight"] is None:
                return ""
            return self._dominant_leg_of(rec["flight"])

    def last_id(self, gang: str) -> Optional[int]:
        """The gang's most recent event id (for explicit cross-gang
        causes), or None."""
        with self._lock:
            rec = self._gangs.get(gang)
            return None if rec is None else rec["last"]

    def flights(self) -> Dict[str, Dict[str, Any]]:
        """Copy-on-read raw flight records — the invariant checks' and
        the SLO tracker's attribution source."""
        with self._lock:
            out = {}
            for gang, rec in self._gangs.items():
                fl = rec["flight"]
                if fl is None:
                    continue
                out[gang] = dict(fl, legs=list(fl["legs"]))
            return out

    def requests(self) -> List[Dict[str, Any]]:
        """Per-request flight summaries, most recently active first (the
        ``/v1/inspect/requests`` payload)."""
        with self._lock:
            out = []
            for gang, rec in self._gangs.items():
                fl = rec["flight"]
                if fl is None:
                    continue
                legs: Dict[str, float] = {}
                for leg, s, e in fl["legs"]:
                    legs[leg] = legs.get(leg, 0.0) + (e - s)
                ft = fl["first_token_t"]
                out.append({
                    "request": gang,
                    "terminal": fl["terminal"],
                    "legs": {k: round(v, 6)
                             for k, v in sorted(legs.items())},
                    "dominantLeg": self._dominant_leg_of(fl),
                    "ttftS": (None if ft is None or not fl["opened"]
                              else round(ft - fl["t0"], 6)),
                    "ttftGapS": (None if fl["ttft_gap"] is None
                                 else round(fl["ttft_gap"], 9)),
                    "wallS": (None if fl["done_t"] is None
                              else round(fl["done_t"] - fl["t0"], 6)),
                    "lastT": rec["last_t"],
                })
        out.sort(key=lambda r: r.pop("lastT"), reverse=True)
        return out

    def request_timeline(self, req: str) -> Dict[str, Any]:
        """One request's retained events in causal order plus its leg
        decomposition (the ``/v1/inspect/requests/<id>/timeline``
        payload)."""
        with self._lock:
            events = [e.to_dict() for e in self._ring if e.gang == req]
            rec = self._gangs.get(req)
            fl = rec["flight"] if rec is not None else None
            legs = summary = None
            if fl is not None:
                legs = [{"leg": leg, "start": round(s, 6),
                         "end": round(e, 6), "durS": round(e - s, 6)}
                        for leg, s, e in fl["legs"]]
                ft = fl["first_token_t"]
                summary = {
                    "terminal": fl["terminal"],
                    "dominantLeg": self._dominant_leg_of(fl),
                    "ttftS": (None if ft is None or not fl["opened"]
                              else round(ft - fl["t0"], 6)),
                    "ttftGapS": (None if fl["ttft_gap"] is None
                                 else round(fl["ttft_gap"], 9)),
                    "droppedLegs": fl["dropped_legs"],
                }
        return {"request": req, "events": events, "legs": legs,
                "summary": summary, "ringEvicted": self.evicted}

    # -- read API (copy-on-read snapshots) -------------------------------
    def snapshot(self) -> List[Event]:
        with self._lock:
            return list(self._ring)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def chrome_events(self, t0: float) -> List[Dict[str, Any]]:
        """Per-gang Perfetto tracks: one named thread lane per gang, an
        instant per journal event and an X span per closed wait interval.
        ``t0`` is the tracer's perf_counter anchor so the lanes align with
        the span tracer's timeline."""
        with self._lock:
            lanes = {gang: rec["tid"] for gang, rec in self._gangs.items()}
            requests = {gang for gang, rec in self._gangs.items()
                        if rec["flight"] is not None}
            intervals = [
                (rec["tid"], bucket, start, end)
                for rec in self._gangs.values()
                for bucket, start, end in rec["intervals"]
            ]
            legs = [
                (rec["tid"], leg, start, end)
                for rec in self._gangs.values()
                if rec["flight"] is not None
                for leg, start, end in rec["flight"]["legs"]
            ]
            events = list(self._ring)
        out: List[Dict[str, Any]] = []
        for gang, tid in lanes.items():
            kind = "request" if gang in requests else "gang"
            out.append({"name": "thread_name", "ph": "M", "pid": 1,
                        "tid": tid, "ts": 0,
                        "args": {"name": f"{kind} {gang}"}})
        for ev in events:
            tid = lanes.get(ev.gang)
            if tid is None:
                continue  # gang record evicted; no lane to draw on
            args = dict(ev.args)
            args.update(id=ev.id, cause=ev.cause)
            if ev.bucket:
                args["bucket"] = ev.bucket
            out.append({"name": ev.type, "ph": "i", "s": "t",
                        "cat": "journal", "ts": (ev.t - t0) * 1e6,
                        "pid": 1, "tid": tid, "args": args})
        for tid, bucket, start, end in intervals:
            out.append({"name": f"wait:{bucket}", "ph": "X",
                        "cat": "journal", "ts": (start - t0) * 1e6,
                        "dur": max(0.0, (end - start) * 1e6),
                        "pid": 1, "tid": tid, "args": {"bucket": bucket}})
        for tid, leg, start, end in legs:
            out.append({"name": f"leg:{leg}", "ph": "X",
                        "cat": "journal", "ts": (start - t0) * 1e6,
                        "dur": max(0.0, (end - start) * 1e6),
                        "pid": 1, "tid": tid, "args": {"leg": leg}})
        return out

    # -- lifecycle -------------------------------------------------------
    def open_spool(self, path: str) -> None:
        self._spool = open(path, "a", encoding="utf-8")
        self._spool_path = path

    def close_spool(self) -> None:
        if self._spool is not None:
            try:
                self._spool.close()
            except OSError:
                pass
            self._spool = None

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._gangs.clear()
            self._seq = 0
            self.evicted = 0


JOURNAL = Journal()

# -- thread-local suppression ------------------------------------------------
# Work that runs for real but never happened as far as the record goes (the
# reference's what-if probes, which roll their transactions back) runs
# under ``suppress()``: the journal and the goodput ledger then record
# nothing. Suppression is PER-THREAD, so engines on other threads keep
# journaling.

_tls = threading.local()


class _Suppress:
    __slots__ = ()

    def __enter__(self) -> "_Suppress":
        _tls.depth = getattr(_tls, "depth", 0) + 1
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _tls.depth -= 1
        return False


_SUPPRESS = _Suppress()


def suppress() -> _Suppress:
    """``with journal.suppress(): ...``: mute this thread's emissions."""
    return _SUPPRESS


def suppressed() -> bool:
    return getattr(_tls, "depth", 0) > 0


def enabled() -> bool:
    return JOURNAL.enabled


def enable(capacity: Optional[int] = None,
           spool_path: Optional[str] = None) -> None:
    """Turn the journal on (optionally resizing — which resets — the ring,
    and/or opening a JSONL spool)."""
    global JOURNAL
    if capacity is not None:
        JOURNAL.close_spool()
        JOURNAL = Journal(capacity)
    if spool_path:
        JOURNAL.open_spool(spool_path)
    JOURNAL.enabled = True


def disable() -> None:
    JOURNAL.enabled = False
    JOURNAL.close_spool()


def emit(etype: str, gang: str, cause: Optional[int] = None,
         bucket: str = "", detail: str = "", at: Optional[float] = None,
         **args: Any) -> Optional[int]:
    return JOURNAL.emit(etype, gang, cause=cause, bucket=bucket,
                        detail=detail, at=at, **args)


def note_wait(gang: str, bucket: str, detail: str = "",
              cause: Optional[int] = None, at: Optional[float] = None,
              etype: str = "queued", **args: Any) -> Optional[int]:
    return JOURNAL.note_wait(gang, bucket, detail=detail, cause=cause,
                             at=at, etype=etype, **args)


def note_phase(gang: str, phase: str, etype: str,
               cause: Optional[int] = None, at: Optional[float] = None,
               **args: Any) -> Optional[int]:
    return JOURNAL.note_phase(gang, phase, etype, cause=cause, at=at,
                              **args)


def note_request_submit(req: str, at: Optional[float] = None,
                        cause: Optional[int] = None,
                        **args: Any) -> Optional[int]:
    return JOURNAL.note_request_submit(req, at=at, cause=cause, **args)


def note_leg(req: str, leg: str, at: Optional[float] = None,
             cause: Optional[int] = None, **args: Any) -> Optional[int]:
    return JOURNAL.note_leg(req, leg, at=at, cause=cause, **args)


def note_request_done(req: str, reason: str,
                      first_token_at: Optional[float] = None,
                      at: Optional[float] = None,
                      cause: Optional[int] = None,
                      **args: Any) -> Optional[int]:
    return JOURNAL.note_request_done(req, reason,
                                     first_token_at=first_token_at,
                                     at=at, cause=cause, **args)


if envflags.get("HIVED_JOURNAL") == "1":  # ad-hoc opt-in, like HIVED_TRACE
    enable()
