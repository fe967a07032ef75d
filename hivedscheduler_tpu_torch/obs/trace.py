"""Dependency-free span/event tracer with Chrome-trace (Perfetto) export.

A copy of ``hivedscheduler_tpu/obs/trace.py`` for the port's workloads:
the serving engine's request lifecycles (``models/serving.py``) and the
train step timeline (``train.py``) emit into one bounded in-memory ring
that exports as Chrome trace event JSON, the format Perfetto,
``chrome://tracing`` and TensorBoard's trace viewer load.

- **Zero overhead when disabled** (the default): every emit path starts
  with one module-level bool check.
- **Thread-safe** (the ring is locked) and **bounded** (a
  ``deque(maxlen=capacity)``: a long-lived server keeps the newest events).

Enable with ``trace.enable()``, ``serve --metrics-dump`` or ``HIVED_TRACE=1``.
Export with ``trace.to_chrome_trace()`` / ``trace.write_chrome_trace(path)``,
which merge the journal's and the goodput ledger's lanes. The capacity
ledger's per-node lanes belong to the scheduler and are not merged here.

Event schema (Chrome trace event format, the subset emitted):

- ``ph="X"`` complete events: ``name, cat, ts, dur, pid, tid, args``
- ``ph="i"`` instant events:  ``name, cat, ts, s="t", pid, tid, args``
- ``ph="M"`` metadata: process/thread names (emitted on ``enable()``)

``ts``/``dur`` are microseconds on the process-wide ``perf_counter``
clock, re-based to the tracer's start; callers that timestamp with
``time.perf_counter()`` themselves hand those values to ``complete()``.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from hivedscheduler_tpu_torch.common import envflags, lockcheck

_DEFAULT_CAPACITY = 65536


class Tracer:
    """Bounded ring of Chrome-trace events. Instantiable for tests; the
    module-level singleton ``TRACER`` is what the stack shares."""

    def __init__(self, capacity: int = _DEFAULT_CAPACITY):
        self._lock = lockcheck.make_lock("trace_lock", late=True)
        self._events: deque = deque(maxlen=capacity)
        # perf_counter anchor: all ts are relative to tracer creation so
        # callers' own perf_counter timestamps convert with one subtraction
        self._t0 = time.perf_counter()
        self.dropped = 0  # events displaced by the ring bound

    # -- emit ------------------------------------------------------------
    def _ts_us(self, at: Optional[float] = None) -> float:
        return ((time.perf_counter() if at is None else at) - self._t0) * 1e6

    def _emit(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            if len(self._events) == self._events.maxlen:
                self.dropped += 1
            self._events.append(ev)

    def complete(
        self,
        name: str,
        start: float,
        end: float,
        cat: str = "",
        tid: Optional[int] = None,
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        """Record a finished span from explicit ``perf_counter`` seconds,
        the path for callers that keep their own timestamps."""
        self._emit({
            "name": name,
            "ph": "X",
            "cat": cat or "default",
            "ts": self._ts_us(start),
            "dur": max(0.0, (end - start) * 1e6),
            "pid": 1,
            "tid": threading.get_ident() & 0x7FFFFFFF if tid is None else tid,
            "args": args or {},
        })

    def instant(
        self,
        name: str,
        cat: str = "",
        tid: Optional[int] = None,
        at: Optional[float] = None,
        args: Optional[Dict[str, Any]] = None,
    ) -> None:
        self._emit({
            "name": name,
            "ph": "i",
            "s": "t",  # thread-scoped instant
            "cat": cat or "default",
            "ts": self._ts_us(at),
            "pid": 1,
            "tid": threading.get_ident() & 0x7FFFFFFF if tid is None else tid,
            "args": args or {},
        })

    def metadata(self, name: str, value: str, tid: int = 0) -> None:
        """``M`` event naming a pid/tid lane in the viewer."""
        key = "process_name" if name == "process" else "thread_name"
        self._emit({
            "name": key,
            "ph": "M",
            "pid": 1,
            "tid": tid,
            "ts": 0,
            "args": {"name": value},
        })

    # -- read ------------------------------------------------------------
    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self.dropped = 0

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The dict form of the Chrome trace JSON object (Perfetto loads
        ``json.dumps`` of this verbatim)."""
        return {
            "traceEvents": self.snapshot(),
            "displayTimeUnit": "ms",
            "otherData": {"producer": "tpu-hive obs.trace",
                          "dropped_events": self.dropped},
        }

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)


# Module state: ONE bool gates every emit path. Disabled by default so the
# instrumented hot paths (serving steps, train steps) pay a single
# attribute load; HIVED_TRACE=1 opts in at import for ad-hoc runs.
_enabled = False
TRACER = Tracer()


def enabled() -> bool:
    return _enabled


def enable(capacity: Optional[int] = None) -> None:
    """Turn tracing on (optionally resizing the ring; resets its content)."""
    global _enabled, TRACER
    if capacity is not None:
        TRACER = Tracer(capacity)
    _enabled = True
    TRACER.metadata("process", "tpu-hive")


def disable() -> None:
    global _enabled
    _enabled = False


def instant(name: str, cat: str = "", tid: Optional[int] = None,
            **args: Any) -> None:
    if not _enabled:
        return
    TRACER.instant(name, cat, tid=tid, args=args)


def complete(name: str, start: float, end: float, cat: str = "",
             tid: Optional[int] = None, **args: Any) -> None:
    """Record a finished span from caller-held perf_counter timestamps."""
    if not _enabled:
        return
    TRACER.complete(name, start, end, cat=cat, tid=tid, args=args)


def to_chrome_trace() -> Dict[str, Any]:
    """The shared timeline as Chrome-trace JSON, with the journal's lanes
    (one per gang or request flight: event instants, wait and leg spans)
    and the goodput ledger's ``workload goodput`` phase lane merged in
    while each is enabled."""
    out = TRACER.to_chrome_trace()
    from hivedscheduler_tpu_torch.obs import goodput as _goodput
    from hivedscheduler_tpu_torch.obs import journal as _journal

    if _journal.JOURNAL.enabled:
        out["traceEvents"] = (
            list(out["traceEvents"])
            + _journal.JOURNAL.chrome_events(TRACER._t0)
        )
    if _goodput.GOODPUT.enabled:
        out["traceEvents"] = (
            list(out["traceEvents"])
            + _goodput.GOODPUT.chrome_events(TRACER._t0)
        )
    return out


def write_chrome_trace(path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(), f)


if envflags.get("HIVED_TRACE") == "1":  # ad-hoc opt-in without code changes
    enable()
