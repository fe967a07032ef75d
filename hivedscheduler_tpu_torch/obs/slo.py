"""Declared serving SLOs: windowed quantiles, error-budget burn rate,
and violation attribution by dominant request leg.

A copy of ``hivedscheduler_tpu/obs/slo.py``:

- :class:`SLObjective`: one declared objective, a quantile ceiling over a
  series (``ttft`` or ``tpot``), optionally scoped to one priority class;
  the serve CLI declares it (``--slo-ttft-p99``, ``--slo-window-s``).
- :class:`SLOTracker`: a bounded, windowed observation ring whose
  :meth:`SLOTracker.snapshot` the serve CLI logs at exit, and which sets
  the ``tpu_hive_slo_ttft_p99_seconds`` / ``tpu_hive_slo_burn_rate``
  gauges and counts ``tpu_hive_slo_violations_total{objective=,leg=}``.

**Burn rate** (the SRE error-budget convention): an objective "quantile q
of the series stays under the ceiling" grants a violation budget of
``1 - q``; over the window, ``burn = violating_fraction / (1 - q)``.

**Violation attribution**: each observation carries the request's dominant
leg (``obs.journal.Journal.request_dominant_leg``), empty when the flight
recorder is off (attribution degrades, tracking does not).

Quantile convention: ``sorted(values)[int(q * (len - 1))]``, the
reference's. ``slo_lock`` is a leaf under which only the metrics leaf is
acquired.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from hivedscheduler_tpu_torch.common import envflags, lockcheck

_DEFAULT_CAP = 256  # observations retained per series


def default_window_s() -> float:
    """``HIVED_SLO_WINDOW_S``: the default sliding window for quantiles
    and burn rates (0 disables time-windowing — pure ring semantics)."""
    return float(envflags.get("HIVED_SLO_WINDOW_S", "60"))


@dataclasses.dataclass(frozen=True)
class SLObjective:
    """One declared objective: ``quantile`` of ``series`` must stay at or
    under ``ceiling_s`` (seconds). ``priority`` scopes the objective to
    one priority class (None = all traffic)."""

    series: str = "ttft"        # "ttft" | "tpot"
    quantile: float = 0.99
    ceiling_s: float = 0.0      # must be > 0 for a real objective
    priority: Optional[int] = None

    def __post_init__(self):
        if self.series not in ("ttft", "tpot"):
            raise ValueError(f"unknown SLO series {self.series!r} "
                             f"(choose ttft or tpot)")
        if not 0.0 < self.quantile < 1.0:
            raise ValueError(f"SLO quantile must be in (0, 1), got "
                             f"{self.quantile}")
        if self.ceiling_s <= 0:
            raise ValueError(f"SLO ceiling must be > 0 s, got "
                             f"{self.ceiling_s}")

    @property
    def name(self) -> str:
        prio = "" if self.priority is None else f"/p{self.priority}"
        return f"{self.series}_p{round(self.quantile * 100):d}{prio}"

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "series": self.series,
                "quantile": self.quantile, "ceilingS": self.ceiling_s,
                "priority": self.priority}


class SLOTracker:
    """Bounded, windowed TTFT/TPOT observations + objective accounting.

    ``window_s`` None reads :func:`default_window_s`; 0 disables time
    windowing (last-``cap`` ring semantics). ``metrics=False`` keeps a
    virtual-clock instance (fake-clock tests) out of the process metrics
    registry, mirroring ``Journal(metrics=...)``.
    """

    def __init__(self, objectives: Tuple[SLObjective, ...] = (),
                 window_s: Optional[float] = None, cap: int = _DEFAULT_CAP,
                 clock=time.perf_counter, metrics: bool = True):
        self._lock = lockcheck.make_lock("slo_lock")
        self.objectives = tuple(objectives)
        self.window_s = default_window_s() if window_s is None else window_s
        self._clock = clock
        self.metrics = metrics
        # series -> deque of (t, value, priority, dominant_leg)
        self._obs: Dict[str, deque] = {
            "ttft": deque(maxlen=cap), "tpot": deque(maxlen=cap)}
        # objective name -> {leg: violation count} (lifetime)
        self.violations: Dict[str, Dict[str, int]] = {
            o.name: {} for o in self.objectives}

    # -- write -----------------------------------------------------------
    def observe(self, series: str, value: float, priority: int = 0,
                leg: str = "", at: Optional[float] = None) -> None:
        """Record one finished request's ``series`` seconds. ``leg`` is
        the request's dominant TTFT leg ("" when the flight recorder is
        off). Updates the objective violation books and — for a real
        (``metrics=True``) tracker — the slo gauges/counters."""
        t = self._clock() if at is None else at
        with self._lock:
            self._obs[series].append((t, value, priority, leg))
            violated: List[str] = []
            for o in self.objectives:
                if o.series != series or value <= o.ceiling_s:
                    continue
                if o.priority is not None and priority != o.priority:
                    continue
                by_leg = self.violations[o.name]
                key = leg or "unattributed"
                by_leg[key] = by_leg.get(key, 0) + 1
                violated.append(o.name)
            if self.metrics:
                from hivedscheduler_tpu_torch.runtime.metrics import REGISTRY
                for name in violated:
                    REGISTRY.inc("tpu_hive_slo_violations_total",
                                 objective=name, leg=leg or "unattributed")
                REGISTRY.set_gauge("tpu_hive_slo_ttft_p99_seconds",
                                   self._quantile_locked(0.99, "ttft", t))
                burns = [self._burn_locked(o, t) for o in self.objectives]
                REGISTRY.set_gauge(
                    "tpu_hive_slo_burn_rate",
                    max((b for b in burns if b is not None), default=0.0))

    # -- read ------------------------------------------------------------
    def _window_locked(self, series: str, now: float,
                       priority: Optional[int] = None):
        cutoff = now - self.window_s if self.window_s > 0 else None
        return [
            (t, v, p, leg) for t, v, p, leg in self._obs[series]
            if (cutoff is None or t >= cutoff)
            and (priority is None or p == priority)
        ]

    def _quantile_locked(self, q: float, series: str, now: float,
                         priority: Optional[int] = None) -> float:
        vals = sorted(v for _t, v, _p, _leg
                      in self._window_locked(series, now, priority))
        if not vals:
            return 0.0
        return vals[int(q * (len(vals) - 1))]

    def quantile(self, q: float, series: str = "ttft",
                 now: Optional[float] = None,
                 priority: Optional[int] = None) -> float:
        """Windowed quantile (0.0 with no observations), the same
        computation as the snapshot's."""
        t = self._clock() if now is None else now
        with self._lock:
            return self._quantile_locked(q, series, t, priority)

    def _burn_locked(self, o: SLObjective, now: float) -> Optional[float]:
        obs = self._window_locked(o.series, now, o.priority)
        if not obs:
            return None
        viol = sum(1 for _t, v, _p, _leg in obs if v > o.ceiling_s)
        return (viol / len(obs)) / max(1e-9, 1.0 - o.quantile)

    def burn_rate(self, objective: SLObjective,
                  now: Optional[float] = None) -> Optional[float]:
        """Error-budget burn over the window: violating fraction divided
        by the budget fraction ``1 - q`` (None with no observations)."""
        t = self._clock() if now is None else now
        with self._lock:
            return self._burn_locked(objective, t)

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        """Windowed series quantiles and per-objective books
        (copy-on-read): what the serve CLI logs at exit."""
        t = self._clock() if now is None else now
        with self._lock:
            series = {}
            for name in ("ttft", "tpot"):
                obs = self._window_locked(name, t)
                series[name] = {
                    "count": len(obs),
                    "p50": round(self._quantile_locked(0.50, name, t), 6),
                    "p95": round(self._quantile_locked(0.95, name, t), 6),
                    "p99": round(self._quantile_locked(0.99, name, t), 6),
                }
            objectives = []
            for o in self.objectives:
                obs = self._window_locked(o.series, t, o.priority)
                viol = sum(1 for _t, v, _p, _leg in obs
                           if v > o.ceiling_s)
                burn = self._burn_locked(o, t)
                objectives.append(dict(
                    o.to_dict(),
                    value=round(self._quantile_locked(
                        o.quantile, o.series, t, o.priority), 6),
                    windowCount=len(obs),
                    windowViolations=viol,
                    compliance=(None if not obs
                                else round(1.0 - viol / len(obs), 6)),
                    burnRate=None if burn is None else round(burn, 4),
                    attribution=dict(sorted(
                        self.violations[o.name].items())),
                ))
        return {"windowS": self.window_s, "series": series,
                "objectives": objectives}


def objectives_from_knobs(ttft_p99_s: float = 0.0, tpot_p95_s: float = 0.0,
                          per_priority_ttft_p99: Optional[
                              Dict[int, float]] = None,
                          ) -> Tuple[SLObjective, ...]:
    """Build the objective tuple from the flat config/CLI knobs (0 = the
    objective is not declared)."""
    out: List[SLObjective] = []
    if ttft_p99_s > 0:
        out.append(SLObjective("ttft", 0.99, ttft_p99_s))
    if tpot_p95_s > 0:
        out.append(SLObjective("tpot", 0.95, tpot_p95_s))
    for prio, ceiling in sorted((per_priority_ttft_p99 or {}).items()):
        if ceiling > 0:
            out.append(SLObjective("ttft", 0.99, ceiling, priority=prio))
    return tuple(out)
