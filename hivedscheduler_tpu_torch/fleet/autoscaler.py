"""Fleet autoscaler: gauges in, replicas out.

A copy of ``hivedscheduler_tpu/fleet/autoscaler.py`` over the port's
router. ``FleetAutoscaler`` reads the signals the serving tier already
exports (block-pool occupancy, queue depth, and the router's SLO
tracker's windowed TTFT quantile, the same number the SLO lines report)
and decides a target replica count per role:

- **hysteresis**: scale up only after ``up_stable_ticks`` consecutive
  ticks of up-pressure (occupancy above ``occ_high``, queue depth above
  ``queue_high`` per replica, or p95 TTFT above ``ttft_ceiling_s``);
  scale down only after ``down_stable_ticks`` ticks of idle signal
  (occupancy below ``occ_low`` AND empty queues);
- **cooldown**: at most one scale action per role per ``cooldown_s``
  (default from ``HIVED_FLEET_AUTOSCALE_COOLDOWN_S``);
- **drain-based scale-down, always**: the victim (least outstanding work)
  gets ``router.begin_drain``; teardown waits until the router observes
  it drained (``remove_replica`` enforces it, ``check_fleet`` pins it).

Scale-up goes through a backend: :class:`LocalScaleBackend` builds
replicas in-process. A backend whose ``grow`` returns None reports the
grow as ``pending`` and is asked again next tick. Left out: the
reference's ``SchedulerScaleBackend``, which submits each replica as a
gang pod to a live scheduler through ``api.constants``, ``k8s.types`` and
``runtime.extender``: that is control plane, which the port does not
copy.

Every decision is journaled (``fleet_scale``) and counted
(``tpu_hive_fleet_scale_events_total``); the current target is the
``tpu_hive_fleet_target_replicas`` gauge.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from hivedscheduler_tpu_torch.common import envflags
from hivedscheduler_tpu_torch.fleet.router import FleetRouter, Replica
from hivedscheduler_tpu_torch.obs import journal as obs_journal
from hivedscheduler_tpu_torch.runtime.metrics import REGISTRY as metrics

log = logging.getLogger(__name__)


@dataclasses.dataclass
class AutoscalePolicy:
    """Per-role autoscaler knobs. ``cooldown_s < 0`` reads the
    ``HIVED_FLEET_AUTOSCALE_COOLDOWN_S`` flag (default 30)."""

    min_replicas: int = 1
    max_replicas: int = 4
    occ_high: float = 0.75
    occ_low: float = 0.25
    queue_high: float = 4.0      # queued requests per active replica
    ttft_ceiling_s: float = 0.0  # 0 = TTFT exerts no up-pressure
    up_stable_ticks: int = 2
    down_stable_ticks: int = 4
    cooldown_s: float = -1.0

    def resolved_cooldown(self) -> float:
        if self.cooldown_s >= 0:
            return self.cooldown_s
        return float(envflags.get("HIVED_FLEET_AUTOSCALE_COOLDOWN_S", "30"))


class LocalScaleBackend:
    """In-process replica factory: ``factory(role) -> (name, engine)`` or
    ``(name, engine, gang)``. grow() fails for capacity only when the
    factory returns None (then the autoscaler reports the grow pending)."""

    def __init__(self, factory: Callable[[str], tuple]):
        self._factory = factory

    def grow(self, role: str) -> Optional[tuple]:
        out = self._factory(role)
        if out is not None and len(out) == 2:
            out = (out[0], out[1], "")
        return out

    def shrink(self, role: str, replica: Replica) -> None:
        pass


class FleetAutoscaler:
    """The control loop. Call ``tick()`` periodically (the serve CLI
    ticks once a router step). ``clock`` is injectable so hysteresis and
    cooldown are deterministically testable."""

    def __init__(self, router: FleetRouter, backend,
                 policy: Optional[AutoscalePolicy] = None,
                 roles: Optional[Tuple[str, ...]] = None,
                 clock=time.perf_counter):
        self.router = router
        self.backend = backend
        self.policy = policy or AutoscalePolicy()
        self._cooldown = self.policy.resolved_cooldown()
        if roles is None:
            roles = (("prefill", "decode")
                     if router.disaggregate and router.kv_ship
                     else ("serve",))
        self.roles = roles
        self._clock = clock
        self._up: Dict[str, int] = {r: 0 for r in roles}
        self._down: Dict[str, int] = {r: 0 for r in roles}
        self._last_action: Dict[str, float] = {r: float("-inf")
                                               for r in roles}
        self._pending_down: Dict[str, str] = {}  # role -> draining name
        self.target: Dict[str, int] = {}
        self.actions: List[Dict[str, Any]] = []
        self.replica_seconds = 0.0  # integral of live replicas (the cost)
        self._last_tick: Optional[float] = None

    # -- signals -----------------------------------------------------------
    def _role_replicas(self, role: str) -> List[Replica]:
        role_blind = len(self.roles) == 1
        return [r for r in self.router.replicas.values()
                if r.state == "active"
                and (role_blind or r.role in (role, "serve"))]

    def signals(self, role: str) -> Dict[str, Any]:
        reps = self._role_replicas(role)
        occs = []
        qdepth = 0
        for rep in reps:
            eng = rep.engine
            if getattr(eng, "paged", False):
                occs.append(eng.blocks_in_use / max(1, eng.num_blocks - 1))
            else:
                occs.append(
                    sum(s is not None for s in eng.slots) / eng.max_batch)
            qdepth += len(eng.queue)
        # the SLO tracker's windowed quantile (obs/slo.py): the SAME
        # computation the SLO lines report
        slo = self.router.slo
        return {
            "replicas": len(reps),
            "occupancy": sum(occs) / len(occs) if occs else 0.0,
            "queueDepth": qdepth,
            "ttftP95": slo.quantile(0.95, "ttft"),
            "ttftP99": slo.quantile(0.99, "ttft"),
        }

    # -- the loop ----------------------------------------------------------
    def tick(self) -> List[Dict[str, Any]]:
        now = self._clock()
        if self._last_tick is not None:
            live = sum(1 for r in self.router.replicas.values()
                       if r.state in ("active", "draining"))
            self.replica_seconds += live * max(0.0, now - self._last_tick)
        self._last_tick = now
        done: List[Dict[str, Any]] = []
        for role in self.roles:
            done.extend(self._tick_role(role, now))
        self._complete_drains(now, done)
        metrics.set_gauge("tpu_hive_fleet_target_replicas",
                          sum(self.target.values()) if self.target else
                          sum(1 for r in self.router.replicas.values()
                              if r.state == "active"))
        self.actions.extend(done)
        return done

    def _tick_role(self, role: str, now: float) -> List[Dict[str, Any]]:
        p = self.policy
        sig = self.signals(role)
        n = sig["replicas"]
        self.target.setdefault(role, max(p.min_replicas, n))
        up_pressure = (
            sig["occupancy"] > p.occ_high
            or sig["queueDepth"] > p.queue_high * max(1, n)
            or (p.ttft_ceiling_s > 0 and sig["ttftP95"] > p.ttft_ceiling_s)
        )
        down_pressure = (
            sig["occupancy"] < p.occ_low and sig["queueDepth"] == 0
        )
        self._up[role] = self._up[role] + 1 if up_pressure else 0
        self._down[role] = self._down[role] + 1 if down_pressure else 0
        out: List[Dict[str, Any]] = []
        if now - self._last_action[role] < self._cooldown:
            return out
        if (self._up[role] >= p.up_stable_ticks and n < p.max_replicas
                and role not in self._pending_down):
            reason = ("occupancy" if sig["occupancy"] > p.occ_high else
                      "queue" if sig["queueDepth"] > p.queue_high * max(1, n)
                      else "ttft")
            handle = self.backend.grow(role)
            if handle is None:
                # no capacity granted: the grow stays pending and is
                # retried next tick
                out.append({"role": role, "direction": "up",
                            "phase": "pending", "reason": reason})
                if obs_journal.JOURNAL.enabled:
                    obs_journal.emit("fleet_scale", f"fleetrole/{role}",
                                     direction="up", phase="pending",
                                     reason=reason)
                return out
            name, engine, gang = handle
            self.router.add_replica(name, engine, role=role, gang=gang)
            self.target[role] = n + 1
            self._last_action[role] = now
            self._up[role] = 0
            metrics.inc("tpu_hive_fleet_scale_events_total", direction="up")
            if obs_journal.JOURNAL.enabled:
                obs_journal.emit("fleet_scale", f"fleetrole/{role}",
                                 direction="up", phase="added",
                                 replica=name, reason=reason)
            log.info("fleet autoscaler: %s scaled up to %d (%s; occ %.2f, "
                     "queue %d)", role, n + 1, reason, sig["occupancy"],
                     sig["queueDepth"])
            out.append({"role": role, "direction": "up", "phase": "added",
                        "replica": name, "reason": reason})
        elif (self._down[role] >= p.down_stable_ticks
                and n > p.min_replicas and role not in self._pending_down):
            reps = self._role_replicas(role)
            victim = min(reps, key=lambda r: (r.outstanding_blocks(),
                                              r.name))
            self.router.begin_drain(victim.name)
            self._pending_down[role] = victim.name
            self.target[role] = n - 1
            self._last_action[role] = now
            self._down[role] = 0
            metrics.inc("tpu_hive_fleet_scale_events_total",
                        direction="down")
            if obs_journal.JOURNAL.enabled:
                obs_journal.emit("fleet_scale", f"fleetrole/{role}",
                                 direction="down", phase="draining",
                                 replica=victim.name, reason="idle")
            log.info("fleet autoscaler: %s draining %s toward %d replicas",
                     role, victim.name, n - 1)
            out.append({"role": role, "direction": "down",
                        "phase": "draining", "replica": victim.name,
                        "reason": "idle"})
        return out

    def _complete_drains(self, now: float,
                         out: List[Dict[str, Any]]) -> None:
        for role, name in list(self._pending_down.items()):
            rep = self.router.replicas.get(name)
            if rep is None:
                del self._pending_down[role]
                continue
            if rep.state != "drained":
                continue
            self.backend.shrink(role, rep)
            self.router.remove_replica(name)
            del self._pending_down[role]
            if obs_journal.JOURNAL.enabled:
                obs_journal.emit("fleet_scale", f"fleetrole/{role}",
                                 direction="down", phase="removed",
                                 replica=name)
            log.info("fleet autoscaler: %s removed drained replica %s",
                     role, name)
            out.append({"role": role, "direction": "down",
                        "phase": "removed", "replica": name})
