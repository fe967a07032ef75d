"""Cross-replica request router with prefill/decode disaggregation.

A copy of ``hivedscheduler_tpu/fleet/router.py`` bound to the port's
engines (``models.serving.ServingEngine`` and its speculative subclass),
the port's journal, SLO tracker, metrics registry and ``lockcheck``.

``FleetRouter`` is the layer between user traffic and N per-replica
engines. Each replica is an engine plus its scheduler gang identity and a
role (``serve`` for a unified replica, ``prefill`` / ``decode`` in
disaggregated mode). The router:

- **routes** each request by a policy: ``least_blocks`` (default) picks
  the replica with the fewest outstanding KV blocks (live pool blocks +
  queued prompt cover, the paged engine's admission currency);
  ``prefix_affinity`` first consults a content-hash prefix index keyed on
  the engine's own prefix-cache boundaries, routing to the replica whose
  cache holds the prompt's leading chunk, and falls back to least-blocks;
- **retries** shed/preempted/lost requests on another replica, up to
  ``max_retries``: the stream restarts from scratch, and a greedy stream
  is a pure function of (params, prompt), so the retry is token-exact;
- **disaggregates** prefill from decode (``disaggregate=True``): a prefill
  leg (a budget-1 submit, which also fills that replica's prefix cache)
  on a prefill-role replica, then a decode leg on a decode-role replica.
  ``HIVED_FLEET_KV_SHIP`` selects the handoff: ``1`` (default) ships the
  prefix payload host-side (``ServingEngine.export_prefix`` /
  ``import_prefix``) and the decode leg hits the imported prefix; ``0``
  re-prefills on the decode side through its own prefix cache, with roles
  routed blind so no replica idles. Both are token-exact against
  single-replica serving.

Concurrency: ONE thread drives the router (``submit``/``step``), as it
drives the engines; ``fleet_router_lock``, a leaf above only the
observability leaves, guards the bookkeeping so a snapshot can be read
concurrently.

Chaos invariants (``chaos.invariants.check_fleet``): no request lost
between shed and retry, no double-routed stream, drain before teardown,
no orphaned blocks after a handoff.

Observability: with the journal on, every fleet request is a flight
(``fleet/<fid>``): the router marks the ``route``, ``router_queue``,
``retry``, ``handoff_ship`` and ``handoff_import`` legs, the engines mark
``admission_wait`` and ``prefill``/``first_decode``, and the legs up to
the first token sum to ``ttft_s`` (``chaos.invariants.check_requests``).
Every finished request is observed into ``self.slo`` with its dominant
leg; the autoscaler's TTFT pressure reads the same tracker.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

from hivedscheduler_tpu_torch.common import envflags, lockcheck
from hivedscheduler_tpu_torch.models.serving import (
    EngineDraining,
    Request,
    ServingEngine,
    SpeculativeServingEngine,
)
from hivedscheduler_tpu_torch.obs import journal as obs_journal
from hivedscheduler_tpu_torch.obs import slo as obs_slo
from hivedscheduler_tpu_torch.runtime.metrics import REGISTRY as metrics

_POLICIES = ("least_blocks", "prefix_affinity")
_RETRYABLE = ("shed", "preempted")


def kv_ship_enabled() -> bool:
    """``HIVED_FLEET_KV_SHIP``: ``0`` selects re-prefill-on-miss instead
    of host-side KV shipping for the disaggregated handoff."""
    return envflags.get("HIVED_FLEET_KV_SHIP", "1") != "0"


class Replica:
    """One serving replica: an engine + its scheduler gang identity.

    ``state`` lifecycle: ``active`` -> (``draining`` -> ``drained``) |
    ``dead``. Only ``active`` replicas receive new routes; ``draining``
    replicas finish their in-flight work (work-preserving scale-down);
    ``dead`` is the chaos/abrupt-loss state — streams that were on a dead
    replica are retried elsewhere by the router."""

    def __init__(self, name: str, engine: ServingEngine, role: str = "serve",
                 gang: str = ""):
        self.name = name
        self.engine = engine
        self.role = role
        self.gang = gang or name
        self.state = "active"
        self.routed = 0  # legs dispatched here, lifetime

    def outstanding_blocks(self) -> int:
        """Outstanding work in KV blocks — the least-loaded routing key.
        Paged: live pool blocks + queued prompts' block cover (+1 decode
        headroom each, mirroring the admission gate). Dense: resident +
        queued tokens at a 16-token pseudo-block granularity, so mixed
        fleets still order sensibly."""
        eng = self.engine
        if getattr(eng, "paged", False):
            bs = eng.page_size
            queued = sum(-(-len(r.prompt) // bs) + 1 for r in eng.queue)
            return eng.blocks_in_use + queued
        tokens = sum(len(r.prompt) + len(r.tokens_out)
                     for r in eng.slots if r is not None)
        tokens += sum(len(r.prompt) for r in eng.queue)
        return -(-tokens // 16)

    def has_work(self) -> bool:
        eng = self.engine
        return bool(eng.queue) or any(s is not None for s in eng.slots)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "role": self.role, "gang": self.gang,
            "state": self.state, "routed": self.routed,
            "outstandingBlocks": self.outstanding_blocks(),
            "queueDepth": len(self.engine.queue),
            "activeSlots": sum(
                s is not None for s in self.engine.slots),
        }


@dataclasses.dataclass
class FleetRequest:
    """User-visible handle for one fleet request. ``attempts`` lists every
    (replica, engine-Request) decode leg dispatched — the LAST entry is
    the authoritative stream (earlier ones were shed/preempted/lost and
    retried); ``handoff`` holds the in-flight disaggregated prefill leg.
    Invariant (check_fleet): a live request has exactly one of a live
    handoff or a live last attempt — never neither (lost) nor both
    (double-routed)."""

    fid: int
    prompt: List[int]
    max_new_tokens: int
    priority: int = 0
    submitted_at: float = 0.0
    done: bool = False
    finish_reason: Optional[str] = None
    tokens_out: List[int] = dataclasses.field(default_factory=list)
    retries: int = 0
    replica: Optional[str] = None  # authoritative decode replica
    attempts: List[Tuple[str, Request]] = dataclasses.field(
        default_factory=list)
    handoff: Optional[Dict[str, Any]] = None
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None

    @property
    def ttft_s(self) -> Optional[float]:
        """Fleet-level TTFT: earliest first token over every leg (in ship
        mode the prefill leg's first token IS the request's first token —
        greedy legs agree on it, so serving it early is legitimate)."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at

    @property
    def tpot_s(self) -> Optional[float]:
        """Mean seconds per output token after the first (None until done
        or when only one token was emitted) — the fleet twin of
        ``Request.tpot_s``, observed into the SLO tracker."""
        if self.done_at is None or self.first_token_at is None:
            return None
        n = len(self.tokens_out) - 1
        if n <= 0:
            return None
        return (self.done_at - self.first_token_at) / n


class FleetRouter:
    """See the module docstring. Engines must be config-identical
    (same TransformerConfig/page_size/kv_dtype) for the KV handoff and
    for the token-exactness of retries; the constructor of each replica
    is the caller's business (``add_replica`` takes a built engine)."""

    def __init__(self, policy: str = "least_blocks",
                 disaggregate: bool = False,
                 kv_ship: Optional[bool] = None,
                 max_retries: int = 2,
                 affinity_index_cap: int = 4096,
                 slo: Optional[obs_slo.SLOTracker] = None,
                 clock=time.perf_counter):
        if policy not in _POLICIES:
            raise ValueError(f"unknown routing policy {policy!r} "
                             f"(choose from {_POLICIES})")
        self._lock = lockcheck.make_lock("fleet_router_lock")
        self._clock = clock
        self.policy = policy
        self.disaggregate = disaggregate
        self.kv_ship = kv_ship_enabled() if kv_ship is None else kv_ship
        self.max_retries = max_retries
        self.replicas: Dict[str, Replica] = {}
        self.removed: List[Replica] = []
        self.requests: List[FleetRequest] = []
        self._next_fid = 0
        # content-hash prefix index: hash(prompt[:boundary]) -> replica
        # name whose prefix cache holds that chunk (bounded, LRU-evicted;
        # a stale/colliding entry only costs a suboptimal route, never
        # correctness)
        self._prefix_index: "OrderedDict[int, str]" = OrderedDict()
        self._index_cap = affinity_index_cap
        self.handoffs = {"ship": 0, "miss": 0, "reprefill": 0}
        self.retried = 0
        self.affinity_hits = 0
        # windowed TTFT/TPOT observations + declared-objective accounting
        # (obs/slo.py): the autoscaler's up-pressure signal, the CLI's SLO
        # lines and the tpu_hive_slo_* exposition are all THIS tracker —
        # one computation, one number
        self.slo = slo if slo is not None else obs_slo.SLOTracker(
            clock=clock)

    # -- replica lifecycle -------------------------------------------------
    def add_replica(self, name: str, engine: ServingEngine,
                    role: str = "serve", gang: str = "") -> Replica:
        if role not in ("serve", "prefill", "decode"):
            raise ValueError(f"unknown replica role {role!r}")
        if self.disaggregate and self.kv_ship:
            if isinstance(engine, SpeculativeServingEngine):
                raise ValueError(
                    "KV shipping across replicas does not support the "
                    "speculative engine; run the fleet with "
                    "HIVED_FLEET_KV_SHIP=0 (re-prefill-on-miss)"
                )
            if engine.prefix_cache_size <= 0:
                raise ValueError(
                    "disaggregated KV shipping needs prefix_cache_size > 0 "
                    "on every replica (the handoff payload travels through "
                    "the prefix cache)"
                )
        with self._lock:
            if name in self.replicas:
                raise ValueError(f"replica {name!r} already exists")
            rep = Replica(name, engine, role=role, gang=gang)
            self.replicas[name] = rep
            self._update_gauge_locked()
        return rep

    def begin_drain(self, name: str) -> None:
        """Work-preserving scale-down, step 1: stop routing to the
        replica and flip its engine's admission off; in-flight work keeps
        running until ``step()`` observes it drained."""
        with self._lock:
            rep = self.replicas.get(name)
            if rep is not None and rep.state == "active":
                rep.state = "draining"
                rep.engine.begin_drain()

    def kill(self, name: str) -> None:
        """Chaos/abrupt replica loss: the engine's in-flight streams are
        gone; the next ``step()`` retries their fleet requests on other
        replicas (the no-request-lost invariant)."""
        with self._lock:
            rep = self.replicas.get(name)
            if rep is not None:
                rep.state = "dead"
                self._update_gauge_locked()

    def remove_replica(self, name: str) -> None:
        """Teardown, step 2: only a drained or dead replica may be
        removed — drain-before-teardown on every scale-down is a
        check_fleet invariant, not a convention."""
        with self._lock:
            rep = self.replicas.get(name)
            if rep is None:
                return
            if rep.state not in ("drained", "dead"):
                raise ValueError(
                    f"scale-down must drain before teardown: replica "
                    f"{name!r} is {rep.state!r} (begin_drain + step until "
                    f"drained first)"
                )
            del self.replicas[name]
            self.removed.append(rep)
            for h, rname in list(self._prefix_index.items()):
                if rname == name:
                    del self._prefix_index[h]
            self._update_gauge_locked()

    def _update_gauge_locked(self) -> None:
        metrics.set_gauge(
            "tpu_hive_fleet_replicas",
            sum(1 for r in self.replicas.values()
                if r.state in ("active", "draining")))

    # -- routing -----------------------------------------------------------
    def _candidates_locked(self, leg: str, exclude=()) -> List[Replica]:
        role_blind = not self.disaggregate or not self.kv_ship
        return [
            r for r in self.replicas.values()
            if r.state == "active" and r.name not in exclude
            and (role_blind or r.role in (leg, "serve"))
        ]

    def _boundaries(self, prompt: List[int], engine) -> List[int]:
        """Chunk boundaries of the prefix index — the same rule the
        engine's ``_store_prefix`` keys on (block-aligned for paged,
        power-of-two for dense), so an index hit really names a cached
        chunk."""
        pl = len(prompt)
        out = [pl]
        if getattr(engine, "paged", False):
            b = engine.page_size
            while b < pl:
                out.append(b)
                b += engine.page_size
        else:
            b = 2
            while b < pl:
                out.append(b)
                b <<= 1
        return sorted(set(out), reverse=True)

    def _register_affinity_locked(self, prompt: List[int],
                                  rep: Replica) -> None:
        if rep.engine.prefix_cache_size <= 0:
            return
        for b in self._boundaries(prompt, rep.engine):
            key = hash(tuple(prompt[:b]))
            self._prefix_index.pop(key, None)
            self._prefix_index[key] = rep.name
        while len(self._prefix_index) > self._index_cap:
            self._prefix_index.popitem(last=False)

    def _pick_locked(self, prompt: List[int], leg: str,
                     exclude=()) -> Optional[Replica]:
        cands = self._candidates_locked(leg, exclude)
        if not cands:
            return None
        if self.policy == "prefix_affinity":
            by_name = {r.name: r for r in cands}
            for b in self._boundaries(prompt, cands[0].engine):
                name = self._prefix_index.get(hash(tuple(prompt[:b])))
                if name in by_name:
                    self.affinity_hits += 1
                    metrics.inc("tpu_hive_fleet_prefix_affinity_hits_total")
                    return by_name[name]
        return min(cands, key=lambda r: (r.outstanding_blocks(), r.routed,
                                         r.name))

    # -- request lifecycle -------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int,
               priority: int = 0) -> FleetRequest:
        with self._lock:
            freq = FleetRequest(self._next_fid, list(prompt),
                                max_new_tokens, priority=priority,
                                submitted_at=self._clock())
            self._next_fid += 1
            self.requests.append(freq)
            if obs_journal.JOURNAL.enabled:
                obs_journal.note_request_submit(
                    f"fleet/{freq.fid}", at=freq.submitted_at,
                    priority=priority, promptTokens=len(freq.prompt))
            self._dispatch_locked(freq)
        return freq

    def _dispatch_locked(self, freq: FleetRequest, exclude=()) -> None:
        if self.disaggregate and self.kv_ship:
            pre = self._pick_locked(freq.prompt, "prefill", exclude)
            if pre is not None:
                try:
                    req = pre.engine.submit(list(freq.prompt), 1,
                                            priority=freq.priority)
                except EngineDraining:
                    pre.state = "draining"  # drained out-of-band: honor it
                    self._dispatch_locked(freq, tuple(exclude) + (pre.name,))
                    return
                pre.routed += 1
                freq.handoff = {"replica": pre.name, "req": req}
                if obs_journal.JOURNAL.enabled:
                    req.flight = f"fleet/{freq.fid}"
                    obs_journal.note_leg(f"fleet/{freq.fid}", "route",
                                         at=req.submitted_at,
                                         replica=pre.name)
                    obs_journal.emit("fleet_route", f"fleet/{freq.fid}",
                                     leg="prefill", replica=pre.name,
                                     policy=self.policy)
                return
            # no prefill replica left: degrade to a re-prefill decode leg
        if self.disaggregate and not self.kv_ship:
            # the re-prefill-on-miss handoff mode: the decode leg carries
            # the whole request and re-prefills through its own cache
            self.handoffs["reprefill"] += 1
            metrics.inc("tpu_hive_fleet_handoffs_total", mode="reprefill")
            if obs_journal.JOURNAL.enabled:
                obs_journal.emit("fleet_handoff", f"fleet/{freq.fid}",
                                 mode="reprefill")
        self._dispatch_decode_locked(freq, exclude)

    def _dispatch_decode_locked(self, freq: FleetRequest, exclude=(),
                                cause: Optional[int] = None,
                                prefer: Optional[Replica] = None,
                                imported: bool = False) -> None:
        dec = prefer
        if dec is None or dec.state != "active" or dec.name in exclude:
            dec = self._pick_locked(freq.prompt, "decode", exclude)
        if dec is None:
            freq.done = True
            freq.finish_reason = "no_replica"
            freq.done_at = self._clock()
            metrics.inc("tpu_hive_fleet_requests_total",
                        outcome="no_replica")
            self._finish_flight_locked(freq)
            return
        try:
            req = dec.engine.submit(list(freq.prompt), freq.max_new_tokens,
                                    priority=freq.priority)
        except EngineDraining:
            dec.state = "draining"
            self._dispatch_decode_locked(freq,
                                         tuple(exclude) + (dec.name,),
                                         cause=cause, imported=imported)
            return
        dec.routed += 1
        freq.attempts.append((dec.name, req))
        freq.replica = dec.name
        self._register_affinity_locked(freq.prompt, dec)
        if obs_journal.JOURNAL.enabled:
            # the leg's engine marks (admission_wait + prefill/
            # first_decode) attribute into this fleet flight; ``imported``
            # legs resume from a shipped prefix, so their first token is
            # the `first_decode` leg, not a full `prefill`
            req.flight = f"fleet/{freq.fid}"
            req.flight_decode = imported
            obs_journal.note_leg(f"fleet/{freq.fid}", "route",
                                 at=req.submitted_at, cause=cause,
                                 replica=dec.name)
            obs_journal.emit("fleet_route", f"fleet/{freq.fid}",
                             cause=cause, leg="decode", replica=dec.name,
                             policy=self.policy)

    # -- the engine tick ---------------------------------------------------
    def step(self) -> bool:
        """Step every live replica's engine once, then advance handoffs,
        harvest finished legs (retrying shed/preempted/lost streams), and
        advance drains. Returns whether any fleet work remains."""
        with self._lock:
            reps = list(self.replicas.values())
        for rep in reps:
            if rep.state != "dead" and rep.has_work():
                rep.engine.step()
        with self._lock:
            self._advance_handoffs_locked()
            self._harvest_locked()
            self._advance_drains_locked()
            return any(not f.done for f in self.requests)

    def run_until_drained(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if not self.step():
                return
        raise RuntimeError(f"fleet did not drain in {max_steps} steps")

    def _leg_cause_locked(self, req: Request) -> Optional[int]:
        if not obs_journal.JOURNAL.enabled:
            return None
        return obs_journal.JOURNAL.last_id(f"serve/{req.rid}")

    def _advance_handoffs_locked(self) -> None:
        for freq in self.requests:
            if freq.done or freq.handoff is None:
                continue
            h = freq.handoff
            rep = self.replicas.get(h["replica"])
            req = h["req"]
            if rep is None or rep.state == "dead":
                # prefill replica lost mid-handoff: restart the dispatch
                freq.handoff = None
                freq.retries += 1
                self.retried += 1
                metrics.inc("tpu_hive_fleet_retries_total", leg="prefill")
                if obs_journal.JOURNAL.enabled:
                    # re-attribution: the lost leg's whole interval lands
                    # in `retry` — nothing between shed and retry is lost
                    obs_journal.note_leg(f"fleet/{freq.fid}", "retry",
                                         at=self._clock(),
                                         fromReplica=h["replica"],
                                         reason="replica_lost")
                    obs_journal.emit("fleet_retry", f"fleet/{freq.fid}",
                                     leg="prefill",
                                     fromReplica=h["replica"],
                                     reason="replica_lost")
                self._dispatch_locked(freq, (h["replica"],))
                continue
            if not req.done:
                continue
            cause = self._leg_cause_locked(req)
            freq.handoff = None
            journaled = obs_journal.JOURNAL.enabled
            if req.finish_reason in _RETRYABLE:
                # the prefill leg itself was shed/preempted: re-prefill on
                # the decode side (counted as a miss — no KV crossed)
                if journaled:
                    obs_journal.note_leg(f"fleet/{freq.fid}", "retry",
                                         at=self._clock(), cause=cause,
                                         fromReplica=rep.name,
                                         reason=req.finish_reason)
                mode, prefer = "miss", None
            else:
                if freq.first_token_at is None:
                    freq.first_token_at = req.first_token_at
                if journaled:
                    # the gap between the prefill leg finishing and THIS
                    # router step picking the handoff up
                    obs_journal.note_leg(f"fleet/{freq.fid}",
                                         "router_queue",
                                         at=self._clock(), cause=cause)
                prefer = self._pick_locked(freq.prompt, "decode")
                exp = rep.engine.export_prefix(freq.prompt)
                if journaled:
                    obs_journal.note_leg(f"fleet/{freq.fid}",
                                         "handoff_ship", at=self._clock(),
                                         fromReplica=rep.name,
                                         hit=exp is not None)
                if exp is not None and prefer is not None:
                    pkey, plen, data = exp
                    prefer.engine.import_prefix(pkey, plen, data)
                    self._register_affinity_locked(list(pkey), prefer)
                    if journaled:
                        obs_journal.note_leg(f"fleet/{freq.fid}",
                                             "handoff_import",
                                             at=self._clock(),
                                             toReplica=prefer.name,
                                             prefixTokens=plen)
                    mode = "ship"
                else:
                    mode = "miss"
            self.handoffs[mode] += 1
            metrics.inc("tpu_hive_fleet_handoffs_total", mode=mode)
            if journaled:
                obs_journal.emit("fleet_handoff", f"fleet/{freq.fid}",
                                 cause=cause, mode=mode,
                                 fromReplica=rep.name)
            self._dispatch_decode_locked(freq, cause=cause, prefer=prefer,
                                         imported=mode == "ship")

    def _harvest_locked(self) -> None:
        for freq in self.requests:
            if freq.done or freq.handoff is not None or not freq.attempts:
                continue
            rep_name, req = freq.attempts[-1]
            rep = self.replicas.get(rep_name)
            lost = (rep is None or rep.state == "dead") and not (
                req.done and req.finish_reason in ("eos", "length"))
            if lost:
                reason = "preempted"
                if not req.done:
                    # finalize the orphaned leg: its engine died with it
                    # (check_fleet pins that only the LAST attempt may be
                    # live)
                    req.done = True
                    req.done_at = self._clock()
                    req.finish_reason = "preempted"
            elif req.done:
                reason = req.finish_reason
            else:
                if freq.first_token_at is None and req.first_token_at:
                    freq.first_token_at = req.first_token_at
                continue
            if reason in _RETRYABLE and freq.retries < self.max_retries:
                alt = self._pick_locked(freq.prompt, "decode",
                                        exclude=(rep_name,))
                if alt is not None:
                    freq.retries += 1
                    self.retried += 1
                    metrics.inc("tpu_hive_fleet_retries_total", leg="decode")
                    cause = self._leg_cause_locked(req)
                    if obs_journal.JOURNAL.enabled:
                        obs_journal.note_leg(f"fleet/{freq.fid}", "retry",
                                             at=self._clock(), cause=cause,
                                             fromReplica=rep_name,
                                             reason=reason)
                        obs_journal.emit("fleet_retry", f"fleet/{freq.fid}",
                                         cause=cause, leg="decode",
                                         fromReplica=rep_name,
                                         reason=reason)
                    # the truncated stream is discarded whole: a greedy
                    # re-run emits the identical tokens from scratch
                    self._dispatch_decode_locked(freq, (rep_name,),
                                                 cause=cause, prefer=alt)
                    continue
            freq.done = True
            freq.finish_reason = reason
            freq.tokens_out = list(req.tokens_out)
            freq.done_at = self._clock()
            if freq.first_token_at is None:
                firsts = [r.first_token_at for _n, r in freq.attempts
                          if r.first_token_at is not None]
                freq.first_token_at = min(firsts) if firsts else None
            self._finish_flight_locked(freq)
            metrics.inc("tpu_hive_fleet_requests_total", outcome=reason)

    def _finish_flight_locked(self, freq: FleetRequest) -> None:
        """ONE home for a fleet request's terminal: close the journal
        flight (the sum-to-ttft accounting happens there) and observe the
        request into the SLO tracker with its dominant-leg attribution —
        the autoscaler's signal and the CLI's SLO lines both read that
        tracker."""
        dom = ""
        if obs_journal.JOURNAL.enabled:
            key = f"fleet/{freq.fid}"
            obs_journal.note_request_done(
                key, freq.finish_reason,
                first_token_at=freq.first_token_at, at=freq.done_at,
                retries=freq.retries, tokensOut=len(freq.tokens_out))
            dom = obs_journal.JOURNAL.request_dominant_leg(key)
        if freq.ttft_s is not None:
            self.slo.observe("ttft", freq.ttft_s, priority=freq.priority,
                             leg=dom, at=freq.done_at)
        if freq.tpot_s is not None:
            self.slo.observe("tpot", freq.tpot_s, priority=freq.priority,
                             leg=dom, at=freq.done_at)

    def _advance_drains_locked(self) -> None:
        for rep in self.replicas.values():
            if rep.state == "draining" and not rep.has_work():
                rep.state = "drained"

    # -- read API (copy-on-read) -------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            live = [f for f in self.requests if not f.done]
            done = [f for f in self.requests if f.done]
            outcomes: Dict[str, int] = {}
            for f in done:
                outcomes[f.finish_reason] = outcomes.get(
                    f.finish_reason, 0) + 1
            return {
                "policy": self.policy,
                "disaggregate": self.disaggregate,
                "kvShip": self.kv_ship,
                "replicas": [r.to_dict() for r in self.replicas.values()],
                "removedReplicas": [
                    {"name": r.name, "state": r.state, "role": r.role}
                    for r in self.removed],
                "requests": {
                    "live": len(live), "done": len(done),
                    "outcomes": outcomes,
                    "inHandoff": sum(1 for f in live
                                     if f.handoff is not None),
                },
                "handoffs": dict(self.handoffs),
                "retries": self.retried,
                "affinityHits": self.affinity_hits,
                "prefixIndexSize": len(self._prefix_index),
            }


# -- module-level publication -----------------------------------------------
_PUBLISHED: Optional[FleetRouter] = None


def publish(router: Optional[FleetRouter]) -> None:
    """Make ``router`` the process's inspectable fleet (the reference's
    ``GET /v1/inspect/fleet`` reads it); ``None`` unpublishes."""
    global _PUBLISHED
    _PUBLISHED = router


def published() -> Optional[FleetRouter]:
    return _PUBLISHED
