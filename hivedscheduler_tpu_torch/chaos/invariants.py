"""From-scratch invariant checks of the workload's host books.

Copies of ``check_block_pool``, ``check_journal`` and ``check_goodput``
from ``hivedscheduler_tpu/chaos/invariants.py`` (the scheduler checks of
that module stay with the control plane), with their own
:class:`InvariantViolation`. ``check_block_pool`` reads only the engine's
host books (``paged``, ``num_blocks``, ``slots``, ``_slot_bids``,
``_table``, ``_prefix_cache``, ``_entry_bids``, ``_free``, ``_ref``),
which the port's engine keeps under the reference's names, so either
package's checker audits either engine. ``check_fleet`` and
``check_requests`` audit the port's fleet router (``fleet/router.py``)
and its request flights in the journal.
"""

from __future__ import annotations

from typing import Dict, Optional


class InvariantViolation(AssertionError):
    """A structural guarantee of the workload's books was broken."""


def _fail(ctx: str, msg: str) -> None:
    raise InvariantViolation(f"{ctx}: {msg}" if ctx else msg)


def check_block_pool(engine, ctx: str = "") -> None:
    """The free list and refcounts of a paged engine must equal a recount
    over every holder: no leak, no double-alloc.

    - block 0 (trash) is never allocated, never refcounted, never free;
    - every other block is either free with refcount 0 or referenced, its
      refcount the number of slot tables plus prefix-cache entries naming
      it;
    - the free list holds no duplicates;
    - each slot's table row is exactly its bids followed by trash zeros (the
      decode reads the table, so a drifted row would mis-address KV);
    - a retired slot holds no blocks.

    No-op for a dense engine. Raises :class:`InvariantViolation`.
    """
    if not getattr(engine, "paged", False):
        return
    n = engine.num_blocks
    counts = [0] * n
    for slot, bids in enumerate(engine._slot_bids):
        if engine.slots[slot] is None and bids:
            _fail(ctx, f"retired slot {slot} still holds blocks {bids}")
        for bid in bids:
            if not 1 <= bid < n:
                _fail(ctx, f"slot {slot} holds out-of-range block {bid}")
            counts[bid] += 1
        row = [int(b) for b in engine._table[slot]]
        want = bids + [0] * (len(row) - len(bids))
        if row != want:
            _fail(ctx, f"slot {slot} table row {row} != owned bids {want}")
    for key, (payload, _plen) in engine._prefix_cache.items():
        for bid in engine._entry_bids(payload):
            if not 1 <= bid < n:
                _fail(ctx, f"cache entry {key!r} names out-of-range block {bid}")
            counts[bid] += 1
    free = list(engine._free)
    if len(set(free)) != len(free):
        _fail(ctx, f"free list has duplicates: {sorted(free)}")
    if 0 in free or counts[0] or engine._ref[0]:
        _fail(ctx, "trash block 0 entered the allocator")
    free_set = set(free)
    for bid in range(1, n):
        if int(engine._ref[bid]) != counts[bid]:
            _fail(ctx, f"block {bid}: refcount {int(engine._ref[bid])} != "
                       f"recount {counts[bid]}")
        if counts[bid] == 0 and bid not in free_set:
            _fail(ctx, f"block {bid} leaked: unreferenced but not free")
        if counts[bid] > 0 and bid in free_set:
            _fail(ctx, f"block {bid} double-allocated: referenced AND free")


def check_journal(journal=None, ctx: str = "") -> None:
    """Structural invariants of the event journal (obs/journal.py).
    No-op when the journal is disabled:

    - **Causal integrity**: every event's ``cause`` points BACKWARD to an
      event id that is retained (the ring evicts oldest-first, so retained
      ids are contiguous — a cause inside the retained range that is
      missing, or a cause >= its own event id, is an orphan/cycle).
    - **Complete lifecycles**: a terminal event (``released`` /
      ``serve_finish`` / ``serve_shed``) requires an open episode — an
      opening event for the same gang after its previous terminal. Two
      terminals with no re-open between them is a duplicate close. The
      open-before-close direction is only enforced while the ring has
      never evicted (a wrapped ring may have dropped the opener).
    """
    from hivedscheduler_tpu_torch.obs import journal as obs_journal

    j = journal if journal is not None else obs_journal.JOURNAL
    if not j.enabled:
        return
    events = j.snapshot()
    if not events:
        return
    ids = {e.id for e in events}
    min_id = min(ids)
    terminal_types = {"released", "serve_finish", "serve_shed"}
    full_history = j.evicted == 0
    open_state: Dict[str, Optional[bool]] = {}  # gang -> episode open?
    for e in events:
        if e.cause is not None:
            if e.cause >= e.id:
                _fail(ctx, f"journal event {e.id} ({e.type}, gang {e.gang}) "
                           f"names a non-backward cause {e.cause}")
            if e.cause >= min_id and e.cause not in ids:
                _fail(ctx, f"journal event {e.id} ({e.type}, gang {e.gang}) "
                           f"has an orphan cause {e.cause} — the cause id "
                           f"is inside the retained range but missing")
        is_open = open_state.get(e.gang)
        if e.type in terminal_types:
            if is_open is False:
                _fail(ctx, f"journal gang {e.gang}: duplicate terminal "
                           f"event {e.type} (id {e.id}) with no re-open "
                           f"since the previous close")
            if is_open is None and full_history:
                _fail(ctx, f"journal gang {e.gang}: terminal event "
                           f"{e.type} (id {e.id}) with no opening event — "
                           f"incomplete open->close lifecycle")
            open_state[e.gang] = False
        else:
            open_state[e.gang] = True


def check_goodput(goodput=None, ctx: str = "",
                  at: Optional[float] = None) -> None:
    """Structural invariants of the workload goodput ledger
    (obs/goodput.py). No-op while disabled:

    - **Conservation**: the per-phase seconds — closed intervals plus
      the open phase measured to ``at`` — sum to the process wallclock
      since ``start()``. A lost or double-opened interval breaks the
      telescoping sum and trips here.
    - **Registered phases only**: no accumulated time in a phase missing
      from ``STEP_PHASES``.
    - **Exactly one open phase**: once started and not yet closed, the
      workload is always *in* a phase.

    The cross-process form, per-incarnation conservation from a shared
    ``--goodput-file`` spool, is ``goodput.check_spool``."""
    from hivedscheduler_tpu_torch.obs import goodput as obs_goodput

    g = goodput if goodput is not None else obs_goodput.GOODPUT
    if not g.enabled:
        return
    t = g._now(at)
    totals = g.totals(t)
    for phase in totals:
        if phase not in obs_goodput.STEP_PHASES:
            _fail(ctx, f"goodput accumulator carries unregistered step "
                       f"phase {phase!r}")
    wall = g.wallclock(t)
    got = sum(totals.values())
    if abs(got - wall) > 1e-6 * max(1.0, wall):
        _fail(ctx, f"goodput conservation broken: phases sum to {got!r}s "
                   f"but the process wallclock is {wall!r}s — an interval "
                   f"was lost or double-opened")
    if wall > 0 and not g._closed and g.current_phase() is None:
        _fail(ctx, "goodput ledger started but in no phase — the "
                   "workload must be in exactly one STEP_PHASES phase "
                   "at every instant")


def check_fleet(router, ctx: str = "") -> None:
    """Structural invariants of the serving-fleet router
    (fleet/router.py), re-derived from its bookkeeping:

    - **No request lost between shed and retry**: every non-done
      FleetRequest has exactly one live leg — an in-flight handoff on a
      live replica, or a last decode attempt whose replica is live (a
      dead replica's streams must be retried or finished, never
      forgotten).
    - **No double-routed stream**: at most one undone engine Request
      across a fleet request's attempts (the last one); earlier attempts
      were all finished (shed/preempted/truncated) before the retry.
    - **Drain-before-teardown**: every removed replica left in state
      ``drained`` or ``dead`` — an active/draining replica was never
      torn down (work-preserving scale-down), and a drained replica's
      engine really holds no work.
    - **Handoff never leaves orphaned blocks**: every live replica's
      paged block pool passes :func:`check_block_pool` (imported handoff
      blocks are refcounted prefix-cache entries, so a leak shows as a
      refcount/recount mismatch).
    - **Prefix-index hygiene**: every index entry names a live replica.

    Call at quiescent points (between ``step()`` calls — the same
    contract as the scheduler checks)."""
    for freq in router.requests:
        live_handoff = 0
        if freq.handoff is not None:
            rep = router.replicas.get(freq.handoff["replica"])
            if rep is not None and rep.state != "dead":
                live_handoff = 1
        undone = [(name, r) for name, r in freq.attempts if not r.done]
        live_attempts = [
            (name, r) for name, r in undone
            if name in router.replicas
            and router.replicas[name].state != "dead"
        ]
        if len(undone) > 1 or (undone and undone[-1][1]
                               is not freq.attempts[-1][1]):
            _fail(ctx, f"fleet request {freq.fid} is double-routed: "
                       f"undone attempts on {[n for n, _ in undone]} "
                       f"(only the LAST attempt may be live)")
        if freq.done:
            continue
        legs = live_handoff + len(live_attempts)
        if freq.handoff is None and not freq.attempts:
            _fail(ctx, f"fleet request {freq.fid} has neither a handoff "
                       f"nor any attempt — never dispatched")
        if legs == 0:
            _fail(ctx, f"fleet request {freq.fid} lost: not done, no live "
                       f"handoff, no live attempt (last attempt on "
                       f"{freq.attempts[-1][0] if freq.attempts else None})")
        if legs > 1:
            _fail(ctx, f"fleet request {freq.fid} double-routed: "
                       f"{legs} live legs at once")
    for rep in router.removed:
        if rep.state not in ("drained", "dead"):
            _fail(ctx, f"replica {rep.name} was removed in state "
                       f"{rep.state!r} — scale-down must drain before "
                       f"teardown")
        if rep.state == "drained" and rep.has_work():
            _fail(ctx, f"replica {rep.name} was removed as drained but "
                       f"its engine still holds work")
    for rep in router.replicas.values():
        if rep.state != "dead":
            check_block_pool(rep.engine, f"{ctx}:fleet/{rep.name}")
    for h, name in router._prefix_index.items():
        if name not in router.replicas:
            _fail(ctx, f"prefix-index entry names removed replica "
                       f"{name!r} — index not scrubbed at teardown")
    check_requests(router, ctx)


def check_requests(router, ctx: str = "") -> None:
    """Structural invariants of the request flight recorder
    (obs/journal.py REQUEST_LEGS), re-derived against the router's own
    request bookkeeping. No-op while the journal is disabled, so every
    fleet soak (``check_fleet`` calls this, and ``check_all(router=)``
    calls ``check_fleet``) attacks the recorder for free once it opts in:

    - **Exactly one terminal leg**: a done request's flight has one
      ``note_request_done`` terminal — never zero (a finish the recorder
      missed) nor two (a double close); a live request has none.
    - **Legs are exclusive, non-overlapping and contiguous** (each leg
      starts where the previous ended), and their sum never exceeds the
      request's wall time.
    - **TTFT legs sum to the measured ttft_s** (the ``ttft_gap`` the
      journal computed at terminal is ~0): an uninstrumented segment on
      the request path shows up here, not in a dashboard.
    - **Retries re-attribute**: every counted retry left a ``retry``
      leg — no time is lost between shed and retry.
    """
    from hivedscheduler_tpu_torch.obs import journal as obs_journal

    j = obs_journal.JOURNAL
    if not j.enabled:
        return
    flights = j.flights()
    for freq in router.requests:
        key = f"fleet/{freq.fid}"
        fl = flights.get(key)
        if fl is None or not fl["opened"]:
            # journal enabled mid-flight (or another router's incarnation
            # overwrote the key): no complete record to check
            continue
        legs = fl["legs"]
        for (l1, s1, e1), (l2, s2, e2) in zip(legs, legs[1:]):
            if s2 < e1 - 1e-9:
                _fail(ctx, f"request {key}: legs {l1!r} [{s1}, {e1}] and "
                           f"{l2!r} [{s2}, {e2}] overlap")
            if s2 > e2 + 1e-9:
                _fail(ctx, f"request {key}: leg {l2!r} is negative")
        if any(s2 > e1 + 1e-9
               for (_l1, _s1, e1), (_l2, s2, _e2) in zip(legs, legs[1:])):
            _fail(ctx, f"request {key}: legs are not contiguous — an "
                       f"interval on the request path went unattributed")
        if freq.done:
            if fl["terminals"] == 0:
                _fail(ctx, f"request {key} is done "
                           f"({freq.finish_reason}) but its flight never "
                           f"reached a terminal leg")
            if fl["terminals"] > 1:
                _fail(ctx, f"request {key} reached {fl['terminals']} "
                           f"terminal legs — exactly one is the contract")
            wall = (freq.done_at or 0.0) - freq.submitted_at
            total = sum(e - s for _l, s, e in legs)
            if total > wall + 1e-6:
                _fail(ctx, f"request {key}: leg sum {total:.6f}s exceeds "
                           f"wall time {wall:.6f}s")
            gap = fl["ttft_gap"]
            if freq.ttft_s is not None and gap is not None \
                    and abs(gap) > 1e-6:
                _fail(ctx, f"request {key}: TTFT legs sum differs from "
                           f"measured ttft_s by {gap:+.9f}s — an "
                           f"uninstrumented (or double-counted) segment "
                           f"on the request path")
            retry_legs = sum(1 for leg, _s, _e in legs if leg == "retry")
            if retry_legs < freq.retries:
                _fail(ctx, f"request {key}: {freq.retries} retries but "
                           f"only {retry_legs} `retry` legs — a leg was "
                           f"lost between shed and retry")
        elif fl["terminals"]:
            _fail(ctx, f"request {key} is live but its flight already "
                       f"reached a terminal leg")
