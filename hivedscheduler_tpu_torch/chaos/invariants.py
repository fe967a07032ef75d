"""From-scratch invariant checks of the workload's host books.

Copies of ``check_block_pool``, ``check_journal`` and ``check_goodput``
from ``hivedscheduler_tpu/chaos/invariants.py`` (the scheduler checks of
that module stay with the control plane), with their own
:class:`InvariantViolation`. ``check_block_pool`` reads only the engine's
host books (``paged``, ``num_blocks``, ``slots``, ``_slot_bids``,
``_table``, ``_prefix_cache``, ``_entry_bids``, ``_free``, ``_ref``),
which the port's engine keeps under the reference's names, so either
package's checker audits either engine. ``check_requests`` reads a fleet
router and waits for the port's fleet.
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
