"""From-scratch accounting of the serving engine's paged KV block pool.

Copy of ``check_block_pool`` from ``hivedscheduler_tpu/chaos/invariants.py``
(the scheduler checks of that module stay with the control plane), with
its own :class:`InvariantViolation`. It reads only the engine's host books
(``paged``, ``num_blocks``, ``slots``, ``_slot_bids``, ``_table``,
``_prefix_cache``, ``_entry_bids``, ``_free``, ``_ref``), which the port's
engine keeps under the reference's names, so either package's checker
audits either engine.
"""

from __future__ import annotations


class InvariantViolation(AssertionError):
    """A structural guarantee of the block pool was broken."""


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
