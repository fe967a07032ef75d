"""Lock registry and the opt-in runtime lock-order sanitizer of the port.

A copy of ``hivedscheduler_tpu/common/lockcheck.py`` for the locks the
port creates (the observability leaves and the watchdog), with the
reference's levels:

- every lock of the port is created through :func:`make_lock` with a
  name registered in :data:`LOCK_HIERARCHY`;
- with ``HIVED_LOCKCHECK=1`` the factories return :class:`CheckedLock`
  wrappers that track each thread's held locks and raise
  :class:`LockOrderError` when a thread acquires a lock whose level is not
  strictly greater than every *other* lock it holds;
- the module-level singleton locks (metrics ``REGISTRY``, the tracer, the
  journal, the goodput ledger) are created with ``late=True``: a
  :class:`SwitchableLock` re-reads the flag on every acquisition, so
  setting ``HIVED_LOCKCHECK=1`` after the first import still puts them
  under the sanitizer. Other locks read it when they are created.

Not copied: the scheduler's locks and their creating files
(``LOCK_SITES``), the thread-spawn sites, RLocks (``make_rlock``) and the
algorithm layer's ``serialize_under``/``assert_serialized``; nothing in
the port has them.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from hivedscheduler_tpu_torch.common import envflags

# ---------------------------------------------------------------------------
# Level = acquisition order: a thread holding a lock at level L may only
# acquire locks at levels > L. The levels are the reference's, so a port
# module and its counterpart sit at the same place in the hierarchy.
# ---------------------------------------------------------------------------
LOCK_HIERARCHY: Dict[str, int] = {
    # parallel/supervisor.py: the watchdog's beat state
    "watchdog_lock": 40,
    # observability leaves: nothing is acquired under these but the
    # metrics leaf (closing a goodput/wait interval or observing an SLO
    # datapoint updates a counter, histogram or gauge while holding them)
    "goodput_lock": 76,
    "journal_lock": 78,
    "slo_lock": 79,
    "metrics_lock": 80,
    "trace_lock": 82,
}


class LockOrderError(RuntimeError):
    """A lock-discipline violation: an out-of-hierarchy acquisition, or the
    release of a checked lock this thread does not hold."""


def enabled() -> bool:
    return envflags.get("HIVED_LOCKCHECK", "") == "1"


_tls = threading.local()


def _stack() -> List["_Held"]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


class _Held:
    __slots__ = ("lock", "count")

    def __init__(self, lock: "CheckedLock"):
        self.lock = lock
        self.count = 1


class CheckedLock:
    """Order-asserting wrapper around a ``threading.Lock`` (``acquire``
    with ``blocking``/``timeout``, ``release``, context manager,
    ``locked``), keeping a per-thread stack of held checked locks to
    assert the :data:`LOCK_HIERARCHY` order on every acquisition."""

    def __init__(self, name: str, level: int, inner):
        self.name = name
        self.level = level
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        st = _stack()
        held = next((h for h in st if h.lock is self), None)
        if held is None:
            worst = max((h for h in st if h.lock.level >= self.level),
                        key=lambda h: h.lock.level, default=None)
            if worst is not None:
                raise LockOrderError(
                    f"lock-order violation: acquiring {self.name!r} (level "
                    f"{self.level}) while holding {worst.lock.name!r} (level "
                    f"{worst.lock.level}); held: "
                    f"{[h.lock.name for h in st]}; see LOCK_HIERARCHY in "
                    f"common/lockcheck.py")
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            if held is not None:
                held.count += 1
            else:
                st.append(_Held(self))
        return ok

    def release(self) -> None:
        st = _stack()
        held = next((h for h in st if h.lock is self), None)
        if held is None:
            raise LockOrderError(
                f"release of {self.name!r} which this thread does not hold")
        self._inner.release()
        held.count -= 1
        if held.count == 0:
            st.remove(held)

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __repr__(self) -> str:
        return f"<CheckedLock {self.name!r} level={self.level} {self._inner!r}>"


class SwitchableLock:
    """Late-enabling wrapper for module-level singleton locks: re-reads
    ``HIVED_LOCKCHECK`` on every acquisition and, when it is set, goes
    through a lazily built :class:`CheckedLock` over the SAME underlying
    lock (so waiters on either path contend correctly). Each acquisition
    records the path it took, so a release pairs with its acquire even if
    the flag flips while the lock is held."""

    __slots__ = ("name", "_inner", "_checked", "_modes")

    def __init__(self, name: str, inner):
        if name not in LOCK_HIERARCHY:
            raise LockOrderError(
                f"lock name {name!r} is not in LOCK_HIERARCHY; register it "
                f"before use")
        self.name = name
        self._inner = inner
        self._checked: Optional[CheckedLock] = None
        self._modes: List = []  # acquisition path stack (GIL-guarded)

    def _target(self):
        if not enabled():
            return self._inner
        if self._checked is None:
            self._checked = CheckedLock(
                self.name, LOCK_HIERARCHY[self.name], self._inner)
        return self._checked

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        tgt = self._target()
        ok = tgt.acquire(blocking, timeout)
        if ok:
            self._modes.append(tgt)
        return ok

    def release(self) -> None:
        tgt = self._modes.pop() if self._modes else self._target()
        tgt.release()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __repr__(self) -> str:
        return (f"<SwitchableLock {self.name!r} "
                f"checked={self._checked is not None} {self._inner!r}>")


def make_lock(name: str, late: bool = False):
    """A ``threading.Lock`` registered as ``name`` (checked under
    ``HIVED_LOCKCHECK=1``, plain otherwise). ``late=True``, for
    module-level singletons, returns a :class:`SwitchableLock` that honours
    the flag per acquisition instead of at creation."""
    if late:
        return SwitchableLock(name, threading.Lock())
    if not enabled():
        return threading.Lock()
    if name not in LOCK_HIERARCHY:
        raise LockOrderError(
            f"lock name {name!r} is not in LOCK_HIERARCHY; register it "
            f"before use")
    return CheckedLock(name, LOCK_HIERARCHY[name], threading.Lock())
