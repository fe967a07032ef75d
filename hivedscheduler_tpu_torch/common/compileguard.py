"""Opt-in capture sanitizer (``HIVED_COMPILE_GUARD=1``).

The port's counterpart of ``hivedscheduler_tpu/common/compileguard.py``.
Where JAX pays for a shape leak with a silent jit recompile, eager PyTorch
pays nothing until a CUDA graph is captured again: a capture costs an
eager iteration, the capture itself and fresh static buffers, so a
steady-state loop must capture nothing. The serving engine reports each
capture of its decode window here (``ServingEngine._run_window``), under
the label ``serve.decode_window``.

- :func:`note_capture` counts one capture under its label while the guard
  is on; off (the default) it costs one flag read.
- :func:`counts`/:func:`total` read the per-label counters; :func:`reset`
  zeroes them (e.g. after warm-up).
- :func:`budget` is the assertion chokepoint: a ``with`` block that raises
  :class:`RecompileError` when more than ``max_new`` captures land inside
  it. A warmed engine or fleet serves under ``budget(0)``.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

from hivedscheduler_tpu_torch.common import envflags, lockcheck

# leaf lock: counter updates only, nothing is acquired under it
_lock = lockcheck.make_lock("compileguard_lock", late=True)
_counts: Dict[str, int] = {}


class RecompileError(RuntimeError):
    """A capture-budget violation: more CUDA-graph captures inside a
    :func:`budget` block than the caller declared legal."""


def enabled() -> bool:
    return envflags.get("HIVED_COMPILE_GUARD", "") == "1"


def note_capture(label: str) -> None:
    """Count one CUDA-graph capture under ``label`` while the guard is on."""
    if not enabled():
        return
    with _lock:
        _counts[label] = _counts.get(label, 0) + 1


def counts() -> Dict[str, int]:
    """Per-label capture counters since the last :func:`reset`."""
    with _lock:
        return dict(_counts)


def total() -> int:
    with _lock:
        return sum(_counts.values())


def reset() -> None:
    """Zero the counters (the warm-up/steady-state boundary)."""
    with _lock:
        _counts.clear()


@contextlib.contextmanager
def budget(max_new: int = 0, label: Optional[str] = None):
    """Assert at most ``max_new`` captures (for ``label``, or in total)
    happen inside the block. No-op unless the guard is enabled."""
    if not enabled():
        yield
        return
    before = counts()
    yield
    after = counts()
    if label is not None:
        new = after.get(label, 0) - before.get(label, 0)
        what = f"label {label!r}"
    else:
        new = sum(after.values()) - sum(before.values())
        what = "all labels"
    if new > max_new:
        grew = {k: after.get(k, 0) - before.get(k, 0)
                for k in after if after.get(k, 0) > before.get(k, 0)}
        raise RecompileError(
            f"capture budget exceeded: {new} CUDA-graph capture(s) for {what} "
            f"inside a budget({max_new}) block — per-label growth {grew}; a "
            f"steady-state loop must not capture again")
