"""Divergence detection and the exit codes of the port's training CLI.

Copies of ``hivedscheduler_tpu/parallel/supervisor.py``'s exit-code
contract and ``DivergenceGuard``. The watchdog, preemption listener and
fault injection come with checkpointing, which is not yet ported.
"""

from __future__ import annotations

import math
from typing import Optional

# Exit-code contract: 0 = clean; nonzero = restart me.
EXIT_STALLED = 43  # watchdog fired: step deadline exceeded
EXIT_DIVERGED = 44  # divergence guard halted
EXIT_GRACE_EXCEEDED = 45  # preemption grace period blown mid-shutdown


class DivergenceGuard:
    """Loss-divergence detection: non-finite always, spikes optionally.

    A non-finite loss is unconditional divergence. With ``spike_factor >
    0``, a loss above ``spike_factor x`` the exponential moving average of
    recent finite losses also counts. The EMA needs ``warmup_steps``
    observations before spike detection arms."""

    def __init__(self, spike_factor: float = 0.0, ema_decay: float = 0.9,
                 warmup_steps: int = 5):
        self.spike_factor = spike_factor
        self.ema_decay = ema_decay
        self.warmup_steps = warmup_steps
        self._ema: Optional[float] = None
        self._seen = 0

    def check(self, step: int, loss: float) -> Optional[str]:
        """Returns a divergence reason string, or None when healthy."""
        if not math.isfinite(loss):
            return f"non-finite loss {loss} at step {step}"
        if (self.spike_factor > 0 and self._seen >= self.warmup_steps
                and self._ema is not None
                and loss > self.spike_factor * self._ema):
            return (f"loss spike at step {step}: {loss:.4f} > "
                    f"{self.spike_factor:.1f} x EMA {self._ema:.4f}")
        self._seen += 1
        self._ema = (loss if self._ema is None
                     else self.ema_decay * self._ema
                     + (1.0 - self.ema_decay) * loss)
        return None

    def reset(self) -> None:
        """Forget history."""
        self._ema = None
        self._seen = 0
