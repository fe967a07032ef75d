"""Workload supervisor: graceful preemption, hang watchdog, divergence guard.

Copies of ``hivedscheduler_tpu/parallel/supervisor.py``'s pieces, so that
a training process on the card keeps the workload half of HiveD's
preemption promise (a preempted gang resumes from its last step):

- :class:`PreemptionListener`: SIGTERM/SIGINT set an event instead of
  killing the process; the train loop checkpoints at the next step
  boundary and exits 0. A bounded grace period backstops a wedged
  shutdown (``EXIT_GRACE_EXCEEDED``); an uncommitted checkpoint step is
  safe by construction (commit markers, ``parallel/checkpoint.py``).
- :class:`Watchdog`: a heartbeat thread enforcing a per-step deadline. On
  expiry it records ``hived_stall.json`` (crash-atomic) and exits
  ``EXIT_STALLED`` so the gang restarts from its newest committed
  checkpoint. The first step's deadline is scaled by
  ``first_step_factor``: on the card that step includes the kernels'
  build when it is cold and the first launches.
- :class:`DivergenceGuard`: non-finite loss (always) and optional
  loss-spike detection, behind the train CLI's ``--on-nan`` policy.
- :class:`FaultInjection`: the chaos hooks (hang, NaN, step pacing, the
  serving drain), inert unless the ``HIVED_FAULT_*`` environment variables
  arm them.

One supervisor per workload process, driven from the main loop; importing
this module imports no torch. Not copied: the metrics counters.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import signal
import threading
import time
from typing import Callable, Optional

from hivedscheduler_tpu_torch.common import envflags

log = logging.getLogger(__name__)

# Exit-code contract (the gang framework's restart policy): 0 = clean
# (including checkpoint-and-exit on preemption); nonzero = restart me.
EXIT_STALLED = 43  # watchdog fired: step deadline exceeded
EXIT_DIVERGED = 44  # divergence guard halted (or rollback budget exhausted)
EXIT_GRACE_EXCEEDED = 45  # preemption grace period blown mid-shutdown

STALL_RECORD = "hived_stall.json"

# chaos/fault-injection environment hooks (one-shot per process; see
# FaultInjection), registered in common/envflags.py
ENV_FAULT_HANG_AT = "HIVED_FAULT_HANG_AT"
ENV_FAULT_NAN_AT = "HIVED_FAULT_NAN_AT"
ENV_FAULT_SERVE_PREEMPT_AT = "HIVED_FAULT_SERVE_PREEMPT_AT"
ENV_FAULT_STEP_DELAY = "HIVED_FAULT_STEP_DELAY"


def _atomic_write_json(path: str, obj: dict) -> None:
    """Crash-atomic JSON write."""
    from hivedscheduler_tpu_torch.parallel.checkpoint import atomic_write_bytes

    atomic_write_bytes(path, json.dumps(obj, sort_keys=True).encode())


class PreemptionListener:
    """SIGTERM/SIGINT -> a thread-safe event, with a bounded grace period.

    ``install()`` swaps the handlers in (main thread only, the CPython
    signal rule) and remembers the previous ones; ``uninstall()`` restores
    them and cancels an armed grace timer. ``trigger()`` requests
    preemption programmatically, with the same semantics as a delivered
    signal; ``on_grace_exceeded`` replaces the grace timer's force-exit.
    """

    def __init__(self, grace_secs: float = 0.0,
                 on_grace_exceeded: Optional[Callable[[], None]] = None):
        self._event = threading.Event()
        self._prev: dict = {}
        self._grace_secs = grace_secs
        self._grace_timer: Optional[threading.Timer] = None
        self._on_grace_exceeded = on_grace_exceeded
        self.signum: Optional[int] = None

    def install(self) -> "PreemptionListener":
        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.signal(sig, self._handle)
        except ValueError:
            # not the main thread (embedded use): preemption still works
            # via trigger(); signals stay with the embedder
            log.warning("not on the main thread: signal-driven preemption "
                        "disabled (trigger() still works)")
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
        if self._grace_timer is not None:
            self._grace_timer.cancel()
            self._grace_timer = None

    def _handle(self, signum, _frame) -> None:
        self.signum = signum
        log.info("received signal %s: requesting checkpoint-and-exit at the "
                 "next step boundary (grace %.1fs)", signum, self._grace_secs)
        self.trigger()

    def trigger(self) -> None:
        """Request preemption (signal handler, tests, chaos hooks)."""
        first = not self._event.is_set()
        self._event.set()
        if first and self._grace_secs > 0:
            self._grace_timer = threading.Timer(self._grace_secs,
                                                self._grace_exceeded)
            self._grace_timer.daemon = True
            self._grace_timer.start()

    def _grace_exceeded(self) -> None:
        if self._on_grace_exceeded is not None:
            self._on_grace_exceeded()
            return
        log.error("preemption grace period (%.1fs) exceeded before a clean "
                  "exit; force-exiting (uncommitted checkpoint steps are "
                  "invisible to restore)", self._grace_secs)
        os._exit(EXIT_GRACE_EXCEEDED)

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    @property
    def event(self) -> threading.Event:
        """The underlying event: hand it to blocking consumers (e.g.
        ``data.prefetch(stop=...)``) so a preemption wakes them."""
        return self._event


class Watchdog:
    """Per-step deadline enforcement from a daemon heartbeat thread.

    The supervised loop calls ``heartbeat(step)`` at every step boundary;
    when the age of the newest heartbeat exceeds the deadline, the thread
    writes ``hived_stall.json`` into ``record_dir`` (crash-atomic) and
    exits the process ``EXIT_STALLED``. The deadline holds at ``deadline_s
    * first_step_factor`` until the second heartbeat, since beat 1
    precedes the incarnation's slow first step. ``on_stall`` (tests)
    replaces the process exit with a callback.
    """

    def __init__(self, deadline_s: float, *, first_step_factor: float = 10.0,
                 record_dir: str = "", poll_s: Optional[float] = None,
                 on_stall: Optional[Callable[[dict], None]] = None,
                 clock=time.monotonic):
        if deadline_s <= 0:
            raise ValueError(f"watchdog deadline must be > 0, got {deadline_s}")
        self.deadline_s = deadline_s
        self.first_step_factor = max(1.0, first_step_factor)
        self.record_dir = record_dir
        self._poll_s = poll_s if poll_s is not None else min(deadline_s / 4, 1.0)
        self._on_stall = on_stall
        self._clock = clock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._last_beat: Optional[float] = None
        self._last_step: Optional[int] = None
        self._beats = 0
        self._armed_at: Optional[float] = None
        self.fired = False

    def start(self) -> "Watchdog":
        self._armed_at = self._clock()
        self._thread = threading.Thread(target=self._run, name="hived-watchdog",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def heartbeat(self, step: int) -> None:
        with self._lock:
            self._last_beat = self._clock()
            self._last_step = step
            self._beats += 1

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            with self._lock:
                beat, step, beats = self._last_beat, self._last_step, self._beats
            if beat is None:
                beat = self._armed_at
            # the scaled deadline holds until the SECOND heartbeat: the loop
            # beats BEFORE running each step, so beat 1 precedes the slow
            # first step
            deadline = (self.deadline_s if beats >= 2
                        else self.deadline_s * self.first_step_factor)
            age = self._clock() - beat
            if age <= deadline:
                continue
            self._fire(step, age, deadline)
            return

    def _fire(self, step: Optional[int], age: float, deadline: float) -> None:
        self.fired = True
        record = {
            "kind": "watchdog_stall",
            "pid": os.getpid(),
            "last_step": step,
            "heartbeat_age_s": round(age, 3),
            "deadline_s": deadline,
            "wall_time": time.time(),
        }
        log.error("watchdog: no step heartbeat for %.1fs (deadline %.1fs, "
                  "last step %s) — exiting %d so the gang restarts from the "
                  "newest committed checkpoint", age, deadline, step,
                  EXIT_STALLED)
        if self.record_dir:
            try:
                os.makedirs(self.record_dir, exist_ok=True)
                _atomic_write_json(
                    os.path.join(self.record_dir, STALL_RECORD), record)
            except OSError:
                log.exception("failed to write the stall record")
        if self._on_stall is not None:
            self._on_stall(record)
            return
        os._exit(EXIT_STALLED)


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
        """Forget history (after a rollback: the restored trajectory's EMA
        must not inherit the diverged run's tail)."""
        self._ema = None
        self._seen = 0


@dataclasses.dataclass
class FaultInjection:
    """One-shot chaos hooks for the workload fault ladder, armed via
    ``HIVED_FAULT_*`` environment variables. Each fires at most once per
    process, so a rollback replaying the same step does not re-trip it."""

    hang_at: Optional[int] = None
    nan_at: Optional[int] = None
    serve_preempt_at: Optional[int] = None
    step_delay_s: float = 0.0

    @classmethod
    def from_env(cls) -> "FaultInjection":
        def geti(name):
            v = envflags.get(name, "")
            return int(v) if v else None

        return cls(hang_at=geti(ENV_FAULT_HANG_AT),
                   nan_at=geti(ENV_FAULT_NAN_AT),
                   serve_preempt_at=geti(ENV_FAULT_SERVE_PREEMPT_AT),
                   step_delay_s=float(
                       envflags.get(ENV_FAULT_STEP_DELAY, "") or 0.0))

    def pace(self) -> None:
        """Pad every step by ``step_delay_s`` so the chaos harness can land
        signals at deterministic step windows. Inert when unarmed."""
        if self.step_delay_s > 0:
            time.sleep(self.step_delay_s)

    def maybe_hang(self, step: int) -> None:
        """Injected stall: sleep far past any watchdog deadline at the
        armed step."""
        if self.hang_at is not None and step == self.hang_at:
            self.hang_at = None
            log.warning("FAULT INJECTION: hanging at step %d", step)
            time.sleep(3600.0)

    def take_nan(self, step: int, params=None) -> bool:
        """True exactly once, at the armed step. Given ``params`` (the
        tensor tree), it also multiplies every leaf by NaN in place, which
        poisons every later loss and checkpoint: the failure the divergence
        guard defends against."""
        if self.nan_at is None or step != self.nan_at:
            return False
        self.nan_at = None
        log.warning("FAULT INJECTION: poisoning params with NaN at step %d",
                    step)
        if params is not None:
            import torch

            from hivedscheduler_tpu_torch.parallel.checkpoint import named_leaves

            with torch.no_grad():
                for leaf in named_leaves(params).values():
                    leaf.mul_(float("nan"))
        return True

    def take_serve_preempt(self, engine_step: int) -> bool:
        """True exactly once, at the armed serving engine step."""
        if (self.serve_preempt_at is not None
                and engine_step == self.serve_preempt_at):
            self.serve_preempt_at = None
            log.warning("FAULT INJECTION: requesting serve preemption at "
                        "engine step %d", engine_step)
            return True
        return False


class Supervisor:
    """The training loop's supervision facade: the preemption listener,
    the optional watchdog, the divergence guard, the fault hooks and the
    rollback budget behind a context manager::

        with Supervisor(grace_secs=30, watchdog_secs=120,
                        record_dir=ckpt_dir) as sup:
            for step in range(start, steps):
                sup.heartbeat(step)
                ... run the step ...
                reason = sup.check_loss(step, loss)
                if reason: ... apply the --on-nan policy ...
                if sup.preempt_requested:
                    ... checkpoint and break ...

    ``on_stall`` / ``on_grace_exceeded`` replace the default process exits
    for in-process tests. ``max_rollbacks`` bounds the rollback policy: a
    persistently diverging run halts (``EXIT_DIVERGED``) rather than
    restoring forever.
    """

    def __init__(self, *, grace_secs: float = 30.0, watchdog_secs: float = 0.0,
                 spike_factor: float = 0.0, max_rollbacks: int = 3,
                 record_dir: str = "", first_step_factor: float = 10.0,
                 on_stall: Optional[Callable[[dict], None]] = None,
                 on_grace_exceeded: Optional[Callable[[], None]] = None,
                 install_signals: bool = True, clock=time.monotonic):
        self.preemption = PreemptionListener(
            grace_secs=grace_secs, on_grace_exceeded=on_grace_exceeded)
        self.watchdog: Optional[Watchdog] = None
        if watchdog_secs > 0:
            self.watchdog = Watchdog(
                watchdog_secs, first_step_factor=first_step_factor,
                record_dir=record_dir, on_stall=on_stall, clock=clock)
        self.guard = DivergenceGuard(spike_factor=spike_factor)
        self.faults = FaultInjection.from_env()
        self.max_rollbacks = max_rollbacks
        self.rollbacks = 0
        self._install_signals = install_signals

    def __enter__(self) -> "Supervisor":
        if self._install_signals:
            self.preemption.install()
        if self.watchdog is not None:
            self.watchdog.start()
        return self

    def __exit__(self, *exc) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
        if self._install_signals:
            self.preemption.uninstall()

    def heartbeat(self, step: int) -> None:
        if self.watchdog is not None:
            self.watchdog.heartbeat(step)

    @property
    def preempt_requested(self) -> bool:
        return self.preemption.requested

    def check_loss(self, step: int, loss: float) -> Optional[str]:
        return self.guard.check(step, loss)

    def note_rollback(self) -> bool:
        """Record one divergence rollback; False when the budget is
        exhausted (the caller must halt)."""
        self.rollbacks += 1
        self.guard.reset()
        return self.rollbacks <= self.max_rollbacks
