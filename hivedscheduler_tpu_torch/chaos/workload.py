"""Process-level workload chaos for the port: kill, hang and restart a real
training subprocess, then prove the resumed run is bit-exact.

The port's copy of ``hivedscheduler_tpu/chaos/workload.py``'s
``WorkloadChaosHarness``, driving ``python -m hivedscheduler_tpu_torch.train
--device cpu``. A training job must survive

- **SIGKILL** mid-step (hard preemption, OOM killer, node loss): the next
  incarnation restores the newest committed checkpoint (parameters, AdamW
  state and the data loader's position) and reproduces the uninterrupted
  run's loss trajectory **bit-exactly**;
- **SIGTERM** (cooperative preemption): the supervisor checkpoints at the
  next step boundary and exits 0 within the grace period;
- **hang** (a wedged step, injected via ``HIVED_FAULT_HANG_AT``): the
  watchdog records ``hived_stall.json`` and exits ``EXIT_STALLED`` so the
  gang restarts instead of wedging forever.

Every fault decision is drawn from one ``random.Random(seed)``, so a seed
replays the same episode plan. Subprocesses run on the CPU with one thread
(:func:`cpu_only_env`); ``HIVED_FAULT_STEP_DELAY`` paces the tiny model's
steps so signals land inside the training window. The elastic episode
needs ``train --elastic``, which is not yet ported.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

from hivedscheduler_tpu_torch.parallel import supervisor as sup_lib

log = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the fault ladder the seeded plan draws from (NaN rollback legitimately
# changes the data stream, so it has its own deterministic test)
EPISODE_KINDS = ("sigkill", "sigterm", "hang")


@dataclasses.dataclass
class WorkloadFaultPlan:
    """Seeded episode plan: how many times to interrupt the run, and the
    step window faults may land in. Steps are drawn in ``[min_step, steps
    - 2]`` so a checkpoint can exist before the first fault and at least
    one step remains after the last."""

    episodes: int = 2
    min_step: int = 3
    kinds: Tuple[str, ...] = EPISODE_KINDS

    def draw(self, rng: random.Random, steps: int) -> List[Tuple[str, int]]:
        hi = max(self.min_step, steps - 2)
        return [(rng.choice(list(self.kinds)), rng.randint(self.min_step, hi))
                for _ in range(self.episodes)]


def cpu_only_env(**extra: str) -> Dict[str, str]:
    """The environment of a killable training subprocess: no card visible,
    one CPU thread (every incarnation reduces in the same order, so their
    losses compare bit for bit), the repository on the path, and no fault
    hook inherited from the caller."""
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for k in list(env):
        if k.startswith("HIVED_FAULT_"):
            del env[k]
    env.update(extra)
    return env


def read_timeline(path: str) -> Dict[int, float]:
    """step -> loss from a ``train --timeline`` JSONL (empty if absent)."""
    out: Dict[int, float] = {}
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue  # torn final line of a killed incarnation
                out[rec["step"]] = rec["loss"]
    except OSError:
        pass
    return out


class WorkloadChaosHarness:
    """Drive one seeded episode plan over a tiny CPU training run.

    ``run()`` executes the plan: each episode launches an incarnation of
    the port's train CLI against a shared checkpoint directory, injects its
    fault and checks the per-fault exit contract; then a final incarnation
    runs to completion and the merged trajectory is compared bit for bit
    with an uninterrupted reference run. Violations are collected, not
    raised, and returned in a deterministic report dict.
    """

    def __init__(self, seed: int, workdir: str, *, steps: int = 8,
                 checkpoint_every: int = 2,
                 plan: Optional[WorkloadFaultPlan] = None,
                 step_delay_s: float = 0.25, watchdog_secs: float = 2.0,
                 grace_secs: float = 30.0, run_timeout_s: float = 240.0):
        self.seed = seed
        self.rng = random.Random(seed)
        self.workdir = workdir
        self.steps = steps
        self.checkpoint_every = checkpoint_every
        self.plan = plan or WorkloadFaultPlan()
        self.episodes = self.plan.draw(self.rng, steps)
        self.step_delay_s = step_delay_s
        self.watchdog_secs = watchdog_secs
        self.grace_secs = grace_secs
        self.run_timeout_s = run_timeout_s
        self.violations: List[str] = []

    # -- building blocks ---------------------------------------------------
    def train_cmd(self, ckpt_dir: str, timeline: str,
                  steps: Optional[int] = None,
                  goodput: str = "") -> List[str]:
        cmd = [
            sys.executable, "-m", "hivedscheduler_tpu_torch.train",
            "--device", "cpu",
            "--steps", str(steps if steps is not None else self.steps),
            "--batch", "2", "--seq-len", "16", "--vocab-size", "64",
            "--d-model", "16", "--n-layers", "1", "--n-heads", "2",
            "--d-ff", "32", "--log-every", "100",
            "--checkpoint-dir", ckpt_dir,
            "--checkpoint-every", str(self.checkpoint_every),
            "--timeline", timeline,
            "--grace-secs", str(self.grace_secs),
            "--watchdog-secs", str(self.watchdog_secs),
        ]
        if goodput:
            cmd += ["--goodput-file", goodput]
        return cmd

    def _wait_for_step(self, proc: subprocess.Popen, timeline: str,
                       step: int) -> bool:
        """Poll the incarnation's timeline until ``step`` is recorded (True)
        or the process exits first (False)."""
        deadline = time.monotonic() + self.run_timeout_s
        while time.monotonic() < deadline:
            if read_timeline(timeline).get(step) is not None:
                return True
            if proc.poll() is not None:
                return False
            time.sleep(0.02)
        return False

    def _wait(self, proc: subprocess.Popen, what: str) -> Optional[int]:
        try:
            proc.wait(timeout=self.run_timeout_s)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            self.violations.append(f"{what}: incarnation did not exit within "
                                   f"{self.run_timeout_s}s")
            return None
        return proc.returncode

    def reference_run(self) -> Dict[int, float]:
        """The uninterrupted ground-truth trajectory (own checkpoint dir)."""
        ck = os.path.join(self.workdir, "ref-ck")
        tl = os.path.join(self.workdir, "ref-timeline.jsonl")
        proc = subprocess.Popen(
            self.train_cmd(ck, tl), cwd=_REPO_ROOT, env=cpu_only_env(),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        rc = self._wait(proc, "reference")
        if rc != 0:
            self.violations.append(f"reference run exited {rc}")
        return read_timeline(tl)

    def check_goodput(self, gp: str, want_torn: int) -> dict:
        """Post-soak goodput audit over the shared spool: conservation per
        summarized incarnation (``check_spool``), the rework classification
        replay, incarnation/torn bookkeeping against the observed exits
        (``want_torn`` = incarnations that exited nonzero: SIGKILL and the
        watchdog's ``os._exit`` skip the atexit summary), and that a
        SIGTERM episode attributed ``checkpoint_save`` time. Violations
        land in ``self.violations``; returns the report's ``goodput``
        block."""
        from hivedscheduler_tpu_torch.obs import goodput as obs_goodput

        self.violations += obs_goodput.check_spool(gp)
        records = obs_goodput.read_spool(gp)
        self.violations += obs_goodput.check_rework_classification(records)
        agg = obs_goodput.aggregate_spool(records)
        want = len(self.episodes) + 1
        if agg["incarnations"] != want:
            self.violations.append(
                f"goodput spool records {agg['incarnations']} incarnations, "
                f"expected {want} (enable() unreached, or the spool was not "
                f"shared across incarnations)")
        if agg["torn"] != want_torn:
            self.violations.append(
                f"goodput spool has {agg['torn']} torn incarnations, "
                f"expected {want_torn} (incarnations that exited nonzero)")
        if any(kind == "sigterm" for kind, _ in self.episodes):
            if not any(s.get("phases", {}).get("checkpoint_save", 0.0) > 0.0
                       for s in agg["summaries"]):
                self.violations.append(
                    "no summarized incarnation attributed checkpoint_save "
                    "time despite a SIGTERM checkpoint-and-exit episode")
        return {
            "phases": {p: round(s, 6) for p, s in sorted(agg["phases"].items())},
            "goodput_fraction": agg["goodput_fraction"],
            "steps": agg["steps"],
            "rework_steps": agg["rework_steps"],
            "incarnations": agg["incarnations"],
            "torn": agg["torn"],
        }

    # -- the soak ----------------------------------------------------------
    def run(self) -> dict:
        from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt_lib

        ck = os.path.join(self.workdir, "soak-ck")
        gp = os.path.join(self.workdir, "soak-goodput.jsonl")
        timelines: List[str] = []
        soak_rcs: List[Optional[int]] = []  # goodput torn accounting
        reference = self.reference_run()
        if len(reference) != self.steps:
            self.violations.append(
                f"reference covered {len(reference)}/{self.steps} steps")

        for i, (kind, at_step) in enumerate(self.episodes):
            tl = os.path.join(self.workdir, f"incarnation-{i}.jsonl")
            timelines.append(tl)
            extra = {sup_lib.ENV_FAULT_STEP_DELAY: str(self.step_delay_s)}
            if kind == "hang":
                extra[sup_lib.ENV_FAULT_HANG_AT] = str(at_step)
            proc = subprocess.Popen(
                self.train_cmd(ck, tl, goodput=gp), cwd=_REPO_ROOT,
                env=cpu_only_env(**extra),
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            )
            if kind == "sigkill":
                if self._wait_for_step(proc, tl, at_step):
                    proc.send_signal(signal.SIGKILL)
                rc = self._wait(proc, f"episode {i} ({kind}@{at_step})")
                soak_rcs.append(rc)
                if rc == 0 and read_timeline(tl).get(self.steps) is None:
                    self.violations.append(
                        f"episode {i}: sigkill incarnation exited 0 without "
                        f"finishing")
            elif kind == "sigterm":
                if self._wait_for_step(proc, tl, at_step):
                    proc.send_signal(signal.SIGTERM)
                rc = self._wait(proc, f"episode {i} ({kind}@{at_step})")
                soak_rcs.append(rc)
                if rc != 0:
                    self.violations.append(
                        f"episode {i}: SIGTERM incarnation exited {rc}, "
                        f"expected a clean checkpoint-and-exit (0)")
                if ckpt_lib.latest_step(ck) is None:
                    self.violations.append(
                        f"episode {i}: SIGTERM left no committed checkpoint")
            else:  # hang
                rc = self._wait(proc, f"episode {i} ({kind}@{at_step})")
                soak_rcs.append(rc)
                if rc != sup_lib.EXIT_STALLED:
                    self.violations.append(
                        f"episode {i}: hung incarnation exited {rc}, "
                        f"expected EXIT_STALLED ({sup_lib.EXIT_STALLED})")
                if not os.path.exists(
                        os.path.join(ck, sup_lib.STALL_RECORD)):
                    self.violations.append(
                        f"episode {i}: watchdog left no stall record")

        # final incarnation: run to completion
        tl = os.path.join(self.workdir, "incarnation-final.jsonl")
        timelines.append(tl)
        proc = subprocess.Popen(
            self.train_cmd(ck, tl, goodput=gp), cwd=_REPO_ROOT,
            env=cpu_only_env(),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        rc = self._wait(proc, "final incarnation")
        soak_rcs.append(rc)
        if rc != 0:
            self.violations.append(f"final incarnation exited {rc}")

        # bit-exactness: EVERY step any incarnation ever recorded must match
        # the uninterrupted reference, replayed steps (between the restored
        # checkpoint and the kill point) included; a mismatch means the
        # resume silently changed the data stream or the restored state
        covered: set = set()
        for t in timelines:
            for step, loss in read_timeline(t).items():
                covered.add(step)
                ref = reference.get(step)
                if ref is None:
                    self.violations.append(
                        f"{os.path.basename(t)}: step {step} beyond the "
                        f"reference run")
                elif loss != ref:
                    self.violations.append(
                        f"{os.path.basename(t)}: step {step} loss {loss!r} "
                        f"!= reference {ref!r} (resume not bit-exact)")
        missing = set(range(1, self.steps + 1)) - covered
        if missing:
            self.violations.append(
                f"steps never executed by any incarnation: {sorted(missing)}")

        goodput_report = self.check_goodput(
            gp, want_torn=sum(1 for r in soak_rcs if r != 0))

        return {
            "seed": self.seed,
            "episodes": [list(e) for e in self.episodes],
            "steps": self.steps,
            "incarnations": len(self.episodes) + 1,
            "goodput": goodput_report,
            "violations": list(self.violations),
        }
