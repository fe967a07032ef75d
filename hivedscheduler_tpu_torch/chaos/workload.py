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
steps so signals land inside the training window.

:class:`ElasticWorkloadHarness` runs the elastic episode (kill -9 on the
full slice, a shrunk resume, a grown resume) on gloo gangs of ``train
--elastic`` processes, one a rank, whose environments the harness builds
as the scheduler's handoff would (:func:`gang_env`).
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

from hivedscheduler_tpu_torch.parallel import distributed
from hivedscheduler_tpu_torch.parallel import supervisor as sup_lib

log = logging.getLogger(__name__)

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# the fault ladder the seeded plan draws from (NaN rollback legitimately
# changes the data stream, so it has its own deterministic test)
EPISODE_KINDS = ("sigkill", "sigterm", "hang")
# the variables of the scheduler's gang handoff (parallel/distributed.py)
_GANG_VARS = ("POD_BIND_INFO", "NODE_NAME", "NVIDIA_VISIBLE_DEVICES", "LOCAL_RANK")


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


def gang_env(world: int, rank: int, node: str = "elastic/127.0.0.1") -> Dict[str, str]:
    """The scheduler's handoff to rank ``rank`` of a one-pod gang holding
    ``world`` GPUs on ``node`` (the coordinator is the node's last path
    element): the bind-info annotation, the node name, the granted GPU
    indices and ``LOCAL_RANK``."""
    bind_info = {
        "node": node,
        "leafCellIsolation": list(range(world)),
        "cellChain": "h100-rack",
        "affinityGroupBindInfo": [{"podPlacements": [{
            "physicalNode": node,
            "physicalLeafCellIndices": list(range(world)),
        }]}],
    }
    return {"POD_BIND_INFO": json.dumps(bind_info), "NODE_NAME": node,
            "NVIDIA_VISIBLE_DEVICES": ",".join(map(str, range(world))),
            "LOCAL_RANK": str(rank)}


def cpu_only_env(gang: Optional[Tuple[int, int]] = None, **extra: str) -> Dict[str, str]:
    """The environment of a killable training subprocess: no card visible,
    one CPU thread (every incarnation reduces in the same order, so their
    losses compare bit for bit), the repository on the path, and no fault
    hook or gang handoff inherited from the caller. ``gang`` (world, rank)
    adds rank ``rank``'s handoff of a one-pod gang (:func:`gang_env`)."""
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    for k in list(env):
        if k.startswith("HIVED_FAULT_") or k in _GANG_VARS:
            del env[k]
    if gang is not None:
        env.update(gang_env(*gang))
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


# one rank of a ``train`` gang: the CLI reaches its coordinator on the port
# given first (each incarnation takes a free one, so that gangs started
# together never meet), then takes the train arguments
_GANG_LAUNCH = (
    "import sys\n"
    "from hivedscheduler_tpu_torch.parallel import distributed\n"
    "distributed.DEFAULT_COORDINATOR_PORT = int(sys.argv[1])\n"
    "from hivedscheduler_tpu_torch import train\n"
    "sys.exit(train.main(sys.argv[2:]))\n"
)


class ElasticWorkloadHarness:
    """The elastic episode, the JAX package's: kill -9 mid-step on the full
    slice, a shrunk resume on half the ranks (a cross-topology restore),
    and a grown resume back on the full slice, all against one checkpoint
    directory.

    Each incarnation is a gloo gang of ``train --elastic --min-chips 1
    --device cpu`` processes, one a rank (:data:`FULL_DEVICES` = 2, then
    :data:`SHRUNK_DEVICES` = 1, then 2 again), each given the scheduler's
    handoff of a one-pod gang (:func:`gang_env`) and a free coordinator
    port. ``--elastic`` derives the mesh from the gang's world size, so the
    checkpoint reshards on each resume. The SIGKILL and the SIGTERM (the
    grow offer evicting the shrunk slice: checkpoint and exit 0) go to
    every rank of the gang; a rank that does not exit within
    :data:`RUN_TIMEOUT_S` (one left blocked in a collective) is killed and
    recorded as a violation, so the harness never hangs.

    Checks, as JAX's: the checkpoint metadata records ``mesh.dp`` 2 after
    the full incarnation and 1 after the shrunk one; the merged trajectory
    (rank 0's timelines) lies within :data:`LOSS_ATOL` of an uninterrupted
    2-rank reference run (cross-topology resumes change reduction orders,
    so it is allclose, not bit-exact); every step ran; the goodput spool
    holds 3 incarnations, exactly 1 torn (the killed one), rework when the
    kill fell between commits, and ``checkpoint_save`` time. The plan is
    JAX's draw: ``kill_step`` and ``preempt_step`` from
    ``random.Random(seed)``, so a seed gives JAX's steps.

    Left out: JAX's ``bridge_ledger``, which meters each incarnation on the
    cluster's capacity ledger (``obs/ledger.py`` ``CapacityLedger``), the
    control plane the port does not copy."""

    FULL_DEVICES = 2
    SHRUNK_DEVICES = 1
    # the JAX package's bound: cross-topology drift is far below it, and a
    # resume at the wrong step or on replayed or skipped data moves a loss
    # by a whole loss scale
    LOSS_ATOL = 0.02

    # the episode: 8 steps with a commit every 2, the killed and the
    # preempted incarnations paced so the signals land mid-run
    STEPS = 8
    CHECKPOINT_EVERY = 2
    STEP_DELAY_S = 0.25
    GRACE_SECS = 30.0
    # a rank still running this long after its gang started is killed and
    # recorded as a violation
    RUN_TIMEOUT_S = 240.0

    def __init__(self, seed: int, workdir: str):
        self.seed = seed
        rng = random.Random(seed)
        self.workdir = workdir
        # the hard kill lands after the first possible commit; the
        # cooperative preemption (the grow offer) strictly later, so the
        # shrunk incarnation does real work first
        self.kill_step = rng.randint(self.CHECKPOINT_EVERY + 1, self.STEPS - 3)
        self.preempt_step = rng.randint(self.kill_step + 1, self.STEPS - 2)
        self.violations: List[str] = []

    def train_args(self, ckpt_dir: str, timeline: str, goodput: str = "",
                   steps: Optional[int] = None) -> List[str]:
        """One rank's ``train`` arguments (``steps`` defaults to the
        episode's)."""
        args = [
            "--device", "cpu",
            "--steps", str(steps if steps is not None else self.STEPS),
            "--batch", "2", "--seq-len", "16", "--vocab-size", "64",
            "--d-model", "16", "--n-layers", "1", "--n-heads", "2",
            "--d-ff", "32", "--log-every", "100",
            "--elastic", "--min-chips", "1",
            "--checkpoint-dir", ckpt_dir,
            "--checkpoint-every", str(self.CHECKPOINT_EVERY),
            "--timeline", timeline,
            "--grace-secs", str(self.GRACE_SECS),
        ]
        if goodput:
            args += ["--goodput-file", goodput]
        return args

    def spawn(self, ckpt: str, timeline: str, world: int, paced: bool,
              goodput: str = "", steps: Optional[int] = None) -> List[subprocess.Popen]:
        """One incarnation: a gang of ``world`` train processes, one a
        rank."""
        extra = ({sup_lib.ENV_FAULT_STEP_DELAY: str(self.STEP_DELAY_S)}
                 if paced else {})
        port = str(distributed._free_local_port())
        cmd = [sys.executable, "-c", _GANG_LAUNCH, port] + self.train_args(
            ckpt, timeline, goodput, steps)
        return [subprocess.Popen(cmd, cwd=_REPO_ROOT,
                                 env=cpu_only_env(gang=(world, rank), **extra),
                                 stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
                for rank in range(world)]

    def _wait_for_step(self, procs, timeline: str, step: int) -> bool:
        deadline = time.monotonic() + self.RUN_TIMEOUT_S
        while time.monotonic() < deadline:
            if read_timeline(timeline).get(step) is not None:
                return True
            if any(p.poll() is not None for p in procs):
                return False
            time.sleep(0.02)
        return False

    @staticmethod
    def _signal(procs, sig) -> None:
        for p in procs:
            if p.poll() is None:
                p.send_signal(sig)

    def wait(self, procs, what: str) -> Optional[int]:
        """The gang's exit code (the first nonzero rank's, else 0); None,
        with a violation, when a rank outlives :data:`RUN_TIMEOUT_S` (it and
        every other rank still running are killed)."""
        deadline = time.monotonic() + self.RUN_TIMEOUT_S
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(0.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                self._signal(procs, signal.SIGKILL)
                for q in procs:
                    q.wait()
                self.violations.append(f"{what}: incarnation did not exit within "
                                       f"{self.RUN_TIMEOUT_S}s")
                return None
        return next((rc for rc in rcs if rc != 0), 0)

    def _checkpoint_mesh(self, ckpt: str) -> Optional[dict]:
        from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt_lib

        if ckpt_lib.latest_step(ckpt) is None:
            return None
        return ckpt_lib.read_metadata(ckpt).get("mesh")

    def run(self) -> dict:
        ck = os.path.join(self.workdir, "elastic-ck")
        gp = os.path.join(self.workdir, "elastic-goodput.jsonl")
        timelines: List[str] = []

        # the uninterrupted full-slice reference (its own checkpoint dir),
        # running beside the first incarnation
        ref_tl = os.path.join(self.workdir, "elastic-ref.jsonl")
        ref_procs = self.spawn(os.path.join(self.workdir, "elastic-ref-ck"), ref_tl,
                               self.FULL_DEVICES, paced=False)

        # 1. full slice, kill -9 mid-step on every rank
        tl = os.path.join(self.workdir, "elastic-full.jsonl")
        timelines.append(tl)
        procs = self.spawn(ck, tl, self.FULL_DEVICES, paced=True, goodput=gp)
        if self._wait_for_step(procs, tl, self.kill_step):
            self._signal(procs, signal.SIGKILL)
        self.wait(procs, f"full incarnation (sigkill@{self.kill_step})")
        mesh = self._checkpoint_mesh(ck)
        if mesh is None:
            self.violations.append("full incarnation left no committed "
                                   "checkpoint to shrink-resume from")
        elif mesh.get("dp") != self.FULL_DEVICES:
            self.violations.append(
                f"full incarnation's checkpoint records mesh {mesh}, "
                f"expected dp={self.FULL_DEVICES}")

        # 2. shrink resume on the degraded slice; SIGTERM = the grow offer
        #    evicting it (checkpoint-and-exit-0)
        tl = os.path.join(self.workdir, "elastic-shrunk.jsonl")
        timelines.append(tl)
        procs = self.spawn(ck, tl, self.SHRUNK_DEVICES, paced=True, goodput=gp)
        if self._wait_for_step(procs, tl, self.preempt_step):
            self._signal(procs, signal.SIGTERM)
        rc = self.wait(procs, f"shrunk incarnation (sigterm@{self.preempt_step})")
        if rc != 0:
            self.violations.append(
                f"shrunk incarnation exited {rc}, expected a clean "
                f"checkpoint-and-exit (0)")
        mesh = self._checkpoint_mesh(ck)
        if mesh is not None and mesh.get("dp") != self.SHRUNK_DEVICES:
            self.violations.append(
                f"shrunk incarnation's checkpoint records mesh {mesh}, "
                f"expected dp={self.SHRUNK_DEVICES} (cross-topology "
                f"metadata trail broken)")

        # 3. grow: back to the full slice, run to completion
        tl = os.path.join(self.workdir, "elastic-grown.jsonl")
        timelines.append(tl)
        procs = self.spawn(ck, tl, self.FULL_DEVICES, paced=False, goodput=gp)
        rc = self.wait(procs, "grown incarnation")
        if rc != 0:
            self.violations.append(f"grown incarnation exited {rc}")

        if self.wait(ref_procs, "reference") != 0:
            self.violations.append("reference run failed")
        reference = read_timeline(ref_tl)
        if len(reference) != self.STEPS:
            self.violations.append(
                f"reference covered {len(reference)}/{self.STEPS} steps")

        # the merged trajectory stays allclose to the uninterrupted
        # reference: a resume that replayed or skipped data or restored the
        # wrong state shows as a whole-loss-scale divergence
        covered: set = set()
        for t in timelines:
            for step, loss in read_timeline(t).items():
                covered.add(step)
                ref = reference.get(step)
                if ref is None:
                    self.violations.append(
                        f"{os.path.basename(t)}: step {step} beyond the "
                        f"reference run")
                elif abs(loss - ref) > self.LOSS_ATOL:
                    self.violations.append(
                        f"{os.path.basename(t)}: step {step} loss {loss!r} "
                        f"vs reference {ref!r} exceeds atol "
                        f"{self.LOSS_ATOL} (elastic resume diverged)")
        missing = set(range(1, self.STEPS + 1)) - covered
        if missing:
            self.violations.append(
                f"steps never executed by any incarnation: {sorted(missing)}")

        goodput_report = self.check_goodput(gp)
        return {
            "seed": self.seed,
            "kind": "elastic",
            "kill_step": self.kill_step,
            "preempt_step": self.preempt_step,
            "steps": self.STEPS,
            "incarnations": 3,
            "goodput": goodput_report,
            "violations": list(self.violations),
        }

    def check_goodput(self, gp: str) -> dict:
        """The episode's goodput audit: conservation (``check_spool``), the
        rework replay, 3 incarnations of which exactly the killed one is
        torn, rework when the kill fell between commits, and
        ``checkpoint_save`` time from the SIGTERM's checkpoint-and-exit."""
        from hivedscheduler_tpu_torch.obs import goodput as obs_goodput

        self.violations += obs_goodput.check_spool(gp)
        records = obs_goodput.read_spool(gp)
        self.violations += obs_goodput.check_rework_classification(records)
        agg = obs_goodput.aggregate_spool(records)
        if agg["incarnations"] != 3:
            self.violations.append(
                f"goodput spool records {agg['incarnations']} incarnations, "
                f"expected 3 (kill -> shrink -> grow)")
        if agg["torn"] != 1:
            self.violations.append(
                f"goodput spool has {agg['torn']} torn incarnations, "
                f"expected exactly the sigkilled full-slice one")
        if self.kill_step % self.CHECKPOINT_EVERY != 0 and agg["rework_steps"] == 0:
            # a kill between commits forces the shrunk resume to re-train
            # from the last committed step
            self.violations.append(
                f"kill@{self.kill_step} landed between commits "
                f"(checkpoint_every={self.CHECKPOINT_EVERY}) yet the spool "
                f"attributes 0 rework steps")
        if not any(s.get("phases", {}).get("checkpoint_save", 0.0) > 0.0
                   for s in agg["summaries"]):
            self.violations.append(
                "no summarized incarnation attributed checkpoint_save time "
                "despite the SIGTERM grow offer's checkpoint-and-exit")
        return {
            "phases": {p: round(s, 6) for p, s in sorted(agg["phases"].items())},
            "goodput_fraction": agg["goodput_fraction"],
            "steps": agg["steps"],
            "rework_steps": agg["rework_steps"],
            "incarnations": agg["incarnations"],
            "torn": agg["torn"],
        }
