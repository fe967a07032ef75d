"""The port's workload supervisor (hivedscheduler_tpu_torch.parallel.
supervisor) held to the JAX package's: the behaviours of
tests/test_supervisor.py, each run on both modules where they share the
interface, then what is the port's own (the NaN fault poisons the tensor
tree in place, the flag registry)."""

import json
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from hivedscheduler_tpu.parallel import data as jdata
from hivedscheduler_tpu.parallel import supervisor as jsup
from hivedscheduler_tpu_torch.common import envflags
from hivedscheduler_tpu_torch.parallel import data as tdata
from hivedscheduler_tpu_torch.parallel import supervisor as tsup

torch.set_num_threads(1)

MODULES = [pytest.param(jsup, id="jax"), pytest.param(tsup, id="port")]
WITH_DATA = [pytest.param(jsup, jdata, id="jax"), pytest.param(tsup, tdata, id="port")]


@pytest.mark.parametrize("sup_lib", MODULES)
def test_signal_sets_event_and_uninstall_restores_handlers(sup_lib):
    prev_term = signal.getsignal(signal.SIGTERM)
    prev_int = signal.getsignal(signal.SIGINT)
    listener = sup_lib.PreemptionListener().install()
    try:
        assert not listener.requested
        os.kill(os.getpid(), signal.SIGTERM)
        for _ in range(200):  # the handler runs between bytecodes
            if listener.requested:
                break
            time.sleep(0.01)
        assert listener.requested
        assert listener.signum == signal.SIGTERM
    finally:
        listener.uninstall()
    assert signal.getsignal(signal.SIGTERM) is prev_term
    assert signal.getsignal(signal.SIGINT) is prev_int


@pytest.mark.parametrize("sup_lib", MODULES)
def test_trigger_is_programmatic_preemption(sup_lib):
    listener = sup_lib.PreemptionListener()
    assert not listener.requested
    listener.trigger()
    assert listener.requested and listener.event.is_set()


@pytest.mark.parametrize("sup_lib", MODULES)
def test_grace_timer_fires_after_trigger(sup_lib):
    fired = threading.Event()
    listener = sup_lib.PreemptionListener(grace_secs=0.05,
                                          on_grace_exceeded=fired.set)
    listener.trigger()
    assert fired.wait(5.0), "grace backstop never fired"
    listener.uninstall()


@pytest.mark.parametrize("sup_lib", MODULES)
def test_no_grace_timer_without_grace(sup_lib):
    fired = threading.Event()
    listener = sup_lib.PreemptionListener(grace_secs=0.0,
                                          on_grace_exceeded=fired.set)
    listener.trigger()
    assert not fired.wait(0.2)


@pytest.mark.parametrize("sup_lib", MODULES)
def test_watchdog_fires_on_stall_and_writes_record(sup_lib, tmp_path):
    records = []
    wd = sup_lib.Watchdog(0.05, first_step_factor=1.0, record_dir=str(tmp_path),
                          poll_s=0.01, on_stall=records.append)
    wd.start()
    wd.heartbeat(1)
    wd.heartbeat(2)  # two beats: the steady-state deadline is armed
    deadline = time.monotonic() + 5.0
    while not wd.fired and time.monotonic() < deadline:
        time.sleep(0.01)
    wd.stop()
    assert wd.fired and records
    assert records[0]["last_step"] == 2
    assert records[0]["kind"] == "watchdog_stall"
    rec = json.loads((tmp_path / sup_lib.STALL_RECORD).read_text())
    assert rec["last_step"] == 2 and rec["pid"] == os.getpid()
    assert set(rec) == {"kind", "pid", "last_step", "heartbeat_age_s",
                        "deadline_s", "wall_time"}


@pytest.mark.parametrize("sup_lib", MODULES)
def test_watchdog_does_not_fire_while_heartbeating(sup_lib):
    wd = sup_lib.Watchdog(0.2, first_step_factor=1.0, poll_s=0.02,
                          on_stall=lambda r: None)
    wd.start()
    t0 = time.monotonic()
    step = 0
    while time.monotonic() - t0 < 0.8:
        wd.heartbeat(step)
        step += 1
        time.sleep(0.02)
    assert not wd.fired
    wd.stop()


@pytest.mark.parametrize("sup_lib", MODULES)
def test_watchdog_first_step_gets_scaled_deadline(sup_lib):
    wd = sup_lib.Watchdog(0.05, first_step_factor=100.0, poll_s=0.01,
                          on_stall=lambda r: None)
    wd.start()
    wd.heartbeat(0)  # one beat only: still inside the first step
    time.sleep(0.3)  # 6x the steady deadline
    assert not wd.fired, "watchdog fired during the first step"
    wd.stop()


@pytest.mark.parametrize("sup_lib", MODULES)
def test_watchdog_rejects_nonpositive_deadline(sup_lib):
    with pytest.raises(ValueError) as err:
        sup_lib.Watchdog(0.0)
    assert "must be > 0" in str(err.value)


@pytest.mark.parametrize("sup_lib", MODULES)
def test_guard_nonfinite_always_diverges(sup_lib):
    g = sup_lib.DivergenceGuard()
    assert g.check(1, float("nan"))
    assert g.check(2, float("inf"))
    assert g.check(3, 4.2) is None


@pytest.mark.parametrize("sup_lib", MODULES)
def test_guard_spike_detection_after_warmup(sup_lib):
    g = sup_lib.DivergenceGuard(spike_factor=3.0, warmup_steps=3)
    for s in range(3):
        assert g.check(s, 1.0) is None
    assert g.check(3, 100.0) is not None  # 100 > 3 x EMA(1.0)
    g.reset()
    assert g.check(4, 100.0) is None  # warming up again


@pytest.mark.parametrize("sup_lib", MODULES)
def test_guard_no_spike_detection_by_default(sup_lib):
    g = sup_lib.DivergenceGuard()
    for s in range(10):
        assert g.check(s, 1.0) is None
    assert g.check(10, 1e9) is None


@pytest.mark.parametrize("sup_lib", MODULES)
def test_faults_from_env_and_one_shot(sup_lib, monkeypatch):
    monkeypatch.setenv(sup_lib.ENV_FAULT_NAN_AT, "3")
    monkeypatch.setenv(sup_lib.ENV_FAULT_HANG_AT, "7")
    monkeypatch.setenv(sup_lib.ENV_FAULT_STEP_DELAY, "0.5")
    faults = sup_lib.FaultInjection.from_env()
    assert (faults.hang_at, faults.nan_at, faults.step_delay_s) == (7, 3, 0.5)
    assert not faults.take_nan(2)
    assert faults.take_nan(3)
    assert not faults.take_nan(3)  # one-shot: a rollback replay is safe


@pytest.mark.parametrize("sup_lib", MODULES)
def test_faults_unarmed_are_inert(sup_lib, monkeypatch):
    for name in (sup_lib.ENV_FAULT_HANG_AT, sup_lib.ENV_FAULT_NAN_AT,
                 sup_lib.ENV_FAULT_STEP_DELAY):
        monkeypatch.delenv(name, raising=False)
    faults = sup_lib.FaultInjection.from_env()
    assert not faults.take_nan(1)
    faults.maybe_hang(1)  # returns immediately
    faults.pace()
    assert faults.step_delay_s == 0.0


@pytest.mark.parametrize("sup_lib", MODULES)
def test_supervisor_context_manager_and_rollback_budget(sup_lib):
    with sup_lib.Supervisor(install_signals=False, max_rollbacks=2) as sup:
        assert not sup.preempt_requested
        assert sup.check_loss(1, 2.5) is None
        assert sup.check_loss(2, float("nan")) is not None
        assert sup.note_rollback()
        assert sup.note_rollback()
        assert not sup.note_rollback()  # budget exhausted -> halt


@pytest.mark.parametrize("sup_lib", MODULES)
def test_supervisor_watchdog_wired_through(sup_lib):
    stalls = []
    with sup_lib.Supervisor(install_signals=False, watchdog_secs=0.05,
                            first_step_factor=1.0,
                            on_stall=stalls.append) as sup:
        sup.heartbeat(0)
        sup.heartbeat(1)
        deadline = time.monotonic() + 5.0
        while not stalls and time.monotonic() < deadline:
            time.sleep(0.01)
    assert stalls and stalls[0]["last_step"] == 1


@pytest.mark.parametrize("sup_lib,data_lib", WITH_DATA)
def test_preemption_event_reaches_prefetch(sup_lib, data_lib):
    release = threading.Event()

    def wedged():
        yield np.zeros((1,), np.int32)
        release.wait(30.0)  # a hung data source
        yield np.ones((1,), np.int32)

    # grace_secs=0: an armed grace timer would force-exit this process
    sup = sup_lib.Supervisor(install_signals=False, grace_secs=0.0)
    it = data_lib.prefetch(wedged(), depth=2, stop=sup.preemption.event)
    try:
        next(it)
        threading.Timer(0.1, sup.preemption.trigger).start()
        t0 = time.monotonic()
        with pytest.raises(StopIteration):
            next(it)
        assert time.monotonic() - t0 < 5.0
    finally:
        release.set()
        sup.preemption.uninstall()


def test_exit_codes_and_fault_hooks_match_jax():
    for name in ("EXIT_STALLED", "EXIT_DIVERGED", "EXIT_GRACE_EXCEEDED",
                 "STALL_RECORD", "ENV_FAULT_HANG_AT", "ENV_FAULT_NAN_AT",
                 "ENV_FAULT_STEP_DELAY"):
        assert getattr(tsup, name) == getattr(jsup, name)


def test_take_nan_poisons_the_tree_in_place(monkeypatch):
    monkeypatch.setenv(tsup.ENV_FAULT_NAN_AT, "2")
    faults = tsup.FaultInjection.from_env()
    w = torch.ones(3, 2, requires_grad=True)
    params = {"embed": w, "layers": {"wq": torch.ones(2, 2, requires_grad=True)}}
    assert not faults.take_nan(1, params)
    assert bool(torch.isfinite(w).all())
    assert faults.take_nan(2, params)
    assert params["embed"] is w and w.requires_grad
    assert bool(torch.isnan(w).all()) and bool(torch.isnan(params["layers"]["wq"]).all())


def test_flag_registry_covers_the_port_reads():
    from hivedscheduler_tpu.common import envflags as jflags

    assert set(envflags.REGISTRY) == {
        "HIVED_GOODPUT", "HIVED_FAULT_HANG_AT", "HIVED_FAULT_NAN_AT",
        "HIVED_FAULT_STEP_DELAY", "HIVED_FAULT_SERVE_PREEMPT_AT", "HIVED_PAGED_KV",
        "HIVED_JOURNAL", "HIVED_TRACE", "HIVED_SLO_WINDOW_S", "HIVED_LOCKCHECK",
        "HIVED_FLEET_KV_SHIP", "HIVED_FLEET_AUTOSCALE_COOLDOWN_S", "HIVED_COMPILE_GUARD",
        "HIVED_OVERLAP"}
    for name, flag in envflags.REGISTRY.items():
        assert flag.default == jflags.REGISTRY[name].default
        assert flag.module.startswith("hivedscheduler_tpu_torch/")
    with pytest.raises(KeyError) as err:
        envflags.get("HIVED_NOT_A_FLAG")
    assert "not a registered HIVED flag" in str(err.value)
