"""The port's goodput ledger (hivedscheduler_tpu_torch.obs.goodput) held to
the JAX package's: one scripted phase sequence with injected ``at=`` times
through both ledgers gives equal totals, snapshots and spool records, and
the JAX package's spool readers accept the port's spool (the spool is the
interface to the cluster's capacity ledger)."""

import json

import pytest

from hivedscheduler_tpu.obs import goodput as jgp
from hivedscheduler_tpu_torch.obs import goodput as tgp


def _ledgers():
    j = jgp.GoodputLedger(metrics=False)
    t = tgp.GoodputLedger()
    j.enabled = t.enabled = True
    return j, t


def _script(led, seed_max=0):
    """A resumed incarnation: bring-up, a restore, a reworked first step,
    new steps with data waits, a checkpoint, an eval window, wrap-up."""
    if seed_max:
        led.seed_max_step(seed_max)
    led.start(at=0.0)
    led.phase("checkpoint_restore", at=1.5)
    led.phase("data_wait", at=2.0)
    led.note_step(3, is_compile=True, at=2.25)
    led.note_step_done(3, at=4.0)
    for i, step in enumerate((4, 5, 6)):
        t = 4.0 + i
        led.phase("data_wait", at=t)
        led.note_step(step, is_compile=False, at=t + 0.125)
        led.note_step_done(step, at=t + 1.0)
    led.phase("checkpoint_save", at=7.0)
    led.phase("eval", at=7.75)
    led.phase("idle", at=8.5)


def test_scripted_sequence_gives_equal_totals_snapshot_and_spool(tmp_path):
    j, t = _ledgers()
    sj, st = str(tmp_path / "j.jsonl"), str(tmp_path / "t.jsonl")
    j.open_spool(sj)
    t.open_spool(st)
    _script(j, seed_max=3)
    _script(t, seed_max=3)
    for at in (8.5, 9.0, 9.75):
        assert t.totals(at=at) == j.totals(at=at)
        assert t.snapshot(at=at) == j.snapshot(at=at)
        assert t.conservation_gap(at=at) == j.conservation_gap(at=at) == 0.0
        assert t.goodput_fraction(at=at) == j.goodput_fraction(at=at)
    assert t.current_phase() == j.current_phase() == "idle"
    j.close(at=10.0)
    t.close(at=10.0)
    assert t.wallclock(at=99.0) == j.wallclock(at=99.0) == 10.0
    recs_j, recs_t = jgp.read_spool(sj), jgp.read_spool(st)
    assert recs_t == recs_j
    kinds = [r["kind"] for r in recs_t]
    assert kinds[0] == "start" and kinds[-1] == "summary"
    assert kinds.count("step") == 4
    summary = recs_t[-1]
    assert summary["rework_steps"] == 1 and summary["max_step"] == 6
    assert summary["phases"]["step_compute"] == 2.625
    # the JAX package's readers accept the port's spool as its own
    assert jgp.check_spool(st) == [] == tgp.check_spool(st)
    # the high-water mark was seeded by hand, not by an earlier incarnation's
    # records in this spool, so the replay flags the reworked step 3: alike
    flagged = jgp.check_rework_classification(recs_t)
    assert flagged == tgp.check_rework_classification(recs_t)
    assert len(flagged) == 1 and "step 3" in flagged[0]
    assert jgp.aggregate_spool(recs_t) == tgp.aggregate_spool(tgp.read_spool(st))
    assert jgp.spool_max_step(st) == tgp.spool_max_step(st) == 6


def test_spool_readers_agree_across_incarnations(tmp_path):
    # a torn first incarnation (no summary) and a resumed second one in one
    # spool, plus a torn trailing line
    sp = tmp_path / "g.jsonl"
    j, t = _ledgers()
    t.open_spool(str(sp))
    t.start(at=0.0)
    t.note_step(1, is_compile=True, at=1.0)
    t.note_step_done(1, at=2.0)
    t.note_step(2, at=2.0)
    t.note_step_done(2, at=3.0)  # then kill -9: no close()
    t2 = tgp.GoodputLedger()
    t2.enabled = True
    t2.open_spool(str(sp))
    t2.seed_max_step(tgp.spool_max_step(str(sp)))
    t2.start(at=10.0)
    t2.note_step(2, is_compile=True, at=11.0)  # rework, over compile
    t2.note_step_done(2, at=12.0)
    t2.note_step(3, at=12.0)
    t2.note_step_done(3, at=13.0)
    t2.close(at=14.0)
    with open(sp, "a") as f:
        f.write('{"kind": "pha')
    recs = tgp.read_spool(str(sp))
    assert recs == jgp.read_spool(str(sp))
    agg = tgp.aggregate_spool(recs)
    assert agg == jgp.aggregate_spool(recs)
    assert (agg["incarnations"], agg["torn"], agg["steps"], agg["rework_steps"]) == (2, 1, 4, 1)
    assert tgp.check_rework_classification(recs) == jgp.check_rework_classification(recs) == []
    assert tgp.check_spool(str(sp)) == jgp.check_spool(str(sp)) == []


def test_check_spool_flags_the_same_violations(tmp_path):
    sp = tmp_path / "bad.jsonl"
    sp.write_text("\n".join(json.dumps(r) for r in [
        {"kind": "start", "pid": 1, "t0": 0.0, "phase": "init"},
        {"kind": "phase", "pid": 1, "phase": "made_up", "start": 0.0, "end": 1.0},
        {"kind": "summary", "pid": 1, "wallclock_s": 5.0,
         "phases": {"init": 1.0, "made_up": 1.0}, "steps": 0,
         "rework_steps": 0, "max_step": 0},
        {"kind": "step", "pid": 1, "step": 1, "rework": True},
    ]) + "\n")
    got = tgp.check_spool(str(sp))
    assert got == jgp.check_spool(str(sp)) and len(got) == 3
    recs = tgp.read_spool(str(sp))
    assert tgp.check_rework_classification(recs) == jgp.check_rework_classification(recs)
    assert len(tgp.check_rework_classification(recs)) == 1


@pytest.mark.parametrize("busy,observed,slack", [
    (10.0, 9.5, 1.0), (10.0, 10.5, 1.0), (10.0, 5.0, 1.0), (3.0, 3.0, 0.0)])
def test_reconcile_busy_matches_jax(busy, observed, slack):
    assert tgp.reconcile_busy(busy, observed, slack) == \
        jgp.reconcile_busy(busy, observed, slack)


def test_registry_and_goodput_phases_match_jax():
    assert list(tgp.STEP_PHASES) == list(jgp.STEP_PHASES)
    assert tgp.GOODPUT_PHASES == jgp.GOODPUT_PHASES


def test_unregistered_phase_raises_and_disabled_is_inert():
    j, t = _ledgers()
    t.start(at=0.0)
    with pytest.raises(ValueError) as err:
        t.phase("made_up_phase", at=1.0)
    assert "not a registered step phase" in str(err.value)
    off = tgp.GoodputLedger()
    off.start(at=0.0)
    off.note_step(1, at=1.0)
    with off.span("drain", at=1.0):
        pass
    assert off.totals(at=2.0) == {} and off.goodput_fraction(at=2.0) is None
    assert off.current_phase() is None


def test_span_restores_the_surrounding_phase():
    _, t = _ledgers()
    t.start(at=0.0)
    t.phase("step_compute", at=1.0)
    with t.span("checkpoint_save", at=2.0):
        assert t.current_phase() == "checkpoint_save"
    assert t.current_phase() == "step_compute"
    assert t.totals()["checkpoint_save"] > 0.0
    assert abs(t.conservation_gap()) < 1e-6


def test_module_enable_spools_and_seeds(tmp_path):
    sp = tmp_path / "g.jsonl"
    sp.write_text(json.dumps({"kind": "step", "pid": 1, "step": 7,
                              "rework": False}) + "\n")
    try:
        tgp.enable(spool_path=str(sp))
        assert tgp.enabled()
        tgp.note_step(5, is_compile=True)
        assert tgp.GOODPUT.current_phase() == "rework"
        tgp.note_step_done(5)
        with tgp.span("checkpoint_save"):
            pass
        tgp.GOODPUT.close()
    finally:
        tgp.disable()
        tgp.GOODPUT.clear()
    recs = tgp.read_spool(str(sp))
    assert [r["kind"] for r in recs][:2] == ["step", "start"]
    assert recs[-1]["kind"] == "summary" and recs[-1]["rework_steps"] == 1
    assert jgp.check_spool(str(sp)) == []
