"""The port's serving fleet (hivedscheduler_tpu_torch.fleet) against the JAX
package's on the same weights, carried across by
hivedscheduler_tpu_torch.bridge.

Each case drives JAX's ``FleetRouter`` and the port's through the same
operations (prompts, kills, drains, clock) over config-identical engines of
their own package, and requires the same outcome: every request's tokens,
finish reason, retries and replicas; the handoff, retry and affinity
counts; each replica's prefix hits and tokens reused; the snapshot; the
autoscaler's decisions tick for tick; the journal's flights leg for leg.
Both ``HIVED_FLEET_KV_SHIP`` modes. Then the port's own pieces against
JAX's: ``FleetConfig`` and its YAML reader, ``check_fleet`` and
``check_requests`` on planted faults, the engines' ``export_prefix`` /
``import_prefix`` (paged, dense, int8 KV) and ``compileguard``.

The model is the JAX fleet tests' (vocab 64, d_model 32, 2 heads, one
layer, f32, page 8).
"""

import dataclasses
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu import fleet as jfleet
from hivedscheduler_tpu.chaos import invariants as jinv
from hivedscheduler_tpu.common import lockcheck as jlock
from hivedscheduler_tpu.models import serving as jsrv
from hivedscheduler_tpu.models import speculative as jspec
from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu.obs import journal as jjournal
from hivedscheduler_tpu.obs import slo as jslo
from hivedscheduler_tpu.obs import trace as jtrace
from hivedscheduler_tpu.runtime import metrics as jmetrics
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch import fleet as tfleet
from hivedscheduler_tpu_torch.chaos import invariants as tinv
from hivedscheduler_tpu_torch.common import compileguard as tcg
from hivedscheduler_tpu_torch.common import lockcheck as tlock
from hivedscheduler_tpu_torch.models import serving as tsrv
from hivedscheduler_tpu_torch.models import speculative as tspec
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.obs import journal as tjournal
from hivedscheduler_tpu_torch.obs import slo as tslo
from hivedscheduler_tpu_torch.obs import trace as ttrace
from hivedscheduler_tpu_torch.runtime import metrics as tmetrics

torch.set_num_threads(1)

MODEL = dict(vocab_size=64, d_model=32, n_heads=2, n_kv_heads=2, n_layers=1, d_ff=64,
             max_seq_len=64)
FLEET_YAML = "example/config/design/fleet.yaml"
PROMPTS = [list(range(1, 12)), [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9]]

PKG = {
    "jax": types.SimpleNamespace(fleet=jfleet, srv=jsrv, inv=jinv, journal=jjournal,
                                 slo=jslo, spec=jspec),
    "port": types.SimpleNamespace(fleet=tfleet, srv=tsrv, inv=tinv, journal=tjournal,
                                  slo=tslo, spec=tspec),
}


def _reset():
    """Both packages' journal, tracer, metrics registry, lockcheck stack,
    published router (and the port's capture counters)."""
    for journal, trace, registry, lock, fleet in (
            (jjournal, jtrace, jmetrics.REGISTRY, jlock, jfleet),
            (tjournal, ttrace, tmetrics.REGISTRY, tlock, tfleet)):
        journal.disable()
        journal.JOURNAL.clear()
        trace.disable()
        trace.TRACER.clear()
        with registry._lock:
            registry._counters.clear()
            registry._gauges.clear()
            registry._histograms.clear()
        lock._tls.stack = []
        fleet.publish(None)
    tcg.reset()


@pytest.fixture(autouse=True)
def _isolation():
    _reset()
    yield
    _reset()


@pytest.fixture(scope="module")
def models():
    """{package: (cfg, params)}, f32, the same weights."""
    params = jax.device_get(jtm.init_params(
        jtm.TransformerConfig(dtype=jnp.float32, **MODEL), jax.random.PRNGKey(0)))
    return {
        "jax": (jtm.TransformerConfig(dtype=jnp.float32, **MODEL),
                jax.tree.map(jnp.asarray, params)),
        "port": (ttm.TransformerConfig(dtype=torch.float32, **MODEL),
                 bridge.from_numpy_tree(params)),
    }


def make_engine(models, pkg, paged=True, prefix_cache=8, **kw):
    cfg, params = models[pkg]
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 64)
    if paged:
        kw.setdefault("page_size", 8)
    return PKG[pkg].srv.ServingEngine(params, cfg, prefix_cache_size=prefix_cache, **kw)


_REF = {}


def reference(models, prompt, budget):
    """The port's single-engine stream (one shared paged engine serves
    every reference: a greedy stream depends only on params and prompt)."""
    key = (tuple(prompt), budget)
    if key not in _REF:
        eng = _REF.setdefault("eng", make_engine(models, "port"))
        req = eng.submit(list(prompt), budget)
        eng.run_until_drained()
        _REF[key] = list(req.tokens_out)
    return _REF[key]


def summary(r):
    """What a fleet run decided, in plain values."""
    return dict(
        requests=[(f.fid, list(f.tokens_out), f.finish_reason, f.retries, f.replica,
                   [n for n, _ in f.attempts], f.handoff is not None, f.done)
                  for f in r.requests],
        handoffs=dict(r.handoffs), retried=r.retried, affinity=r.affinity_hits,
        replicas={n: (rep.role, rep.state, rep.routed, rep.engine.prefix_hits,
                      rep.engine.prefix_tokens_reused) for n, rep in r.replicas.items()},
        removed=[(rep.name, rep.state) for rep in r.removed],
        snapshot=r.snapshot())


def flight_legs(pkg):
    """{flight: (legs, terminal, terminals)} of ``pkg``'s journal."""
    return {k: ([leg for leg, _, _ in f["legs"]], f["terminal"], f["terminals"])
            for k, f in PKG[pkg].journal.JOURNAL.flights().items()}


def both(run):
    """``run(pkg)`` for each package; the two results must be equal."""
    out = {pkg: run(pkg) for pkg in PKG}
    assert out["port"] == out["jax"]
    return out["port"]


# -- routing policies ---------------------------------------------------------------
def test_least_blocks_spread_snapshot_publish(models):
    def run(pkg):
        p = PKG[pkg]
        r = p.fleet.FleetRouter()
        r.add_replica("a", make_engine(models, pkg))
        r.add_replica("b", make_engine(models, pkg))
        f1, f2 = r.submit(PROMPTS[0], 4), r.submit(PROMPTS[1], 4)
        assert {f1.replica, f2.replica} == {"a", "b"}
        r.run_until_drained()
        p.inv.check_fleet(r, "least-blocks")
        p.fleet.publish(r)
        assert p.fleet.published() is r
        p.fleet.publish(None)
        assert p.fleet.published() is None
        return summary(r)

    out = both(run)
    assert [f[2] for f in out["requests"]] == ["length", "length"]
    assert out["snapshot"]["requests"]["done"] == 2


def test_prefix_affinity_routes_to_caching_replica(models):
    system = list(range(1, 17))  # two full blocks: indexable boundaries

    def run(pkg):
        r = PKG[pkg].fleet.FleetRouter(policy="prefix_affinity")
        r.add_replica("a", make_engine(models, pkg))
        r.add_replica("b", make_engine(models, pkg))
        f1 = r.submit(system + [40, 41], 3)
        r.run_until_drained()
        f2 = r.submit(system + [50, 51, 52], 3)
        assert f2.replica == f1.replica  # the idle replica lost to the index
        r.run_until_drained()
        PKG[pkg].inv.check_fleet(r, "affinity")
        return summary(r)

    out = both(run)
    assert out["affinity"] >= 1
    assert max(v[3] for v in out["replicas"].values()) >= 1  # a real prefix hit


def test_shed_retry_token_exact_then_exhausted(models):
    """A shed waiter retries on another replica, token-exact; with no
    alternative left, the retries exhaust and it finishes shed."""
    def run(pkg):
        clk = [0.0]
        r = PKG[pkg].fleet.FleetRouter(clock=lambda: clk[0])
        r.add_replica("a", make_engine(models, pkg, max_batch=1, queue_timeout_s=0.5,
                                       clock=lambda: clk[0]))
        f1, f2 = r.submit(PROMPTS[0], 8), r.submit(PROMPTS[1], 8)
        r.step()
        r.add_replica("b", make_engine(models, pkg, max_batch=1, clock=lambda: clk[0]))
        clk[0] = 1.0
        r.run_until_drained()
        PKG[pkg].inv.check_fleet(r, "shed-retry")
        r.kill("b")
        r.submit(PROMPTS[0], 8)
        r.submit(PROMPTS[1], 8)
        r.step()
        clk[0] = 2.0
        r.run_until_drained()
        PKG[pkg].inv.check_fleet(r, "shed-exhausted")
        return summary(r)

    out = both(run)
    reqs = out["requests"]
    assert reqs[1][3] == 1 and reqs[1][4] == "b" and reqs[1][2] == "length"
    assert reqs[1][1] == reference(models, PROMPTS[1], 8)
    assert reqs[3][2] == "shed" and reqs[3][1] == []


# -- disaggregation -------------------------------------------------------------------
@pytest.mark.parametrize("kv_ship", [True, False])
def test_disaggregated_token_exact_in_both_handoff_modes(models, kv_ship, monkeypatch):
    monkeypatch.setenv("HIVED_FLEET_KV_SHIP", "1" if kv_ship else "0")

    def run(pkg):
        r = PKG[pkg].fleet.FleetRouter(disaggregate=True)
        assert r.kv_ship is kv_ship  # the flag selects the mode
        r.add_replica("p0", make_engine(models, pkg), role="prefill")
        r.add_replica("d0", make_engine(models, pkg), role="decode")
        for p in PROMPTS:
            r.submit(p, 6)
        r.run_until_drained()
        PKG[pkg].inv.check_fleet(r, f"disagg ship={kv_ship}")
        return summary(r)

    out = both(run)
    for req, prompt in zip(out["requests"], PROMPTS):
        assert req[1] == reference(models, prompt, 6)
    dec = out["replicas"]["d0"]
    if kv_ship:
        assert out["handoffs"]["ship"] == len(PROMPTS)
        # the decode legs restore the shipped 8-token leading block
        assert dec[3] == len(PROMPTS) and dec[4] == 8 * len(PROMPTS)
    else:
        assert out["handoffs"]["reprefill"] == len(PROMPTS)


def test_ship_mode_refusals(models):
    """A speculative engine and an engine without a prefix cache are
    refused in ship mode with JAX's messages; both are accepted elsewhere."""
    said = {}
    for pkg in PKG:
        p = PKG[pkg]
        cfg, params = models[pkg]
        dcfg = p.spec.derive_draft_config(cfg, 1, 0)
        if pkg == "jax":
            dparams = jtm.init_params(dcfg, jax.random.PRNGKey(7))
        else:
            dparams = ttm.init_params(dcfg, torch.Generator().manual_seed(7))
        spec = p.srv.ServingEngine(params, cfg, max_batch=2, max_len=64, prefix_cache_size=8,
                                   spec_decode=p.spec.SpecDecodeConfig(
                                       draft_params=dparams, draft_cfg=dcfg, gamma=2))
        r = p.fleet.FleetRouter(disaggregate=True, kv_ship=True)
        with pytest.raises(ValueError) as spec_err:
            r.add_replica("p0", spec, role="prefill")
        with pytest.raises(ValueError) as cache_err:
            r.add_replica("p0", make_engine(models, pkg, prefix_cache=0), role="prefill")
        p.fleet.FleetRouter(disaggregate=True, kv_ship=False).add_replica("p0", spec)
        p.fleet.FleetRouter(kv_ship=True).add_replica("s0", spec)
        with pytest.raises(ValueError) as role_err:
            r.add_replica("x", make_engine(models, pkg), role="draft")
        with pytest.raises(ValueError) as policy_err:
            p.fleet.FleetRouter(policy="round_robin")
        said[pkg] = [str(e.value) for e in (spec_err, cache_err, role_err, policy_err)]
    assert said["port"] == said["jax"]
    assert "HIVED_FLEET_KV_SHIP=0" in said["port"][0]
    assert "prefix_cache_size > 0" in said["port"][1]


# -- chaos: kills mid-handoff and a seeded soak, journal on ---------------------------
@pytest.mark.parametrize("victim", ["decode", "prefill"])
def test_kill_replica_mid_handoff(models, victim):
    def run(pkg):
        p = PKG[pkg]
        p.journal.enable()
        r = p.fleet.FleetRouter(disaggregate=True, kv_ship=True)
        roles = (["prefill", "decode", "decode"] if victim == "decode"
                 else ["prefill", "prefill", "decode"])
        for i, role in enumerate(roles):
            r.add_replica(f"{role[0]}{i}", make_engine(models, pkg), role=role)
        prompt = list(range(1, 20))
        f = r.submit(prompt, 8)
        if victim == "decode":
            for _ in range(200):  # until the decode leg is in flight
                r.step()
                if f.handoff is None and f.attempts and not f.done:
                    break
            assert f.handoff is None and f.replica
            lost = f.replica
        else:
            lost = f.handoff["replica"]
        r.kill(lost)
        r.step()
        p.inv.check_fleet(r, "post-kill")
        assert f.retries == 1
        r.run_until_drained()
        p.inv.check_fleet(r, "post-drain")
        assert f.tokens_out == reference(models, prompt, 8)
        return summary(r), flight_legs(pkg)

    (out, legs) = both(run)
    assert "retry" in legs["fleet/0"][0] and legs["fleet/0"][1:] == ("length", 1)


def test_seeded_soak_replayed_op_for_op(models):
    """JAX's fast soak (seed 7, 12 ops of submit/add/kill/drain/step) on
    both routers, with the journal on and check_fleet after every op."""
    def run(pkg):
        p = PKG[pkg]
        p.journal.enable()
        rng = random.Random(7)
        r = p.fleet.FleetRouter(policy="prefix_affinity", disaggregate=True, kv_ship=True)
        r.add_replica("p0", make_engine(models, pkg), role="prefill")
        r.add_replica("d0", make_engine(models, pkg), role="decode")
        r.add_replica("d1", make_engine(models, pkg), role="decode")
        system = list(range(1, 9))
        added, ops = 0, []
        for i in range(12):
            op = rng.random()
            decs = [n for n, rep in r.replicas.items()
                    if rep.role == "decode" and rep.state == "active"]
            if op < 0.45:
                tail = [rng.randrange(1, 60) for _ in range(rng.randrange(2, 8))]
                r.submit(system + tail, rng.randrange(2, 5))
                ops.append("submit")
            elif op < 0.55 and added < 3:
                added += 1
                r.add_replica(f"dx{added}", make_engine(models, pkg), role="decode")
                ops.append("add")
            elif op < 0.65:
                if len(decs) > 1:
                    r.kill(rng.choice(decs))
                ops.append("kill")
            elif op < 0.75:
                if len(decs) > 1:
                    r.begin_drain(rng.choice(decs))
                ops.append("drain")
            else:
                r.step()
                ops.append("step")
            r.step()
            p.inv.check_fleet(r, f"soak op={i}")
            for name, rep in list(r.replicas.items()):
                if rep.state == "drained":
                    r.remove_replica(name)
        r.run_until_drained()
        p.inv.check_fleet(r, "soak end")
        return summary(r), flight_legs(pkg), ops

    out, _legs, ops = both(run)
    assert "submit" in ops and len(ops) == 12
    for req in out["requests"]:
        assert req[7]  # done


# -- the autoscaler, decision for decision ---------------------------------------------
def _autoscaled(models, pkg, policy_kw, clk, engines=1, grow=True):
    p = PKG[pkg]
    seq = [0]

    def factory(role):
        if not grow:
            return None
        seq[0] += 1
        return f"auto{seq[0]}", make_engine(models, pkg)

    r = p.fleet.FleetRouter(clock=lambda: clk[0])
    for i in range(engines):
        r.add_replica(f"r{i}", make_engine(models, pkg))
    a = p.fleet.FleetAutoscaler(r, p.fleet.LocalScaleBackend(factory),
                                p.fleet.AutoscalePolicy(**policy_kw), clock=lambda: clk[0])
    return r, a


def test_autoscaler_up_needs_stable_pressure_and_cooldown(models):
    def run(pkg):
        clk = [0.0]
        r, a = _autoscaled(models, pkg, dict(max_replicas=4, queue_high=0.5,
                                             up_stable_ticks=2, cooldown_s=10.0), clk)
        for _ in range(8):
            r.submit(PROMPTS[0], 4)
        seen = []
        for t in (100.0, 100.5, 101.0, 105.0, 111.0, 112.0):
            clk[0] = t
            seen.append((t, a.tick(), len(r.replicas), a.signals("serve")))
        r.run_until_drained()
        PKG[pkg].inv.check_fleet(r, "up")
        return seen, dict(a.target), summary(r)

    seen, target, _ = both(run)
    sizes = [n for _, _, n, _ in seen]
    assert sizes[0] == 1 and sizes[1] == 2  # two ticks of pressure scale once
    assert sizes[2:4] == [2, 2] and sizes[4] == 3  # the cooldown holds, then expires
    assert target == {"serve": 3}


def test_autoscaler_scale_down_is_drain_based_and_floored(models):
    def run(pkg):
        clk = [0.0]
        r, a = _autoscaled(models, pkg, dict(min_replicas=1, max_replicas=3,
                                             down_stable_ticks=2, cooldown_s=0.0),
                           clk, engines=2)
        seen = [a.tick(), a.tick()]
        r.step()  # the router observes the drain
        seen.append(a.tick())
        PKG[pkg].inv.check_fleet(r, "drain-down")
        for i in range(8):
            clk[0] = float(i)
            seen.append(a.tick())
        return seen, len(r.replicas), [x.name for x in r.removed], a.replica_seconds

    seen, n, removed, cost = both(run)
    phases = [x["phase"] for acts in seen for x in acts]
    assert phases[:2] == ["draining", "removed"] and n == 1 and removed == ["r0"]
    assert cost == pytest.approx(7.0)  # one live replica over 7 s


def test_autoscaler_replica_seconds_signals_and_pending_grow(models):
    def run(pkg):
        clk = [0.0]
        r, a = _autoscaled(models, pkg, dict(cooldown_s=0.0), clk)
        a.tick()
        clk[0] = 5.0
        a.tick()
        cost = a.replica_seconds
        for _ in range(3):
            r.submit(PROMPTS[0], 2)
        sig = a.signals("serve")
        r.run_until_drained()
        # a backend that grants nothing: the grow is reported pending
        r2, a2 = _autoscaled(models, pkg, dict(max_replicas=4, queue_high=0.5,
                                               up_stable_ticks=1, cooldown_s=0.0),
                             clk, grow=False)
        for _ in range(8):
            r2.submit(PROMPTS[1], 2)
        pending = a2.tick()
        r2.run_until_drained()
        return cost, sig, pending, len(r2.replicas)

    cost, sig, pending, n = both(run)
    assert cost == pytest.approx(5.0)
    assert set(sig) == {"replicas", "occupancy", "queueDepth", "ttftP95", "ttftP99"}
    assert sig["replicas"] == 1 and sig["queueDepth"] >= 1 and 0.0 <= sig["occupancy"] <= 1.0
    assert pending == [{"role": "serve", "direction": "up", "phase": "pending",
                        "reason": "queue"}] and n == 1


def test_autoscaler_cooldown_reads_the_flag(monkeypatch):
    monkeypatch.setenv("HIVED_FLEET_AUTOSCALE_COOLDOWN_S", "7.5")
    assert tfleet.AutoscalePolicy().resolved_cooldown() == \
        jfleet.AutoscalePolicy().resolved_cooldown() == 7.5
    monkeypatch.delenv("HIVED_FLEET_AUTOSCALE_COOLDOWN_S")
    assert tfleet.AutoscalePolicy().resolved_cooldown() == 30.0


# -- journal flights -----------------------------------------------------------------
@pytest.mark.parametrize("kv_ship", [True, False])
def test_fleet_flights_match_jax(models, kv_ship):
    """On one stepped virtual clock: the same flights, legs and leg times in
    both packages; each flight one terminal, its legs tiling its TTFT; the
    SLO tracker's attribution by dominant leg."""
    def run(pkg):
        p = PKG[pkg]
        p.journal.enable()
        clk = [0.0]
        tracker = p.slo.SLOTracker(objectives=(p.slo.SLObjective("ttft", 0.99,
                                                                 ceiling_s=1e-9),),
                                   window_s=0.0, metrics=False, clock=lambda: clk[0])
        r = p.fleet.FleetRouter(disaggregate=True, kv_ship=kv_ship, slo=tracker,
                                clock=lambda: clk[0])
        r.add_replica("p0", make_engine(models, pkg, clock=lambda: clk[0]), role="prefill")
        r.add_replica("d0", make_engine(models, pkg, clock=lambda: clk[0]), role="decode")
        plan = [(0, list(range(1, 14)), 4), (0, list(range(2, 10)), 3),
                (2, list(range(5, 25)), 5)]
        reqs, step = [], 0
        while plan or not all(f.done for f in reqs):
            clk[0] = float(step)
            while plan and plan[0][0] <= step:
                _, prompt, budget = plan.pop(0)
                reqs.append(r.submit(prompt, budget))
            clk[0] = step + 0.5
            r.step()
            step += 1
        p.inv.check_fleet(r, "flights")
        flights = p.journal.JOURNAL.flights()
        for f in reqs:
            fl = flights[f"fleet/{f.fid}"]
            assert fl["terminals"] == 1 and fl["terminal"] == f.finish_reason
            assert fl["ttft_gap"] == pytest.approx(0.0, abs=1e-9)
        obj = tracker.snapshot(now=clk[0] + 1)["objectives"][0]
        return ({k: (f["legs"], f["terminal"], f["t0"]) for k, f in flights.items()},
                obj["attribution"], summary(r))

    flights, attribution, out = both(run)
    legs = [[leg for leg, _, _ in f[0]] for f in flights.values()]
    assert all(seq[0] == "route" and "admission_wait" in seq for seq in legs)
    if kv_ship:
        assert any("handoff_import" in seq for seq in legs)
    assert attribution and set(attribution) <= set(tjournal.REQUEST_LEGS)


# -- FleetConfig and its YAML reader -----------------------------------------------------
def test_fleet_config_from_yaml_equals_jax():
    port, ref = tfleet.FleetConfig.from_yaml(FLEET_YAML), jfleet.FleetConfig.from_yaml(FLEET_YAML)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.disaggregate and port.autoscale and port.policy == "prefix_affinity"
    assert dataclasses.asdict(port.autoscale_policy()) == \
        dataclasses.asdict(ref.autoscale_policy())
    objectives = [dataclasses.asdict(o) for o in port.slo_tracker(metrics=False).objectives]
    assert objectives == [dataclasses.asdict(o)
                          for o in ref.slo_tracker(metrics=False).objectives]
    assert {o["priority"] for o in objectives} == {None, 10}


def test_fleet_config_unknown_keys_and_missing_section(tmp_path):
    said = []
    for mod in (jfleet, tfleet):
        with pytest.raises(ValueError) as err:
            mod.FleetConfig.from_dict({"replicsa": 3})
        said.append(str(err.value))
    assert said[0] == said[1] and "unknown fleet config keys" in said[1]
    p = tmp_path / "nofleet.yaml"
    p.write_text("physicalCluster: {}\nvirtualClusters:\n  - a\n  - [b, c]\n")
    assert tfleet.FleetConfig.from_yaml(str(p)) is None
    assert jfleet.FleetConfig.from_yaml(str(p)) is None
    p.write_text("other: 1\nfleet:\n  # nothing declared\nafter: [1, 2]\n")
    assert tfleet.read_fleet_section(str(p)) is None
    p.write_text("fleet:\n  replicas: 2\n  slo_ttft_p99_by_priority:\n    0: 1\n    10: 0.25\n"
                 "  occ_high: .5  # a comment\n  policy: least_blocks\n  cooldown_s: -1.0\n"
                 "zzz: {a: [1]}\n")
    cfg = tfleet.FleetConfig.from_yaml(str(p))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jfleet.FleetConfig.from_yaml(str(p)))
    assert cfg.slo_ttft_p99_by_priority == {0: 1.0, 10: 0.25} and cfg.occ_high == 0.5


@pytest.mark.parametrize("body, what", [
    ("  replicas: [1, 2]\n", "flow"),
    ("  replicas: {a: 1}\n", "flow"),
    ("  policy:\n    - least_blocks\n", "nested"),
    ("  - replicas\n", "list"),
    ("  policy: &p least_blocks\n", "anchor"),
    ("  policy: *p\n", "alias"),
    ("  policy: |\n    least_blocks\n", "nested"),
    ("  policy: >\n", "block scalar"),
    ("  policy: least\n    blocks\n", "nested"),
    ("  policy: 'least_blocks'\n", "quoted"),
    ("\treplicas: 2\n", "tab"),
    ("  replicas: 2\n  replicas: 3\n", "second"),
    ("  autoscale: yes\n", "value"),
    ("  slo_ttft_p99_by_priority:\n    x: 0.2\n", "key"),
    ("  slo_ttft_p99_by_priority:\n    10:\n      0.2\n", "more than one level"),
])
def test_fleet_yaml_reader_refuses_what_it_does_not_read(tmp_path, body, what):
    p = tmp_path / "fleet.yaml"
    p.write_text("cluster: x\nfleet:\n" + body)
    with pytest.raises(ValueError) as err:
        tfleet.read_fleet_section(str(p))
    assert "fleet section reader does not accept" in str(err.value)
    assert what in str(err.value)


def test_fleet_yaml_reader_refuses_a_flow_section(tmp_path):
    p = tmp_path / "fleet.yaml"
    p.write_text("fleet: {replicas: 2}\n")
    with pytest.raises(ValueError) as err:
        tfleet.FleetConfig.from_yaml(str(p))
    assert "block mapping" in str(err.value)


# -- check_fleet and check_requests on planted faults ------------------------------------
def _check_msg(inv, fn, *args):
    with pytest.raises(inv.InvariantViolation) as err:
        fn(*args)
    return str(err.value)


def test_check_fleet_sees_planted_faults(models):
    def run(pkg):
        p = PKG[pkg]
        said = []
        r = p.fleet.FleetRouter()
        r.add_replica("a", make_engine(models, pkg))
        r.add_replica("b", make_engine(models, pkg))
        f = r.submit(PROMPTS[0], 6)
        r.step()
        p.inv.check_fleet(r, "clean")
        other = "b" if f.replica == "a" else "a"
        # a request with two live attempts
        stray = r.replicas[other].engine.submit(list(PROMPTS[0]), 6)
        f.attempts.insert(0, (other, stray))
        said.append(_check_msg(p.inv, p.inv.check_fleet, r, "two"))
        f.attempts.pop(0)
        stray.done = True
        # a lost request: its replica died and no step retried it
        r.kill(f.replica)
        said.append(_check_msg(p.inv, p.inv.check_fleet, r, "lost"))
        r.step()
        p.inv.check_fleet(r, "retried")
        # teardown of an active replica, and a stale prefix-index entry
        r.removed.append(r.replicas[other])
        said.append(_check_msg(p.inv, p.inv.check_fleet, r, "teardown"))
        r.removed.pop()
        r._prefix_index[12345] = "gone"
        said.append(_check_msg(p.inv, p.inv.check_fleet, r, "index"))
        return said

    said = both(run)
    assert "double-routed" in said[0] and "lost" in said[1]
    assert "must drain before teardown" in said[2] and "'gone'" in said[3]


def test_check_requests_sees_planted_faults():
    def freq(fid, ttft=None, retries=0):
        return types.SimpleNamespace(fid=fid, done=True, finish_reason="length",
                                     submitted_at=0.0, done_at=5.0, ttft_s=ttft,
                                     retries=retries)

    def run(pkg):
        j, inv = PKG[pkg].journal, PKG[pkg].inv
        j.enable()
        said = []
        # a dropped leg: the legs miss the TTFT
        j.note_request_submit("fleet/0", at=0.0)
        j.note_leg("fleet/0", "route", at=0.5)
        j.note_request_done("fleet/0", "length", first_token_at=2.0, at=5.0)
        said.append(_check_msg(inv, inv.check_requests,
                               types.SimpleNamespace(requests=[freq(0, ttft=2.0)]), "gap"))
        # a second terminal
        j.note_request_submit("fleet/1", at=0.0)
        j.note_request_done("fleet/1", "length", at=1.0)
        j.note_request_done("fleet/1", "length", at=2.0)
        said.append(_check_msg(inv, inv.check_requests,
                               types.SimpleNamespace(requests=[freq(1)]), "dup"))
        # a retry without its leg
        j.note_request_submit("fleet/2", at=0.0)
        j.note_leg("fleet/2", "route", at=0.5)
        j.note_request_done("fleet/2", "length", at=1.0)
        said.append(_check_msg(inv, inv.check_requests,
                               types.SimpleNamespace(requests=[freq(2, retries=1)]), "retry"))
        j.disable()
        inv.check_requests(types.SimpleNamespace(requests=[freq(0, ttft=2.0)]))  # off: no-op
        return said

    said = both(run)
    assert "TTFT legs sum differs" in said[0]
    assert "2 terminal legs" in said[1] and "retry" in said[2]


# -- the engines' KV handoff ----------------------------------------------------------------
def _served(models, pkg, prompt, **kw):
    eng = make_engine(models, pkg, **kw)
    req = eng.submit(list(prompt), 1)
    eng.run_until_drained()
    return eng, req


@pytest.mark.parametrize("kw", [dict(), dict(kv_dtype="int8"), dict(paged=False),
                                dict(paged=False, kv_dtype="int8")],
                         ids=["paged", "paged-int8", "dense", "dense-int8"])
def test_export_import_round_trip(models, kw):
    """The port's export equals JAX's on the same prompt; an import into a
    fresh engine holds the exported bytes and its stream equals local
    serving, with the same prefix accounting as JAX's."""
    prompt = list(range(1, 20))
    exports, streams = {}, {}
    for pkg in PKG:
        src, _ = _served(models, pkg, prompt, **kw)
        key, plen, data = src.export_prefix(prompt)
        dst = make_engine(models, pkg, **kw)
        assert dst.import_prefix(key, plen, data) is True
        assert dst.import_prefix(key, plen, data) is False  # already cached
        req = dst.submit(list(prompt), 6)
        dst.run_until_drained()
        PKG[pkg].inv.check_block_pool(dst)
        exports[pkg] = (key, plen, data)
        streams[pkg] = (req.tokens_out, dst.prefix_hits, dst.prefix_tokens_reused)
        if pkg == "port":
            if dst.paged:
                bids = torch.tensor(list(dst._entry_bids(dst._prefix_cache[tuple(key)][0])))
                held = [t.index_select(1, bids) for t in tsrv._kv_tensors(dst.pool)]
                want = [data[n] for n in ("k", "v", "k_scale", "v_scale") if n in data]
            else:
                held = list(dst._prefix_cache[tuple(key)][0])
                want = list(data)
            assert all(torch.equal(h, w) for h, w in zip(held, want)) and len(held) == len(want)
    assert streams["port"] == streams["jax"]
    local = make_engine(models, "port", prefix_cache=0, **kw)
    want = local.submit(list(prompt), 6)
    local.run_until_drained()
    assert streams["port"][0] == want.tokens_out and streams["port"][1:] == (1, 16)
    (jkey, jplen, jdata), (tkey, tplen, tdata) = exports["jax"], exports["port"]
    assert tuple(jkey) == tuple(tkey) and jplen == tplen == 16  # a block and a power of 2
    jparts = [jdata[n] for n in sorted(jdata)] if isinstance(jdata, dict) else list(jdata)
    tparts = [tdata[n] for n in sorted(tdata)] if isinstance(tdata, dict) else list(tdata)
    assert [tuple(a.shape) for a in jparts] == [tuple(t.shape) for t in tparts]
    for a, t in zip(jparts, tparts):
        if t.dtype == torch.int8:  # a rounding tie may land one level apart
            assert np.abs(np.asarray(a, np.int32) - t.numpy().astype(np.int32)).max() <= 1
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=1e-4, atol=1e-5)


def test_import_prefix_checks_and_releases(models):
    """JAX's refusals with JAX's messages; an import the pool cannot hold
    raises and gives back every block it took."""
    said = {}
    for pkg in PKG:
        src, _ = _served(models, pkg, list(range(1, 20)))
        key, plen, data = src.export_prefix(list(range(1, 20)))
        msgs = []
        for eng, args in ((make_engine(models, pkg, prefix_cache=0), (key, plen, data)),
                          (make_engine(models, pkg), (key[:-1], plen, data)),
                          (make_engine(models, pkg, page_size=4), (key, plen, data))):
            with pytest.raises(ValueError) as err:
                eng.import_prefix(*args)
            msgs.append(str(err.value))
        said[pkg] = msgs
        assert src.export_prefix([1, 2]) is None  # a miss
    assert said["port"] == said["jax"]
    # 9 blocks of 8 into a pool of 8 allocatable blocks
    eng = make_engine(models, "port", num_blocks=9)
    big = {n: torch.zeros((1, 9, 8, 2, 16)) for n in ("k", "v")}
    with pytest.raises(RuntimeError) as err:
        eng.import_prefix(tuple(range(72)), 72, big)
    assert "exhausted" in str(err.value)
    assert eng.blocks_in_use == 0 and not eng._prefix_cache
    tinv.check_block_pool(eng)


def test_import_prefix_writes_the_pool_in_place(models):
    """The pool tensors keep their storage across an import (a captured
    decode graph holds their addresses)."""
    src, _ = _served(models, "port", list(range(1, 20)), kv_dtype="int8")
    dst = make_engine(models, "port", kv_dtype="int8")
    before = [(t.data_ptr(), t) for t in tsrv._kv_tensors(dst.pool)]
    pool = dst.pool
    dst.import_prefix(*src.export_prefix(list(range(1, 20))))
    assert dst.pool is pool
    assert [t.data_ptr() for t in tsrv._kv_tensors(dst.pool)] == [p for p, _ in before]


# -- compileguard -------------------------------------------------------------------------
def test_compileguard_counts_captures_under_the_flag(monkeypatch):
    monkeypatch.delenv("HIVED_COMPILE_GUARD", raising=False)
    tcg.note_capture("serve.decode_window")
    assert tcg.counts() == {} and tcg.total() == 0
    with tcg.budget(0):
        tcg.note_capture("serve.decode_window")  # off: no budget at all
    monkeypatch.setenv("HIVED_COMPILE_GUARD", "1")
    tcg.note_capture("serve.decode_window")
    with tcg.budget(1, label="serve.decode_window"):
        tcg.note_capture("serve.decode_window")
    assert tcg.counts() == {"serve.decode_window": 2} and tcg.total() == 2
    with pytest.raises(tcg.RecompileError) as err:
        with tcg.budget(0):
            tcg.note_capture("serve.decode_window")
    assert "capture budget exceeded" in str(err.value)
    tcg.reset()
    assert tcg.total() == 0


def test_warmed_disaggregated_fleet_serves_under_budget_zero(models, monkeypatch):
    """JAX's steady-state pin on the port's fleet: after a warm-up, fresh
    prompts of the same shapes serve under ``budget(0)`` (on the CPU no
    graph is captured at all; the card test holds the captures)."""
    monkeypatch.setenv("HIVED_COMPILE_GUARD", "1")
    r = tfleet.FleetRouter(disaggregate=True, kv_ship=True)
    r.add_replica("p0", make_engine(models, "port", decode_steps=4), role="prefill")
    r.add_replica("d0", make_engine(models, "port", decode_steps=4), role="decode")
    warm = [r.submit(list(range(1, 12)), 4), r.submit(list(range(30, 41)), 4)]
    r.run_until_drained()
    assert all(w.done for w in warm)
    with tcg.budget(0):
        reqs = [r.submit([t % 60 + 1 for t in range(i, i + 11)], 4) for i in (5, 17)]
        r.run_until_drained()
    assert all(f.finish_reason == "length" for f in reqs)
    assert tcg.total() == 0
