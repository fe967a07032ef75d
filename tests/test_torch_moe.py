"""The port's mixture-of-experts layer and model
(``hivedscheduler_tpu_torch.models.transformer``: ``_moe_route``,
``_moe_mlp``, ``forward_with_aux``) against the JAX package's on the same
numpy-seeded inputs and weights carried across by ``bridge.py``, in f32.

Routing is held exactly where it is a decision: the chosen experts (JAX's
``lax.top_k``, recorded), the dispatch mask and which slots of the combine
tensor are set. The gates in those slots are softmax values that both
sides round differently by an ulp or two (the router's product and exp
differ in summation order and polynomial), so they are held to atol 1e-6
and a relative 1e-5 (observed 2.4e-7, a few ulps of a gate below 1; and
a relative 4.8e-6 where the planted zero-gate case's logits of ~50 scale
the router's rounding up).
The layer's output to atol 1e-5 and its aux loss to 1e-6; through the
whole model the logits to 2e-5 and the summed aux to 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu.parallel import train as jtrain
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.parallel import train as ttrain

torch.set_num_threads(1)

GATE_ATOL = 1e-6
GATE_RTOL = 1e-5
OUT_ATOL = 1e-5
AUX_ATOL = 1e-6
LOGIT_ATOL = 2e-5
LOSS_ATOL = 1e-5

TINY = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
            d_ff=48, max_seq_len=64, n_experts=4, attn_block_q=16,
            attn_block_k=16)
B, T = 2, 32


def _cfgs(**over):
    kw = dict(TINY, **over)
    return (jtm.TransformerConfig(dtype=jnp.float32, **kw),
            ttm.TransformerConfig(dtype=torch.float32, **kw))


def _params(jcfg, seed=0):
    return jax.device_get(jtm.init_params(jcfg, jax.random.PRNGKey(seed)))


def _tokens(seed, b=B, t=T):
    return np.random.default_rng(seed).integers(0, TINY["vocab_size"], (b, t)).astype(np.int32)


def _jax_moe(h, lp, jcfg, monkeypatch):
    """JAX's ``_moe_mlp``, eagerly -> (out, aux, chosen experts, dispatch,
    combine), the last three recorded from its ``lax.top_k`` and einsums."""
    rec = {}
    real_einsum, real_top_k = jnp.einsum, jax.lax.top_k

    def einsum(spec, *ops, **kw):
        rec.setdefault(spec, ops)
        return real_einsum(spec, *ops, **kw)

    def top_k(x, k):
        rec["top_k"] = real_top_k(x, k)
        return rec["top_k"]

    monkeypatch.setattr(jnp, "einsum", einsum)
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    out, aux = jtm._moe_mlp(jnp.asarray(h), lp, jcfg, jnp.float32)
    monkeypatch.undo()
    return (np.asarray(out), float(aux), np.asarray(rec["top_k"][1]),
            np.asarray(rec["btec,btd->ebcd"][0]), np.asarray(rec["btec,ebcd->btd"][0]))


def _layer(params, i=0):
    return {k: v[i] for k, v in params["layers"].items()}


def test_top_k_keeps_lax_order_among_ties():
    # values from a set of three: nearly every row ties
    x = np.random.default_rng(0).integers(0, 3, (64, 8)).astype(np.float32) / 4
    for k in (1, 2, 3):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = ttm._top_k(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def _plant_tie(lp):
    # experts 1 and 2 get the same router column: their logits tie exactly
    lp = dict(lp)
    router = np.array(lp["router"])
    router[:, 2] = router[:, 1] * 3.0
    router[:, 1] = router[:, 2]
    lp["router"] = router
    return lp


def _plant_zero_gate(lp):
    # two experts whose logits differ by hundreds: the loser's softmax
    # underflows to 0, so its top-2 gate is 0 and dispatch drops it
    lp = dict(lp)
    router = np.array(lp["router"])
    router[:, 0] = np.abs(router[:, 0]) * 60.0
    router[:, 1] = -router[:, 0]
    lp["router"] = router
    return lp


# (config overrides, a change to the layer's weights)
MOE_CASES = {
    "top1": (dict(moe_top_k=1), None),
    "top2": (dict(moe_top_k=2), None),
    "top2-zloss": (dict(moe_top_k=2, moe_zloss_weight=0.5), None),
    "top1-zloss": (dict(moe_top_k=1, moe_zloss_weight=0.5), None),
    # capacity ceil(32 * 2 / 4 * 0.3) = 5 of a fair 16: most tokens drop
    "top2-drops": (dict(moe_top_k=2, expert_capacity_factor=0.3), None),
    # the JAX package's own drop test: capacity floors at 1
    "top1-capacity-1": (dict(moe_top_k=1, expert_capacity_factor=1e-9), None),
    "top2-tie": (dict(moe_top_k=2), _plant_tie),
    "top1-tie": (dict(moe_top_k=1, moe_zloss_weight=0.5), _plant_tie),
    "top2-zero-gate": (dict(moe_top_k=2, n_experts=2), _plant_zero_gate),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_mlp_matches_jax(case, monkeypatch):
    over, plant = MOE_CASES[case]
    jcfg, tcfg = _cfgs(**over)
    lp = _layer(_params(jcfg))
    if plant is not None:
        lp = plant(lp)
    h = np.random.default_rng(1).standard_normal((B, T, TINY["d_model"])).astype(np.float32)
    out, aux, idx, dispatch, combine = _jax_moe(h, lp, jcfg, monkeypatch)
    tlp = bridge.from_numpy_tree(lp)
    th = torch.from_numpy(h)
    t_comb, t_disp, t_idx, t_aux = ttm._moe_route(th, tlp["router"], tcfg)
    np.testing.assert_array_equal(t_idx.numpy(), idx)
    np.testing.assert_array_equal(t_disp.numpy(), dispatch)
    np.testing.assert_array_equal(t_comb.numpy() > 0, combine > 0)
    np.testing.assert_allclose(t_comb.numpy(), combine, atol=GATE_ATOL, rtol=GATE_RTOL)
    got, got_aux = ttm._moe_mlp(th, lambda name: tlp[name], tcfg)
    np.testing.assert_allclose(got.numpy(), out, atol=OUT_ATOL, rtol=0)
    assert abs(float(got_aux) - aux) <= AUX_ATOL, (float(got_aux), aux)
    assert float(t_aux) == float(got_aux)
    kept = int(dispatch.sum())
    chosen = B * T * jcfg.moe_top_k
    if "drops" in case or "capacity-1" in case:
        assert kept < chosen / 2  # the case really drops
    if case == "top2-zero-gate":
        assert kept < chosen and int((t_idx[..., :1] != t_idx[..., 1:]).all())
    if "tie" in case:
        # the tie decided some first choices: expert 1 wins over expert 2
        probs = torch.softmax(torch.einsum("btd,de->bte", th, tlp["router"]), -1)
        assert bool((probs[..., 1] == probs[..., 2]).all())
        assert bool((t_idx[..., 0] == 1).any()) and not bool((t_idx[..., 0] == 2).any())


def test_capacity_floor_drops_every_later_token():
    # the JAX package's test_moe_capacity_drops_overflow on the port: one
    # expert of capacity 1 keeps only each row's first token
    _, tcfg = _cfgs(n_experts=1, n_layers=1, expert_capacity_factor=1e-9)
    params = ttm.init_params(tcfg, torch.Generator().manual_seed(0))
    zeroed = dict(params, layers=dict(params["layers"]))
    zeroed["layers"]["w_down"] = torch.zeros_like(params["layers"]["w_down"])
    tokens = torch.from_numpy(_tokens(1, 2, 8))
    out = ttm.forward(params, tokens, tcfg)
    out_res = ttm.forward(zeroed, tokens, tcfg)
    assert not torch.allclose(out[:, 0], out_res[:, 0])
    torch.testing.assert_close(out[:, 1:], out_res[:, 1:], atol=1e-6, rtol=0)


@pytest.mark.parametrize("over", [
    dict(moe_top_k=1, attn_impl="xla"),
    dict(moe_top_k=2, moe_zloss_weight=0.5, attn_impl="flash"),
    dict(moe_top_k=2, expert_capacity_factor=0.5, moe_aux_weight=0.1, attn_impl="xla"),
], ids=["top1-xla", "top2-zloss-flash", "top2-drops-xla"])
def test_forward_with_aux_matches_jax(over):
    jcfg, tcfg = _cfgs(**over)
    params = _params(jcfg)
    tokens = _tokens(2)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        logits, aux = jtm.forward_with_aux(params, jnp.asarray(tokens), jcfg)
    got, got_aux = ttm.forward_with_aux(bridge.from_numpy_tree(params),
                                        torch.from_numpy(tokens), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(logits), atol=LOGIT_ATOL, rtol=0)
    assert abs(float(got_aux) - float(aux)) <= AUX_ATOL
    # two layers' aux, each near moe_aux_weight (a balanced router's 1)
    assert float(got_aux) > tcfg.n_layers * 0.5 * tcfg.moe_aux_weight


@pytest.mark.parametrize("ce_chunk", [0, 16])
@pytest.mark.parametrize("include_aux", [True, False])
def test_loss_fn_matches_jax_with_and_without_aux(ce_chunk, include_aux):
    jcfg, tcfg = _cfgs(moe_top_k=2, moe_zloss_weight=0.1, moe_aux_weight=0.2)
    params = _params(jcfg)
    tokens = _tokens(3)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        want = float(jtrain.loss_fn(params, jnp.asarray(tokens), jcfg,
                                    ce_chunk=ce_chunk, include_aux=include_aux))
        pure = float(jtrain.loss_fn(params, jnp.asarray(tokens), jcfg,
                                    ce_chunk=ce_chunk, include_aux=False))
    got = float(ttrain.loss_fn(bridge.from_numpy_tree(params), torch.from_numpy(tokens),
                               tcfg, ce_chunk=ce_chunk, include_aux=include_aux))
    assert abs(got - want) <= LOSS_ATOL, (got, want)
    if include_aux:
        assert got > pure + 0.1  # the aux is really in it


def test_init_params_and_specs_mirror_jax():
    jcfg, tcfg = _cfgs(moe_top_k=2)
    jshapes = jax.tree.map(lambda a: a.shape, jax.eval_shape(
        lambda k: jtm.init_params(jcfg, k), jax.random.PRNGKey(0)))
    tshapes = bridge.map_tree(lambda t: tuple(t.shape), ttm.init_params(
        tcfg, torch.Generator().manual_seed(0)))
    assert tshapes == jshapes
    jspecs = jtm.sharding_specs(jcfg)
    tspecs = ttm.sharding_specs(tcfg)
    for name, spec in tspecs["layers"].items():
        assert tuple(jspecs["layers"][name]) == spec, name
    assert ttm._layer_specs(True)["w_down"] == ("ep", "tp", "fsdp")


def test_moe_layouts_the_port_refuses():
    _, tcfg = _cfgs()
    # experts split over ep evenly
    ttm.check_mesh(tcfg, dict(ep=4, tp=2))
    with pytest.raises(ValueError) as err:
        ttm.check_mesh(tcfg, dict(ep=3))
    assert "does not split over ep=3" in str(err.value)
    # sp > 1 runs JAX's manual global-capacity formulation
    # (tests/test_torch_moe_sp.py), with every attn_impl; the experts must
    # still split over ep there
    for attn in ("ring", "xla"):
        ttm.check_mesh(dataclasses.replace(tcfg, attn_impl=attn), dict(sp=2, ep=2))
    with pytest.raises(ValueError) as err:
        ttm.check_mesh(tcfg, dict(sp=2, ep=3))
    assert "does not split over ep=3" in str(err.value)
    # the dense model takes ep > 1 (replicated over it, as in JAX)
    ttm.check_mesh(dataclasses.replace(tcfg, n_experts=0), dict(ep=2))
    # JAX's init_params refuses MLP adapters on experts
    with pytest.raises(ValueError) as err:
        ttm.check_supported(dataclasses.replace(tcfg, lora_rank=4, lora_mlp=True))
    assert "MoE experts are not adapted" in str(err.value)
