"""The port's KV-cache decode (hivedscheduler_tpu_torch.models.decode)
against the JAX package's on the same weights, carried across by
hivedscheduler_tpu_torch.bridge, and the same numpy prompts.

Tolerances: in f32 the two packages differ by summation order only; the
per-position logits (|logit| <= ~3) of the prefill and of every decode step
agree to atol 1e-5 (observed <= 2.6e-6). Greedy tokens are compared
exactly, and the filter masks of ``filter_logits`` must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import decode as jdec
from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch.models import decode as tdec
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.ops.attention import NEG_INF

torch.set_num_threads(1)

LOGIT_ATOL = 1e-5

SMALL = dict(vocab_size=97, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_seq_len=64)
B, T, PREFILL = 2, 12, 6


def _cfgs(n_kv):
    kw = dict(SMALL, n_kv_heads=n_kv)
    return (jtm.TransformerConfig(dtype=jnp.float32, **kw),
            ttm.TransformerConfig(dtype=torch.float32, **kw))


def _tokens(seed=0, b=B, t=T):
    return np.random.default_rng(seed).integers(
        0, SMALL["vocab_size"], size=(b, t)).astype(np.int32)


@pytest.fixture(scope="module")
def weights():
    """f32 JAX params per n_kv_heads (0 = MHA, 2 = GQA), as numpy trees."""
    return {n_kv: jax.device_get(jtm.init_params(_cfgs(n_kv)[0], jax.random.PRNGKey(0)))
            for n_kv in (0, 2)}


@pytest.fixture(scope="module")
def jax_advance():
    return jax.jit(jdec.advance, static_argnums=3)


def _as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("n_kv", [0, 2])
def test_advance_prefill_and_steps_match_jax(weights, jax_advance, n_kv):
    jcfg, tcfg = _cfgs(n_kv)
    jparams, tparams = _as_jax(weights[n_kv]), bridge.from_numpy_tree(weights[n_kv])
    tokens = _tokens()
    jcache = jdec.init_kv_cache(jcfg, B, T)
    tcache = tdec.init_kv_cache(tcfg, B, T)
    assert tcache.k.shape == tuple(jcache.k.shape)  # compact GQA cache
    spans = [(0, PREFILL)] + [(i, i + 1) for i in range(PREFILL, T)]
    for lo, hi in spans:
        jl, jcache = jax_advance(jparams, jcache, jnp.asarray(tokens[:, lo:hi]), jcfg)
        tl, tcache = tdec.advance(tparams, tcache, torch.from_numpy(tokens[:, lo:hi]), tcfg)
        assert tcache.length == int(jcache.length) == hi
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"positions {lo}..{hi - 1}")
    np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), atol=LOGIT_ATOL, rtol=0)


def test_incremental_logits_equal_the_full_forward(weights):
    _, tcfg = _cfgs(2)
    params = bridge.from_numpy_tree(weights[2])
    tokens = torch.from_numpy(_tokens(1))
    with torch.inference_mode():
        full = ttm.forward(params, tokens, tcfg)
    cache = tdec.init_kv_cache(tcfg, B, T)
    pre, cache = tdec.advance(params, cache, tokens[:, :PREFILL], tcfg)
    steps = [pre]
    for i in range(PREFILL, T):
        logits, cache = tdec.advance(params, cache, tokens[:, i:i + 1], tcfg)
        steps.append(logits)
    torch.testing.assert_close(torch.cat(steps, dim=1), full, atol=LOGIT_ATOL, rtol=0)


def test_advance_refuses_to_overrun_the_cache(weights):
    _, tcfg = _cfgs(0)
    params = bridge.from_numpy_tree(weights[0])
    cache = tdec.init_kv_cache(tcfg, B, 4)
    with pytest.raises(ValueError) as err:
        tdec.advance(params, cache, torch.from_numpy(_tokens(t=5)), tcfg)
    assert "cannot take 5 tokens" in str(err.value)


@pytest.mark.parametrize("n_kv", [0, 2])
def test_greedy_generate_is_token_exact_against_jax(weights, n_kv):
    jcfg, tcfg = _cfgs(n_kv)
    prompt = _tokens(2, t=7)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        want = np.asarray(jdec.generate(_as_jax(weights[n_kv]), jnp.asarray(prompt), jcfg, 14))
    got = tdec.generate(bridge.from_numpy_tree(weights[n_kv]), torch.from_numpy(prompt), tcfg, 14)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("top_k,top_p", [
    (5, 1.0),    # top-k alone
    (0, 0.9),    # top-p alone
    (5, 0.5),    # k then p
    (0, 0.0),    # top_p 0 keeps the most likely entry only
    (0, 1.0),    # identity
    (20, 0.95),
])
def test_filter_logits_masks_are_identical_to_jax(top_k, top_p):
    logits = (np.random.default_rng(3).normal(size=(4, 3, 97)) * 3).astype(np.float32)
    logits[0, 0, :4] = logits[0, 0].max() + 1.0  # a four-way tie at the top
    want = np.asarray(jdec.filter_logits(jnp.asarray(logits), top_k, top_p))
    got = tdec.filter_logits(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(got <= NEG_INF, want <= NEG_INF)
    np.testing.assert_array_equal(got, want)
    if top_p == 0.0:
        assert ((got > NEG_INF).sum(-1)[1:] == 1).all()
    if top_k == 0 and top_p == 1.0:
        np.testing.assert_array_equal(got, logits)


def test_top_k_keeps_ties_at_the_kth_value():
    logits = torch.tensor([[3.0, 2.0, 2.0, 2.0, 1.0]])
    got = tdec.filter_logits(logits, top_k=2)
    assert (got > NEG_INF).tolist() == [[True, True, True, True, False]]


def _teacher_forced_logits(params, prompt, toks, cfg):
    """The logits each generated token was drawn from, by the same
    sequence of advance calls generate makes."""
    cache = tdec.init_kv_cache(cfg, prompt.shape[0], prompt.shape[1] + toks.shape[1])
    logits, cache = tdec.advance(params, cache, prompt, cfg)
    out = [logits[:, -1]]
    for i in range(toks.shape[1] - 1):
        logits, cache = tdec.advance(params, cache, toks[:, i:i + 1], cfg)
        out.append(logits[:, -1])
    return torch.stack(out, dim=1)


def test_sampled_stream_is_inside_the_filtered_support_and_repeats(weights):
    _, tcfg = _cfgs(2)
    params = bridge.from_numpy_tree(weights[2])
    prompt = torch.from_numpy(_tokens(4, t=5))
    kw = dict(temperature=0.8, top_k=8, top_p=0.9)
    a = tdec.generate(params, prompt, tcfg, 12, generator=torch.Generator().manual_seed(7), **kw)
    b = tdec.generate(params, prompt, tcfg, 12, generator=torch.Generator().manual_seed(7), **kw)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    c = tdec.generate(params, prompt, tcfg, 12, generator=torch.Generator().manual_seed(8), **kw)
    assert not torch.equal(a, c)
    logits = _teacher_forced_logits(params, prompt, a, tcfg)
    kept = tdec.filter_logits(logits / kw["temperature"], kw["top_k"], kw["top_p"]) > NEG_INF
    assert kept.gather(-1, a.long()[..., None]).all()
    assert (kept.sum(-1) <= kw["top_k"]).all()


def test_sampling_with_top_k_one_equals_greedy(weights):
    _, tcfg = _cfgs(0)
    params = bridge.from_numpy_tree(weights[0])
    prompt = torch.from_numpy(_tokens(5, t=6))
    greedy = tdec.generate(params, prompt, tcfg, 10)
    sampled = tdec.generate(params, prompt, tcfg, 10, temperature=1.3, top_k=1,
                            generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(sampled, greedy, rtol=0, atol=0)


def test_decode_steps_do_not_change_the_tokens(weights):
    _, tcfg = _cfgs(2)
    params = bridge.from_numpy_tree(weights[2])
    prompt = torch.from_numpy(_tokens(6, t=6))
    one = tdec.generate(params, prompt, tcfg, 9, decode_steps=1)
    three = tdec.generate(params, prompt, tcfg, 9, decode_steps=3)
    torch.testing.assert_close(three, one, rtol=0, atol=0)
    with pytest.raises(ValueError) as err:
        tdec.generate(params, prompt, tcfg, 9, decode_steps=0)
    assert "decode_steps" in str(err.value)


def test_generate_argument_checks(weights):
    _, tcfg = _cfgs(0)
    params = bridge.from_numpy_tree(weights[0])
    prompt = torch.from_numpy(_tokens(t=6))
    with pytest.raises(ValueError) as err:
        tdec.generate(params, prompt, tcfg, 4, temperature=0.5)
    assert "torch.Generator" in str(err.value)
    with pytest.raises(ValueError) as err:
        tdec.generate(params, prompt, tcfg, 4, max_len=9)
    assert "max_len 9" in str(err.value)
    assert tdec.generate(params, prompt, tcfg, 0).shape == (B, 0)


def test_moe_config_is_refused(weights):
    # MoE decodes (tests/test_torch_moe_serving.py); what advance still
    # refuses is a MoE config with MLP adapters, as JAX's init_params does
    _, tcfg = _cfgs(0)
    params = bridge.from_numpy_tree(weights[0])
    moe = ttm.TransformerConfig(dtype=torch.float32, n_experts=4, **SMALL)
    assert tdec.inference_moe_cfg(tcfg) is tcfg
    assert tdec.inference_moe_cfg(moe).expert_capacity_factor == 4.0
    lora_moe = dataclasses.replace(moe, lora_rank=4, lora_mlp=True)
    with pytest.raises(ValueError) as err:
        tdec.advance(params, tdec.init_kv_cache(tcfg, B, T), torch.from_numpy(_tokens()),
                     lora_moe)
    assert "MoE experts are not adapted" in str(err.value)
