"""The port's speculative decoding
(hivedscheduler_tpu_torch.models.speculative) against the JAX package's on
the same f32 weights and numpy prompts.

Speculation is an acceleration, not an approximation: greedy speculative
tokens must equal greedy ``generate``'s, the port's and the JAX package's,
whatever the draft; a draft equal to the target accepts every proposal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import decode as jdec
from hivedscheduler_tpu.models import speculative as jspec
from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch.models import decode as tdec
from hivedscheduler_tpu_torch.models import speculative as tspec
from hivedscheduler_tpu_torch.models import transformer as ttm

torch.set_num_threads(1)

TARGET = dict(vocab_size=97, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
              d_ff=64, max_seq_len=128)
DRAFT = dict(TARGET, d_model=16, n_heads=2, n_kv_heads=0, n_layers=1, d_ff=32)
NEW = 14


def _cfgs(kw):
    return (jtm.TransformerConfig(dtype=jnp.float32, **kw),
            ttm.TransformerConfig(dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def models():
    """(target params, draft params, prompt, JAX greedy tokens), numpy."""
    jt, _ = _cfgs(TARGET)
    jd, _ = _cfgs(DRAFT)
    target = jax.device_get(jtm.init_params(jt, jax.random.PRNGKey(0)))
    draft = jax.device_get(jtm.init_params(jd, jax.random.PRNGKey(42)))
    prompt = np.random.default_rng(1).integers(0, 97, (2, 7)).astype(np.int32)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        want = np.asarray(jdec.generate(jax.tree.map(jnp.asarray, target),
                                        jnp.asarray(prompt), jt, NEW))
    return target, draft, prompt, want


@pytest.mark.parametrize("gamma", [1, 3, 5])
def test_greedy_speculative_equals_greedy_generate_and_jax(models, gamma):
    target, draft, prompt, want = models
    _, tcfg = _cfgs(TARGET)
    _, dcfg = _cfgs(DRAFT)
    tparams = bridge.from_numpy_tree(target)
    prompt_t = torch.from_numpy(prompt)
    got, stats = tspec.generate_speculative(
        tparams, bridge.from_numpy_tree(draft), prompt_t, tcfg, dcfg, NEW, gamma=gamma)
    np.testing.assert_array_equal(got.numpy(), want)
    torch.testing.assert_close(got, tdec.generate(tparams, prompt_t, tcfg, NEW), rtol=0, atol=0)
    assert stats.rounds >= 1 and stats.drafted == gamma * stats.rounds
    assert 0 <= stats.accepted <= stats.drafted
    # each round emits its accepted tokens and one more
    assert stats.accepted + stats.rounds >= NEW - 1


def test_self_draft_accepts_everything(models):
    target, _, prompt, _ = models
    _, tcfg = _cfgs(TARGET)
    params = bridge.from_numpy_tree(target)
    got, stats = tspec.generate_speculative(
        params, params, torch.from_numpy(prompt), tcfg, tcfg, 12, gamma=4,
        temperature=0.8, generator=torch.Generator().manual_seed(3))
    assert got.shape == (2, 12)
    assert stats.accepted == stats.drafted > 0


def test_sampled_speculation_repeats_and_stays_in_the_vocab(models):
    target, draft, prompt, _ = models
    _, tcfg = _cfgs(TARGET)
    _, dcfg = _cfgs(DRAFT)
    tparams, dparams = bridge.from_numpy_tree(target), bridge.from_numpy_tree(draft)
    kw = dict(gamma=3, temperature=1.0, top_k=20, top_p=0.9)

    def run(seed):
        return tspec.generate_speculative(
            tparams, dparams, torch.from_numpy(prompt), tcfg, dcfg, 10,
            generator=torch.Generator().manual_seed(seed), **kw)

    a, stats = run(11)
    b, _ = run(11)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert 0 <= int(a.min()) and int(a.max()) < TARGET["vocab_size"]
    assert stats.drafted == 3 * stats.rounds
    assert not torch.equal(a, run(12)[0])


@pytest.mark.parametrize("layers,d_model", [(1, 0), (2, 0), (1, 64), (3, 96)])
def test_derive_draft_config_matches_jax(layers, d_model):
    for base in (dict(TARGET, d_model=64), dict(TARGET, d_model=2048, n_heads=16,
                                                n_kv_heads=8, d_ff=8192)):
        jcfg, tcfg = _cfgs(base)
        want = jspec.derive_draft_config(jcfg, layers, d_model)
        got = tspec.derive_draft_config(tcfg, layers, d_model)
        fields = [f.name for f in dataclasses.fields(got) if f.name != "dtype"]
        assert {f: getattr(got, f) for f in fields} == {f: getattr(want, f) for f in fields}


def test_derive_draft_config_errors_match_jax():
    jcfg, tcfg = _cfgs(TARGET)
    with pytest.raises(ValueError) as want:
        jspec.derive_draft_config(jcfg, 1, 20)
    with pytest.raises(ValueError) as got:
        tspec.derive_draft_config(tcfg, 1, 20)
    assert str(got.value) == str(want.value)


def test_argument_checks(models):
    target, _, prompt, _ = models
    _, tcfg = _cfgs(TARGET)
    params = bridge.from_numpy_tree(target)
    prompt_t = torch.from_numpy(prompt)
    other = dataclasses.replace(tcfg, vocab_size=96)
    cases = [
        (dict(target_cfg=tcfg, draft_cfg=other), "vocabs must match"),
        (dict(target_cfg=tcfg, draft_cfg=tcfg, gamma=0), "gamma must be >= 1"),
        (dict(target_cfg=tcfg, draft_cfg=tcfg, temperature=0.5), "torch.Generator"),
    ]
    for kw, msg in cases:
        with pytest.raises(ValueError) as err:
            tspec.generate_speculative(params, params, prompt_t, max_new_tokens=4, **kw)
        assert msg in str(err.value)
