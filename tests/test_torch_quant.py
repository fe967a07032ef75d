"""The port's weight-only int8 quantization
(hivedscheduler_tpu_torch.models.quant) against the JAX package's on the
same f32 weights.

Both divide in f32 and round half to even, so the int8 codes must be
identical and the scales equal to rtol 1e-6 (observed: equal). The int8
decode logits of the two packages, on JAX's int8 tree carried across,
agree to atol 1e-5 as the float ones do (observed <= 2.6e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import decode as jdec
from hivedscheduler_tpu.models import quant as jquant
from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch.models import decode as tdec
from hivedscheduler_tpu_torch.models import quant as tquant
from hivedscheduler_tpu_torch.models import transformer as ttm

torch.set_num_threads(1)

LOGIT_ATOL = 1e-5
SCALE_RTOL = 1e-6

SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2,
             d_ff=64, max_seq_len=32)
JCFG = jtm.TransformerConfig(dtype=jnp.float32, **SMALL)
TCFG = ttm.TransformerConfig(dtype=torch.float32, **SMALL)


@pytest.fixture(scope="module")
def weights():
    return jax.device_get(jtm.init_params(JCFG, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def jax_int8(weights):
    return jax.device_get(jquant.quantize_params(jax.tree.map(jnp.asarray, weights), JCFG))


def _prompt(seed=1, b=2, t=8):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"], (b, t)).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_quantize_params_matches_jax(weights, jax_int8):
    got = _flat(tquant.quantize_params(bridge.from_numpy_tree(weights), TCFG))
    want = _flat(jax_int8)
    assert sorted(got) == sorted(want)
    n_codes = 0
    for name, ref in want.items():
        t = got[name]
        assert tuple(t.shape) == ref.shape, name
        if name.endswith(".qi8"):
            assert t.dtype == torch.int8
            np.testing.assert_array_equal(t.numpy(), ref, err_msg=name)
            n_codes += 1
        elif name.endswith(".scale"):
            assert t.dtype == torch.float32
            np.testing.assert_allclose(t.numpy(), ref, rtol=SCALE_RTOL, atol=0, err_msg=name)
        else:  # norms pass through unchanged
            np.testing.assert_array_equal(t.numpy(), ref, err_msg=name)
    assert n_codes == 9  # embed, lm_head and the seven layer projections


def test_norms_stay_float_and_roundtrip_is_within_half_a_step(weights):
    qp = tquant.quantize_params(bridge.from_numpy_tree(weights), TCFG)
    for leaf in (qp["layers"]["attn_norm"], qp["layers"]["mlp_norm"], qp["final_norm"]):
        assert not ttm.is_quantized_leaf(leaf)
    w = torch.tensor(weights["layers"]["wo"])
    deq = ttm.load_weight(qp["layers"]["wo"], torch.float32)
    step = qp["layers"]["wo"]["scale"]
    assert step.shape == (SMALL["n_layers"], 1, 1, SMALL["d_model"])
    assert ((w - deq).abs() <= 0.5 * step + 1e-8).all()


def test_lora_leaves_are_refused(weights):
    params = bridge.from_numpy_tree(weights)
    params["layers"]["lora_a_wq"] = torch.zeros(2, 32, 4)
    with pytest.raises(ValueError) as err:
        tquant.quantize_params(params, TCFG)
    assert "merge_lora" in str(err.value)


def test_int8_advance_logits_match_jax(weights, jax_int8):
    prompt = _prompt()
    jl, _ = jdec.advance(jax.tree.map(jnp.asarray, jax_int8),
                         jdec.init_kv_cache(JCFG, 2, 8), jnp.asarray(prompt), JCFG)
    ported = tquant.quantize_params(bridge.from_numpy_tree(weights), TCFG)
    for tree in (bridge.from_numpy_tree(jax_int8), ported):
        tl, _ = tdec.advance(tree, tdec.init_kv_cache(TCFG, 2, 8), torch.from_numpy(prompt), TCFG)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL, rtol=0)


def test_int8_decode_tracks_float_at_decisive_positions(weights):
    """As the JAX package holds it: int8 logits near the float ones, and the
    argmax equal wherever the float top-1 margin exceeds twice the noise."""
    params = bridge.from_numpy_tree(weights)
    qp = tquant.quantize_params(params, TCFG)
    prompt = torch.from_numpy(_prompt())
    lf, _ = tdec.advance(params, tdec.init_kv_cache(TCFG, 2, 8), prompt, TCFG)
    lq, _ = tdec.advance(qp, tdec.init_kv_cache(TCFG, 2, 8), prompt, TCFG)
    noise = float((lf - lq).abs().max())
    assert noise < 0.15
    top2 = lf.topk(2, dim=-1).values
    decisive = (top2[..., 0] - top2[..., 1]) > 2 * noise
    assert decisive.any()
    assert torch.equal(lf.argmax(-1)[decisive], lq.argmax(-1)[decisive])
    assert tdec.generate(qp, prompt, TCFG, 6).shape == (2, 6)
