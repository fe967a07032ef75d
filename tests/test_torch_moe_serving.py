"""The port's mixture-of-experts inference (decode, int8 weights,
speculative decoding, the serving engine and the generate and serve CLIs)
against the JAX package's, on the same weights carried across by
``bridge.py``, in f32.

Every inference path routes with the no-drop capacity of
``inference_moe_cfg`` (S x k slots per expert), so a token's expert output
does not depend on the other tokens of its call: streams are compared
token for token. ``advance``'s logits agree to atol 1e-5 (summation order
only; |logit| <= ~3). The serving engine is set up as the JAX package's
``tests/test_serving_moe.py`` sets it up (4 experts, top-2) and held to
JAX's engine on the same trace, dense and paged, with chunked prefill, the
prefix cache and fused decode windows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import decode as jdec
from hivedscheduler_tpu.models import quant as jquant
from hivedscheduler_tpu.models import serving as jsrv
from hivedscheduler_tpu.models import speculative as jspec
from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch import generate as tgen_cli
from hivedscheduler_tpu_torch import serve as tserve
from hivedscheduler_tpu_torch.models import decode as tdec
from hivedscheduler_tpu_torch.models import quant as tquant
from hivedscheduler_tpu_torch.models import serving as tsrv
from hivedscheduler_tpu_torch.models import speculative as tspec
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.obs import goodput as tgp

torch.set_num_threads(1)

ATOL = 1e-5
# the JAX package's tests/test_serving_moe.py model
MODEL = dict(vocab_size=96, d_model=48, n_heads=4, n_kv_heads=2, n_layers=2,
             d_ff=96, max_seq_len=128, n_experts=4, moe_top_k=2)
DRAFT = dict(MODEL, n_experts=0, d_model=24, n_heads=2, n_kv_heads=1, d_ff=48,
             n_layers=1)
B, PROMPT, NEW = 2, 8, 8
SYSTEM = list(range(30, 46))


def _cfgs(**over):
    kw = dict(MODEL, **over)
    return (jtm.TransformerConfig(dtype=jnp.float32, **kw),
            ttm.TransformerConfig(dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, port cfg, port params), f32, top-2."""
    jcfg, tcfg = _cfgs()
    params_np = jax.device_get(jtm.init_params(jcfg, jax.random.PRNGKey(3)))
    return jcfg, jax.tree.map(jnp.asarray, params_np), tcfg, bridge.from_numpy_tree(params_np)


def _prompt(seed=0, b=B, t=PROMPT):
    return np.random.default_rng(seed).integers(0, MODEL["vocab_size"], (b, t)).astype(np.int32)


def test_advance_logits_match_jax(models):
    jcfg, jparams, tcfg, tparams = models
    prompt = _prompt(1)
    jcache = jdec.init_kv_cache(jcfg, B, 16)
    tcache = tdec.init_kv_cache(tcfg, B, 16)
    for toks in (prompt, prompt[:, :1], prompt[:, 1:2]):
        jl, jcache = jdec.advance(jparams, jcache, jnp.asarray(toks), jcfg)
        tl, tcache = tdec.advance(tparams, tcache, torch.from_numpy(toks), tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    assert tcache.length == PROMPT + 2


@pytest.mark.parametrize("top_k", [1, 2])
def test_greedy_generate_matches_jax(top_k):
    jcfg, tcfg = _cfgs(moe_top_k=top_k)
    params_np = jax.device_get(jtm.init_params(jcfg, jax.random.PRNGKey(top_k)))
    prompt = _prompt(2)
    want = np.asarray(jdec.generate(jax.tree.map(jnp.asarray, params_np),
                                    jnp.asarray(prompt), jcfg, NEW))
    got = tdec.generate(bridge.from_numpy_tree(params_np), torch.from_numpy(prompt), tcfg, NEW)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_moe_decode_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    jq = jax.device_get(jquant.quantize_params(jparams, jcfg))
    tq = tquant.quantize_params(tparams, tcfg)
    # per-expert scales [L, E, 1, F]; the router stays f32
    assert tuple(tq["layers"]["w_gate"]["scale"].shape) == (2, 4, 1, 96)
    assert tq["layers"]["router"].dtype == torch.float32
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(tq["layers"][name]["qi8"].numpy(),
                                      jq["layers"][name]["qi8"])
        np.testing.assert_array_equal(tq["layers"][name]["scale"].numpy(),
                                      jq["layers"][name]["scale"])
    # the JAX int8 tree carried across decodes as the port's own
    prompt = _prompt(3)
    want = np.asarray(jdec.generate(jax.tree.map(jnp.asarray, jq), jnp.asarray(prompt),
                                    jcfg, NEW))
    for tree in (tq, bridge.from_numpy_tree(jq)):
        got = tdec.generate(tree, torch.from_numpy(prompt), tcfg, NEW)
        np.testing.assert_array_equal(got.numpy(), want)


def test_speculative_with_an_moe_target_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    jdcfg = jtm.TransformerConfig(dtype=jnp.float32, **DRAFT)
    tdcfg = ttm.TransformerConfig(dtype=torch.float32, **DRAFT)
    dparams_np = jax.device_get(jtm.init_params(jdcfg, jax.random.PRNGKey(9)))
    prompt = _prompt(4)
    want, jstats = jspec.generate_speculative(
        jparams, jax.tree.map(jnp.asarray, dparams_np), jnp.asarray(prompt), jcfg, jdcfg,
        NEW, gamma=3)
    got, stats = tspec.generate_speculative(tparams, bridge.from_numpy_tree(dparams_np),
                                            torch.from_numpy(prompt), tcfg, tdcfg, NEW,
                                            gamma=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats.drafted == int(jstats.drafted) and stats.accepted == int(jstats.accepted)
    # greedy speculation is greedy decode
    np.testing.assert_array_equal(
        got.numpy(), tdec.generate(tparams, torch.from_numpy(prompt), tcfg, NEW).numpy())
    # the CLIs' draft is dense
    assert tspec.derive_draft_config(tcfg, 1).n_experts == 0


def _trace():
    rng = np.random.default_rng(5)
    prompts = [SYSTEM + [int(t) for t in rng.integers(0, 96, int(rng.integers(1, 12)))]
               for _ in range(5)] + [[5, 9, 2], [1]]
    return prompts, [int(rng.integers(3, 9)) for _ in prompts]


def _drive(mod, params, cfg, prompts, budgets, **kw):
    eng = mod.ServingEngine(params, cfg, max_batch=2, max_len=64, **kw)
    pending, reqs, step = list(zip(prompts, budgets)), [], 0
    while pending or any(not r.done for r in reqs):
        if pending and step % 2 == 0:
            reqs.append(eng.submit(*pending.pop(0)))
        eng.step()
        step += 1
    return [r.tokens_out for r in reqs], eng


@pytest.fixture(scope="module")
def jax_streams(models):
    jcfg, jparams, _, _ = models
    return _drive(jsrv, jparams, jcfg, *_trace())[0]


ENGINES = {
    "dense": (dict(), None),
    "paged": (dict(page_size=8), None),
    "chunked": (dict(prefill_chunk=8), "prefill_chunks_done"),
    "prefix": (dict(prefix_cache_size=4), "prefix_hits"),
    "paged-prefix-chunked": (dict(page_size=8, prefix_cache_size=4, prefill_chunk=8),
                             "prefix_block_hits"),
    "window": (dict(decode_steps=4), "fused_windows"),
    "paged-window": (dict(page_size=8, decode_steps=3), "fused_windows"),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_streams_match_jax(models, jax_streams, name):
    _, _, tcfg, tparams = models
    kw, counter = ENGINES[name]
    got, eng = _drive(tsrv, tparams, tcfg, *_trace(), **kw)
    assert got == jax_streams
    if counter is not None:
        assert getattr(eng, counter) > 0, counter


def test_engine_stream_equals_single_request_decode(models, jax_streams):
    # what JAX's test_serving_moe.py holds: routing-exact streams
    _, _, tcfg, tparams = models
    prompts, budgets = _trace()
    for i in (0, 5, 6):
        want = tdec.generate(tparams, torch.tensor([prompts[i]]), tcfg, budgets[i])
        assert jax_streams[i] == want[0].tolist(), i


@pytest.fixture
def _fresh_goodput():
    tgp.disable()
    tgp.GOODPUT.clear()
    yield
    tgp.disable()
    tgp.GOODPUT.clear()


CLI_MODEL = ["--vocab-size", "96", "--d-model", "48", "--n-heads", "4", "--n-kv-heads",
             "2", "--n-layers", "2", "--d-ff", "96", "--n-experts", "4", "--moe-top-k",
             "2", "--device", "cpu"]


@pytest.mark.parametrize("extra", [[], ["--quantize", "int8"],
                                   ["--draft-layers", "1", "--gamma", "3"]],
                         ids=["bf16", "int8", "speculative"])
def test_generate_cli_with_moe(extra, capsys, _fresh_goodput):
    argv = CLI_MODEL + ["--batch", "2", "--prompt-len", "8", "--new-tokens", "6",
                        "--seed", "5"]
    assert tgen_cli.main(argv + extra) == 0
    rows = [[int(t) for t in line.split()] for line in capsys.readouterr().out.splitlines()]
    cfg = ttm.TransformerConfig(**dict(MODEL, max_seq_len=14))
    params = ttm.init_params(cfg, torch.Generator().manual_seed(5))
    prompt = torch.randint(0, 96, (2, 8), generator=torch.Generator().manual_seed(6))
    if extra[:1] == ["--quantize"]:
        params = tquant.quantize_params(params, cfg)
    want = tdec.generate(ttm.cast_params(params, cfg.dtype), prompt, cfg, 6)
    if extra[:1] == ["--draft-layers"]:
        # greedy speculation is greedy decode, up to bf16 ties
        assert len(rows) == 2 and all(len(r) == 6 for r in rows)
    else:
        assert rows == want.tolist()


@pytest.mark.parametrize("extra", [[], ["--page-size", "8", "--decode-steps", "4"]],
                         ids=["dense", "paged-window"])
def test_serve_cli_with_moe(extra, capsys, _fresh_goodput):
    argv = CLI_MODEL + ["--requests", "4", "--max-batch", "2", "--max-len", "64",
                        "--max-new-tokens", "5", "--seed", "3"]
    assert tserve.main(argv + extra) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4 and all(line.startswith("[") for line in lines)
    if extra:
        capsys.readouterr()
        assert tserve.main(argv) == 0
        assert capsys.readouterr().out.splitlines() == lines  # window and paged: the same
