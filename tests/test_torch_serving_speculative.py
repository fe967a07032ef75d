"""The port's speculative serving engine
(hivedscheduler_tpu_torch.models.serving.SpeculativeServingEngine) against
the JAX package's, on the same target and draft weights (the ``setup`` of
``tests/test_serving_speculative.py``: f32, a 2-layer target and a
half-width draft), carried across by hivedscheduler_tpu_torch.bridge.

Greedy streams are compared token for token, request for request, with
equal ``drafted`` and ``accepted`` counts and equal engine steps: under a
weak draft interleaved, a perfect draft (the target itself), per-row
acceptance, a slot recycled mid-flight, a seeded fuzz of arrivals with and
without chunked prefill, the paged target, int8 KV and a prefix-cache hit.
In f32 the packages differ by summation order only, so a greedy stream
parts only at an exact tie, which random weights do not give.

The sampler is the port's own (a counter-based hash, not JAX's bits), so
sampled speculation is held as JAX's ``tests/
test_serving_speculative_sampled.py`` holds JAX's: a perfect draft equals
the port's plain sampled engine bit for bit, streams do not depend on
interleaving, chunked prefill does not change them, and a weak draft
completes with valid tokens. The tag-0 draws are pinned to the values the
sampler gave before it took a purpose tag.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.chaos import invariants as jinv
from hivedscheduler_tpu.models import serving as jsrv
from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch.chaos import invariants as tinv
from hivedscheduler_tpu_torch.models import serving as tsrv
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.models.speculative import SpecDecodeConfig

torch.set_num_threads(1)

TARGET = dict(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
              d_ff=128, max_seq_len=128)
DRAFT = dict(TARGET, d_model=32, n_heads=2, n_kv_heads=1, d_ff=64)
SAMPLING = dict(temperature=0.8, top_k=20, top_p=0.9, seed=5)


@pytest.fixture(scope="module")
def setup():
    """{"jax": (cfg, params, draft cfg, draft params), "port": (...)}."""
    out = {}
    jt = jax.device_get(jtm.init_params(jtm.TransformerConfig(dtype=jnp.float32, **TARGET),
                                        jax.random.PRNGKey(0)))
    jd = jax.device_get(jtm.init_params(jtm.TransformerConfig(dtype=jnp.float32, **DRAFT),
                                        jax.random.PRNGKey(7)))
    out["jax"] = (jtm.TransformerConfig(dtype=jnp.float32, **TARGET), jax.tree.map(jnp.asarray, jt),
                  jtm.TransformerConfig(dtype=jnp.float32, **DRAFT), jax.tree.map(jnp.asarray, jd))
    out["port"] = (ttm.TransformerConfig(dtype=torch.float32, **TARGET), bridge.from_numpy_tree(jt),
                   ttm.TransformerConfig(dtype=torch.float32, **DRAFT), bridge.from_numpy_tree(jd))
    return out


def drive(mod, models, plan, perfect=False, audit=False, **kw):
    """Serve ``plan`` [(arrival step, prompt, budget)] through ``mod``'s
    speculative engine -> (streams in submission order, engine)."""
    cfg, params, dcfg, dparams = models
    if perfect:
        dcfg, dparams = cfg, params
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 64)
    eng = mod.SpeculativeServingEngine(params, cfg, dparams, dcfg, **kw)
    plan, live, step = sorted(plan, key=lambda t: t[0]), [], 0
    while plan or eng.queue or any(s is not None for s in eng.slots):
        while plan and plan[0][0] <= step:
            _, prompt, budget = plan.pop(0)
            live.append(eng.submit(prompt, budget))
        eng.step()
        if audit and eng.paged:
            jinv.check_block_pool(eng, f"step {step}")
            tinv.check_block_pool(eng, f"step {step}")
        step += 1
        assert step < 500
    return [r.tokens_out for r in live], eng


def both(setup, plan, **kw):
    """The same plan through both engines: streams, drafted, accepted and
    steps must agree; the port's engine is returned."""
    ref, jeng = drive(jsrv, setup["jax"], plan, **kw)
    out, teng = drive(tsrv, setup["port"], plan, audit=True, **kw)
    assert out == ref
    assert (teng.drafted, teng.accepted, teng.steps) == (jeng.drafted, jeng.accepted,
                                                        jeng.steps)
    assert all(len(s) == n for s, (_, _, n) in zip(out, sorted(plan, key=lambda t: t[0])))
    return teng, jeng


def _fuzz_plan(seed, n=5):
    rng = random.Random(seed)
    return [(rng.randrange(0, 8), [rng.randrange(1, TARGET["vocab_size"])
                                   for _ in range(rng.randrange(1, 7))],
             rng.randrange(1, 7)) for _ in range(n)]


WEAK_PLAN = [(0, [5, 9, 2], 7), (0, [17, 3, 88, 41, 7], 4), (0, [1], 9),
             (0, [100, 22, 63, 4], 5)]


# -- greedy: request for request against JAX -------------------------------
def test_weak_draft_interleaved_matches_jax(setup):
    teng, _ = both(setup, WEAK_PLAN, gamma=3)
    assert 0.0 <= teng.acceptance < 1.0


def test_perfect_draft_accepts_everything(setup):
    teng, _ = both(setup, [(0, [5, 9, 2], 9)], perfect=True, gamma=3, max_batch=1)
    assert teng.acceptance == 1.0
    # one prefill token, then ceil(8 / (gamma + 1)) = 2 rounds
    assert teng.steps == 2


def test_per_row_acceptance_no_min_barrier(setup):
    teng, _ = both(setup, [(0, [5, 9, 2], 9), (0, [17, 3, 88], 9)], perfect=True, gamma=3)
    assert teng.acceptance == 1.0 and teng.steps == 2


def test_recycled_slot_mid_flight(setup):
    both(setup, [(0, [5, 9, 2], 3), (0, [100, 22, 63, 4], 6)], gamma=2, max_batch=1)


@pytest.mark.parametrize("prefill_chunk", [0, 3])
def test_fuzz_random_interleavings_match_jax(setup, prefill_chunk):
    teng, _ = both(setup, _fuzz_plan(23), gamma=2, prefill_chunk=prefill_chunk)
    if prefill_chunk:
        assert teng.prefill_chunks_done > 0


def test_paged_target_matches_jax(setup):
    # page 4: every round allocates its window's blocks and trims the
    # rejected tail's; chunked admissions park rows beside the live ones
    plan = WEAK_PLAN + [(3, [9, 8, 7, 6, 5, 4, 3], 6)]
    teng, _ = both(setup, plan, gamma=3, page_size=4, prefill_chunk=3)
    assert teng.paged and teng.blocks_in_use == 0


def test_int8_kv_matches_jax(setup):
    teng, _ = both(setup, WEAK_PLAN, gamma=2, kv_dtype="int8")
    assert teng.draft_cache.quantized


@pytest.mark.parametrize("page_size", [0, 4])
def test_prefix_cache_hit_matches_jax(setup, page_size):
    system = [7, 11, 23, 42, 5, 9, 81, 2, 64]
    plan = [(0, system + [3, 1], 5), (4, system + [8], 6), (6, system + [3, 1, 77], 4)]
    teng, _ = both(setup, plan, gamma=2, prefix_cache_size=4, page_size=page_size)
    assert teng.prefix_hits > 0


def test_spec_decode_constructs_the_speculative_engine(setup):
    cfg, params, dcfg, dparams = setup["port"]
    spec = SpecDecodeConfig(draft_params=dparams, draft_cfg=dcfg, gamma=3)
    eng = tsrv.ServingEngine(params, cfg, max_batch=2, max_len=64, spec_decode=spec,
                             decode_steps=4)
    assert type(eng) is tsrv.SpeculativeServingEngine and eng.gamma == 3
    ref, _ = drive(tsrv, setup["port"], WEAK_PLAN[:2], gamma=3)
    reqs = [eng.submit(p, n) for _, p, n in WEAK_PLAN[:2]]
    eng.run_until_drained()
    # decode_steps is accepted and ignored: no fused window, no graph
    assert [r.tokens_out for r in reqs] == ref
    assert eng.fused_windows == 0 and eng._window is None


def test_parked_row_beside_a_live_row_at_the_arena_edge(setup):
    """A chunked row stays parked at max_len - 1 while a live row runs
    rounds beside it (every verify pass writes its gamma + 1 positions onto
    that one index), and the live row's prompt fills the arena up to
    submit's headroom: both streams equal JAX's."""
    g, max_len = 3, 32
    long_prompt = list(range(3, 3 + max_len - 2 - (g + 1)))  # 26 tokens + budget 2
    plan = [(0, [5, 9, 2], 8), (1, long_prompt, 2)]
    teng, _ = both(setup, plan, gamma=g, max_len=max_len, prefill_chunk=4)
    assert teng.prefill_chunks_done >= 2


# -- sampled: held to the port's own plain engine ---------------------------
def test_sampled_perfect_draft_matches_plain_sampled_engine(setup):
    cfg, params, _, _ = setup["port"]
    prompts = [[5, 9, 2], [17, 3, 88], [1, 4]]
    plain = tsrv.ServingEngine(params, cfg, max_batch=2, max_len=64, **SAMPLING)
    refs = [plain.submit(p, 6) for p in prompts]
    plain.run_until_drained()
    out, eng = drive(tsrv, setup["port"], [(0, p, 6) for p in prompts], perfect=True,
                     gamma=3, **SAMPLING)
    assert out == [r.tokens_out for r in refs]
    assert eng.acceptance == 1.0


def test_sampled_streams_reproducible_under_interleaving(setup):
    kw = dict(gamma=2, **SAMPLING)
    a, _ = drive(tsrv, setup["port"], [(0, [4, 8], 5), (0, [9, 1, 7], 6)], **kw)
    b, _ = drive(tsrv, setup["port"], [(0, [4, 8], 5), (1, [9, 1, 7], 6)], **kw)
    c, _ = drive(tsrv, setup["port"], [(0, [4, 8], 5), (1, [9, 1, 7], 6)], max_batch=1, **kw)
    assert a == b == c


def test_sampled_composes_with_chunked_prefill(setup):
    long = list(range(20, 50))
    plan = [(0, long, 5), (0, [7, 8], 5), (0, long + [5], 5)]
    kw = dict(gamma=2, max_len=96, **SAMPLING)
    plain, _ = drive(tsrv, setup["port"], plan, **kw)
    chunked, eng = drive(tsrv, setup["port"], plan, prefill_chunk=8, **kw)
    assert chunked == plain and eng.prefill_chunks_done > 0


@pytest.mark.parametrize("page_size", [0, 4])
def test_sampled_weak_draft_completes_with_valid_tokens(setup, page_size):
    plan = [(0, [5, 9, 2], 6), (0, [17, 3, 88, 41], 4), (0, [1], 8), (0, [100, 22, 63], 5)]
    out, eng = drive(tsrv, setup["port"], plan, gamma=3, page_size=page_size,
                     audit=True, **SAMPLING)
    assert [len(s) for s in out] == [6, 4, 8, 5]
    assert all(0 <= t < TARGET["vocab_size"] for s in out for t in s)
    assert 0.0 <= eng.acceptance < 1.0


def test_tag_zero_draws_are_the_untagged_samplers():
    """Pinned from the sampler before it took a tag: tag 0 is bit for bit
    the plain engine's draw; tag 1 draws other uniforms."""
    rids, counts = torch.tensor([0, 3, 17]), torch.tensor([0, 2, 9])
    u = tsrv.stream_uniforms(5, rids, counts, 6)
    assert u[0].tolist() == [0.44293373823165894, 0.7059319615364075, 0.6290846467018127,
                             0.9224957823753357, 0.5399587750434875, 0.2845681309700012]
    assert u[2, :3].tolist() == [0.4126022458076477, 0.4465257525444031,
                                 0.052964627742767334]
    assert torch.equal(tsrv.stream_uniforms(5, rids, counts, 6, tag=0), u)
    assert not torch.equal(tsrv.stream_uniforms(5, rids, counts, 6, tag=1), u)
    assert tsrv.sample_rows(torch.zeros(3, 50), rids, counts, 5, 0.8, 0, 1.0).tolist() == [
        21, 25, 42]


# -- what the engine refuses -------------------------------------------------
def test_validation(setup):
    cfg, params, dcfg, dparams = setup["port"]
    with pytest.raises(ValueError) as err:
        tsrv.SpeculativeServingEngine(params, cfg, dparams, dcfg, gamma=0)
    assert "gamma" in str(err.value)
    with pytest.raises(ValueError) as err:
        tsrv.SpeculativeServingEngine(
            params, cfg, dparams, ttm.TransformerConfig(dtype=torch.float32,
                                                        **dict(DRAFT, vocab_size=64)))
    assert "vocab" in str(err.value)
    with pytest.raises(ValueError) as err:
        tsrv.SpeculativeServingEngine(params, cfg)
    assert "draft model" in str(err.value)
    eng = tsrv.SpeculativeServingEngine(params, cfg, dparams, dcfg, gamma=4, max_len=32)
    with pytest.raises(ValueError) as err:
        eng.submit([1] * 20, 8)  # 20 + 8 + 5 > 32
    assert "headroom" in str(err.value)
    eng.submit([1] * 19, 8)  # 19 + 8 + 5 = 32 fits
    for call in (lambda: eng.export_prefix([1, 2]), lambda: eng.import_prefix((1,), 1, None)):
        with pytest.raises(RuntimeError) as err:
            call()
        assert "bundle a draft-cache copy" in str(err.value)
    spec = SpecDecodeConfig(draft_params=dparams, draft_cfg=dcfg)
    # the mesh layout is ported (tests/test_torch_sharded_serving.py); a
    # mesh must be the ("dp", "tp") serving mesh
    with pytest.raises(ValueError) as err:
        tsrv.ServingEngine(params, cfg, spec_decode=spec, mesh=object())
    assert "the serving mesh has the axes" in str(err.value)
    with pytest.raises(ValueError) as err:
        tsrv.SpeculativeServingEngine(params, cfg, dparams, dcfg, spec_decode=spec)
    assert "not both" in str(err.value)
