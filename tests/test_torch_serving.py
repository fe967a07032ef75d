"""The port's serving engine (hivedscheduler_tpu_torch.models.serving),
dense path, against the JAX package's on the same weights, carried across
by hivedscheduler_tpu_torch.bridge, and the same numpy traces.

Tolerances: in f32 the two packages differ by summation order only, so
``_ragged_attention``, ``_quant_kv`` and ``advance_ragged``'s logits agree
to atol 1e-5 (|logit| <= ~3), and greedy streams are compared token for
token, per request, under every composition: chunked prefill (chunks 4
and 7), the prefix cache, int8 KV, fused windows of 4 and 3, and an EOS
inside, at and after a window boundary. Sampling cannot match JAX's bits
(a counter-based hash stands in for ``fold_in`` keys), so it is held by
properties: a stream is the same under other arrival orders, another
``max_batch`` and any window size, and ``top_k=1`` is greedy. Queueing
(priority FIFO, shedding on an injected clock, aging) and drain follow the
reference's own tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import serving as jsrv
from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch.models import decode as tdec
from hivedscheduler_tpu_torch.models import quant as tquant
from hivedscheduler_tpu_torch.models import serving as tsrv
from hivedscheduler_tpu_torch.models import transformer as ttm

torch.set_num_threads(1)

ATOL = 1e-5
MODEL = dict(vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
             d_ff=128, max_seq_len=128)
MAX_BATCH, MAX_LEN = 3, 48
SYSTEM = [7, 11, 23, 42, 5, 9, 81, 2, 64, 33]


def _trace(seed=0, n=6, system=()):
    rng = np.random.default_rng(seed)
    prompts = [list(system) + [int(t) for t in rng.integers(0, MODEL["vocab_size"],
                                                            int(rng.integers(2, 20)))]
               for _ in range(n)]
    budgets = [int(rng.integers(3, 12)) for _ in range(n)]
    return prompts, budgets


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, port cfg, port params), f32, one seed."""
    jcfg = jtm.TransformerConfig(dtype=jnp.float32, **MODEL)
    tcfg = ttm.TransformerConfig(dtype=torch.float32, **MODEL)
    params_np = jax.device_get(jtm.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, jax.tree.map(jnp.asarray, params_np), tcfg, bridge.from_numpy_tree(params_np)


def drive(mod, params, cfg, prompts, budgets, arrival_every=2, after_step=None, **kw):
    """Serve the trace with one arrival every ``arrival_every`` steps;
    [(tokens, finish_reason)] per request, and the engine."""
    kw.setdefault("max_batch", MAX_BATCH)
    kw.setdefault("max_len", MAX_LEN)
    eng = mod.ServingEngine(params, cfg, **kw)
    pending, reqs, step = list(zip(prompts, budgets)), [], 0
    while pending or any(not r.done for r in reqs):
        if pending and step % arrival_every == 0:
            reqs.append(eng.submit(*pending.pop(0)))
        eng.step()
        if after_step is not None:
            after_step(eng)
        step += 1
    return [(r.tokens_out, r.finish_reason) for r in reqs], eng


def both(models, prompts, budgets, **kw):
    jcfg, jparams, tcfg, tparams = models
    ref, _ = drive(jsrv, jparams, jcfg, prompts, budgets, **kw)
    out, eng = drive(tsrv, tparams, tcfg, prompts, budgets, **kw)
    return ref, out, eng


# -- the dense cache's functions -------------------------------------------
def _qkv(seed, b=2, s=3, m=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, 4, 16)).astype(np.float32)
    ck = rng.standard_normal((b, m, 2, 16)).astype(np.float32)
    cv = rng.standard_normal((b, m, 2, 16)).astype(np.float32)
    pos = np.array([[2, 3, 4], [5, 6, 7]], np.int32)[:b, :s]
    return q, ck, cv, pos


@pytest.mark.parametrize("int8", [False, True])
def test_ragged_attention_matches_jax(int8):
    q, ck, cv, pos = _qkv(1)
    kw_j, kw_t = {}, {}
    if int8:
        kq, ks = jsrv._quant_kv(jnp.asarray(ck))
        vq, vs = jsrv._quant_kv(jnp.asarray(cv))
        ck, cv = np.array(kq), np.array(vq)
        kw_j = dict(ck_scale=ks, cv_scale=vs)
        kw_t = dict(ck_scale=torch.tensor(np.asarray(ks)),
                    cv_scale=torch.tensor(np.asarray(vs)))
    ref = jsrv._ragged_attention(jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
                                 jnp.asarray(pos), 0.25, **kw_j)
    out = tsrv._ragged_attention(torch.from_numpy(q), torch.from_numpy(ck),
                                 torch.from_numpy(cv), torch.from_numpy(pos), 0.25, **kw_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_quant_kv_matches_jax():
    x = np.random.default_rng(2).standard_normal((3, 5, 2, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # an all-zero row takes the 1e-8 floor
    jq, js = jsrv._quant_kv(jnp.asarray(x))
    tq, ts = tsrv._quant_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-7, atol=0)


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_advance_ragged_matches_jax(models, kv_dtype):
    """Offset prefill into two rows, then decode steps of every row at its
    own length (one row pinned at the arena edge): logits, lengths and the
    cache's live entries agree."""
    jcfg, jparams, tcfg, tparams = models
    m_len = 16
    jc = jsrv.init_ragged_cache(jcfg, 3, m_len, kv_dtype=kv_dtype)
    tc = tsrv.init_ragged_cache(tcfg, 3, m_len, kv_dtype=kv_dtype)
    rng = np.random.default_rng(3)
    for row, (start, n) in enumerate([(0, 6), (0, 4)]):
        toks = rng.integers(0, MODEL["vocab_size"], (1, 8)).astype(np.int32)
        jl, jc = jsrv.advance_ragged(jparams, jc, jnp.asarray(toks), jcfg,
                                     row=jnp.int32(row), start=jnp.int32(start))
        tl, tc = tsrv.advance_ragged(tparams, tc, torch.from_numpy(toks), tcfg,
                                     row=row, start=start)
        np.testing.assert_allclose(tl.numpy()[:, :n], np.asarray(jl)[:, :n], atol=ATOL, rtol=0)
        jc = jc._replace(lengths=jc.lengths.at[row].set(n))
        tc.lengths[row] = n
    # a tail prefill at an offset, as after a prefix hit
    toks = rng.integers(0, MODEL["vocab_size"], (1, 2)).astype(np.int32)
    jl, jc = jsrv.advance_ragged(jparams, jc, jnp.asarray(toks), jcfg,
                                 row=jnp.int32(1), start=jnp.int32(4))
    tl, tc = tsrv.advance_ragged(tparams, tc, torch.from_numpy(toks), tcfg, row=1, start=4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    jc = jc._replace(lengths=jc.lengths.at[1].set(6).at[2].set(m_len - 1))
    tc.lengths.copy_(torch.tensor([6, 6, m_len - 1], dtype=torch.int32))
    for _ in range(3):
        toks = rng.integers(0, MODEL["vocab_size"], (3, 1)).astype(np.int32)
        jl, jc = jsrv.advance_ragged(jparams, jc, jnp.asarray(toks), jcfg)
        tl, tc = tsrv.advance_ragged(tparams, tc, torch.from_numpy(toks), tcfg)
        np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
        # row 2 sits at the edge: its logits are an idle row's, never read
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], atol=ATOL, rtol=0)
    assert tc.lengths.tolist() == [9, 9, m_len]
    for name in ("k", "v") + (("k_scale", "v_scale") if kv_dtype else ()):
        live_t = getattr(tc, name)[:, :2, :9].float().numpy()
        live_j = np.asarray(getattr(jc, name))[:, :2, :9].astype(np.float32)
        np.testing.assert_allclose(live_t, live_j, atol=1.0 if name in ("k", "v") and kv_dtype
                                   else ATOL, rtol=0)


def test_prefill_past_the_arena_raises(models):
    """Where lax.dynamic_update_slice clamps its start silently, the port
    refuses: the engine never sends such a write."""
    _, _, tcfg, tparams = models
    tc = tsrv.init_ragged_cache(tcfg, 1, 8)
    with pytest.raises(ValueError) as err:
        tsrv.advance_ragged(tparams, tc, torch.zeros((1, 4), dtype=torch.long), tcfg,
                            row=0, start=6)
    assert "overruns" in str(err.value)


# -- streams against the JAX engine ---------------------------------------
CONFIGS = {
    "dense": {},
    "chunk4": dict(prefill_chunk=4),
    "chunk7": dict(prefill_chunk=7),
    "int8_kv": dict(kv_dtype="int8"),
    "steps4": dict(decode_steps=4),
    "steps3": dict(decode_steps=3),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_greedy_streams_match_jax(models, name):
    prompts, budgets = _trace()
    ref, out, eng = both(models, prompts, budgets, **CONFIGS[name])
    assert out == ref
    if name.startswith("chunk"):
        assert eng.prefill_chunks_done > len(prompts)
    if name.startswith("steps"):
        assert eng.fused_windows > 0 and eng.graph_windows == 0  # eager on the CPU


def test_prefix_cache_streams_match_jax(models):
    """A shared system prompt: hits restore the cached KV and prefill only
    the tail, with the same hits, reuse and LRU contents as the reference."""
    prompts, budgets = _trace(seed=4, system=SYSTEM)
    jcfg, jparams, tcfg, tparams = models
    ref, jeng = drive(jsrv, jparams, jcfg, prompts, budgets, prefix_cache_size=6)
    out, teng = drive(tsrv, tparams, tcfg, prompts, budgets, prefix_cache_size=6)
    assert out == ref
    assert teng.prefix_hits == jeng.prefix_hits > 0
    assert teng.prefix_tokens_reused == jeng.prefix_tokens_reused
    assert list(teng._prefix_cache) == list(jeng._prefix_cache)


def test_prefix_payload_is_a_copy(models):
    """A stored prefix is a clone: overwriting the row it came from does not
    change it."""
    _, _, tcfg, tparams = models
    eng = tsrv.ServingEngine(tparams, tcfg, max_batch=1, max_len=MAX_LEN,
                             prefix_cache_size=4)
    eng.submit(SYSTEM + [1, 2], 2)
    eng.run_until_drained()
    payload, _ = eng._prefix_cache[tuple(SYSTEM + [1, 2])]
    before = payload[0].clone()
    eng.cache.k.fill_(7.0)
    assert torch.equal(payload[0], before)


@pytest.mark.parametrize("decode_steps", [4, 3])
def test_eos_around_a_window_boundary_matches_jax(models, decode_steps):
    """EOS probed inside a window, at its boundary and after it: the stream
    stops there, surplus window tokens are discarded, as in JAX."""
    jcfg, jparams, tcfg, tparams = models
    prompt = [5, 9, 2]
    (stream, _), = drive(tsrv, tparams, tcfg, [prompt], [9])[0]
    probes = [p for p in (decode_steps - 1, decode_steps, decode_steps + 1)
              if stream[p] not in stream[:p]]
    assert probes, "every probe position repeats an earlier token"
    for pos in probes:
        kw = dict(decode_steps=decode_steps, eos_id=stream[pos])
        ref, _ = drive(jsrv, jparams, jcfg, [prompt, [17, 3, 88]], [9, 8], **kw)
        out, _ = drive(tsrv, tparams, tcfg, [prompt, [17, 3, 88]], [9, 8], **kw)
        assert out == ref
        assert out[0] == (stream[:pos + 1], "eos"), pos


def test_single_request_equals_generate(models):
    """One request through the engine is the port's greedy generate."""
    _, _, tcfg, tparams = models
    prompt = [17, 3, 88, 41, 7]
    (toks, reason), = drive(tsrv, tparams, tcfg, [prompt], [7])[0]
    ref = tdec.generate(tparams, torch.tensor([prompt]), tcfg, 7)
    assert toks == ref[0].tolist() and reason == "length"


def test_int8_weights_serve_exactly(models):
    """int8 weight trees flow through the engine and match int8 generate."""
    _, _, tcfg, tparams = models
    q = tquant.quantize_params(tparams, tcfg)
    (toks, _), = drive(tsrv, q, tcfg, [[5, 9, 2]], [5])[0]
    assert toks == tdec.generate(q, torch.tensor([[5, 9, 2]]), tcfg, 5)[0].tolist()


def test_idle_row_lengths_clamp_at_arena(models):
    """Retired rows advance with every shared decode step; their lengths
    clamp at the arena (and the decode scatter at its last position)
    instead of running past it, and nothing raises."""
    _, _, tcfg, tparams = models
    eng = tsrv.ServingEngine(tparams, tcfg, max_batch=2, max_len=32)
    short = eng.submit([5], 1)
    long_req = eng.submit([5, 9, 2], 25)
    eng.run_until_drained()
    assert short.done and long_req.done
    assert (eng.cache.lengths <= 32).all()
    # slot 1 stays idle through two more requests in slot 0: it is pinned
    # at the edge, where its writes go to the dead last position
    for _ in range(2):
        again = eng.submit([5, 9, 2], 25)
        eng.run_until_drained()
        assert again.tokens_out == long_req.tokens_out
    assert eng.cache.lengths.tolist()[1] == 32


# -- sampling ----------------------------------------------------------------
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95, seed=11)


def _sampled(models, prompts, budgets, **kw):
    _, _, tcfg, tparams = models
    out, _ = drive(tsrv, tparams, tcfg, prompts, budgets, **dict(SAMPLED, **kw))
    return [t for t, _ in out]


def test_sampled_streams_ignore_arrival_batch_and_window(models):
    """A sampled stream depends on (seed, rid, count, logits) only: the same
    under other arrival spacing, another max_batch and fused windows."""
    prompts, budgets = _trace(seed=5)
    base = _sampled(models, prompts, budgets)
    assert _sampled(models, prompts, budgets, arrival_every=1) == base
    assert _sampled(models, prompts, budgets, max_batch=5) == base
    assert _sampled(models, prompts, budgets, decode_steps=4) == base
    assert _sampled(models, prompts, budgets, seed=12) != base


def test_top_k_one_equals_greedy(models):
    prompts, budgets = _trace(seed=6)
    greedy = [t for t, _ in drive(tsrv, models[3], models[2], prompts, budgets)[0]]
    assert _sampled(models, prompts, budgets, top_k=1, top_p=1.0) == greedy


def test_stream_uniforms_are_per_row_pure():
    """Row (rid, count) draws the same uniforms wherever it sits."""
    rids, counts = torch.tensor([3, 9, 3]), torch.tensor([5, 0, 5])
    u = tsrv.stream_uniforms(7, rids, counts, 64)
    assert torch.equal(u[0], u[2]) and not torch.equal(u[0], u[1])
    alone = tsrv.stream_uniforms(7, rids[1:2], counts[1:2], 64)
    assert torch.equal(alone[0], u[1])
    assert float(u.min()) > 0.0 and float(u.max()) < 1.0


def test_gumbel_max_draws_from_the_softmax():
    """Over 4096 (rid, count) coordinates the draw frequencies of a fixed
    4-way distribution are within 3 sigma of its probabilities."""
    logits = torch.log(torch.tensor([0.1, 0.2, 0.3, 0.4]))[None].expand(4096, 4)
    rids = torch.arange(4096) // 64
    counts = torch.arange(4096) % 64
    picks = tsrv.sample_rows(logits, rids, counts, seed=1, temperature=1.0,
                             top_k=0, top_p=1.0)
    freq = torch.bincount(picks, minlength=4).double() / 4096
    p = torch.tensor([0.1, 0.2, 0.3, 0.4], dtype=torch.float64)
    assert bool(((freq - p).abs() <= 3 * torch.sqrt(p * (1 - p) / 4096)).all()), freq


# -- queueing ----------------------------------------------------------------
class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_priority_insert_keeps_fifo_within_level(models):
    _, _, tcfg, tparams = models
    eng = tsrv.ServingEngine(tparams, tcfg, max_batch=1, max_len=MAX_LEN)
    a = eng.submit([1, 2], 2)
    b = eng.submit([3, 4], 2, priority=5)
    c = eng.submit([5, 6], 2)
    d = eng.submit([7, 8], 2, priority=5)
    assert eng.queue == [b, d, a, c]


def test_overload_sheds_low_priority_first(models):
    _, _, tcfg, tparams = models
    clock = FakeClock()
    eng = tsrv.ServingEngine(tparams, tcfg, max_batch=1, max_len=64,
                             queue_timeout_s=10.0, clock=clock)
    running = eng.submit([5, 9, 2], 3)
    eng.step()
    assert eng.slots[0] is running
    low = eng.submit([1, 2], 4, priority=0)
    clock.t = 8.0
    high = eng.submit([3, 4], 4, priority=1)
    assert eng.queue[0] is high
    clock.t = 12.0
    eng.run_until_drained()
    assert low.finish_reason == "shed" and low.tokens_out == [] and low.admitted_at is None
    assert high.finish_reason == "length" and len(high.tokens_out) == 4
    assert running.finish_reason == "length"


def test_age_boost_bounds_low_priority_wait(models):
    """One level per age_boost_secs waited: a low-priority waiter that has
    waited long enough outranks a fresher high-priority one."""
    _, _, tcfg, tparams = models
    clock = FakeClock()
    eng = tsrv.ServingEngine(tparams, tcfg, max_batch=1, max_len=64,
                             age_boost_secs=10.0, clock=clock)
    eng.submit([5, 9, 2], 2)
    eng.step()
    low = eng.submit([1, 2], 2, priority=0)
    clock.t = 25.0
    high = eng.submit([3, 4], 2, priority=1)
    assert eng._next_waiter_index() == eng.queue.index(low)  # 0 + 2 > 1 + 0
    eng.run_until_drained()
    assert low.admitted_at <= high.admitted_at
    strict = tsrv.ServingEngine(tparams, tcfg, max_batch=1, max_len=64, clock=clock)
    strict.submit([1, 2], 2)
    strict.submit([3, 4], 2, priority=1)
    clock.t = 1000.0
    assert strict._next_waiter_index() == 0


# -- drain -------------------------------------------------------------------
def test_drain_finishes_or_preempts(models):
    _, _, tcfg, tparams = models
    eng = tsrv.ServingEngine(tparams, tcfg, max_batch=2, max_len=MAX_LEN)
    a = eng.submit([5, 9, 2], 4)
    assert eng.drain(deadline_s=None) is True and a.finish_reason == "length"
    with pytest.raises(tsrv.EngineDraining):
        eng.submit([1, 2], 2)
    eng.end_drain()
    busy = [eng.submit([5, 9, 2], 30), eng.submit([7], 30), eng.submit([8, 8], 30)]
    eng.step()
    with pytest.raises(RuntimeError):
        eng.end_drain()
    assert eng.drain(deadline_s=0.0) is False
    assert all(r.done and r.finish_reason == "preempted" for r in busy)
    assert not eng.queue and all(s is None for s in eng.slots)
    eng.end_drain()


def test_unported_options_raise(models):
    _, _, tcfg, tparams = models
    # speculative serving and the mesh layout are ported
    # (tests/test_torch_serving_speculative.py,
    # tests/test_torch_sharded_serving.py); a mesh must be the ("dp", "tp")
    # serving mesh, with or without a draft
    from hivedscheduler_tpu_torch.models.speculative import SpecDecodeConfig

    spec = SpecDecodeConfig(draft_params=tparams, draft_cfg=tcfg)
    for kw in (dict(mesh=object()), dict(mesh=object(), spec_decode=spec)):
        with pytest.raises(ValueError) as err:
            tsrv.ServingEngine(tparams, tcfg, **kw)
        assert "the serving mesh has the axes ('dp', 'tp')" in str(err.value)
    with pytest.raises(ValueError):
        tsrv.ServingEngine(tparams, tcfg, decode_steps=0)
    with pytest.raises(ValueError):
        tsrv.ServingEngine(tparams, tcfg, kv_dtype="fp8")
