"""The port's paged KV cache (hivedscheduler_tpu_torch.models.serving,
``page_size > 0``) against the JAX package's on the same weights (bridged,
f32) and the same numpy traces.

``gather_block_kv`` and ``block_coords`` agree with JAX's on the same
integer arrays exactly, and ``advance_paged``'s logits to atol 1e-5 (the
two packages differ by summation order only). Greedy streams and finish
reasons equal the JAX paged engine's, per request, under prefix sharing
with copy-on-write mid-block, chunked prefill, int8 KV, fused windows with
an EOS at the boundary, admission gated on free blocks and pool
exhaustion; after every step of every port engine here the JAX package's
own ``chaos.invariants.check_block_pool`` audits the port's allocator
books, as does the port's copy, which must also catch a seeded leak, a
double-alloc and a drifted table row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.chaos import invariants as jinv
from hivedscheduler_tpu.models import serving as jsrv
from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu.ops import attention as jattn
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch.chaos import invariants as tinv
from hivedscheduler_tpu_torch.models import serving as tsrv
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

ATOL = 1e-5
MODEL = dict(vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
             d_ff=128, max_seq_len=128)
SYSTEM = [7, 11, 23, 42, 5, 9, 81, 2, 64, 33]  # one full block of 8 + 2


@pytest.fixture(scope="module")
def models():
    jcfg = jtm.TransformerConfig(dtype=jnp.float32, **MODEL)
    tcfg = ttm.TransformerConfig(dtype=torch.float32, **MODEL)
    params_np = jax.device_get(jtm.init_params(jcfg, jax.random.PRNGKey(0)))
    return jcfg, jax.tree.map(jnp.asarray, params_np), tcfg, bridge.from_numpy_tree(params_np)


def _trace(seed, n=6, system=()):
    rng = np.random.default_rng(seed)
    prompts = [list(system) + [int(t) for t in rng.integers(0, MODEL["vocab_size"],
                                                            int(rng.integers(2, 20)))]
               for _ in range(n)]
    return prompts, [int(rng.integers(3, 12)) for _ in range(n)]


def drive(mod, params, cfg, prompts, budgets, arrival_every=2, audit=False, **kw):
    """Serve the trace (one arrival every ``arrival_every`` steps); with
    ``audit``, both packages' pool checks after every step."""
    kw.setdefault("max_batch", 3)
    kw.setdefault("max_len", 48)
    eng = mod.ServingEngine(params, cfg, **kw)
    pending, reqs, step = list(zip(prompts, budgets)), [], 0
    while pending or any(not r.done for r in reqs):
        if pending and step % arrival_every == 0:
            reqs.append(eng.submit(*pending.pop(0)))
        eng.step()
        if audit:
            jinv.check_block_pool(eng, f"step {step}")
            tinv.check_block_pool(eng, f"step {step}")
        step += 1
    return [(r.tokens_out, r.finish_reason) for r in reqs], eng


def both(models, prompts, budgets, **kw):
    jcfg, jparams, tcfg, tparams = models
    ref, jeng = drive(jsrv, jparams, jcfg, prompts, budgets, **kw)
    out, teng = drive(tsrv, tparams, tcfg, prompts, budgets, audit=True, **kw)
    assert out == ref
    return jeng, teng


# -- the block indirection ---------------------------------------------------
def test_gather_block_kv_and_block_coords_match_jax():
    rng = np.random.default_rng(0)
    pool = rng.standard_normal((6, 4, 2, 3)).astype(np.float32)
    table = np.array([[2, 0, 5], [1, 4, 0]], np.int32)
    np.testing.assert_array_equal(
        tattn.gather_block_kv(torch.from_numpy(pool), torch.from_numpy(table)).numpy(),
        np.asarray(jattn.gather_block_kv(jnp.asarray(pool), jnp.asarray(table))))
    scales = pool[..., 0]  # an int8 scale pool's tail shape [H_kv]
    np.testing.assert_array_equal(
        tattn.gather_block_kv(torch.from_numpy(scales), torch.from_numpy(table)).numpy(),
        np.asarray(jattn.gather_block_kv(jnp.asarray(scales), jnp.asarray(table))))
    for pos, tbl in ((np.array([[0, 5, 11, 99], [3, 4, 12, 7]], np.int32), table),
                     (np.array([[6, 7, 8, 9, 10, 11, 12, 13]], np.int32), table[1:])):
        jb, jo = jattn.block_coords(jnp.asarray(pos), jnp.asarray(tbl), 4)
        tb, to = tattn.block_coords(torch.from_numpy(pos), torch.from_numpy(tbl), 4)
        assert tb.tolist() == np.asarray(jb).tolist() and to.tolist() == np.asarray(jo).tolist()


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_advance_paged_matches_jax(models, kv_dtype):
    """A prefill through a row's table (the cover spans two blocks, the
    padded tail runs into trash), an offset tail prefill, then decode steps
    with one idle row parked on the trash block."""
    jcfg, jparams, tcfg, tparams = models
    block, nbs = 4, 4
    jp = jsrv.init_paged_pool(jcfg, 9, block, kv_dtype=kv_dtype)
    tp = tsrv.init_paged_pool(tcfg, 9, block, kv_dtype=kv_dtype)
    table = np.array([[3, 5, 0, 0], [1, 2, 7, 0], [0, 0, 0, 0]], np.int32)
    jt, tt = jnp.asarray(table), torch.from_numpy(table.astype(np.int64))
    rng = np.random.default_rng(1)
    for row, (start, n) in enumerate([(0, 6), (0, 8)]):
        toks = rng.integers(0, MODEL["vocab_size"], (1, 8)).astype(np.int32)
        jl, jp = jsrv.advance_paged(jparams, jp, jnp.asarray(toks), jcfg, jt,
                                    row=jnp.int32(row), start=jnp.int32(start))
        tl, tp = tsrv.advance_paged(tparams, tp, torch.from_numpy(toks), tcfg, tt,
                                    row=row, start=start)
        np.testing.assert_allclose(tl.numpy()[:, :n], np.asarray(jl)[:, :n], atol=ATOL, rtol=0)
    toks = rng.integers(0, MODEL["vocab_size"], (1, 2)).astype(np.int32)
    jl, jp = jsrv.advance_paged(jparams, jp, jnp.asarray(toks), jcfg, jt,
                                row=jnp.int32(1), start=jnp.int32(8))
    tl, tp = tsrv.advance_paged(tparams, tp, torch.from_numpy(toks), tcfg, tt, row=1, start=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    lengths = np.array([6, 10, nbs * block - 1], np.int32)
    for _ in range(2):
        toks = rng.integers(0, MODEL["vocab_size"], (3, 1)).astype(np.int32)
        jl, jp = jsrv.advance_paged(jparams, jp, jnp.asarray(toks), jcfg, jt, jnp.asarray(lengths))
        tl, tp = tsrv.advance_paged(tparams, tp, torch.from_numpy(toks), tcfg, tt,
                                    torch.from_numpy(lengths))
        np.testing.assert_allclose(tl.numpy()[:2], np.asarray(jl)[:2], atol=ATOL, rtol=0)
        lengths[:2] += 1
    for name in ("k", "v") + (("k_scale", "v_scale") if kv_dtype else ()):
        t, j = getattr(tp, name), np.asarray(getattr(jp, name))
        for blk in (1, 2, 3, 5, 7):  # every live block; 0 is trash
            np.testing.assert_allclose(t[:, blk].float().numpy(), j[:, blk].astype(np.float32),
                                       atol=1.0 if kv_dtype and name in ("k", "v") else ATOL,
                                       rtol=0)


# -- streams against the JAX paged engine -------------------------------------
def test_paged_streams_match_jax(models):
    prompts, budgets = _trace(seed=10)
    _, eng = both(models, prompts, budgets, page_size=8)
    assert eng.blocks_in_use == 0


def test_prefix_sharing_and_cow_mid_block_match_jax(models):
    """Prompts sharing the 10-token system prefix: later ones take the
    cached blocks by reference (one full, one partial) and copy the partial
    block when they write into it mid-block."""
    prompts = [SYSTEM + [100, 101], SYSTEM + [120, 90, 3], SYSTEM + [100, 101, 55],
               SYSTEM[:8] + [1, 2, 3]]
    jeng, teng = both(models, prompts, [5, 6, 4, 3], arrival_every=3,
                      page_size=8, prefix_cache_size=16)
    assert teng.prefix_block_hits == jeng.prefix_block_hits >= 1
    assert teng.blocks_cow == jeng.blocks_cow >= 1
    assert list(teng._prefix_cache) == list(jeng._prefix_cache)


def test_chunked_prefill_with_prefix_matches_jax(models):
    prompts, budgets = _trace(seed=11, system=SYSTEM)
    _, eng = both(models, prompts, budgets, page_size=8, prefix_cache_size=8,
                  prefill_chunk=3)
    assert eng.prefill_chunks_done > 0


def test_int8_kv_paged_matches_jax_and_dense(models):
    prompts, budgets = _trace(seed=12, system=SYSTEM)
    jcfg, jparams, tcfg, tparams = models
    both(models, prompts, budgets, page_size=8, kv_dtype="int8", prefix_cache_size=8)
    paged, _ = drive(tsrv, tparams, tcfg, prompts, budgets, page_size=8, kv_dtype="int8")
    dense, _ = drive(tsrv, tparams, tcfg, prompts, budgets, kv_dtype="int8")
    assert paged == dense


def test_fused_window_eos_at_boundary_matches_jax(models):
    """decode_steps 3 with the EOS at a window boundary: the stream stops
    there, as in JAX."""
    jcfg, jparams, tcfg, tparams = models
    (stream, _), = drive(tsrv, tparams, tcfg, [[5, 9, 2]], [10], page_size=8)[0]
    pos = next(p for p in (3, 2, 4) if stream[p] not in stream[:p])
    kw = dict(page_size=8, decode_steps=3, eos_id=stream[pos])
    _, eng = both(models, [[5, 9, 2], [17, 3, 88, 41, 7]], [10, 9], **kw)
    assert eng.fused_windows > 0


def test_admission_gated_on_block_availability(models):
    """8 usable blocks, 17-token prompts (3 blocks, growing to 4): at most
    two streams at once though 4 slots exist, nothing preempted, the same
    streams as JAX."""
    prompts = [[40 + i] * 17 for i in range(4)]
    jeng, teng = both(models, prompts, [15] * 4, arrival_every=1, max_batch=4,
                      max_len=64, page_size=8, num_blocks=9)
    assert teng.pool_preempted == jeng.pool_preempted == 0


def test_pool_exhaustion_preempts_like_jax(models):
    """Decode growth exhausts the pool: the youngest stream is preempted,
    the survivor finishes, every block comes back."""
    jeng, teng = both(models, [[3] * 10, [9] * 10], [20, 20], arrival_every=1,
                      max_batch=2, max_len=32, page_size=4, num_blocks=9)
    assert teng.pool_preempted == jeng.pool_preempted == 1
    assert teng.blocks_in_use == 0


def test_cache_blocks_reclaimed_before_preemption(models):
    """Cached prefix blocks are evicted (LRU) before any stream is
    preempted."""
    prompts = [[1, 2, 3, 4, 5, 6, 7, 8, 9], [11, 12, 13, 14, 15, 16, 17, 18, 19],
               [21, 22, 23, 24, 25, 26, 27]]
    jeng, teng = both(models, prompts, [6, 6, 12], arrival_every=4, max_batch=1,
                      max_len=32, page_size=4, num_blocks=9, prefix_cache_size=8)
    assert teng.pool_preempted == jeng.pool_preempted == 0
    assert list(teng._prefix_cache) == list(jeng._prefix_cache)


# -- the allocator's books ----------------------------------------------------
def _busy(models, **kw):
    _, _, tcfg, tparams = models
    eng = tsrv.ServingEngine(tparams, tcfg, max_batch=2, max_len=64, page_size=8, **kw)
    eng.submit([5, 9, 2], 40)
    eng.submit(SYSTEM + [1], 40)
    eng.step()
    return eng


def test_drain_returns_every_block(models):
    eng = _busy(models, prefix_cache_size=4)
    assert eng.blocks_in_use > 0
    assert eng.drain(deadline_s=0.0) is False
    jinv.check_block_pool(eng, "after drain")
    tinv.check_block_pool(eng, "after drain")
    # the prefix cache keeps its entries' blocks; nothing else is held
    held = {b for payload, _ in eng._prefix_cache.values() for b in payload}
    assert eng.blocks_in_use == len(held)
    assert all(not b for b in eng._slot_bids) and not eng._table.any()


@pytest.mark.parametrize("fault, words", [
    ("double_alloc", "double-allocated"), ("refcount", "refcount"),
    ("leak", "leaked"), ("table", "table row")])
def test_port_checker_catches_seeded_faults(models, fault, words):
    eng = _busy(models)
    tinv.check_block_pool(eng, "clean")
    bid = eng._slot_bids[0][0]
    if fault == "double_alloc":
        eng._free.append(bid)  # referenced AND free
    elif fault == "refcount":
        eng._ref[bid] += 1
    elif fault == "leak":
        gone = eng._slot_bids[0].pop()  # dropped without going back to the free list
        eng._table[0, len(eng._slot_bids[0])] = 0
        eng._ref[gone] = 0
    else:
        eng._table[1, [0, 1]] = eng._table[1, [1, 0]]  # swapped entries
    with pytest.raises(tinv.InvariantViolation) as port_err:
        tinv.check_block_pool(eng, "seeded")
    with pytest.raises(jinv.InvariantViolation) as jax_err:
        jinv.check_block_pool(eng, "seeded")
    assert words in str(port_err.value) and words in str(jax_err.value)


def test_env_kill_switch_forces_dense(models, monkeypatch):
    _, _, tcfg, tparams = models
    monkeypatch.setenv("HIVED_PAGED_KV", "0")
    eng = tsrv.ServingEngine(tparams, tcfg, max_batch=2, max_len=64, page_size=8)
    assert not eng.paged and eng.pool is None and eng.cache is not None
    monkeypatch.setenv("HIVED_PAGED_KV", "1")
    assert tsrv.ServingEngine(tparams, tcfg, max_batch=2, max_len=64, page_size=8).paged


def test_num_blocks_validation(models):
    _, _, tcfg, tparams = models
    with pytest.raises(ValueError) as err:
        tsrv.ServingEngine(tparams, tcfg, max_batch=2, max_len=64, page_size=8, num_blocks=8)
    assert "trash" in str(err.value)
    eng = tsrv.ServingEngine(tparams, tcfg, max_batch=2, max_len=64, page_size=8)
    assert eng.num_blocks == 2 * 8 + 1


def test_admission_math(models):
    """Needed blocks = cover - floor(plen / page), plus a spare when the
    first decode token opens a fresh block."""
    _, _, tcfg, tparams = models
    eng = tsrv.ServingEngine(tparams, tcfg, max_batch=2, max_len=64, page_size=8)
    for n, fits, short in ((17, [1, 2, 3], [1, 2]), (16, [1, 2, 3], [1, 2])):
        req = tsrv.Request(0, list(range(n)), 4)
        eng._free = list(fits)
        assert eng._blocks_admit(req, None)
        eng._free = list(short)
        assert not eng._blocks_admit(req, None)


def test_copy_on_write_copies_values_and_scales(models):
    """The copy is a real copy: writing the source afterwards leaves it."""
    _, _, tcfg, tparams = models
    eng = tsrv.ServingEngine(tparams, tcfg, max_batch=1, max_len=16, page_size=4,
                             kv_dtype="int8")
    for t in tsrv._kv_tensors(eng.pool):
        t[:, 1].fill_(3)
    eng._copy_block(1, 2)
    for t in tsrv._kv_tensors(eng.pool):
        t[:, 1].fill_(5)
        assert bool((t[:, 2] == 3).all())


def test_trim_blocks_returns_the_tail(models):
    """Rolling a slot back (the speculative verify's rollback) returns the
    blocks past the kept tokens, with the books clean."""
    eng = _busy(models)
    bids = list(eng._slot_bids[1])
    assert len(bids) >= 2
    eng._trim_blocks(1, 8)  # keep one block of 8
    assert eng._slot_bids[1] == bids[:1]
    assert list(eng._table[1]) == bids[:1] + [0] * (eng._blocks_per_slot - 1)
    assert all(b in eng._free for b in bids[1:])
    jinv.check_block_pool(eng, "after trim")
    tinv.check_block_pool(eng, "after trim")
