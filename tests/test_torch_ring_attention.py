"""The port's sequence-parallel attention (``parallel/ring_attention.py``)
and the f32 forms of its flash kernels, against the JAX package on the CPU.

- The plain versions of K1's f32 output and K2/K3's f32 gradients against
  JAX's ``_flash_forward(out_dtype=f32)`` and ``_flash_backward(grad_dtype=
  f32)`` in Pallas interpret mode, on bf16 inputs: atol 2e-5 and 3e-5
  (both compute in f32 from the same bf16 values; the bounds of
  ``test_torch_attention.py`` and ``test_torch_train.py``).
- Each attention of the ring family on gloo gangs of 2 (and 4, ``slow``)
  processes (``tests/torch_ring_worker.py``), each rank on its slice of the
  sequence, against its JAX counterpart on a CPU mesh of the same size:
  outputs atol 2e-5, gradients 5e-5 (``tests/test_parallel.py``'s bounds:
  f32, only the summation order differs). The flash rings run twice: with
  the kernels forced (no mesh context, as ``tests/test_ring_flash.py``
  drives JAX's interpret-mode kernels) and through the public entry, which
  takes the einsum ring by JAX's route rule; the route each side took is
  asserted.
- The hop schedule itself, the replay of a whole ring in one process that
  ``chip_smoke.py`` runs on the card (here on the plain versions), and the
  JAX package's errors.
"""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu.ops import attention as jattn
from hivedscheduler_tpu.parallel import ring_attention as jra
from hivedscheduler_tpu.parallel import topology as jtopo
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.ops import attention as tattn
from hivedscheduler_tpu_torch.parallel import ring_attention as tra

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_ring_worker.py")
sys.path.insert(0, os.path.join(ROOT, "tests"))

from test_torch_sharded_train import Gang, _free_port, _result  # noqa: E402

FWD_ATOL, BWD_ATOL = 2e-5, 3e-5  # the f32 forms
OUT_ATOL, GRAD_ATOL = 2e-5, 5e-5  # the attentions on gangs
B, T, H, H_KV, D = 2, 32, 4, 2, 8
BLOCK = 8
IMPLS = ("ring", "ring_noncausal", "ring_flash", "ring_flash_kernels",
         "ring_flash_kernels_noncausal", "zigzag", "zigzag_flash",
         "zigzag_flash_kernels", "ulysses")
# the public flash entries run in a mesh context: the einsum ring on the CPU
EINSUM_ROUTED = ("ring_flash", "zigzag_flash")


def _bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bf16 values, kept as f32 numpy (both frameworks
    read the same bf16 numbers)."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _inputs(seed, b, t, h, h_kv, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s, dtype=np.float32)
            for s in ((b, t, h, d), (b, t, h_kv, d), (b, t, h_kv, d), (b, t, h, d))]


# -- the kernels' f32 forms --------------------------------------------------

# (h_kv, causal, d, t, block_q, block_k): D 32 at T=256 over blocks 128/64,
# ids ``h_kv-causal``; the head dims past 128 (run at the padded width 256 on
# the card) with MQA at T=128 over blocks of 64
F32_CASES = [pytest.param(h_kv, causal, 32, 256, 128, 64, id=f"{h_kv}-{causal}")
             for h_kv in (4, 2) for causal in (True, False)] + [
    pytest.param(1, causal, d, 128, 64, 64, id=f"1-{causal}-{d}")
    for d in (136, 192, 256) for causal in (True, False)]


@pytest.mark.parametrize("h_kv, causal, d, t, block_q, block_k", F32_CASES)
def test_plain_f32_forward_matches_jax_kernel(h_kv, causal, d, t, block_q, block_k):
    # bf16 inputs, f32 output: what each ring hop asks of K1
    q, k, v, _ = (_bf16(x) for x in _inputs(0, 1, t, 4, h_kv, d))
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        o_ref, lse_ref = jattn._flash_forward(
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), causal=causal,
            block_q=block_q, block_k=block_k, interpret=True, out_dtype=jnp.float32)
    qt, kt, vt = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    o, lse = tattn.flash_forward(qt, kt, vt, causal=causal, out_dtype=torch.float32)
    assert o.dtype == torch.float32 and o_ref.dtype == jnp.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=FWD_ATOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[..., 0], atol=FWD_ATOL, rtol=0)
    # the default keeps q's dtype: the f32 output rounds to it
    o16, _ = tattn.flash_forward(qt, kt, vt, causal=causal)
    assert o16.dtype == torch.bfloat16
    assert torch.equal(o16, o.to(torch.bfloat16))


@pytest.mark.parametrize("h_kv, causal, d, t, block_q, block_k", F32_CASES)
def test_plain_f32_backward_matches_jax_kernel(h_kv, causal, d, t, block_q, block_k):
    q, k, v, do = (_bf16(x) for x in _inputs(1, 1, t, 4, h_kv, d))
    qt, kt, vt, dot = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    # K2/K3 read the ring's merged out in bf16 and its f32 lse
    o, lse = tattn.flash_forward(qt, kt, vt, causal=causal)
    lanes = np.broadcast_to(lse.numpy()[..., None], lse.shape + (jattn._LANES,))
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        ref = jattn._flash_backward(
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
            jnp.asarray(o.float().numpy(), jnp.bfloat16), jnp.asarray(lanes),
            jnp.asarray(do, jnp.bfloat16), causal=causal, block_q=block_q,
            block_k=block_k, interpret=True, grad_dtype=jnp.float32)
    got = tattn.flash_backward(qt, kt, vt, o, lse, dot, causal=causal,
                               grad_dtype=torch.float32)
    for g, r, name in zip(got, ref, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32 and r.dtype == jnp.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=BWD_ATOL, rtol=0,
                                   err_msg=name)


def test_f32_launch_counters_exist_apart_from_the_bf16_ones():
    # chip_smoke.py proves the ring ran the f32 forms from these
    for name in ("FLASH_FWD_F32_LAUNCHES", "FLASH_BWD_DQ_F32_LAUNCHES",
                 "FLASH_BWD_DKV_F32_LAUNCHES"):
        assert isinstance(getattr(tattn, name), int)
    assert set(tattn._KERNELS) >= {"hived_flash_fwd_f32", "hived_flash_bwd_dq_f32",
                                   "hived_flash_bwd_dkv_f32"}
    # the f32 entry points take the bf16 ones' arguments
    for name in ("hived_flash_fwd", "hived_flash_bwd_dq", "hived_flash_bwd_dkv"):
        assert tattn._KERNELS[name] == tattn._KERNELS[name + "_f32"]


@pytest.mark.parametrize("d, t, mesh_axes, einsum", [
    (12, 64, (), True),          # D not a multiple of 8: JAX's ring falls back everywhere
    (12, 64, ("sp",), True),
    (16, 96, (), False),         # T tiles no 64-block: the kernels tile it themselves
    (96, 64, ("sp",), False),    # a mesh context: only the interpret mode falls back
])
def test_flash_ring_route_off_the_cpu(d, t, mesh_axes, einsum):
    # a meta tensor stands in for a CUDA one: only JAX's head-dim rule, which
    # holds on every backend, sends it to the einsum ring, counted
    q = torch.empty((1, t, 4, d), device="meta")
    k = torch.empty((1, t, 2, d), device="meta")
    before = tra.RING_REFERENCE_ROUTES
    assert tra._einsum_route(q, k, mesh_axes, 64, 64) is einsum
    assert tra.RING_REFERENCE_ROUTES == before + int(einsum)


# -- the five attentions on gloo gangs ---------------------------------------


def _start_gang(tmp, world, qkv_path):
    """The worker gang of every attention at sp = ``world`` -> (gang, its
    output file), for ``_result``."""
    job = dict(world=world, port=_free_port(), qkv=qkv_path, impls=list(IMPLS),
               block=BLOCK, out=os.path.join(tmp, f"ring{world}.npz"))
    path = os.path.join(tmp, f"ring{world}.json")
    with open(path, "w") as f:
        json.dump(job, f)
    return Gang(tmp, f"ring{world}", world,
                lambda rank: [sys.executable, WORKER, path, str(rank)]), job["out"]


def _jax_attention(name, sp, q, k, v, w, routes):
    """JAX's counterpart of ``name`` on an sp mesh of CPU devices -> (out,
    dq, dk, dv) of sum(out * w); ``routes`` counts the einsum rings that
    its flash rings fell back to."""
    mesh = Mesh(np.array(jax.devices("cpu")[:sp]).reshape(sp), ("sp",))
    spec = P(None, "sp", None, None)
    kw = dict(seq_axis="sp", batch_axes=(), head_axis=None)

    def kernels(fn, **kernel_kw):  # interpret-mode kernels: no vma context
        return jra._get_shard_map()(
            functools.partial(fn, axis_name="sp", mesh_axes=(), **kernel_kw),
            mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec, check_vma=False)

    blocks = dict(block_q=BLOCK, block_k=BLOCK)
    fn = {
        "ring": lambda q, k, v: jra.ring_attention(q, k, v, mesh, **kw),
        "ring_noncausal": lambda q, k, v: jra.ring_attention(q, k, v, mesh, causal=False,
                                                             **kw),
        "ring_flash": lambda q, k, v: jra.ring_flash_attention(q, k, v, mesh, **blocks, **kw),
        "ring_flash_kernels": kernels(jra._ring_flash_attention_local, causal=True, **blocks),
        "ring_flash_kernels_noncausal": kernels(jra._ring_flash_attention_local,
                                                causal=False, **blocks),
        "zigzag": lambda q, k, v: jra.zigzag_ring_attention(q, k, v, mesh, **kw),
        "zigzag_flash": lambda q, k, v: jra.zigzag_ring_flash_attention(
            q, k, v, mesh, **blocks, **kw),
        "zigzag_flash_kernels": kernels(jra._zigzag_flash_attention_local,
                                        block_q=BLOCK // 2, block_k=BLOCK // 2),
        "ulysses": lambda q, k, v: jra.ulysses_attention(q, k, v, mesh, **kw),
    }[name]
    before = dict(routes)
    out, vjp = jax.vjp(jax.jit(fn), *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp(jnp.asarray(w))
    took = {key: routes[key] - before[key] for key in routes}
    return [np.asarray(x) for x in (out, *grads)], took


def _gang_and_reference(tmp, sp, monkeypatch):
    q, k, v, w = _inputs(5, B, T, H, H_KV, D)
    path = os.path.join(tmp, f"qkv{sp}.npz")
    np.savez(path, q=q, k=k, v=v, w=w)
    gang = _start_gang(tmp, sp, path)
    routes = {"einsum": 0}
    for local in ("_ring_attention_local", "_zigzag_ring_attention_local"):
        real = getattr(jra, local)

        def counting(*a, _real=real, **kw):
            routes["einsum"] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(jra, local, counting)
    ref = {name: _jax_attention(name, sp, q, k, v, w, routes) for name in IMPLS}
    monkeypatch.undo()
    return _result(gang), ref


@pytest.fixture(scope="module")
def sp2(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        return _gang_and_reference(str(tmp_path_factory.mktemp("ring")), 2, mp)
    finally:
        mp.undo()


def _assert_matches(got, ref, name):
    (out, dq, dk, dv), _ = ref[name]
    np.testing.assert_allclose(got[f"{name}/out"], out, atol=OUT_ATOL, rtol=0,
                               err_msg=f"{name} out")
    for key, want in (("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_allclose(got[f"{name}/{key}"], want, atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", IMPLS)
def test_attention_at_sp2_matches_jax(sp2, name):
    got, ref = sp2
    _assert_matches(got, ref, name)
    # GQA stayed compact: k/v gradients have the kv heads
    assert got[f"{name}/dk"].shape == (B, T, H_KV, D)


@pytest.mark.parametrize("name", IMPLS)
def test_route_at_sp2_is_jax_route(sp2, name):
    got, ref = sp2
    _, took = ref[name]
    port_einsum = int(got[f"{name}/reference_routes"])
    if name in EINSUM_ROUTED:
        # JAX's interpret-mode kernels cannot run under the vma checker of
        # its mesh context: both sides took the einsum ring
        assert took["einsum"] >= 1 and port_einsum == 1
    else:
        assert port_einsum == 0
        if name.endswith("_kernels"):
            assert took["einsum"] == 0


@pytest.mark.slow
def test_attentions_at_sp4_match_jax(tmp_path, monkeypatch):
    got, ref = _gang_and_reference(str(tmp_path), 4, monkeypatch)
    for name in IMPLS:
        _assert_matches(got, ref, name)


# -- the hop schedule, the replay and the errors -----------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_zigzag_schedule_is_balanced_and_causal(n):
    # every rank computes 2n + 1 quarter-blocks (JAX's count), and a
    # quarter-block is computed iff some of its keys are in its rows' past
    for i in range(n):
        hops = [(src, *hop) for src in range(n) for hop in tra._zigzag_hops(src, i)]
        assert len(hops) == 2 * n + 1
        chunks_q = (i, 2 * n - 1 - i)
        for src in range(n):
            chunks_k = (src, 2 * n - 1 - src)
            for qh in (0, 1):
                for kh in (0, 1):
                    cq, ck = chunks_q[qh], chunks_k[kh]
                    visible = ck <= cq
                    done = [diag for s, q_, k_, diag in hops
                            if (s, q_, k_) == (src, qh, kh)]
                    assert bool(done) == visible, (n, i, src, qh, kh)
                    if done:
                        # the diagonal flag marks the one masked block
                        assert done == [ck == cq]
    for src, i, causal, want in ((0, 0, True, True), (0, 1, True, False),
                                 (1, 0, True, None), (1, 0, False, False)):
        assert tra._ring_hop(src, i, causal) is want


@pytest.mark.parametrize("zigzag", [False, True])
def test_replayed_ring_equals_the_whole_sequence(zigzag):
    # chip_smoke.py's (m) replays a 4-rank ring's hops on the card; here on
    # the plain versions, against the whole-sequence plain forward/backward
    import chip_smoke

    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in _inputs(11, 1, 64, 4, 2, 16))
    out, dq, dk, dv = chip_smoke.ring_replay(q, k, v, do, 4, zigzag)
    o_ref, lse_ref = tattn.flash_attention_plain(q, k, v, causal=True)
    ref = tattn.flash_backward_plain(q, k, v, o_ref, lse_ref, do, causal=True,
                                     grad_dtype=torch.float32)
    assert out.dtype == torch.bfloat16 and dq.dtype == torch.float32
    # one bf16 rounding of o on both sides
    np.testing.assert_allclose(out.float().numpy(), o_ref.float().numpy(), atol=1e-2)
    for got, want in zip((dq, dk, dv), ref):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-3)


def test_zigzag_refuses_non_causal_as_jax_does():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 1, 8, 2, 2, 8))
    for port, ref in ((tra.zigzag_ring_attention, jra.zigzag_ring_attention),
                      (tra.zigzag_ring_flash_attention, jra.zigzag_ring_flash_attention)):
        with pytest.raises(ValueError) as got:
            port(q, k, v, None, causal=False)
        with pytest.raises(ValueError) as want:
            ref(q.numpy(), k.numpy(), v.numpy(), None, causal=False)
        assert "CAUSAL" in str(got.value) and "CAUSAL" in str(want.value)


def test_zigzag_refuses_odd_shards_as_jax_does():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(3, 1, 3, 2, 2, 8))
    for port, ref in ((tra._zigzag_ring_attention_local, jra._zigzag_ring_attention_local),
                      (tra._zigzag_flash_attention_local, jra._zigzag_flash_attention_local)):
        with pytest.raises(ValueError) as got:
            port(q, k, v, tra.SeqAxis())
        with pytest.raises(ValueError) as want:
            ref(q.numpy(), k.numpy(), v.numpy(), axis_name="sp")
        for err in (got, want):
            assert "T % (2 * sp) == 0" in str(err.value)


def test_ulysses_refuses_heads_that_do_not_divide_sp_as_jax_does():
    # 4 heads over tp=2 leave 2 a rank, which sp=4 does not divide
    kw = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=1, d_ff=64,
              attn_impl="ulysses")
    ok, reason = jtm.overlap_applicable(
        jtm.TransformerConfig(dtype=jnp.float32, **kw),
        jtopo.make_mesh(jtopo.MeshAxes(tp=2, sp=4), jax.devices("cpu")[:8]))
    assert not ok and "ulysses needs tp-local heads divisible by sp" in reason
    cfg = ttm.TransformerConfig(dtype=torch.float32, **kw)
    with pytest.raises(ValueError) as err:
        ttm.check_mesh(cfg, {"sp": 4, "tp": 2})
    assert "ulysses needs tp-local heads divisible by sp" in str(err.value)
    with pytest.raises(ValueError):
        ttm.check_mesh(cfg, {"sp": 8})
    ttm.check_mesh(cfg, {"sp": 2, "tp": 2})
    # a rank's own heads are checked again where they are split
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(4, 1, 8, 3, 3, 8))

    axis = tra.SeqAxis()
    axis.size = 2  # checked before any exchange
    with pytest.raises(ValueError) as err:
        tra._ulysses_local(q, k, v, axis)
    assert "divisible by sp" in str(err.value)


def test_sp_above_1_needs_the_ring_family():
    # not any more: xla and flash gather the sequence at sp > 1
    # (tests/test_torch_sp_train.py holds them to JAX), the ring family
    # attends across the slices; every one takes the mesh
    for impl in ttm.ATTN_IMPLS:
        ttm.check_mesh(ttm.TransformerConfig(dtype=torch.float32, attn_impl=impl), {"sp": 2})
    assert set(ttm.ATTN_IMPLS) == {"xla", "flash"} | set(ttm.RING_FAMILY)
