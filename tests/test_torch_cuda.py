"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

    python -m pytest -m cuda tests/test_torch_cuda.py -q   # on a CUDA card

Without a card every test skips: whether a card is present is decided in
the ``cuda`` fixture, never at import, so every xdist worker collects the
same tests. The forward kernel is held to its plain PyTorch version on the
card (o at atol/rtol 2e-2: bf16 output of a kernel that rounds p to bf16,
and every row (b, t, h) within a relative 1e-2 of its reference, so a
fault in a few rows cannot pass; lse at atol 5e-3). The backward kernels
are held to theirs by normalised errors: dq, dk and dv within a relative
Frobenius 1e-2 and every row within a relative 2e-2 (p and ds are rounded
to bf16 for their products; an H100 read ~2.6e-3 and ~5e-3), a row whose
reference is below 1e-3 of the largest row measured against that floor
(row 0 of a causal dq is 0 in exact arithmetic). Shapes include the
kernels' tile edges (T a multiple of 64 but not of 128, T under one tile,
non-causal D=64, a GQA group of 4), and both the forward and the backward
must repeat bit for bit. The model, eval step and train step are held to the xla
path on the same weights. A checkpoint of a small train state round-trips
bit-identically on the card, and the train CLI resumes there. Decode on
the card (f32, no TF32) matches decode on the CPU (logits atol 1e-4,
greedy tokens equal, plain and int8), greedy speculative decoding equals
greedy generate, and the generate CLI prints its rows. The serving engine
on the card (bf16) serves the same streams dense and paged, eager and
through its CUDA-graph decode window, greedy and sampled, int8 KV dense
and paged; its graph refuses a rebound cache; the metrics registry counts
one fused window a window the graph replays; a prefix imported into a
graph-warmed engine keeps the pool's addresses and the next window
replays without a new capture; the serve CLI prints its request lines;
``ServingEngine(mesh=)`` on a one-GPU NCCL serving mesh serves the
mesh-less engine's streams and replays its graph windows with no new
capture once warm. K1-K3 hold at the local shapes a tp=2 shard of the
flagship launches, and a train step on a one-GPU NCCL mesh (DTensor
state) equals the single-device step. K1-K3's f32 forms (the ring's hops)
hold to their plain versions at hop shapes and, rounded once to bf16,
equal the bf16 kernels' outputs; ring_flash at sp = 1 on the NCCL mesh
launches them and equals flash's losses (ring_zigzag_flash within 1e-3).
The MoE model decodes on the card as on the CPU (f32, plain and int8
experts), serves the same streams eager and through the CUDA-graph window,
and its train step on the one-GPU NCCL mesh equals the single-device step.
A LoRA step on the card launches K1-K3, leaves the base bit-identical and
its first loss equal to the dense step's; the speculative engine with the
target as its own draft serves the plain engine's greedy streams wherever
the target's top-1 margin is decisive. K1-K3 and their f32 forms hold at
head dims other than 64 and 128 (32, 72, 80, 96, 112, run at the padded
width 64 or 128, K2 and K3 at 96 for 72-96, which torch.profiler's kernel
names show, at bf16 and fp16 and with no spill; 136, 192 and Gemma's 256
with MQA and ragged T, run at 256), and
store nothing past D into a wider output buffer; a head dim off the
multiples of 8 or a cross-length k takes ``xla_attention``, as in the JAX
package, and the raw kernel call refuses D = 12 and f64. K1-K3 at fp16
inputs run the same wgmma kernels' fp16 forms (outputs in fp16 or f32),
held to their plain versions with the bf16 limits and an error below the
bf16 kernels' on the same inputs; every input dtype past D 1024 runs the
CUDA-core family, held to the
plain versions (f32 within a relative 2e-5), each on its own launch
counter, with nothing stored past D; the fp16 libraries multiply on wgmma
fed by TMA. bf16 and fp16 K1-K3 at 256 < D <= 1024 run the cluster kernels,
held to the plain versions and to the CUDA-core kernels on the same inputs,
bit-reproducible, and their entry points refuse what they do not take. K1,
K2 and K3 at f32 inputs up to D 128 run the 3xTF32 wgmma kernels, held to
the plain f32 forward and backward within 2e-5 (also on inputs whose
operands truncation to tf32 would cut by more than that) and to the
CUDA-core kernels, bit-reproducible in both output forms, on their own
counters; their entry points refuse what they do not take, and every
instance runs on wgmma and TMA. K2 and K3 at f32 inputs past D 128 up to
1024 run the 3xTF32 cluster kernels, held the same way (D 136 with an
8-column last panel, 256, 320, 512 and 1024, MQA and ragged T), storing
nothing past D into a wider buffer; so does K1 there (D 136 to 1024, every
cluster size from 2 to 8 blocks), also held to the CUDA-core K1, refusing
what it does not take, on wgmma and TMA with no local-memory spill.
"""

import os
import re
import subprocess

import numpy as np
import pytest
import torch

from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.ops import _build
from hivedscheduler_tpu_torch.ops import attention as tattn
from hivedscheduler_tpu_torch.parallel import train as ttrain

pytestmark = pytest.mark.cuda

O_TOL = 2e-2
O_REL = 5e-3  # K1's relative Frobenius limit, as chip_smoke.py (b)'s
O_ROW_REL = 1e-2
LSE_ATOL = 5e-3
GRAD_REL = 1e-2
GRAD_ROW_REL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _worst_row_rel(o, o_ref):
    diff = (o.float() - o_ref.float()).norm(dim=-1)
    return float((diff / o_ref.float().norm(dim=-1)).max())


def _grad_errs(x, ref):
    """(relative Frobenius, worst row relative) over rows along D; a row
    whose reference is below 1e-3 of the largest is measured against that
    floor."""
    x, ref = x.float(), ref.float()
    diff = (x - ref).norm(dim=-1)
    norms = ref.norm(dim=-1)
    floor = 1e-3 * float(norms.max())
    return (float((x - ref).norm() / ref.norm()),
            float((diff / norms.clamp_min(floor)).max()))


def _qkv(b, t, h, h_kv, d, seed=0, dtype=torch.bfloat16):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(s, generator=g, device="cuda").to(dtype)
                 for s in ((b, t, h, d), (b, t, h_kv, d), (b, t, h_kv, d)))


# the kernels' tile edges: K1 and K2 take 128 q rows a block, K1 128 keys a
# tile and K2 64; K3 takes 64 keys a block and 64 q rows a tile
EDGE_SHAPES = [
    (2, 192, 4, 2, 128, True),  # T a multiple of 64, not of 128
    (2, 192, 4, 2, 128, False),
    (2, 40, 4, 1, 64, True),    # T shorter than one tile, MQA
    (2, 320, 4, 2, 64, False),  # non-causal D=64, ragged 128-row tile
]
# head dims other than 64 and 128, run at the padded width 64 (D=32) or 128
# (D=72, 80, 96: Phi-2's and Phi-3-mini's; 112; K2 and K3 run 72-96 at 96),
# with GQA and ragged T; 72 (b, h_kv) pairs, more than half an H100's 132
# SMs, turn the Dp 96 K3's grid (csrc/flash_bwd.cu)
PADDED_SHAPES = [
    (2, 200, 4, 2, 32, True),
    (2, 200, 4, 1, 72, True),
    (3, 200, 24, 24, 80, True),
    (3, 256, 24, 24, 96, False),
    (2, 256, 4, 1, 80, False),
    (1, 192, 8, 2, 96, True),
    (2, 130, 4, 4, 96, False),
    (2, 200, 8, 2, 112, True),
]
# head dims past 128, run at the padded width 256 (K1 and K2 in 128-row
# blocks of two consumers that each own all 256 columns of o or dq for their
# rows, with a T = 150 block whose second consumer has no row; K3 a block a
# 64-key tile whose consumers own all 256 columns of dv or dk, on grids of at
# least the card's SMs (the last two: 4 x 2 x 18 = 144 and 8 x 1 x 17 = 136
# blocks), else in column halves), with MQA and ragged T
WIDE_SHAPES = [
    (2, 200, 8, 1, 136, True),
    (1, 200, 8, 1, 192, False),
    (2, 200, 8, 1, 256, True),
    (2, 150, 8, 1, 256, True),
    (1, 320, 8, 2, 256, False),
    (4, 1100, 8, 2, 256, True),
    (8, 1050, 8, 1, 200, False),
]


@pytest.mark.parametrize("shape", [
    (2, 256, 4, 2, 128, True),
    (2, 256, 4, 4, 128, False),
    (1, 512, 8, 1, 64, True),
    (3, 130, 2, 1, 64, True),   # ragged last tile
    (1, 64, 2, 2, 128, False),  # one tile
] + EDGE_SHAPES + PADDED_SHAPES + WIDE_SHAPES)
def test_kernel_matches_plain(cuda, shape):
    b, t, h, h_kv, d, causal = shape
    q, k, v = _qkv(b, t, h, h_kv, d)
    before = tattn.FLASH_FWD_LAUNCHES
    o, lse = tattn.flash_forward(q, k, v, causal=causal)
    assert tattn.FLASH_FWD_LAUNCHES == before + 1
    o_ref, lse_ref = tattn.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and lse.shape == (b * h, t)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=O_TOL, rtol=O_TOL)
    assert _worst_row_rel(o, o_ref) <= O_ROW_REL
    torch.testing.assert_close(lse, lse_ref, atol=LSE_ATOL, rtol=0)


def test_forward_is_bit_reproducible(cuda):
    q, k, v = _qkv(2, 512, 8, 2, 128, seed=6)
    first = tattn.flash_forward(q, k, v)
    second = tattn.flash_forward(q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
def test_forward_at_width_256_is_bit_reproducible(cuda, dtype):
    # the Dp 256 K1's consumers load each other's tiles by tickets taken in
    # no fixed order; what they compute does not depend on it
    q, k, v = _qkv(2, 640, 8, 1, 256, seed=7, dtype=dtype)
    for causal in (True, False):
        first = tattn.flash_forward(q, k, v, causal=causal)
        second = tattn.flash_forward(q, k, v, causal=causal)
        assert all(torch.equal(a, b) for a, b in zip(first, second)), causal


def test_flash_attention_sends_ragged_t_to_the_kernel(cuda):
    # T=200 tiles by neither block: the JAX rules would take the reference,
    # but on the card the kernel tiles it itself
    q, k, v = _qkv(2, 200, 4, 2, 128, seed=3)
    launches, routes = tattn.FLASH_FWD_LAUNCHES, tattn.FLASH_REFERENCE_ROUTES
    o = tattn.flash_attention(q, k, v, causal=True, block_q=128, block_k=128)
    assert tattn.FLASH_FWD_LAUNCHES == launches + 1
    assert tattn.FLASH_REFERENCE_ROUTES == routes
    o_ref, _ = tattn.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=O_TOL, rtol=O_TOL)
    assert _worst_row_rel(o, o_ref) <= O_ROW_REL


def test_flash_attention_raises_on_cross_length_k(cuda):
    # a k longer than q takes xla_attention, as JAX's flash_attention does on
    # every backend: counted, no launch, the reference's result (the name is
    # kept from when the card raised here)
    q, _, _ = _qkv(1, 128, 2, 2, 64)
    _, k, v = _qkv(1, 256, 2, 2, 64)
    before = (tattn.FLASH_FWD_LAUNCHES, tattn.FLASH_REFERENCE_ROUTES)
    o = tattn.flash_attention(q, k, v, causal=False)
    assert (tattn.FLASH_FWD_LAUNCHES, tattn.FLASH_REFERENCE_ROUTES) == (
        before[0], before[1] + 1)
    assert torch.equal(o, tattn.xla_attention(q, k, v, causal=False))


def test_flash_attention_routes_a_head_dim_off_the_8_grid_to_the_reference(cuda):
    # D=12: JAX's flash_attention returns xla_attention; so does the port
    q, k, v = _qkv(1, 128, 2, 2, 12)
    before = (tattn.FLASH_FWD_LAUNCHES, tattn.FLASH_REFERENCE_ROUTES)
    o = tattn.flash_attention(q, k, v)
    assert (tattn.FLASH_FWD_LAUNCHES, tattn.FLASH_REFERENCE_ROUTES) == (
        before[0], before[1] + 1)
    assert torch.equal(o, tattn.xla_attention(q, k, v))


def test_kernel_builds_for_sm90a(cuda):
    path = _build.build("flash_fwd")
    assert path.startswith(_build.BUILD_DIR)
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)


@pytest.mark.parametrize("bad", ["f32", "noncontig", "grad", "head_dim"])
def test_kernel_raises_instead_of_falling_back(cuda, bad):
    q, k, v = _qkv(1, 128, 2, 2, 64)
    if bad in ("f32", "head_dim"):
        # f32 inputs at D = 64 run the 3xTF32 K1, and D = 1032 past the
        # cluster kernels' 1024 the CUDA-core family (their counter moves,
        # the wgmma one does not); f64 and D = 12, off the multiples of 8,
        # are refused
        if bad == "f32":
            q, k, v = q.float(), k.float(), v.float()
            refused, kind = tuple(x.double() for x in (q, k, v)), TypeError
            counter = "FLASH_FWD_TF32_LAUNCHES"
        else:
            q, k, v = _qkv(1, 128, 2, 2, 1032)
            refused, kind = _qkv(1, 128, 2, 2, 12), ValueError
            counter = "FLASH_FWD_GENERIC_LAUNCHES"
        before = (tattn.FLASH_FWD_LAUNCHES, getattr(tattn, counter))
        o, lse = tattn.flash_forward(q, k, v)
        assert (tattn.FLASH_FWD_LAUNCHES, getattr(tattn, counter)) == (
            before[0], before[1] + 1)
        o_ref, lse_ref = tattn.flash_attention_plain(q, k, v)
        assert o.dtype == q.dtype and _worst_row_rel(o, o_ref) <= O_ROW_REL
        with pytest.raises(kind):
            tattn.flash_forward(*refused)
        assert getattr(tattn, counter) == before[1] + 1
        return
    if bad == "noncontig":
        q = torch.randn(1, 2, 128, 64, device="cuda").to(torch.bfloat16).transpose(1, 2)
        kind = ValueError
    else:
        # a raw kernel call is not differentiable: under grad mode it
        # refuses a tensor that requires grad (flash_attention takes it)
        q = q.clone().requires_grad_(True)
        kind = NotImplementedError
    before = tattn.FLASH_FWD_LAUNCHES
    with pytest.raises(kind):
        tattn.flash_forward(q, k, v)
    assert tattn.FLASH_FWD_LAUNCHES == before


def test_model_flash_matches_xla_on_card(cuda):
    kw = dict(vocab_size=512, d_model=256, n_heads=4, n_kv_heads=2,
              n_layers=2, d_ff=512, max_seq_len=256)
    cfg_f = ttm.TransformerConfig(attn_impl="flash", **kw)
    cfg_x = ttm.TransformerConfig(attn_impl="xla", **kw)
    params = ttm.init_params(cfg_f, torch.Generator(device="cuda").manual_seed(0), cuda)
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, 512, (2, 256)).astype(np.int32)).cuda()
    before = tattn.FLASH_FWD_LAUNCHES
    with torch.inference_mode():
        lf = ttm.forward(params, tokens, cfg_f)
        lx = ttm.forward(params, tokens, cfg_x)
    assert tattn.FLASH_FWD_LAUNCHES == before + cfg_f.n_layers
    assert bool(torch.isfinite(lf).all())
    # bf16 activations on both paths; logits are O(1)
    torch.testing.assert_close(lf, lx, atol=0.1, rtol=0)


def test_eval_step_flash_matches_xla_on_card(cuda):
    kw = dict(vocab_size=512, d_model=256, n_heads=4, n_kv_heads=2,
              n_layers=2, d_ff=512, max_seq_len=256)
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, 512, (2, 256)).astype(np.int32))
    losses = []
    for impl in ("flash", "xla"):
        step, init_fn = ttrain.make_eval_step(
            ttm.TransformerConfig(attn_impl=impl, **kw), cuda, ce_chunk=64)
        params = init_fn(torch.Generator(device="cuda").manual_seed(0))
        losses.append(float(step(params, tokens)))
    assert np.isfinite(losses).all()
    assert abs(losses[0] - losses[1]) < 2e-2


BWD_SHAPES = [
    (2, 256, 4, 2, 128, True),
    (2, 256, 4, 4, 128, False),
    (1, 512, 8, 1, 64, True),
    (3, 130, 2, 1, 64, True),   # ragged last tile
    (1, 64, 2, 2, 128, False),  # one tile
    (1, 320, 16, 4, 128, True),  # GQA group of 4: K3's head walk crosses 3 boundaries
    (2, 256, 16, 4, 64, False),
] + EDGE_SHAPES + PADDED_SHAPES + WIDE_SHAPES


def _bwd_inputs(b, t, h, h_kv, d, causal, seed=0):
    q, k, v = _qkv(b, t, h, h_kv, d, seed=seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    do = torch.randn(q.shape, generator=g, device="cuda").to(torch.bfloat16)
    o, lse = tattn.flash_forward(q, k, v, causal=causal)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_backward_kernels_match_plain(cuda, shape):
    *dims, causal = shape
    q, k, v, o, lse, do = _bwd_inputs(*dims, causal)
    before = (tattn.FLASH_BWD_DQ_LAUNCHES, tattn.FLASH_BWD_DKV_LAUNCHES)
    got = tattn.flash_backward(q, k, v, o, lse, do, causal=causal)
    assert (tattn.FLASH_BWD_DQ_LAUNCHES, tattn.FLASH_BWD_DKV_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    want = tattn.flash_backward_plain(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    for x, ref, like, name in zip(got, want, (q, k, v), ("dq", "dk", "dv")):
        assert x.dtype == torch.bfloat16 and x.shape == like.shape, name
        assert bool(torch.isfinite(x).all()), name
        fro, row = _grad_errs(x, ref)
        assert fro <= GRAD_REL and row <= GRAD_ROW_REL, (name, fro, row)


def test_backward_is_bit_reproducible(cuda):
    q, k, v, o, lse, do = _bwd_inputs(2, 512, 8, 2, 128, True, seed=4)
    first = tattn.flash_backward(q, k, v, o, lse, do)
    second = tattn.flash_backward(q, k, v, o, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
def test_backward_at_width_256_is_bit_reproducible(cuda, dtype):
    # the Dp 256 K2's and K3's consumers load each other's tiles by tickets
    # taken in no fixed order; what they compute does not depend on it (4 x
    # 2 x 18 = 144 key-tile blocks: K3's Dp 256 kernel on an H100's 132 SMs)
    q, k, v = _qkv(4, 1100, 8, 2, 256, seed=8, dtype=dtype)
    do = torch.randn(q.shape, generator=torch.Generator(device="cuda").manual_seed(9),
                     device="cuda").to(dtype)
    for causal in (True, False):
        o, lse = tattn.flash_forward(q, k, v, causal=causal)
        for gd in (None, torch.float32):
            first = tattn.flash_backward(q, k, v, o, lse, do, causal=causal, grad_dtype=gd)
            second = tattn.flash_backward(q, k, v, o, lse, do, causal=causal, grad_dtype=gd)
            assert all(torch.equal(a, b) for a, b in zip(first, second)), (causal, gd)


SENTINEL = -7777.0


@pytest.mark.parametrize("d", [32, 72, 96, 136, 256])
@pytest.mark.parametrize("f32", [False, True])
def test_kernels_store_no_column_past_d(cuda, d, f32):
    # every output is a view of its first d columns into a buffer as wide as
    # the padded width (64 columns past it at D 256) whose other columns hold
    # a sentinel: a store past d would overwrite the next head's columns; the
    # views must equal the wrappers' outputs
    b, t, h, h_kv = 2, 200, 4, 2
    width = 128 if d <= 128 else 256 if d < 256 else d + 64
    q, k, v, o16, lse, do = _bwd_inputs(b, t, h, h_kv, d, True, seed=9)
    out_dtype = torch.float32 if f32 else torch.bfloat16
    suffix = "_f32" if f32 else ""

    def wide(like):
        buf = torch.full((*like.shape[:3], width), SENTINEL, dtype=out_dtype, device="cuda")
        return buf, buf[..., :d]

    stream = torch.cuda.current_stream().cuda_stream
    dims = (b, t, h, h_kv, d, 1)
    (o_buf, o), lse2 = wide(q), torch.empty_like(lse)
    tattn._launch("hived_flash_fwd" + suffix, (q, k, v, o, lse2), dims, (q, k, v, o), stream)
    (dq_buf, dq), delta = wide(q), torch.empty_like(lse)
    tattn._launch("hived_flash_bwd_dq" + suffix, (q, k, v, o16, do, lse, delta, dq), dims,
                  (q, k, v, o16, do, dq), stream)
    (dk_buf, dk), (dv_buf, dv) = wide(k), wide(v)
    tattn._launch("hived_flash_bwd_dkv" + suffix, (q, k, v, do, lse, delta, dk, dv), dims,
                  (q, k, v, do, dk, dv), stream)
    torch.cuda.synchronize()
    for buf in (o_buf, dq_buf, dk_buf, dv_buf):
        assert bool((buf[..., d:] == SENTINEL).all())
    kw = dict(out_dtype=torch.float32) if f32 else {}
    gw = dict(grad_dtype=torch.float32) if f32 else {}
    assert torch.equal(o, tattn.flash_forward(q, k, v, **kw)[0])
    for x, y in zip((dq, dk, dv), tattn.flash_backward(q, k, v, o16, lse, do, **gw)):
        assert torch.equal(x, y)


def test_ragged_t_through_autograd(cuda):
    # T=200 with D=64 and MQA: autograd through flash_attention reaches K1,
    # K2 and K3, with a gradient in the layout autograd makes
    q, k, v = (x.requires_grad_(True) for x in _qkv(2, 200, 4, 1, 64, seed=5))
    w = torch.randn((2, 4, 200, 64), device="cuda").transpose(1, 2)
    launches = (tattn.FLASH_FWD_LAUNCHES, tattn.FLASH_BWD_DQ_LAUNCHES,
                tattn.FLASH_BWD_DKV_LAUNCHES)
    o = tattn.flash_attention(q, k, v, causal=True)
    got = torch.autograd.grad((o.float() * w).sum(), (q, k, v))
    assert (tattn.FLASH_FWD_LAUNCHES, tattn.FLASH_BWD_DQ_LAUNCHES,
            tattn.FLASH_BWD_DKV_LAUNCHES) == tuple(n + 1 for n in launches)
    with torch.no_grad():
        o2, lse = tattn.flash_forward(q, k, v)
        want = tattn.flash_backward_plain(q, k, v, o2, lse, w.to(torch.bfloat16))
    for x, ref, name in zip(got, want, ("dq", "dk", "dv")):
        fro, row = _grad_errs(x, ref)
        assert fro <= GRAD_REL and row <= GRAD_ROW_REL, (name, fro, row)


def test_backward_kernels_build_for_sm90a(cuda):
    paths = _build.build_all(["flash_fwd", "flash_bwd"])
    assert all(p.startswith(_build.BUILD_DIR) for p in paths)
    # and every library of the kernels, one compiler each, all at once
    paths = _build.build_all(_build.LIBRARIES)
    assert all(p.startswith(_build.BUILD_DIR) for p in paths)


def _sass_by_kernel(library: str) -> dict:
    """{mangled kernel name: its SASS} of a built library, by cuobjdump (it
    sits beside nvcc)."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                         check=True, timeout=120).stdout
    kernels, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
        elif name:
            kernels[name].append(line)
    return {k: "\n".join(v) for k, v in kernels.items()}


@pytest.mark.parametrize("library, kernel", [
    ("flash_fwd", "flash_fwd_kernel"),
    ("flash_bwd", "flash_bwd_dq_kernel"),
    ("flash_bwd", "flash_bwd_dkv_kernel"),
    ("flash_fwd_f16", "flash_fwd_kernel"),
    ("flash_bwd_f16", "flash_bwd_dq_kernel"),
    ("flash_bwd_f16", "flash_bwd_dkv_kernel"),
])
def test_kernels_run_on_wgmma_and_tma(cuda, library, kernel):
    # every instance (D 64/128/256 x causal/full x 16-bit/f32 outputs, of
    # the bf16 or the fp16 library, and K2's and K3's Dp 96; the names take
    # in the Dp 256 kernels, and K3 keeps its column-split Dp 256 instances
    # for small grids: 20) multiplies with wgmma (HGMMA) on tiles loaded by
    # TMA (UTMALDG), never with mma.sync (HMMA) or cp.async (LDGSTS)
    sass = _sass_by_kernel(_build.build(library))
    found = {k: v for k, v in sass.items() if kernel in k}
    assert len(found) == (20 if "dkv" in kernel else 16 if "bwd" in kernel else 12), sorted(sass)
    for name, text in found.items():
        assert "HGMMA" in text and "UTMALDG" in text, name
        assert "HMMA" not in text and "LDGSTS" not in text, name


@pytest.mark.parametrize("library", ["flash_bwd", "flash_bwd_f16"])
@pytest.mark.parametrize("kernel", ["flash_bwd_dq_kernel_d256", "flash_bwd_dkv_kernel_d256"])
def test_width_256_backward_holds_its_accumulators_in_registers(cuda, library, kernel):
    # the Dp 256 K2 and K3 (causal or not x 16-bit or f32 outputs) keep
    # dq's, or dv's and dk's, 128 f32 accumulators a thread in registers:
    # wgmma on TMA-fed tiles, and no local-memory load or store (a spill)
    sass = _sass_by_kernel(_build.build(library))
    found = {k: v for k, v in sass.items() if kernel in k}
    assert len(found) == 4, sorted(sass)
    for name, text in found.items():
        assert "HGMMA" in text and "UTMALDG" in text, name
        assert not re.search(r"\b(LDL|STL)\b", text), name


@pytest.mark.parametrize("library", ["flash_bwd", "flash_bwd_f16"])
@pytest.mark.parametrize("kernel", ["flash_bwd_dq_kernelILi96E", "flash_bwd_dkv_kernelILi96E"])
def test_width_96_backward_runs_on_64_byte_panels_without_spill(cuda, library, kernel):
    # the Dp 96 K2 and K3 (causal or not x 16-bit or f32 outputs): wgmma on
    # TMA-fed tiles, no local-memory load or store (a spill), and ptxas did
    # not serialize their wgmma (its C7512 note)
    sass = _sass_by_kernel(_build.build(library))
    found = {k: v for k, v in sass.items() if kernel in k}
    assert len(found) == 4, sorted(sass)
    for name, text in found.items():
        assert "HGMMA" in text and "UTMALDG" in text, name
        assert not re.search(r"\b(LDL|STL)\b", text), name
    report = {n: r for n, r in _build.ptxas_report(_build.build_log(library)).items()
              if kernel in n}
    assert len(report) == 4 and not any(r[3] for r in report.values()), report


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("d", [72, 80, 96, 112])
def test_backward_at_72_to_96_launches_its_own_kernels(cuda, dtype, d):
    # by torch.profiler's kernel names: K2 and K3 at 64 < D <= 96 launch the
    # Dp 96 instances, at 112 the Dp 128 ones, in both output forms; each
    # form held to the plain version, the f32 one rounded equal to the other
    from torch.profiler import ProfilerActivity, profile

    q, k, v, do = _dtype_inputs(dtype, 2, 200, 8, 2, d, True, seed=13)
    o, lse = tattn.flash_forward(q, k, v)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        grads = tattn.flash_backward(q, k, v, o, lse, do)
        grads32 = tattn.flash_backward(q, k, v, o, lse, do, grad_dtype=torch.float32)
        torch.cuda.synchronize()
    found = sorted({(m.group(1), int(m.group(2))) for e in prof.key_averages()
                    for m in [re.search(r"flash_bwd_(dq|dkv)_kernel(?:<|ILi)(\d+)", e.key)] if m})
    width = 96 if d <= 96 else 128
    assert found == [("dkv", width), ("dq", width)]
    assert tattn.padded_head_dim(d, "dq") == tattn.padded_head_dim(d, "dkv") == width
    want = tattn.flash_backward_plain(q, k, v, o, lse, do, grad_dtype=torch.float32)
    for gr in (grads, grads32):
        for x, r, name in zip(gr, want, ("dq", "dk", "dv")):
            fro, row = _grad_errs(x, r)
            assert fro <= GRAD_REL and row <= GRAD_ROW_REL, (name, fro, row)
    assert all(torch.equal(x.to(dtype), y) for x, y in zip(grads32, grads))


@pytest.mark.parametrize("library", ["flash_fwd", "flash_fwd_f16"])
def test_width_256_forward_holds_o_in_registers(cuda, library):
    # the Dp 256 K1 (causal or not x 16-bit or f32 o) keeps o's 128 f32
    # accumulators a thread in registers: wgmma on TMA-fed tiles, and no
    # local-memory load or store (a spill)
    sass = _sass_by_kernel(_build.build(library))
    found = {k: v for k, v in sass.items() if "flash_fwd_kernel_d256" in k}
    assert len(found) == 4, sorted(sass)
    for name, text in found.items():
        assert "HGMMA" in text and "UTMALDG" in text, name
        assert not re.search(r"\b(LDL|STL)\b", text), name


def test_flagship_train_step_flash_matches_xla(cuda):
    # one layer at the flagship width, T=2048: the loss and every gradient
    # leaf of one step, flash against xla on the same weights and batch
    kw = dict(vocab_size=32768, d_model=2048, n_heads=16, n_kv_heads=8,
              n_layers=1, d_ff=8192, max_seq_len=2048, remat="dots")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 32768, (2, 2048)).astype(np.int32)).cuda()
    results = {}
    for impl in ("flash", "xla"):
        cfg = ttm.TransformerConfig(attn_impl=impl, **kw)
        params = ttm.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), cuda)
        leaves = ttrain._leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        launches = tattn.FLASH_BWD_DKV_LAUNCHES
        loss = ttrain.loss_fn(params, tokens, cfg, ce_chunk=512)
        grads = torch.autograd.grad(loss, leaves)
        assert tattn.FLASH_BWD_DKV_LAUNCHES - launches == (impl == "flash")
        results[impl] = (float(loss.detach()), [g.float() for g in grads])
    (lf, gf), (lx, gx) = results["flash"], results["xla"]
    assert np.isfinite(lf) and abs(lf - lx) < 2e-2
    for a, b in zip(gf, gx):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).norm() / b.norm()) < 5e-2


def test_checkpoint_round_trip_on_card_is_bit_identical(cuda, tmp_path):
    # a small train state after one step on the card: every parameter and
    # AdamW moment comes back bit-identical, on the card, in f32, into the
    # tensors the optimizer already holds
    from hivedscheduler_tpu_torch.parallel import checkpoint as tck

    cfg = ttm.TransformerConfig(vocab_size=256, d_model=256, n_heads=2, n_kv_heads=1,
                                n_layers=2, d_ff=512, max_seq_len=256, attn_impl="flash")
    step, init_fn = ttrain.make_train_step(cfg, cuda)
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 256)).astype(np.int32)).cuda()
    params, opt, _ = step(params, opt, tokens)
    tck.save(str(tmp_path), 1, params, opt)
    params2, opt2 = init_fn(torch.Generator(device="cuda").manual_seed(9))
    held = [p for g in opt2.param_groups for p in g["params"]]
    assert tck.restore(str(tmp_path), params2, opt2)[0] == 1
    assert [p for g in opt2.param_groups for p in g["params"]] == held
    for a, b in zip(ttrain._leaves(params), ttrain._leaves(params2)):
        assert b.device.type == "cuda" and torch.equal(a, b)
    for a, b in zip(ttrain._leaves(params), ttrain._leaves(params2)):
        sa, sb = opt.state[a], opt2.state[b]
        for key in ("exp_avg", "exp_avg_sq"):
            assert sb[key].device.type == "cuda" and sb[key].dtype == torch.float32
            assert torch.equal(sa[key], sb[key])
        assert torch.equal(sa["step"].cpu(), sb["step"].cpu())


def test_cli_resume_on_card(cuda, tmp_path):
    # 4 steps against 2 + 2 through the train CLI on the card at a small
    # size; the losses of the resumed steps against the uninterrupted ones
    import json

    from hivedscheduler_tpu_torch import train as ttrain_cli

    model = ["--vocab-size", "512", "--d-model", "256", "--n-layers", "2",
             "--n-heads", "2", "--n-kv-heads", "1", "--d-ff", "512",
             "--seq-len", "256", "--batch", "2", "--attn", "flash",
             "--remat", "dots", "--ce-chunk", "128", "--device", "cuda"]

    def run(name, *extra):
        tl = tmp_path / f"{name}.jsonl"
        assert ttrain_cli.main(model + ["--timeline", str(tl)] + list(extra)) == 0
        return {r["step"]: r["loss"] for r in map(json.loads, tl.read_text().splitlines())}

    ref = run("a", "--steps", "4")
    ck = str(tmp_path / "ck")
    first = run("b1", "--steps", "2", "--checkpoint-dir", ck)
    second = run("b2", "--steps", "4", "--checkpoint-dir", ck)
    assert sorted(first) == [1, 2] and sorted(second) == [3, 4]
    got = {**first, **second}
    for s in range(1, 5):
        assert np.isfinite(got[s]) and abs(got[s] - ref[s]) <= 1e-3 * abs(ref[s]), (s, got, ref)


# -- decode and generate on the card -------------------------------------------

DECODE_MODEL = dict(vocab_size=256, d_model=128, n_heads=4, n_kv_heads=2,
                    n_layers=2, d_ff=256, max_seq_len=64)


def _decode_setup(dtype=torch.float32):
    cfg = ttm.TransformerConfig(dtype=dtype, **DECODE_MODEL)
    params = ttm.init_params(cfg, torch.Generator().manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (3, 10)))
    return cfg, params, prompt


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


def test_decode_on_card_matches_the_cpu(cuda):
    # f32 on both (no TF32): the prefill and every step's logits within
    # atol 1e-4 of the CPU's, and greedy tokens equal, plain and int8
    from hivedscheduler_tpu_torch.models import decode as tdec
    from hivedscheduler_tpu_torch.models import quant as tquant

    cfg, params, prompt = _decode_setup()
    for tree in (params, tquant.quantize_params(params, cfg)):
        logits = {}
        for dev in ("cpu", "cuda"):
            p, x = _to(tree, dev), prompt.to(dev)
            cache = tdec.init_kv_cache(cfg, 3, 20, dev)
            out, cache = tdec.advance(p, cache, x, cfg)
            steps = [out]
            for i in range(4):
                out, cache = tdec.advance(p, cache, x[:, i:i + 1], cfg)
                steps.append(out)
            logits[dev] = torch.cat(steps, dim=1).cpu()
            assert cache.k.device.type == dev
        torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=1e-4, rtol=0)
        toks = {dev: tdec.generate(_to(tree, dev), prompt.to(dev), cfg, 8).cpu()
                for dev in ("cpu", "cuda")}
        assert torch.equal(toks["cuda"], toks["cpu"])


def test_speculative_on_card_equals_greedy_generate(cuda):
    from hivedscheduler_tpu_torch.models import decode as tdec
    from hivedscheduler_tpu_torch.models import speculative as tspec

    cfg, params, prompt = _decode_setup()
    d_cfg = tspec.derive_draft_config(cfg, 1)
    draft = ttm.init_params(d_cfg, torch.Generator(device="cuda").manual_seed(3), cuda)
    p, x = _to(params, "cuda"), prompt.cuda()
    want = tdec.generate(p, x, cfg, 12)
    for gamma in (1, 4):
        got, stats = tspec.generate_speculative(p, draft, x, cfg, d_cfg, 12, gamma=gamma)
        assert torch.equal(got, want) and stats.rounds >= 1
    got, stats = tspec.generate_speculative(
        p, p, x, cfg, cfg, 12, gamma=4, temperature=0.8,
        generator=torch.Generator(device="cuda").manual_seed(0))
    assert stats.accepted == stats.drafted and got.shape == (3, 12)


def test_generate_cli_on_card(cuda, capsys):
    from hivedscheduler_tpu_torch import generate as tgen_cli

    model = [a for k, v in DECODE_MODEL.items() if k != "max_seq_len"
             for a in (f"--{k.replace('_', '-')}", str(v))]
    for extra in ([], ["--quantize", "int8"], ["--draft-layers", "1"],
                  ["--temperature", "0.7", "--top-p", "0.9"]):
        capsys.readouterr()
        assert tgen_cli.main(model + ["--batch", "2", "--new-tokens", "5"] + extra) == 0
        rows = [line.split() for line in capsys.readouterr().out.splitlines()]
        assert len(rows) == 2 and all(len(r) == 5 for r in rows), extra


SERVE_MODEL = dict(vocab_size=256, d_model=128, n_heads=4, n_kv_heads=2, n_layers=2,
                   d_ff=256, max_seq_len=64)


def _serve_setup(device):
    cfg = ttm.TransformerConfig(**SERVE_MODEL)  # bf16, as served
    params = ttm.cast_params(ttm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device), cfg.dtype)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(0, 256, int(rng.integers(2, 20)))]
               for _ in range(6)]
    return cfg, params, prompts


def _serve_streams(params, cfg, prompts, **kw):
    from hivedscheduler_tpu_torch.chaos import invariants as tinv
    from hivedscheduler_tpu_torch.models import serving as tsrv

    eng = tsrv.ServingEngine(params, cfg, max_batch=3, max_len=48, **kw)
    pending, reqs, step = list(prompts), [], 0
    while pending or any(not r.done for r in reqs):
        if pending and step % 2 == 0:
            reqs.append(eng.submit(pending.pop(0), 9))
        eng.step()
        tinv.check_block_pool(eng, f"step {step}")
        step += 1
    return [r.tokens_out for r in reqs], eng


@pytest.mark.parametrize("sampled", [False, True])
def test_serving_graph_and_paged_equal_eager_dense_on_card(cuda, sampled):
    # the same ops on the same shapes: dense and paged, eager and the
    # CUDA-graph window, greedy or counter-sampled, token for token
    cfg, params, prompts = _serve_setup("cuda")
    kw = dict(temperature=0.8, top_k=40, seed=5) if sampled else {}
    ref, _ = _serve_streams(params, cfg, prompts, **kw)
    for extra in (dict(decode_steps=4), dict(page_size=8), dict(page_size=8, decode_steps=3),
                  dict(page_size=8, decode_steps=4, prefix_cache_size=4)):
        got, eng = _serve_streams(params, cfg, prompts, **kw, **extra)
        assert got == ref, extra
        if eng.decode_steps > 1:
            assert eng.graph_windows == eng.fused_windows > 0, extra


def test_serving_int8_kv_paged_equals_dense_on_card(cuda):
    cfg, params, prompts = _serve_setup("cuda")
    dense, _ = _serve_streams(params, cfg, prompts, kv_dtype="int8", decode_steps=4)
    paged, _ = _serve_streams(params, cfg, prompts, kv_dtype="int8", decode_steps=4,
                              page_size=8)
    assert dense == paged


def test_serving_graph_refuses_a_rebound_cache(cuda):
    from hivedscheduler_tpu_torch.models import serving as tsrv

    cfg, params, prompts = _serve_setup("cuda")
    eng = tsrv.ServingEngine(params, cfg, max_batch=2, max_len=48, decode_steps=4)
    eng.submit(prompts[0], 20)
    eng.step()
    assert eng.graph_windows == 1
    eng.cache = tsrv.init_ragged_cache(cfg, 2, 48, device="cuda")
    with pytest.raises(RuntimeError) as err:
        eng.step()
    assert "rebound" in str(err.value)


def test_graph_windows_count_once_a_window_on_card(cuda):
    # the counter sits in the host code around the replays, never in the
    # captured iteration: one count a window, graph replays included
    from hivedscheduler_tpu_torch.runtime.metrics import REGISTRY

    name = ("tpu_hive_serve_fused_decode_windows_total", ())
    cfg, params, prompts = _serve_setup("cuda")
    before = REGISTRY._counters.get(name, 0)
    _, eng = _serve_streams(params, cfg, prompts, page_size=8, decode_steps=4)
    assert eng.graph_windows == eng.fused_windows > 1
    assert REGISTRY._counters[name] - before == eng.fused_windows


def test_import_prefix_keeps_the_graph_on_card(cuda, monkeypatch):
    # the fleet's KV handoff writes a graph-warmed engine's pool in place:
    # the pool's data pointers stay, the next window replays the captured
    # graph (no new capture), and the imported prefix serves the stream the
    # exporter serves from its own cached prefix
    from hivedscheduler_tpu_torch.chaos import invariants as tinv
    from hivedscheduler_tpu_torch.common import compileguard
    from hivedscheduler_tpu_torch.models import serving as tsrv

    monkeypatch.setenv("HIVED_COMPILE_GUARD", "1")
    compileguard.reset()
    cfg, params, prompts = _serve_setup("cuda")
    kw = dict(max_batch=3, max_len=48, page_size=8, decode_steps=4, prefix_cache_size=4)
    src = tsrv.ServingEngine(params, cfg, **kw)
    dst = tsrv.ServingEngine(params, cfg, **kw)
    prompt = list(range(1, 20))
    src.submit(prompt, 9)
    src.run_until_drained()
    local = src.submit(prompt, 9)  # a hit on src's own 16-token prefix
    src.run_until_drained()
    dst.submit(prompts[0], 9)
    dst.run_until_drained()  # captures dst's decode graph
    assert dst.graph_windows >= 1 and compileguard.counts() == {"serve.decode_window": 2}
    pointers = [t.data_ptr() for t in tsrv._kv_tensors(dst.pool)]
    windows = dst.graph_windows
    with compileguard.budget(0):
        assert dst.import_prefix(*src.export_prefix(prompt)) is True
        assert [t.data_ptr() for t in tsrv._kv_tensors(dst.pool)] == pointers
        req = dst.submit(prompt, 9)
        dst.run_until_drained()
    assert dst.prefix_hits == 1 and dst.graph_windows > windows
    assert src.prefix_hits == 1 and req.tokens_out == local.tokens_out
    tinv.check_block_pool(dst)
    compileguard.reset()


def test_world_1_nccl_mesh_engine_replays_its_graph_and_serves_the_same_streams(
        cuda, monkeypatch):
    # ServingEngine(mesh=) on a one-GPU NCCL serving mesh issues no
    # collective: its decode windows capture once, replay with no new
    # capture once warm, and serve the mesh-less engine's streams, dense
    # and paged
    from hivedscheduler_tpu_torch.common import compileguard
    from hivedscheduler_tpu_torch.parallel import distributed, topology

    monkeypatch.setenv("HIVED_COMPILE_GUARD", "1")
    cfg, params, prompts = _serve_setup("cuda")
    try:
        assert distributed.initialize_from_gang(device="cuda") == (0, 1)
        mesh = topology.serving_mesh(1, 1, "cuda")
        for extra in (dict(decode_steps=4), dict(page_size=8, decode_steps=4)):
            compileguard.reset()
            ref, _ = _serve_streams(params, cfg, prompts, **extra)
            got, eng = _serve_streams(params, cfg, prompts, mesh=mesh, **extra)
            assert got == ref, extra
            assert eng.graph_windows == eng.fused_windows > 0, extra
            assert compileguard.counts() == {"serve.decode_window": 2}, extra
            windows = eng.graph_windows
            with compileguard.budget(0):
                req = eng.submit(prompts[1], 9)
                eng.run_until_drained()
            assert eng.graph_windows > windows and req.tokens_out == ref[1], extra
    finally:
        distributed.shutdown()
        compileguard.reset()


def test_serve_cli_on_card(cuda, capsys):
    from hivedscheduler_tpu_torch import serve as tserve

    model = [a for k, v in SERVE_MODEL.items() if k != "max_seq_len"
             for a in (f"--{k.replace('_', '-')}", str(v))]
    outs = []
    for extra in ([], ["--page-size", "8", "--decode-steps", "4", "--prefix-cache", "4"]):
        capsys.readouterr()
        assert tserve.main(model + ["--requests", "4", "--max-new-tokens", "6"] + extra) == 0
        outs.append(capsys.readouterr().out.splitlines())
        assert len(outs[-1]) == 4
    assert outs[0] != outs[1]  # the prefix-cache run serves system-prompt requests


# -- the mesh path on one card ------------------------------------------------

# a tp=2 shard of the flagship: half its heads
TP_LOCAL = (8, 2048, 8, 4, 128)


def test_kernels_at_the_tp_local_shape_match_plain(cuda):
    b, t, h, h_kv, d = TP_LOCAL
    q, k, v, o, lse, do = _bwd_inputs(b, t, h, h_kv, d, True)
    o_ref, lse_ref = tattn.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(o.float(), o_ref.float(), atol=O_TOL, rtol=O_TOL)
    assert _worst_row_rel(o, o_ref) <= O_ROW_REL
    torch.testing.assert_close(lse, lse_ref, atol=LSE_ATOL, rtol=0)
    got = tattn.flash_backward(q, k, v, o, lse, do, causal=True)
    want = tattn.flash_backward_plain(q, k, v, o, lse, do, causal=True)
    for x, ref, name in zip(got, want, ("dq", "dk", "dv")):
        fro, row = _grad_errs(x, ref)
        assert fro <= GRAD_REL and row <= GRAD_ROW_REL, (name, fro, row)


def test_world_1_nccl_mesh_step_equals_the_single_device_step(cuda):
    from hivedscheduler_tpu_torch.parallel import data as tdata
    from hivedscheduler_tpu_torch.parallel import distributed, topology

    cfg = ttm.TransformerConfig(vocab_size=512, d_model=256, n_heads=2, n_kv_heads=1,
                                n_layers=2, d_ff=512, max_seq_len=256,
                                attn_impl="flash", remat="dots")
    tokens = np.random.default_rng(3).integers(0, 512, (2, 256)).astype(np.int32)
    step, init_fn = ttrain.make_train_step(cfg, cuda, ce_chunk=128)
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
    want = [float(step(params, opt, torch.from_numpy(tokens).cuda())[2]) for _ in range(2)]
    try:
        assert distributed.initialize_from_gang(device="cuda") == (0, 1)
        assert torch.distributed.get_backend() == "nccl"
        mesh = topology.make_mesh(topology.MeshAxes(), "cuda")
        mstep, minit, tok_sh = ttrain.make_sharded_train_step(cfg, mesh, ce_chunk=128)
        mparams, mopt = minit(torch.Generator(device="cuda").manual_seed(0))
        before = tattn.FLASH_BWD_DKV_LAUNCHES
        got = [float(mstep(mparams, mopt, tdata.device_put_global(tokens, tok_sh, 2))[2])
               for _ in range(2)]
        assert tattn.FLASH_BWD_DKV_LAUNCHES - before == 2 * cfg.n_layers
    finally:
        distributed.shutdown()
    assert all(np.isfinite(got))
    assert max(abs(a - b) / abs(b) for a, b in zip(got, want)) <= 1e-3, (got, want)


# -- the sequence-parallel path: the kernels' f32 forms and the ring ----------

# one hop of a ring: its diagonal (causal) and an unmasked hop, GQA
RING_HOP_SHAPES = [(1, 256, 4, 2, 128, True), (1, 256, 4, 2, 128, False),
                   (2, 192, 4, 1, 64, True), (1, 256, 4, 2, 96, True),
                   (1, 256, 8, 1, 256, True), (1, 200, 8, 1, 192, False),
                   (1, 2048, 8, 1, 256, True)]  # one sp = 4 hop of Gemma-2B's heads
# the share of an f32 form's outputs that a bf16 holds exactly (its exact
# zeros and o's first causal row, at these shapes under 1%)
F32_EXACT_BF16_MAX = 0.1


def _exact_bf16_share(x):
    return float((x == x.to(torch.bfloat16).float()).float().mean())


@pytest.mark.parametrize("shape", RING_HOP_SHAPES)
def test_f32_forms_match_plain_and_round_to_the_bf16_kernels(cuda, shape):
    b, t, h, h_kv, d, causal = shape
    f32 = torch.float32
    q, k, v, o16, lse, do = _bwd_inputs(b, t, h, h_kv, d, causal)
    before = (tattn.FLASH_FWD_F32_LAUNCHES, tattn.FLASH_BWD_DQ_F32_LAUNCHES,
              tattn.FLASH_BWD_DKV_F32_LAUNCHES, tattn.FLASH_FWD_LAUNCHES)
    o, lse32 = tattn.flash_forward(q, k, v, causal=causal, out_dtype=f32)
    o_ref, _ = tattn.flash_attention_plain(q, k, v, causal=causal, out_dtype=f32)
    assert o.dtype == f32
    assert _worst_row_rel(o, o_ref) <= O_ROW_REL
    # only the epilogue's store differs: rounded once, the bf16 kernel's o
    assert torch.equal(o.to(torch.bfloat16), o16) and torch.equal(lse32, lse)
    got = tattn.flash_backward(q, k, v, o16, lse, do, causal=causal, grad_dtype=f32)
    got16 = tattn.flash_backward(q, k, v, o16, lse, do, causal=causal)
    want = tattn.flash_backward_plain(q, k, v, o16, lse, do, causal=causal, grad_dtype=f32)
    # f32 precision kept: few outputs are values a bf16 holds exactly (a
    # bf16 store widened to f32 would give all of them)
    assert _exact_bf16_share(o) <= F32_EXACT_BF16_MAX
    assert _exact_bf16_share(o16.float()) > F32_EXACT_BF16_MAX
    for x, x16, ref, name in zip(got, got16, want, ("dq", "dk", "dv")):
        assert x.dtype == f32, name
        fro, row = _grad_errs(x, ref)
        assert fro <= GRAD_REL and row <= GRAD_ROW_REL, (name, fro, row)
        assert torch.equal(x.to(torch.bfloat16), x16), name
        assert _exact_bf16_share(x) <= F32_EXACT_BF16_MAX, name
    after = (tattn.FLASH_FWD_F32_LAUNCHES, tattn.FLASH_BWD_DQ_F32_LAUNCHES,
             tattn.FLASH_BWD_DKV_F32_LAUNCHES, tattn.FLASH_FWD_LAUNCHES)
    assert [a - b_ for a, b_ in zip(after, before)] == [1, 1, 1, 0]


def test_f32_forms_refuse_other_dtypes(cuda):
    for dtype in (torch.bfloat16, torch.float16):
        q, k, v = _qkv(1, 128, 2, 2, 64, dtype=dtype)
        # the inputs' form is the default (None), not a dtype to ask for,
        # and no other dtype is a form
        for out_dtype in (torch.float16, torch.bfloat16):
            with pytest.raises(TypeError):
                tattn.flash_forward(q, k, v, out_dtype=out_dtype)
        # None: the inputs' dtype, fp16 for fp16 inputs
        assert tattn.flash_forward(q, k, v)[0].dtype == dtype
        assert tattn.flash_forward(q, k, v, out_dtype=torch.float32)[0].dtype == torch.float32


@pytest.mark.parametrize("impl", ["ring_flash", "ring_zigzag_flash"])
def test_ring_at_sp1_runs_the_f32_kernels_on_the_nccl_mesh(cuda, impl):
    from hivedscheduler_tpu_torch.parallel import data as tdata
    from hivedscheduler_tpu_torch.parallel import distributed, topology

    kw = dict(vocab_size=512, d_model=256, n_heads=2, n_kv_heads=1, n_layers=2,
              d_ff=512, max_seq_len=256, remat="dots")
    tokens = np.random.default_rng(4).integers(0, 512, (2, 256)).astype(np.int32)
    losses = {}
    try:
        assert distributed.initialize_from_gang(device="cuda") == (0, 1)
        mesh = topology.make_mesh(topology.MeshAxes(), "cuda")
        for attn in ("flash", impl):
            cfg = ttm.TransformerConfig(attn_impl=attn, **kw)
            step, init, tok_sh = ttrain.make_sharded_train_step(cfg, mesh, ce_chunk=128)
            params, opt = init(torch.Generator(device="cuda").manual_seed(0))
            before = tattn.FLASH_FWD_F32_LAUNCHES
            losses[attn] = [float(step(params, opt, tdata.device_put_global(
                tokens, tok_sh, 2))[2]) for _ in range(2)]
            blocks = 3 if impl == "ring_zigzag_flash" else 1
            want = 0 if attn == "flash" else 2 * 2 * cfg.n_layers * blocks
            assert tattn.FLASH_FWD_F32_LAUNCHES - before == want, attn
    finally:
        distributed.shutdown()
    # one diagonal hop merges into an empty accumulator exactly
    if impl == "ring_flash":
        assert losses[impl] == losses["flash"]
    else:
        assert max(abs(a - b) for a, b in zip(losses[impl], losses["flash"])) <= 1e-3


# -- the mixture-of-experts model ---------------------------------------------

MOE = dict(n_experts=4, moe_top_k=2)


def test_moe_decode_on_card_matches_the_cpu(cuda):
    # f32 on both (no TF32): MoE logits within atol 1e-4 of the CPU's and
    # greedy tokens equal, plain and int8 experts
    from hivedscheduler_tpu_torch.models import decode as tdec
    from hivedscheduler_tpu_torch.models import quant as tquant

    cfg = ttm.TransformerConfig(dtype=torch.float32, **DECODE_MODEL, **MOE)
    params = ttm.init_params(cfg, torch.Generator().manual_seed(0))
    prompt = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (3, 10)))
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for tree in (params, tquant.quantize_params(params, cfg)):
            logits = {}
            for dev in ("cpu", "cuda"):
                cache = tdec.init_kv_cache(cfg, 3, 20, dev)
                out, cache = tdec.advance(_to(tree, dev), cache, prompt.to(dev), cfg)
                logits[dev] = out.cpu()
            torch.testing.assert_close(logits["cuda"], logits["cpu"], atol=1e-4, rtol=0)
            toks = {dev: tdec.generate(_to(tree, dev), prompt.to(dev), cfg, 8).cpu()
                    for dev in ("cpu", "cuda")}
            assert torch.equal(toks["cuda"], toks["cpu"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow


def test_moe_serving_graph_and_paged_equal_eager_dense_on_card(cuda):
    # the MoE layer inside the CUDA-graph decode window: static shapes, no
    # host read; dense and paged, eager and graph, token for token
    cfg = ttm.TransformerConfig(**SERVE_MODEL, **MOE)
    params = ttm.cast_params(ttm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), cfg.dtype)
    _, _, prompts = _serve_setup("cuda")
    ref, _ = _serve_streams(params, cfg, prompts)
    for extra in (dict(decode_steps=4), dict(page_size=8, decode_steps=3)):
        got, eng = _serve_streams(params, cfg, prompts, **extra)
        assert got == ref, extra
        assert eng.graph_windows == eng.fused_windows > 0, extra


def test_moe_world_1_mesh_step_equals_the_single_device_step(cuda):
    from hivedscheduler_tpu_torch.parallel import data as tdata
    from hivedscheduler_tpu_torch.parallel import distributed, topology

    cfg = ttm.TransformerConfig(vocab_size=512, d_model=256, n_heads=2, n_kv_heads=1,
                                n_layers=2, d_ff=512, max_seq_len=256, attn_impl="flash",
                                remat="dots", moe_zloss_weight=0.1, **MOE)
    tokens = np.random.default_rng(3).integers(0, 512, (2, 256)).astype(np.int32)
    step, init_fn = ttrain.make_train_step(cfg, cuda, ce_chunk=128)
    params, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
    want = [float(step(params, opt, torch.from_numpy(tokens).cuda())[2]) for _ in range(2)]
    try:
        assert distributed.initialize_from_gang(device="cuda") == (0, 1)
        mesh = topology.make_mesh(topology.MeshAxes(), "cuda")
        mstep, minit, tok_sh = ttrain.make_sharded_train_step(cfg, mesh, ce_chunk=128)
        mparams, mopt = minit(torch.Generator(device="cuda").manual_seed(0))
        got = [float(mstep(mparams, mopt, tdata.device_put_global(tokens, tok_sh, 2))[2])
               for _ in range(2)]
    finally:
        distributed.shutdown()
    assert got == want


def test_lora_step_on_card_keeps_the_base_and_runs_the_kernels(cuda):
    import dataclasses

    cfg = ttm.TransformerConfig(vocab_size=512, d_model=256, n_heads=2, n_kv_heads=1,
                                n_layers=2, d_ff=512, max_seq_len=256, attn_impl="flash",
                                remat="dots", lora_rank=8, lora_alpha=16.0, lora_mlp=True)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, 512, (2, 256)).astype(np.int32)).cuda()
    step, init_fn = ttrain.make_lora_train_step(cfg, cuda, ce_chunk=128)
    base, lora, opt = init_fn(torch.Generator(device="cuda").manual_seed(0))
    before = {k: v.clone() for k, v in base["layers"].items()}
    lora_before = {k: v.detach().clone() for k, v in lora["layers"].items()}
    launches = (tattn.FLASH_FWD_LAUNCHES, tattn.FLASH_BWD_DQ_LAUNCHES,
                tattn.FLASH_BWD_DKV_LAUNCHES)
    losses = [float(step(base, lora, opt, tokens)[2]) for _ in range(2)]
    got = (tattn.FLASH_FWD_LAUNCHES - launches[0], tattn.FLASH_BWD_DQ_LAUNCHES - launches[1],
           tattn.FLASH_BWD_DKV_LAUNCHES - launches[2])
    assert got == (2 * 2 * 2, 2 * 2, 2 * 2)  # K1 twice a layer under "dots"
    assert all(torch.equal(v, before[k]) for k, v in base["layers"].items())
    assert all(not torch.equal(v, lora_before[k]) for k, v in lora["layers"].items())
    # the dense step's first loss on the same base: bit for bit
    dense_cfg = dataclasses.replace(cfg, lora_rank=0, lora_mlp=False)
    dstep, dinit = ttrain.make_train_step(dense_cfg, cuda, ce_chunk=128)
    params, dopt = dinit(torch.Generator(device="cuda").manual_seed(0))
    assert float(dstep(params, dopt, tokens)[2]) == losses[0]


def test_self_draft_serving_equals_the_plain_engine_at_decisive_positions(cuda):
    from hivedscheduler_tpu_torch.models import serving as tsrv
    from hivedscheduler_tpu_torch.models.speculative import SpecDecodeConfig

    cfg, params, prompts = _serve_setup("cuda")
    ref, _ = _serve_streams(params, cfg, prompts)
    spec = SpecDecodeConfig(draft_params=params, draft_cfg=cfg, gamma=4)
    for extra in ({}, dict(page_size=8)):
        got, eng = _serve_streams(params, cfg, prompts, spec_decode=spec, **extra)
        assert isinstance(eng, tsrv.SpeculativeServingEngine)
        assert eng.acceptance > 0.5, extra
        with torch.inference_mode():
            for p, a, b in zip(prompts, ref, got):
                first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
                if first is None:
                    continue
                # a stream may part from the plain one only where the
                # target's top two logits are within bf16 rounding
                seq = torch.tensor([p + a[:first]], device="cuda")
                top = torch.topk(ttm.forward(params, seq, cfg)[0, -1].float(), 2).values
                assert float(top[0] - top[1]) < 0.25, (extra, first)


# -- every input dtype and head dim: the fp16 forms and the CUDA-core family ---

# (dtype, (B, T, H, H_kv, D, causal)): fp16 on the wgmma kernels at each
# padded width (ragged T, GQA, MQA, not causal); the CUDA-core family at f32
# (D 128, 64 ragged) and at bf16, fp16 and f32 past D 256 (264: an 8-column
# last panel; 320; 512), with MQA and ragged T
DTYPE_CASES = [
    (torch.float16, (2, 256, 4, 2, 128, True)), (torch.float16, (2, 200, 4, 1, 64, True)),
    (torch.float16, (1, 192, 8, 2, 96, False)), (torch.float16, (2, 200, 8, 1, 256, True)),
    (torch.float32, (2, 256, 4, 2, 128, True)), (torch.float32, (2, 200, 4, 1, 64, False)),
    (torch.bfloat16, (2, 200, 4, 1, 264, True)), (torch.float16, (1, 192, 4, 2, 320, False)),
    (torch.float32, (1, 256, 4, 2, 512, True)), (torch.bfloat16, (1, 130, 4, 4, 512, False)),
]
# f32 inputs: every output within a relative 2e-5 of the plain f32 version
# (a TF32 pass or a 16-bit operand would read ~1e-3; an H100 read ~1e-7)
F32_REL = 2e-5


def _dtype_inputs(dtype, b, t, h, h_kv, d, causal, seed=0, do_scale=1.0):
    q, k, v = _qkv(b, t, h, h_kv, d, seed=seed, dtype=dtype)
    g = torch.Generator(device="cuda").manual_seed(seed + 100)
    do = (torch.randn(q.shape, generator=g, device="cuda") * do_scale).to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("dtype, shape", DTYPE_CASES,
                         ids=[f"{str(d)[6:]}-{s[4]}-{s[5]}" for d, s in DTYPE_CASES])
def test_every_dtype_and_head_dim_runs_its_kernels(cuda, dtype, shape):
    b, t, h, h_kv, d, causal = shape
    f32 = torch.float32
    q, k, v, do = _dtype_inputs(dtype, *shape)
    counters = {form: [tattn._COUNTERS[tattn.kernel_entry(dtype, d, form, kernel)]
                       for kernel in ("fwd", "dq", "dkv")] for form in (False, True)}
    before = {n: getattr(tattn, n) for n in tattn._COUNTERS.values()}
    o, lse = tattn.flash_forward(q, k, v, causal=causal)
    grads = tattn.flash_backward(q, k, v, o, lse, do, causal=causal)
    o32, lse32 = tattn.flash_forward(q, k, v, causal=causal, out_dtype=f32)
    grads32 = tattn.flash_backward(q, k, v, o, lse, do, causal=causal, grad_dtype=f32)
    torch.cuda.synchronize()
    moved = {n: getattr(tattn, n) - before[n] for n in before if getattr(tattn, n) != before[n]}
    want = {}
    for form in (False, True):
        for name in counters[form]:
            want[name] = want.get(name, 0) + 1
    assert moved == want
    assert o.dtype == dtype and all(x.dtype == dtype for x in grads)
    assert o32.dtype == f32 and all(x.dtype == f32 for x in grads32)
    o_ref, lse_ref = tattn.flash_attention_plain(q, k, v, causal=causal, out_dtype=f32)
    g_ref = tattn.flash_backward_plain(q, k, v, o, lse, do, causal=causal, grad_dtype=f32)
    torch.testing.assert_close(lse, lse_ref, atol=LSE_ATOL, rtol=0)
    assert torch.equal(lse32, lse)
    for out, gr in ((o, grads), (o32, grads32)):
        if dtype == f32:
            assert _grad_errs(out, o_ref)[0] <= F32_REL
            assert all(_grad_errs(x, r)[0] <= F32_REL for x, r in zip(gr, g_ref))
        else:
            assert _worst_row_rel(out, o_ref) <= O_ROW_REL
            for x, r, name in zip(gr, g_ref, ("dq", "dk", "dv")):
                fro, row = _grad_errs(x, r)
                assert fro <= GRAD_REL and row <= GRAD_ROW_REL, (name, fro, row)
    # the f32 forms, rounded once, are the inputs'-dtype forms bit for bit
    assert torch.equal(o32.to(dtype), o)
    assert all(torch.equal(x.to(dtype), y) for x, y in zip(grads32, grads))
    again = (*tattn.flash_forward(q, k, v, causal=causal),
             *tattn.flash_backward(q, k, v, o, lse, do, causal=causal))
    assert all(torch.equal(x, y) for x, y in zip((o, lse, *grads), again))


@pytest.mark.parametrize("do_scale", [1.0, 2.0 ** -20])
def test_fp16_backward_beats_bf16_on_the_same_inputs(cuda, do_scale):
    # the same f32 draws rounded to each type; the f32 forms' errors against
    # each one's plain version: fp16's three more mantissa bits must show,
    # also at a gradient's magnitude (do ~ 1e-6), where an unscaled fp16 ds
    # would fall into the subnormals (csrc/flash_bwd.cu)
    errs = {}
    for dtype in (torch.bfloat16, torch.float16):
        q, k, v, do = _dtype_inputs(dtype, 2, 512, 8, 4, 128, True, seed=11, do_scale=do_scale)
        o, lse = tattn.flash_forward(q, k, v)
        got = tattn.flash_backward(q, k, v, o, lse, do, grad_dtype=torch.float32)
        want = tattn.flash_backward_plain(q, k, v, o, lse, do, grad_dtype=torch.float32)
        errs[dtype] = [_grad_errs(x, r)[0] for x, r in zip(got, want)]
    assert all(a < b for a, b in zip(errs[torch.float16], errs[torch.bfloat16])), errs


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_core_family_stores_no_column_past_d(cuda, dtype):
    # D = 264: an 8-column last panel; every output a view into a buffer 64
    # columns wider whose other columns hold a sentinel
    b, t, h, h_kv, d = 2, 200, 4, 2, 264
    q, k, v, do = _dtype_inputs(dtype, b, t, h, h_kv, d, True, seed=12)
    o16, lse = tattn.flash_forward(q, k, v)

    def wide(like):
        buf = torch.full((*like.shape[:3], d + 64), SENTINEL, dtype=dtype, device="cuda")
        return buf, buf[..., :d]

    stream = torch.cuda.current_stream().cuda_stream

    def launch(kernel, ptrs, strided):
        symbol = tattn.kernel_entry(dtype, d, False, kernel)
        dims = tattn.launch_dims(symbol, (b, t, h, h_kv, d, 1), dtype, False)
        tattn._launch(symbol, ptrs, dims, strided, stream)

    (o_buf, o), lse2 = wide(q), torch.empty_like(lse)
    launch("fwd", (q, k, v, o, lse2), (q, k, v, o))
    (dq_buf, dq), delta = wide(q), torch.empty_like(lse)
    launch("dq", (q, k, v, o16, do, lse, delta, dq), (q, k, v, o16, do, dq))
    (dk_buf, dk), (dv_buf, dv) = wide(k), wide(v)
    launch("dkv", (q, k, v, do, lse, delta, dk, dv), (q, k, v, do, dk, dv))
    torch.cuda.synchronize()
    for buf in (o_buf, dq_buf, dk_buf, dv_buf):
        assert bool((buf[..., d:] == SENTINEL).all())
    assert torch.equal(o, o16)
    for x, y in zip((dq, dk, dv), tattn.flash_backward(q, k, v, o16, lse, do)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype, d", [(torch.float16, 320), (torch.float32, 128),
                                      (torch.float32, 320)], ids=["fp16-320", "f32-128", "f32-320"])
def test_ring_hops_run_every_dtype_and_head_dim(cuda, dtype, d):
    # the ring's per-hop functions reach the new forms through flash_forward
    # and flash_backward unchanged: f32 partials of the CUDA-core family (f32
    # inputs), and at fp16 past D 256 of the cluster K1-K3, whose fp16
    # operands hold o and the gradients to the 16-bit limits
    from hivedscheduler_tpu_torch.parallel import ring_attention as tring

    f32 = torch.float32
    q, k, v, do = _dtype_inputs(dtype, 1, 256, 4, 2, d, True, seed=13)
    counters = [tattn._COUNTERS[tattn.kernel_entry(dtype, d, True, kernel)]
                for kernel in ("fwd", "dkv")]
    grad_rel = F32_REL if dtype == f32 else GRAD_REL
    for diag in (True, False):
        before = [getattr(tattn, n) for n in counters]
        o, lse = tring._flash_block(q, k, v, diag)
        out = o.permute(0, 2, 1, 3).to(dtype).contiguous()
        rows = lse.reshape(-1, q.shape[1]).contiguous()
        grads = tring._flash_block_grad(q, k, v, out, rows, do, diag)
        assert [getattr(tattn, n) for n in counters] == [n + 1 for n in before]
        o_ref, _ = tattn.flash_attention_plain(q, k, v, causal=diag, out_dtype=f32)
        g_ref = tattn.flash_backward_plain(q, k, v, out, rows, do, causal=diag, grad_dtype=f32)
        if dtype == f32:
            assert o.dtype == f32 and _grad_errs(o.permute(0, 2, 1, 3), o_ref)[0] <= F32_REL
        else:
            assert o.dtype == f32 and _worst_row_rel(o.permute(0, 2, 1, 3), o_ref) <= O_ROW_REL
        for x, r in zip(grads, g_ref):
            assert x.dtype == f32 and _grad_errs(x, r)[0] <= grad_rel


# -- the cluster K2 and K3 past D 256 (csrc/flash_bwd_wide.cu) -------------------

# (B, T, H, H_kv, D, causal): clusters of 3 (D 264, an 8-column last panel;
# 320; 384), 4 (512), 5 (640), 6 (768), 8 (896, whose 7 panels run as 8;
# 1024) blocks; GQA groups 1, 2 and 4 and H_kv = 1; T 1000 and 130, ragged
# against K2's 128-row and both 64 tiles
WIDE_BWD_SHAPES = [
    (2, 1000, 4, 1, 264, True),
    (1, 256, 4, 2, 320, False),
    (1, 256, 4, 4, 384, True),
    (2, 256, 4, 2, 512, True),
    (1, 1000, 4, 4, 512, False),
    (1, 256, 4, 2, 640, False),
    (1, 192, 8, 2, 768, True),
    (1, 130, 4, 1, 896, True),
    (1, 200, 4, 1, 1024, True),
    (1, 256, 2, 2, 1024, False),
]


def _cuda_core_backward(q, k, v, o, lse, do, causal, out_f32):
    """K2 then K3 of the CUDA-core family, called by symbol on the same
    inputs -> (dq, dk, dv)."""
    out = torch.float32 if out_f32 else q.dtype
    dims = (*q.shape[:3], k.shape[2], q.shape[3], int(causal))
    stream = torch.cuda.current_stream().cuda_stream
    dq, delta = torch.empty_like(q, dtype=out), torch.empty_like(lse)
    dk, dv = torch.empty_like(k, dtype=out), torch.empty_like(v, dtype=out)
    for symbol, ptrs, strided in (
            ("hived_flash_generic_bwd_dq", (q, k, v, o, do, lse, delta, dq), (q, k, v, o, do, dq)),
            ("hived_flash_generic_bwd_dkv", (q, k, v, do, lse, delta, dk, dv),
             (q, k, v, do, dk, dv))):
        tattn._launch(symbol, ptrs, tattn.launch_dims(symbol, dims, q.dtype, out_f32), strided,
                      stream)
    return dq, dk, dv


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("shape", WIDE_BWD_SHAPES,
                         ids=[f"d{s[4]}-t{s[1]}-g{s[2] // s[3]}-{'causal' if s[5] else 'full'}"
                              for s in WIDE_BWD_SHAPES])
def test_wide_backward_matches_plain_and_cuda_core(cuda, dtype, shape):
    # both output forms against the plain f32 backward and the CUDA-core K2
    # and K3 on the same inputs ((f)'s limits), one launch each on the
    # cluster kernels' counters, two runs bit-identical, the f32 forms
    # rounded once equal to the dtype's
    b, t, h, h_kv, d, causal = shape
    q, k, v, do = _dtype_inputs(dtype, *shape, seed=21)
    o, lse = tattn.flash_forward(q, k, v, causal=causal)
    ref = tattn.flash_backward_plain(q, k, v, o, lse, do, causal=causal,
                                     grad_dtype=torch.float32)
    forms = {}
    for out_f32 in (False, True):
        grad_dtype = torch.float32 if out_f32 else None
        before = (tattn.FLASH_BWD_DQ_WIDE_LAUNCHES, tattn.FLASH_BWD_DKV_WIDE_LAUNCHES)
        got = tattn.flash_backward(q, k, v, o, lse, do, causal=causal, grad_dtype=grad_dtype)
        torch.cuda.synchronize()
        assert (tattn.FLASH_BWD_DQ_WIDE_LAUNCHES, tattn.FLASH_BWD_DKV_WIDE_LAUNCHES) == (
            before[0] + 1, before[1] + 1)
        assert all(x.dtype == (torch.float32 if out_f32 else dtype) for x in got)
        again = tattn.flash_backward(q, k, v, o, lse, do, causal=causal, grad_dtype=grad_dtype)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        core = _cuda_core_backward(q, k, v, o, lse, do, causal, out_f32)
        for name, x, r, c in zip(("dq", "dk", "dv"), got, ref, core):
            for against in (r, c):
                fro, row = _grad_errs(x, against)
                assert fro <= GRAD_REL and row <= GRAD_ROW_REL, (name, out_f32, fro, row)
        forms[out_f32] = got
    assert all(torch.equal(x.to(dtype), y) for x, y in zip(forms[True], forms[False]))


@pytest.mark.parametrize("do_scale", [1.0, 2.0 ** -20])
def test_wide_fp16_backward_beats_bf16_on_the_same_inputs(cuda, do_scale):
    # as the D 128 test: the same f32 draws rounded to each type, the f32
    # forms against each one's plain version; at a gradient's magnitude the
    # fp16 ds row scaling, derived from the summed ds, must still show
    errs = {}
    for dtype in (torch.bfloat16, torch.float16):
        q, k, v, do = _dtype_inputs(dtype, 1, 512, 4, 2, 512, True, seed=22, do_scale=do_scale)
        o, lse = tattn.flash_forward(q, k, v)
        got = tattn.flash_backward(q, k, v, o, lse, do, grad_dtype=torch.float32)
        want = tattn.flash_backward_plain(q, k, v, o, lse, do, grad_dtype=torch.float32)
        errs[dtype] = [_grad_errs(x, r)[0] for x, r in zip(got, want)]
    assert all(a < b for a, b in zip(errs[torch.float16], errs[torch.bfloat16])), errs


def test_wide_backward_refuses_what_it_does_not_take(cuda):
    # a dtype or head dim off the cluster kernels' range is refused by the
    # entry point itself, not run on another kernel
    q, k, v, do = _dtype_inputs(torch.bfloat16, 1, 128, 2, 2, 512, True, seed=23)
    o, lse = tattn.flash_forward(q, k, v)
    dims = (1, 128, 2, 2, 512, 1)
    stream = torch.cuda.current_stream().cuda_stream
    delta, dq = torch.empty_like(lse), torch.empty_like(q)
    symbol = "hived_flash_wide_bwd_dq"
    ptrs, strided = (q, k, v, o, do, lse, delta, dq), (q, k, v, o, do, dq)
    for bad in ((1, 128, 2, 2, 256, 1, 0, 0), (1, 128, 2, 2, 1032, 1, 0, 0),
                (1, 128, 2, 2, 512, 1, 2, 2), (1, 128, 2, 2, 512, 1, 0, 1)):
        with pytest.raises(RuntimeError) as info:
            tattn._launch(symbol, ptrs, bad, strided, stream)
        assert "CUDA error" in str(info.value)
    tattn._launch(symbol, ptrs, tattn.launch_dims(symbol, dims, q.dtype, False), strided, stream)
    torch.cuda.synchronize()
    assert _grad_errs(dq, tattn.flash_backward_plain(q, k, v, o, lse, do)[0])[0] <= GRAD_REL


# -- the cluster K1 past D 256 (csrc/flash_fwd_wide.cu) ------------------------


def _cuda_core_forward(q, k, v, causal, out_f32):
    """K1 of the CUDA-core family, called by symbol on the same inputs ->
    (o, lse)."""
    o = torch.empty_like(q, dtype=torch.float32 if out_f32 else q.dtype)
    lse = torch.empty((q.shape[0] * q.shape[2], q.shape[1]), dtype=torch.float32,
                      device=q.device)
    symbol = "hived_flash_generic_fwd"
    dims = (*q.shape[:3], k.shape[2], q.shape[3], int(causal))
    tattn._launch(symbol, (q, k, v, o, lse), tattn.launch_dims(symbol, dims, q.dtype, out_f32),
                  (q, k, v, o), torch.cuda.current_stream().cuda_stream)
    return o, lse


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("shape", WIDE_BWD_SHAPES,
                         ids=[f"d{s[4]}-t{s[1]}-g{s[2] // s[3]}-{'causal' if s[5] else 'full'}"
                              for s in WIDE_BWD_SHAPES])
def test_wide_forward_matches_plain_and_cuda_core(cuda, dtype, shape):
    # both output forms against the plain f32 forward and the CUDA-core K1
    # on the same inputs ((b)'s limits), one launch each on the cluster K1's
    # counter, two runs bit-identical, the f32 form rounded once equal to
    # the dtype's
    b, t, h, h_kv, d, causal = shape
    q, k, v, _ = _dtype_inputs(dtype, *shape, seed=24)
    o_ref, lse_ref = tattn.flash_attention_plain(q, k, v, causal=causal, out_dtype=torch.float32)
    forms = {}
    for out_f32 in (False, True):
        out_dtype = torch.float32 if out_f32 else None
        before = tattn.FLASH_FWD_WIDE_LAUNCHES
        o, lse = tattn.flash_forward(q, k, v, causal=causal, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert tattn.FLASH_FWD_WIDE_LAUNCHES == before + 1
        assert o.dtype == (torch.float32 if out_f32 else dtype)
        again = tattn.flash_forward(q, k, v, causal=causal, out_dtype=out_dtype)
        assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
        core_o, core_lse = _cuda_core_forward(q, k, v, causal, out_f32)
        for o_want, lse_want in ((o_ref, lse_ref), (core_o, core_lse)):
            fro, row = _grad_errs(o, o_want)
            assert fro <= O_REL and row <= O_ROW_REL, (out_f32, fro, row)
            torch.testing.assert_close(lse, lse_want, atol=LSE_ATOL, rtol=0)
        forms[out_f32] = (o, lse)
    assert torch.equal(forms[True][0].to(dtype), forms[False][0])
    assert torch.equal(forms[True][1], forms[False][1])


def test_wide_forward_refuses_what_it_does_not_take(cuda):
    # D 256 (the wgmma kernels'), D 1032 (past the cluster's 1024) and f32
    # inputs or a third output type are refused by the entry point itself,
    # not run on another kernel
    q, k, v, _ = _dtype_inputs(torch.bfloat16, 1, 128, 2, 2, 512, True, seed=25)
    stream = torch.cuda.current_stream().cuda_stream
    o, lse = torch.empty_like(q), torch.empty((2, 128), dtype=torch.float32, device="cuda")
    symbol = "hived_flash_wide_fwd"
    ptrs, strided = (q, k, v, o, lse), (q, k, v, o)
    before = tattn.FLASH_FWD_WIDE_LAUNCHES
    for bad in ((1, 128, 2, 2, 256, 1, 0, 0), (1, 128, 2, 2, 1032, 1, 0, 0),
                (1, 128, 2, 2, 512, 1, 2, 2), (1, 128, 2, 2, 512, 1, 0, 1)):
        with pytest.raises(RuntimeError) as info:
            tattn._launch(symbol, ptrs, bad, strided, stream)
        assert "CUDA error" in str(info.value)
    tattn._launch(symbol, ptrs, tattn.launch_dims(symbol, (1, 128, 2, 2, 512, 1), q.dtype, False),
                  strided, stream)
    torch.cuda.synchronize()
    assert tattn.FLASH_FWD_WIDE_LAUNCHES == before  # a raw launch counts nothing
    o_ref, lse_ref = tattn.flash_attention_plain(q, k, v, out_dtype=torch.float32)
    assert _grad_errs(o, o_ref)[0] <= O_REL
    torch.testing.assert_close(lse, lse_ref, atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("library, kernel", [("flash_fwd_wide", "wide_fwd_kernel"),
                                             ("flash_bwd_wide", "wide_dq_kernel"),
                                             ("flash_bwd_wide", "wide_dkv_kernel")])
def test_wide_kernels_run_on_wgmma_and_tma(cuda, library, kernel):
    # every instance (bf16 or fp16 inputs x 16-bit or f32 outputs) multiplies
    # with wgmma on tiles loaded by TMA
    sass = _sass_by_kernel(_build.build(library))
    found = {k: v for k, v in sass.items() if kernel in k}
    assert len(found) == 4, sorted(sass)
    for name, text in found.items():
        assert "HGMMA" in text and "UTMALDG" in text, name
        assert "HMMA" not in text and "LDGSTS" not in text, name


# -- the 3xTF32 K2 and K3 at f32 inputs (csrc/flash_bwd_tf32.cu) ---------------

# (B, T, H, H_kv, D, causal): D 8, 72 and 96 (zero columns up to the padded
# width 64 or 128), 64 and 128; a ragged T (1000, 130) against the 64-row and
# 32-key tiles; MQA (H_kv 1) and GQA groups 2 and 4; causal and not
TF32_SHAPES = [
    (1, 256, 4, 2, 8, True),
    (2, 256, 4, 2, 64, True),
    (1, 256, 4, 2, 96, False),
    (2, 1000, 4, 1, 128, True),
    (1, 512, 8, 2, 128, False),
    (1, 130, 2, 2, 72, True),
]


def _tf32_inputs(shape, seed):
    q, k, v, do = _dtype_inputs(torch.float32, *shape, seed=seed)
    o, lse = tattn.flash_forward(q, k, v, causal=shape[5])
    return q, k, v, o, lse, do


@pytest.mark.parametrize("shape", TF32_SHAPES,
                         ids=[f"d{s[4]}-t{s[1]}-g{s[2] // s[3]}-{'causal' if s[5] else 'full'}"
                              for s in TF32_SHAPES])
def test_tf32_backward_matches_plain_f32(cuda, shape):
    # both output forms (f32 in both) within F32_REL of the plain f32
    # backward, delta too; one launch each on the 3xTF32 counters and none
    # on the CUDA-core family's; the two forms and two runs bit-identical
    b, t, h, h_kv, d, causal = shape
    q, k, v, o, lse, do = _tf32_inputs(shape, seed=31)
    assert all(tattn.kernel_entry(torch.float32, d, f, kernel).startswith("hived_flash_tf32")
               for f in (False, True) for kernel in ("dq", "dkv"))
    ref = tattn.flash_backward_plain(q, k, v, o, lse, do, causal=causal)
    forms = []
    for grad_dtype in (None, torch.float32):
        before = {n: getattr(tattn, n) for n in tattn._COUNTERS.values()}
        got = tattn.flash_backward(q, k, v, o, lse, do, causal=causal, grad_dtype=grad_dtype)
        torch.cuda.synchronize()
        moved = {n: getattr(tattn, n) - before[n] for n in before
                 if getattr(tattn, n) != before[n]}
        assert moved == {"FLASH_BWD_DQ_TF32_LAUNCHES": 1, "FLASH_BWD_DKV_TF32_LAUNCHES": 1}
        assert all(x.dtype == torch.float32 for x in got)
        for name, x, r in zip(("dq", "dk", "dv"), got, ref):
            assert _grad_errs(x, r)[0] <= F32_REL, (name, _grad_errs(x, r))
        forms.append(got)
    assert all(torch.equal(x, y) for x, y in zip(*forms))
    again = tattn.flash_backward(q, k, v, o, lse, do, causal=causal)
    assert all(torch.equal(x, y) for x, y in zip(forms[0], again))
    _, delta = tattn.flash_backward_dq_cuda(q, k, v, o, lse, do, causal)
    want = (do * o).sum(-1).permute(0, 2, 1).reshape(b * h, t)
    assert _grad_errs(delta, want)[0] <= F32_REL


def test_tf32_backward_rounds_its_operands_to_nearest(cuda):
    # every input's low 13 bits set at or past half a tf32 ulp, where
    # truncating an operand to tf32 and rounding it differ: the kernels
    # still agree with the plain f32 backward, while the same backward on
    # the truncated inputs does not (what an operand left to wgmma to cut
    # down would give)
    shape = (1, 512, 4, 2, 128, True)
    q, k, v, do = _dtype_inputs(torch.float32, *shape, seed=32)

    def round_up_bits(x):
        bits = x.view(torch.int32)
        return ((bits & ~0x1FFF) | 0x1800).view(torch.float32)

    def truncated(x):
        return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)

    q, k, v, do = (round_up_bits(x) for x in (q, k, v, do))
    o, lse = tattn.flash_forward(q, k, v)
    ref = tattn.flash_backward_plain(q, k, v, o, lse, do)
    got = tattn.flash_backward(q, k, v, o, lse, do)
    cut = tattn.flash_backward_plain(*(truncated(x) for x in (q, k, v, o)), lse, truncated(do))
    for name, x, c, r in zip(("dq", "dk", "dv"), got, cut, ref):
        assert _grad_errs(x, r)[0] <= F32_REL, name
        assert _grad_errs(c, r)[0] > F32_REL, name


def test_tf32_pair_matches_the_cuda_core_pair(cuda):
    # the same inputs through both families' K2 and K3, by symbol (the
    # CUDA-core pair computes every product in f32 FMA): within F32_REL of
    # each other; a raw launch counts nothing
    shape = (2, 1024, 8, 4, 128, True)
    q, k, v, o, lse, do = _tf32_inputs(shape, seed=33)
    before = (tattn.FLASH_BWD_DQ_TF32_LAUNCHES, tattn.FLASH_BWD_DKV_TF32_LAUNCHES)
    dims = (*q.shape[:3], k.shape[2], q.shape[3], 1)
    stream = torch.cuda.current_stream().cuda_stream
    dq, delta = torch.empty_like(q), torch.empty_like(lse)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for symbol, ptrs, strided in (
            ("hived_flash_tf32_bwd_dq", (q, k, v, o, do, lse, delta, dq), (q, k, v, o, do, dq)),
            ("hived_flash_tf32_bwd_dkv", (q, k, v, do, lse, delta, dk, dv),
             (q, k, v, do, dk, dv))):
        tattn._launch(symbol, ptrs, tattn.launch_dims(symbol, dims, q.dtype, False), strided,
                      stream)
    core = _cuda_core_backward(q, k, v, o, lse, do, True, False)
    torch.cuda.synchronize()
    assert (tattn.FLASH_BWD_DQ_TF32_LAUNCHES, tattn.FLASH_BWD_DKV_TF32_LAUNCHES) == before
    for name, x, c in zip(("dq", "dk", "dv"), (dq, dk, dv), core):
        assert _grad_errs(x, c)[0] <= F32_REL, name


def test_tf32_backward_refuses_what_it_does_not_take(cuda):
    # 16-bit type codes, an output type other than f32 and D past 128 are
    # refused by the entry points themselves
    shape = (1, 128, 2, 2, 128, True)
    q, k, v, o, lse, do = _tf32_inputs(shape, seed=34)
    stream = torch.cuda.current_stream().cuda_stream
    delta, dq = torch.empty_like(lse), torch.empty_like(q)
    symbol = "hived_flash_tf32_bwd_dq"
    ptrs, strided = (q, k, v, o, do, lse, delta, dq), (q, k, v, o, do, dq)
    for bad in ((1, 128, 2, 2, 136, 1, 2, 2), (1, 128, 2, 2, 128, 1, 0, 0),
                (1, 128, 2, 2, 128, 1, 2, 0), (1, 128, 2, 2, 12, 1, 2, 2)):
        with pytest.raises(RuntimeError) as info:
            tattn._launch(symbol, ptrs, bad, strided, stream)
        assert "CUDA error" in str(info.value)
    tattn._launch(symbol, ptrs, (1, 128, 2, 2, 128, 1, 2, 2), strided, stream)
    torch.cuda.synchronize()
    assert _grad_errs(dq, tattn.flash_backward_plain(q, k, v, o, lse, do)[0])[0] <= F32_REL


@pytest.mark.parametrize("kernel", ["tf32_dq_kernel", "tf32_dkv_kernel"])
def test_tf32_kernels_run_on_wgmma_and_tma(cuda, kernel):
    # every instance (padded width 64 or 128 x causal or not) multiplies
    # with wgmma on tiles loaded by TMA, never with mma.sync
    sass = _sass_by_kernel(_build.build("flash_bwd_tf32"))
    found = {k: v for k, v in sass.items() if kernel in k}
    assert len(found) == 4, sorted(sass)
    for name, text in found.items():
        assert "HGMMA" in text and "UTMALDG" in text, name
        assert "HMMA" not in text and "LDGSTS" not in text, name


# -- the 3xTF32 K1 at f32 inputs (csrc/flash_fwd_tf32.cu) -----------------------


@pytest.mark.parametrize("shape", TF32_SHAPES,
                         ids=[f"d{s[4]}-t{s[1]}-g{s[2] // s[3]}-{'causal' if s[5] else 'full'}"
                              for s in TF32_SHAPES])
def test_tf32_forward_matches_plain_f32(cuda, shape):
    # both output forms (f32 in both) within F32_REL of the plain f32
    # forward, o and lse; one launch each on the 3xTF32 K1's counter and
    # none on the CUDA-core family's; the two forms and two runs
    # bit-identical, and within F32_REL of the CUDA-core K1 on the same
    # inputs; stored through a wider buffer's view, nothing past D
    b, t, h, h_kv, d, causal = shape
    q, k, v, _ = _dtype_inputs(torch.float32, *shape, seed=35)
    assert all(tattn.kernel_entry(torch.float32, d, f) == "hived_flash_tf32_fwd"
               for f in (False, True))
    o_ref, lse_ref = tattn.flash_attention_plain(q, k, v, causal=causal)
    forms = []
    for out_dtype in (None, torch.float32):
        before = {n: getattr(tattn, n) for n in tattn._COUNTERS.values()}
        o, lse = tattn.flash_forward(q, k, v, causal=causal, out_dtype=out_dtype)
        torch.cuda.synchronize()
        moved = {n: getattr(tattn, n) - before[n] for n in before
                 if getattr(tattn, n) != before[n]}
        assert moved == {"FLASH_FWD_TF32_LAUNCHES": 1}
        assert o.dtype == torch.float32 and lse.shape == (b * h, t)
        assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
        assert _grad_errs(o, o_ref)[0] <= F32_REL, _grad_errs(o, o_ref)
        assert _grad_errs(lse, lse_ref)[0] <= F32_REL, _grad_errs(lse, lse_ref)
        forms.append((o, lse))
    assert all(torch.equal(x, y) for x, y in zip(*forms))
    again = tattn.flash_forward(q, k, v, causal=causal)
    assert all(torch.equal(x, y) for x, y in zip(forms[0], again))
    core_o, core_lse = _cuda_core_forward(q, k, v, causal, False)
    assert _grad_errs(forms[0][0], core_o)[0] <= F32_REL
    assert _grad_errs(forms[0][1], core_lse)[0] <= F32_REL
    # o through a view into a buffer 64 columns wider: nothing stored past D
    buf = torch.full((b, t, h, d + 64), SENTINEL, dtype=torch.float32, device="cuda")
    lse2 = torch.empty_like(lse_ref)
    symbol = "hived_flash_tf32_fwd"
    tattn._launch(symbol, (q, k, v, buf[..., :d], lse2),
                  tattn.launch_dims(symbol, (b, t, h, h_kv, d, int(causal)), q.dtype, False),
                  (q, k, v, buf[..., :d]), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert bool((buf[..., d:] == SENTINEL).all())
    assert torch.equal(buf[..., :d], forms[0][0]) and torch.equal(lse2, forms[0][1])


def test_tf32_forward_rounds_its_operands_to_nearest(cuda):
    # every input's low 13 bits set at or past half a tf32 ulp, where
    # truncating an operand to tf32 and rounding it differ (D 64: the
    # 1/sqrt(D) scale of q is a power of two and keeps those bits): the
    # kernel still agrees with the plain f32 forward, while the same forward
    # on the truncated inputs does not
    shape = (1, 512, 4, 2, 64, True)
    q, k, v, _ = _dtype_inputs(torch.float32, *shape, seed=36)

    def round_up_bits(x):
        bits = x.view(torch.int32)
        return ((bits & ~0x1FFF) | 0x1800).view(torch.float32)

    def truncated(x):
        return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)

    q, k, v = (round_up_bits(x) for x in (q, k, v))
    o_ref, lse_ref = tattn.flash_attention_plain(q, k, v)
    o, lse = tattn.flash_forward(q, k, v)
    o_cut, _ = tattn.flash_attention_plain(*(truncated(x) for x in (q, k, v)))
    assert _grad_errs(o, o_ref)[0] <= F32_REL
    assert _grad_errs(lse, lse_ref)[0] <= F32_REL
    assert _grad_errs(o_cut, o_ref)[0] > F32_REL


def test_tf32_forward_refuses_what_it_does_not_take(cuda):
    # 16-bit type codes, an output type other than f32 and D past 128 are
    # refused by the entry point itself; a raw launch counts nothing
    shape = (1, 128, 2, 2, 128, True)
    q, k, v, _ = _dtype_inputs(torch.float32, *shape, seed=37)
    stream = torch.cuda.current_stream().cuda_stream
    o, lse = torch.empty_like(q), torch.empty((2, 128), dtype=torch.float32, device="cuda")
    symbol = "hived_flash_tf32_fwd"
    ptrs, strided = (q, k, v, o, lse), (q, k, v, o)
    before = tattn.FLASH_FWD_TF32_LAUNCHES
    for bad in ((1, 128, 2, 2, 136, 1, 2, 2), (1, 128, 2, 2, 128, 1, 0, 0),
                (1, 128, 2, 2, 128, 1, 2, 0), (1, 128, 2, 2, 12, 1, 2, 2)):
        with pytest.raises(RuntimeError) as info:
            tattn._launch(symbol, ptrs, bad, strided, stream)
        assert "CUDA error" in str(info.value)
    tattn._launch(symbol, ptrs, (1, 128, 2, 2, 128, 1, 2, 2), strided, stream)
    torch.cuda.synchronize()
    assert tattn.FLASH_FWD_TF32_LAUNCHES == before
    o_ref, lse_ref = tattn.flash_attention_plain(q, k, v)
    assert _grad_errs(o, o_ref)[0] <= F32_REL and _grad_errs(lse, lse_ref)[0] <= F32_REL


def test_tf32_forward_runs_on_wgmma_and_tma(cuda):
    # every instance (padded width 64 or 128 x causal or not) multiplies
    # with wgmma on tiles loaded by TMA, never with mma.sync
    sass = _sass_by_kernel(_build.build("flash_fwd_tf32"))
    found = {k: v for k, v in sass.items() if "tf32_fwd_kernel" in k}
    assert len(found) == 4, sorted(sass)
    for name, text in found.items():
        assert "HGMMA" in text and "UTMALDG" in text, name
        assert "HMMA" not in text and "LDGSTS" not in text, name


# -- the 3xTF32 cluster K2 and K3 past D 128 (csrc/flash_bwd_tf32_wide.cu) ------

# (B, T, H, H_kv, D, causal): D 136 (an 8-column last panel) with MQA and a
# ragged T; Gemma-2B's D 256 with MQA; D 320 not causal; D 512; D 1024 (the
# route's largest, clusters of 8) with a ragged T
TF32_WIDE_SHAPES = [
    (2, 200, 4, 1, 136, True),
    (1, 256, 8, 1, 256, True),
    (1, 256, 4, 2, 320, False),
    (1, 512, 4, 2, 512, True),
    (1, 200, 4, 2, 1024, True),
]


@pytest.mark.parametrize("shape", TF32_WIDE_SHAPES,
                         ids=[f"d{s[4]}-t{s[1]}-g{s[2] // s[3]}-{'causal' if s[5] else 'full'}"
                              for s in TF32_WIDE_SHAPES])
def test_tf32_wide_backward_matches_plain_f32(cuda, shape):
    # both output forms (f32 in both) within F32_REL of the plain f32
    # backward, delta too; one launch each on the cluster pair's counters and
    # none on another's; the two forms and two runs bit-identical; dq, dk and
    # dv stored through views into buffers 64 columns wider, nothing past D
    b, t, h, h_kv, d, causal = shape
    q, k, v, o, lse, do = _tf32_inputs(shape, seed=41)
    assert all(tattn.kernel_entry(torch.float32, d, f, kernel).startswith("hived_flash_tf32_wide")
               for f in (False, True) for kernel in ("dq", "dkv"))
    ref = tattn.flash_backward_plain(q, k, v, o, lse, do, causal=causal)
    forms = []
    for grad_dtype in (None, torch.float32):
        before = {n: getattr(tattn, n) for n in tattn._COUNTERS.values()}
        got = tattn.flash_backward(q, k, v, o, lse, do, causal=causal, grad_dtype=grad_dtype)
        torch.cuda.synchronize()
        moved = {n: getattr(tattn, n) - before[n] for n in before
                 if getattr(tattn, n) != before[n]}
        assert moved == {"FLASH_BWD_DQ_TF32_WIDE_LAUNCHES": 1,
                         "FLASH_BWD_DKV_TF32_WIDE_LAUNCHES": 1}
        assert all(x.dtype == torch.float32 for x in got)
        for name, x, r in zip(("dq", "dk", "dv"), got, ref):
            assert _grad_errs(x, r)[0] <= F32_REL, (name, _grad_errs(x, r))
        forms.append(got)
    assert all(torch.equal(x, y) for x, y in zip(*forms))
    again = tattn.flash_backward(q, k, v, o, lse, do, causal=causal)
    assert all(torch.equal(x, y) for x, y in zip(forms[0], again))
    _, delta = tattn.flash_backward_dq_cuda(q, k, v, o, lse, do, causal)
    want = (do * o).sum(-1).permute(0, 2, 1).reshape(b * h, t)
    assert _grad_errs(delta, want)[0] <= F32_REL
    bufs = [torch.full((*x.shape[:3], d + 64), SENTINEL, device="cuda") for x in (q, k, v)]
    dq, dk, dv = (buf[..., :d] for buf in bufs)
    delta2 = torch.empty_like(lse)
    dims = (b, t, h, h_kv, d, int(causal))
    stream = torch.cuda.current_stream().cuda_stream
    for symbol, ptrs, strided in (
            ("hived_flash_tf32_wide_bwd_dq", (q, k, v, o, do, lse, delta2, dq),
             (q, k, v, o, do, dq)),
            ("hived_flash_tf32_wide_bwd_dkv", (q, k, v, do, lse, delta2, dk, dv),
             (q, k, v, do, dk, dv))):
        tattn._launch(symbol, ptrs, tattn.launch_dims(symbol, dims, q.dtype, False), strided,
                      stream)
    torch.cuda.synchronize()
    assert all(bool((buf[..., d:] == SENTINEL).all()) for buf in bufs)
    assert all(torch.equal(x, y) for x, y in zip((dq, dk, dv), forms[0]))


def test_tf32_wide_pair_matches_the_cuda_core_pair(cuda):
    # the same inputs through the cluster pair and the CUDA-core pair, by
    # symbol (f32 FMA): within F32_REL of each other; a raw launch counts
    # nothing
    shape = (2, 512, 4, 2, 384, True)
    q, k, v, o, lse, do = _tf32_inputs(shape, seed=42)
    before = (tattn.FLASH_BWD_DQ_TF32_WIDE_LAUNCHES, tattn.FLASH_BWD_DKV_TF32_WIDE_LAUNCHES)
    dims = (*q.shape[:3], k.shape[2], q.shape[3], 1)
    stream = torch.cuda.current_stream().cuda_stream
    dq, delta = torch.empty_like(q), torch.empty_like(lse)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for symbol, ptrs, strided in (
            ("hived_flash_tf32_wide_bwd_dq", (q, k, v, o, do, lse, delta, dq),
             (q, k, v, o, do, dq)),
            ("hived_flash_tf32_wide_bwd_dkv", (q, k, v, do, lse, delta, dk, dv),
             (q, k, v, do, dk, dv))):
        tattn._launch(symbol, ptrs, tattn.launch_dims(symbol, dims, q.dtype, False), strided,
                      stream)
    core = _cuda_core_backward(q, k, v, o, lse, do, True, False)
    torch.cuda.synchronize()
    assert (tattn.FLASH_BWD_DQ_TF32_WIDE_LAUNCHES,
            tattn.FLASH_BWD_DKV_TF32_WIDE_LAUNCHES) == before
    for name, x, c in zip(("dq", "dk", "dv"), (dq, dk, dv), core):
        assert _grad_errs(x, c)[0] <= F32_REL, name


def test_tf32_wide_backward_refuses_what_it_does_not_take(cuda):
    # D 128 (the 3xTF32 kernels' own), D 1032 (past a portable cluster of 8
    # panels), 16-bit type codes and an output type other than f32 are
    # refused by the entry point itself, not run on another kernel
    shape = (1, 128, 2, 2, 256, True)
    q, k, v, o, lse, do = _tf32_inputs(shape, seed=43)
    stream = torch.cuda.current_stream().cuda_stream
    delta, dq = torch.empty_like(lse), torch.empty_like(q)
    symbol = "hived_flash_tf32_wide_bwd_dq"
    ptrs, strided = (q, k, v, o, do, lse, delta, dq), (q, k, v, o, do, dq)
    for bad in ((1, 128, 2, 2, 128, 1, 2, 2), (1, 128, 2, 2, 1032, 1, 2, 2),
                (1, 128, 2, 2, 256, 1, 0, 0), (1, 128, 2, 2, 256, 1, 2, 0)):
        with pytest.raises(RuntimeError) as info:
            tattn._launch(symbol, ptrs, bad, strided, stream)
        assert "CUDA error" in str(info.value)
    tattn._launch(symbol, ptrs, (1, 128, 2, 2, 256, 1, 2, 2), strided, stream)
    torch.cuda.synchronize()
    assert _grad_errs(dq, tattn.flash_backward_plain(q, k, v, o, lse, do)[0])[0] <= F32_REL


@pytest.mark.parametrize("kernel", ["tf32_wide_dq_kernel", "tf32_wide_dkv_kernel"])
def test_tf32_wide_kernels_run_on_wgmma_and_tma(cuda, kernel):
    # the one instance of each multiplies with wgmma on tiles loaded by TMA,
    # never with mma.sync
    sass = _sass_by_kernel(_build.build("flash_bwd_tf32_wide"))
    found = {k: v for k, v in sass.items() if kernel in k}
    assert len(found) == 1, sorted(sass)
    for name, text in found.items():
        assert "HGMMA" in text and "UTMALDG" in text, name
        assert "HMMA" not in text and "LDGSTS" not in text, name


# -- the 3xTF32 cluster K1 past D 128 (csrc/flash_fwd_tf32_wide.cu) ------------

# (B, T, H, H_kv, D, causal): clusters of 2 (D 136, an 8-column last panel,
# with MQA and a ragged T; Gemma-2B's D 256 with MQA), 3 (384), 4 (512 not
# causal, ragged T), 5 (640 not causal), 6 (768), 8 (896, whose 7 panels run
# as 8, with MQA and a ragged T; 1024, the route's largest)
TF32_WIDE_FWD_SHAPES = [
    (2, 200, 4, 1, 136, True),
    (1, 256, 8, 1, 256, True),
    (1, 256, 4, 4, 384, True),
    (1, 200, 4, 2, 512, False),
    (1, 256, 4, 2, 640, False),
    (1, 192, 8, 2, 768, True),
    (1, 130, 4, 1, 896, True),
    (1, 200, 4, 1, 1024, False),
]


@pytest.mark.parametrize("shape", TF32_WIDE_FWD_SHAPES,
                         ids=[f"d{s[4]}-t{s[1]}-g{s[2] // s[3]}-{'causal' if s[5] else 'full'}"
                              for s in TF32_WIDE_FWD_SHAPES])
def test_tf32_wide_forward_matches_plain_f32(cuda, shape):
    # both output forms (f32 in both) within F32_REL of the plain f32
    # forward, o and lse; one launch each on the cluster K1's counter and
    # none on another's; the two forms and two runs bit-identical; o stored
    # through a view into a buffer 64 columns wider, nothing past D
    b, t, h, h_kv, d, causal = shape
    q, k, v, _ = _dtype_inputs(torch.float32, *shape, seed=45)
    assert all(tattn.kernel_entry(torch.float32, d, f) == "hived_flash_tf32_wide_fwd"
               for f in (False, True))
    o_ref, lse_ref = tattn.flash_attention_plain(q, k, v, causal=causal)
    forms = []
    for out_dtype in (None, torch.float32):
        before = {n: getattr(tattn, n) for n in tattn._COUNTERS.values()}
        o, lse = tattn.flash_forward(q, k, v, causal=causal, out_dtype=out_dtype)
        torch.cuda.synchronize()
        moved = {n: getattr(tattn, n) - before[n] for n in before
                 if getattr(tattn, n) != before[n]}
        assert moved == {"FLASH_FWD_TF32_WIDE_LAUNCHES": 1}
        assert o.dtype == torch.float32 and lse.shape == (b * h, t)
        assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
        assert _grad_errs(o, o_ref)[0] <= F32_REL, _grad_errs(o, o_ref)
        assert _grad_errs(lse, lse_ref)[0] <= F32_REL, _grad_errs(lse, lse_ref)
        forms.append((o, lse))
    assert all(torch.equal(x, y) for x, y in zip(*forms))
    again = tattn.flash_forward(q, k, v, causal=causal)
    assert all(torch.equal(x, y) for x, y in zip(forms[0], again))
    buf = torch.full((b, t, h, d + 64), SENTINEL, dtype=torch.float32, device="cuda")
    lse2 = torch.empty_like(lse_ref)
    symbol = "hived_flash_tf32_wide_fwd"
    tattn._launch(symbol, (q, k, v, buf[..., :d], lse2),
                  tattn.launch_dims(symbol, (b, t, h, h_kv, d, int(causal)), q.dtype, False),
                  (q, k, v, buf[..., :d]), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert bool((buf[..., d:] == SENTINEL).all())
    assert torch.equal(buf[..., :d], forms[0][0]) and torch.equal(lse2, forms[0][1])


def test_tf32_wide_forward_matches_the_cuda_core_k1(cuda):
    # the same inputs through the cluster K1 and the CUDA-core K1, by symbol
    # (f32 FMA): within F32_REL of each other; a raw launch counts nothing
    shape = (2, 512, 4, 2, 384, True)
    q, k, v, _ = _dtype_inputs(torch.float32, *shape, seed=46)
    before = tattn.FLASH_FWD_TF32_WIDE_LAUNCHES
    o, lse = torch.empty_like(q), torch.empty((2 * 4, 512), dtype=torch.float32, device="cuda")
    symbol = "hived_flash_tf32_wide_fwd"
    tattn._launch(symbol, (q, k, v, o, lse),
                  tattn.launch_dims(symbol, (2, 512, 4, 2, 384, 1), q.dtype, False),
                  (q, k, v, o), torch.cuda.current_stream().cuda_stream)
    core_o, core_lse = _cuda_core_forward(q, k, v, True, False)
    torch.cuda.synchronize()
    assert tattn.FLASH_FWD_TF32_WIDE_LAUNCHES == before
    assert _grad_errs(o, core_o)[0] <= F32_REL and _grad_errs(lse, core_lse)[0] <= F32_REL


def test_tf32_wide_forward_refuses_what_it_does_not_take(cuda):
    # D 128 (the 3xTF32 K1's own), D 1032 (past a portable cluster of 8
    # panels), 16-bit type codes and an output type other than f32 are
    # refused by the entry point itself, not run on another kernel
    shape = (1, 128, 2, 2, 256, True)
    q, k, v, _ = _dtype_inputs(torch.float32, *shape, seed=47)
    stream = torch.cuda.current_stream().cuda_stream
    o, lse = torch.empty_like(q), torch.empty((2, 128), dtype=torch.float32, device="cuda")
    symbol = "hived_flash_tf32_wide_fwd"
    ptrs, strided = (q, k, v, o, lse), (q, k, v, o)
    for bad in ((1, 128, 2, 2, 128, 1, 2, 2), (1, 128, 2, 2, 1032, 1, 2, 2),
                (1, 128, 2, 2, 256, 1, 0, 0), (1, 128, 2, 2, 256, 1, 1, 2),
                (1, 128, 2, 2, 256, 1, 2, 0)):
        with pytest.raises(RuntimeError) as info:
            tattn._launch(symbol, ptrs, bad, strided, stream)
        assert "CUDA error" in str(info.value)
    tattn._launch(symbol, ptrs, (1, 128, 2, 2, 256, 1, 2, 2), strided, stream)
    torch.cuda.synchronize()
    o_ref, lse_ref = tattn.flash_attention_plain(q, k, v)
    assert _grad_errs(o, o_ref)[0] <= F32_REL and _grad_errs(lse, lse_ref)[0] <= F32_REL


def test_tf32_wide_forward_runs_on_wgmma_and_tma_without_spill(cuda):
    # its one instance multiplies with wgmma on tiles loaded by TMA, never
    # with mma.sync, and touches no local memory (no register spill)
    sass = _sass_by_kernel(_build.build("flash_fwd_tf32_wide"))
    found = {k: v for k, v in sass.items() if "tf32_wide_fwd_kernel" in k}
    assert len(found) == 1, sorted(sass)
    for name, text in found.items():
        assert "HGMMA" in text and "UTMALDG" in text, name
        assert "HMMA" not in text and "LDGSTS" not in text, name
        assert not re.search(r"\b(LDL|STL)\b", text), name
