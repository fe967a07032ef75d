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
head dims other than 64 and 128 (32, 80, 96, 112, run at the padded width
64 or 128; 136, 192 and Gemma's 256 with MQA and ragged T, run at 256), and
store nothing past D into a wider output buffer; a head dim off the
multiples of 8 or a cross-length k takes ``xla_attention``, as in the JAX
package, and the raw kernel call refuses D = 12 and D = 264.
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
# (D=80, 96: Phi-2's and Phi-3-mini's; 112), with GQA and ragged T
PADDED_SHAPES = [
    (2, 200, 4, 2, 32, True),
    (2, 256, 4, 1, 80, False),
    (1, 192, 8, 2, 96, True),
    (2, 130, 4, 4, 96, False),
    (2, 200, 8, 2, 112, True),
]
# head dims past 128, run at the padded width 256 (K1 and K2 in 64-row
# blocks whose consumers split the output's columns, K3 in column halves),
# with MQA and ragged T
WIDE_SHAPES = [
    (2, 200, 8, 1, 136, True),
    (1, 200, 8, 1, 192, False),
    (2, 200, 8, 1, 256, True),
    (2, 150, 8, 1, 256, True),
    (1, 320, 8, 2, 256, False),
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
    if bad == "f32":
        q, k, v = q.float(), k.float(), v.float()
        kind = TypeError
    elif bad == "noncontig":
        q = torch.randn(1, 2, 128, 64, device="cuda").to(torch.bfloat16).transpose(1, 2)
        kind = ValueError
    elif bad == "grad":
        # a raw kernel call is not differentiable: under grad mode it
        # refuses a tensor that requires grad (flash_attention takes it)
        q = q.clone().requires_grad_(True)
        kind = NotImplementedError
    else:
        # the raw kernel call takes the multiples of 8 up to 256: D=264 is
        # past the widest template, and D=12 (below) is off the grid
        q, k, v = _qkv(1, 128, 2, 2, 264)
        kind = ValueError
    before = tattn.FLASH_FWD_LAUNCHES
    with pytest.raises(kind):
        tattn.flash_forward(q, k, v)
    if bad == "head_dim":
        with pytest.raises(kind):
            tattn.flash_forward(*_qkv(1, 128, 2, 2, 12))
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


SENTINEL = -7777.0


@pytest.mark.parametrize("d", [32, 96, 136, 256])
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
])
def test_kernels_run_on_wgmma_and_tma(cuda, library, kernel):
    # every instance (D 64/128/256 x causal/full x bf16/f32 outputs)
    # multiplies with wgmma (HGMMA) on tiles loaded by TMA (UTMALDG), never
    # with mma.sync (HMMA) or cp.async (LDGSTS)
    sass = _sass_by_kernel(_build.build(library))
    found = {k: v for k, v in sass.items() if kernel in k}
    assert len(found) == 12, sorted(sass)
    for name, text in found.items():
        assert "HGMMA" in text and "UTMALDG" in text, name
        assert "HMMA" not in text and "LDGSTS" not in text, name


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
                   (1, 256, 8, 1, 256, True), (1, 200, 8, 1, 192, False)]
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
    q, k, v = _qkv(1, 128, 2, 2, 64)
    with pytest.raises(TypeError):
        tattn.flash_forward(q, k, v, out_dtype=torch.float16)
    # the bf16 form is the default (None), not a dtype to ask for
    with pytest.raises(TypeError):
        tattn.flash_forward(q, k, v, out_dtype=torch.bfloat16)


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
