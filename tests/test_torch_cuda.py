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
bit-identically on the card, and the train CLI resumes there.
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


@pytest.mark.parametrize("shape", [
    (2, 256, 4, 2, 128, True),
    (2, 256, 4, 4, 128, False),
    (1, 512, 8, 1, 64, True),
    (3, 130, 2, 1, 64, True),   # ragged last tile
    (1, 64, 2, 2, 128, False),  # one tile
] + EDGE_SHAPES)
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
    q, _, _ = _qkv(1, 128, 2, 2, 64)
    _, k, v = _qkv(1, 256, 2, 2, 64)
    before = tattn.FLASH_FWD_LAUNCHES
    with pytest.raises(ValueError):
        tattn.flash_attention(q, k, v, causal=False)
    assert tattn.FLASH_FWD_LAUNCHES == before


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
        q, k, v = _qkv(1, 128, 2, 2, 32)
        kind = ValueError
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
] + EDGE_SHAPES


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
    # every instance (D 64/128 x causal/full) multiplies with wgmma (HGMMA)
    # on tiles loaded by TMA (UTMALDG), never with mma.sync (HMMA) or
    # cp.async (LDGSTS)
    sass = _sass_by_kernel(_build.build(library))
    found = {k: v for k, v in sass.items() if kernel in k}
    assert len(found) == 4, sorted(sass)
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
