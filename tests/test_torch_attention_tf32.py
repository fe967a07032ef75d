"""The arithmetic the 3xTF32 K1, K2 and K3 (``csrc/flash_fwd_tf32.cu``,
``csrc/flash_bwd_tf32.cu``) and the 3xTF32 cluster K1, K2 and K3 past D 128
(``csrc/flash_fwd_tf32_wide.cu``, ``csrc/flash_bwd_tf32_wide.cu``) rest on,
emulated on the CPU and held to
the port's plain f32 forward and backward and to the JAX package's
``_flash_forward`` and ``_flash_backward`` (Pallas in interpret mode).

The card kernels form every product (the forward's q k^T and p v, the
backward's q k^T, do v^T, ds k, ds^T q, p^T do) from the operands' tf32
parts: big = the f32 value rounded
to tf32 (10 mantissa bits, to nearest, ties away from zero: ``cvt.rna``),
small = the rest rounded the same way, and a b = big big' + big small' +
small big', accumulated in f32. Here each product is three f32 matmuls of
tf32-valued operands, whose products are exact in f32 (11 x 11 significant
bits), summed in f32. The tests show that this stays within the f32 limit
the card checks hold the kernels to (2e-5 relative Frobenius,
``chip_smoke.py``'s ``DT_F32_REL``) and that one TF32 pass (big big' alone)
does not, at B 1, T 128, H 4 on H_kv 2, D 64 and 96, causal and not; the
forward also at a ragged T 200, in K1's own order (32-key tiles, each
tile's o^T = v^T p^T in a fresh part folded in as o corr + part); the
backward past D 128 in the cluster kernels' order (each 128-column panel's
partial scores through the 3xTF32 product, the panels' partials added in
rank order, each panel's outputs summed a tile at a time) at D 136, 256,
320 and 512, causal and not, GQA (H_kv 2) and MQA (H_kv 1); and the forward
past D 128 in the cluster K1's order (each panel's partial scores through
the 3xTF32 product, added in rank order, then K1's 32-key tiles) at the same
head dims, masks and groups, at T 128 and a ragged T 200.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.ops import attention as jattn
from hivedscheduler_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

F32_REL = 2e-5  # chip_smoke.py's DT_F32_REL, the card checks' limit at f32 inputs
CASES = [pytest.param(d, causal, id=f"d{d}-{'causal' if causal else 'full'}")
         for d in (64, 96) for causal in (True, False)]
FWD_CASES = [pytest.param(t, d, causal, id=f"t{t}-d{d}-{'causal' if causal else 'full'}")
             for t in (128, 200) for d in (64, 96) for causal in (True, False)]
KEYS = 32  # keys a K/V tile of the card's K1
PANEL = 128  # output columns a block of the cluster K2 and K3 owns
TILE = 32  # the cluster K2's keys a K/V tile, K3's q rows a q/do tile
WIDE_CASES = [pytest.param(d, causal, h_kv, id=f"d{d}-{'causal' if causal else 'full'}-"
                                                f"{'mqa' if h_kv == 1 else 'gqa'}")
              for d in (136, 256, 320, 512) for causal in (True, False) for h_kv in (2, 1)]
WIDE_FWD_CASES = [pytest.param(t, d, causal, h_kv,
                               id=f"t{t}-d{d}-{'causal' if causal else 'full'}-"
                                  f"{'mqa' if h_kv == 1 else 'gqa'}")
                  for t in (128, 200) for d in (136, 256, 320, 512) for causal in (True, False)
                  for h_kv in (2, 1)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to tf32 as cvt.rna.tf32.f32 does: half of the 13
    dropped bits added to the magnitude, then the 13 bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    big = tf32(x)
    return big, tf32(x - big)


def mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in 3xTF32: three f32 matmuls of tf32 parts."""
    (ab, as_), (bb, bs) = split(a), split(b)
    return as_ @ bb + ab @ bs + ab @ bb


def mm1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in one TF32 pass."""
    return tf32(a) @ tf32(b)


def backward(q, k, v, o, lse, do, causal: bool, mm):
    """dq, dk, dv of the flash backward with every product through ``mm``,
    the rest in f32, as the card kernels compute them: s = q k^T times the
    scale, p = exp(s - lse) (0 where causal masks), delta = rowsum(do o),
    ds = p (dp - delta), dq = scale ds k, dk = scale ds^T q, dv = p^T do, dk
    and dv summed over each kv head's q-head group."""
    b, t, h, d = q.shape
    h_kv = k.shape[2]
    g = h // h_kv
    scale = 1.0 / d ** 0.5
    qh, oh, doh = (x.permute(0, 2, 1, 3) for x in (q, o, do))  # [b, h, t, d]
    kh, vh = (x.permute(0, 2, 1, 3).repeat_interleave(g, dim=1) for x in (k, v))
    s = mm(qh, kh.transpose(-1, -2)) * scale
    p = torch.exp(s - lse.reshape(b, h, t, 1))
    if causal:
        p = p.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), 0.0)
    dp = mm(doh, vh.transpose(-1, -2))
    delta = (doh * oh).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dq = mm(ds, kh) * scale
    dk = (mm(ds.transpose(-1, -2), qh) * scale).reshape(b, h_kv, g, t, d).sum(2)
    dv = mm(p.transpose(-1, -2), doh).reshape(b, h_kv, g, t, d).sum(2)
    return dq.permute(0, 2, 1, 3), dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def cluster_backward(q, k, v, o, lse, do, causal: bool, mm):
    """dq, dk, dv in the order of the card's cluster K2 and K3: qs = scale
    q in f32; each 128-column panel's partial s = qs k^T and dp = do v^T
    through ``mm``, the panels' partials added in rank order (from 0, as an
    owner adds them); delta likewise from each panel's rowsum(do o); p =
    exp(s - lse) (0 where causal masks), ds = p (dp - delta); each panel's
    dq^T from 32-key tiles, and its dk^T and dv^T from 32-row q tiles of
    every head of the kv head's group in turn, each tile's product through
    ``mm`` in a fresh part added to the f32 sum; dq times the scale."""
    b, t, h, d = q.shape
    h_kv = k.shape[2]
    g = h // h_kv
    scale = 1.0 / d ** 0.5
    qs = q * scale
    qh, oh, doh = (x.permute(0, 2, 1, 3) for x in (qs, o, do))  # [b, h, t, d]
    kh, vh = (x.permute(0, 2, 1, 3).repeat_interleave(g, dim=1) for x in (k, v))
    panels = [slice(c, min(c + PANEL, d)) for c in range(0, d, PANEL)]
    s = torch.zeros(b, h, t, t)
    dp = torch.zeros(b, h, t, t)
    delta = torch.zeros(b, h, t, 1)
    for cols in panels:
        s = s + mm(qh[..., cols], kh[..., cols].transpose(-1, -2))
        dp = dp + mm(doh[..., cols], vh[..., cols].transpose(-1, -2))
        delta = delta + (doh[..., cols] * oh[..., cols]).sum(-1, keepdim=True)
    p = torch.exp(s - lse.reshape(b, h, t, 1))
    if causal:
        p = p.masked_fill(~torch.ones(t, t, dtype=torch.bool).tril(), 0.0)
    ds = p * (dp - delta)
    dq = torch.zeros(b, h, t, d)
    dk = torch.zeros(b, h_kv, t, d)
    dv = torch.zeros(b, h_kv, t, d)
    for cols in panels:
        for k0 in range(0, t, TILE):
            keys = slice(k0, k0 + TILE)
            dq[..., cols] += mm(ds[..., keys], kh[:, :, keys, cols])
        for head in range(g):
            for r0 in range(0, t, TILE):
                rows = slice(r0, r0 + TILE)
                hs = slice(head, h, g)  # this head of every kv head's group
                dk[..., cols] += mm(ds[:, hs, rows].transpose(-1, -2), qh[:, hs, rows, cols])
                dv[..., cols] += mm(p[:, hs, rows].transpose(-1, -2), doh[:, hs, rows, cols])
    dq = dq * scale
    return dq.permute(0, 2, 1, 3), dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def forward(q, k, v, causal: bool, mm):
    """o, lse [B*H, T] of the flash forward in the card K1's order, every
    product through ``mm``, the rest in f32: q scaled by 1/sqrt(D), then
    for each 32-key tile s = q k^T (causal keys past the row at NEG_INF),
    m_new, m_safe = max(m_new, -0.5e30), p = exp(s - m_safe), corr =
    exp(max(m, -0.5e30) - m_safe), l = l corr + rowsum(p) and o = o corr +
    part, with the tile's part = (v^T p^T)^T in a fresh accumulator; then
    the l == 0 guard, o / l and lse = m_safe + log(l)."""
    b, t, h, d = q.shape
    g = h // k.shape[2]
    qh = q.permute(0, 2, 1, 3) * (1.0 / d ** 0.5)  # [b, h, t, d]
    kh, vh = (x.permute(0, 2, 1, 3).repeat_interleave(g, dim=1) for x in (k, v))
    m = torch.full((b, h, t, 1), tattn.NEG_INF)
    l = torch.zeros((b, h, t, 1))
    o = torch.zeros((b, h, t, d))
    rows = torch.arange(t)[:, None]
    for k0 in range(0, t, KEYS):
        kt, vt = kh[:, :, k0:k0 + KEYS], vh[:, :, k0:k0 + KEYS]
        s = mm(qh, kt.transpose(-1, -2))
        if causal:
            s = s.masked_fill(torch.arange(k0, k0 + kt.shape[2])[None, :] > rows, tattn.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_safe = torch.clamp(m_new, min=tattn._CLAMP)
        p = torch.exp(s - m_safe)
        corr = torch.exp(torch.clamp(m, min=tattn._CLAMP) - m_safe)
        l = l * corr + p.sum(-1, keepdim=True)
        part = mm(vt.transpose(-1, -2), p.transpose(-1, -2)).transpose(-1, -2)
        o = o * corr + part
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    lse = torch.clamp(m, min=tattn._CLAMP) + torch.log(l_safe)
    return (o / l_safe).permute(0, 2, 1, 3), lse.reshape(b * h, t)


def cluster_forward(q, k, v, causal: bool, mm):
    """o, lse [B*H, T] in the order of the card's cluster K1: q scaled by
    1/sqrt(D) in f32; for each 32-key tile each 128-column panel's partial
    s = qs k^T through ``mm``, the panels' partials added in rank order
    (from 0, as an owner adds them); then K1's online softmax step (causal
    keys past the row at NEG_INF, m_safe, corr, p, l) and o = o corr + part,
    the tile's part = (v^T p^T)^T through ``mm`` in a fresh accumulator
    (each panel's columns of it, which no sum over panels touches); then the
    l == 0 guard, o / l and lse = m_safe + log(l)."""
    b, t, h, d = q.shape
    g = h // k.shape[2]
    qh = q.permute(0, 2, 1, 3) * (1.0 / d ** 0.5)  # [b, h, t, d]
    kh, vh = (x.permute(0, 2, 1, 3).repeat_interleave(g, dim=1) for x in (k, v))
    panels = [slice(c, min(c + PANEL, d)) for c in range(0, d, PANEL)]
    m = torch.full((b, h, t, 1), tattn.NEG_INF)
    l = torch.zeros((b, h, t, 1))
    o = torch.zeros((b, h, t, d))
    rows = torch.arange(t)[:, None]
    for k0 in range(0, t, KEYS):
        kt, vt = kh[:, :, k0:k0 + KEYS], vh[:, :, k0:k0 + KEYS]
        s = torch.zeros(b, h, t, kt.shape[2])
        for cols in panels:
            s = s + mm(qh[..., cols], kt[..., cols].transpose(-1, -2))
        if causal:
            s = s.masked_fill(torch.arange(k0, k0 + kt.shape[2])[None, :] > rows, tattn.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        m_safe = torch.clamp(m_new, min=tattn._CLAMP)
        p = torch.exp(s - m_safe)
        corr = torch.exp(torch.clamp(m, min=tattn._CLAMP) - m_safe)
        l = l * corr + p.sum(-1, keepdim=True)
        part = torch.cat([mm(vt[..., cols].transpose(-1, -2), p.transpose(-1, -2))
                          for cols in panels], dim=2).transpose(-1, -2)
        o = o * corr + part
        m = m_new
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    lse = torch.clamp(m, min=tattn._CLAMP) + torch.log(l_safe)
    return (o / l_safe).permute(0, 2, 1, 3), lse.reshape(b * h, t)


def _rel(x, ref) -> float:
    x, ref = torch.as_tensor(np.array(x)), torch.as_tensor(np.array(ref))
    return float((x - ref).norm() / ref.norm())


@functools.lru_cache(maxsize=None)
def _inputs(d: int, causal: bool, h_kv: int = 2):
    """q, k, v, do from a seed, and the forward's o and lse from JAX's
    interpret-mode kernel (lse as the port's [B*H, T]), with JAX's
    interpret-mode dq, dk and dv."""
    rng = np.random.default_rng(1000 + d + causal + 10 * (h_kv - 2))
    b, t, h = 1, 128, 4
    q, do = (rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, t, h_kv, d)).astype(np.float32) for _ in range(2))
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        o, lse = jattn._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=causal, block_q=64, block_k=64, interpret=True)
        g_ref = jattn._flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o, lse,
                                      jnp.asarray(do), causal=causal, block_q=64, block_k=64,
                                      interpret=True)
    x = {n: torch.from_numpy(a) for n, a in (("q", q), ("k", k), ("v", v), ("do", do))}
    x["o"] = torch.from_numpy(np.asarray(o).copy())
    x["lse"] = torch.from_numpy(np.asarray(lse)[:, :, 0].copy())
    return x, [np.asarray(g) for g in g_ref]


@functools.lru_cache(maxsize=None)
def _fwd_inputs(t: int, d: int, causal: bool, h_kv: int = 2):
    """q, k, v from a seed, and o and lse from JAX's interpret-mode
    forward (lse as the port's [B*H, T]; blocks of 64, or 40 at T 200)."""
    rng = np.random.default_rng(2000 + t + d + causal + 10 * (h_kv - 2))
    b, h = 1, 4
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, t, h_kv, d)).astype(np.float32) for _ in range(2))
    block = 64 if t % 64 == 0 else 40
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        o, lse = jattn._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=causal, block_q=block, block_k=block,
                                      interpret=True)
    x = {n: torch.from_numpy(a) for n, a in (("q", q), ("k", k), ("v", v))}
    return x, np.asarray(o), np.asarray(lse)[:, :, 0]


@pytest.mark.parametrize("t, d, causal", FWD_CASES)
def test_3xtf32_forward_is_within_the_f32_limit(t, d, causal):
    x, jax_o, jax_lse = _fwd_inputs(t, d, causal)
    args = (x["q"], x["k"], x["v"], causal)
    o, lse = forward(*args, mm3)
    plain_o, plain_lse = tattn.flash_attention_plain(*args)
    for got, plain, jax_ref in ((o, plain_o, jax_o), (lse, plain_lse, jax_lse)):
        assert _rel(got, plain) <= F32_REL, _rel(got, plain)
        assert _rel(got, jax_ref) <= F32_REL, _rel(got, jax_ref)
    # the emulation with exact products is the plain version's function
    exact = forward(*args, torch.matmul)
    assert _rel(exact[0], plain_o) <= 1e-6 and _rel(exact[1], plain_lse) <= 1e-6


@pytest.mark.parametrize("t, d, causal", FWD_CASES)
def test_one_tf32_pass_forward_is_outside_the_f32_limit(t, d, causal):
    # what the three passes buy in K1: one pass is off by more than the limit
    x, jax_o, _ = _fwd_inputs(t, d, causal)
    args = (x["q"], x["k"], x["v"], causal)
    o, _ = forward(*args, mm1)
    assert _rel(o, tattn.flash_attention_plain(*args)[0]) > F32_REL
    assert _rel(o, jax_o) > F32_REL


@pytest.mark.parametrize("d, causal", CASES)
def test_3xtf32_backward_is_within_the_f32_limit(d, causal):
    x, jax_grads = _inputs(d, causal)
    args = (x["q"], x["k"], x["v"], x["o"], x["lse"], x["do"], causal)
    got = backward(*args, mm3)
    plain = tattn.flash_backward_plain(*args)
    for name, g, p, j in zip(("dq", "dk", "dv"), got, plain, jax_grads):
        assert _rel(g, p) <= F32_REL, (name, _rel(g, p))
        assert _rel(g, j) <= F32_REL, (name, _rel(g, j))
    # the emulation with exact products is the plain version's function
    exact = backward(*args, torch.matmul)
    assert all(_rel(e, p) <= 1e-6 for e, p in zip(exact, plain))


@pytest.mark.parametrize("d, causal", CASES)
def test_one_tf32_pass_is_outside_the_f32_limit(d, causal):
    # what the three passes buy: one pass is off by more than the limit
    x, jax_grads = _inputs(d, causal)
    args = (x["q"], x["k"], x["v"], x["o"], x["lse"], x["do"], causal)
    one = backward(*args, mm1)
    plain = tattn.flash_backward_plain(*args)
    errs = [_rel(g, p) for g, p in zip(one, plain)]
    assert min(errs) > F32_REL, errs
    assert all(_rel(g, j) > F32_REL for g, j in zip(one, jax_grads))


def test_tf32_split_rounds_to_nearest_and_keeps_22_bits():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(4096).astype(np.float32) * 3.0)
    big, small = split(x)
    low = 0x1FFF
    assert int((big.view(torch.int32) & low).abs().sum()) == 0
    assert int((small.view(torch.int32) & low).abs().sum()) == 0
    # big is the nearest tf32 value: within half a tf32 ulp (2^-11 of the
    # value's binade), where truncation would be off by up to a whole one
    assert float(((x - big).abs() / x.abs()).max()) <= 2.0 ** -11
    bits = x.view(torch.int32)
    trunc = (bits & ~low).view(torch.float32)
    up = (bits & low) >= 0x1000  # rounding goes away from zero here
    assert bool(up.any()) and bool((~up).any())
    assert bool((big[up].abs() > trunc[up].abs()).all())
    assert torch.equal(big[~up], trunc[~up])
    # big + small is x to about 2^-22
    assert float(((big + small - x).abs() / x.abs()).max()) <= 2.0 ** -21
    # ties go away from zero, as cvt.rna does
    tie = torch.tensor([0x3F801000, -0x407FF000], dtype=torch.int32).view(torch.float32)
    assert torch.equal(tf32(tie).view(torch.int32),
                       torch.tensor([0x3F802000, -0x407FE000], dtype=torch.int32))


@pytest.mark.parametrize("d, causal, h_kv", WIDE_CASES)
def test_3xtf32_cluster_backward_is_within_the_f32_limit(d, causal, h_kv):
    x, jax_grads = _inputs(d, causal, h_kv)
    args = (x["q"], x["k"], x["v"], x["o"], x["lse"], x["do"], causal)
    got = cluster_backward(*args, mm3)
    plain = tattn.flash_backward_plain(*args)
    for name, g, p, j in zip(("dq", "dk", "dv"), got, plain, jax_grads):
        assert _rel(g, p) <= F32_REL, (name, _rel(g, p))
        assert _rel(g, j) <= F32_REL, (name, _rel(g, j))
    # the emulation with exact products is the plain version's function
    exact = cluster_backward(*args, torch.matmul)
    assert all(_rel(e, p) <= 1e-6 for e, p in zip(exact, plain))


@pytest.mark.parametrize("d, causal, h_kv", WIDE_CASES)
def test_one_tf32_pass_cluster_backward_is_outside_the_f32_limit(d, causal, h_kv):
    # what the three passes buy past D 128: one pass is off by more than the
    # limit against both references
    x, jax_grads = _inputs(d, causal, h_kv)
    args = (x["q"], x["k"], x["v"], x["o"], x["lse"], x["do"], causal)
    one = cluster_backward(*args, mm1)
    plain = tattn.flash_backward_plain(*args)
    errs = [_rel(g, p) for g, p in zip(one, plain)]
    assert min(errs) > F32_REL, errs
    assert all(_rel(g, j) > F32_REL for g, j in zip(one, jax_grads))


@pytest.mark.parametrize("t, d, causal, h_kv", WIDE_FWD_CASES)
def test_3xtf32_cluster_forward_is_within_the_f32_limit(t, d, causal, h_kv):
    x, jax_o, jax_lse = _fwd_inputs(t, d, causal, h_kv)
    args = (x["q"], x["k"], x["v"], causal)
    o, lse = cluster_forward(*args, mm3)
    plain_o, plain_lse = tattn.flash_attention_plain(*args)
    for got, plain, jax_ref in ((o, plain_o, jax_o), (lse, plain_lse, jax_lse)):
        assert _rel(got, plain) <= F32_REL, _rel(got, plain)
        assert _rel(got, jax_ref) <= F32_REL, _rel(got, jax_ref)
    # the emulation with exact products is the plain version's function
    exact = cluster_forward(*args, torch.matmul)
    assert _rel(exact[0], plain_o) <= 1e-6 and _rel(exact[1], plain_lse) <= 1e-6


@pytest.mark.parametrize("t, d, causal, h_kv", WIDE_FWD_CASES)
def test_one_tf32_pass_cluster_forward_is_outside_the_f32_limit(t, d, causal, h_kv):
    # what the three passes buy in the cluster K1: one pass is off by more
    # than the limit against both references
    x, jax_o, _ = _fwd_inputs(t, d, causal, h_kv)
    args = (x["q"], x["k"], x["v"], causal)
    o, _ = cluster_forward(*args, mm1)
    assert _rel(o, tattn.flash_attention_plain(*args)[0]) > F32_REL
    assert _rel(o, jax_o) > F32_REL
