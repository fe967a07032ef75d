"""The arithmetic of the card's K2 and K3 at the padded width 96
(``csrc/flash_bwd.cu`` ``flash_bwd_dq_kernel<96>`` and
``flash_bwd_dkv_kernel<96>``, 16-bit inputs at 64 < D <= 96: Phi-3-mini's
head dim 96, and 72, 80, 88), emulated on the CPU in the kernels' order and
held to the JAX package's ``_flash_backward`` (Pallas in interpret mode,
blocks of T / 2, ``grad_dtype=f32``) and to the port's
``flash_backward_plain`` on the same seeded bf16 and fp16 inputs, o and lse.

A tile at Dp 96 is three 32-column panels (``csrc/hopper.cuh``), zero past
D. The K-major products (K2's s = q k^T and dp = do v^T, K3's s^T = k q^T
and dp^T = v do^T) run six k-steps of 16 columns in order, two a panel, and
the MN-major ones (dq += ds k, dv += p^T do, dk += ds^T q) have 96 output
columns, of which the epilogues store those below D. The blocks, tiles,
masks and roundings are those of the Dp 128 kernels:

K2 takes 128 q rows a block as two consumers of 64, over 64-key K/V tiles
zero-filled past T. A consumer reads the key tiles up to its last row's
diagonal tile (causal) or all of them, and masks only its last tile: p = 0
for keys past T and causal keys past the row. Its rows past T get lse =
+inf, so their p is 0, and are not stored. delta = rowsum(do * o) in f32,
two lanes a row: columns 0-63 and 64 up to D, added. Per tile p = exp(scale
s - lse), ds = p (dp - delta), and dq += ds k with ds rounded to the input
type; fp16 packs each row of ds scaled by 2^E (E chosen a tile so that the
row's largest |ds| lands in [2^14, 2^15), only falling, the row's
accumulator moved by the power of two between two scales, and the epilogue
multiplies by 2^-E). dq = scale * acc.

K3 takes one block per (batch, kv head, 64-key tile) and walks the group's
q heads in order, each over its 64-row q tiles from the causal diagonal on.
Only the diagonal tile (causal) and a ragged last tile are masked, s^T =
-inf for rows at or past T and causal keys past the row. dv += p^T do with
p^T rounded to the input type; dk += ds^T q with ds^T = p^T (dp^T - delta)
from the f32 p^T, rounded (fp16: each key's row scaled by 2^E over its q
tiles). dk = scale * acc.

Tolerance: u of the input type in relative Frobenius norm (bf16 2^-8, fp16
2^-11), as ``test_torch_attention_d256_bwd.py`` argues: the kernels round ds
(K2), p^T and ds^T (K3) once per element before a product that sums them,
which JAX and the plain version do not. The planted faults fall outside it:
the diagonal mask one key late, and the first k-step of the 32-column panel
(columns 64-79, which hold data at every D of the route) skipped in every
K-major product. Cases at a ragged T of 200: D 72 and 80 with a GQA group
of 4, D 96 with Phi-3-mini's group of 1, causal and not.
"""

import os
import re

import pytest
import torch
import torch.nn.functional as F

from hivedscheduler_tpu_torch.ops import attention as tattn
from test_torch_attention_d256_bwd import (  # noqa: E402
    DS_EXP_MAX, DTYPES, UNIT_ROUNDOFF, _heads, _inputs, _pack, _pow2, _rel)

ROWS = 128  # K2: q rows a block, two consumers of 64
HALF = 64
KEYS = 64  # K2: keys a K/V tile; K3: keys a block
Q_TILE = 64  # K3: q rows a streamed tile
DP = 96  # the padded width: three 32-column panels
K_STEP = 16  # columns a k-step of the K-major products
DELTA_SPLIT = 64  # K2's delta: lane 0 sums columns [0, 64), lane 1 [64, D)
# (T, D, causal, H, H_kv): D 72 and 80 with a GQA group of 4, D 96 with
# Phi-3-mini's group of 1, causal and not between them
CASES = [(200, 72, False, 4, 1), (200, 80, True, 4, 1), (200, 96, True, 2, 2),
         (200, 96, False, 2, 2)]
FAULTS = ("late_mask", "skip_kstep")
SKIPPED_KSTEP = 4  # columns 64-79: the 32-column panel's first k-step
CSRC = os.path.join(os.path.dirname(tattn.__file__), "csrc")


def _case_id(case) -> str:
    t, d, causal, h, h_kv = case
    return f"t{t}-d{d}-{'causal' if causal else 'full'}-group{h // h_kv}"


def _padded(x: torch.Tensor) -> torch.Tensor:
    """x's last axis zero-filled to the padded width, as TMA fills a box."""
    return F.pad(x, (0, DP - x.shape[-1]))


def _kmajor(a: torch.Tensor, b: torch.Tensor, skip: int = None) -> torch.Tensor:
    """a b^T over the padded width as a K-major product takes it: six k-steps
    of 16 columns in order (two a 32-column panel); ``skip`` leaves one
    out."""
    out = torch.zeros(*a.shape[:-1], b.shape[-2])
    for kk in range(DP // K_STEP):
        if kk != skip:
            cols = slice(K_STEP * kk, K_STEP * (kk + 1))
            out = out + a[..., cols] @ b[..., cols].transpose(-1, -2)
    return out


def d96_dq(q, k, v, o, lse, do, causal: bool, fault: str = None):
    """(dq f32 [B, T, H, D], delta [B*H, T]) of K2 at Dp 96, in the kernel's
    order (the module docstring)."""
    b, t, h, d = q.shape
    g = h // k.shape[2]
    tp = -(-t // ROWS) * ROWS
    qh, doh, oh = (_padded(_heads(x, tp)) for x in (q, do, o))
    kh, vh = (_padded(_heads(x, tp, g)) for x in (k, v))
    skip = SKIPPED_KSTEP if fault == "skip_kstep" else None
    lb = F.pad(lse.reshape(b, h, t), (0, tp - t), value=float("inf"))
    prod = doh * oh  # rows past T: 0
    delta = prod[..., :DELTA_SPLIT].sum(-1) + prod[..., DELTA_SPLIT:].sum(-1)
    scale = 1.0 / d ** 0.5
    n_t = -(-t // KEYS)
    dq = torch.zeros(b, h, tp, DP)
    for r0 in range(0, tp, HALF):  # consumer c of block r0 // ROWS: rows r0 + [0, 64)
        if r0 >= t:
            continue  # every row of this consumer is past T: nothing stored
        n_c = min(n_t, (r0 + HALF) // KEYS) if causal else n_t
        rows = torch.arange(r0, r0 + HALF)[:, None] + (1 if fault == "late_mask" else 0)
        acc = torch.zeros(b, h, HALF, DP)
        e = torch.full((b, h, HALF, 1), DS_EXP_MAX, dtype=torch.int32)
        for j in range(n_c):
            keys = slice(j * KEYS, (j + 1) * KEYS)
            s = _kmajor(qh[:, :, r0:r0 + HALF], kh[:, :, keys], skip)
            p = torch.exp(s * scale - lb[:, :, r0:r0 + HALF, None])
            if j == n_c - 1:  # the consumer's last tile: its diagonal, or T
                cols = torch.arange(j * KEYS, (j + 1) * KEYS)[None, :]
                p = p.masked_fill((cols >= t) | (causal & (cols > rows)), 0.0)
            dp = _kmajor(doh[:, :, r0:r0 + HALF], vh[:, :, keys], skip)
            ds, acc, e = _pack(p * (dp - delta[:, :, r0:r0 + HALF, None]), q.dtype, e, acc)
            acc = acc + ds @ kh[:, :, keys]  # 96 output columns
        if q.dtype == torch.float16:
            acc = acc * _pow2(-e)
        dq[:, :, r0:r0 + HALF] = acc * scale
    return (dq[:, :, :t, :d].permute(0, 2, 1, 3),
            delta[:, :, :t].reshape(b * h, t))


def d96_dkv(q, k, v, lse, delta, do, causal: bool, fault: str = None):
    """dk, dv (f32, [B, T, H_kv, D]) of K3 at Dp 96, in the kernel's order
    (the module docstring); delta is K2's."""
    b, t, h, d = q.shape
    h_kv = k.shape[2]
    g = h // h_kv
    tp = -(-t // KEYS) * KEYS
    # q heads as [B, H_kv, group, rows, 96]: head j * group + i is (j, i)
    qh, doh = (_padded(_heads(x, tp)).reshape(b, h_kv, g, tp, DP) for x in (q, do))
    kh, vh = (_padded(_heads(x, tp)) for x in (k, v))
    skip = SKIPPED_KSTEP if fault == "skip_kstep" else None
    lb = F.pad(lse.reshape(b, h_kv, g, t), (0, tp - t), value=float("inf"))
    dl = F.pad(delta.reshape(b, h_kv, g, t), (0, tp - t))
    scale = 1.0 / d ** 0.5
    n_q = tp // Q_TILE
    dk, dv = torch.zeros(b, h_kv, tp, DP), torch.zeros(b, h_kv, tp, DP)
    for k0 in range(0, tp, KEYS):
        kb, vb = kh[:, :, k0:k0 + KEYS], vh[:, :, k0:k0 + KEYS]
        keys = torch.arange(k0, k0 + KEYS)[:, None] - (1 if fault == "late_mask" else 0)
        first = k0 // Q_TILE if causal else 0
        acc_k, acc_v = torch.zeros(b, h_kv, KEYS, DP), torch.zeros(b, h_kv, KEYS, DP)
        e = torch.full((b, h_kv, KEYS, 1), DS_EXP_MAX, dtype=torch.int32)
        for i in range(g):  # the group's heads, each from the diagonal on
            for q0 in range(first * Q_TILE, n_q * Q_TILE, Q_TILE):
                qb, dob = qh[:, :, i, q0:q0 + Q_TILE], doh[:, :, i, q0:q0 + Q_TILE]
                s = _kmajor(kb, qb, skip)  # [B, H_kv, keys, rows]
                if (causal and q0 == k0) or q0 + Q_TILE > t:
                    rows = torch.arange(q0, q0 + Q_TILE)[None, :]
                    s = s.masked_fill((rows >= t) | (causal & (keys > rows)), -float("inf"))
                p = torch.exp(s * scale - lb[:, :, i, None, q0:q0 + Q_TILE])
                acc_v = acc_v + p.to(q.dtype).float() @ dob
                dp = _kmajor(vb, dob, skip)
                ds, acc_k, e = _pack(p * (dp - dl[:, :, i, None, q0:q0 + Q_TILE]), q.dtype, e,
                                     acc_k)
                acc_k = acc_k + ds @ qb
        if q.dtype == torch.float16:
            acc_k = acc_k * _pow2(-e)
        dk[:, :, k0:k0 + KEYS] = acc_k * scale
        dv[:, :, k0:k0 + KEYS] = acc_v
    return tuple(x[:, :, :t, :d].permute(0, 2, 1, 3) for x in (dk, dv))


def d96_backward(x: dict, causal: bool, fault: str = None):
    """(dq, dk, dv) in f32 of K2 and K3 at Dp 96 on ``x``'s tensors."""
    dq, delta = d96_dq(x["q"], x["k"], x["v"], x["o"], x["lse"], x["do"], causal, fault)
    return (dq, *d96_dkv(x["q"], x["k"], x["v"], x["lse"], delta, x["do"], causal, fault))


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_width_96_backward_order_matches_jax_and_plain(case, dtype_name):
    x, jax_grads = _inputs(case, dtype_name)
    causal = case[2]
    got = d96_backward(x, causal)
    plain = tattn.flash_backward_plain(x["q"], x["k"], x["v"], x["o"], x["lse"], x["do"],
                                       causal=causal, grad_dtype=torch.float32)
    tol = UNIT_ROUNDOFF[x["q"].dtype]
    for name, g, jg, pg in zip(("dq", "dk", "dv"), got, jax_grads, plain):
        assert g.shape == jg.shape == pg.shape, name
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, jg) <= tol, (name, _rel(g, jg), tol)
        assert _rel(g, pg) <= tol, (name, _rel(g, pg), tol)


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("fault", FAULTS)
def test_width_96_backward_planted_faults_fall_outside_the_tolerance(fault, dtype_name):
    # Phi-3-mini's D 96 and group of 1, causal at the ragged T 200: the mask
    # one key late and the skipped k-step each move every output past the
    # tolerance
    case = (200, 96, True, 2, 2)
    x, jax_grads = _inputs(case, dtype_name)
    good = d96_backward(x, True)
    bad = d96_backward(x, True, fault)
    tol = UNIT_ROUNDOFF[x["q"].dtype]
    for name, g, b, jg in zip(("dq", "dk", "dv"), good, bad, jax_grads):
        assert _rel(g, jg) <= tol, name
        assert _rel(b, jg) > tol, (name, _rel(b, jg), tol)


def _rule(source: str, name: str):
    """The padded-width rule ``name`` of ``csrc/flash_common.cuh`` as a
    function: its chain of ``D <= n ? w`` and the last width."""
    body = re.search(r"inline int " + name + r"\(int D\) \{\s*return ([^;]+);", source).group(1)
    steps = [(int(n), int(w)) for n, w in re.findall(r"D <= (\d+) \? (\d+)", body)]
    last = int(body.rsplit(":", 1)[1])
    return lambda d: next((w for n, w in steps if d <= n), last)


def test_backward_padded_width_rule_keeps_k1_at_128():
    # the rules the C entry points route by, against the port's statement of
    # them: K2 and K3 run 64 < D <= 96 at 96 and nothing else moves; K1
    # keeps 128 there (Phi-3-mini's D 96: K1 at 128, K2 and K3 at 96)
    with open(os.path.join(CSRC, "flash_common.cuh")) as f:
        source = f.read()
    fwd, bwd = _rule(source, "padded_head_dim"), _rule(source, "bwd_padded_head_dim")
    for d in tattn.WGMMA_HEAD_DIMS:
        assert fwd(d) == tattn.padded_head_dim(d, "fwd"), d
        for kernel in ("dq", "dkv"):
            assert bwd(d) == tattn.padded_head_dim(d, kernel), (d, kernel)
        assert bwd(d) == (96 if 64 < d <= 96 else fwd(d)), d
    assert [bwd(d) for d in (64, 72, 80, 88, 96, 104, 112, 128)] == [64, 96, 96, 96, 96, 128,
                                                                      128, 128]
    assert fwd(96) == 128 and bwd(96) == 96
    # the K2 and K3 entry points route by the backward's rule, K1's by its own
    with open(os.path.join(CSRC, "flash_bwd.cu")) as f:
        bwd_src = f.read()
    with open(os.path.join(CSRC, "flash_fwd.cu")) as f:
        fwd_src = f.read()
    assert bwd_src.count("const int Dp = bwd_padded_head_dim(D);") == 2
    assert "padded_head_dim(D)" not in bwd_src.replace("bwd_padded_head_dim(D)", "")
    assert "const int Dp = padded_head_dim(D);" in fwd_src
    assert "bwd_padded_head_dim" not in fwd_src
