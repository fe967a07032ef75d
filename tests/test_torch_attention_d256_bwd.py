"""The arithmetic of the card's K2 and K3 at the padded width 256
(``csrc/flash_bwd.cu`` ``flash_bwd_dq_kernel_d256`` and
``flash_bwd_dkv_kernel_d256``, 16-bit inputs at 128 < D <= 256), emulated
on the CPU in the kernels' order and held to the JAX package's
``_flash_backward`` (Pallas in interpret mode, blocks of T / 2,
``grad_dtype=f32``) and to the port's ``flash_backward_plain`` on the same
seeded bf16 and fp16 inputs, o and lse.

K2 takes 128 q rows a block as two consumers of 64, each with all 256
columns of dq, over 64-key K/V tiles zero-filled past T (and past D, which
leaves every product as it is). A consumer reads the key tiles up to its
last row's diagonal tile (causal) or all of them; only its last tile is
masked (causal: its diagonal tile; else the tile that holds T), p = 0 for
keys past T and causal keys past the row. Its rows past T get lse = +inf,
so their p is 0; a consumer whose rows are all past T does nothing. Per
tile s = q k^T and dp = do v^T in f32, p = exp(scale s - lse), ds = p (dp -
delta) with delta = rowsum(do * o) in f32, and dq += ds k with ds rounded
to the input type; fp16 packs each row of ds scaled by 2^E, E chosen a tile
so that the row's largest |ds| lands in [2^14, 2^15) and only falling, the
row's accumulator moved by the power of two between two scales, and the
epilogue multiplies by 2^-E. dq = scale * acc.

K3 takes one block per (batch, kv head, 64-key tile) and walks the group's
q heads in order, each over its 64-row q tiles from the causal diagonal on.
Only the diagonal tile (causal) and a ragged last tile are masked, s^T =
-inf for rows at or past T and causal keys past the row. dv += p^T do with
p^T = exp(scale s^T - lse) rounded to the input type; dk += ds^T q with ds^T
= p^T (dp^T - delta) from the f32 p^T, rounded to the input type (fp16: each
key's row scaled by 2^E over its q tiles, as K2's rows over its key tiles).
dk = scale * acc.

Tolerance. The kernels round ds (K2) and p^T and ds^T (K3) to the input
type once per element before a product that sums them over keys or rows;
JAX and the plain version do not round them. One rounding has a relative
error of at most the type's unit roundoff u (bf16 2^-8, fp16 2^-11) and
about u / sqrt(3) in mean square, and the roundings of a sum's terms are
independent, so an output's relative error in the Frobenius norm is about
u / sqrt(3): the tests hold dq, dk and dv (the kernels' f32-output forms)
within u of both references. The planted faults, the diagonal mask one key
late and a consumer's (K3: a head's) last tile skipped, fall outside it.
Cases: D 136 and 256, causal and not, MQA and a GQA group of 4, T 128, a
ragged 200, and T 150, where the last K2 block's consumer 1 has no row.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hivedscheduler_tpu.ops import attention as jattn
from hivedscheduler_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

ROWS = 128  # K2: q rows a block, two consumers of 64
HALF = 64
KEYS = 64  # K2: keys a K/V tile; K3: keys a block
Q_TILE = 64  # K3: q rows a streamed tile
DS_EXP_MAX = 126  # fp16: the largest 2^E, kept a normal f32 with its inverse
UNIT_ROUNDOFF = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp16": (torch.float16, jnp.float16)}
# (T, D, causal, H, H_kv)
CASES = [(t, d, causal, 2, 1) for t in (128, 200) for d in (136, 256)
         for causal in (True, False)] + [
    (200, 256, True, 8, 2), (128, 136, False, 8, 2), (150, 256, True, 2, 1)]
FAULTS = ("late_mask", "skip_last")


def _case_id(case) -> str:
    t, d, causal, h, h_kv = case
    heads = "mqa" if h_kv == 1 else f"gqa{h // h_kv}"
    return f"t{t}-d{d}-{'causal' if causal else 'full'}-{heads}"


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """2^e in f32 for integer e <= 127, 0 below 2^-126 (the kernels' pow2i)."""
    return torch.where(e < -126, torch.zeros((), dtype=torch.float32),
                       torch.ldexp(torch.ones(e.shape), e.float()))


def _ds_exponent(m: torch.Tensor) -> torch.Tensor:
    """The E that puts m * 2^E in [2^14, 2^15), at most DS_EXP_MAX (the
    kernels' ds_exponent, from m's f32 exponent field)."""
    field = (m.float().view(torch.int32) >> 23) & 0xFF
    return torch.clamp(141 - field, max=DS_EXP_MAX)


def _pack(ds: torch.Tensor, dtype, e: torch.Tensor, acc: torch.Tensor):
    """ds rounded to ``dtype`` as the kernels pack it: fp16 scaled by each
    row's 2^E (the last axis is the row's), E only falling, ``acc`` moved to
    the new E; returns (packed ds in f32, acc, e)."""
    if dtype != torch.float16:
        return ds.to(dtype).float(), acc, e
    e_new = torch.minimum(e, _ds_exponent(ds.abs().amax(-1, keepdim=True)))
    acc = acc * _pow2(e_new - e)
    return (ds * _pow2(e_new)).to(dtype).float(), acc, e_new


def _heads(x: torch.Tensor, rows: int, repeat: int = 1) -> torch.Tensor:
    """[B, T, heads, D] -> [B, heads * repeat, rows, D] f32, zeros past T."""
    x = x.float().permute(0, 2, 1, 3).repeat_interleave(repeat, dim=1)
    return F.pad(x, (0, 0, 0, rows - x.shape[2]))


def d256_dq(q, k, v, o, lse, do, causal: bool, fault: str = None):
    """(dq f32 [B, T, H, D], delta [B*H, T]) of K2 at Dp 256, in the
    kernel's order (the module docstring)."""
    b, t, h, d = q.shape
    g = h // k.shape[2]
    tp = -(-t // ROWS) * ROWS
    qh, doh, oh = (_heads(x, tp) for x in (q, do, o))
    kh, vh = (_heads(x, tp, g) for x in (k, v))
    lb = F.pad(lse.reshape(b, h, t), (0, tp - t), value=float("inf"))
    delta = (doh * oh).sum(-1)  # rows past T: 0
    scale = 1.0 / d ** 0.5
    n_t = -(-t // KEYS)
    dq = torch.zeros(b, h, tp, d)
    for r0 in range(0, tp, HALF):  # consumer c of block r0 // ROWS: rows r0 + [0, 64)
        if r0 >= t:
            continue  # every row of this consumer is past T
        n_c = min(n_t, (r0 + HALF) // KEYS) if causal else n_t
        if fault == "skip_last":
            n_c -= 1
        rows = torch.arange(r0, r0 + HALF)[:, None] + (1 if fault == "late_mask" else 0)
        acc = torch.zeros(b, h, HALF, d)
        e = torch.full((b, h, HALF, 1), DS_EXP_MAX, dtype=torch.int32)
        for j in range(n_c):
            keys = slice(j * KEYS, (j + 1) * KEYS)
            s = qh[:, :, r0:r0 + HALF] @ kh[:, :, keys].transpose(-1, -2)
            p = torch.exp(s * scale - lb[:, :, r0:r0 + HALF, None])
            if (causal and j == n_c - 1) or (j + 1) * KEYS > t:
                cols = torch.arange(j * KEYS, (j + 1) * KEYS)[None, :]
                p = p.masked_fill((cols >= t) | (causal & (cols > rows)), 0.0)
            dp = doh[:, :, r0:r0 + HALF] @ vh[:, :, keys].transpose(-1, -2)
            ds, acc, e = _pack(p * (dp - delta[:, :, r0:r0 + HALF, None]), q.dtype, e, acc)
            acc = acc + ds @ kh[:, :, keys]
        if q.dtype == torch.float16:
            acc = acc * _pow2(-e)
        dq[:, :, r0:r0 + HALF] = acc * scale
    return dq[:, :, :t].permute(0, 2, 1, 3), delta[:, :, :t].reshape(b * h, t)


def d256_dkv(q, k, v, lse, delta, do, causal: bool, fault: str = None):
    """dk, dv (f32, [B, T, H_kv, D]) of K3 at Dp 256, in the kernel's order
    (the module docstring); delta is K2's."""
    b, t, h, d = q.shape
    h_kv = k.shape[2]
    g = h // h_kv
    tp = -(-t // KEYS) * KEYS
    # q heads as [B, H_kv, group, rows, D]: head j * group + i is (j, i)
    qh, doh = (_heads(x, tp).reshape(b, h_kv, g, tp, d) for x in (q, do))
    kh, vh = (_heads(x, tp) for x in (k, v))
    lb = F.pad(lse.reshape(b, h_kv, g, t), (0, tp - t), value=float("inf"))
    dl = F.pad(delta.reshape(b, h_kv, g, t), (0, tp - t))
    scale = 1.0 / d ** 0.5
    n_q = tp // Q_TILE
    dk, dv = torch.zeros(b, h_kv, tp, d), torch.zeros(b, h_kv, tp, d)
    for k0 in range(0, tp, KEYS):
        kb, vb = kh[:, :, k0:k0 + KEYS], vh[:, :, k0:k0 + KEYS]
        keys = torch.arange(k0, k0 + KEYS)[:, None] - (1 if fault == "late_mask" else 0)
        first = k0 // Q_TILE if causal else 0
        last = n_q - (1 if fault == "skip_last" else 0)
        acc_k, acc_v = torch.zeros(b, h_kv, KEYS, d), torch.zeros(b, h_kv, KEYS, d)
        e = torch.full((b, h_kv, KEYS, 1), DS_EXP_MAX, dtype=torch.int32)
        for i in range(g):  # the group's heads, each from the diagonal on
            for q0 in range(first * Q_TILE, last * Q_TILE, Q_TILE):
                qb, dob = qh[:, :, i, q0:q0 + Q_TILE], doh[:, :, i, q0:q0 + Q_TILE]
                s = kb @ qb.transpose(-1, -2)  # [B, H_kv, keys, rows]
                if (causal and q0 == k0) or q0 + Q_TILE > t:
                    rows = torch.arange(q0, q0 + Q_TILE)[None, :]
                    s = s.masked_fill((rows >= t) | (causal & (keys > rows)), -float("inf"))
                p = torch.exp(s * scale - lb[:, :, i, None, q0:q0 + Q_TILE])
                acc_v = acc_v + p.to(q.dtype).float() @ dob
                dp = vb @ dob.transpose(-1, -2)
                ds, acc_k, e = _pack(p * (dp - dl[:, :, i, None, q0:q0 + Q_TILE]), q.dtype, e,
                                     acc_k)
                acc_k = acc_k + ds @ qb
        if q.dtype == torch.float16:
            acc_k = acc_k * _pow2(-e)
        dk[:, :, k0:k0 + KEYS] = acc_k * scale
        dv[:, :, k0:k0 + KEYS] = acc_v
    return tuple(x[:, :, :t].permute(0, 2, 1, 3) for x in (dk, dv))


def d256_backward(x: dict, causal: bool, fault: str = None):
    """(dq, dk, dv) in f32 of K2 and K3 at Dp 256 on ``x``'s tensors."""
    dq, delta = d256_dq(x["q"], x["k"], x["v"], x["o"], x["lse"], x["do"], causal, fault)
    return (dq, *d256_dkv(x["q"], x["k"], x["v"], x["lse"], delta, x["do"], causal, fault))


@functools.lru_cache(maxsize=None)
def _inputs(case: tuple, dtype_name: str):
    """q, k, v, do of the input type from a seed, JAX's interpret-mode o
    and lse ([B*H, T]) on them, and JAX's f32 dq, dk, dv (blocks of T / 2)."""
    t, d, causal, h, h_kv = case
    dtype, jdtype = DTYPES[dtype_name]
    rng = np.random.default_rng(4000 + t + d + 2 * causal + h + (dtype == torch.float16))
    q, do = (rng.standard_normal((1, t, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((1, t, h_kv, d)).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, block_q=t // 2, block_k=t // 2, interpret=True)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        jq, jk, jv, jdo = (jnp.asarray(a, dtype=jdtype) for a in (q, k, v, do))
        o, lse = jattn._flash_forward(jq, jk, jv, **kw)
        grads = jattn._flash_backward(jq, jk, jv, o, lse, jdo, grad_dtype=jnp.float32, **kw)
        o = np.array(o.astype(jnp.float32))
        lse = np.array(lse[:, :, 0])
        grads = [np.array(g) for g in grads]
    x = {n: torch.from_numpy(a).to(dtype) for n, a in (("q", q), ("k", k), ("v", v), ("do", do),
                                                        ("o", o))}
    x["lse"] = torch.from_numpy(lse)
    return x, [torch.from_numpy(g) for g in grads]


def _rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float((x.float() - ref.float()).norm() / ref.float().norm())


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_width_256_backward_order_matches_jax_and_plain(case, dtype_name):
    x, jax_grads = _inputs(case, dtype_name)
    causal = case[2]
    got = d256_backward(x, causal)
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
def test_width_256_backward_planted_faults_fall_outside_the_tolerance(fault, dtype_name):
    # causal at the ragged T 200 with a GQA group of 4: the mask one key late
    # and the skipped last tile each move every output past the tolerance
    case = (200, 256, True, 8, 2)
    x, jax_grads = _inputs(case, dtype_name)
    good = d256_backward(x, True)
    bad = d256_backward(x, True, fault)
    tol = UNIT_ROUNDOFF[x["q"].dtype]
    for name, g, b, jg in zip(("dq", "dk", "dv"), good, bad, jax_grads):
        assert _rel(g, jg) <= tol, name
        assert _rel(b, jg) > tol, (name, _rel(b, jg), tol)


def test_width_256_fp16_rows_keep_their_scale_exponents_falling():
    # the per-row 2^E of fp16's ds: a row whose ds grows is rescaled to a
    # smaller E, and the accumulator with it, by a power of two, so packing
    # a tile scaled and undoing the scale equals packing it at the final E
    acc = torch.ones(1, 2, 4)
    e = torch.full((1, 2, 1), DS_EXP_MAX, dtype=torch.int32)
    first = torch.tensor([[[1e-3, -2e-3, 0.0, 5e-4], [0.0, 0.0, 0.0, 0.0]]])
    ds, acc, e = _pack(first, torch.float16, e, acc)
    assert e[0, 0, 0] == 141 - 118 and e[0, 1, 0] == DS_EXP_MAX  # 2e-3 has exponent field 118
    assert 2.0 ** 14 <= float(ds[0, 0].abs().max()) < 2.0 ** 15
    second = torch.tensor([[[4.0, 1.0, 0.0, 0.0], [1e-8, 0.0, 0.0, 0.0]]])
    ds2, acc2, e2 = _pack(second, torch.float16, e, acc)
    assert e2[0, 0, 0] == 141 - 129 and e2[0, 1, 0] == 141 - 100
    assert torch.equal(acc2[0, 0], acc[0, 0] * 2.0 ** (int(e2[0, 0, 0]) - int(e[0, 0, 0])))
    assert float(ds2[0, 0, 0]) * 2.0 ** -int(e2[0, 0, 0]) == 4.0
