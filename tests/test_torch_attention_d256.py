"""The arithmetic of the card's K1 at the padded width 256
(``csrc/flash_fwd.cu`` ``flash_fwd_kernel_d256``, 16-bit inputs at
128 < D <= 256), emulated on the CPU in the kernel's order and held to the
JAX package's ``_flash_forward`` (Pallas in interpret mode) and to the
port's plain forward on the same bf16 inputs.

The kernel takes 128 q rows a block as two consumers of 64 rows, each with
all 256 columns of o, over 64-key K/V tiles zero-filled past T (and past D,
which leaves the scores as they are). Per tile a consumer forms each score
once in f32, scaled by 1/sqrt(D); only its last tile is masked (causal: its
diagonal tile, the last it reads; else the tile that holds T), keys past T
at -inf and causal keys past the row at NEG_INF; then the online softmax
(m_safe clamp, corr, l from the f32 p) and o = o corr + p v with p rounded to
the input type; a consumer whose rows are all past T does nothing. The
tests hold o within one bf16 rounding (1e-2, the limit
``tests/test_torch_attention.py`` puts on the plain bf16 forward, and a
bf16 ulp of |o| past it) and lse within 1e-4, at D 136 and 256, causal and
not, MQA, T 128 and a ragged T 200 (JAX's blocks of T / 2 tile both), and
at T 150, where the last block's second consumer has no row.
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

ROWS = 128  # q rows a block: two consumers of 64
HALF = 64
KEYS = 64  # keys a K/V tile
# o one bf16 rounding apart: 1e-2 (``tests/test_torch_attention.py``'s limit
# on the plain bf16 forward), and past it a bf16 ulp of |o| (2^-7): the
# kernel rounds p to bf16 and JAX does not, so an o of 2 or more may round
# one ulp (2^-6) away
O_ATOL, O_RTOL = 1e-2, 2.0 ** -7
LSE_ATOL = 1e-4
CASES = [pytest.param(t, d, causal, id=f"t{t}-d{d}-{'causal' if causal else 'full'}")
         for t in (128, 200) for d in (136, 256) for causal in (True, False)] + [
    pytest.param(150, 256, True, id="t150-d256-causal")]


def d256_forward(q, k, v, causal: bool):
    """o (q's dtype) and lse [B*H, T] of K1 at Dp 256, in the kernel's
    order (the module docstring)."""
    b, t, h, d = q.shape
    g = h // k.shape[2]
    tp = -(-t // ROWS) * ROWS

    def pad(x):  # [B, T, heads, D] -> [B, heads, tp, D] f32, zeros past T
        x = x.float().permute(0, 2, 1, 3)
        return torch.nn.functional.pad(x, (0, 0, 0, tp - t))

    qh = pad(q)
    kh, vh = (pad(x).repeat_interleave(g, dim=1) for x in (k, v))
    scale = 1.0 / d ** 0.5
    n_t = -(-t // KEYS)
    o = torch.zeros(b, h, tp, d)
    lse = torch.zeros(b, h, tp)
    for q_tile in range(tp // ROWS):
        for c in range(2):
            r0 = q_tile * ROWS + HALF * c
            if r0 >= t:
                continue  # every row of this consumer is past T
            n_c = min(n_t, 2 * q_tile + c + 1) if causal else n_t
            rows = torch.arange(r0, r0 + HALF)[:, None]
            m = torch.full((b, h, HALF, 1), tattn.NEG_INF)
            l = torch.zeros(b, h, HALF, 1)
            acc = torch.zeros(b, h, HALF, d)
            for j in range(n_c):
                keys = slice(j * KEYS, (j + 1) * KEYS)
                s = qh[:, :, r0:r0 + HALF] @ kh[:, :, keys].transpose(-1, -2) * scale
                if j == n_c - 1:
                    cols = torch.arange(j * KEYS, (j + 1) * KEYS)[None, :]
                    s = s.masked_fill(cols >= t, -float("inf"))
                    if causal:
                        s = s.masked_fill((cols < t) & (cols > rows), tattn.NEG_INF)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                m_safe = torch.clamp(m_new, min=tattn._CLAMP)
                corr = torch.exp(torch.clamp(m, min=tattn._CLAMP) - m_safe)
                p = torch.exp(s - m_safe)
                l = l * corr + p.sum(-1, keepdim=True)
                acc = acc * corr + p.to(q.dtype).float() @ vh[:, :, keys]
                m = m_new
            l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
            o[:, :, r0:r0 + HALF] = acc / l_safe
            lse[:, :, r0:r0 + HALF] = (torch.clamp(m, min=tattn._CLAMP) + torch.log(l_safe))[..., 0]
    return o[:, :, :t].permute(0, 2, 1, 3).to(q.dtype), lse[:, :, :t].reshape(b * h, t)


@functools.lru_cache(maxsize=None)
def _inputs(t: int, d: int, causal: bool):
    """bf16 q, k, v from a seed (MQA: 2 q heads on one kv head), and JAX's
    interpret-mode o and lse ([B*H, T]) on them (blocks of T / 2)."""
    rng = np.random.default_rng(3000 + t + d + causal)
    b, h = 1, 2
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, t, 1, d)).astype(np.float32) for _ in range(2))
    block = t // 2
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        o, lse = jattn._flash_forward(*(jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v)),
                                      causal=causal, block_q=block, block_k=block,
                                      interpret=True)
    x = {n: torch.from_numpy(a).to(torch.bfloat16) for n, a in (("q", q), ("k", k), ("v", v))}
    return x, np.asarray(o.astype(jnp.float32)), np.asarray(lse)[:, :, 0]


@pytest.mark.parametrize("t, d, causal", CASES)
def test_width_256_forward_order_matches_jax_and_plain(t, d, causal):
    x, jax_o, jax_lse = _inputs(t, d, causal)
    o, lse = d256_forward(x["q"], x["k"], x["v"], causal)
    plain_o, plain_lse = tattn.flash_attention_plain(x["q"], x["k"], x["v"], causal=causal)
    assert o.dtype == torch.bfloat16 and lse.shape == (2, t)
    for ref_o, ref_lse in ((jax_o, jax_lse), (plain_o.float().numpy(), plain_lse.numpy())):
        np.testing.assert_allclose(o.float().numpy(), ref_o, atol=O_ATOL, rtol=O_RTOL)
        np.testing.assert_allclose(lse.numpy(), ref_lse, atol=LSE_ATOL, rtol=0)
