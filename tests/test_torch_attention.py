"""The port's attention (hivedscheduler_tpu_torch.ops.attention) against
the JAX package's on the same inputs.

The plain version of the flash forward kernel is held to the JAX kernel
``_flash_forward`` run in Pallas interpret mode, in f32 at atol 2e-5 (the
bound tests/test_parallel.py holds the JAX kernel to): both compute the
same online softmax, and at these sizes f32 rounding differs by ~1e-6.
Inputs are made with numpy from a seed and handed to both as numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.ops import attention as jattn
from hivedscheduler_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

ATOL = 2e-5


def _qkv(seed, b, t, h, h_kv, d, t_k=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d), dtype=np.float32)
    k = rng.standard_normal((b, t_k or t, h_kv, d), dtype=np.float32)
    v = rng.standard_normal((b, t_k or t, h_kv, d), dtype=np.float32)
    return q, k, v


def _jax_flash_forward(q, k, v, causal, block_q, block_k):
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        o, lse = jattn._flash_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            block_q=block_q, block_k=block_k, interpret=True)
    return np.asarray(o), np.asarray(lse)


# head dims of the kernels' cases: 32, and D = 80 and 96 (Phi-2's and
# Phi-3-mini's), which the card's kernels run at their padded width 128
HEAD_DIMS = [32, 80, 96]
# head dims past 128, which the card's kernels run at their padded width 256:
# 136 and 192, and Gemma's 256
WIDE_HEAD_DIMS = [136, 192, 256]


# (h_kv, causal, d, t, block_q, block_k): HEAD_DIMS at T=256 over blocks
# 128/64 with each head grouping, ids ``h_kv-causal-d``; WIDE_HEAD_DIMS with
# MQA at T=128 over blocks of 64 (two q and two k blocks: the diagonal and
# the skipped block above it)
KERNEL_CASES = [pytest.param(h_kv, causal, d, 256, 128, 64, id=f"{h_kv}-{causal}-{d}")
                for h_kv in (4, 2, 1) for causal in (True, False) for d in HEAD_DIMS] + [
    pytest.param(1, causal, d, 128, 64, 64, id=f"1-{causal}-{d}")
    for causal in (True, False) for d in WIDE_HEAD_DIMS]


@pytest.mark.parametrize("h_kv, causal, d, t, block_q, block_k", KERNEL_CASES)
def test_plain_flash_matches_jax_kernel(causal, h_kv, d, t, block_q, block_k):
    # T=256 over blocks 128/64: two q blocks, four k blocks, so the causal
    # diagonal block and the skipped blocks above it are both exercised
    q, k, v = _qkv(0, 1, t, 4, h_kv, d)
    o_ref, lse_ref = _jax_flash_forward(q, k, v, causal, block_q, block_k)
    o, lse = tattn.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    assert o.shape == (1, t, 4, d) and o.dtype == torch.float32
    assert lse.shape == (4, t) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), o_ref, atol=ATOL)
    # the TPU kernel stores lse 128 lanes wide, every lane equal
    np.testing.assert_allclose(lse.numpy(), lse_ref[..., 0], atol=ATOL)


def test_plain_flash_batch_and_heads_layout():
    # B=2 with GQA: lse rows are ordered b*H + h, as the kernel writes them
    q, k, v = _qkv(1, 2, 128, 4, 2, 16)
    o_ref, lse_ref = _jax_flash_forward(q, k, v, True, 128, 128)
    o, lse = tattn.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(o.numpy(), o_ref, atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref[..., 0], atol=ATOL)


def test_plain_flash_keeps_bf16_output_dtype():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(2, 1, 64, 2, 1, 16))
    o, lse = tattn.flash_attention_plain(q, k, v)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref = tattn.xla_attention(q, k, v)
    # both compute in f32 from the same bf16 inputs; the outputs differ by
    # at most one bf16 rounding
    np.testing.assert_allclose(o.float().numpy(), ref.float().numpy(),
                               atol=1e-2)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h_kv", [4, 2, 1])
def test_xla_attention_matches_jax(causal, h_kv):
    q, k, v = _qkv(3, 2, 48, 4, h_kv, 16)
    ref = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal)
    out = tattn.xla_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_xla_attention_cross_length_matches_jax():
    # decode-shaped call: fewer queries than keys, causal from position 0
    q, k, v = _qkv(4, 1, 8, 4, 2, 16, t_k=24)
    ref = jattn.xla_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = tattn.xla_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


# (shape of q, kv heads, k length or None, block_q, block_k): each either
# tiles (kernel) or hits one of the reference's fallback rules
ROUTE_CASES = {
    "tiles": ((1, 128, 2, 16), 2, None, 64, 64),
    "t_not_div_block_q": ((1, 96, 2, 16), 2, None, 64, 32),
    "t_not_div_block_k": ((1, 96, 2, 16), 2, None, 32, 64),
    "d_not_mult_8": ((1, 64, 2, 12), 2, None, 64, 64),
    "cross_length_k": ((1, 64, 2, 16), 1, 128, 64, 64),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_flash_route_matches_jax_choice(case, monkeypatch):
    shape, h_kv, t_k, bq, bk = ROUTE_CASES[case]
    b, t, h, d = shape
    q, k, v = _qkv(5, b, t, h, h_kv, d, t_k=t_k)

    jax_routes = []
    real = jattn.xla_attention

    def counting(*a, **kw):
        jax_routes.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(jattn, "xla_attention", counting)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        ref = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=True, block_q=bq,
                                    block_k=bk, interpret=True)
    before = tattn.FLASH_REFERENCE_ROUTES
    out = tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=True,
                                block_q=bq, block_k=bk)
    assert tattn.FLASH_REFERENCE_ROUTES - before == len(jax_routes)
    assert len(jax_routes) == (0 if case == "tiles" else 1)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_flash_indivisible_gqa_raises_like_jax():
    q, k, v = _qkv(6, 1, 64, 3, 2, 16)
    with pytest.raises(ValueError) as jax_err:
        jattn.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              block_q=64, block_k=64, interpret=True)
    with pytest.raises(ValueError) as port_err:
        tattn.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), block_q=64, block_k=64)
    assert "GQA needs n_heads divisible" in str(jax_err.value)
    assert "GQA needs n_heads divisible" in str(port_err.value)


def test_plain_flash_uniform_scores_closed_form():
    # zero q and k: every visible score is 0, so row r averages its r + 1
    # visible values and lse = log(r + 1); masked keys add nothing
    q = torch.zeros((1, 4, 1, 8))
    k = torch.zeros((1, 4, 1, 8))
    v = torch.ones((1, 4, 1, 8))
    o, lse = tattn.flash_attention_plain(q, k, v, causal=True)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(o.numpy(), np.ones((1, 4, 1, 8)), atol=1e-6)
    np.testing.assert_allclose(lse.numpy()[0], np.log(np.arange(1, 5)),
                               atol=1e-6)


def test_cpu_flash_forward_takes_plain_version_and_launches_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(7, 1, 64, 2, 1, 16))
    before = tattn.FLASH_FWD_LAUNCHES
    o, lse = tattn.flash_forward(q, k, v, causal=True)
    o_plain, lse_plain = tattn.flash_attention_plain(q, k, v, causal=True)
    assert tattn.FLASH_FWD_LAUNCHES == before
    assert torch.equal(o, o_plain) and torch.equal(lse, lse_plain)


def test_flash_forward_refuses_other_devices():
    q = torch.empty((1, 64, 2, 16), device="meta")
    with pytest.raises(ValueError) as err:
        tattn.flash_forward(q, q, q)
    assert "cuda or cpu" in str(err.value)


def test_flash_attention_off_the_cpu_never_takes_the_reference():
    # T=96 tiles by neither block: on the CPU that is the reference route,
    # off it the kernel's wrapper decides (and refuses a meta tensor)
    q = torch.empty((1, 96, 2, 16), device="meta")
    before = tattn.FLASH_REFERENCE_ROUTES
    with pytest.raises(ValueError) as err:
        tattn.flash_attention(q, q, q, block_q=64, block_k=64)
    assert "cuda or cpu" in str(err.value)
    assert tattn.FLASH_REFERENCE_ROUTES == before


@pytest.mark.parametrize("case", ["d_not_mult_8", "cross_length_k"])
def test_flash_attention_off_the_cpu_takes_the_reference_where_jax_does(case, monkeypatch):
    # JAX's flash_attention returns xla_attention for these shapes on every
    # backend, before any kernel: so does the port off the CPU (a meta
    # tensor stands in for a CUDA one), counted, and no kernel is reached
    shape, h_kv, t_k, bq, bk = ROUTE_CASES[case]
    b, t, h, d = shape
    q = torch.empty(shape, device="meta")
    k = torch.empty((b, t_k or t, h_kv, d), device="meta")
    monkeypatch.setattr(tattn.FlashAttention, "apply", staticmethod(
        lambda *a: pytest.fail("the kernels' op was reached")))
    before = tattn.FLASH_REFERENCE_ROUTES
    out = tattn.flash_attention(q, k, k, block_q=bq, block_k=bk)
    assert tattn.FLASH_REFERENCE_ROUTES == before + 1
    assert out.shape == shape and out.device.type == "meta"
    # JAX's choice on the same shapes
    jax_routes = []
    real = jattn.xla_attention
    monkeypatch.setattr(jattn, "xla_attention",
                        lambda *a, **kw: jax_routes.append(1) or real(*a, **kw))
    qj, kj, _ = _qkv(5, b, t, h, h_kv, d, t_k=t_k)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        jattn.flash_attention(jnp.asarray(qj), jnp.asarray(kj), jnp.asarray(kj),
                              block_q=bq, block_k=bk, interpret=True)
    assert jax_routes == [1]


def test_head_dims_the_kernels_take():
    # every multiple of 8 up to 256, each run at the padded width 64, 128 or
    # 256
    assert tattn.KERNEL_HEAD_DIMS == tuple(range(8, 257, 8))
    assert {32, 80, 96, 112, 136, 192, 256} <= set(tattn.KERNEL_HEAD_DIMS)
    assert not {12, 264} & set(tattn.KERNEL_HEAD_DIMS)


@pytest.mark.parametrize("d, route", [(256, "kernel"), (264, "refused")])
def test_head_dim_route_off_the_cpu(d, route, monkeypatch):
    # a meta tensor stands in for a CUDA one: D = 256 (Gemma's) goes to the
    # kernels' op, D = 264 is past the widest template and the kernels'
    # wrapper refuses it, with no fallback to the plain versions or the
    # reference
    q = torch.empty((1, 128, 8, d), device="meta", dtype=torch.bfloat16)
    k = torch.empty((1, 128, 1, d), device="meta", dtype=torch.bfloat16)
    routes = tattn.FLASH_REFERENCE_ROUTES
    if route == "kernel":
        reached = []
        monkeypatch.setattr(tattn.FlashAttention, "apply", staticmethod(
            lambda *a: reached.append(a[0].shape) or a[0]))
        tattn.flash_attention(q, k, k, block_q=64, block_k=64)
        assert reached == [q.shape]
    else:
        with pytest.raises(ValueError) as err:
            tattn._check_kernel_inputs(q, k, k)
        assert "multiples of 8 up to 256" in str(err.value)
    assert tattn.FLASH_REFERENCE_ROUTES == routes


def test_flagship_bound_counts():
    # the numbers the kernel's source note and PERF.md state
    flops = tattn.attention_flops(8, 2048, 16, 128, causal=True)
    nbytes = tattn.attention_bytes(8, 2048, 16, 8, 128)
    assert flops == 4 * 8 * 16 * 128 * (2048 * 2049 // 2)
    assert round(flops / 1e9, 1) == 137.5
    assert round(nbytes / 1e6) == 202
    assert round(flops / 989e12 * 1e3, 3) == 0.139


# -- backward ----------------------------------------------------------------
# The plain backward and autograd through the port's flash_attention are
# held to the JAX kernels at atol 3e-5, the bound tests/test_parallel.py
# holds the JAX flash gradients to: both are f32 over T=256 and differ by
# summation order only.
GRAD_ATOL = 3e-5


def _jax_flash_backward(q, k, v, do, causal, block_q, block_k):
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        kw = dict(causal=causal, block_q=block_q, block_k=block_k, interpret=True)
        o, lse = jattn._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
        grads = jattn._flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      o, lse, jnp.asarray(do), **kw)
    return np.array(o), np.array(lse[..., 0]), [np.array(g) for g in grads]


@pytest.mark.parametrize("h_kv, causal, d, t, block_q, block_k", KERNEL_CASES)
def test_plain_backward_matches_jax_kernels(causal, h_kv, d, t, block_q, block_k):
    # T=256 over blocks 128/64: the dq kernel walks k blocks up to the
    # diagonal, the dk/dv kernel q blocks from it, and GQA sums the group
    q, k, v = _qkv(10, 1, t, 4, h_kv, d)
    do = np.random.default_rng(11).standard_normal(q.shape, dtype=np.float32)
    o, lse, want = _jax_flash_backward(q, k, v, do, causal, block_q, block_k)
    got = tattn.flash_backward_plain(
        *(torch.from_numpy(x) for x in (q, k, v, o, lse, do)), causal=causal)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, err_msg=name)


def test_plain_backward_batch_layout_and_bf16_dtypes():
    # B=2: lse rows are b*H + h; bf16 inputs give bf16 gradients
    q, k, v = _qkv(12, 2, 128, 4, 2, 16)
    do = np.random.default_rng(13).standard_normal(q.shape, dtype=np.float32)
    o, lse, want = _jax_flash_backward(q, k, v, do, True, 128, 128)
    got = tattn.flash_backward_plain(
        *(torch.from_numpy(x) for x in (q, k, v, o, lse, do)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, o)]
    grads = tattn.flash_backward_plain(*bf, torch.from_numpy(lse),
                                       torch.from_numpy(do).to(torch.bfloat16))
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3


def _sin_loss_grads(fn, q, k, v):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    loss = torch.sin(fn(qt, kt, vt)).sum()
    return [g.numpy() for g in torch.autograd.grad(loss, (qt, kt, vt))]


@pytest.mark.parametrize("d", [16] + HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h_kv", [4, 1])
def test_flash_attention_grads_match_jax_grad(causal, h_kv, d):
    q, k, v = _qkv(14, 1, 256, 4, h_kv, d)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        want = jax.grad(
            lambda q, k, v: jnp.sum(jnp.sin(jattn.flash_attention(
                q, k, v, causal=causal, block_q=128, block_k=64, interpret=True))),
            argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    before = tattn.FLASH_REFERENCE_ROUTES
    got = _sin_loss_grads(lambda q, k, v: tattn.flash_attention(
        q, k, v, causal=causal, block_q=128, block_k=64), q, k, v)
    assert tattn.FLASH_REFERENCE_ROUTES == before  # the plain kernels ran
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, np.asarray(w), atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h_kv", [4, 2, 1])
def test_flash_attention_grads_match_xla_attention(causal, h_kv):
    q, k, v = _qkv(15, 2, 128, 4, h_kv, 16)
    got = _sin_loss_grads(lambda q, k, v: tattn.flash_attention(
        q, k, v, causal=causal, block_q=64, block_k=64), q, k, v)
    want = _sin_loss_grads(lambda q, k, v: tattn.xla_attention(
        q, k, v, causal=causal), q, k, v)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, w, atol=GRAD_ATOL, err_msg=name)


def test_reference_route_is_differentiable_too():
    # T=96 does not tile by 64: the reference's einsums carry the gradient
    q, k, v = _qkv(16, 1, 96, 2, 1, 16)
    before = tattn.FLASH_REFERENCE_ROUTES
    got = _sin_loss_grads(lambda q, k, v: tattn.flash_attention(
        q, k, v, block_q=64, block_k=64), q, k, v)
    assert tattn.FLASH_REFERENCE_ROUTES == before + 1
    want = _sin_loss_grads(tattn.xla_attention, q, k, v)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-6)


def test_cpu_flash_backward_takes_plain_version_and_launches_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(17, 1, 64, 2, 1, 16))
    do = torch.from_numpy(np.random.default_rng(18).standard_normal(
        tuple(q.shape), dtype=np.float32))
    o, lse = tattn.flash_forward(q, k, v)
    launches = (tattn.FLASH_BWD_DQ_LAUNCHES, tattn.FLASH_BWD_DKV_LAUNCHES)
    got = tattn.flash_backward(q, k, v, o, lse, do)
    want = tattn.flash_backward_plain(q, k, v, o, lse, do)
    assert (tattn.FLASH_BWD_DQ_LAUNCHES, tattn.FLASH_BWD_DKV_LAUNCHES) == launches
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError) as err:
        tattn.flash_backward(*(x.to("meta") for x in (q, k, v, o, lse, do)))
    assert "cuda or cpu" in str(err.value)


def test_flash_attention_under_inference_mode_records_nothing():
    q, k, v = (torch.from_numpy(x) for x in _qkv(19, 1, 64, 2, 1, 16))
    with torch.inference_mode():
        o = tattn.flash_attention(q, k, v, block_q=64, block_k=64)
    assert not o.requires_grad and o.grad_fn is None
    np.testing.assert_array_equal(o.numpy(), tattn.flash_attention_plain(q, k, v)[0].numpy())


def test_non_contiguous_output_gradient_is_read_as_is():
    # autograd may hand the backward a transposed or expanded gradient
    q, k, v = (torch.from_numpy(x) for x in _qkv(20, 1, 64, 2, 2, 16))
    o, lse = tattn.flash_forward(q, k, v)
    do = torch.ones((1, 1, 1, 1)).expand(1, 64, 2, 16)
    got = tattn.flash_backward(q, k, v, o, lse, do)
    want = tattn.flash_backward_plain(q, k, v, o, lse, do.contiguous())
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert tattn._kernel_readable(do) is not do  # the kernels would get a copy
    assert tattn._kernel_readable(q) is q


def test_zero_stride_output_gradient_is_copied_for_the_kernels():
    # D contiguous but broadcast over B, T and H: a TMA tensor map needs every
    # stride positive, so the kernels get a copy
    do = torch.ones((1, 1, 1, 16)).expand(2, 64, 2, 16)
    assert do.stride() == (0, 0, 0, 1)
    copied = tattn._kernel_readable(do)
    assert copied is not do and copied.is_contiguous() and torch.equal(copied, do)
    strided = torch.ones((2, 2, 64, 16)).transpose(1, 2)  # [B, T, H, D] of [B, H, T, D]
    assert tattn._kernel_readable(strided) is strided


def test_flagship_backward_bound_counts():
    # the numbers the kernels' source note and PERF.md state
    flops = tattn.attention_bwd_flops(8, 2048, 16, 128, causal=True)
    nbytes = tattn.attention_bwd_bytes(8, 2048, 16, 8, 128)
    assert {k: round(v / 1e9, 1) for k, v in flops.items()} == {
        "dq": 206.3, "dkv": 275.0, "least": 343.8}
    assert flops["dq"] == 3 * tattn.attention_flops(8, 2048, 16, 128, True) // 2
    assert {k: round(v / 1e6, 1) for k, v in nbytes.items()} == {"dq": 337.6, "dkv": 270.5}
    assert round(flops["dq"] / 989e12 * 1e3, 4) == 0.2086
    assert round(flops["dkv"] / 989e12 * 1e3, 4) == 0.2781
