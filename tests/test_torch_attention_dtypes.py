"""The port's flash attention at every input dtype and head dim the JAX
package's kernels take: fp16 and f32 inputs, and D past 256, against the
JAX package on the same inputs.

On the CPU the port's wrappers run the plain versions of their kernels
(the card runs the fp16 wgmma kernels and the f32 CUDA-core family, held to
the same plain versions by ``chip_smoke.py`` [x]); the JAX package runs its
Pallas kernels in interpret mode (``block_q = block_k = 64``, so that T =
128 tiles and JAX takes its kernel, not ``xla_attention``: asserted).

Tolerances, as max |port - JAX| over max |JAX|:
- f32: 1e-5. Both compute in f32 and differ by summation order only
  (observed up to 1.6e-6).
- fp16: 2^-10, one fp16 ulp of the largest element. Both compute in f32
  and round once to fp16, so an element differs by at most the one ulp an
  f32 rounding difference can flip (observed up to 9.4e-4).
The models (2 layers, f32 master weights carried by ``bridge.py``): f32
logits 1e-4 and train steps as ``tests/test_torch_head_dims.py`` holds them
(losses 1e-5, parameters 3e-5 save AdamW's near-zero first gradients);
fp16 logits 2.5e-2 absolute (logits near 4.4, whose fp16 ulp is 3.9e-3,
after two layers whose matmuls and residual adds each framework rounds to
fp16 at its own points: observed 6.3e-3), fp16 losses 1e-3 (observed
1.3e-4). The first step's gradients, leaf by leaf, relative Frobenius:
f32 1e-5 (observed up to 3.5e-6), fp16 5e-3 (observed up to 1.8e-3; dv
scaled by 0.97 in the attention backward reads 3.8e-2 in wv and 7e-3 in
wq). The fp16 parameters after the steps are held only within 2 lr x
steps, the most two AdamW runs can part, which proves little: AdamW's
first steps turn a small gradient's sign into a whole step (observed
1.0e-3 of 1.2e-3). The gradients are what hold the fp16 backward.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.chaos import workload as jchaos
from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu.ops import attention as jattn
from hivedscheduler_tpu.parallel import ring_attention as jring
from hivedscheduler_tpu.parallel import topology
from hivedscheduler_tpu.parallel import train as jtrain
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch import eval as teval
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.ops import attention as tattn
from hivedscheduler_tpu_torch.parallel import checkpoint as tckpt
from hivedscheduler_tpu_torch.parallel import ring_attention as tring
from hivedscheduler_tpu_torch.parallel import train as ttrain

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = {"f32": 1e-5, "fp16": 2.0 ** -10}
DTYPES = {"f32": (np.float32, torch.float32, jnp.float32),
          "fp16": (np.float16, torch.float16, jnp.float16)}
LOGIT_ATOL = {"f32": 1e-4, "fp16": 2.5e-2}
LOSS_ATOL = {"f32": 1e-5, "fp16": 1e-3}
GRAD_REL = {"f32": 1e-5, "fp16": 5e-3}  # a leaf's first-step gradient
PARAM_ATOL = 3e-5
ADAMW_EPS, ADAMW_LR = 1e-8, 3e-4


def _rel(got, ref) -> float:
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def _count_jax_reference(monkeypatch):
    routes = []
    real = jattn.xla_attention
    monkeypatch.setattr(jattn, "xla_attention",
                        lambda *a, **kw: routes.append(1) or real(*a, **kw))
    return routes


def _cpu():
    return jax.default_device(jax.local_devices(backend="cpu")[0])


# -- the kernels: forward and all three gradients ------------------------------

# D 64 (the wgmma kernels' widths on the card) and 264, 320, 512 (past 256:
# the CUDA-core family), with GQA (4 q heads on 2 kv heads), causal and not
KERNEL_CASES = [pytest.param(dt, d, causal, id=f"{dt}-{d}-{causal}")
                for dt in DTYPES for d in (64, 264, 320, 512) for causal in (True, False)]


@pytest.mark.parametrize("dt, d, causal", KERNEL_CASES)
def test_flash_attention_matches_jax_kernel(dt, d, causal, monkeypatch):
    np_dt, t_dt, _ = DTYPES[dt]
    rng = np.random.default_rng(d)
    q = rng.standard_normal((1, 128, 4, d)).astype(np_dt)
    k = rng.standard_normal((1, 128, 2, d)).astype(np_dt)
    v = rng.standard_normal((1, 128, 2, d)).astype(np_dt)
    w = rng.standard_normal((1, 128, 4, d)).astype(np.float32)  # the loss's weights
    routes = _count_jax_reference(monkeypatch)

    def loss(q, k, v):
        o = jattn.flash_attention(q, k, v, causal=causal, block_q=64, block_k=64,
                                  interpret=True)
        return jnp.sum(o.astype(jnp.float32) * w), o

    with _cpu():
        (_, o_ref), g_ref = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    assert routes == []  # JAX took its Pallas kernels
    before = tattn.FLASH_REFERENCE_ROUTES
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    o = tattn.flash_attention(qt, kt, vt, causal=causal, block_q=64, block_k=64)
    (o.float() * torch.from_numpy(w)).sum().backward()
    assert tattn.FLASH_REFERENCE_ROUTES == before  # and the port its kernels' plain versions
    assert o.dtype == t_dt and qt.grad.dtype == t_dt and kt.grad.dtype == t_dt
    assert _rel(o.detach().numpy(), o_ref) <= REL[dt]
    for name, got, ref in zip(("dq", "dk", "dv"), (qt.grad, kt.grad, vt.grad), g_ref):
        assert np.asarray(ref).dtype == np_dt
        assert _rel(got.numpy(), ref) <= REL[dt], name


# -- the route table -------------------------------------------------------------

STEMS = {"fwd": "hived_flash_fwd", "dq": "hived_flash_bwd_dq", "dkv": "hived_flash_bwd_dkv"}


@pytest.mark.parametrize("dtype, suffix", [(torch.bfloat16, ""), (torch.float16, "_f16")],
                         ids=["bf16", "fp16"])
@pytest.mark.parametrize("d", [8, 64, 96, 128, 136, 256])
def test_kernel_entry_takes_the_wgmma_kernels_up_to_256(dtype, suffix, d):
    for kernel, stem in STEMS.items():
        assert tattn.kernel_entry(dtype, d, False, kernel) == stem + suffix
        assert tattn.kernel_entry(dtype, d, True, kernel) == stem + suffix + "_f32"
        for out_f32 in (False, True):
            symbol = stem + suffix + ("_f32" if out_f32 else "")
            # the fp16 forms live in libraries of their own (flash_*_f16.cu)
            assert tattn._KERNELS[symbol][0] == (
                ("flash_fwd" if kernel == "fwd" else "flash_bwd") + suffix)
            # their C entry points take the bf16 ones' arguments
            assert tattn._KERNELS[symbol][1:] == tattn._KERNELS[stem][1:]
            assert tattn.launch_dims(symbol, (1, 2, 3, 4, d, 1), dtype, out_f32) == (
                1, 2, 3, 4, d, 1)
    assert tattn.kernel_entry(dtype, d, False) == "hived_flash_fwd" + suffix


@pytest.mark.parametrize("dtype, d", [
    (torch.float32, 8), (torch.float32, 128), (torch.float32, 256), (torch.float32, 264),
    (torch.float32, 1024), (torch.bfloat16, 264), (torch.bfloat16, 512),
    (torch.float16, 320), (torch.float16, 1024), (torch.bfloat16, 1032),
    (torch.float16, 1032), (torch.float32, 1032)])
def test_kernel_entry_takes_the_cuda_core_family(dtype, d):
    # K1-K3 past D 1024 at every input dtype (the cluster kernels' limit);
    # up to it, f32 K1-K3 run on the 3xTF32 kernels up to D 128 and on their
    # cluster form past it, and at 16-bit inputs past 256 all three take the
    # cluster kernels; every one of them with the same arguments
    code = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}[dtype]
    core = d > 1024
    for kernel, stem in STEMS.items():
        lib = "flash_fwd_wide" if kernel == "fwd" else "flash_bwd_wide"
        tf32 = dtype == torch.float32 and d <= 128
        tf32_wide = dtype == torch.float32 and 128 < d <= 1024
        for out_f32 in (False, True):
            symbol = tattn.kernel_entry(dtype, d, out_f32, kernel)
            generic = stem.replace("hived_flash", "hived_flash_generic")
            if tf32:
                assert symbol == stem.replace("hived_flash", "hived_flash_tf32")
                assert tattn._KERNELS[symbol][0] == (
                    "flash_fwd_tf32" if kernel == "fwd" else "flash_bwd_tf32")
            elif tf32_wide:
                assert symbol == stem.replace("hived_flash", "hived_flash_tf32_wide")
                assert tattn._KERNELS[symbol][0] == (
                    "flash_fwd_tf32_wide" if kernel == "fwd" else "flash_bwd_tf32_wide")
            else:
                assert symbol == (generic if core else
                                  stem.replace("hived_flash", "hived_flash_wide"))
                assert tattn._KERNELS[symbol][0] == ("flash_generic" if core else lib)
            assert tattn._KERNELS[symbol][1:] == tattn._KERNELS[generic][1:]
            # the dims, then the input- and output-type codes: f32 out is 2
            assert tattn.launch_dims(symbol, (1, 2, 3, 4, d, 0), dtype, out_f32) == (
                1, 2, 3, 4, d, 0, code, 2 if out_f32 else code)
            assert tattn._KERNELS[symbol][2] == 8


@pytest.mark.parametrize("out_f32", [False, True], ids=["in-dtype", "f32-out"])
@pytest.mark.parametrize("d", [264, 320, 512, 1024])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
def test_kernel_entry_takes_the_wide_backward(dtype, d, out_f32):
    # K1, K2 and K3 at 16-bit inputs past 256 up to 1024: the cluster
    # kernels (K1 csrc/flash_fwd_wide.cu, K2 and K3 csrc/flash_bwd_wide.cu),
    # one symbol each for every input and output type, type codes after the
    # dims as the CUDA-core family's
    code = {torch.bfloat16: 0, torch.float16: 1}[dtype]
    for kernel, entry in (("fwd", ("flash_fwd_wide", 5, 8, 12)),
                          ("dq", ("flash_bwd_wide", 8, 8, 18)),
                          ("dkv", ("flash_bwd_wide", 8, 8, 18))):
        symbol = tattn.kernel_entry(dtype, d, out_f32, kernel)
        assert symbol == STEMS[kernel].replace("hived_flash", "hived_flash_wide")
        assert tattn._KERNELS[symbol] == entry
        assert tattn._KERNELS[symbol][1:] == tattn._KERNELS[
            STEMS[kernel].replace("hived_flash", "hived_flash_generic")][1:]
        assert tattn.launch_dims(symbol, (1, 2, 3, 4, d, 1), dtype, out_f32) == (
            1, 2, 3, 4, d, 1, code, 2 if out_f32 else code)
    assert tattn.kernel_entry(dtype, d, out_f32, "fwd") == "hived_flash_wide_fwd"
    # f32 at the same head dims: K1, K2 and K3 on the 3xTF32 cluster kernels
    assert tattn.kernel_entry(torch.float32, d, out_f32, "fwd") == "hived_flash_tf32_wide_fwd"
    assert tattn.kernel_entry(torch.float32, d, out_f32, "dq") == "hived_flash_tf32_wide_bwd_dq"
    assert d in tattn.WIDE_HEAD_DIMS and d not in tattn.WGMMA_HEAD_DIMS


@pytest.mark.parametrize("out_f32", [False, True], ids=["in-dtype", "f32-out"])
@pytest.mark.parametrize("d", list(range(8, 129, 8)))
def test_kernel_entry_takes_the_tf32_backward_at_f32(d, out_f32):
    # K1, K2 and K3 at f32 inputs up to D 128: the 3xTF32 wgmma kernels
    # (K1 csrc/flash_fwd_tf32.cu, K2 and K3 csrc/flash_bwd_tf32.cu), with
    # the CUDA-core family's arguments (the type codes after the dims, f32
    # in and out in both forms); past 128 all three take the 3xTF32 cluster
    # kernels
    f32 = torch.float32
    assert d in tattn.TF32_HEAD_DIMS
    for kernel, entry, counter in (
            ("fwd", ("flash_fwd_tf32", 5, 8, 12), "FLASH_FWD_TF32_LAUNCHES"),
            ("dq", ("flash_bwd_tf32", 8, 8, 18), "FLASH_BWD_DQ_TF32_LAUNCHES"),
            ("dkv", ("flash_bwd_tf32", 8, 8, 18), "FLASH_BWD_DKV_TF32_LAUNCHES")):
        symbol = tattn.kernel_entry(f32, d, out_f32, kernel)
        generic = STEMS[kernel].replace("hived_flash", "hived_flash_generic")
        assert symbol == STEMS[kernel].replace("hived_flash", "hived_flash_tf32")
        assert tattn._KERNELS[symbol] == entry
        assert tattn._KERNELS[symbol][1:] == tattn._KERNELS[generic][1:]
        assert tattn.launch_dims(symbol, (1, 2, 3, 4, d, 1), f32, out_f32) == (
            1, 2, 3, 4, d, 1, 2, 2)
        assert tattn._COUNTERS[symbol] == counter
        assert entry[0] in tattn._TYPED_LIBRARIES
        for wider in (136, 256):
            assert wider not in tattn.TF32_HEAD_DIMS
            assert tattn.kernel_entry(f32, wider, out_f32, kernel) == (
                STEMS[kernel].replace("hived_flash", "hived_flash_tf32_wide"))
    # 16-bit inputs at the same head dims keep the wgmma kernels
    assert tattn.kernel_entry(torch.bfloat16, d, out_f32, "dq") == (
        "hived_flash_bwd_dq" + ("_f32" if out_f32 else ""))
    assert tattn.kernel_entry(torch.float16, d, out_f32, "dkv") == (
        "hived_flash_bwd_dkv_f16" + ("_f32" if out_f32 else ""))


@pytest.mark.parametrize("out_f32", [False, True], ids=["in-dtype", "f32-out"])
@pytest.mark.parametrize("d", [136, 256, 264, 512, 896, 1024])
def test_kernel_entry_takes_the_tf32_cluster_backward_past_128(d, out_f32):
    # K1, K2 and K3 at f32 inputs at 128 < D <= 1024: the 3xTF32 cluster
    # kernels (K1 csrc/flash_fwd_tf32_wide.cu, K2 and K3
    # csrc/flash_bwd_tf32_wide.cu), one symbol for both forms, with the
    # CUDA-core family's arguments and counters of their own; past 1024 all
    # three stay on the CUDA-core family; 16-bit inputs keep their own kernels
    f32 = torch.float32
    assert d in tattn.TF32_WIDE_HEAD_DIMS and d not in tattn.TF32_HEAD_DIMS
    assert list(tattn.TF32_WIDE_HEAD_DIMS) == list(range(136, 1025, 8))
    for kernel, entry, counter in (
            ("fwd", ("flash_fwd_tf32_wide", 5, 8, 12), "FLASH_FWD_TF32_WIDE_LAUNCHES"),
            ("dq", ("flash_bwd_tf32_wide", 8, 8, 18), "FLASH_BWD_DQ_TF32_WIDE_LAUNCHES"),
            ("dkv", ("flash_bwd_tf32_wide", 8, 8, 18), "FLASH_BWD_DKV_TF32_WIDE_LAUNCHES")):
        symbol = tattn.kernel_entry(f32, d, out_f32, kernel)
        generic = STEMS[kernel].replace("hived_flash", "hived_flash_generic")
        assert symbol == STEMS[kernel].replace("hived_flash", "hived_flash_tf32_wide")
        assert tattn._KERNELS[symbol] == entry
        assert tattn._KERNELS[symbol][1:] == tattn._KERNELS[generic][1:]
        assert tattn.launch_dims(symbol, (1, 2, 3, 4, d, 1), f32, out_f32) == (
            1, 2, 3, 4, d, 1, 2, 2)
        assert tattn._COUNTERS[symbol] == counter
        assert tattn.kernel_entry(f32, 1032, out_f32, kernel) == generic
        assert tattn.kernel_entry(torch.bfloat16, d, out_f32, kernel) != symbol
        assert entry[0] in tattn._TYPED_LIBRARIES


@pytest.mark.parametrize("out_f32", [False, True], ids=["in-dtype", "f32-out"])
def test_kernel_entry_takes_the_tf32_cluster_forward_at_every_head_dim(out_f32):
    # f32 K1 at every multiple of 8 past 128 up to 1024 goes to the 3xTF32
    # cluster K1, in both output forms; at 1032, past a cluster of 8 panels,
    # to the CUDA-core K1
    f32 = torch.float32
    for d in range(136, 1025, 8):
        assert tattn.kernel_entry(f32, d, out_f32, "fwd") == "hived_flash_tf32_wide_fwd", d
    assert tattn.kernel_entry(f32, 1032, out_f32, "fwd") == "hived_flash_generic_fwd"
    assert tattn.kernel_entry(f32, 128, out_f32, "fwd") == "hived_flash_tf32_fwd"


@pytest.mark.parametrize("dtype, d, error", [
    (torch.float64, 64, TypeError), (torch.int32, 64, TypeError),
    (torch.bfloat16, 12, ValueError), (torch.float32, 12, ValueError),
    (torch.float16, 0, ValueError)])
def test_kernel_entry_refuses(dtype, d, error):
    with pytest.raises(error):
        tattn.kernel_entry(dtype, d, False)


def test_every_entry_point_has_its_own_launch_counter():
    assert set(tattn._COUNTERS) == set(tattn._KERNELS)
    assert len(set(tattn._COUNTERS.values())) == len(tattn._COUNTERS)
    assert tattn._COUNTERS["hived_flash_wide_fwd"] == "FLASH_FWD_WIDE_LAUNCHES"
    assert tattn._COUNTERS["hived_flash_wide_bwd_dq"] == "FLASH_BWD_DQ_WIDE_LAUNCHES"
    assert tattn._COUNTERS["hived_flash_wide_bwd_dkv"] == "FLASH_BWD_DKV_WIDE_LAUNCHES"
    assert tattn._COUNTERS["hived_flash_tf32_fwd"] == "FLASH_FWD_TF32_LAUNCHES"
    assert tattn._COUNTERS["hived_flash_tf32_bwd_dq"] == "FLASH_BWD_DQ_TF32_LAUNCHES"
    assert tattn._COUNTERS["hived_flash_tf32_bwd_dkv"] == "FLASH_BWD_DKV_TF32_LAUNCHES"
    assert tattn._COUNTERS["hived_flash_tf32_wide_fwd"] == "FLASH_FWD_TF32_WIDE_LAUNCHES"
    assert tattn._COUNTERS["hived_flash_tf32_wide_bwd_dq"] == "FLASH_BWD_DQ_TF32_WIDE_LAUNCHES"
    assert tattn._COUNTERS["hived_flash_tf32_wide_bwd_dkv"] == "FLASH_BWD_DKV_TF32_WIDE_LAUNCHES"
    for counter in tattn._COUNTERS.values():
        assert isinstance(getattr(tattn, counter), int)
    assert tattn.KERNEL_DTYPES == (torch.bfloat16, torch.float16, torch.float32)
    assert {8, 256, 264, 320, 512, 4096} <= {d for d in (8, 256, 264, 320, 512, 4096)
                                              if d in tattn.KERNEL_HEAD_DIMS}
    assert 12 not in tattn.KERNEL_HEAD_DIMS and 0 not in tattn.KERNEL_HEAD_DIMS


@pytest.mark.parametrize("in_bytes", [2, 4])
def test_attention_bytes_take_the_inputs_element_size(in_bytes):
    b, t, h, h_kv, d = 2, 1024, 4, 2, 512
    q_el, kv_el, rows = b * t * h * d, b * t * h_kv * d, b * h * t
    out = 4 if in_bytes == 4 else 2
    assert tattn.attention_bytes(b, t, h, h_kv, d, out_bytes=out, in_bytes=in_bytes) == (
        (q_el + 2 * kv_el) * in_bytes + q_el * out + 4 * rows)
    got = tattn.attention_bwd_bytes(b, t, h, h_kv, d, out_bytes=out, in_bytes=in_bytes)
    assert got["dq"] == (3 * q_el + 2 * kv_el) * in_bytes + q_el * out + 8 * rows
    assert got["dkv"] == (2 * q_el + 2 * kv_el) * in_bytes + 2 * kv_el * out + 8 * rows
    # the default is the 16-bit forms', as before
    assert tattn.attention_bytes(b, t, h, h_kv, d) == tattn.attention_bytes(
        b, t, h, h_kv, d, out_bytes=2, in_bytes=2)


def test_f32_inputs_store_f32_in_both_forms():
    x = torch.zeros(1, 8, 1, 8)
    assert tattn._is_f32(None, x) and tattn._is_f32(torch.float32, x)
    assert not tattn._is_f32(None, x.half()) and tattn._is_f32(torch.float32, x.half())
    with pytest.raises(TypeError):
        tattn._is_f32(torch.float16, x)


# -- the model: logits and two train steps ----------------------------------------

BASE = dict(vocab_size=256, n_layers=2, d_ff=256, max_seq_len=128, attn_block_q=64,
            attn_block_k=64, attn_impl="flash")
# D 64 (d_model 128, 2 heads), D 256 (d_model 512, 2 heads: Gemma-2B's head
# dim) and D 320 (d_model 640, 2 heads), one kv head
WIDTHS = {"d64": dict(d_model=128, n_heads=2, n_kv_heads=1),
          "d256": dict(d_model=512, n_heads=2, n_kv_heads=1),
          "d320": dict(d_model=640, n_heads=2, n_kv_heads=1)}
BATCH, SEQ = 2, 128


def _tokens(seed):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab_size"], size=(BATCH, SEQ)).astype(np.int32)


@pytest.fixture(scope="module", params=list(WIDTHS))
def model(request):
    """(the width's model fields, the JAX f32 weights from seed 0)."""
    kw = dict(BASE, **WIDTHS[request.param])
    assert ttm.TransformerConfig(**kw).head_dim == int(request.param[1:])
    with _cpu():
        weights = jtm.init_params(jtm.TransformerConfig(dtype=jnp.float32, **kw),
                                  jax.random.PRNGKey(0))
    return kw, jax.device_get(weights)


def _cfgs(model, dt, **over):
    kw = dict(model[0], **over)
    return (jtm.TransformerConfig(dtype=DTYPES[dt][2], **kw),
            ttm.TransformerConfig(dtype=DTYPES[dt][1], **kw))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_model_logits_match_jax(model, dt, monkeypatch):
    jcfg, tcfg = _cfgs(model, dt)
    tokens = _tokens(0)
    routes = _count_jax_reference(monkeypatch)
    with _cpu():
        ref = np.asarray(jtm.forward(model[1], jnp.asarray(tokens), jcfg)).astype(np.float32)
    before = tattn.FLASH_REFERENCE_ROUTES
    out = ttm.forward(bridge.from_numpy_tree(model[1]), torch.from_numpy(tokens), tcfg)
    assert routes == [] and tattn.FLASH_REFERENCE_ROUTES == before
    # the logits leave the model in f32 at every compute dtype, as JAX's do
    assert out.dtype == torch.float32 and out.shape == (BATCH, SEQ, BASE["vocab_size"])
    np.testing.assert_allclose(out.float().numpy(), ref, atol=LOGIT_ATOL[dt], rtol=0)


@pytest.mark.parametrize("dt", list(DTYPES))
def test_two_train_steps_match_jax(model, dt, monkeypatch):
    jcfg, tcfg = _cfgs(model, dt, remat="dots")
    batches = [_tokens(10 + i) for i in range(2)]
    routes = _count_jax_reference(monkeypatch)
    with _cpu():
        mesh = topology.make_mesh(topology.MeshAxes(), jax.devices("cpu")[:1])
        step, init_fn, tok_sh = jtrain.make_sharded_train_step(jcfg, mesh, ce_chunk=64)
        params, opt = init_fn(jax.random.PRNGKey(0))
        init = jax.device_get(params)
        grad = jax.jit(jax.grad(lambda p, t: jtrain.loss_fn(p, t, jcfg, ce_chunk=64)))
        j_grads, j_losses = [], []
        for tokens in batches:
            j_grads.append(tckpt.named_leaves(bridge.from_numpy_tree(
                jax.device_get(grad(params, jnp.asarray(tokens))))))
            params, opt, loss = step(params, opt, jax.device_put(tokens, tok_sh))
            j_losses.append(float(loss))
        j_params = tckpt.named_leaves(bridge.from_numpy_tree(jax.device_get(params)))
    assert routes == []

    t_step, _ = ttrain.make_train_step(tcfg, "cpu", ce_chunk=64)
    t_params = bridge.from_numpy_tree(init)
    leaves = ttrain._leaves(t_params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    t_opt = ttrain.make_optimizer()(leaves)
    before = tattn.FLASH_REFERENCE_ROUTES
    _, t_grads = ttrain.value_and_grad(t_params, torch.from_numpy(batches[0]), tcfg, ce_chunk=64)
    for name, g in zip(tckpt.named_leaves(t_params), t_grads):
        ref = j_grads[0][name]
        assert float((g - ref).norm() / ref.norm()) <= GRAD_REL[dt], name
    t_losses = []
    for tokens in batches:
        t_params, t_opt, loss = t_step(t_params, t_opt, torch.from_numpy(tokens))
        t_losses.append(float(loss))
    assert tattn.FLASH_REFERENCE_ROUTES == before
    np.testing.assert_allclose(t_losses, j_losses, atol=LOSS_ATOL[dt], rtol=0)
    got = tckpt.named_leaves(t_params)
    assert list(got) == list(j_params)
    steps = len(batches)
    for name, t in got.items():
        diff = np.abs(t.detach().numpy() - j_params[name].numpy())
        if dt == "fp16":
            atol = 2 * ADAMW_LR * steps
        else:
            # an element whose first nonzero gradient is within 100 x AdamW's
            # eps of 0 may take a step of its own (test_torch_head_dims.py)
            g = np.abs(np.stack([s[name].numpy() for s in j_grads]))
            g1 = np.take_along_axis(g, (g > 0).argmax(0)[None], 0)[0]
            atol = np.where((g1 > 0) & (g1 < 100 * ADAMW_EPS), 2 * ADAMW_LR * steps, PARAM_ATOL)
        assert (diff <= atol).all(), (name, float(diff.max()))
    # the steps moved the attention weights by far more than the f32 tolerance
    assert float((j_params["layers.wq"] - bridge.from_numpy_tree(init)["layers"]["wq"])
                 .abs().max()) > 10 * PARAM_ATOL


# -- the eval CLI at D 320 -----------------------------------------------------------

CLI_MODEL = ["--vocab-size", "256", "--d-model", "640", "--n-heads", "2", "--n-kv-heads", "1",
             "--n-layers", "2", "--d-ff", "256", "--seq-len", "128", "--batch", "2",
             "--max-steps", "2", "--attn", "flash", "--ce-chunk", "64"]
# JAX's eval CLI in f32 from the weights in $HIVED_TEST_INIT (an .npz of named
# leaves), counting its reference routes
JAX_EVAL = (
    "import functools, os, sys, numpy as np, jax.numpy as jnp\n"
    "from hivedscheduler_tpu.models import transformer as tm\n"
    "from hivedscheduler_tpu.ops import attention as fa\n"
    "tm.TransformerConfig = functools.partial(tm.TransformerConfig, dtype=jnp.float32)\n"
    "def _loaded(cfg, key):\n"
    "    tree = {}\n"
    "    with np.load(os.environ['HIVED_TEST_INIT']) as f:\n"
    "        for name, value in f.items():\n"
    "            node = tree\n"
    "            *path, leaf = name.split('.')\n"
    "            for k in path:\n"
    "                node = node.setdefault(k, {})\n"
    "            node[leaf] = jnp.asarray(value)\n"
    "    return tree\n"
    "tm.init_params = _loaded\n"
    "routes = []\n"
    "_real = fa.xla_attention\n"
    "fa.xla_attention = lambda *a, **kw: routes.append(1) or _real(*a, **kw)\n"
    "from hivedscheduler_tpu import eval\n"
    "rc = eval.main(sys.argv[1:])\n"
    "print(f'reference routes {len(routes)}')\n"
    "sys.exit(rc)\n")


def _loss_line(text: str) -> float:
    lines = [line for line in text.splitlines() if line.startswith("loss ")]
    assert len(lines) == 1, text
    return float(lines[0].split()[1])


def test_eval_cli_at_d320_matches_jax_cli(tmp_path, monkeypatch, capsys):
    kw = dict(BASE, **WIDTHS["d320"])
    with _cpu():
        weights = jax.device_get(jtm.init_params(
            jtm.TransformerConfig(dtype=jnp.float32, **kw), jax.random.PRNGKey(3)))
    named = tckpt.named_leaves(bridge.from_numpy_tree(weights))
    init_path = str(tmp_path / "init.npz")
    np.savez(init_path, **{name: x.numpy() for name, x in named.items()})
    jax_run = subprocess.Popen(
        [sys.executable, "-c", JAX_EVAL, *CLI_MODEL], cwd=ROOT,
        env=jchaos.cpu_only_env(devices=1, HIVED_TEST_INIT=init_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    # the port's CLI in this process, in f32 from the same weights
    real_cfg = ttm.TransformerConfig
    monkeypatch.setattr(ttm, "TransformerConfig",
                        lambda **kw: real_cfg(dtype=torch.float32, **kw))
    monkeypatch.setattr(ttm, "init_params", lambda cfg, generator, device="cpu":
                        bridge.from_numpy_tree(weights, device))
    before = tattn.FLASH_REFERENCE_ROUTES
    assert teval.main(CLI_MODEL + ["--device", "cpu"]) == 0
    assert tattn.FLASH_REFERENCE_ROUTES == before
    port_loss = _loss_line(capsys.readouterr().out)

    out = jax_run.communicate(timeout=600)[0]
    assert jax_run.returncode == 0, out
    assert "reference routes 0" in out  # JAX's eval took its Pallas kernel
    assert port_loss == pytest.approx(_loss_line(out), abs=1e-5)


# -- the ring's per-hop functions at fp16 and D 320 --------------------------------------


@pytest.mark.parametrize("diag", [True, False])
def test_ring_flash_block_at_fp16_d320_matches_jax(diag):
    rng = np.random.default_rng(7)
    b, t, h, h_kv, d = 1, 128, 4, 2, 320
    q = rng.standard_normal((b, t, h, d)).astype(np.float16)
    k = rng.standard_normal((b, t, h_kv, d)).astype(np.float16)
    v = rng.standard_normal((b, t, h_kv, d)).astype(np.float16)
    do = rng.standard_normal((b, t, h, d)).astype(np.float16)
    with _cpu():
        o_ref, lse_ref = jring._flash_block(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), diag,
                                            64, 64, True, ())
        # the backward hop takes the merged out in q's dtype and the lse rows
        out = jnp.einsum("bhqd->bqhd", o_ref).astype(jnp.float16)
        lse_rows = jnp.broadcast_to(lse_ref.reshape(b * h, t, 1), (b * h, t, 128))
        g_ref = jattn._flash_backward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), out,
                                      lse_rows, jnp.asarray(do), causal=diag, block_q=64,
                                      block_k=64, interpret=True, grad_dtype=jnp.float32)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tring._flash_block(tq, tk, tv, diag)
    assert o.dtype == torch.float32 and o.shape == (b, h, t, d) and lse.shape == (b, h, t)
    assert _rel(o.numpy(), o_ref) <= REL["f32"]
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=2e-5, rtol=0)
    grads = tring._flash_block_grad(tq, tk, tv, torch.from_numpy(np.asarray(out)),
                                    torch.from_numpy(np.asarray(lse_ref)).reshape(b * h, t),
                                    tdo, diag)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, g_ref):
        assert got.dtype == torch.float32, name
        assert _rel(got.numpy(), ref) <= REL["f32"], name
