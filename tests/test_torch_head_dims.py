"""The port at head dims other than 64 or 128: two narrow models with
``attn_impl="flash"``, against the JAX package on the same weights, carried
across by hivedscheduler_tpu_torch.bridge. ``d96``: D = 96 (Phi-3-mini's
head dim; d_model 192, 2 heads, 2 kv heads); ``d256``: D = 256 with one kv
head (Gemma-2B's head dim and MQA; d_model 512, 2 heads). Both: d_ff 512,
vocab 264, 2 layers, seq 128.

At T = 128 over blocks of 64 the JAX package takes its Pallas kernels
(interpret mode on the CPU) and the port the plain versions of its kernels,
which the card's K1-K3 are held to at this D. Tolerances are the earlier
slices': f32 logits atol 1e-4 (tests/test_torch_transformer.py); three
AdamW steps against ``make_sharded_train_step`` on a one-device mesh,
losses 1e-5 and parameters 3e-5 (tests/test_torch_train.py), the first
step's gradients 1e-5, and, as tests/test_torch_moe_train.py holds them,
the few elements whose first nonzero gradient over the steps is within 100
x AdamW's eps of zero to the 2 lr x steps AdamW can move them: there g / (|g| + eps)
turns f32 rounding into a fraction of a step (observed here: one w_gate
element 5.5e-5 apart); greedy decode and the serving engine's streams
(dense, and paged with per-head int8 KV scales) token for token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import decode as jdec
from hivedscheduler_tpu.models import serving as jsrv
from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu.ops import attention as jattn
from hivedscheduler_tpu.parallel import topology
from hivedscheduler_tpu.parallel import train as jtrain
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch.models import decode as tdec
from hivedscheduler_tpu_torch.models import serving as tsrv
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.ops import attention as tattn
from hivedscheduler_tpu_torch.parallel import checkpoint as tckpt
from hivedscheduler_tpu_torch.parallel import train as ttrain

torch.set_num_threads(1)

LOGIT_ATOL = 1e-4
LOSS_ATOL = 1e-5
PARAM_ATOL = 3e-5
GRAD_ATOL = 1e-5
ADAMW_EPS, ADAMW_LR = 1e-8, 3e-4

BASE = dict(vocab_size=264, n_layers=2, d_ff=512, max_seq_len=128, attn_block_q=64,
            attn_block_k=64, attn_impl="flash")
# the models' widths, by the head dim d_model / n_heads
WIDTHS = {"d96": dict(d_model=192, n_heads=2, n_kv_heads=2),
          "d256": dict(d_model=512, n_heads=2, n_kv_heads=1)}
BATCH, SEQ = 2, 128


def _tokens(seed, b=BATCH, t=SEQ):
    return np.random.default_rng(seed).integers(
        0, BASE["vocab_size"], size=(b, t)).astype(np.int32)


@pytest.fixture(scope="module", params=list(WIDTHS))
def model(request):
    """(the width's model fields, the JAX weights from seed 0)."""
    kw = dict(BASE, **WIDTHS[request.param])
    jcfg = jtm.TransformerConfig(dtype=jnp.float32, **kw)
    assert ttm.TransformerConfig(**kw).head_dim == int(request.param[1:])
    return kw, jax.device_get(jtm.init_params(jcfg, jax.random.PRNGKey(0)))


def _cfgs(model, **over):
    kw = dict(model[0], **over)
    return (jtm.TransformerConfig(dtype=jnp.float32, **kw),
            ttm.TransformerConfig(dtype=torch.float32, **kw))


def _count_jax_reference(monkeypatch):
    routes = []
    real = jattn.xla_attention

    def counting(*a, **kw):
        routes.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(jattn, "xla_attention", counting)
    return routes


def test_forward_logits_match_jax(model, monkeypatch):
    jcfg, tcfg = _cfgs(model)
    weights = model[1]
    tokens = _tokens(0)
    routes = _count_jax_reference(monkeypatch)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        ref = np.asarray(jtm.forward(weights, jnp.asarray(tokens), jcfg))
    before = tattn.FLASH_REFERENCE_ROUTES
    out = ttm.forward(bridge.from_numpy_tree(weights), torch.from_numpy(tokens), tcfg)
    # both took their kernels (the port the plain versions), not the reference
    assert routes == [] and tattn.FLASH_REFERENCE_ROUTES == before
    assert out.shape == (BATCH, SEQ, BASE["vocab_size"])
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGIT_ATOL, rtol=0)


def test_three_train_steps_match_jax_sharded_train_step(model, monkeypatch):
    jcfg, tcfg = _cfgs(model, remat="dots")
    batches = [_tokens(10 + i) for i in range(3)]
    routes = _count_jax_reference(monkeypatch)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        mesh = topology.make_mesh(topology.MeshAxes(), jax.devices("cpu")[:1])
        step, init_fn, tok_sh = jtrain.make_sharded_train_step(jcfg, mesh, ce_chunk=64)
        params, opt = init_fn(jax.random.PRNGKey(0))
        init = jax.device_get(params)
        # each step's gradients at the parameters it starts from
        grad = jax.jit(jax.grad(lambda p, t: jtrain.loss_fn(p, t, jcfg, ce_chunk=64)))
        j_steps_grads, j_losses = [], []
        for tokens in batches:
            j_steps_grads.append(jax.device_get(grad(params, jnp.asarray(tokens))))
            params, opt, loss = step(params, opt, jax.device_put(tokens, tok_sh))
            j_losses.append(float(loss))
        j_params = jax.device_get(params)
    assert routes == []
    j_steps_grads = [tckpt.named_leaves(bridge.from_numpy_tree(g)) for g in j_steps_grads]
    j_grads = j_steps_grads[0]
    j_params = tckpt.named_leaves(bridge.from_numpy_tree(j_params))

    t_step, _ = ttrain.make_train_step(tcfg, "cpu", ce_chunk=64)
    t_params = bridge.from_numpy_tree(init)
    leaves = ttrain._leaves(t_params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    before = tattn.FLASH_REFERENCE_ROUTES
    grads = torch.autograd.grad(ttrain.loss_fn(t_params, torch.from_numpy(batches[0]), tcfg,
                                               ce_chunk=64), leaves)
    for name, g in zip(tckpt.named_leaves(t_params), grads):
        np.testing.assert_allclose(g.numpy(), j_grads[name].numpy(), atol=GRAD_ATOL, rtol=0,
                                   err_msg=name)
    t_opt = ttrain.make_optimizer()(leaves)
    t_losses = []
    for tokens in batches:
        t_params, t_opt, loss = t_step(t_params, t_opt, torch.from_numpy(tokens))
        t_losses.append(float(loss))
    assert tattn.FLASH_REFERENCE_ROUTES == before
    np.testing.assert_allclose(t_losses, j_losses, atol=LOSS_ATOL, rtol=0)
    got = tckpt.named_leaves(t_params)
    assert list(got) == list(j_params)
    n_loose = 0
    for name, t in got.items():
        # each element's first nonzero gradient over the steps: AdamW's first
        # step for it (an embedding row whose token the first batch lacks
        # has a gradient of exactly 0 there)
        steps = np.abs(np.stack([g[name].numpy() for g in j_steps_grads]))
        g1 = np.take_along_axis(steps, (steps > 0).argmax(0)[None], 0)[0]
        loose = (g1 > 0) & (g1 < 100 * ADAMW_EPS)
        n_loose += int(loose.sum())
        atol = np.where(loose, 2 * ADAMW_LR * len(batches), PARAM_ATOL)
        diff = np.abs(t.detach().numpy() - j_params[name].numpy())
        assert (diff <= atol).all(), (name, float(diff.max()))
    assert n_loose < 1e-3 * sum(v.numel() for v in j_grads.values())
    # the steps moved the attention weights by far more than the tolerance
    assert float((j_params["layers.wq"] - bridge.from_numpy_tree(init)["layers"]["wq"])
                 .abs().max()) > 20 * PARAM_ATOL


def test_greedy_decode_is_token_exact_against_jax(model):
    jcfg, tcfg = _cfgs(model)
    weights = model[1]
    prompt = _tokens(20, t=9)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        want = np.asarray(jdec.generate(jax.tree.map(jnp.asarray, weights),
                                        jnp.asarray(prompt), jcfg, 16))
    got = tdec.generate(bridge.from_numpy_tree(weights), torch.from_numpy(prompt), tcfg, 16)
    np.testing.assert_array_equal(got.numpy(), want)


def _drive(mod, params, cfg, prompts, budgets, **kw):
    eng = mod.ServingEngine(params, cfg, max_batch=3, max_len=48, **kw)
    pending, reqs, step = list(zip(prompts, budgets)), [], 0
    while pending or any(not r.done for r in reqs):
        if pending and step % 2 == 0:
            reqs.append(eng.submit(*pending.pop(0)))
        eng.step()
        step += 1
    return [(r.tokens_out, r.finish_reason) for r in reqs]


@pytest.mark.parametrize("engine", [
    dict(),
    dict(page_size=8, kv_dtype="int8", decode_steps=3),
], ids=["dense", "paged_int8kv_steps3"])
def test_engine_streams_match_jax(model, engine):
    jcfg, tcfg = _cfgs(model)
    weights = model[1]
    rng = np.random.default_rng(30)
    prompts = [[int(t) for t in rng.integers(0, BASE["vocab_size"], int(rng.integers(2, 20)))]
               for _ in range(5)]
    budgets = [int(rng.integers(3, 12)) for _ in range(5)]
    ref = _drive(jsrv, jax.tree.map(jnp.asarray, weights), jcfg, prompts, budgets, **engine)
    out = _drive(tsrv, bridge.from_numpy_tree(weights), tcfg, prompts, budgets, **engine)
    assert out == ref
