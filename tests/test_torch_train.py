"""The port's training step (hivedscheduler_tpu_torch.parallel.train)
against the JAX package's ``make_sharded_train_step`` on the same weights.

Weights are made by the JAX package and carried across with
``hivedscheduler_tpu_torch.bridge``; batches are numpy. In f32 the two
steps differ by summation order only: the losses agree to atol 1e-5 (a
mean of O(5) cross-entropies; observed 4.8e-7) and, after three AdamW
steps of lr 3e-4, every parameter to atol 3e-5, a tenth of one step
(observed 1.0e-5 in one element of w_down, median 2e-9: AdamW's update
g / (|g| + eps) is sensitive to f32 rounding only where g is near eps).
The gradients themselves agree to atol 1e-5 in f32. In bf16 both round
activations at different points: the loss within 5e-3 and every leaf's
gradient within a relative Frobenius 5e-2 (observed <= 1.4e-3 and
<= 1.5e-2 over three seeds); the updated parameters are not compared in
bf16, since AdamW's first step is lr x sign(g) and flips wherever bf16
noise flips the sign of a near-zero gradient.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu.ops import attention as jattn
from hivedscheduler_tpu.parallel import topology
from hivedscheduler_tpu.parallel import train as jtrain
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.ops import attention as tattn
from hivedscheduler_tpu_torch.parallel import train as ttrain

torch.set_num_threads(1)

LOSS_ATOL = 1e-5
PARAM_ATOL = 3e-5
GRAD_ATOL = 1e-5
BF16_LOSS_ATOL = 5e-3
BF16_GRAD_REL = 5e-2

# T=128 over blocks of 64: the JAX package takes its Pallas kernels
# (interpret mode on the CPU), the port the plain versions of its kernels
SMALL = dict(vocab_size=96, d_model=128, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=256, max_seq_len=128, attn_block_q=64,
             attn_block_k=64, attn_impl="flash")
BATCH, SEQ = 2, 128


def _cfgs(dtype="f32", **over):
    kw = dict(SMALL, **over)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    return jtm.TransformerConfig(dtype=jdt, **kw), ttm.TransformerConfig(dtype=tdt, **kw)


def _batches(n, seed=0, batch=BATCH):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, SMALL["vocab_size"], (batch, SEQ)).astype(np.int32)
            for _ in range(n)]


def _jax_run(jcfg, batches, ce_chunk, monkeypatch):
    """JAX's step on a one-device CPU mesh -> (losses, final numpy params,
    initial numpy params), counting the routes its attention took."""
    routes = {"reference": 0, "flash_backward": 0}
    real_xla, real_bwd = jattn.xla_attention, jattn._flash_backward

    def xla(*a, **kw):
        routes["reference"] += 1
        return real_xla(*a, **kw)

    def bwd(*a, **kw):
        routes["flash_backward"] += 1
        return real_bwd(*a, **kw)

    monkeypatch.setattr(jattn, "xla_attention", xla)
    monkeypatch.setattr(jattn, "_flash_backward", bwd)
    mesh = topology.make_mesh(topology.MeshAxes(), jax.devices("cpu")[:1])
    step, init_fn, tok_sh = jtrain.make_sharded_train_step(jcfg, mesh,
                                                           ce_chunk=ce_chunk)
    params, opt = init_fn(jax.random.PRNGKey(0))
    init = jax.device_get(params)
    losses = []
    for tokens in batches:
        params, opt, loss = step(params, opt, jax.device_put(tokens, tok_sh))
        losses.append(float(loss))
    # the traced layer scan took the kernels, forward and backward, never
    # the reference
    assert routes["reference"] == 0 and routes["flash_backward"] > 0
    return losses, jax.device_get(params), init


def _trainable(tree):
    """JAX-made numpy weights as the port's trainable params and AdamW."""
    params = bridge.from_numpy_tree(tree)
    for leaf in ttrain._leaves(params):
        leaf.requires_grad_(True)
    return params, ttrain.make_optimizer()(ttrain._leaves(params))


def _port_run(tcfg, init_np, batches, **kw):
    step, _ = ttrain.make_train_step(tcfg, "cpu", **kw)
    params, opt = _trainable(init_np)
    losses = []
    for tokens in batches:
        params, opt, loss = step(params, opt, torch.from_numpy(tokens))
        losses.append(float(loss))
    return losses, bridge.to_numpy_tree(params)


def _assert_trees_close(got, want, atol):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("ce_chunk", [0, 64])
def test_three_steps_match_jax_sharded_train_step(ce_chunk, monkeypatch):
    jcfg, tcfg = _cfgs()
    batches = _batches(3)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        j_losses, j_params, init = _jax_run(jcfg, batches, ce_chunk, monkeypatch)
    routes = tattn.FLASH_REFERENCE_ROUTES
    t_losses, t_params = _port_run(tcfg, init, batches, ce_chunk=ce_chunk)
    assert tattn.FLASH_REFERENCE_ROUTES == routes  # the plain kernels, not xla
    np.testing.assert_allclose(t_losses, j_losses, atol=LOSS_ATOL, rtol=0)
    _assert_trees_close(t_params, j_params, PARAM_ATOL)
    # the steps moved the parameters by far more than the tolerance
    assert np.abs(j_params["layers"]["wq"] - init["layers"]["wq"]).max() > 20 * PARAM_ATOL


def _both_grads(dtype, seed, ce_chunk):
    """(loss, grads) of JAX's loss_fn under jax.grad and of the port's under
    autograd, on the same JAX-made weights and batch, as numpy trees."""
    jcfg, tcfg = _cfgs(dtype)
    tokens = _batches(1, seed=seed)[0]
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        weights = jax.device_get(jtm.init_params(jcfg, jax.random.PRNGKey(seed)))
        j_loss, j_grads = jax.jit(jax.value_and_grad(
            lambda p: jtrain.loss_fn(p, jnp.asarray(tokens), jcfg,
                                     ce_chunk=ce_chunk)))(weights)
    params, _ = _trainable(weights)
    loss = ttrain.loss_fn(params, torch.from_numpy(tokens), tcfg, ce_chunk=ce_chunk)
    grads = iter(torch.autograd.grad(loss, ttrain._leaves(params)))
    # back into the tree, in the port's leaf order
    t_grads = bridge.map_tree(lambda _: next(grads), params)
    return (float(j_loss), jax.device_get(j_grads), float(loss.detach()),
            bridge.to_numpy_tree(t_grads))


def test_loss_fn_grads_match_jax_f32():
    j_loss, j_grads, t_loss, t_grads = _both_grads("f32", 1, 32)
    assert t_loss == pytest.approx(j_loss, abs=LOSS_ATOL)
    _assert_trees_close(t_grads, j_grads, GRAD_ATOL)


def test_bf16_step_matches_jax():
    j_loss, j_grads, t_loss, t_grads = _both_grads("bf16", 2, 64)
    assert abs(t_loss - j_loss) <= BF16_LOSS_ATOL
    flat_t = jax.tree_util.tree_leaves_with_path(t_grads)
    flat_j = jax.tree_util.tree_leaves_with_path(j_grads)
    for (path, t), (_, j) in zip(flat_t, flat_j):
        rel = np.linalg.norm(t - j) / np.linalg.norm(j)
        assert rel <= BF16_GRAD_REL, (jax.tree_util.keystr(path), rel)


def _snapshot(params):
    """A numpy copy of the tree (to_numpy_tree shares CPU memory)."""
    return jax.tree_util.tree_map(np.copy, bridge.to_numpy_tree(params))


def _one_port_step(tcfg, tokens, **kw):
    step, init_fn = ttrain.make_train_step(tcfg, "cpu", **kw)
    params, opt = init_fn(torch.Generator().manual_seed(0))
    params, opt, loss = step(params, opt, torch.from_numpy(tokens))
    return float(loss), bridge.to_numpy_tree(params), opt


def test_grad_accum_equals_full_batch():
    _, tcfg = _cfgs()
    tokens = _batches(1, seed=2, batch=4)[0]
    full_loss, full, _ = _one_port_step(tcfg, tokens, ce_chunk=64)
    acc_loss, acc, _ = _one_port_step(tcfg, tokens, ce_chunk=64, grad_accum=2)
    # the mean of two half-batch means is the full-batch mean
    assert acc_loss == pytest.approx(full_loss, abs=LOSS_ATOL)
    _assert_trees_close(acc, full, 1e-6)
    with pytest.raises(ValueError) as err:
        _one_port_step(tcfg, tokens, grad_accum=3)
    assert "not divisible by grad_accum" in str(err.value)


@pytest.mark.parametrize("policy", ["dots", "none"])
def test_remat_policies_compute_the_same_step(policy):
    # remat only changes what the backward recomputes: the same loss and
    # the same updated parameters as blanket remat, bit for bit on the CPU
    _, tcfg = _cfgs()
    tokens = _batches(1, seed=3)[0]
    loss_full, full, _ = _one_port_step(tcfg, tokens, remat_policy="full")
    loss_p, got, _ = _one_port_step(tcfg, tokens, remat_policy=policy)
    assert loss_p == loss_full
    _assert_trees_close(got, full, 0.0)


def test_remat_recomputes_the_flash_forward(monkeypatch):
    # "full" and "dots" run each layer's flash forward again in the
    # backward; "none" does not. The backward runs once per layer always.
    _, tcfg = _cfgs()
    tokens = _batches(1, seed=4)[0]
    calls = {"fwd": 0, "bwd": 0}
    real_fwd, real_bwd = tattn.flash_forward, tattn.flash_backward

    def fwd(*a, **kw):
        calls["fwd"] += 1
        return real_fwd(*a, **kw)

    def bwd(*a, **kw):
        calls["bwd"] += 1
        return real_bwd(*a, **kw)

    monkeypatch.setattr(tattn, "flash_forward", fwd)
    monkeypatch.setattr(tattn, "flash_backward", bwd)
    n = tcfg.n_layers
    for policy, want_fwd in (("none", n), ("full", 2 * n), ("dots", 2 * n)):
        calls.update(fwd=0, bwd=0)
        _one_port_step(tcfg, tokens, remat_policy=policy, ce_chunk=64)
        assert calls == {"fwd": want_fwd, "bwd": n}, policy


def test_remat_policy_validated():
    _, tcfg = _cfgs()
    with pytest.raises(ValueError) as err:
        ttrain.make_train_step(tcfg, "cpu", remat_policy="some")
    assert "unknown remat_policy" in str(err.value)
    assert ttrain.REMAT_POLICIES == jtrain.REMAT_POLICIES


def test_skip_nonfinite_gate_passes_state_through():
    _, tcfg = _cfgs(n_layers=1)
    step, init_fn = ttrain.make_train_step(tcfg, "cpu", skip_nonfinite=True)
    params, opt = init_fn(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_batches(1, seed=5)[0])
    # a healthy step: the gate must not block real updates
    before = _snapshot(params)
    params, opt, loss = step(params, opt, tokens)
    assert math.isfinite(float(loss))
    after = _snapshot(params)
    assert not np.array_equal(before["embed"], after["embed"])
    state_before = {k: v.clone() for k, v in opt.state[params["embed"]].items()}
    # a poisoned step: params and optimizer state (step count included)
    # come back bit-identical, and the loss still reports the NaN
    with torch.no_grad():
        params["final_norm"].mul_(float("nan"))
    poisoned = _snapshot(params)
    params, opt, loss = step(params, opt, tokens)
    assert not math.isfinite(float(loss))
    _assert_trees_close(bridge.to_numpy_tree(params), poisoned, 0.0)
    for key, value in opt.state[params["embed"]].items():
        assert torch.equal(value, state_before[key]), key
    assert all(p.grad is None for p in ttrain._leaves(params))


def test_optimizer_matches_optax_adamw():
    # three updates of the same gradients through both optimizers
    rng = np.random.default_rng(6)
    w0 = rng.standard_normal((8, 4)).astype(np.float32)
    grads = [rng.standard_normal((8, 4)).astype(np.float32) for _ in range(3)]
    opt = jtrain.make_optimizer()
    w, state = jnp.asarray(w0), None
    state = opt.init(w)
    for g in grads:
        upd, state = opt.update(jnp.asarray(g), state, w)
        w = w + upd
    tw = torch.from_numpy(w0.copy()).requires_grad_(True)
    topt = ttrain.make_optimizer()([tw])
    for g in grads:
        tw.grad = torch.from_numpy(g)
        topt.step()
    np.testing.assert_allclose(tw.detach().numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_chunked_ce_backward_recomputes_each_chunk(monkeypatch):
    # the chunked loss is checkpointed per chunk: the backward runs each
    # chunk's lm_head product again, so the logits of all chunks are never
    # saved together
    _, tcfg = _cfgs(n_layers=1)
    calls = []
    real = ttrain._chunk_ce

    def spy(*a):
        calls.append(a[0].shape[1])
        return real(*a)

    monkeypatch.setattr(ttrain, "_chunk_ce", spy)
    _one_port_step(tcfg, _batches(1, seed=8)[0], ce_chunk=32, remat_policy="none")
    assert calls == [32] * 4 * 2  # 4 chunks, forward and recompute


def test_config_remat_field_drives_the_layer_loop():
    # make_train_step without an override keeps cfg.remat
    _, tcfg = _cfgs(remat="none")
    assert ttrain._apply_remat_policy(tcfg, None) is tcfg
    assert ttrain._apply_remat_policy(tcfg, "dots") == dataclasses.replace(tcfg, remat="dots")
