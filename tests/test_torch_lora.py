"""LoRA in the port (``models/transformer.py``'s adapter leaves,
``split_lora_params``, ``combine_lora_params``, ``merge_lora``, and
``parallel/train.py``'s ``make_lora_train_step`` and
``make_sharded_lora_train_step``) against the JAX package's, the functions
of ``tests/test_lora.py``, on weights made by JAX and carried across by
``hivedscheduler_tpu_torch.bridge``.

Tolerances (f32): with zero ``B`` the port's adapted forward equals its
base forward bit for bit (each delta is an exact zero added after its base
product), JAX's its own within 1e-6, and the port's logits JAX's within
1e-5, no further apart than the two dense forwards (3.7e-6 observed; the
dense forward's parity test allows 1e-4); the merged model equals the adapter
forward within 1e-5 (JAX's own limit: (W + s A B) x against W x + s (x A)
B reorders the sums); three LoRA steps match JAX's in losses within 1e-5
and adapters within 3e-5, the limits of the dense step
(``test_torch_train.py``), and leave the base untouched bit for bit; on
gloo gangs at tp=2 and fsdp=2 the same limits hold against JAX's step on
the matching CPU mesh. Merged weights decode token for token as JAX's
``generate`` does on the same merged weights.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import decode as jdec
from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu.parallel import topology as jtopo
from hivedscheduler_tpu.parallel import train as jtrain
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch.models import decode as tdec
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.parallel import checkpoint as tckpt
from hivedscheduler_tpu_torch.parallel import train as ttrain

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from test_torch_sharded_train import _named, _result, _worker_gang  # noqa: E402

LOSS_ATOL = 1e-5
PARAM_ATOL = 3e-5
SMALL = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=64,
             max_seq_len=32, attn_block_q=16, attn_block_k=16)
STEPS = 3


def _cfgs(**over):
    kw = dict(SMALL, **over)
    return (jtm.TransformerConfig(dtype=jnp.float32, **kw),
            ttm.TransformerConfig(dtype=torch.float32, **kw))


def _perturb_b(tree, seed=5, scale=0.1):
    """Numpy tree with every ``lora_*_b`` leaf random: the adapters act."""
    rng = np.random.default_rng(seed)
    layers = dict(tree["layers"])
    for name in sorted(layers):
        if name.startswith("lora_") and name.endswith("_b"):
            layers[name] = (scale * rng.standard_normal(layers[name].shape)).astype(np.float32)
    return {**tree, "layers": layers}


def _init(jcfg, perturb=False):
    tree = jax.device_get(jtm.init_params(jcfg, jax.random.PRNGKey(0)))
    return _perturb_b(tree) if perturb else tree


def _tokens(shape=(2, 16), seed=1):
    return np.random.default_rng(seed).integers(0, SMALL["vocab_size"], shape).astype(np.int32)


def _forward_both(tree, jcfg, tcfg, tokens):
    want = np.asarray(jtm.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(tokens), jcfg))
    got = ttm.forward(bridge.from_numpy_tree(tree), torch.from_numpy(tokens), tcfg)
    return got.detach().numpy(), want


@pytest.mark.parametrize("attn", ["xla", "flash"])
def test_zero_init_equals_the_base_model(attn):
    jcfg, tcfg = _cfgs(lora_rank=4, lora_mlp=True, attn_impl=attn)
    tree = _init(jcfg)
    tokens = _tokens()
    got, want = _forward_both(tree, jcfg, tcfg, tokens)
    jbase, _ = jtm.split_lora_params(tree)
    base_got, base_want = _forward_both(jbase, *_cfgs(attn_impl=attn), tokens)
    # each package's adapted model is its base model: the port's bit for
    # bit, JAX's within its own test's 1e-6
    assert np.array_equal(got, base_got)
    np.testing.assert_allclose(want, base_want, atol=1e-6, rtol=0)
    # across the packages the gap is the dense forward's own (observed
    # 3.7e-6 on logits of ~1, here and without adapters alike)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(got - want).max() <= np.abs(base_got - base_want).max()


def test_init_draws_the_adapters_after_the_base():
    _, tcfg = _cfgs()
    base = ttm.init_params(tcfg, torch.Generator().manual_seed(3))
    lora = ttm.init_params(dataclasses.replace(tcfg, lora_rank=2, lora_mlp=True),
                           torch.Generator().manual_seed(3))
    for name, t in tckpt.named_leaves(base).items():
        assert torch.equal(tckpt.named_leaves(lora)[name], t), name
    for name, t in lora["layers"].items():
        if name.startswith("lora_"):
            assert (t.abs().sum() > 0) == name.endswith("_a"), name
    jtree = jax.device_get(jtm.init_params(_cfgs(lora_rank=2, lora_mlp=True)[0],
                                           jax.random.PRNGKey(0)))
    assert {k: v.shape for k, v in lora["layers"].items()} == {
        k: tuple(v.shape) for k, v in jtree["layers"].items()}


@pytest.mark.parametrize("mlp", [False, True])
def test_merge_matches_the_adapter_forward(mlp):
    jcfg, tcfg = _cfgs(lora_rank=4, lora_alpha=8.0, lora_mlp=mlp)
    tree = _init(jcfg, perturb=True)
    tokens = _tokens()
    adapted, want = _forward_both(tree, jcfg, tcfg, tokens)
    np.testing.assert_allclose(adapted, want, atol=1e-5, rtol=0)
    merged = ttm.merge_lora(bridge.from_numpy_tree(tree), tcfg)
    assert not any(k.startswith("lora_") for k in merged["layers"])
    jmerged = jax.device_get(jtm.merge_lora(jax.tree.map(jnp.asarray, tree), jcfg))
    for name, t in tckpt.named_leaves(merged).items():
        np.testing.assert_allclose(t.numpy(), _named(jmerged)[name], atol=1e-6, rtol=0)
    base_cfg = dataclasses.replace(tcfg, lora_rank=0, lora_mlp=False)
    out = ttm.forward(merged, torch.from_numpy(tokens), base_cfg).numpy()
    np.testing.assert_allclose(out, adapted, atol=1e-5, rtol=0)
    # the adapters change the function, else this proves nothing
    base, _ = ttm.split_lora_params(bridge.from_numpy_tree(tree))
    assert np.abs(ttm.forward(base, torch.from_numpy(tokens), base_cfg).numpy()
                  - adapted).max() > 1e-3


def _jax_lora_steps(jcfg, tree, batches, axes=None, grad_accum=1, ce_chunk=0):
    """JAX's ``make_sharded_lora_train_step`` from ``tree`` -> (losses,
    named final params: base and adapters)."""
    axes = axes or jtopo.MeshAxes()
    mesh = jtopo.make_mesh(axes, jax.devices("cpu")[:axes.size])
    step, init_fn, tok_sh = jtrain.make_sharded_lora_train_step(
        jcfg, mesh, grad_accum=grad_accum, ce_chunk=ce_chunk)
    base, lora, opt = init_fn(jax.random.PRNGKey(0))
    shard = lambda t, like: jax.device_put(t, jax.tree.map(lambda a: a.sharding, like))  # noqa: E731
    jbase, jlora = jtm.split_lora_params(tree)
    base, lora = shard(jbase, base), shard(jlora, lora)
    losses = []
    for tokens in batches:
        lora, opt, loss = step(base, lora, opt, jax.device_put(tokens, tok_sh))
        losses.append(float(loss))
    return losses, _named(jax.device_get(jtm.combine_lora_params(base, lora)))


@pytest.mark.parametrize("attn,mlp,ce_chunk", [("xla", True, 8), ("flash", False, 0)])
def test_three_lora_steps_match_jax(attn, mlp, ce_chunk):
    jcfg, tcfg = _cfgs(lora_rank=4, lora_alpha=8.0, lora_mlp=mlp, attn_impl=attn)
    tree = _init(jcfg, perturb=True)
    batches = _tokens((STEPS, 2, 16), seed=7)
    j_losses, j_params = _jax_lora_steps(jcfg, tree, batches, ce_chunk=ce_chunk)
    step, _ = ttrain.make_lora_train_step(tcfg, "cpu", ce_chunk=ce_chunk)
    base, lora = ttm.split_lora_params(bridge.from_numpy_tree(tree))
    lora = ttrain._trainable_adapters(lora)
    opt = ttrain.make_optimizer()(ttrain._leaves(lora))
    losses = []
    for tokens in batches:
        lora, opt, loss = step(base, lora, opt, torch.from_numpy(tokens))
        losses.append(float(loss))
    np.testing.assert_allclose(losses, j_losses, atol=LOSS_ATOL, rtol=0)
    init = _named(tree)
    for name, t in tckpt.named_leaves(ttm.combine_lora_params(base, lora)).items():
        if ".lora_" in name:
            np.testing.assert_allclose(t.detach().numpy(), j_params[name], atol=PARAM_ATOL,
                                       rtol=0, err_msg=name)
            assert np.abs(j_params[name] - init[name]).max() > 20 * PARAM_ATOL, name
        else:
            # the base never moves: no gradient, no optimizer state
            np.testing.assert_array_equal(t.numpy(), init[name], err_msg=name)
            assert not t.requires_grad
    assert len(opt.state) == len(ttrain._leaves(lora))


def test_lora_grad_accum_matches_full_batch():
    _, tcfg = _cfgs(lora_rank=2, lora_mlp=True)
    tree = _init(_cfgs(lora_rank=2, lora_mlp=True)[0], perturb=True)
    tokens = torch.from_numpy(_tokens((8, 16), seed=3))
    out = {}
    for accum in (1, 4):
        step, _ = ttrain.make_lora_train_step(tcfg, "cpu", grad_accum=accum)
        base, lora = ttm.split_lora_params(bridge.from_numpy_tree(tree))
        lora = ttrain._trainable_adapters(lora)
        opt = ttrain.make_optimizer()(ttrain._leaves(lora))
        lora, opt, loss = step(base, lora, opt, tokens)
        out[accum] = (float(loss), {k: v.detach().clone() for k, v in lora["layers"].items()})
    assert abs(out[1][0] - out[4][0]) < 1e-5
    for name, t in out[1][1].items():
        np.testing.assert_allclose(out[4][1][name].numpy(), t.numpy(), atol=2e-5, rtol=0,
                                   err_msg=name)


def test_lora_step_factories_init_and_refuse():
    _, tcfg = _cfgs(lora_rank=2)
    step, init_fn = ttrain.make_lora_train_step(tcfg, "cpu")
    base, lora, opt = init_fn(torch.Generator().manual_seed(0))
    assert set(lora["layers"]) == {f"lora_{n}_{ab}" for n in ("wq", "wk", "wv", "wo")
                                   for ab in "ab"}
    assert all(t.requires_grad for t in ttrain._leaves(lora))
    assert not any(t.requires_grad for t in ttrain._leaves(base))
    before = {k: v.clone() for k, v in tckpt.named_leaves(base).items()}
    lora, opt, loss = step(base, lora, opt, torch.from_numpy(_tokens()))
    assert np.isfinite(float(loss))
    assert all(torch.equal(t, before[k]) for k, t in tckpt.named_leaves(base).items())
    for bad in (dict(lora_rank=0), dict(lora_rank=0, lora_mlp=True),
                dict(lora_rank=2, lora_mlp=True, n_experts=2)):
        with pytest.raises(ValueError) as err:
            ttrain.make_lora_train_step(_cfgs(**bad)[1], "cpu")
        assert "lora" in str(err.value)


def test_split_combine_round_trip():
    _, tcfg = _cfgs(lora_rank=2, lora_mlp=True)
    params = ttm.init_params(tcfg, torch.Generator().manual_seed(0))
    base, lora = ttm.split_lora_params(params)
    assert not any(k.startswith("lora_") for k in base["layers"])
    assert all(k.startswith("lora_") for k in lora["layers"]) and len(lora["layers"]) == 14
    back = ttm.combine_lora_params(base, lora)
    assert list(tckpt.named_leaves(back)) == list(tckpt.named_leaves(params))
    assert all(a is b for a, b in zip(tckpt.named_leaves(back).values(),
                                      tckpt.named_leaves(params).values()))
    assert list(ttm.sharding_specs(tcfg)["layers"]) == list(params["layers"])


def test_merged_params_generate_token_exact():
    jcfg, tcfg = _cfgs(lora_rank=2, lora_alpha=4.0)
    tree = _init(jcfg, perturb=True)
    jmerged = jtm.merge_lora(jax.tree.map(jnp.asarray, tree), jcfg)
    merged = ttm.merge_lora(bridge.from_numpy_tree(tree), tcfg)
    prompt = _tokens((2, 5), seed=2)
    base_j = dataclasses.replace(jcfg, lora_rank=0)
    base_t = dataclasses.replace(tcfg, lora_rank=0)
    want = np.asarray(jdec.generate(jmerged, jnp.asarray(prompt), base_j, 8))
    got = tdec.generate(merged, torch.from_numpy(prompt), base_t, 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_restore_serving_params_merges_a_lora_checkpoint(tmp_path):
    _, tcfg = _cfgs(lora_rank=2, lora_mlp=True)
    params = ttm.init_params(tcfg, torch.Generator().manual_seed(0))
    for name, t in params["layers"].items():
        if name.endswith("_b"):
            t.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(1))
    opt = ttrain.make_optimizer()(ttrain._leaves(ttm.split_lora_params(params)[1]))
    tckpt.save(str(tmp_path), 1, params, opt)
    base_cfg = dataclasses.replace(tcfg, lora_rank=0, lora_mlp=False)
    got, step = tckpt.restore_serving_params(
        base_cfg, str(tmp_path), torch.Generator().manual_seed(9), lora_rank=2,
        lora_alpha=tcfg.lora_alpha, lora_mlp=True)
    assert step == 1
    want = ttm.merge_lora(params, tcfg)
    assert list(tckpt.named_leaves(got)) == list(tckpt.named_leaves(want))
    for name, t in tckpt.named_leaves(want).items():
        assert torch.equal(tckpt.named_leaves(got)[name], t), name


# -- gloo gangs: the sharded LoRA step against JAX's on the matching mesh --
GANG_CFG = dict(vocab_size=256, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=128,
                max_seq_len=64, attn_block_q=32, attn_block_k=32, lora_rank=4,
                lora_alpha=8.0)
GANG_RUNS = {
    "tp2": dict(tp=2, cfg=dict(GANG_CFG, lora_mlp=True, attn_impl="xla")),
    "fsdp2": dict(fsdp=2, cfg=dict(GANG_CFG, attn_impl="flash"), grad_accum=2),
}


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("lora"))
    trees, jobs = {}, {}
    batches = np.random.default_rng(7).integers(0, 256, (STEPS, 4, 64)).astype(np.int32)
    np.savez(os.path.join(tmp, "batches.npz"), tokens=batches)
    for name, run in GANG_RUNS.items():
        jcfg = jtm.TransformerConfig(dtype=jnp.float32, **run["cfg"])
        trees[name] = _perturb_b(jax.device_get(jtm.init_params(jcfg, jax.random.PRNGKey(0))))
        np.savez(os.path.join(tmp, f"{name}.init.npz"), **_named(trees[name]))
        jobs[name] = _worker_gang(tmp, name, 2, tasks=["train"],
                                  init=os.path.join(tmp, f"{name}.init.npz"),
                                  batches=os.path.join(tmp, "batches.npz"),
                                  **{k: v for k, v in run.items()})
    ref = {}
    for name, run in GANG_RUNS.items():
        jcfg = jtm.TransformerConfig(dtype=jnp.float32, **run["cfg"])
        axes = jtopo.MeshAxes(tp=run.get("tp", 1), fsdp=run.get("fsdp", 1))
        ref[name] = _jax_lora_steps(jcfg, jax.tree.map(jnp.asarray, trees[name]), batches,
                                    axes=axes, grad_accum=run.get("grad_accum", 1))
    return dict(trees=trees, ref=ref, out={name: _result(job) for name, job in jobs.items()})


@pytest.mark.parametrize("name", sorted(GANG_RUNS))
def test_sharded_lora_steps_match_jax(gangs, name):
    j_losses, j_params = gangs["ref"][name]
    out = gangs["out"][name]
    init = _named(gangs["trees"][name])
    np.testing.assert_allclose(out["losses"], j_losses, atol=LOSS_ATOL, rtol=0)
    for key, got in out.items():
        if not key.startswith("params/"):
            continue
        leaf = key[len("params/"):]
        if ".lora_" in leaf:
            np.testing.assert_allclose(got, j_params[leaf], atol=PARAM_ATOL, rtol=0,
                                       err_msg=leaf)
            assert f"opt/{leaf}.exp_avg" in out
        else:
            np.testing.assert_array_equal(got, init[leaf], err_msg=leaf)
            assert not any(k.startswith(f"opt/{leaf}.") for k in out)
    assert np.abs(j_params["layers.lora_wq_a"] - init["layers.lora_wq_a"]).max() > 20 * PARAM_ATOL

