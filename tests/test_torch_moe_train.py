"""The port's mixture-of-experts training and eval against the JAX
package's, on one device and in gloo process groups with ep, tp and fsdp.

The JAX reference is ``make_sharded_train_step`` (one device: a one-device
mesh) on the matching mesh of the CPU devices that ``tests/conftest.py``
forces, from the same numpy weights and batches; each port gang is
``tests/torch_mesh_worker.py`` (or the ``train`` CLI) joined through
``initialize_from_gang``. The port's gangs start first and the JAX
references are built while they run.

Tolerances (f32, a tiny MoE of 4 experts, top-2, z-loss on): losses atol
1e-5 and parameters after three AdamW steps atol 3e-5, as for the dense
model: routing is decided identically on both sides (tests/test_torch_moe.py
holds it exactly), so what is left is summation order, which the expert
region's all-reduces over ep and tp add to. The eval loss at ep=2 against
JAX's eval step: atol 1e-6. A checkpoint saved at ep=2 restores on one
device bit for bit.

On one device the parameters are held at 3e-5 except where the first
step's gradient is within 100 x AdamW's eps of zero and not zero: there
the first update g / (|g| + eps) turns the two sides' f32 rounding of g
(~1e-8, the gradients agree to 1e-7) into a fraction of a step (observed
once: an embed element with g of -5.1e-9 in JAX and -1.7e-8 here moved
6.4e-5 apart), so those few are held to the 2 lr x steps that AdamW can
move them at most. The first step's gradients themselves are held to
atol 1e-5.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu.parallel import checkpoint as jckpt
from hivedscheduler_tpu.parallel import topology as jtopo
from hivedscheduler_tpu.parallel import train as jtrain
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch import eval as teval
from hivedscheduler_tpu_torch import train as ttrain_cli
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.parallel import checkpoint as tckpt
from hivedscheduler_tpu_torch.parallel import train as ttrain

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from test_torch_sharded_train import (  # noqa: E402
    BATCH, CFG, EVAL_ATOL, LOSS_ATOL, PARAM_ATOL, SEQ, STEPS, Gang, _assert_params_close,
    _free_port, _named, _result, _worker_gang)
from torch_mesh_worker import gang_env  # noqa: E402

MOE = dict(CFG, n_experts=4, moe_top_k=2, moe_aux_weight=0.1, moe_zloss_weight=0.05)
# the world-2 gangs (tier-1): mesh degrees and worker options
MESH_RUNS = {
    "ep2": dict(ep=2, tasks=["eval", "train", "save"], ce_chunk=16),
    "tp2": dict(tp=2, tasks=["train"], remat="dots"),
    # 2 slices of 2 global rows, one row of each on each fsdp rank
    "fsdp2-accum2": dict(fsdp=2, grad_accum=2, tasks=["train"]),
}
# world 4 (slow); their fast cousins are ep2, tp2 and fsdp2-accum2
WORLD4_RUNS = {
    "ep2-tp2": dict(ep=2, tp=2),
    "fsdp2-ep2": dict(fsdp=2, ep=2, ce_chunk=16),
}
MOE_FLAGS = ["--n-experts", "4", "--moe-top-k", "2"]
CLI_MODEL = ["--vocab-size", "256", "--d-model", "64", "--n-layers", "2",
             "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "128",
             "--seq-len", "64", "--batch", "4", "--device", "cpu"] + MOE_FLAGS


def _jax_cfg(**over):
    return jtm.TransformerConfig(dtype=jnp.float32, **dict(MOE, **over))


def _inputs(tmp):
    init = jax.device_get(jtm.init_params(_jax_cfg(), jax.random.PRNGKey(0)))
    np.savez(os.path.join(tmp, "init.npz"), **_named(init))
    batches = np.random.default_rng(7).integers(
        0, CFG["vocab_size"], (STEPS, BATCH, SEQ)).astype(np.int32)
    np.savez(os.path.join(tmp, "batches.npz"), tokens=batches)
    return init, batches, dict(init=os.path.join(tmp, "init.npz"),
                               batches=os.path.join(tmp, "batches.npz"))


def _start(tmp, name, world, run, common, **extra):
    cfg = dict(MOE, attn_impl=run.get("attn", "xla"), remat=run.get("remat", "full"))
    return _worker_gang(tmp, name, world, ep=run.get("ep", 1), tp=run.get("tp", 1),
                        fsdp=run.get("fsdp", 1), grad_accum=run.get("grad_accum", 1),
                        ce_chunk=run.get("ce_chunk", 0), cfg=cfg,
                        tasks=run.get("tasks", ["train"]), **common, **extra)


def _jax_mesh(run):
    axes = jtopo.MeshAxes(ep=run.get("ep", 1), tp=run.get("tp", 1), fsdp=run.get("fsdp", 1))
    return jtopo.make_mesh(axes, jax.devices("cpu")[:axes.size])


def _jax_run(run, init, batches):
    """JAX's sharded step of ``run`` from ``init`` -> (losses, final named
    params)."""
    cfg = _jax_cfg(attn_impl=run.get("attn", "xla"), remat=run.get("remat", "full"))
    step, init_fn, tok_sh = jtrain.make_sharded_train_step(
        cfg, _jax_mesh(run), grad_accum=run.get("grad_accum", 1),
        ce_chunk=run.get("ce_chunk", 0))
    params, opt = init_fn(jax.random.PRNGKey(0))
    params = jax.device_put(init, jax.tree.map(lambda a: a.sharding, params))
    losses = []
    for tokens in batches:
        params, opt, loss = step(params, opt, jax.device_put(tokens, tok_sh))
        losses.append(float(loss))
    return losses, _named(jax.device_get(params))


def _jax_eval(run, init, tokens):
    cfg = _jax_cfg()
    eval_step, init_fn, tok_sh = jtrain.make_sharded_eval_step(
        cfg, _jax_mesh(run), ce_chunk=run.get("ce_chunk", 0))
    params = jax.device_put(init, jax.tree.map(lambda a: a.sharding,
                                               init_fn(jax.random.PRNGKey(0))))
    return float(eval_step(params, jax.device_put(tokens, tok_sh)))


def _cli_gang(tmp, name, module, argv):
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "from hivedscheduler_tpu_torch.parallel import distributed; "
            f"distributed.DEFAULT_COORDINATOR_PORT = {_free_port()}; "
            f"from hivedscheduler_tpu_torch import {module}; "
            f"sys.exit({module}.main({argv!r}))")
    return Gang(tmp, name, 2, lambda rank: [sys.executable, "-c", code],
                lambda rank: gang_env(2, rank))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every world-2 port run, the train CLI's ep=2 gang, and the JAX
    references."""
    tmp = str(tmp_path_factory.mktemp("moe"))
    init, batches, common = _inputs(tmp)
    ckpt_dir = os.path.join(tmp, "ckpt-ep2")
    port = {name: _start(tmp, name, 2, run, common, ckpt_dir=ckpt_dir)
            for name, run in MESH_RUNS.items()}
    cli_dir = os.path.join(tmp, "ckpt-cli")
    cli = _cli_gang(tmp, "cli-ep2", "train", CLI_MODEL + [
        "--ep", "2", "--steps", "2", "--log-every", "1", "--checkpoint-dir", cli_dir])
    ref = {name: _jax_run(run, init, batches) for name, run in MESH_RUNS.items()}
    ref["eval-ep2"] = _jax_eval(MESH_RUNS["ep2"], init, batches[0])
    out = {name: _result(job) for name, job in port.items()}
    return dict(init=init, batches=batches, ref=ref, out=out, ckpt_dir=ckpt_dir,
                cli=cli.wait(), cli_dir=cli_dir)


@pytest.mark.parametrize("name", sorted(MESH_RUNS))
def test_three_steps_on_a_mesh_match_jax(runs, name):
    j_losses, j_params = runs["ref"][name]
    out = runs["out"][name]
    np.testing.assert_allclose(out["losses"], j_losses, atol=LOSS_ATOL, rtol=0)
    _assert_params_close(out, j_params, PARAM_ATOL)
    init = _named(runs["init"])
    for leaf in ("layers.router", "layers.w_gate", "layers.wq"):
        assert np.abs(j_params[leaf] - init[leaf]).max() > 20 * PARAM_ATOL, leaf


def test_ep_ranks_read_the_same_rows(runs):
    assert list(runs["out"]["ep2"]["data_part"]) == [0, 1]
    assert list(runs["out"]["fsdp2-accum2"]["data_part"]) == [0, 2]


def test_eval_at_ep2_excludes_the_aux(runs):
    out = runs["out"]["ep2"]
    got, pure, with_aux = (float(out[k]) for k in ("eval_loss", "loss_aux_False",
                                                   "loss_aux_True"))
    assert got == pure
    assert with_aux > pure + 0.05  # the regularizers really were left out
    want = runs["ref"]["eval-ep2"]
    assert abs(got - want) <= EVAL_ATOL, (got, want)


def test_checkpoint_saved_at_ep2_restores_at_ep1(runs):
    saved = runs["out"]["ep2"]
    cfg = ttm.TransformerConfig(dtype=torch.float32, **MOE)
    _, init_fn = ttrain.make_train_step(cfg, "cpu")
    params, opt = init_fn(torch.Generator().manual_seed(1))
    step, _, _ = tckpt.restore(runs["ckpt_dir"], params, opt)
    assert step == STEPS
    names = tckpt.named_leaves(params)
    assert {"layers.router", "layers.w_gate", "layers.w_up", "layers.w_down"} <= set(names)
    for name, t in names.items():
        np.testing.assert_array_equal(t.detach().numpy(), saved[f"params/{name}"])
        for key, m in opt.state[t].items():
            np.testing.assert_array_equal(m.numpy(), saved[f"opt/{name}.{key}"])
    meta = jckpt.read_metadata(runs["ckpt_dir"])
    assert meta["mesh"] == {"dp": 1, "fsdp": 1, "pp": 1, "ep": 2, "tp": 1, "sp": 1}
    assert meta["model"]["n_experts"] == 4
    # a dense model of the same widths cannot load it
    dense = dataclasses.replace(cfg, n_experts=0)
    with pytest.raises(ValueError) as err:
        tckpt.validate_resume_metadata(meta, jtopo.MeshAxes(), dense,
                                       global_batch=BATCH, seq_len=SEQ)
    assert "n_experts: saved 4 != current 0" in str(err.value)


def test_train_cli_at_ep2_and_eval_of_its_checkpoint(runs, capsys):
    rcs, outs = runs["cli"]
    assert rcs == [0, 0], "\n".join(outs)
    assert "step 2 loss" in outs[0] and "step 1 loss" not in outs[1]
    assert "ep=2" in outs[0] and "n_experts=4" in outs[0]
    assert tckpt.latest_step(runs["cli_dir"]) == 2
    # on one process (ep=1) the eval CLI reads the ep=2 checkpoint
    assert teval.main(CLI_MODEL + ["--checkpoint-dir", runs["cli_dir"],
                                   "--max-steps", "1"]) == 0
    loss = float(capsys.readouterr().out.split()[1])
    assert np.isfinite(loss) and loss < 7.0


# one device: (grad_accum, attn_impl, remat, ce_chunk)
ONE_DEVICE = {
    "flash-dots-ce16": (1, "flash", "dots", 16),
    "xla-accum2-dots": (2, "xla", "dots", 0),
}


GRAD_ATOL = 1e-5
ADAMW_EPS, ADAMW_LR = 1e-8, 3e-4


@pytest.mark.parametrize("name", sorted(ONE_DEVICE))
def test_three_steps_on_one_device_match_jax(name):
    grad_accum, attn, remat, ce_chunk = ONE_DEVICE[name]
    jcfg = _jax_cfg(attn_impl=attn, remat=remat)
    init = jax.device_get(jtm.init_params(jcfg, jax.random.PRNGKey(0)))
    batches = np.random.default_rng(3).integers(
        0, CFG["vocab_size"], (STEPS, BATCH, SEQ)).astype(np.int32)
    j_losses, j_params = _jax_run(dict(attn=attn, remat=remat, grad_accum=grad_accum,
                                       ce_chunk=ce_chunk), init, batches)
    _, j_grads = jtrain._accumulated_value_and_grad(
        jax.value_and_grad(lambda p, t: jtrain.loss_fn(p, t, jcfg, ce_chunk=ce_chunk)),
        init, jnp.asarray(batches[0]), grad_accum)
    j_grads = _named(jax.device_get(j_grads))
    tcfg = ttm.TransformerConfig(dtype=torch.float32, **dict(MOE, attn_impl=attn, remat=remat))
    params = bridge.from_numpy_tree(init)
    leaves = ttrain._leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)

    def grad_fn(p, micro):
        loss = ttrain.loss_fn(p, micro, tcfg, ce_chunk=ce_chunk)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    _, grads = ttrain._accumulated_value_and_grad(grad_fn, params,
                                                  torch.from_numpy(batches[0]), grad_accum)
    for name_, g in zip(tckpt.named_leaves(params), grads):
        np.testing.assert_allclose(g.numpy(), j_grads[name_], atol=GRAD_ATOL, rtol=0,
                                   err_msg=name_)
    step, _ = ttrain.make_train_step(tcfg, "cpu", grad_accum=grad_accum, ce_chunk=ce_chunk)
    opt = ttrain.make_optimizer()(leaves)
    losses = [float(step(params, opt, torch.from_numpy(t))[2]) for t in batches]
    np.testing.assert_allclose(losses, j_losses, atol=LOSS_ATOL, rtol=0)
    n_loose = 0
    for name_, t in tckpt.named_leaves(params).items():
        g1 = np.abs(j_grads[name_])
        loose = (g1 > 0) & (g1 < 100 * ADAMW_EPS)
        n_loose += int(loose.sum())
        atol = np.where(loose, 2 * ADAMW_LR * STEPS, PARAM_ATOL)
        diff = np.abs(t.detach().numpy() - j_params[name_])
        assert (diff <= atol).all(), (name_, float(diff.max()))
    assert n_loose < 1e-3 * sum(v.size for v in j_grads.values())


@pytest.mark.parametrize("argv", [
    ["--steps", "2", "--log-every", "1", "--attn", "flash", "--remat", "dots",
     "--ce-chunk", "32", "--block-q", "32", "--block-k", "32", "--moe-zloss", "0.1"],
    ["--steps", "2", "--log-every", "1", "--grad-accum", "2",
     "--expert-capacity-factor", "0.5"],
], ids=["flash-dots", "accum2-drops"])
def test_train_cli_with_moe_on_one_process(argv, tmp_path):
    import json

    timeline = str(tmp_path / "t.jsonl")
    assert ttrain_cli.main(CLI_MODEL + argv + ["--timeline", timeline]) == 0
    with open(timeline) as f:
        losses = [json.loads(line)["loss"] for line in f]
    assert len(losses) == 2 and all(np.isfinite(losses))


@pytest.mark.parametrize("extra,message", [
    # MoE at --sp above 1 is ported (tests/test_torch_moe_sp.py): on one
    # process its mesh cannot be laid
    (["--sp", "2"], "1 devices not divisible by tp*sp*fsdp*pp*ep=2"),
    (["--ep", "3"], "1 devices not divisible by tp*sp*fsdp*pp*ep=3"),
])
def test_moe_clis_refuse_what_is_not_ported(extra, message, capsys):
    for main in (ttrain_cli.main, teval.main):
        with pytest.raises(SystemExit) as exc:
            main(CLI_MODEL + extra)
        assert exc.value.code == 2
        assert message in capsys.readouterr().err


@pytest.mark.slow
@pytest.mark.parametrize("name", sorted(WORLD4_RUNS))
def test_world_4_matches_jax(name, tmp_path):
    run = WORLD4_RUNS[name]
    init, batches, common = _inputs(str(tmp_path))
    job = _start(str(tmp_path), name, 4, run, common)
    j_losses, j_params = _jax_run(run, init, batches)
    out = _result(job)
    np.testing.assert_allclose(out["losses"], j_losses, atol=LOSS_ATOL, rtol=0)
    _assert_params_close(out, j_params, PARAM_ATOL)
