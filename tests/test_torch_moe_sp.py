"""The port's mixture of experts at sp > 1 (global capacity over the
sequence) against the JAX package, on gloo gangs on the CPU.

The reference is the JAX package's model on one device, from the same
numpy weights (``tests/test_pipeline_moe.py``'s tiny f32 config with 4
experts): its GSPMD path at sp > 1 computes the unsharded routing, which
is what the port's ``manual_sp_axis`` form must reproduce. Each gang is
``tests/torch_mesh_worker.py`` with several cases on one process group.

- sp = 2 (one gang, six cases): (capacity factor, top-k) = (1.25, 1)
  (capacity 5: the all-reduce over sp), (2.0, 1) (capacity 8: the
  reduce-scatter) and (1.25, 2) (the cross-slice choice order), each with
  ``ring`` and with ``flash`` (which gathers the sequence). Logits atol
  1e-4 and every leaf's gradient (the loss with the aux, z-loss on) atol
  1e-4, as ``test_moe_inside_sp_pipeline_matches_dense`` holds JAX's; the
  aux atol 1e-6: the statistics are the global means, JAX's.
- sp 2 x ep 2 (a world-4 gang): three train steps' losses against JAX's
  ``make_sharded_train_step`` on the same CPU mesh, atol 1e-5, and the
  parameters at 3e-5 (``test_torch_sharded_train.py``'s limits).
- ``eval --n-experts 4 --sp 2`` as a 2-rank gang against JAX's eval CLI
  on 2 CPU devices, both in f32 from the same weights: atol 1e-5.
- sp = 1: a one-rank mesh gives the mesh-less path's logits, aux and
  gradients bit for bit, and issues no collective.
"""

import dataclasses
import functools
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
from hivedscheduler_tpu.parallel import topology as jtopo
from hivedscheduler_tpu.parallel import train as jtrain
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch.chaos import workload as tchaos
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.parallel import distributed as tdist
from hivedscheduler_tpu_torch.parallel import sharding as tsharding
from hivedscheduler_tpu_torch.parallel import topology as ttopo
from hivedscheduler_tpu_torch.parallel import train as ttrain

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from test_torch_sharded_train import (  # noqa: E402
    LOSS_ATOL, PARAM_ATOL, _assert_params_close, _named, _result, _worker_gang)

# tests/test_pipeline_moe.py's tiny config, f32
TINY = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64, max_seq_len=32)
MOE = dict(TINY, n_experts=4, moe_aux_weight=0.1, moe_zloss_weight=0.05)
BATCH, SEQ, STEPS = 4, 16, 3
LOGIT_ATOL = GRAD_ATOL = 1e-4
AUX_ATOL = 1e-6
EVAL_ATOL = 1e-5
# (capacity factor, top-k): capacity ceil(16 k / 4 x cf) = 5, 8, 10
ROUTINGS = {"cf1.25-top1": (1.25, 1), "cf2-top1": (2.0, 1), "cf1.25-top2": (1.25, 2)}
SP_CASES = {f"{name}-{attn}": dict(expert_capacity_factor=cf, moe_top_k=k, attn_impl=attn)
            for name, (cf, k) in ROUTINGS.items() for attn in ("ring", "flash")}
JOB_TIMEOUT = 240


def _cfg(**over):
    return dict(MOE, **over)


def _jax_cfg(**over):
    return jtm.TransformerConfig(dtype=jnp.float32, **_cfg(**over))


def _inputs(tmp):
    init = jax.device_get(jtm.init_params(_jax_cfg(), jax.random.PRNGKey(0)))
    np.savez(os.path.join(tmp, "init.npz"), **_named(init))
    batches = np.random.default_rng(11).integers(
        0, TINY["vocab_size"], (STEPS, BATCH, SEQ)).astype(np.int32)
    np.savez(os.path.join(tmp, "batches.npz"), tokens=batches)
    return init, batches, dict(init=os.path.join(tmp, "init.npz"),
                               batches=os.path.join(tmp, "batches.npz"))


def jax_one_device(over, init, tokens):
    """JAX's one-device logits, aux and per-leaf gradients of the training
    loss (the aux included) for the config ``over``."""
    cfg = _jax_cfg(**dict(over, attn_impl="xla"))
    logits, aux = jtm.forward_with_aux(init, jnp.asarray(tokens), cfg)
    grads = jax.grad(lambda p: jtrain.loss_fn(p, jnp.asarray(tokens), cfg))(init)
    return np.asarray(logits), float(aux), _named(jax.device_get(grads))


def assert_forward_and_grads(out, ref, what=""):
    logits, aux, grads = ref
    np.testing.assert_allclose(out["logits"], logits, atol=LOGIT_ATOL, rtol=0,
                               err_msg=what)
    assert float(out["replica_spread"]) == 0.0, what
    for name, g in grads.items():
        np.testing.assert_allclose(out[f"grads/{name}"], g, atol=GRAD_ATOL, rtol=0,
                                   err_msg=f"{what} {name}")
    return aux


# the CLIs in f32 from the weights in $HIVED_TEST_INIT (an .npz of named
# leaves): each package's config dtype and init_params patched before main
PORT_F32_INIT = (
    "import functools, os, numpy as np, torch\n"
    "from hivedscheduler_tpu_torch import bridge\n"
    "from hivedscheduler_tpu_torch.models import transformer as tm\n"
    "tm.TransformerConfig = functools.partial(tm.TransformerConfig, dtype=torch.float32)\n"
    "_init = tm.init_params\n"
    "def _loaded(cfg, generator, device='cpu'):\n"
    "    if str(device) == 'meta':\n"
    "        return _init(cfg, generator, device)\n"
    "    tree = {}\n"
    "    with np.load(os.environ['HIVED_TEST_INIT']) as f:\n"
    "        for name, value in f.items():\n"
    "            node = tree\n"
    "            *path, leaf = name.split('.')\n"
    "            for key in path:\n"
    "                node = node.setdefault(key, {})\n"
    "            node[leaf] = value\n"
    "    return bridge.from_numpy_tree(tree, device)\n"
    "tm.init_params = _loaded\n")
JAX_F32_INIT = (
    "import functools, os, sys, numpy as np, jax.numpy as jnp\n"
    "from hivedscheduler_tpu.models import transformer as tm\n"
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
    "tm.init_params = _loaded\n")


def port_cli_gang(tmp, name, module, world, argv, init_path):
    """``module.main(argv)`` on each rank of a one-pod gloo gang, in f32
    from ``init_path``'s weights; each rank's output in ``{name}.{rank}.log``."""
    code = (PORT_F32_INIT + tchaos._GANG_LAUNCH).replace(
        "from hivedscheduler_tpu_torch import train\n",
        f"from hivedscheduler_tpu_torch import {module} as train\n")
    port = str(tdist._free_local_port())
    procs = []
    for rank in range(world):
        log = open(os.path.join(tmp, f"{name}.{rank}.log"), "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-c", code, port] + argv, cwd=ROOT,
            env=tchaos.cpu_only_env(gang=(world, rank), HIVED_TEST_INIT=init_path),
            stdout=log, stderr=subprocess.STDOUT))
    return procs


def jax_cli(tmp, name, module, devices, argv, init_path):
    """JAX's ``module`` CLI as a subprocess on ``devices`` forced CPU
    devices, in f32 from ``init_path``'s weights; output in ``{name}.log``."""
    code = JAX_F32_INIT + (f"from hivedscheduler_tpu import {module}\n"
                           f"sys.exit({module}.main(sys.argv[1:]))\n")
    return subprocess.Popen(
        [sys.executable, "-c", code] + argv, cwd=ROOT,
        env=jchaos.cpu_only_env(devices=devices, HIVED_TEST_INIT=init_path),
        stdout=open(os.path.join(tmp, f"{name}.log"), "w"), stderr=subprocess.STDOUT)


def wait_all(procs, tmp, names):
    """Exit codes and logs of ``procs`` (their logs named ``names``)."""
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(timeout=JOB_TIMEOUT))
        except subprocess.TimeoutExpired:
            p.kill()
            rcs.append(p.wait())
    return rcs, [open(os.path.join(tmp, n)).read() for n in names]


def wait_gang(gang_and_out):
    """Wait for a worker gang whose cases write their own outputs."""
    gang, _ = gang_and_out
    rcs, outs = gang.wait()
    assert rcs == [0] * len(rcs), f"{gang.name} exited {rcs}:\n" + "\n".join(outs)


def _eval_loss(text: str) -> float:
    lines = [line for line in text.splitlines() if line.startswith("loss ")]
    assert len(lines) == 1, text
    return float(lines[0].split()[1])


EVAL_ARGV = ["--vocab-size", "64", "--d-model", "32", "--n-layers", "4", "--n-heads", "4",
             "--d-ff", "64", "--seq-len", "16", "--batch", "4", "--n-experts", "4",
             "--moe-top-k", "2", "--sp", "2", "--max-steps", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("moe-sp"))
    init, batches, common = _inputs(tmp)
    cases = [dict(name=name, cfg=_cfg(**over), out=os.path.join(tmp, f"{name}.npz"),
                  tasks=["forward", "grads"]) for name, over in SP_CASES.items()]
    sp2 = _worker_gang(tmp, "sp2", 2, sp=2, cfg=_cfg(), tasks=[], cases=cases, **common)
    ep_run = dict(attn_impl="ring", moe_top_k=2)
    sp2ep2 = _worker_gang(tmp, "sp2-ep2", 4, sp=2, ep=2, cfg=_cfg(**ep_run),
                          tasks=["train"], **common)
    evals = port_cli_gang(tmp, "eval-port", "eval", 2, EVAL_ARGV + ["--device", "cpu"],
                          common["init"])
    jax_eval = jax_cli(tmp, "eval-jax", "eval", 2, EVAL_ARGV, common["init"])

    ref = {name: jax_one_device(over, init, batches[0]) for name, over in SP_CASES.items()}
    # JAX's sharded step on the same sp 2 x ep 2 mesh of CPU devices
    axes = jtopo.MeshAxes(sp=2, ep=2)
    step, init_fn, tok_sh = jtrain.make_sharded_train_step(
        _jax_cfg(**ep_run), jtopo.make_mesh(axes, jax.devices("cpu")[:4]))
    params, opt = init_fn(jax.random.PRNGKey(0))
    params = jax.device_put(init, jax.tree.map(lambda a: a.sharding, params))
    j_losses = []
    for tokens in batches:
        params, opt, loss = step(params, opt, jax.device_put(tokens, tok_sh))
        j_losses.append(float(loss))
    rcs, logs = wait_all(evals + [jax_eval], tmp,
                         ["eval-port.0.log", "eval-port.1.log", "eval-jax.log"])
    wait_gang(sp2)
    return dict(tmp=tmp, init=init, ref=ref,
                out={name: dict(np.load(os.path.join(tmp, f"{name}.npz")))
                     for name in SP_CASES},
                sp2ep2=(_result(sp2ep2), j_losses, _named(jax.device_get(params))),
                evals=(rcs, logs))


@pytest.mark.parametrize("name", sorted(SP_CASES))
def test_moe_at_sp2_matches_jax_forward_and_gradients(runs, name):
    aux = assert_forward_and_grads(runs["out"][name], runs["ref"][name], name)
    # the statistics are the global means (MeshShards.data_mean over dp,
    # fsdp and sp): the aux is the one-device aux
    assert abs(float(runs["out"][name]["aux"]) - aux) <= AUX_ATOL, name


def test_capacity_cases_take_both_expert_sums(runs):
    # capacity ceil(T k / E x cf) on the whole length T = 16: 5 does not
    # split over sp = 2 (the all-reduce), 8 and 10 do (the reduce-scatter)
    caps = {name: int(np.ceil(SEQ * k / MOE["n_experts"] * cf))
            for name, (cf, k) in ROUTINGS.items()}
    assert caps == {"cf1.25-top1": 5, "cf2-top1": 8, "cf1.25-top2": 10}
    # and on a row of one repeated token, which every layer routes to one
    # expert, capacity decides the output
    tokens = jnp.zeros((1, SEQ), jnp.int32) + 3
    ample, tight = (np.asarray(jtm.forward(runs["init"], tokens,
                                           _jax_cfg(expert_capacity_factor=cf)))
                    for cf in (8.0, 1.25))
    assert np.abs(ample - tight).max() > 1e-3


def test_sp2_ep2_train_steps_match_jax(runs):
    out, j_losses, j_params = runs["sp2ep2"]
    np.testing.assert_allclose(out["losses"], j_losses, atol=LOSS_ATOL, rtol=0)
    _assert_params_close(out, j_params, PARAM_ATOL)


def test_eval_cli_at_sp2_with_experts_matches_jax_cli(runs):
    rcs, (port0, port1, jax_log) = runs["evals"]
    assert rcs == [0, 0, 0], "\n".join((port0, port1, jax_log))
    got, want = _eval_loss(port0), _eval_loss(jax_log)
    assert "MeshAxes(dp=1, fsdp=1, pp=1, ep=1, tp=1, sp=2)" in port0
    assert abs(got - want) <= EVAL_ATOL, (got, want)


def test_sp1_mesh_is_bit_identical_to_the_meshless_path(monkeypatch):
    """At sp = 1 MoE issues no new collective and computes today's numbers
    bit for bit: a one-rank mesh against no mesh, forward and gradients."""
    cfg = ttm.TransformerConfig(dtype=torch.float32, **_cfg(moe_top_k=2))
    init = jax.device_get(jtm.init_params(_jax_cfg(moe_top_k=2), jax.random.PRNGKey(0)))
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, 64, (BATCH, SEQ)).astype(np.int32))
    plain = bridge.from_numpy_tree(init)
    for leaf in ttrain._leaves(plain):
        leaf.requires_grad_(True)
    with torch.no_grad():
        want_logits, want_aux = ttm.forward_with_aux(plain, tokens, cfg)
    want_loss, want_grads = ttrain.value_and_grad(plain, tokens, cfg)
    calls = []
    for fn in ("_all_gather", "_reduce_scatter", "_all_reduce"):
        real = getattr(tsharding, fn)
        monkeypatch.setattr(tsharding, fn, functools.partial(
            lambda real, name, *a, **kw: calls.append(name) or real(*a, **kw), real, fn))
    try:
        tdist.initialize_from_gang(device="cpu")
        mesh = ttopo.make_mesh(ttopo.MeshAxes(), "cpu")
        params = bridge.distribute_tree(init, mesh, ttm.sharding_specs(cfg))
        for leaf in ttrain._leaves(params):
            leaf.requires_grad_(True)
        with torch.no_grad():
            logits, aux = ttm.forward_with_aux(params, tokens, cfg, mesh)
        loss, grads = ttrain.value_and_grad(params, tokens, cfg, mesh)
    finally:
        tdist.shutdown()
    assert calls == []
    assert torch.equal(logits, want_logits) and torch.equal(aux, want_aux)
    assert torch.equal(loss, want_loss)
    for g, w in zip(grads, want_grads):
        assert torch.equal(g.to_local(), w)


def test_route_at_sp1_keeps_its_capacity():
    # the capacity is on the whole length: at sp = 1 it is T's, as before
    cfg = ttm.TransformerConfig(dtype=torch.float32, **_cfg(expert_capacity_factor=1.25))
    h = torch.randn(2, SEQ, TINY["d_model"], generator=torch.Generator().manual_seed(0))
    router = torch.randn(TINY["d_model"], 4, generator=torch.Generator().manual_seed(1))
    combine, _, _, _ = ttm._moe_route(h, router, dataclasses.replace(cfg))
    assert combine.shape == (2, SEQ, 4, 5)
