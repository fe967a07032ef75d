"""The port's GPipe pipeline (``parallel/pipeline.py``) against the JAX
package, on gloo gangs on the CPU.

The reference for logits, losses and gradients is the JAX package's model
WITHOUT the pipeline, from the same numpy weights: its own manual pipeline
has a known layout gap (``tests/test_pipeline_moe.py``
``test_loss_identical_across_layouts``, a red under ``-m slow``). The one
exception is the MoE aux, which the pipeline takes per microbatch and data
shard (meaned over sp only) by design: it is held to JAX's PIPELINED
``forward_with_aux`` on the same CPU mesh, and a MoE model's gradients to
JAX's non-pipelined cross-entropy gradient plus the gradient of JAX's
pipelined aux.

Config: ``tests/test_pipeline_moe.py``'s tiny f32 one (vocab 64, d 32, 4
heads, 4 layers, d_ff 64, T 16, B 4), 2 microbatches. Limits: logits and
gradients atol 1e-4 (JAX's own pipeline tests'), the aux atol 1e-5.

- world 2 (one gang): pp 2 dense; pp 2 with remat dots, ce_chunk 8 and
  grad_accum 2; pp 2 MoE (top-2, z-loss); pp 2 LoRA (rank 2, MLP adapters
  too: the adapters' gradients alone, the base frozen); and the cross-layout
  checkpoints: a pp 2 save restored at dp 2, a dp 2 save restored at pp
  2, params and AdamW moments equal (the pp 2 save restored on one device
  is checked in this process).
- world 4 (one gang): dp 2 x pp 2, pp 2 x tp 2 (GQA), pp 2 x fsdp 2, pp 2
  x sp 2 (ring), pp 2 x ep 2 (MoE), and MoE in an sp 2 pipeline at
  (capacity factor, top-k) (1.25, 1), (2.0, 1) and (1.25, 2).
- world 8 (``-m slow``): dp 2 x pp 2 x tp 2 and pp 2 x sp 2 x ep 2 (MoE);
  their fast cousins are the world-4 cases.
- in this process: the refusals with JAX's messages, the pp layout of
  ``sharding_specs``, and a one-stage pipeline on a one-rank mesh equal to
  the plain forward and gradients.
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
from hivedscheduler_tpu.parallel import topology as jtopo
from hivedscheduler_tpu.parallel import train as jtrain
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.parallel import checkpoint as tckpt
from hivedscheduler_tpu_torch.parallel import distributed as tdist
from hivedscheduler_tpu_torch.parallel import pipeline as tpipe
from hivedscheduler_tpu_torch.parallel import topology as ttopo
from hivedscheduler_tpu_torch.parallel import train as ttrain

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

from test_torch_moe_sp import ROUTINGS, wait_gang  # noqa: E402
from test_torch_sharded_train import _named, _worker_gang  # noqa: E402

TINY = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=4, d_ff=64, max_seq_len=32)
MOE = dict(n_experts=4, moe_top_k=2, moe_aux_weight=0.1, moe_zloss_weight=0.05)
BATCH, SEQ, STEPS, N_MICRO = 4, 16, 3, 2
ATOL = 1e-4
AUX_ATOL = 1e-5

# name: (mesh degrees, config over TINY, worker options); "moe" marks a
# case whose aux and gradients take JAX's pipelined aux
WORLD2 = {
    "pp2": (dict(pp=2), {}, {}),
    "pp2-dots-ce8-accum2": (dict(pp=2), dict(remat="dots"), dict(ce_chunk=8, grad_accum=2)),
    "pp2-moe": (dict(pp=2), MOE, {}),
    # the adapters alone train, the base frozen (JAX's
    # test_lora_inside_pipeline_matches_nonpipelined)
    "pp2-lora-mlp": (dict(pp=2), dict(lora_rank=2, lora_mlp=True), {}),
}
WORLD4 = {
    "dp2-pp2": (dict(pp=2), {}, {}),
    "pp2-tp2-gqa": (dict(pp=2, tp=2), dict(n_kv_heads=2), {}),
    "pp2-fsdp2": (dict(pp=2, fsdp=2), {}, {}),
    "pp2-sp2-ring": (dict(pp=2, sp=2), dict(attn_impl="ring"), {}),
    "pp2-ep2-moe": (dict(pp=2, ep=2), MOE, {}),
    **{f"pp2-sp2-moe-{name}": (dict(pp=2, sp=2), dict(
        MOE, attn_impl="ring", expert_capacity_factor=cf, moe_top_k=k), {})
       for name, (cf, k) in ROUTINGS.items()},
}
WORLD8 = {
    "dp2-pp2-tp2": (dict(pp=2, tp=2), {}, {}),
    "pp2-sp2-ep2-moe": (dict(pp=2, sp=2, ep=2), dict(MOE, attn_impl="ring"), {}),
}


def _cfg(over, pipelined=True):
    cfg = dict(TINY, **over)
    if pipelined:
        cfg["pipeline_microbatches"] = N_MICRO
    return cfg


def _jax_cfg(over, pipelined=False):
    cfg = _cfg(over, pipelined)
    if not pipelined:
        cfg["attn_impl"] = "xla"
    return jtm.TransformerConfig(dtype=jnp.float32, **cfg)


GEOMETRY = ("n_kv_heads", "n_experts", "lora_rank", "lora_mlp")


def _geometry(over) -> str:
    return "-".join(f"{k}{over.get(k, 0)}" for k in GEOMETRY)


class Inputs:
    """The batches, and each model geometry's weights from seed 0 (as an
    .npz of named leaves for the workers)."""

    def __init__(self, tmp):
        self.tmp, self.trees = tmp, {}
        self.batches = np.random.default_rng(13).integers(
            0, TINY["vocab_size"], (STEPS, BATCH, SEQ)).astype(np.int32)
        self.batches_path = os.path.join(tmp, "batches.npz")
        np.savez(self.batches_path, tokens=self.batches)

    def init(self, over):
        key = _geometry(over)
        if key not in self.trees:
            self.trees[key] = jax.device_get(jtm.init_params(
                _jax_cfg({k: v for k, v in over.items() if k in GEOMETRY}),
                jax.random.PRNGKey(0)))
            np.savez(self.path(over), **_named(self.trees[key]))
        return self.trees[key]

    def path(self, over):
        return os.path.join(self.tmp, f"init-{_geometry(over)}.npz")


def _cases(tmp, runs, inputs):
    cases = []
    for name, (mesh, over, opts) in runs.items():
        inputs.init(over)
        cases.append(dict(name=name, cfg=_cfg(over), out=os.path.join(tmp, f"{name}.npz"),
                          init=inputs.path(over), tasks=["forward", "grads"],
                          **dict(dict(tp=1, sp=1, fsdp=1, ep=1, pp=1), **mesh), **opts))
    return cases


def jax_reference(run, world, inputs, tokens):
    """(logits, aux, named gradients, the non-pipelined aux) that the port's
    pipelined case ``run`` on ``world`` ranks must give: JAX's
    non-pipelined model on one device, and for a MoE model the aux of JAX's
    pipeline on the case's mesh (its gradient added to the non-pipelined
    cross-entropy's)."""
    mesh_degrees, over, opts = run
    moe = "n_experts" in over
    init = inputs.init(over)
    cfg = _jax_cfg(over)
    t = jnp.asarray(tokens)
    logits, aux = jtm.forward_with_aux(init, t, cfg)
    ce_chunk, grad_accum = opts.get("ce_chunk", 0), opts.get("grad_accum", 1)
    _, grads = jtrain._accumulated_value_and_grad(
        jax.value_and_grad(lambda p, x: jtrain.loss_fn(
            p, x, cfg, ce_chunk=ce_chunk, include_aux=not moe)),
        init, t, grad_accum)
    grads = _named(jax.device_get(grads))
    if "lora_rank" in over:
        grads = {k: v for k, v in grads.items() if ".lora_" in k}
    global_aux = float(aux)
    if moe:
        axes = jtopo.MeshAxes(dp=world // int(np.prod(list(mesh_degrees.values()))),
                              **mesh_degrees)
        mesh = jtopo.make_mesh(axes, jax.devices("cpu")[:axes.size])
        pcfg = _jax_cfg(over, pipelined=True)

        def pipelined_aux(p):
            return jtm.forward_with_aux(p, t, pcfg, mesh=mesh)[1]

        aux, aux_grads = jax.jit(jax.value_and_grad(pipelined_aux))(init)
        for key, g in _named(jax.device_get(aux_grads)).items():
            grads[key] = grads[key] + g
    return np.asarray(logits), float(aux), grads, global_aux


def assert_matches(out, ref, name):
    logits, aux, grads, _ = ref
    np.testing.assert_allclose(out["logits"], logits, atol=ATOL, rtol=0, err_msg=name)
    # every pp (and tp, ep) replica holds the last stage's output
    assert float(out["replica_spread"]) == 0.0, name
    assert abs(float(out["aux"]) - aux) <= AUX_ATOL, (name, float(out["aux"]), aux)
    for key, g in grads.items():
        np.testing.assert_allclose(out[f"grads/{key}"], g, atol=ATOL, rtol=0,
                                   err_msg=f"{name} {key}")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("pipeline"))
    inputs = Inputs(tmp)
    inputs.init({})
    common = dict(batches=inputs.batches_path, init=inputs.path({}))
    ck_pp, ck_dp = os.path.join(tmp, "ck-pp2"), os.path.join(tmp, "ck-dp2")
    layouts = [
        # trained at pp 2 and saved; restored at dp 2, which trains and saves
        # in its turn; that restored at pp 2
        dict(name="save-pp2", pp=2, cfg=_cfg({}), tasks=["train", "save"],
             ckpt_dir=ck_pp, out=os.path.join(tmp, "save-pp2.npz")),
        dict(name="dp2", cfg=_cfg({}, pipelined=False), tasks=["restore", "train", "save"],
             ckpt_dir=ck_pp, save_dir=ck_dp, out=os.path.join(tmp, "dp2.npz")),
        dict(name="restore-pp2", pp=2, cfg=_cfg({}), tasks=["restore"],
             ckpt_dir=ck_dp, out=os.path.join(tmp, "restore-pp2.npz")),
    ]
    gang2 = _worker_gang(tmp, "world2", 2, cfg=_cfg({}), tasks=[], **common,
                         cases=_cases(tmp, WORLD2, inputs) + layouts)
    gang4 = _worker_gang(tmp, "world4", 4, cfg=_cfg({}), tasks=[], **common,
                         cases=_cases(tmp, WORLD4, inputs))
    refs = {name: jax_reference(run, world, inputs, inputs.batches[0])
            for world, table in ((2, WORLD2), (4, WORLD4)) for name, run in table.items()}
    wait_gang(gang2)
    wait_gang(gang4)
    out = {name: dict(np.load(os.path.join(tmp, f"{name}.npz")))
           for name in list(WORLD2) + list(WORLD4) + [c["name"] for c in layouts]}
    return dict(refs=refs, out=out, ck_pp=ck_pp)


@pytest.mark.parametrize("name", sorted(WORLD2) + sorted(WORLD4))
def test_pipeline_matches_jax(runs, name):
    assert_matches(runs["out"][name], runs["refs"][name], name)


@pytest.mark.parametrize("name", ["pp2-moe", "pp2-ep2-moe"])
def test_pipelined_moe_aux_is_not_the_global_one(runs, name):
    # by design (the JAX package's stage body): the aux of each microbatch
    # and data shard differs from the model's without the pipeline, whose
    # statistics are global; the check above holds it to JAX's pipeline
    _, pipelined, _, global_aux = runs["refs"][name]
    assert abs(float(runs["out"][name]["aux"]) - pipelined) <= AUX_ATOL
    assert abs(pipelined - global_aux) > 100 * AUX_ATOL, (pipelined, global_aux)


def _assert_state_equal(saved, restored, prefix="restored/"):
    keys = [k for k in saved if k.startswith(("params/", "opt/"))]
    assert any(k.startswith("opt/") for k in keys)
    for key in keys:
        np.testing.assert_array_equal(restored[prefix + key], saved[key], err_msg=key)


def test_pp2_checkpoint_restores_at_dp2_and_back(runs):
    out = runs["out"]
    _assert_state_equal(out["save-pp2"], out["dp2"])
    _assert_state_equal(out["dp2"], out["restore-pp2"])
    # each layout trained: the dp 2 run moved on from the pp 2 commit
    assert not np.array_equal(out["dp2"]["params/layers.wq"],
                              out["save-pp2"]["params/layers.wq"])


def test_pp2_checkpoint_restores_on_one_device(runs):
    saved = runs["out"]["save-pp2"]
    cfg = ttm.TransformerConfig(dtype=torch.float32, **_cfg({}, pipelined=False))
    _, init_fn = ttrain.make_train_step(cfg, "cpu")
    params, opt = init_fn(torch.Generator().manual_seed(1))
    step, _, _ = tckpt.restore(runs["ck_pp"], params, opt)
    assert step == STEPS
    for name, t in tckpt.named_leaves(params).items():
        np.testing.assert_array_equal(t.detach().numpy(), saved[f"params/{name}"])
        for key, m in opt.state[t].items():
            np.testing.assert_array_equal(m.numpy(), saved[f"opt/{name}.{key}"])
    assert tckpt.read_metadata(runs["ck_pp"])["mesh"]["pp"] == 2


def _jax_error(cfg_over, axes, batch=BATCH):
    cfg = jtm.TransformerConfig(dtype=jnp.float32, **_cfg(cfg_over))
    mesh = jtopo.make_mesh(axes, jax.devices("cpu")[:axes.size])
    params = jtm.init_params(cfg, jax.random.PRNGKey(0))
    with pytest.raises((ValueError, AssertionError)) as err:
        jtm.forward(params, jnp.zeros((batch, SEQ), jnp.int32), cfg, mesh=mesh)
    return str(err.value)


@pytest.mark.parametrize("over,axes", [
    ({}, dict(pp=2, sp=2)),  # sp > 1 needs the ring family in a stage
    (dict(n_kv_heads=2), dict(pp=2, tp=4)),  # kv heads must divide tp
    (dict(n_experts=3), dict(pp=2, ep=2)),  # experts must split over ep
    (dict(attn_impl="ulysses", n_heads=2), dict(pp=2, sp=4)),  # Ulysses' heads
], ids=["sp-local-attention", "gqa-tp", "experts-ep", "ulysses-heads"])
def test_pipeline_refusals_carry_jax_messages(over, axes):
    want = _jax_error(over, jtopo.MeshAxes(**axes))
    cfg = ttm.TransformerConfig(dtype=torch.float32, **_cfg(over))
    with pytest.raises(ValueError) as err:
        ttm.check_mesh(cfg, axes)
    assert str(err.value) == want


def test_pipeline_refuses_layers_pp_does_not_split_and_a_meshless_run():
    cfg = ttm.TransformerConfig(dtype=torch.float32, **_cfg(dict(n_layers=3)))
    with pytest.raises(ValueError) as err:
        ttm.check_mesh(cfg, dict(pp=2))
    assert str(err.value) == "n_layers 3 does not split over pp=2 pipeline stages"
    # the pipeline needs a mesh, as in the JAX package; a model that is not
    # pipelined cannot take a mesh with pp above 1
    with pytest.raises(ValueError) as err:
        ttm.forward(None, torch.zeros((BATCH, SEQ), dtype=torch.int32), cfg)
    assert str(err.value) == "xla/pipeline requires a mesh"
    with pytest.raises(ValueError) as err:
        ttm.check_mesh(dataclasses.replace(cfg, pipeline_microbatches=0), dict(pp=2))
    assert "needs a pipelined model" in str(err.value)


def test_sharding_specs_put_the_layer_axis_on_pp():
    for over in ({}, MOE, dict(lora_rank=2, lora_mlp=True)):
        jspecs = jtm.sharding_specs(jtm.TransformerConfig(**_cfg(over)))
        tspecs = ttm.sharding_specs(ttm.TransformerConfig(**_cfg(over)))
        for name, spec in tspecs["layers"].items():
            assert tuple(jspecs["layers"][name]) == spec, name
            assert spec[0] == "pp"
        assert tspecs["embed"] == (None, "fsdp")
    assert tpipe.bubble(2, 4) == 0.2


def test_one_stage_pipeline_equals_the_plain_model():
    """At pp = 1 the library still runs the schedule (JAX's pipeline_apply
    with one stage): on a one-rank mesh its logits and gradients equal the
    plain model's, and a batch that the microbatches do not split raises
    JAX's message."""
    inits = jax.device_get(jtm.init_params(_jax_cfg({}), jax.random.PRNGKey(0)))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, 64, (BATCH, SEQ)).astype(np.int32))
    plain_cfg = ttm.TransformerConfig(dtype=torch.float32, **_cfg({}, pipelined=False))
    pp_cfg = ttm.TransformerConfig(dtype=torch.float32, **_cfg({}))
    want_jax = _jax_error({}, jtopo.MeshAxes(pp=2), batch=3)
    try:
        tdist.initialize_from_gang(device="cpu")
        mesh = ttopo.make_mesh(ttopo.MeshAxes(), "cpu")
        got = {}
        for name, cfg in (("plain", plain_cfg), ("pp", pp_cfg)):
            params = bridge.distribute_tree(inits, mesh, ttm.sharding_specs(cfg))
            for leaf in ttrain._leaves(params):
                leaf.requires_grad_(True)
            with torch.no_grad():
                logits = ttm.forward(params, tokens, cfg, mesh)
            loss, grads = ttrain.value_and_grad(params, tokens, cfg, mesh)
            got[name] = (logits, loss, [g.to_local() for g in grads])
        with pytest.raises(ValueError) as err:
            with torch.no_grad():
                ttm.forward(params, tokens[:3], pp_cfg, mesh)
    finally:
        tdist.shutdown()
    assert str(err.value) == want_jax == "local batch 3 not divisible by 2 microbatches"
    torch.testing.assert_close(got["pp"][0], got["plain"][0], atol=1e-6, rtol=0)
    torch.testing.assert_close(got["pp"][1], got["plain"][1], atol=1e-6, rtol=0)
    for a, b in zip(got["pp"][2], got["plain"][2]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


@pytest.mark.slow
def test_world_8_pipelines_match_jax(tmp_path):
    tmp = str(tmp_path)
    inputs = Inputs(tmp)
    inputs.init({})
    gang = _worker_gang(tmp, "world8", 8, cfg=_cfg({}), tasks=[],
                        batches=inputs.batches_path, init=inputs.path({}),
                        cases=_cases(tmp, WORLD8, inputs))
    refs = {name: jax_reference(run, 8, inputs, inputs.batches[0])
            for name, run in WORLD8.items()}
    wait_gang(gang)
    for name in WORLD8:
        assert_matches(dict(np.load(os.path.join(tmp, f"{name}.npz"))), refs[name], name)
