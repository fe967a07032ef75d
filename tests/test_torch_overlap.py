"""Overlapped tensor parallelism in the port, against the JAX package.

The port's collective-matmul stack (``shard_utils.allgather_matmul`` and
``matmul_reducescatter`` inside ``transformer._overlapped_stack``) runs in
gloo gangs on the CPU (``tests/torch_mesh_worker.py``: one gang of 2 and
one of 4, each running its cases in turn on one process group, and the
CLIs as gangs of 2); the references are the port's own reference body
under ``HIVED_OVERLAP=0`` and JAX's overlapped path on the matching mesh
of the CPU devices that ``tests/conftest.py`` forces, from the same numpy
weights, in f32, at ``tests/test_overlap.py``'s tiny config.

Tolerances: the forward is equal bit for bit to the reference body at tp =
2 (two-term sums commute), within JAX's own 2e-5 of JAX's overlapped
forward; three AdamW steps within the 1e-5 (loss) and 3e-5 (parameters)
of ``tests/test_torch_sharded_train.py``; the model's gradients within 1e-6
of the reference body's, and the collective matmuls' (O(10) values) within
1e-5 of autograd of the plain compositions (the same products summed in
another order); an eval window's loss at tp = 2 within 1e-6 of one
device's, in f32.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu.parallel import topology as jtopo
from hivedscheduler_tpu.parallel import train as jtrain
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.parallel import topology as ttopo

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_mesh_worker.py")
sys.path.insert(0, os.path.join(ROOT, "tests"))

from torch_mesh_worker import gang_env  # noqa: E402

CFG = dict(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2,
           d_ff=128, max_seq_len=64)
# tp = 4 needs kv heads that divide it (JAX's tp4 parity test uses 4)
CFG_KV4 = dict(CFG, n_kv_heads=4)
BATCH, SEQ, STEPS = 4, 32, 3
FWD_ATOL = 2e-5
LOSS_ATOL, PARAM_ATOL = 1e-5, 3e-5
GRAD_ATOL = 1e-6
# the collective matmuls alone: O(10) gradients summed in another order
UNIT_GRAD_ATOL = 1e-5
EVAL_ATOL = 1e-6
JOB_TIMEOUT = 300
CLI_MODEL = ["--vocab-size", "128", "--d-model", "64", "--n-layers", "2",
             "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "128",
             "--seq-len", "32", "--batch", "4", "--device", "cpu"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _named(tree) -> dict:
    return {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _jcfg(**over):
    return jtm.TransformerConfig(**dict(CFG, dtype=jnp.float32, **over))


def _tcfg(**over):
    return ttm.TransformerConfig(**dict(CFG, dtype=torch.float32, **over))


def _jmesh(**axes):
    axes = jtopo.MeshAxes(**axes)
    return jtopo.make_mesh(axes, jax.devices("cpu")[:axes.size])


# -- the gate -----------------------------------------------------------------

GATE_CASES = [
    (dict(), dict(tp=2), SEQ, BATCH),
    (dict(n_experts=4), dict(tp=2), SEQ, BATCH),
    (dict(lora_rank=2), dict(tp=2), SEQ, BATCH),
    (dict(pipeline_microbatches=2), dict(tp=2), SEQ, BATCH),
    (dict(d_ff=129), dict(tp=2), SEQ, BATCH),
    (dict(), dict(tp=2), 33, BATCH),
    (dict(), None, None, None),
    (dict(), dict(dp=2), SEQ, BATCH),
    (dict(), dict(tp=2, sp=2), SEQ, BATCH),
    (dict(attn_impl="ring"), dict(tp=2, sp=2), SEQ, BATCH),
    (dict(attn_impl="ulysses"), dict(tp=2, sp=4), SEQ, BATCH),
    (dict(), dict(dp=2, tp=2), SEQ, 3),
    (dict(), dict(dp=2, tp=2), SEQ, None),
]


@pytest.mark.parametrize("over,axes,seq,batch", GATE_CASES)
def test_applicability_matches_jax(over, axes, seq, batch):
    jmesh = None if axes is None else _jmesh(**axes)
    want = jtm.overlap_applicable(_jcfg(**over), jmesh, seq, batch)
    taxes = None if axes is None else ttopo.MeshAxes(**axes)
    assert ttm.overlap_applicable(_tcfg(**over), taxes, seq, batch) == want


def test_env_kill_switch_and_explicit_opt(monkeypatch):
    axes, jmesh = ttopo.MeshAxes(tp=2), _jmesh(tp=2)
    monkeypatch.setenv("HIVED_OVERLAP", "0")
    assert not ttm._use_overlap(_tcfg(overlap=True), axes, SEQ, BATCH)
    monkeypatch.delenv("HIVED_OVERLAP")
    assert not ttm._use_overlap(_tcfg(overlap=False), axes, SEQ, BATCH)
    assert ttm._use_overlap(_tcfg(), axes, SEQ, BATCH)
    assert ttm._use_overlap(_tcfg(overlap=True), axes, SEQ, BATCH)
    for over, t_mesh, j_mesh in ((dict(n_experts=4), axes, jmesh),
                                 (dict(), None, None),
                                 (dict(), ttopo.MeshAxes(dp=2), _jmesh(dp=2))):
        with pytest.raises(ValueError) as t_err:
            ttm._use_overlap(_tcfg(overlap=True, **over), t_mesh, SEQ, BATCH)
        with pytest.raises(ValueError) as j_err:
            jtm._use_overlap(_jcfg(overlap=True, **over), j_mesh, SEQ, BATCH)
        assert str(t_err.value) == str(j_err.value)
        assert "cannot serve this config" in str(t_err.value)


def test_size_one_ring_is_the_plain_einsum():
    from hivedscheduler_tpu_torch.parallel import shard_utils

    gen = torch.Generator().manual_seed(3)
    x = torch.randn((2, 8, 16), generator=gen)
    ws = [torch.randn((16, 2, 4), generator=gen) for _ in range(3)]
    ring = shard_utils.RingAxis()
    outs = shard_utils.allgather_matmul(x, ws, ring, "btd,dhk->bthk")
    for o, w in zip(outs, ws):
        assert torch.equal(o, torch.einsum("btd,dhk->bthk", x, w))
    y = torch.randn((2, 8, 2, 4), generator=gen)
    w = torch.randn((2, 4, 16), generator=gen)
    assert torch.equal(shard_utils.matmul_reducescatter(y, w, ring, "bthk,hkd->btd"),
                       torch.einsum("bthk,hkd->btd", y, w))


def test_chunked_einsum_rows_equal_the_whole_product():
    # the collective matmuls' bit parity rests on this: a sequence chunk's
    # product is the whole product's rows, bit for bit, on this CPU's BLAS
    gen = torch.Generator().manual_seed(4)
    x = torch.randn((4, 32, 64), generator=gen)
    w = torch.randn((64, 2, 16), generator=gen)
    whole = torch.einsum("btd,dhk->bthk", x, w)
    for c in range(4):
        part = torch.einsum("btd,dhk->bthk", x[:, c * 8:(c + 1) * 8], w)
        assert torch.equal(part, whole[:, c * 8:(c + 1) * 8])


# -- the gangs ------------------------------------------------------------------


class Gang:
    """The processes of one port run, started at once."""

    def __init__(self, tmp, name, world, argv_of_rank, env_of_rank=None):
        self.name, self.logs, self.procs = name, [], []
        for rank in range(world):
            log = open(os.path.join(tmp, f"{name}.{rank}.log"), "w+")
            env = dict(os.environ, **(env_of_rank(rank) if env_of_rank else {}))
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                argv_of_rank(rank), cwd=ROOT, env=env, stdout=log,
                stderr=subprocess.STDOUT))

    def wait(self):
        """The exit codes; each rank's output."""
        rcs = []
        for p in self.procs:
            try:
                rcs.append(p.wait(timeout=JOB_TIMEOUT))
            except subprocess.TimeoutExpired:
                p.kill()
                rcs.append(p.wait())
        outs = []
        for log in self.logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
        return rcs, outs


def _worker_gang(tmp, name, world, cases, **common):
    """One gang running ``cases`` in turn; each case writes its own npz."""
    cases = [dict(c, out=os.path.join(tmp, f"{name}-{c['name']}.npz")) for c in cases]
    job = dict(world=world, port=_free_port(), cases=cases, **common)
    path = os.path.join(tmp, f"{name}.json")
    with open(path, "w") as f:
        json.dump(job, f)
    gang = Gang(tmp, name, world, lambda rank: [sys.executable, WORKER, path, str(rank)])
    return gang, {c["name"]: c["out"] for c in cases}


def _results(started):
    gang, outs = started
    rcs, logs = gang.wait()
    assert rcs == [0] * len(rcs), f"{gang.name} exited {rcs}:\n" + "\n".join(logs)
    got = {}
    for name, path in outs.items():
        with np.load(path) as f:
            got[name] = dict(f)
    return got


# the eval CLI in f32, each window's loss recorded in full precision, and the
# overlapped stacks counted
EVAL_CLI = (
    "import functools, sys, torch\n"
    "from hivedscheduler_tpu_torch.parallel import distributed\n"
    "distributed.DEFAULT_COORDINATOR_PORT = int(sys.argv[1])\n"
    "from hivedscheduler_tpu_torch.models import transformer as tm\n"
    "tm.TransformerConfig = functools.partial(tm.TransformerConfig, dtype=torch.float32)\n"
    "from hivedscheduler_tpu_torch.parallel import train as pt\n"
    "losses, make = [], pt.make_sharded_eval_step\n"
    "def recorded(*a, **k):\n"
    "    step, init, sharding = make(*a, **k)\n"
    "    def run(params, tokens):\n"
    "        loss = step(params, tokens)\n"
    "        losses.append(float(loss))\n"
    "        return loss\n"
    "    return run, init, sharding\n"
    "pt.make_sharded_eval_step = recorded\n"
    "from hivedscheduler_tpu_torch import eval as ev\n"
    "rc = ev.main(sys.argv[2:])\n"
    "print('EVAL', repr(losses), tm.OVERLAPPED_STACKS)\n"
    "sys.exit(rc)\n"
)
TRAIN_CLI = (
    "import sys\n"
    "from hivedscheduler_tpu_torch.parallel import distributed\n"
    "distributed.DEFAULT_COORDINATOR_PORT = int(sys.argv[1])\n"
    "from hivedscheduler_tpu_torch.models import transformer as tm\n"
    "from hivedscheduler_tpu_torch import train\n"
    "rc = train.main(sys.argv[2:])\n"
    "print('STACKS', tm.OVERLAPPED_STACKS)\n"
    "sys.exit(rc)\n"
)
EVAL_ARGS = CLI_MODEL + ["--max-steps", "2"]
TRAIN_ARGS = CLI_MODEL + ["--steps", "2", "--log-every", "1", "--attn", "flash",
                          "--block-q", "16", "--block-k", "16"]


def _cli_gang(tmp, name, code, argv):
    port = str(_free_port())
    return Gang(tmp, name, 2, lambda rank: [sys.executable, "-c", code, port] + argv,
                lambda rank: gang_env(2, rank))


def _jax_forward(cfg, axes, init, tokens):
    """JAX's overlapped forward on ``axes`` of the CPU devices, params and
    tokens placed on the training shardings."""
    mesh = _jmesh(**axes)
    assert jtm._use_overlap(cfg, mesh, SEQ, BATCH), "JAX's gate must engage"
    psh, tsh = jtrain._shardings(cfg, mesh)
    params, toks = jax.device_put(init, psh), jax.device_put(tokens, tsh)
    return np.asarray(jax.jit(lambda p, t: jtm.forward(p, t, cfg, mesh))(params, toks))


def _jax_train(cfg, axes, init, batches, grad_accum=1):
    """JAX's sharded steps from ``init`` -> (losses, final named params)."""
    mesh = _jmesh(**axes)
    # the gate as JAX's step sees each grad_accum slice
    assert jtm._use_overlap(cfg, mesh, SEQ, BATCH // grad_accum) == (grad_accum == 1)
    step, init_fn, tok_sh = jtrain.make_sharded_train_step(cfg, mesh, grad_accum=grad_accum)
    params, opt = init_fn(jax.random.PRNGKey(0))
    params = jax.device_put(init, jax.tree.map(lambda a: a.sharding, params))
    losses = []
    for tokens in batches:
        params, opt, loss = step(params, opt, jax.device_put(tokens, tok_sh))
        losses.append(float(loss))
    return losses, _named(jax.device_get(params))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every port gang and its JAX references: the gangs start first and
    the references are computed while they run."""
    tmp = str(tmp_path_factory.mktemp("overlap"))
    inits = {}
    for name, cfg in (("kv2", CFG), ("kv4", CFG_KV4)):
        init = jax.device_get(jtm.init_params(_jcfg(**{k: cfg[k] for k in ("n_kv_heads",)}),
                                              jax.random.PRNGKey(0)))
        inits[name] = init
        np.savez(os.path.join(tmp, f"init-{name}.npz"), **_named(init))
    batches = np.random.default_rng(7).integers(
        0, CFG["vocab_size"], (STEPS, BATCH, SEQ)).astype(np.int32)
    np.savez(os.path.join(tmp, "batches.npz"), tokens=batches)
    common = dict(batches=os.path.join(tmp, "batches.npz"),
                  init=os.path.join(tmp, "init-kv2.npz"))
    off = {"HIVED_OVERLAP": "0"}
    world2 = _worker_gang(tmp, "w2", 2, [
        dict(name="collective", tp=2, cfg=CFG, tasks=["collective"]),
        dict(name="ref", tp=2, cfg=CFG, env=off, tasks=["forward", "grads"]),
        dict(name="full", tp=2, cfg=dict(CFG, remat="full"),
             tasks=["forward", "grads", "train"]),
        dict(name="dots", tp=2, cfg=dict(CFG, remat="dots"), tasks=["grads", "train"]),
        dict(name="none", tp=2, cfg=dict(CFG, remat="none"), tasks=["grads", "train"]),
    ], **common)
    blocks = dict(attn_block_q=16, attn_block_k=16)
    world4 = _worker_gang(tmp, "w4", 4, [
        dict(name="collective", tp=4, cfg=CFG_KV4, tasks=["collective"]),
        dict(name="tp4", tp=4, cfg=CFG_KV4, init=os.path.join(tmp, "init-kv4.npz"),
             tasks=["forward"]),
        dict(name="fsdp2-tp2", fsdp=2, tp=2, cfg=CFG, tasks=["forward"]),
        dict(name="sp2-tp2-ring", sp=2, tp=2, cfg=dict(CFG, attn_impl="ring"),
             tasks=["forward"]),
        dict(name="sp2-tp2-ring_flash", sp=2, tp=2, ring_kernels=True,
             cfg=dict(CFG, attn_impl="ring_flash", **blocks), tasks=["forward"]),
        dict(name="dp2-tp2-ref", tp=2, cfg=CFG, env=off, tasks=["forward"]),
        dict(name="dp2-tp2", tp=2, cfg=CFG, tasks=["forward", "train"]),
        # slices of one row, which do not split over dp: replicated, and
        # off the overlapped path, as JAX's gate sees them
        dict(name="dp2-tp2-accum4", tp=2, cfg=CFG, grad_accum=4, tasks=["train"]),
    ], **common)
    cli = {
        "train": _cli_gang(tmp, "cli-train", TRAIN_CLI, TRAIN_ARGS + ["--tp", "2"]),
        "train-no-overlap": _cli_gang(tmp, "cli-train-no", TRAIN_CLI,
                                      TRAIN_ARGS + ["--tp", "2", "--no-overlap"]),
        "eval": _cli_gang(tmp, "cli-eval", EVAL_CLI, EVAL_ARGS + ["--tp", "2"]),
    }
    kv2, kv4 = inits["kv2"], inits["kv4"]
    ref = {
        "tp2": _jax_forward(_jcfg(), dict(tp=2), kv2, batches[0]),
        "tp4": _jax_forward(_jcfg(n_kv_heads=4), dict(tp=4), kv4, batches[0]),
        "fsdp2-tp2": _jax_forward(_jcfg(), dict(fsdp=2, tp=2), kv2, batches[0]),
        "sp2-tp2-ring": _jax_forward(_jcfg(attn_impl="ring"), dict(sp=2, tp=2), kv2,
                                     batches[0]),
        "sp2-tp2-ring_flash": _jax_forward(_jcfg(attn_impl="ring_flash", **blocks),
                                           dict(sp=2, tp=2), kv2, batches[0]),
        "train-tp2": _jax_train(_jcfg(), dict(tp=2), kv2, batches),
        "train-dp2-tp2": _jax_train(_jcfg(), dict(dp=2, tp=2), kv2, batches),
        "train-dp2-tp2-accum4": _jax_train(_jcfg(), dict(dp=2, tp=2), kv2, batches,
                                           grad_accum=4),
    }
    out = {"w2": _results(world2), "w4": _results(world4)}
    cli_out = {name: gang.wait() for name, gang in cli.items()}
    return dict(init=_named(kv2), batches=batches, ref=ref, out=out, cli=cli_out)


@pytest.mark.parametrize("world,name", [(2, "gather1"), (2, "gather3"), (2, "scatter"),
                                        (4, "gather1"), (4, "gather3"), (4, "scatter")])
def test_collective_matmuls_match_the_plain_compositions(runs, world, name):
    fwd_diff, unequal, *grad_diffs = runs["out"][f"w{world}"]["collective"][
        f"collective/{name}"]
    # each product is the plain one's local dot; the sums of the reduce-
    # scatter commute at tp = 2 and are reordered at tp = 4
    if world == 2 or name != "scatter":
        assert unequal == 0.0 and fwd_diff == 0.0, (world, name, fwd_diff)
    assert fwd_diff <= FWD_ATOL * 0.1, fwd_diff
    assert len(grad_diffs) == (4 if name == "gather3" else 2)
    assert max(grad_diffs) <= UNIT_GRAD_ATOL, grad_diffs


def test_forward_at_tp2_equals_the_reference_body_bit_for_bit(runs):
    w2 = runs["out"]["w2"]
    assert int(w2["ref"]["overlapped_stacks"]) == 0
    assert int(w2["full"]["overlapped_stacks"]) > 0
    np.testing.assert_array_equal(w2["full"]["logits"], w2["ref"]["logits"])
    assert float(w2["full"]["replica_spread"]) == 0.0


def test_forward_at_dp2_tp2_equals_the_reference_body_bit_for_bit(runs):
    w4 = runs["out"]["w4"]
    assert int(w4["dp2-tp2-ref"]["overlapped_stacks"]) == 0
    assert int(w4["dp2-tp2"]["overlapped_stacks"]) > 0
    np.testing.assert_array_equal(w4["dp2-tp2"]["logits"], w4["dp2-tp2-ref"]["logits"])


def test_gradients_at_tp2_match_the_reference_body(runs):
    # a norm weight's gradient is partial over tp on the overlapped path: a
    # missing sum halves it and a doubled one doubles it, far past this
    w2 = runs["out"]["w2"]
    np.testing.assert_allclose(float(w2["full"]["grad_loss"]), float(w2["ref"]["grad_loss"]),
                               rtol=0, atol=LOSS_ATOL)
    names = sorted(k for k in w2["ref"] if k.startswith("grads/"))
    assert "grads/layers.attn_norm" in names and "grads/layers.mlp_norm" in names
    for name in names:
        ref = w2["ref"][name]
        np.testing.assert_allclose(w2["full"][name], ref, rtol=0, atol=GRAD_ATOL,
                                   err_msg=name)
        assert np.abs(ref).max() > 100 * GRAD_ATOL, name


@pytest.mark.parametrize("case", ["tp2", "tp4", "fsdp2-tp2", "sp2-tp2-ring",
                                  "sp2-tp2-ring_flash"])
def test_forward_matches_jax_overlapped(runs, case):
    got = runs["out"]["w2"]["full"] if case == "tp2" else runs["out"]["w4"][case]
    assert int(got["overlapped_stacks"]) > 0
    if case == "sp2-tp2-ring_flash":
        # the port's rings ran the kernels' plain versions, not the einsum
        # ring (JAX's interpret mode takes its einsum ring in the mesh)
        assert int(got["case_ring_routes"]) == 0
    np.testing.assert_allclose(got["logits"], runs["ref"][case], rtol=0, atol=FWD_ATOL)
    assert float(got["replica_spread"]) == 0.0


def _assert_train_matches(got, want, init):
    j_losses, j_params = want
    np.testing.assert_allclose(got["losses"], j_losses, rtol=0, atol=LOSS_ATOL)
    params = {k[len("params/"):]: v for k, v in got.items() if k.startswith("params/")}
    assert sorted(params) == sorted(j_params)
    for name, w in j_params.items():
        np.testing.assert_allclose(params[name], w, rtol=0, atol=PARAM_ATOL, err_msg=name)
    # the norms' updates, named: they moved by far more than the tolerance
    for name in ("layers.attn_norm", "layers.mlp_norm", "layers.wq"):
        assert np.abs(j_params[name] - init[name]).max() > 20 * PARAM_ATOL, name


@pytest.mark.parametrize("case", ["tp2", "dp2-tp2"])
def test_three_steps_match_jax_overlapped(runs, case):
    got = runs["out"]["w2"]["full"] if case == "tp2" else runs["out"]["w4"]["dp2-tp2"]
    assert int(got["overlapped_stacks"]) >= STEPS
    _assert_train_matches(got, runs["ref"][f"train-{case}"], runs["init"])


def test_replicated_accum_slices_take_the_reference_body_as_jax(runs):
    got = runs["out"]["w4"]["dp2-tp2-accum4"]
    assert int(got["overlapped_stacks"]) == 0
    _assert_train_matches(got, runs["ref"]["train-dp2-tp2-accum4"], runs["init"])


@pytest.mark.parametrize("policy", ["dots", "none"])
def test_remat_policies_compute_the_same_step(runs, policy):
    w2 = runs["out"]["w2"]
    full, other = w2["full"], w2[policy]
    assert int(other["overlapped_stacks"]) > 0
    assert float(other["grad_loss"]) == float(full["grad_loss"])
    for name in (k for k in full if k.startswith("grads/")):
        np.testing.assert_allclose(other[name], full[name], rtol=0, atol=GRAD_ATOL,
                                   err_msg=name)
    np.testing.assert_array_equal(other["losses"][:1], full["losses"][:1])
    for name in (k for k in full if k.startswith("params/")):
        np.testing.assert_allclose(other[name], full[name], rtol=0, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["train", "train-no-overlap"])
def test_train_cli_at_tp2_logs_the_path(runs, mode):
    rcs, outs = runs["cli"][mode]
    assert rcs == [0, 0], "\n".join(outs)
    assert "step 2 loss" in outs[0]
    enabled = "overlapped collective-matmul path enabled (tp=2)" in outs[0]
    stacks = [int(line.split()[1]) for out in outs for line in out.splitlines()
              if line.startswith("STACKS ")]
    assert len(stacks) == 2
    if mode == "train":
        assert enabled and min(stacks) > 0
    else:
        assert not enabled and stacks == [0, 0]


def test_eval_cli_at_tp2_takes_the_path_and_equals_one_device(runs, monkeypatch, capsys):
    import functools

    from hivedscheduler_tpu_torch import eval as teval
    from hivedscheduler_tpu_torch.parallel import train as ptrain

    rcs, outs = runs["cli"]["eval"]
    assert rcs == [0, 0], "\n".join(outs)
    got = [line.split(" ", 1)[1] for line in outs[0].splitlines() if line.startswith("EVAL ")]
    assert len(got) == 1
    losses, stacks = got[0].rsplit(" ", 1)
    losses = json.loads(losses)
    assert len(losses) == 2 and int(stacks) == 2
    # one device, in this process, in f32
    monkeypatch.setattr(ttm, "TransformerConfig",
                        functools.partial(ttm.TransformerConfig, dtype=torch.float32))
    want, make = [], ptrain.make_sharded_eval_step

    def recorded(*a, **k):
        step, init, sharding = make(*a, **k)

        def run(params, tokens):
            loss = step(params, tokens)
            want.append(float(loss))
            return loss

        return run, init, sharding

    monkeypatch.setattr(ptrain, "make_sharded_eval_step", recorded)
    before = ttm.OVERLAPPED_STACKS
    assert teval.main(EVAL_ARGS) == 0
    capsys.readouterr()
    assert ttm.OVERLAPPED_STACKS == before
    np.testing.assert_allclose(losses, want, rtol=0, atol=EVAL_ATOL)


def test_overlap_on_one_device_is_jax_usage_error(capsys):
    from hivedscheduler_tpu_torch import train as ttrain_cli

    with pytest.raises(SystemExit) as exc:
        ttrain_cli.main(CLI_MODEL + ["--steps", "1", "--overlap"])
    assert exc.value.code == 2
    _, reason = jtm.overlap_applicable(_jcfg(), _jmesh(), SEQ, BATCH)
    assert f"--overlap requested but inapplicable: {reason}" in capsys.readouterr().err


def test_chip_smoke_replay_of_a_tp2_pair_matches_one_device():
    # chip_smoke.py [w] replays a tp = 2 rank pair in one process through
    # the hop functions; here at the tiny config in f32, on the CPU
    import chip_smoke

    cfg = _tcfg(attn_impl="flash", attn_block_q=16, attn_block_k=16)
    attn_fn = ttm._resolve_attn_fn(cfg)
    params = ttm.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, CFG["vocab_size"], (2, SEQ),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = ttm.forward_with_aux(params, tokens, cfg, return_hidden=True)[0]
        got = chip_smoke._replay_stack(params, tokens, cfg, attn_fn)
        bad = chip_smoke._replay_stack(params, tokens, cfg, attn_fn, plant=True)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=FWD_ATOL)
    assert float((bad - ref).abs().max()) > 0.1
    lp = ttm.layer_leaves(params["layers"])[0]
    positions = ttm.token_positions(tokens)
    x = ttm.embed_tokens(params, tokens, cfg).detach()
    dy = torch.randn(x.shape, generator=torch.Generator().manual_seed(2))
    leaves = {name: lp[name].detach().requires_grad_(True)
              for name in chip_smoke._tp_shards(lp, cfg.dtype)[0]}
    leaves.update(attn_norm=lp["attn_norm"].detach().requires_grad_(True),
                  mlp_norm=lp["mlp_norm"].detach().requires_grad_(True))
    x_leaf = x.clone().requires_grad_(True)
    y, _ = ttm._apply_layer(x_leaf, leaves, positions, cfg, attn_fn)
    want = dict(zip(["x", *leaves], torch.autograd.grad(y, [x_leaf, *leaves.values()], dy)))
    grads = chip_smoke._replay_layer_grad(x, lp, dy, positions, cfg, attn_fn)
    assert sorted(grads) == sorted(want)
    groups, worst = chip_smoke._layer_grad_errs(grads, want)
    assert worst <= 1e-5, groups
    bad_groups, _ = chip_smoke._layer_grad_errs(
        chip_smoke._replay_layer_grad(x, lp, dy, positions, cfg, attn_fn, plant=True), want)
    assert bad_groups["input"] > chip_smoke.TRAIN_GRAD_REL
