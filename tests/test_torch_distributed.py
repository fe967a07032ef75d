"""The port's gang handoff, mesh axes, data split and shardings
(hivedscheduler_tpu_torch.parallel.distributed, .topology, .data,
.sharding) against the JAX package, and the H100 cell chain booted by the
scheduler.

Multi-rank training itself is in ``test_torch_sharded_train.py``; what is
here runs in this process, at most with a one-rank gloo group."""

import itertools
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.algorithm import HivedAlgorithm
from hivedscheduler_tpu.api import constants as C
from hivedscheduler_tpu.api import types as japi
from hivedscheduler_tpu.api.config import load_config
from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu.parallel import distributed as jdist
from hivedscheduler_tpu.parallel import topology as jtopo
from hivedscheduler_tpu.runtime.types import FILTERING_PHASE
from hivedscheduler_tpu.runtime.utils import new_binding_pod
from hivedscheduler_tpu_torch import train as ttrain_cli
from hivedscheduler_tpu_torch.api import types as tapi
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.ops import attention as tattn
from hivedscheduler_tpu_torch.parallel import data as tdata
from hivedscheduler_tpu_torch.parallel import distributed as tdist
from hivedscheduler_tpu_torch.parallel import topology as ttopo
from hivedscheduler_tpu_torch.parallel import train as ttrain

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from helpers import all_node_names, make_pod, set_healthy_nodes  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100_CONFIG = os.path.join(ROOT, "example", "config", "design", "h100-hive.yaml")


def _bind_info(placements, node=None) -> dict:
    """A bind-info annotation's dict: one affinity-group member per
    (node, chips) placement."""
    return {
        "node": node or placements[0][0],
        "leafCellIsolation": list(placements[0][1]),
        "cellChain": "h100-rack",
        "affinityGroupBindInfo": [{"podPlacements": [
            {"physicalNode": n, "physicalLeafCellIndices": list(chips)}
            for n, chips in placements]}],
    }


BIND_INFOS = {
    # four hosts, given out of order: ranks follow the sorted member order
    "four_hosts": [(f"pod0/{x}", range(4)) for x in ("2-0-0", "0-0-0", "0-2-0", "2-2-0")],
    # two gang pods on one node: told apart by their chip indices
    "pods_share_a_node": [("h0", [0, 1]), ("h0", [3, 2]), ("h1", [0, 1, 2, 3])],
    # two 8-GPU nodes
    "two_h100_nodes": [("h100-1", range(8)), ("h100-0", range(8))],
}


def _both(fn_j, fn_t, *args, **kwargs):
    """(result or (error type, message)) of the JAX and the port function."""
    out = []
    for fn in (fn_j, fn_t):
        try:
            out.append(fn(*args, **kwargs))
        except ValueError as err:
            out.append((ValueError, str(err)))
    return out


@pytest.mark.parametrize("case", sorted(BIND_INFOS))
def test_gang_process_info_matches_jax(case):
    d = _bind_info(BIND_INFOS[case])
    jinfo = japi.PodBindInfo.from_dict(d)
    tinfo = tapi.parse_pod_bind_info(json.dumps(d))
    nodes = sorted({n for n, _ in BIND_INFOS[case]}) + ["ghost"]
    for node in nodes:
        j, t = _both(jdist.gang_process_info, tdist.gang_process_info, jinfo, node)
        if isinstance(j, tuple) and j[0] is ValueError:
            # the port names NVIDIA_VISIBLE_DEVICES where JAX names its
            # TPU handoff; the rest of the message is the same
            assert t[0] is ValueError
            assert t[1].split("(")[0] == j[1].split("(")[0]
        else:
            assert t == j
    for node, chips in BIND_INFOS[case]:
        assert (tdist.gang_process_info(tinfo, node, list(chips))
                == jdist.gang_process_info(jinfo, node, list(chips)))


@pytest.mark.parametrize("case", sorted(BIND_INFOS))
def test_gang_rank_is_one_per_gpu(case):
    placements = BIND_INFOS[case]
    info = tapi.parse_pod_bind_info(json.dumps(_bind_info(placements)))
    ranks = []
    for node, chips in placements:
        coord, pod, pods = tdist.gang_process_info(info, node, list(chips))
        for local in range(len(list(chips))):
            c, rank, world = tdist.gang_rank(info, node, list(chips), local)
            assert c == coord and world == sum(len(list(x)) for _, x in placements)
            ranks.append((pod, local, rank))
    # ranks 0..world-1, each pod's GPUs contiguous, in the pods' order
    assert sorted(r for _, _, r in ranks) == list(range(len(ranks)))
    assert [r for _, _, r in sorted(ranks)] == list(range(len(ranks)))
    with pytest.raises(ValueError) as err:
        node, chips = placements[0]
        tdist.gang_rank(info, node, list(chips), local_rank=len(list(chips)))
    assert "LOCAL_RANK" in str(err.value)


def test_gang_errors_match_jax():
    d = _bind_info(BIND_INFOS["pods_share_a_node"])
    jinfo, tinfo = japi.PodBindInfo.from_dict(d), tapi.PodBindInfo.from_dict(d)
    for args in (("h0",), ("ghost",), ("h0", [0, 9])):
        with pytest.raises(ValueError) as jerr:
            jdist.gang_process_info(jinfo, *args)
        with pytest.raises(ValueError) as terr:
            tdist.gang_process_info(tinfo, *args)
        assert str(terr.value).split("(")[0] == str(jerr.value).split("(")[0]
    # with the chips named, every pod on the shared node has its own index
    for _, chips in BIND_INFOS["pods_share_a_node"][:2]:
        assert (tdist.gang_process_info(tinfo, "h0", list(chips))
                == jdist.gang_process_info(jinfo, "h0", list(chips)))


def test_bind_info_is_json_only():
    d = _bind_info(BIND_INFOS["four_hosts"])
    assert tapi.parse_pod_bind_info(json.dumps(d)).affinity_group_bind_info[0] \
        .pod_placements[1].physical_node == "pod0/0-0-0"
    for text in ("node: h0\nleafCellIsolation: [0]\n", "[1, 2]", "{not json"):
        with pytest.raises(ValueError) as err:
            tapi.parse_pod_bind_info(text)
        assert C.ANNOTATION_POD_BIND_INFO in str(err.value)
    assert tapi.ANNOTATION_POD_BIND_INFO == C.ANNOTATION_POD_BIND_INFO


def test_visible_chip_indices_read_nvidia_visible_devices(monkeypatch):
    monkeypatch.delenv("NVIDIA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1")  # renumbered: not read
    assert ttopo.visible_chip_indices() is None
    for raw, want in (("4,5,6,7", [4, 5, 6, 7]), (" 3 ", [3]), ("all", None),
                      ("void", None), ("", None)):
        monkeypatch.setenv("NVIDIA_VISIBLE_DEVICES", raw)
        assert ttopo.visible_chip_indices() == want
    monkeypatch.setenv("NVIDIA_VISIBLE_DEVICES", "GPU-5e3b4c1a")
    with pytest.raises(ValueError) as err:
        ttopo.visible_chip_indices()
    assert "NVIDIA_VISIBLE_DEVICES" in str(err.value)


def test_initialize_from_gang_one_rank(monkeypatch):
    for name in ("POD_BIND_INFO", "NODE_NAME", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert tdist.gang_from_env() is None
    try:
        assert tdist.initialize_from_gang(device="cpu") == (0, 1)
        assert torch.distributed.get_backend() == "gloo"
        with pytest.raises(RuntimeError):
            tdist.initialize_from_gang(device="cpu")  # one group at a time
    finally:
        tdist.shutdown()
    # a gang of one pod with one GPU is a one-rank group too
    monkeypatch.setenv("POD_BIND_INFO", json.dumps(_bind_info([("h100-3", [5])])))
    monkeypatch.setenv("NODE_NAME", "h100-3")
    monkeypatch.setenv("NVIDIA_VISIBLE_DEVICES", "5")
    assert tdist.gang_from_env() == ("h100-3", 0, 1)
    try:
        assert tdist.initialize_from_gang(device="cpu") == (0, 1)
        assert not tdist.any_rank(False, "cpu") and tdist.any_rank(True, "cpu")
    finally:
        tdist.shutdown()
    assert not torch.distributed.is_initialized()


def test_one_rank_group_takes_another_port_when_its_own_is_taken(monkeypatch):
    # between the probe that finds a free port and the store's bind another
    # socket can take it (EADDRINUSE): the one-rank group tries a new free
    # port; a port the caller gave, and any other error, are not retried
    for name in ("POD_BIND_INFO", "NODE_NAME", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    ports = iter([50423, 50424])
    monkeypatch.setattr(tdist, "_free_local_port", lambda: next(ports))
    calls, errors = [], []

    def fake_init(backend, init_method, **kw):
        calls.append(init_method)
        if errors:
            raise errors.pop(0)

    taken = ("The server socket has failed to listen on any local network address. "
             "port: 50423, useIpv6: false, code: -98, name: EADDRINUSE, message: "
             "address already in use")
    monkeypatch.setattr(torch.distributed, "init_process_group", fake_init)
    monkeypatch.setattr(torch.distributed, "get_backend", lambda *a: "gloo")
    errors.append(torch.distributed.DistNetworkError(taken))
    assert tdist.initialize_from_gang(device="cpu") == (0, 1)
    assert calls == ["tcp://127.0.0.1:50423", "tcp://127.0.0.1:50424"]
    calls.clear()
    errors.append(torch.distributed.DistNetworkError(taken))
    with pytest.raises(torch.distributed.DistNetworkError):
        tdist.initialize_from_gang(device="cpu", coordinator_port=50423)
    assert calls == ["tcp://127.0.0.1:50423"]
    monkeypatch.setattr(tdist, "_free_local_port", lambda: 50425)
    calls.clear()
    errors.append(torch.distributed.DistNetworkError("connection reset"))
    with pytest.raises(torch.distributed.DistNetworkError):
        tdist.initialize_from_gang(device="cpu")
    assert calls == ["tcp://127.0.0.1:50425"]


AXES_GRID = [dict(n=n, tp=tp, sp=sp, fsdp=f, pp=pp, ep=ep)
             for n, tp, sp, f, pp, ep in itertools.product(
                 (1, 2, 4, 6, 8, 16), (1, 2, 4), (1, 2), (1, 2, 4), (1, 2), (1, 2))]


def test_infer_and_elastic_axes_match_jax():
    for kw in AXES_GRID:
        n = kw.pop("n")
        j, t = _both(jtopo.infer_axes, ttopo.infer_axes, n, **kw)
        assert (t == j) if isinstance(j, tuple) else (t.shape == j.shape), (n, kw)
        for extra in (dict(), dict(n_heads=8, n_kv_heads=2),
                      dict(global_batch=12, seq_len=64), dict(n_heads=6)):
            j, t = _both(jtopo.elastic_axes, ttopo.elastic_axes, n, **kw, **extra)
            assert (t == j) if isinstance(j, tuple) else (t.shape == j.shape), (n, kw)
    j, t = _both(jtopo.elastic_axes, ttopo.elastic_axes, 0)
    assert t == j and j[0] is ValueError


def test_mesh_from_slice_matches_jax():
    with pytest.raises(ValueError) as jerr:
        jtopo.mesh_from_slice((2, 2), jtopo.MeshAxes(dp=2, tp=4))
    with pytest.raises(ValueError) as terr:
        ttopo.mesh_from_slice((2, 2), ttopo.MeshAxes(dp=2, tp=4), "cpu")
    assert str(terr.value) == str(jerr.value)
    jmesh = jtopo.mesh_from_slice((1,), jtopo.MeshAxes(), jax.devices("cpu")[:1])
    try:
        tdist.initialize_from_gang(device="cpu")
        mesh = ttopo.mesh_from_slice((1,), ttopo.MeshAxes(), "cpu")
        assert mesh.mesh_dim_names == jmesh.axis_names
        assert ttopo.mesh_axes(mesh) == ttopo.MeshAxes()
        with pytest.raises(ValueError) as err:
            ttopo.make_mesh(ttopo.MeshAxes(tp=2), "cpu")
        assert str(err.value) == "mesh axes (1, 1, 1, 1, 2, 1) require 2 devices, have 1"
    finally:
        tdist.shutdown()


def test_sharding_specs_match_jax():
    cfg_j = jtm.TransformerConfig(vocab_size=256, d_model=64, n_heads=4,
                                  n_kv_heads=2, n_layers=2, d_ff=128)
    cfg_t = ttm.TransformerConfig(vocab_size=256, d_model=64, n_heads=4,
                                  n_kv_heads=2, n_layers=2, d_ff=128)
    want = jtm.sharding_specs(cfg_j)
    got = ttm.sharding_specs(cfg_t)
    flat_w = {jax.tree_util.keystr(p): tuple(s) for p, s in
              jax.tree_util.tree_leaves_with_path(
                  want, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))}
    flat_g = {jax.tree_util.keystr(p): s for p, s in
              jax.tree_util.tree_leaves_with_path(
                  got, is_leaf=lambda x: isinstance(x, tuple))}
    assert flat_g == flat_w
    assert ttm.activation_spec() == tuple(jtm.activation_spec())


class _StubMesh:
    """The mesh surface ``data_split`` reads, for one rank of a world."""

    def __init__(self, axes, rank):
        self.mesh_dim_names = axes.names
        self.mesh = torch.zeros(axes.shape)
        self.coord = list(np.unravel_index(rank, axes.shape))

    def get_coordinate(self):
        return self.coord


@pytest.mark.parametrize("axes", [ttopo.MeshAxes(dp=2, tp=2),
                                  ttopo.MeshAxes(fsdp=2, tp=2),
                                  ttopo.MeshAxes(dp=2, fsdp=2)])
def test_data_split_tp_ranks_share_rows_data_ranks_do_not(axes):
    ds = tdata.synthetic_dataset(64, size=4096)
    batch = 8
    full = next(tdata.CheckpointableBatches(ds, batch, 16, seed=3))
    rows = {}
    for rank in range(axes.size):
        index, count = tdata.data_split(_StubMesh(axes, rank))
        coord = dict(zip(axes.names, np.unravel_index(rank, axes.shape)))
        assert count == axes.dp * axes.fsdp
        assert index == coord["dp"] * axes.fsdp + coord["fsdp"]
        loader = tdata.CheckpointableBatches(ds, batch, 16, seed=3,
                                             process_index=index,
                                             process_count=count)
        rows[rank] = (coord, next(loader))
        assert loader.to_dict()["step"] == 1  # the same state on every rank
    for a, b in itertools.combinations(rows, 2):
        (ca, ra), (cb, rb) = rows[a], rows[b]
        same_data = (ca["dp"], ca["fsdp"]) == (cb["dp"], cb["fsdp"])
        assert np.array_equal(ra, rb) == same_data
    # the data ranks' rows, in order, are the global batch
    parts = {(c["dp"], c["fsdp"]): r for c, r in rows.values()}
    assert np.array_equal(np.concatenate([parts[k] for k in sorted(parts)]), full)


def test_flash_attention_refuses_a_dtensor():
    from torch.distributed.tensor import distribute_tensor

    q = torch.randn(1, 64, 4, 16)
    k = torch.randn(1, 64, 2, 16)
    try:
        tdist.initialize_from_gang(device="cpu")
        mesh = ttopo.make_mesh(ttopo.MeshAxes(), "cpu")
        from hivedscheduler_tpu_torch.parallel import sharding

        pmesh = sharding.param_mesh(mesh)
        dq = distribute_tensor(q, pmesh, sharding.placements((None,) * 4, pmesh))
        for args in ((dq, k, k), (q, dq, k), (q, k, dq)):
            with pytest.raises(TypeError) as err:
                tattn.flash_attention(*args, block_q=32, block_k=32)
            assert "DTensor" in str(err.value)
            with pytest.raises(TypeError):
                tattn.FlashAttention.apply(*args, True)
        # the local shard is taken
        out = tattn.flash_attention(dq.to_local(), k, k, block_q=32, block_k=32)
        assert out.shape == q.shape
    finally:
        tdist.shutdown()


def test_world_1_mesh_step_is_the_single_device_step():
    # every collective of a one-GPU mesh is skipped: the mesh step computes
    # exactly what the single-device step does, bit for bit
    cfg = ttm.TransformerConfig(vocab_size=256, d_model=64, n_heads=4,
                                n_kv_heads=2, n_layers=2, d_ff=128,
                                max_seq_len=64, dtype=torch.float32,
                                attn_impl="flash", attn_block_q=32,
                                attn_block_k=32, remat="dots")
    tokens = np.random.default_rng(0).integers(0, 256, (2, 64)).astype(np.int32)
    step, init_fn = ttrain.make_train_step(cfg, "cpu", ce_chunk=32)
    params, opt = init_fn(torch.Generator().manual_seed(0))
    want = [float(step(params, opt, torch.from_numpy(tokens))[2]) for _ in range(2)]
    try:
        tdist.initialize_from_gang(device="cpu")
        mesh = ttopo.make_mesh(ttopo.MeshAxes(), "cpu")
        mstep, minit, tok_sh = ttrain.make_sharded_train_step(cfg, mesh, ce_chunk=32)
        mparams, mopt = minit(torch.Generator().manual_seed(0))
        got = [float(mstep(mparams, mopt, tdata.device_put_global(tokens, tok_sh, 2))[2])
               for _ in range(2)]
        assert got == want
        for name, t in ttrain.named_leaves(mparams).items():
            assert torch.equal(t.to_local(), ttrain.named_leaves(params)[name]), name
    finally:
        tdist.shutdown()


@pytest.mark.parametrize("flag,what", [("--sp", "sequence parallelism"),
                                       ("--pp", "pipelining"),
                                       ("--ep", "expert parallelism")])
def test_train_cli_refuses_each_unported_axis_with_its_own_message(flag, what, capsys):
    with pytest.raises(SystemExit) as exc:
        ttrain_cli.main(["--device", "cpu", flag, "2"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "not yet ported" not in err
    if flag in ("--sp", "--ep"):
        # sequence and expert parallelism are ported: on one device their
        # mesh cannot be laid, a usage error of its own
        assert "1 devices not divisible by tp*sp*fsdp*pp*ep=2" in err
    else:
        # pipelining is ported: --pp above 1 without --microbatches is the
        # JAX CLI's usage error (tests/test_torch_pipeline_cli.py)
        assert "--pp > 1 requires --microbatches" in err
    # --elastic is ported (tests/test_torch_elastic.py); --min-chips without
    # it is the JAX CLI's usage error
    with pytest.raises(SystemExit) as exc:
        ttrain_cli.main(["--device", "cpu", "--min-chips", "2"])
    assert exc.value.code == 2
    assert "--min-chips requires --elastic" in capsys.readouterr().err


def test_h100_config_gang_of_16_gets_ranks_0_to_15():
    h = HivedAlgorithm(load_config(H100_CONFIG))
    set_healthy_nodes(h)
    spec = {"virtualCluster": "train", "priority": 1, "chipType": "h100-gpu",
            "chipNumber": 8,
            "affinityGroup": {"name": "g16",
                              "members": [{"podNumber": 2, "chipNumber": 8}]}}
    bound = []
    for i in range(2):
        pod = make_pod(f"g16-{i}", spec)
        r = h.schedule(pod, all_node_names(h), FILTERING_PHASE)
        assert r.pod_bind_info is not None
        bp = new_binding_pod(pod, r.pod_bind_info)
        h.add_allocated_pod(bp)
        bound.append(bp)
    assert len({bp.node_name for bp in bound}) == 2  # two 8-GPU nodes
    seen = {}
    for bp in bound:
        info = tapi.parse_pod_bind_info(bp.annotations[C.ANNOTATION_POD_BIND_INFO])
        chips = [int(x) for x in
                 bp.annotations[C.ANNOTATION_POD_CHIP_ISOLATION].split(",")]
        assert sorted(chips) == list(range(8))
        for local in range(len(chips)):
            coord, rank, world = tdist.gang_rank(info, bp.node_name, chips, local)
            assert world == 16
            seen[rank] = (coord, bp.node_name, local)
    assert sorted(seen) == list(range(16))
    assert len({c for c, _, _ in seen.values()}) == 1  # one coordinator
    # the members agree: each pod's GPUs are one contiguous block of ranks
    for node in {bp.node_name for bp in bound}:
        ranks = sorted(r for r, (_, n, _) in seen.items() if n == node)
        assert ranks == list(range(ranks[0], ranks[0] + 8))
