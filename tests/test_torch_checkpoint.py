"""The port's checkpointing (hivedscheduler_tpu_torch.parallel.checkpoint)
against the JAX package's contract: the seven cases of
tests/test_checkpoint.py on the port, then the on-disk protocol read by the
JAX package's own readers, the resume metadata, the payload format and the
retention of three committed steps."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu.parallel import checkpoint as jck
from hivedscheduler_tpu.parallel import topology as jtopo
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.parallel import checkpoint as tck
from hivedscheduler_tpu_torch.parallel import topology as ttopo
from hivedscheduler_tpu_torch.parallel import train as ttrain

torch.set_num_threads(1)

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_seq_len=16)


def _state(seed=0):
    step, init_fn = ttrain.make_train_step(
        ttm.TransformerConfig(dtype=torch.float32, **CFG), "cpu")
    params, opt = init_fn(torch.Generator().manual_seed(seed))
    return step, params, opt


def _tokens(seed=1):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, 64, (4, 16)).astype(np.int32))


def _leaves(params):
    return list(tck.named_leaves(params).values())


def _tiny_state(scale=1.0):
    """One f32 [4, 4] parameter and its AdamW, stepped once."""
    w = torch.full((4, 4), scale, requires_grad=True)
    opt = torch.optim.AdamW([w], lr=0.1)
    w.grad = torch.ones(4, 4)
    opt.step()
    opt.zero_grad(set_to_none=True)
    with torch.no_grad():
        w.fill_(scale)
    return {"w": w}, opt


def _template():
    w = torch.zeros(4, 4, requires_grad=True)
    return {"w": w}, torch.optim.AdamW([w], lr=0.1)


def test_save_restore_roundtrip(tmp_path):
    step, params, opt = _state()
    tokens = _tokens()
    params, opt, _ = step(params, opt, tokens)
    tck.save(str(tmp_path), 1, params, opt)
    assert tck.latest_step(str(tmp_path)) == 1

    # the restored state into a fresh incarnation (other init), then the
    # same step on both: bit-identical, since the state is
    params2_t, opt2_t = _state(seed=7)[1:]
    ids = [id(t) for t in _leaves(params2_t)]
    step_no, params2, opt2 = tck.restore(str(tmp_path), params2_t, opt2_t)
    assert step_no == 1 and params2 is params2_t and opt2 is opt2_t
    # in place: the optimizer still updates the tree's own tensors
    assert [id(t) for t in _leaves(params2)] == ids
    assert [id(p) for p in opt2.param_groups[0]["params"]] == ids
    for a, b in zip(opt.param_groups[0]["params"], opt2.param_groups[0]["params"]):
        sa, sb = opt.state[a], opt2.state[b]
        assert set(sa) == set(sb) == {"step", "exp_avg", "exp_avg_sq"}
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
            assert (sa[k].dtype, sa[k].device) == (sb[k].dtype, sb[k].device)
    ref_params, _, ref_loss = step(params, opt, tokens)
    params2, _, loss2 = step(params2, opt2, tokens)
    assert float(loss2) == float(ref_loss)
    for a, b in zip(_leaves(ref_params), _leaves(params2)):
        assert torch.equal(a, b)


def test_restore_missing_dir(tmp_path):
    with pytest.raises(FileNotFoundError):
        tck.restore(str(tmp_path / "nope"), {}, None)


def test_restore_params_only_from_full_checkpoint(tmp_path):
    step, params, opt = _state()
    params, opt, _ = step(params, opt, _tokens())
    tck.save(str(tmp_path), 7, params, opt)

    template = {k: v for k, v in _state(seed=3)[1].items()}
    got_step, restored = tck.restore_params(str(tmp_path), template)
    assert got_step == 7 and restored is template
    for a, b in zip(_leaves(restored), _leaves(params)):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        tck.restore_params(str(tmp_path / "nope"), template)


def test_save_is_atomic_crash_before_marker_invisible(tmp_path):
    d = str(tmp_path)
    p1, opt = _tiny_state(1.0)
    tck.save(d, 1, p1, opt)
    p2, opt2 = _tiny_state(2.0)
    tck.save(d, 2, p2, opt2)
    assert tck.latest_step(d) == 2
    assert os.path.exists(os.path.join(d, "2", "hived_complete.json"))

    os.unlink(os.path.join(d, "2", "hived_complete.json"))  # the crash window
    assert tck.latest_step(d) == 1
    template, topt = _template()
    step, params = tck.restore_params(d, template)
    assert step == 1
    assert torch.equal(params["w"], torch.full((4, 4), 1.0))
    # full restore takes the same ladder
    template, topt = _template()
    step, params, _ = tck.restore(d, template, topt)
    assert step == 1
    assert torch.equal(params["w"], torch.full((4, 4), 1.0))


def test_restore_falls_back_past_torn_committed_step(tmp_path):
    d = str(tmp_path)
    p1, opt1 = _tiny_state(1.0)
    p3, opt3 = _tiny_state(3.0)
    tck.save(d, 1, p1, opt1)
    tck.save(d, 3, p3, opt3)
    payload = glob.glob(os.path.join(d, "3", "*.distcp"))
    assert payload
    for f in payload:
        with open(f, "r+b") as fh:
            fh.truncate(3)  # torn data file despite the marker
    template, topt = _template()
    step, params, _ = tck.restore(d, template, topt)
    assert step == 1
    assert torch.equal(params["w"], torch.full((4, 4), 1.0))
    # an EXPLICITLY requested step must not silently fall back
    with pytest.raises(Exception) as err:
        tck.restore_params(d, _template()[0], step=3)
    assert not isinstance(err.value, FileNotFoundError)


def test_extra_metadata_commits_with_the_marker(tmp_path):
    d = str(tmp_path)
    params, opt = _tiny_state(1.0)
    extra = {"loader": {"seed": 3, "step": 5, "epoch": 0,
                        "bitgen": {"bit_generator": "PCG64"}}}
    tck.save(d, 5, params, opt, extra=extra)
    assert tck.read_metadata(d) == extra
    assert tck.read_metadata(d, 5) == extra
    tck.save(d, 6, params, opt)
    assert tck.read_metadata(d) == {}
    assert tck.read_metadata(d, 5) == extra
    assert tck.read_metadata(d, 99) == {}
    assert tck.read_metadata(str(tmp_path / "nope")) == {}
    os.unlink(os.path.join(d, "6", "hived_complete.json"))
    assert tck.latest_step(d) == 5
    assert tck.read_metadata(d) == extra


def test_atomic_write_bytes_replaces_whole_file(tmp_path):
    target = tmp_path / "latest"
    tck.atomic_write_bytes(str(target), b"one")
    assert target.read_bytes() == b"one"
    tck.atomic_write_bytes(str(target), b"two-longer")
    assert target.read_bytes() == b"two-longer"
    assert [p.name for p in tmp_path.iterdir()] == ["latest"]


def test_jax_readers_read_a_port_directory_as_the_port_does(tmp_path):
    d = str(tmp_path)
    params, opt = _tiny_state(1.0)
    for s in (2, 4):
        tck.save(d, s, params, opt, extra={"loader": {"step": s}})
    os.makedirs(os.path.join(d, "6"))  # a save killed before its marker
    assert jck._committed_steps(d) == tck._committed_steps(d) == [4, 2]
    assert jck.latest_step(d) == tck.latest_step(d) == 4
    for s in (None, 2, 4, 6, 99):
        assert jck.read_metadata(d, s) == tck.read_metadata(d, s)
    marker = json.loads((tmp_path / "4" / "hived_complete.json").read_text())
    assert marker == {"step": 4, "format": tck.FORMAT,
                      "extra": {"loader": {"step": 4}}}


def test_a_marker_of_another_format_raises(tmp_path):
    d = str(tmp_path)
    params, opt = _tiny_state(1.0)
    tck.save(d, 1, params, opt)
    tck.save(d, 2, params, opt)
    # what the JAX package writes beside an orbax payload
    tck.atomic_write_bytes(os.path.join(d, "2", "hived_complete.json"),
                           json.dumps({"step": 2, "format": "orbax-composite-v1"}).encode())
    for restore in (lambda: tck.restore(d, *_template()),
                    lambda: tck.restore_params(d, _template()[0]),
                    lambda: tck.restore_params(d, _template()[0], step=2)):
        with pytest.raises(ValueError) as err:
            restore()
        assert "orbax-composite-v1" in str(err.value)


def test_three_newest_committed_steps_are_kept(tmp_path):
    d = str(tmp_path)
    params, opt = _tiny_state(1.0)
    for s in (1, 2, 3, 4, 5):
        tck.save(d, s, params, opt)
    assert tck._committed_steps(d) == [5, 4, 3]
    assert sorted(os.listdir(d)) == ["3", "4", "5"]


def test_saving_a_committed_step_again_replaces_it(tmp_path):
    d = str(tmp_path)
    tck.save(d, 2, *_tiny_state(1.0))
    tck.save(d, 2, *_tiny_state(5.0))
    assert tck.latest_step(d) == 2
    template, _ = _template()
    tck.restore_params(d, template)
    assert torch.equal(template["w"], torch.full((4, 4), 5.0))


def test_restore_into_another_geometry_raises(tmp_path):
    step, params, opt = _state()
    tck.save(str(tmp_path), 1, params, opt)
    wide = dict(CFG, d_model=64)
    _, init_fn = ttrain.make_train_step(ttm.TransformerConfig(**wide), "cpu")
    params2, opt2 = init_fn(torch.Generator().manual_seed(0))
    with pytest.raises(Exception) as err:
        tck.restore(str(tmp_path), params2, opt2, step=1)
    assert not isinstance(err.value, FileNotFoundError)


def test_train_metadata_matches_jax():
    kw = dict(CFG, n_kv_heads=2, n_experts=0)
    jcfg, tcfg = jtm.TransformerConfig(**kw), ttm.TransformerConfig(**kw)
    want = jck.train_metadata(jtopo.MeshAxes(), jcfg, global_batch=8, seq_len=16)
    got = tck.train_metadata(ttopo.MeshAxes(), tcfg, global_batch=8, seq_len=16)
    assert got == want
    assert json.loads(json.dumps(got)) == got
    assert tck.GEOMETRY_FIELDS == jck.GEOMETRY_FIELDS
    for name in ("names", "shape", "size"):
        assert getattr(ttopo.MeshAxes(), name) == getattr(jtopo.MeshAxes(), name)
        assert getattr(ttopo.MeshAxes(tp=2, dp=3), name) == \
            getattr(jtopo.MeshAxes(tp=2, dp=3), name)


@pytest.mark.parametrize("change,kw", [
    ("geometry", dict(d_model=64)),
    ("geometry", dict(n_layers=3, vocab_size=128)),
    ("data", dict(global_batch=4)),
    ("data", dict(seq_len=32)),
    ("mesh", dict(mesh=dict(tp=2))),
    ("same", {}),
])
def test_validate_resume_metadata_matches_jax(change, kw):
    base = dict(CFG, n_kv_heads=2)
    saved = jck.train_metadata(jtopo.MeshAxes(**kw.get("mesh", {})),
                               jtm.TransformerConfig(**base),
                               global_batch=8, seq_len=16)
    cur = {k: v for k, v in kw.items() if k in CFG}
    batch, seq = kw.get("global_batch", 8), kw.get("seq_len", 16)
    outcomes = []
    for mod, topo, tm in ((jck, jtopo, jtm), (tck, ttopo, ttm)):
        try:
            outcomes.append(("ok", mod.validate_resume_metadata(
                saved, topo.MeshAxes(), tm.TransformerConfig(**dict(base, **cur)),
                global_batch=batch, seq_len=seq)))
        except ValueError as e:
            outcomes.append(("raised", str(e)))
    assert outcomes[0] == outcomes[1]
    want = {"geometry": "raised", "data": "raised", "mesh": "ok", "same": "ok"}[change]
    assert outcomes[1][0] == want
    if change == "mesh":
        assert outcomes[1][1]["tp"] == 2
