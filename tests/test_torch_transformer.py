"""The port's transformer (hivedscheduler_tpu_torch.models.transformer)
against the JAX package's on the same weights, carried across by
hivedscheduler_tpu_torch.bridge.

Tolerances: in f32 the two forwards differ only by summation order, so
logits (|logit| <= ~5) agree to atol 1e-4; observed <= 5e-6. In bf16 both
round activations after every matmul, but at different points (XLA fuses
differently from PyTorch's eager ops), so one-ulp differences of bf16
(2^-8 relative) compound over the layers: atol 0.1, about 2% of the
largest logit; observed <= 0.051 over three seeds.
"""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu_torch import bridge, resolve_device
from hivedscheduler_tpu_torch.models import transformer as ttm

torch.set_num_threads(1)

F32_ATOL = 1e-4
BF16_ATOL = 0.1

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "hivedscheduler_tpu_torch")

SMALL = dict(vocab_size=96, d_model=128, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=256, max_seq_len=128, attn_block_q=64,
             attn_block_k=64)


def _configs(attn_impl, dtype_name, **over):
    kw = dict(SMALL, attn_impl=attn_impl)
    kw.update(over)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype_name]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    return jtm.TransformerConfig(dtype=jdt, **kw), ttm.TransformerConfig(dtype=tdt, **kw)


def _tokens(seed, b, t, vocab):
    return np.random.default_rng(seed).integers(0, vocab, size=(b, t)).astype(np.int32)


def _jax_params(jcfg, seed=0):
    return jax.device_get(jtm.init_params(jcfg, jax.random.PRNGKey(seed)))


def _both_logits(jcfg, tcfg, tokens, seed=0):
    params_np = _jax_params(jcfg, seed)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        ref = np.asarray(jtm.forward(params_np, jnp.asarray(tokens), jcfg))
    out = ttm.forward(bridge.from_numpy_tree(params_np),
                      torch.from_numpy(tokens), tcfg)
    return out, ref


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_logits_match_jax_f32(attn_impl):
    jcfg, tcfg = _configs(attn_impl, "f32")
    out, ref = _both_logits(jcfg, tcfg, _tokens(0, 2, 128, 96))
    assert out.shape == (2, 128, 96) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_ATOL)


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_logits_match_jax_bf16(attn_impl):
    jcfg, tcfg = _configs(attn_impl, "bf16")
    out, ref = _both_logits(jcfg, tcfg, _tokens(1, 2, 128, 96))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=BF16_ATOL)


def test_logits_match_jax_mha_f32():
    # n_kv_heads = n_heads: no GQA grouping on either side
    jcfg, tcfg = _configs("flash", "f32", n_kv_heads=0)
    out, ref = _both_logits(jcfg, tcfg, _tokens(2, 1, 128, 96))
    np.testing.assert_allclose(out.numpy(), ref, atol=F32_ATOL)


def test_flash_path_goes_through_flash_forward(monkeypatch):
    # on the CPU the flash path runs the plain version once per layer, with
    # compact (un-repeated) GQA k/v, and takes no reference route
    from hivedscheduler_tpu_torch.ops import attention as tattn

    seen = []
    real = tattn.flash_forward

    def spy(q, k, v, causal=True):
        seen.append((q.shape[2], k.shape[2]))
        return real(q, k, v, causal)

    monkeypatch.setattr(tattn, "flash_forward", spy)
    _, tcfg = _configs("flash", "f32")
    params = ttm.init_params(tcfg, torch.Generator().manual_seed(0))
    before = tattn.FLASH_REFERENCE_ROUTES
    ttm.forward(params, torch.from_numpy(_tokens(3, 1, 128, 96)), tcfg)
    assert seen == [(4, 2)] * tcfg.n_layers
    assert tattn.FLASH_REFERENCE_ROUTES == before


def test_hidden_matches_jax_f32():
    jcfg, tcfg = _configs("flash", "f32")
    params_np = _jax_params(jcfg)
    tokens = _tokens(4, 1, 128, 96)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        ref, _ = jtm.forward_with_aux(params_np, jnp.asarray(tokens), jcfg,
                                      return_hidden=True)
    out, aux = ttm.forward_with_aux(bridge.from_numpy_tree(params_np),
                                    torch.from_numpy(tokens), tcfg,
                                    return_hidden=True)
    assert out.shape == (1, 128, 128) and float(aux) == 0.0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=F32_ATOL)


def test_rope_and_rms_norm_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 3, 8), dtype=np.float32)
    w = rng.standard_normal((8,), dtype=np.float32)
    pos = np.arange(16, dtype=np.int32)[None, :]
    np.testing.assert_allclose(
        ttm._rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy(),
        np.asarray(jtm._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)),
        atol=1e-5)
    np.testing.assert_allclose(
        ttm._rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jtm._rms_norm(jnp.asarray(x), jnp.asarray(w))), atol=1e-5)


def test_bridge_round_trip_is_exact():
    jcfg, _ = _configs("flash", "f32")
    params_np = _jax_params(jcfg)
    back = bridge.to_numpy_tree(bridge.from_numpy_tree(params_np))
    flat_a = jax.tree_util.tree_leaves_with_path(params_np)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_bridge_bf16_leaves_round_trip_through_f32():
    leaf = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    t = bridge.from_numpy_tree({"w": leaf})["w"]
    assert t.dtype == torch.bfloat16
    back = bridge.to_numpy_tree({"w": t})["w"]
    np.testing.assert_array_equal(back, leaf.astype(np.float32))


def test_init_params_shapes_and_dtypes_match_jax():
    jcfg, tcfg = _configs("flash", "f32")
    shapes = jax.eval_shape(lambda k: jtm.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    params = ttm.init_params(tcfg, torch.Generator().manual_seed(0))
    want = {jax.tree_util.keystr(p): (tuple(s.shape), str(s.dtype))
            for p, s in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {jax.tree_util.keystr(p): (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for p, t in jax.tree_util.tree_leaves_with_path(params)}
    assert got == want


def test_init_params_is_seeded():
    _, tcfg = _configs("flash", "f32")
    a = ttm.init_params(tcfg, torch.Generator().manual_seed(3))
    b = ttm.init_params(tcfg, torch.Generator().manual_seed(3))
    assert torch.equal(a["layers"]["wq"], b["layers"]["wq"])
    # N(0, 1/fan_in): the std of a d_model-fan-in weight is ~1/sqrt(128)
    std = float(a["layers"]["w_gate"].std())
    assert abs(std - 128 ** -0.5) < 0.01


def test_config_fields_pinned_to_jax():
    names = [f.name for f in dataclasses.fields(jtm.TransformerConfig)]
    assert [f.name for f in dataclasses.fields(ttm.TransformerConfig)] == names
    jd, td = jtm.TransformerConfig(), ttm.TransformerConfig()
    for n in names:
        if n != "dtype":
            assert getattr(td, n) == getattr(jd, n), n
    assert td.dtype == torch.bfloat16
    cfg = ttm.TransformerConfig(d_model=2048, n_heads=16, n_kv_heads=8)
    assert (cfg.head_dim, cfg.kv_heads) == (128, 8)


def test_cast_params_and_load_weight():
    _, tcfg = _configs("flash", "f32")
    params = ttm.init_params(tcfg, torch.Generator().manual_seed(0))
    params["layers"]["int_leaf"] = torch.arange(3)
    q = {"qi8": torch.tensor([2, -3], dtype=torch.int8),
         "scale": torch.tensor([0.5, 0.5])}
    params["quant"] = q
    cast = ttm.cast_params(params, torch.bfloat16)
    assert cast["embed"].dtype == torch.bfloat16
    assert cast["layers"]["wq"].dtype == torch.bfloat16
    assert cast["layers"]["int_leaf"].dtype == torch.int64
    assert cast["quant"] is q
    np.testing.assert_array_equal(
        ttm.load_weight(q, torch.float32).numpy(), [1.0, -1.5])


@pytest.mark.parametrize("over,kind", [
    # MoE, LoRA and the pipeline are ported (tests/test_torch_moe.py,
    # tests/test_torch_lora.py, tests/test_torch_pipeline.py): the pipeline
    # needs a mesh, as in JAX. The overlapped stack is ported
    # (tests/test_torch_overlap.py): overlap=True without a mesh raises
    # JAX's ValueError (the ids are those of the cases when they raised
    # NotImplementedError)
    (dict(n_experts=2, lora_rank=4, pipeline_microbatches=2), ValueError),
    pytest.param(dict(lora_rank=4, overlap=True), ValueError,
                 id="over1-NotImplementedError"),
    (dict(pipeline_microbatches=2), ValueError),
    pytest.param(dict(overlap=True), ValueError, id="over3-NotImplementedError"),
    # the ring family needs a mesh (JAX asserts one)
    (dict(attn_impl="ring_flash"), ValueError),
    (dict(attn_impl="flsh"), ValueError),
    (dict(remat="some"), ValueError),
    # as JAX's init_params: MLP adapters need a rank and a dense MLP
    (dict(lora_mlp=True), ValueError),
    (dict(n_experts=2, lora_rank=4, lora_mlp=True), ValueError),
])
def test_unported_configs_raise(over, kind):
    over = dict(over)
    _, tcfg = _configs(over.pop("attn_impl", "flash"), "f32", **over)
    with pytest.raises(kind) as err:
        ttm.forward(None, torch.zeros((1, 8), dtype=torch.int32), tcfg)
    if over.get("overlap"):
        assert ("cfg.overlap=True but the overlapped path cannot serve this "
                "config: no mesh") in str(err.value)


class _SpMesh:
    """The six axes of a mesh with sp = 2 (all the forward reads of one
    before it refuses the mesh)."""

    mesh_dim_names = ("dp", "fsdp", "pp", "ep", "tp", "sp")
    mesh = torch.zeros((1, 1, 1, 1, 1, 2))

    def get_group(self, name):
        return None


def test_forward_over_a_mesh_raises():
    # dp, fsdp, tp, sp and pp are ported (tests/test_torch_sharded_train.py,
    # tests/test_torch_sp_train.py, tests/test_torch_pipeline.py), every
    # attn_impl at sp > 1 (xla and flash gather the sequence) and MoE at
    # sp > 1 (tests/test_torch_moe_sp.py); a pipeline stage at sp > 1
    # needs the ring family, with the JAX package's message
    _, tcfg = _configs("xla", "f32")
    piped = dataclasses.replace(tcfg, pipeline_microbatches=2)
    with pytest.raises(ValueError) as err:
        ttm.forward(None, torch.zeros((1, 8), dtype=torch.int32), piped, mesh=_SpMesh())
    assert "pipeline with mesh sp > 1 requires one of attn_impl" in str(err.value)
    for impl in ("xla", "flash"):
        ttm.check_mesh(dataclasses.replace(tcfg, attn_impl=impl), {"sp": 2})
        ttm.check_mesh(dataclasses.replace(tcfg, attn_impl=impl, n_experts=2), {"sp": 2})


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError) as err:
            resolve_device()
        assert "no CUDA device" in str(err.value)


FORBIDDEN_ROOTS = {"jax", "jaxlib", "optax", "orbax", "yaml",
                   "hivedscheduler_tpu"}


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PORT_DIR):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


# modules whose reference imports JAX, orbax or the JAX package's own
# modules: the port keeps its own copies
PORT_COPIES = ("common/envflags.py", "parallel/topology.py",
               "parallel/checkpoint.py", "parallel/supervisor.py",
               "obs/goodput.py", "chaos/workload.py", "train.py", "eval.py",
               "models/decode.py", "models/quant.py", "models/speculative.py",
               "generate.py", "parallel/ring_attention.py", "fleet/__init__.py",
               "fleet/router.py", "fleet/autoscaler.py", "common/compileguard.py")


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = _port_files()
    assert len(files) > 10
    rel = {os.path.relpath(p, PORT_DIR) for p in files}
    assert set(PORT_COPIES) <= rel
    bad = [(os.path.relpath(p, REPO), line, root)
           for p in files for root, line in _imported_roots(p)
           if root in FORBIDDEN_ROOTS]
    assert bad == []


def test_import_check_sees_a_forbidden_import(tmp_path):
    # the check reads import statements, so the package name being a prefix
    # of the port's does not hide an import of it
    p = tmp_path / "m.py"
    p.write_text("import hivedscheduler_tpu_torch\n"
                 "from hivedscheduler_tpu.ops import attention\n"
                 "def f():\n    import jax.numpy\n")
    roots = [r for r, _ in _imported_roots(str(p)) if r in FORBIDDEN_ROOTS]
    assert roots == ["hivedscheduler_tpu", "jax"]
