"""The port's eval path (hivedscheduler_tpu_torch.parallel.train, .eval,
.parallel.data) against the JAX package's on the same weights and windows.

The loss is a mean of O(10) per-token cross-entropies; in f32 the two
packages differ by summation order only, so losses agree to atol 1e-5
(observed ~1e-6). The synthetic corpus comes from the same numpy calls and
must be bit-identical.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hivedscheduler_tpu.models import transformer as jtm
from hivedscheduler_tpu.parallel import data as jdata
from hivedscheduler_tpu.parallel import topology
from hivedscheduler_tpu.parallel import train as jtrain
from hivedscheduler_tpu_torch import bridge
from hivedscheduler_tpu_torch import eval as teval
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.parallel import data as tdata
from hivedscheduler_tpu_torch.parallel import train as ttrain

torch.set_num_threads(1)

LOSS_ATOL = 1e-5

SMALL = dict(vocab_size=96, d_model=64, n_heads=4, n_kv_heads=2,
             n_layers=2, d_ff=128, max_seq_len=128, attn_block_q=64,
             attn_block_k=64, attn_impl="flash")
BATCH, SEQ = 2, 128


def _cfgs():
    return (jtm.TransformerConfig(dtype=jnp.float32, **SMALL),
            ttm.TransformerConfig(dtype=torch.float32, **SMALL))


def _windows(n):
    corpus = jdata.synthetic_dataset(SMALL["vocab_size"]).tokens
    w = BATCH * SEQ
    return [np.asarray(corpus[i * w:(i + 1) * w], dtype=np.int32).reshape(BATCH, SEQ)
            for i in range(n)]


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    return jax.device_get(jtm.init_params(jcfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("ce_chunk", [0, 32])
def test_loss_fn_matches_jax(weights, ce_chunk):
    jcfg, tcfg = _cfgs()
    tparams = bridge.from_numpy_tree(weights)
    tokens = _windows(1)[0]
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        ref = float(jtrain.loss_fn(weights, jnp.asarray(tokens), jcfg,
                                   ce_chunk=ce_chunk))
    with torch.inference_mode():
        got = float(ttrain.loss_fn(tparams, torch.from_numpy(tokens), tcfg,
                                   ce_chunk=ce_chunk))
    assert got == pytest.approx(ref, abs=LOSS_ATOL)


def test_chunked_ce_equals_full():
    _, tcfg = _cfgs()
    params = ttm.init_params(tcfg, torch.Generator().manual_seed(1))
    tokens = torch.from_numpy(_windows(1)[0])
    with torch.inference_mode():
        full = float(ttrain.loss_fn(params, tokens, tcfg))
        chunked = float(ttrain.loss_fn(params, tokens, tcfg, ce_chunk=64))
    assert chunked == pytest.approx(full, abs=LOSS_ATOL)
    with pytest.raises(ValueError) as err:
        ttrain.loss_fn(params, tokens, tcfg, ce_chunk=48)
    assert "not divisible by ce_chunk" in str(err.value)


@pytest.mark.parametrize("ce_chunk", [0, 64])
def test_eval_step_matches_jax_sharded_eval_step(weights, ce_chunk):
    jcfg, tcfg = _cfgs()
    mesh = topology.make_mesh(topology.MeshAxes(), jax.devices("cpu")[:1])
    j_step, _, tok_sh = jtrain.make_sharded_eval_step(jcfg, mesh,
                                                      ce_chunk=ce_chunk)
    t_step, _ = ttrain.make_eval_step(tcfg, "cpu", ce_chunk=ce_chunk)
    tparams = bridge.from_numpy_tree(weights)
    for tokens in _windows(2):
        ref = float(j_step(weights, jax.device_put(tokens, tok_sh)))
        got = t_step(tparams, torch.from_numpy(tokens))
        assert got.dtype == torch.float32 and got.shape == ()
        assert not got.requires_grad
        assert float(got) == pytest.approx(ref, abs=LOSS_ATOL)


def test_make_eval_step_init_fn_is_seeded_on_device():
    _, tcfg = _cfgs()
    _, init_fn = ttrain.make_eval_step(tcfg, "cpu")
    a = init_fn(torch.Generator().manual_seed(0))
    b = init_fn(torch.Generator().manual_seed(0))
    assert a["embed"].device.type == "cpu"
    assert torch.equal(a["lm_head"], b["lm_head"])


def test_synthetic_corpus_bit_identical_to_jax():
    for vocab, size, seed in ((96, 4096, 0), (1 << 17, 1000, 3)):
        a = jdata.synthetic_dataset(vocab, size=size, seed=seed).tokens
        b = tdata.synthetic_dataset(vocab, size=size, seed=seed).tokens
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_token_file_dataset_matches_jax(tmp_path):
    path = tmp_path / "corpus.bin"
    np.arange(1000, dtype=np.uint32).tofile(path)
    a = jdata.TokenFileDataset(str(path), dtype="uint32")
    b = tdata.TokenFileDataset(str(path), dtype="uint32")
    assert len(a) == len(b) == 1000
    np.testing.assert_array_equal(a.tokens, b.tokens)
    empty = tmp_path / "empty.bin"
    empty.write_bytes(b"")
    with pytest.raises(ValueError):
        tdata.TokenFileDataset(str(empty))


CLI_MODEL = ["--vocab-size", "96", "--d-model", "64", "--n-layers", "2",
             "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "128",
             "--seq-len", "128", "--batch", "2", "--device", "cpu"]


def _run_cli(args, capsys):
    assert teval.main(args) == 0
    line = [l for l in capsys.readouterr().out.splitlines() if "loss" in l][-1]
    parts = line.split()
    assert parts[0] == "loss" and parts[2] == "perplexity"
    return float(parts[1]), float(parts[3])


@pytest.mark.parametrize("attn", ["flash", "xla"])
def test_cli_prints_loss_line_for_its_windows(attn, capsys):
    loss, ppl = _run_cli(CLI_MODEL + ["--attn", attn, "--ce-chunk", "64",
                                      "--max-steps", "2"], capsys)
    assert ppl == pytest.approx(math.exp(loss), rel=1e-4)
    # the same windows through the step the CLI builds, on the same seeded
    # weights: the CLI is the sequential-window mean of eval_step
    cfg = ttm.TransformerConfig(**dict(SMALL, attn_impl=attn, dtype=torch.bfloat16))
    step, init_fn = ttrain.make_eval_step(cfg, "cpu", ce_chunk=64)
    params = init_fn(torch.Generator(device="cpu").manual_seed(0))
    want = sum(float(step(params, torch.from_numpy(w))) for w in _windows(2)) / 2
    assert loss == pytest.approx(want, abs=1e-6)


def test_cli_reads_a_token_file(tmp_path, capsys):
    path = tmp_path / "corpus.bin"
    np.tile(np.arange(8, dtype=np.uint16), 200).tofile(path)
    loss, _ = _run_cli(CLI_MODEL + ["--data", str(path)], capsys)
    assert np.isfinite(loss)


def test_cli_rejects_a_too_small_corpus(tmp_path):
    path = tmp_path / "tiny.bin"
    np.arange(10, dtype=np.uint16).tofile(path)
    assert teval.main(CLI_MODEL + ["--data", str(path)]) == 1


def test_cli_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError) as err:
        teval.main(CLI_MODEL[:-2] + ["--max-steps", "1"])  # default --device cuda
    assert "no CUDA device" in str(err.value)


@pytest.mark.parametrize("extra", [
    ["--tp", "2"], ["--sp", "2"], ["--fsdp", "2"], ["--ep", "2"],
    ["--n-experts", "2", "--sp", "2"], ["--attn", "ring", "--sp", "2"],
])
def test_cli_unported_flags_exit_with_error(extra, capsys):
    # --tp, --fsdp, --ep and --sp (with the ring family) are ported, and
    # MoE at --sp above 1 too (tests/test_torch_moe_sp.py): on one device
    # their mesh cannot be laid, which is a usage error
    with pytest.raises(SystemExit) as exc:
        teval.main(CLI_MODEL + extra)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    if {"--tp", "--fsdp", "--sp", "--ep"} & set(extra):
        assert "1 devices not divisible by tp*sp*fsdp*pp*ep=2" in err
    else:
        assert "not yet ported" in err
