"""The port's generate CLI (hivedscheduler_tpu_torch.generate) on the CPU,
and ``checkpoint.restore_serving_params``.

Each CLI run is held to the library call it stands for, on the same seeded
weights and prompt, token for token: ``decode.generate`` (greedy, int8),
``speculative.generate_speculative`` (``--draft-layers``), and the
parameters a ``train`` run checkpointed (``--checkpoint-dir``), a LoRA
run's merged (``--lora-rank``, ``--lora-mlp``).
"""

import logging

import pytest
import torch

from hivedscheduler_tpu_torch import generate as tgen_cli
from hivedscheduler_tpu_torch import train as ttrain_cli
from hivedscheduler_tpu_torch.models import decode as tdec
from hivedscheduler_tpu_torch.models import quant as tquant
from hivedscheduler_tpu_torch.models import speculative as tspec
from hivedscheduler_tpu_torch.models import transformer as ttm
from hivedscheduler_tpu_torch.obs import goodput as tgp
from hivedscheduler_tpu_torch.parallel import checkpoint as tck

torch.set_num_threads(1)

MODEL = dict(vocab_size=96, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=128)
BATCH, PROMPT, NEW, SEED = 2, 8, 6, 5
CLI = [a for k, v in MODEL.items() for a in (f"--{k.replace('_', '-')}", str(v))] + [
    "--batch", str(BATCH), "--prompt-len", str(PROMPT), "--new-tokens", str(NEW),
    "--seed", str(SEED), "--device", "cpu"]
CFG = ttm.TransformerConfig(max_seq_len=PROMPT + NEW, **MODEL)


@pytest.fixture(autouse=True)
def _fresh_goodput():
    """The goodput ledger is a process singleton: each test starts with it
    off and leaves it off."""
    tgp.disable()
    tgp.GOODPUT.clear()
    yield
    tgp.disable()
    tgp.GOODPUT.clear()


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture
def log_lines():
    """The CLI's log messages. A module another test file imports may have
    disabled logging process-wide (bench.py does, at import): lift that
    while the CLI runs."""
    disabled = logging.root.manager.disable
    logging.disable(logging.NOTSET)
    handler = _Messages()
    logger = logging.getLogger(tgen_cli.__name__)
    logger.addHandler(handler)
    yield handler.lines
    logger.removeHandler(handler)
    logging.disable(disabled)


def _run(capsys, *extra):
    capsys.readouterr()
    rc = tgen_cli.main(CLI + list(extra))
    out = capsys.readouterr().out
    return rc, [[int(t) for t in line.split()] for line in out.splitlines()]


def _seeded(offset):
    return torch.Generator().manual_seed(SEED + offset)


def _inputs():
    """The weights (f32) and prompt the CLI draws from --seed."""
    params = ttm.init_params(CFG, _seeded(0))
    prompt = torch.randint(0, CFG.vocab_size, (BATCH, PROMPT), generator=_seeded(1))
    return params, prompt


def test_greedy_rows_equal_generate(capsys):
    rc, rows = _run(capsys)
    assert rc == 0
    params, prompt = _inputs()
    want = tdec.generate(ttm.cast_params(params, CFG.dtype), prompt, CFG, NEW)
    assert rows == want.tolist()
    assert len(rows) == BATCH and all(len(r) == NEW for r in rows)


def test_int8_rows_equal_generate_on_quantized_weights(capsys):
    rc, rows = _run(capsys, "--quantize", "int8")
    assert rc == 0
    params, prompt = _inputs()
    want = tdec.generate(tquant.quantize_params(params, CFG), prompt, CFG, NEW)
    assert rows == want.tolist()


def test_draft_layers_rows_equal_generate_speculative(capsys, log_lines):
    rc, rows = _run(capsys, "--draft-layers", "1", "--gamma", "3")
    assert rc == 0
    params, prompt = _inputs()
    dcfg = tspec.derive_draft_config(CFG, 1)
    draft = ttm.cast_params(ttm.init_params(dcfg, _seeded(3)), dcfg.dtype)
    want, stats = tspec.generate_speculative(
        ttm.cast_params(params, CFG.dtype), draft, prompt, CFG, dcfg, NEW, gamma=3)
    assert rows == want.tolist()
    assert any(line.startswith(f"speculation: {stats.rounds} rounds, "
                               f"{stats.accepted}/{stats.drafted} draft tokens accepted")
               for line in log_lines)


def test_sampled_rows_repeat_and_the_goodput_spool_records_the_decode(capsys, tmp_path):
    flags = ["--temperature", "0.9", "--top-k", "10", "--top-p", "0.9"]
    gp = str(tmp_path / "goodput.jsonl")
    rc, first = _run(capsys, *flags, "--goodput-file", gp)
    assert rc == 0
    tgp.GOODPUT.close()
    assert tgp.aggregate_spool(tgp.read_spool(gp))["phases"]["step_compute"] > 0.0
    assert tgp.check_spool(gp) == []
    tgp.disable()
    tgp.GOODPUT.clear()
    assert _run(capsys, *flags) == (0, first)
    params, prompt = _inputs()
    want = tdec.generate(ttm.cast_params(params, CFG.dtype), prompt, CFG, NEW,
                         temperature=0.9, top_k=10, top_p=0.9, generator=_seeded(2))
    assert first == want.tolist()


@pytest.mark.parametrize("extra", [
    # --tp/--dp are ported (tests/test_torch_sharded_serving.py), MoE and
    # LoRA on the mesh too: one process cannot lay a mesh of two ranks,
    # which is a usage error, as train's is
    ["--tp", "2"], ["--dp", "2"], ["--n-experts", "2", "--tp", "2"],
    ["--lora-rank", "4", "--tp", "2"],
])
def test_unported_flags_exit_with_error(extra, capsys):
    with pytest.raises(SystemExit) as exc:
        tgen_cli.main(CLI + extra)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "1 devices not divisible by dp*tp=2" in err
    assert "not yet ported" not in err


@pytest.mark.parametrize("extra", [
    ["--top-k", "97"],
    ["--draft-layers", "1", "--gamma", "0"],
    ["--decode-steps", "0"],
    ["--draft-layers", "1", "--draft-d-model", "20"],
    ["--checkpoint-dir", "/nonexistent/checkpoints"],
])
def test_bad_values_exit_1(extra, capsys):
    rc, rows = _run(capsys, *extra)
    assert (rc, rows) == (1, [])


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError) as err:
        tgen_cli.main(CLI[:-2])  # default --device cuda
    assert "no CUDA device" in str(err.value)


TRAIN = [a for k, v in MODEL.items() for a in (f"--{k.replace('_', '-')}", str(v))] + [
    "--seq-len", "64", "--batch", "2", "--block-q", "64", "--block-k", "64",
    "--device", "cpu", "--attn", "flash", "--log-every", "100"]


def test_checkpoint_dir_restores_what_train_wrote(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    assert ttrain_cli.main(TRAIN + ["--steps", "2", "--checkpoint-dir", ck]) == 0
    params, step = tck.restore_serving_params(CFG, ck, _seeded(0))
    assert step == 2
    fresh = ttm.init_params(CFG, _seeded(0))
    assert not torch.equal(params["layers"]["wq"], fresh["layers"]["wq"])
    rc, rows = _run(capsys, "--checkpoint-dir", ck)
    assert rc == 0
    _, prompt = _inputs()
    want = tdec.generate(ttm.cast_params(params, CFG.dtype), prompt, CFG, NEW)
    assert rows == want.tolist()


def test_restore_serving_params_without_a_directory_and_its_refusals(tmp_path):
    params, step = tck.restore_serving_params(CFG, "", _seeded(0))
    assert step is None
    fresh = ttm.init_params(CFG, _seeded(0))
    assert all(torch.equal(params["layers"][k], fresh["layers"][k]) for k in fresh["layers"])
    with pytest.raises(FileNotFoundError) as err:
        tck.restore_serving_params(CFG, str(tmp_path / "missing"), _seeded(0))
    assert "no checkpoint found" in str(err.value)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tck.restore_serving_params(CFG, str(tmp_path / "empty"), _seeded(0))
    # a LoRA tree without a checkpoint merges its zero-init adapters: the
    # base, bit for bit
    merged, step = tck.restore_serving_params(CFG, "", _seeded(0), lora_rank=4,
                                              lora_mlp=True)
    assert step is None and set(merged["layers"]) == set(fresh["layers"])
    assert all(torch.equal(merged["layers"][k], fresh["layers"][k]) for k in fresh["layers"])


def test_lora_checkpoint_merges_into_generate(tmp_path, capsys, log_lines):
    """A LoRA run's checkpoint: ``--lora-rank`` (with its alpha and MLP
    adapters) restores base and adapters and decodes the merged model, as
    ``decode.generate`` does on ``merge_lora`` of the restored tree; int8
    quantizes after the merge."""
    import dataclasses

    ck = str(tmp_path / "lora")
    lora = ["--lora-rank", "4", "--lora-alpha", "8", "--lora-mlp"]
    assert ttrain_cli.main(TRAIN + lora + ["--steps", "2", "--checkpoint-dir", ck]) == 0
    lcfg = dataclasses.replace(CFG, lora_rank=4, lora_alpha=8.0, lora_mlp=True)
    tree = ttm.init_params(lcfg, _seeded(0))
    tck.restore_params(ck, tree)
    assert tree["layers"]["lora_w_down_b"].abs().sum() > 0  # the adapters trained
    merged = ttm.merge_lora(tree, lcfg)
    _, prompt = _inputs()
    rc, rows = _run(capsys, "--checkpoint-dir", ck, *lora)
    assert rc == 0
    assert rows == tdec.generate(ttm.cast_params(merged, CFG.dtype), prompt, CFG, NEW).tolist()
    assert "merged rank-4 LoRA adapters into the base weights" in log_lines
    rc, rows = _run(capsys, "--checkpoint-dir", ck, *lora, "--quantize", "int8")
    assert rc == 0
    assert rows == tdec.generate(tquant.quantize_params(merged, CFG), prompt, CFG,
                                 NEW).tolist()
