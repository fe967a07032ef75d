"""The port's ``train`` CLI (hivedscheduler_tpu_torch.train) on the CPU,
and its divergence guard (hivedscheduler_tpu_torch.parallel.supervisor)
against the JAX package's."""

import json
import logging
import math

import pytest
import torch

from hivedscheduler_tpu.parallel import supervisor as jsup
from hivedscheduler_tpu_torch import train as ttrain_cli
from hivedscheduler_tpu_torch.parallel import supervisor as tsup
from hivedscheduler_tpu_torch.parallel import train as ttrain

torch.set_num_threads(1)

CLI_MODEL = ["--vocab-size", "96", "--d-model", "64", "--n-layers", "2",
             "--n-heads", "4", "--n-kv-heads", "2", "--d-ff", "128",
             "--seq-len", "128", "--batch", "2", "--block-q", "64",
             "--block-k", "64", "--ce-chunk", "64", "--device", "cpu"]


class _StepLines(logging.Handler):
    """Keeps the arguments of the CLI's step log line."""

    def __init__(self):
        super().__init__()
        self.args = []

    def emit(self, record):
        if record.msg == ttrain_cli.STEP_LOG:
            self.args.append(record.args)


@pytest.fixture
def step_lines():
    # a module imported by another test file in this process may have
    # disabled logging process-wide (bench.py does, at import): lift that
    # while the CLI runs, since its step line is what these tests read
    disabled = logging.root.manager.disable
    logging.disable(logging.NOTSET)
    handler = _StepLines()
    logger = logging.getLogger(ttrain_cli.__name__)
    logger.addHandler(handler)
    yield handler.args
    logger.removeHandler(handler)
    logging.disable(disabled)


@pytest.mark.parametrize("attn,remat", [("flash", "dots"), ("xla", "full")])
def test_two_steps_log_and_write_the_timeline(attn, remat, tmp_path, step_lines):
    timeline = tmp_path / "timeline.jsonl"
    rc = ttrain_cli.main(CLI_MODEL + ["--attn", attn, "--remat", remat,
                                      "--steps", "2", "--log-every", "1",
                                      "--timeline", str(timeline)])
    assert rc == 0
    assert [a[0] for a in step_lines] == [1, 2]
    assert all(math.isfinite(a[1]) and a[2] > 0 for a in step_lines)
    records = [json.loads(line) for line in timeline.read_text().splitlines()]
    assert [r["step"] for r in records] == [1, 2]
    assert [r["compile"] for r in records] == [True, False]
    assert set(records[0]) == {"step", "wall_s", "tokens_per_sec", "loss", "compile"}
    # the log line and the timeline report the same losses
    assert [r["loss"] for r in records] == pytest.approx([a[1] for a in step_lines])


def test_cli_steps_are_the_train_step_on_the_loader_stream(step_lines):
    # the CLI's losses are make_train_step's on the seeded weights and the
    # checkpointable stream's batches
    from hivedscheduler_tpu_torch.models import transformer as ttm
    from hivedscheduler_tpu_torch.parallel import data as tdata

    assert ttrain_cli.main(CLI_MODEL + ["--attn", "flash", "--steps", "2",
                                        "--log-every", "1", "--prefetch", "0"]) == 0
    cfg = ttm.TransformerConfig(vocab_size=96, d_model=64, n_layers=2, n_heads=4,
                                n_kv_heads=2, d_ff=128, max_seq_len=128,
                                attn_impl="flash", attn_block_q=64, attn_block_k=64)
    step, init_fn = ttrain.make_train_step(cfg, "cpu", ce_chunk=64)
    params, opt = init_fn(torch.Generator().manual_seed(0))
    loader = tdata.CheckpointableBatches(tdata.synthetic_dataset(96), 2, 128)
    want = []
    for _ in range(2):
        params, opt, loss = step(params, opt, torch.from_numpy(next(loader)))
        want.append(float(loss))
    assert [a[1] for a in step_lines] == pytest.approx(want, abs=1e-6)


def _poison_step(monkeypatch, at_step):
    """Make the loss of the given (1-based) step non-finite."""
    calls = []
    real = ttrain.loss_fn

    def loss_fn(*a, **kw):
        calls.append(1)
        loss = real(*a, **kw)
        return loss * float("nan") if len(calls) == at_step else loss

    monkeypatch.setattr(ttrain, "loss_fn", loss_fn)


def test_non_finite_loss_halts_with_exit_44(monkeypatch, step_lines):
    _poison_step(monkeypatch, 2)
    rc = ttrain_cli.main(CLI_MODEL + ["--attn", "flash", "--steps", "3",
                                      "--log-every", "1", "--on-nan", "halt"])
    assert rc == tsup.EXIT_DIVERGED == jsup.EXIT_DIVERGED
    assert [a[0] for a in step_lines] == [1]  # step 2 diverged, 3 never ran


def test_non_finite_loss_is_skipped_under_skip(monkeypatch, step_lines):
    _poison_step(monkeypatch, 2)
    rc = ttrain_cli.main(CLI_MODEL + ["--attn", "flash", "--steps", "3",
                                      "--log-every", "1", "--on-nan", "skip"])
    assert rc == 0
    losses = [a[1] for a in step_lines]
    assert [a[0] for a in step_lines] == [1, 2, 3]
    assert math.isfinite(losses[0]) and math.isnan(losses[1])
    assert math.isfinite(losses[2])  # the skipped update left the state sound


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError) as err:
        ttrain_cli.main(CLI_MODEL[:-2] + ["--steps", "1"])  # default --device cuda
    assert "no CUDA device" in str(err.value)


@pytest.mark.parametrize("extra", [
    ["--tp", "2"], ["--sp", "2"], ["--fsdp", "2"], ["--pp", "2"], ["--ep", "2"],
    ["--microbatches", "2"], ["--n-experts", "2", "--sp", "2"],
    ["--lora-rank", "4", "--on-nan", "skip"], ["--lora-mlp"],
    ["--lora-rank", "4", "--lora-mlp", "--n-experts", "2"], ["--overlap"],
    ["--min-chips", "2"], ["--attn", "ring", "--sp", "2"],
])
def test_unported_flags_exit_with_error(extra, capsys):
    # --tp, --fsdp, --ep and --sp are ported, MoE at --sp above 1 too: on
    # one device their mesh cannot be laid, which is a usage error too;
    # --pp and --microbatches are ported, each refused without the other
    # with the JAX CLI's usage errors; LoRA is ported, and refused where
    # JAX's CLI refuses it (--on-nan skip) or its init_params does (MLP
    # adapters without a rank, or on experts); --overlap is not yet ported
    with pytest.raises(SystemExit) as exc:
        ttrain_cli.main(CLI_MODEL + extra)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    if "--on-nan" in extra:
        assert "--on-nan skip gates the full train step" in err
    elif "--min-chips" in extra:
        # --elastic is ported (tests/test_torch_elastic.py): the floor
        # without it is the JAX CLI's usage error
        assert "--min-chips requires --elastic" in err
    elif "--lora-mlp" in extra:
        assert ("requires --lora-rank > 0" if "--n-experts" not in extra
                else "MoE experts are not adapted") in err
    elif "--pp" in extra:
        assert "--pp > 1 requires --microbatches" in err
    elif "--microbatches" in extra:
        assert "--microbatches requires --pp > 1" in err
    elif {"--tp", "--fsdp", "--sp", "--ep"} & set(extra):
        assert "1 devices not divisible by tp*sp*fsdp*pp*ep=2" in err
    else:
        assert "not yet ported" in err


def test_flags_and_defaults_match_the_jax_cli():
    # every flag of the JAX train CLI exists with the same default; the port
    # adds --device only
    from hivedscheduler_tpu import train as jtrain_cli

    captured = {}

    class Stop(Exception):
        pass

    def grab(self, args=None, namespace=None):
        captured[self.prog] = {a.dest: a.default for a in self._actions
                               if a.dest != "help"}
        raise Stop

    import argparse

    real = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        for cli in (jtrain_cli, ttrain_cli):
            with pytest.raises(Stop):
                cli.main([])
    finally:
        argparse.ArgumentParser.parse_args = real
    jax_flags, port_flags = captured["tpu-hive-train"], captured["tpu-hive-torch-train"]
    assert set(port_flags) - set(jax_flags) == {"device"}
    assert {k: port_flags[k] for k in jax_flags} == jax_flags


@pytest.mark.parametrize("losses,spike", [
    ([3.0, 2.9, float("nan")], 0.0),
    ([3.0, 2.9, float("inf")], 0.0),
    ([3.0] * 6 + [9.5, 2.0], 3.0),
    ([3.0] * 3 + [9.5, 2.0], 3.0),  # spikes before warm-up are not divergence
    ([5.0, 4.0, 3.0, 2.0], 0.0),
])
def test_divergence_guard_matches_jax(losses, spike):
    jg, tg = jsup.DivergenceGuard(spike_factor=spike), tsup.DivergenceGuard(spike_factor=spike)
    for i, loss in enumerate(losses):
        assert tg.check(i + 1, loss) == jg.check(i + 1, loss)
    tg.reset()
    jg.reset()
    assert tg.check(1, 100.0) == jg.check(1, 100.0) is None


def test_exit_codes_match_jax():
    for name in ("EXIT_STALLED", "EXIT_DIVERGED", "EXIT_GRACE_EXCEEDED"):
        assert getattr(tsup, name) == getattr(jsup, name)


LORA_ARGS = ["--attn", "flash", "--remat", "dots", "--log-every", "1", "--lora-rank", "4",
             "--lora-alpha", "8", "--lora-mlp"]


@pytest.fixture(scope="module")
def lora_runs(tmp_path_factory):
    """A dense run's checkpoint (1 step), then a LoRA run of 2 steps that
    warm-starts its base from it and commits its own checkpoint."""
    tmp = tmp_path_factory.mktemp("lora-cli")
    dense, lora = str(tmp / "dense"), str(tmp / "lora")
    assert ttrain_cli.main(CLI_MODEL + ["--attn", "flash", "--steps", "1",
                                        "--checkpoint-dir", dense]) == 0
    timeline = str(tmp / "lora.jsonl")
    assert ttrain_cli.main(CLI_MODEL + LORA_ARGS + [
        "--steps", "2", "--init-from", dense, "--checkpoint-dir", lora,
        "--timeline", timeline, "--prefetch", "0"]) == 0
    with open(timeline) as f:
        losses = [json.loads(line)["loss"] for line in f]
    return dict(dense=dense, lora=lora, losses=losses)


def _lora_cfg():
    from hivedscheduler_tpu_torch.models import transformer as ttm

    return ttm.TransformerConfig(vocab_size=96, d_model=64, n_layers=2, n_heads=4,
                                 n_kv_heads=2, d_ff=128, max_seq_len=128,
                                 attn_impl="flash", attn_block_q=64, attn_block_k=64,
                                 remat="dots", lora_rank=4, lora_alpha=8.0, lora_mlp=True)


def test_lora_run_trains_the_adapters_on_the_warm_started_base(lora_runs):
    """The LoRA run's checkpoint holds the dense run's base, unchanged, its
    moved adapters and AdamW state for the adapters alone; its losses are
    make_lora_train_step's on that base and the loader's stream."""
    import dataclasses

    from hivedscheduler_tpu_torch.models import transformer as ttm
    from hivedscheduler_tpu_torch.parallel import checkpoint as tckpt
    from hivedscheduler_tpu_torch.parallel import data as tdata

    cfg = _lora_cfg()
    base_cfg = dataclasses.replace(cfg, lora_rank=0, lora_mlp=False)
    _, dense_init = ttrain.make_train_step(base_cfg, "cpu")
    dense, dense_opt = dense_init(torch.Generator().manual_seed(1))
    tckpt.restore(lora_runs["dense"], dense, dense_opt)
    step, init_fn = ttrain.make_lora_train_step(cfg, "cpu", ce_chunk=64)
    base, lora, opt = init_fn(torch.Generator().manual_seed(7))
    tckpt.restore_params(lora_runs["dense"], base)
    lora0 = {k: v.detach().clone() for k, v in lora["layers"].items()}
    restored, _, _ = tckpt.restore(lora_runs["lora"], ttm.combine_lora_params(base, lora), opt)
    assert restored == 2
    for name, t in tckpt.named_leaves(base).items():
        assert torch.equal(t, tckpt.named_leaves(dense)[name]), name
    assert all(not torch.equal(v, lora0[k]) for k, v in lora["layers"].items())
    assert set(tckpt._opt_state_dict(ttm.combine_lora_params(base, lora), opt)) == {
        f"layers.{k}" for k in lora["layers"]}
    meta = tckpt.read_metadata(lora_runs["lora"])
    assert meta["model"]["lora_rank"] == 4 and meta["model"]["lora_mlp"] is True
    # the same two steps from the dense base and the init's adapters
    base, lora, opt = init_fn(torch.Generator().manual_seed(0))
    tckpt.restore_params(lora_runs["dense"], base)
    loader = tdata.CheckpointableBatches(tdata.synthetic_dataset(96), 2, 128)
    want = []
    for _ in range(2):
        lora, opt, loss = step(base, lora, opt, torch.from_numpy(next(loader)))
        want.append(float(loss))
    assert lora_runs["losses"] == pytest.approx(want, abs=1e-6)


def test_lora_resume_with_another_rank_is_refused(lora_runs):
    args = [a if a != "4" else "2" for a in LORA_ARGS]
    with pytest.raises(ValueError) as err:
        ttrain_cli.main(CLI_MODEL + args + ["--steps", "3", "--checkpoint-dir",
                                            lora_runs["lora"]])
    assert "lora_rank: saved 4 != current 2" in str(err.value)


def test_lora_resume_continues_the_run(lora_runs, tmp_path, step_lines):
    import shutil

    ckpt = str(tmp_path / "lora")
    shutil.copytree(lora_runs["lora"], ckpt)
    assert ttrain_cli.main(CLI_MODEL + LORA_ARGS + ["--steps", "3",
                                                    "--checkpoint-dir", ckpt]) == 0
    assert [a[0] for a in step_lines] == [3]
