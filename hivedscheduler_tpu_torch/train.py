"""Train the flagship transformer on one device.

Counterpart of ``hivedscheduler_tpu/train.py``, with the same flags and
defaults, the same step loop and the same log line:

    python -m hivedscheduler_tpu_torch.train --attn flash --remat dots \
        --ce-chunk 512 --steps 20

``--device`` (default ``cuda``) is the one addition; ``--device cpu`` runs
on the CPU. ``--attn flash`` runs the flash kernels forward and backward;
the optimizer is AdamW. ``--timeline`` writes the same per-step JSONL and
syncs every step. ``--on-nan halt`` exits 44 on divergence and ``skip``
drops the update of a non-finite step. Mesh axes above 1, pipelining, MoE,
LoRA, the overlapped stack, checkpoints and what rides on them (rollback,
warm start, the watchdog, elastic meshes), the profiler, the journal and
the goodput ledger are not yet ported and exit with an error rather than
being ignored.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import sys
import time

from hivedscheduler_tpu_torch.common import utils as common

log = logging.getLogger(__name__)

PORTED_ATTN = ("xla", "flash")
# the step loop's log line: step, loss, tokens/s since the loop started
STEP_LOG = "step %s loss %.4f | %.0f tok/s"


def _reject_unported(parser: argparse.ArgumentParser, args) -> None:
    for flag in ("tp", "sp", "fsdp", "pp", "ep"):
        if getattr(args, flag) > 1:
            parser.error(f"--{flag} > 1 is not yet ported: the port trains on "
                         "one device")
    unported = {
        "--microbatches": args.microbatches > 0,
        "--n-experts > 0 (MoE)": args.n_experts > 0,
        "--lora-rank": args.lora_rank > 0,
        "--lora-mlp": args.lora_mlp,
        "--lora-alpha": args.lora_alpha != 16.0,
        "--overlap": bool(args.overlap),
        "--on-nan rollback": args.on_nan == "rollback",
        "--checkpoint-dir": bool(args.checkpoint_dir),
        "--init-from": bool(args.init_from),
        "--profile-dir": bool(args.profile_dir),
        "--journal-file": bool(args.journal_file),
        "--goodput-file": bool(args.goodput_file),
        "--elastic": args.elastic,
        "--min-chips": args.min_chips > 0,
        "--watchdog-secs > 0": args.watchdog_secs > 0,
    }
    for flag, given in unported.items():
        if given:
            parser.error(f"{flag} is not yet ported")
    if args.attn is not None and args.attn not in PORTED_ATTN:
        parser.error(f"--attn {args.attn} is not yet ported; the port runs "
                     f"{'|'.join(PORTED_ATTN)}")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="tpu-hive-torch-train")
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=512)
    parser.add_argument("--vocab-size", type=int, default=32000)
    parser.add_argument("--d-model", type=int, default=512)
    parser.add_argument("--n-layers", type=int, default=8)
    parser.add_argument("--n-heads", type=int, default=8)
    parser.add_argument("--n-kv-heads", type=int, default=0,
                        help="GQA shared k/v heads (0 = n_heads, 1 = MQA)")
    parser.add_argument("--d-ff", type=int, default=1408)
    parser.add_argument("--tp", type=int, default=1, help="not yet ported above 1")
    parser.add_argument("--sp", type=int, default=1, help="not yet ported above 1")
    parser.add_argument("--fsdp", type=int, default=1, help="not yet ported above 1")
    parser.add_argument("--pp", type=int, default=1, help="not yet ported above 1")
    parser.add_argument("--microbatches", type=int, default=0,
                        help="not yet ported")
    parser.add_argument("--ep", type=int, default=1, help="not yet ported above 1")
    parser.add_argument("--n-experts", type=int, default=0,
                        help="not yet ported above 0")
    parser.add_argument("--moe-top-k", type=int, default=1)
    parser.add_argument("--moe-zloss", type=float, default=0.0)
    parser.add_argument("--moe-aux-weight", type=float, default=0.01)
    parser.add_argument("--expert-capacity-factor", type=float, default=1.25)
    parser.add_argument("--rope-theta", type=float, default=10000.0,
                        help="RoPE base frequency")
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="gradient-accumulation slices per batch "
                        "(batch must divide evenly)")
    parser.add_argument("--lora-rank", type=int, default=0, help="not yet ported")
    parser.add_argument("--lora-mlp", action="store_true", help="not yet ported")
    parser.add_argument("--lora-alpha", type=float, default=16.0,
                        help="not yet ported")
    parser.add_argument("--remat", "--remat-policy", dest="remat",
                        choices=("full", "dots", "none"), default="full",
                        help="layer remat policy: full recomputes whole "
                        "layers, dots saves matmul outputs and recomputes "
                        "the rest, none saves everything")
    parser.add_argument("--overlap", action=argparse.BooleanOptionalAction,
                        default=None, help="not yet ported")
    parser.add_argument("--ce-chunk", type=int, default=0,
                        help="chunked cross-entropy: lm_head+CE in sequence "
                        "chunks of this size (0 = off; must divide --seq-len)")
    parser.add_argument("--block-q", type=int, default=128,
                        help="flash tile by the JAX package's shape rules "
                        "(CPU tensors)")
    parser.add_argument("--block-k", type=int, default=128,
                        help="flash tile by the JAX package's shape rules "
                        "(CPU tensors)")
    parser.add_argument("--attn", default=None, help="xla|flash (default: xla)")
    parser.add_argument("--prefetch", type=int, default=2,
                        help="data-loader prefetch depth (0 disables)")
    parser.add_argument("--data", default="",
                        help="packed token file; synthetic corpus when omitted")
    parser.add_argument("--data-dtype", default="uint16",
                        choices=["uint16", "uint32"])
    parser.add_argument("--init-from", default="", help="not yet ported")
    parser.add_argument("--profile-dir", default="", help="not yet ported")
    parser.add_argument("--journal-file", default="", help="not yet ported")
    parser.add_argument("--goodput-file", default="", help="not yet ported")
    parser.add_argument("--timeline", default="",
                        help="write a per-step JSONL timeline (step, wall_s, "
                        "tokens_per_sec, loss, compile) to this path; syncs "
                        "on the loss every step")
    parser.add_argument("--checkpoint-dir", default="", help="not yet ported")
    parser.add_argument("--checkpoint-every", type=int, default=50,
                        help="with --checkpoint-dir (not yet ported)")
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--data-seed", type=int, default=0,
                        help="data-loader stream seed")
    parser.add_argument("--elastic", action="store_true", help="not yet ported")
    parser.add_argument("--min-chips", type=int, default=0, help="not yet ported")
    parser.add_argument("--grace-secs", type=float, default=30.0,
                        help="preemption grace period (with checkpoints, not "
                        "yet ported)")
    parser.add_argument("--watchdog-secs", type=float, default=0.0,
                        help="not yet ported above 0")
    parser.add_argument("--on-nan", choices=("halt", "rollback", "skip"),
                        default="halt",
                        help="divergence policy for a non-finite loss (or "
                        "spike): halt = exit 44; skip = drop the update and "
                        "continue; rollback is not yet ported")
    parser.add_argument("--loss-spike-factor", type=float, default=0.0,
                        help="also treat loss > FACTOR x its EMA as "
                        "divergence (0 = non-finite only)")
    parser.add_argument("--max-rollbacks", type=int, default=3,
                        help="with --on-nan rollback (not yet ported)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("-v", "--verbose", action="store_true")
    return parser


def main(argv=None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    _reject_unported(parser, args)

    common.init_all(logging.DEBUG if args.verbose else logging.INFO)

    import torch

    from hivedscheduler_tpu_torch import resolve_device
    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.parallel import data as data_lib
    from hivedscheduler_tpu_torch.parallel import supervisor as sup_lib
    from hivedscheduler_tpu_torch.parallel.train import make_train_step

    device = resolve_device(args.device)
    cfg = tm.TransformerConfig(
        vocab_size=args.vocab_size,
        d_model=args.d_model,
        n_heads=args.n_heads,
        n_kv_heads=args.n_kv_heads,
        n_layers=args.n_layers,
        d_ff=args.d_ff,
        max_seq_len=args.seq_len,
        attn_impl=args.attn or "xla",
        n_experts=args.n_experts,
        moe_top_k=args.moe_top_k,
        moe_aux_weight=args.moe_aux_weight,
        moe_zloss_weight=args.moe_zloss,
        expert_capacity_factor=args.expert_capacity_factor,
        rope_theta=args.rope_theta,
        remat=args.remat,
        attn_block_q=args.block_q,
        attn_block_k=args.block_k,
    )
    log.info("device %s, config %s", device, cfg)
    step_fn, init_fn = make_train_step(
        cfg, device, grad_accum=args.grad_accum, ce_chunk=args.ce_chunk,
        skip_nonfinite=args.on_nan == "skip")
    params, opt_state = init_fn(torch.Generator(device=device).manual_seed(0))

    if args.data:
        dataset = data_lib.TokenFileDataset(args.data, dtype=args.data_dtype)
        peak = int(dataset.tokens[: 1 << 16].max())
        if peak >= cfg.vocab_size:
            raise SystemExit(
                f"--data contains token id {peak} >= vocab size "
                f"{cfg.vocab_size}; wrong --data-dtype or --vocab-size?"
            )
    else:
        dataset = data_lib.synthetic_dataset(cfg.vocab_size)
    loader = data_lib.CheckpointableBatches(dataset, args.batch, args.seq_len,
                                            seed=args.data_seed)
    guard = sup_lib.DivergenceGuard(spike_factor=args.loss_spike_factor)

    tokens_per_step = args.batch * args.seq_len
    timeline = open(args.timeline, "w") if args.timeline else None
    batches = data_lib.prefetch(loader, depth=args.prefetch)
    diverged = None
    step = 0
    t0 = time.perf_counter()
    try:
        while step < args.steps:
            step_t0 = time.perf_counter()
            tokens = torch.from_numpy(next(batches)).to(device, non_blocking=True)
            params, opt_state, loss = step_fn(params, opt_state, tokens)
            loss_f = float(loss)  # waits for the device: per-step times are true
            if timeline is not None:
                wall = time.perf_counter() - step_t0
                timeline.write(json.dumps({
                    "step": step + 1,
                    "wall_s": round(wall, 6),
                    "tokens_per_sec": round(tokens_per_step / max(wall, 1e-9), 1),
                    "loss": loss_f,
                    "compile": step == 0,
                }) + "\n")
                timeline.flush()
            if args.on_nan == "skip":
                if not math.isfinite(loss_f):
                    log.warning("non-finite loss at step %s: update skipped",
                                step + 1)
            else:
                diverged = guard.check(step + 1, loss_f)
                if diverged is not None:
                    break
            step += 1
            if step % args.log_every == 0:
                dt = time.perf_counter() - t0
                log.info(STEP_LOG, step, loss_f,
                         step * tokens_per_step / max(dt, 1e-9))
    finally:
        batches.close()
        if timeline is not None:
            timeline.close()
            log.info("step timeline written to %s", args.timeline)
    if diverged is not None:
        log.error("divergence: %s; halting (exit %s)", diverged,
                  sup_lib.EXIT_DIVERGED)
        return sup_lib.EXIT_DIVERGED
    log.info("training complete: %s steps", args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
