"""Held-out evaluation: token-level loss and perplexity.

Counterpart of ``hivedscheduler_tpu/eval.py``, with the same flags, the
same sequential non-overlapping windows (each scores batch x (seq_len - 1)
positions) and the same output line:

    python -m hivedscheduler_tpu_torch.eval --attn flash --data heldout.bin

``--device`` (default ``cuda``) is the one addition; ``--device cpu`` runs
on the CPU. The flash kernel runs under ``--attn flash``; ``--attn`` takes
every ``attn_impl`` and defaults to ``ring`` when ``--sp`` is above 1.
``--checkpoint-dir`` evaluates the parameters of the newest committed
checkpoint of a ``train`` run (random init from seed 0 without it), and
``--goodput-file`` spools the goodput ledger's phases. As in ``train``,
the run opens its process group from the scheduler's gang handoff, lays
the mesh ``infer_axes(world, tp=, sp=, fsdp=, ep=)`` over it, and each rank
reads its data-parallel share of every window (over sp, its slice of the
sequence). A mixture-of-experts model (``--n-experts``, ``--moe-top-k``)
routes with the training capacity (at ``--sp`` above 1 on the whole
sequence's length, as on one device) and its loss leaves out the aux
terms; ``--ep`` shards its experts. At ``--tp`` above 1 a dense model
takes the overlapped collective-matmul layer stack wherever it applies, as
the JAX eval does (it has no flag; ``HIVED_OVERLAP=0`` forces the
reference body).
"""

from __future__ import annotations

import argparse
import logging
import math
import sys
import time

from hivedscheduler_tpu_torch.common import utils as common

log = logging.getLogger(__name__)

# the window loop's timing line: n windows, tokens, seconds, tokens/s
WINDOWS_LOG = "%s windows (%s tokens) in %.2fs (%.0f tok/s)"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="tpu-hive-torch-eval")
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=512)
    parser.add_argument("--vocab-size", type=int, default=32000)
    parser.add_argument("--d-model", type=int, default=512)
    parser.add_argument("--n-layers", type=int, default=8)
    parser.add_argument("--n-heads", type=int, default=8)
    parser.add_argument("--n-kv-heads", type=int, default=0)
    parser.add_argument("--d-ff", type=int, default=1408)
    parser.add_argument("--n-experts", type=int, default=0)
    parser.add_argument("--moe-top-k", type=int, default=1)
    parser.add_argument("--attn", default=None,
                        help="xla|flash|ring|ring_flash|ring_zigzag|"
                        "ring_zigzag_flash|ulysses (default: ring when sp>1, "
                        "else xla)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree")
    parser.add_argument("--sp", type=int, default=1,
                        help="sequence-parallel degree")
    parser.add_argument("--fsdp", type=int, default=1,
                        help="fully-sharded data-parallel degree")
    parser.add_argument("--ep", type=int, default=1,
                        help="expert-parallel degree (with --n-experts)")
    parser.add_argument("--ce-chunk", type=int, default=0,
                        help="chunked cross-entropy (as in train)")
    parser.add_argument("--data", default="",
                        help="packed token file; synthetic corpus when "
                             "omitted (smoke only: perplexity of random "
                             "tokens is ~vocab size)")
    parser.add_argument("--data-dtype", default="uint16",
                        choices=["uint16", "uint32"])
    parser.add_argument("--max-steps", type=int, default=0,
                        help="cap evaluated windows (0 = whole corpus)")
    parser.add_argument("--checkpoint-dir", default="",
                        help="checkpoint to evaluate (random init when "
                             "omitted: smoke only)")
    parser.add_argument("--goodput-file", default="",
                        help="enable the workload goodput ledger and append "
                        "this run's step-phase records to this JSONL spool")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    common.init_all(logging.DEBUG if args.verbose else logging.INFO)
    from hivedscheduler_tpu_torch.parallel import distributed

    gang = distributed.gang_from_env()
    from hivedscheduler_tpu_torch.obs import goodput as obs_goodput

    if args.goodput_file and (gang is None or gang[1] == 0):
        obs_goodput.enable(spool_path=args.goodput_file)

    rank, world = distributed.initialize_from_gang(device=args.device)
    try:
        return _evaluate(parser, args, rank, world)
    finally:
        distributed.shutdown()


def _evaluate(parser: argparse.ArgumentParser, args, rank: int, world: int) -> int:
    if rank:
        logging.getLogger().setLevel(logging.WARNING)  # rank 0 logs
    import numpy as np
    import torch

    from hivedscheduler_tpu_torch import resolve_device
    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.obs import goodput as obs_goodput
    from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt
    from hivedscheduler_tpu_torch.parallel import data as data_lib
    from hivedscheduler_tpu_torch.parallel import topology
    from hivedscheduler_tpu_torch.parallel.train import make_sharded_eval_step

    device = resolve_device(args.device)
    try:
        axes = topology.infer_axes(world, tp=args.tp, sp=args.sp, fsdp=args.fsdp,
                                   ep=args.ep)
    except ValueError as err:
        parser.error(str(err))
    mesh = topology.make_mesh(axes, device.type)
    log.info("rank %s/%s: device %s, mesh %s", rank, world, device, axes)

    cfg = tm.TransformerConfig(
        vocab_size=args.vocab_size,
        d_model=args.d_model,
        n_heads=args.n_heads,
        n_kv_heads=args.n_kv_heads,
        n_layers=args.n_layers,
        d_ff=args.d_ff,
        max_seq_len=args.seq_len,
        attn_impl=args.attn or ("ring" if axes.sp > 1 else "xla"),
        n_experts=args.n_experts,
        moe_top_k=args.moe_top_k,
    )
    eval_step, init_fn, token_sharding = make_sharded_eval_step(
        cfg, mesh, ce_chunk=args.ce_chunk)
    params = init_fn(torch.Generator(device=device).manual_seed(0))
    if args.checkpoint_dir:
        step, params = ckpt.restore_params(args.checkpoint_dir, params)
        log.info("restored params from step %s", step)
    else:
        log.warning("no --checkpoint-dir: evaluating RANDOM init (smoke)")

    if args.data:
        dataset = data_lib.TokenFileDataset(args.data, dtype=args.data_dtype)
    else:
        dataset = data_lib.synthetic_dataset(cfg.vocab_size)
    corpus = dataset.tokens
    window = args.batch * args.seq_len
    n_steps = len(corpus) // window
    if args.max_steps > 0:
        n_steps = min(n_steps, args.max_steps)
    if n_steps == 0:
        log.error("corpus too small: %s tokens < one %s-token batch window",
                  len(corpus), window)
        return 1
    # each rank takes its data-parallel share of every window's rows
    part, n_parts = data_lib.data_split(mesh)
    if args.batch % n_parts:
        log.error("--batch %s must divide the %s data-parallel ranks",
                  args.batch, n_parts)
        return 1
    rows = args.batch // n_parts

    t0 = time.perf_counter()
    obs_goodput.phase("eval")
    # accumulate on the device; one host sync at the end
    total_loss = None
    for i in range(n_steps):
        batch_np = np.asarray(
            corpus[i * window: (i + 1) * window], dtype=np.int32
        ).reshape(args.batch, args.seq_len)[part * rows: (part + 1) * rows]
        tokens = data_lib.device_put_global(batch_np, token_sharding,
                                            args.batch)
        step_loss = eval_step(params, tokens)
        total_loss = step_loss if total_loss is None else total_loss + step_loss
        if args.verbose and (i + 1) % 10 == 0:
            log.info("window %s/%s running loss %.4f", i + 1, n_steps,
                     float(total_loss) / (i + 1))
    # every window scores batch*(seq-1) positions, so the mean of
    # per-window means is the corpus token-level mean over scored targets
    loss = float(total_loss) / n_steps  # waits for the device
    dt = time.perf_counter() - t0
    obs_goodput.phase("idle")
    ppl = math.exp(min(loss, 30.0))
    log.info(WINDOWS_LOG, n_steps, n_steps * window, dt,
             n_steps * window / max(dt, 1e-9))
    if rank == 0:
        print(f"loss {loss:.6f}  perplexity {ppl:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
