"""Train the flagship transformer, on one GPU or a gang of them.

Counterpart of ``hivedscheduler_tpu/train.py``, with the same flags and
defaults, the same step loop and the same log line:

    python -m hivedscheduler_tpu_torch.train --attn flash --remat dots \
        --ce-chunk 512 --steps 20

``--device`` (default ``cuda``) is the one addition; ``--device cpu`` runs
on the CPU. ``--attn flash`` runs the flash kernels forward and backward;
the optimizer is AdamW. ``--attn`` takes every ``attn_impl`` of the JAX
package and defaults to ``ring`` when ``--sp`` is above 1, ``xla``
otherwise; the ring family runs on the mesh (at ``--sp 1`` a ring of one
hop). ``--timeline`` writes the same per-step JSONL and
syncs every step.

One process drives one GPU. Step 1 opens the process group from the
scheduler's gang handoff (``POD_BIND_INFO``, ``NODE_NAME``,
``NVIDIA_VISIBLE_DEVICES`` and ``LOCAL_RANK``; a one-rank group when the
run was not placed by the scheduler), NCCL on ``cuda`` and gloo on
``cpu``; step 2 lays the mesh ``infer_axes(world, tp=, sp=, fsdp=, pp=,
ep=)`` over it, dp taking the rest. ``--tp`` and ``--fsdp`` shard the
model (Megatron tensor parallelism, ZeRO-3), ``--sp`` the sequence (each
rank attends its slice over the ring family), ``--ep`` the experts of a
mixture-of-experts model (``--n-experts``, ``--moe-top-k``,
``--expert-capacity-factor``, ``--moe-aux-weight``, ``--moe-zloss``; at
``--sp`` above 1 the routing keeps global capacity), ``--pp`` the layers
into GPipe stages of ``--microbatches`` microbatches
(``parallel/pipeline.py``); tokens/s is over the global batch. Rank 0
alone writes the logs, the timeline and the goodput spool; every rank
takes part in each checkpoint save.

Preemptible training, as in the JAX CLI: with ``--checkpoint-dir`` the run
commits a checkpoint every ``--checkpoint-every`` steps and at its end, and
a new incarnation resumes from the newest committed step (parameters,
AdamW state and the data loader's position), reproducing the
uninterrupted run. SIGTERM/SIGINT checkpoint at the next step boundary and
exit 0 within ``--grace-secs``; ``--watchdog-secs`` exits 43 on a hung
step; ``--on-nan halt`` exits 44 on divergence, ``skip`` drops the update
of a non-finite step and ``rollback`` restores the newest committed step
and skips the poisoned batch (``--max-rollbacks`` times at most).
``--init-from`` warm-starts the parameters with a fresh optimizer;
``--goodput-file`` spools the goodput ledger's step phases.

Observability, as in the JAX CLI: ``--journal-file`` spools the event
journal (``train_resume`` with the step and whether the mesh changed,
``train_rollback``); a resume counts ``tpu_hive_train_resumes_total`` (and
``tpu_hive_train_cross_topology_resumes_total`` across meshes); with
``--timeline`` each step is also a ``train/step`` span of ``obs.trace``.
``--profile-dir`` records steps 2-4 of the incarnation with
``torch.profiler`` (CUDA activity on the card, where a trace without a
kernel event is an error), each step a ``train/step N`` range, written by
``tensorboard_trace_handler`` as ``rank<r>.<ns>.pt.trace.json``, one file a
rank, for TensorBoard or Perfetto. Rank 0 alone spools the journal; every
rank writes its own trace.

LoRA fine-tuning, as in the JAX CLI: ``--lora-rank`` trains rank-r
adapters on the attention projections (``--lora-mlp`` adds the MLP's,
``--lora-alpha`` scales them) with the base frozen and AdamW over the
adapters alone; ``--init-from`` then loads the pretrained base they
tune. Checkpoints hold the base and the adapters, and the adapters'
optimizer state; ``generate`` and ``serve`` merge them with the same
``--lora-*`` flags.

Elastic meshes, as in the JAX CLI: with ``--elastic`` the requested
``--tp/--sp/--fsdp/--ep`` are preferences, and the mesh is
``topology.elastic_axes`` for the slice the scheduler offered, the gang's
world size (the GPUs the bind annotation granted), with a warning when it
differs from the request; a checkpoint saved on one mesh restores onto the
derived one. ``--min-chips`` is the job's floor: an offer below it exits
nonzero on every rank before any weight is built. The checkpoint metadata
records the floor and the request (``elastic``).

The overlapped stack (``--overlap``) is not yet ported and exits with an
error rather than being ignored.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import math
import sys
import time

from hivedscheduler_tpu_torch.common import utils as common

log = logging.getLogger(__name__)

# the step loop's log line: step, loss, tokens/s since the loop started
STEP_LOG = "step %s loss %.4f | %.0f tok/s"
# --profile-dir records the steps of an incarnation from this index (0 is
# the first step, which builds and warms up and would drown the trace) to
# the one before the stop index: steps 2-4
PROFILE_START, PROFILE_STOP = 1, 4


def _reject_unported(parser: argparse.ArgumentParser, args) -> None:
    if args.overlap:
        parser.error("--overlap is not yet ported")


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
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel degree (heads and the MLP "
                        "hidden dim; must divide the head counts)")
    parser.add_argument("--sp", type=int, default=1,
                        help="sequence-parallel degree (the ring family "
                        "attends across it; must divide --seq-len)")
    parser.add_argument("--fsdp", type=int, default=1,
                        help="fully-sharded data-parallel degree (ZeRO-3)")
    parser.add_argument("--pp", type=int, default=1,
                        help="pipeline stages (requires --microbatches)")
    parser.add_argument("--microbatches", type=int, default=0,
                        help="GPipe microbatches; required when --pp > 1")
    parser.add_argument("--ep", type=int, default=1,
                        help="expert-parallel degree (with --n-experts; must "
                        "divide it)")
    parser.add_argument("--n-experts", type=int, default=0,
                        help="experts per MoE layer (0 = dense MLP)")
    parser.add_argument("--moe-top-k", type=int, default=1)
    parser.add_argument("--moe-zloss", type=float, default=0.0)
    parser.add_argument("--moe-aux-weight", type=float, default=0.01)
    parser.add_argument("--expert-capacity-factor", type=float, default=1.25)
    parser.add_argument("--rope-theta", type=float, default=10000.0,
                        help="RoPE base frequency")
    parser.add_argument("--grad-accum", type=int, default=1,
                        help="gradient-accumulation slices per batch "
                        "(batch must divide evenly)")
    parser.add_argument("--lora-rank", type=int, default=0,
                        help="LoRA fine-tuning: adapter rank on the attention "
                        "projections (0 = full training)")
    parser.add_argument("--lora-mlp", action="store_true",
                        help="extend the LoRA adapters to the dense-MLP "
                        "projections (gate/up/down)")
    parser.add_argument("--lora-alpha", type=float, default=16.0,
                        help="LoRA scale (delta = alpha/rank * A B)")
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
    parser.add_argument("--attn", default=None,
                        help="xla|flash|ring|ring_flash|ring_zigzag|"
                        "ring_zigzag_flash|ulysses (default: ring when sp>1, "
                        "else xla)")
    parser.add_argument("--prefetch", type=int, default=2,
                        help="data-loader prefetch depth (0 disables)")
    parser.add_argument("--data", default="",
                        help="packed token file; synthetic corpus when omitted")
    parser.add_argument("--data-dtype", default="uint16",
                        choices=["uint16", "uint32"])
    parser.add_argument("--init-from", default="",
                        help="warm-start params from another run's "
                        "checkpoint (fresh optimizer). With --lora-rank this "
                        "is the pretrained base the adapters fine-tune")
    parser.add_argument("--profile-dir", default="",
                        help="capture a torch.profiler trace (TensorBoard/"
                        "Perfetto format) of steps 2..4 into this directory, "
                        "one file a rank; step 1 builds and warms up and "
                        "would drown the trace")
    parser.add_argument("--journal-file", default="",
                        help="enable the event journal and append this "
                        "incarnation's resume/rollback events to this JSONL "
                        "spool (rank 0)")
    parser.add_argument("--goodput-file", default="",
                        help="enable the workload goodput ledger and append "
                        "this incarnation's step-phase records to this JSONL "
                        "spool; sharing one spool across a gang's "
                        "incarnations makes rework classification exact "
                        "across kills")
    parser.add_argument("--timeline", default="",
                        help="write a per-step JSONL timeline (step, wall_s, "
                        "tokens_per_sec, loss, compile) to this path; syncs "
                        "on the loss every step")
    parser.add_argument("--checkpoint-dir", default="",
                        help="commit checkpoints here and resume from the "
                        "newest committed one")
    parser.add_argument("--checkpoint-every", type=int, default=50)
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--data-seed", type=int, default=0,
                        help="data-loader stream seed (the loader's state "
                        "joins every checkpoint, so a resumed run continues "
                        "the uninterrupted stream)")
    parser.add_argument("--elastic", action="store_true",
                        help="elastic mesh mode: treat --tp/--sp/--fsdp/"
                        "--pp/--ep as PREFERENCES and derive a valid mesh "
                        "for whatever slice the scheduler actually offered "
                        "(the device count the bind annotation granted) "
                        "instead of asserting the requested shape. A "
                        "checkpoint saved on one mesh restores onto the "
                        "derived one (cross-topology resume; "
                        "doc/design/elastic.md)")
    parser.add_argument("--min-chips", type=int, default=0,
                        help="with --elastic: the smallest slice this job "
                        "accepts; an offer below it exits nonzero instead "
                        "of training degenerately (recorded in the "
                        "checkpoint metadata as the job's shape ladder "
                        "floor)")
    parser.add_argument("--grace-secs", type=float, default=30.0,
                        help="preemption grace period: SIGTERM/SIGINT "
                        "request checkpoint-and-exit at the next step "
                        "boundary; a shutdown still wedged after this many "
                        "seconds is force-exited (exit 45)")
    parser.add_argument("--watchdog-secs", type=float, default=0.0,
                        help="per-step hang deadline (0 = off): a step "
                        "exceeding it records hived_stall.json in the "
                        "checkpoint dir and exits 43 (the first step gets "
                        "10x: it includes the kernels' build when cold)")
    parser.add_argument("--on-nan", choices=("halt", "rollback", "skip"),
                        default="halt",
                        help="divergence policy for a non-finite loss (or "
                        "spike): halt = exit 44 with the last committed "
                        "checkpoint intact; rollback = restore the newest "
                        "committed checkpoint and skip past the poisoned "
                        "batch; skip = drop the update and continue")
    parser.add_argument("--loss-spike-factor", type=float, default=0.0,
                        help="also treat loss > FACTOR x its EMA as "
                        "divergence (0 = non-finite only)")
    parser.add_argument("--max-rollbacks", type=int, default=3,
                        help="divergence rollback budget before halting "
                        "(--on-nan rollback)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("-v", "--verbose", action="store_true")
    return parser


def main(argv=None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.pp > 1 and args.microbatches <= 0:
        parser.error("--pp > 1 requires --microbatches")
    if args.microbatches > 0 and args.pp <= 1:
        parser.error("--microbatches requires --pp > 1")
    _reject_unported(parser, args)
    if args.on_nan == "skip" and args.lora_rank > 0:
        parser.error("--on-nan skip gates the full train step; with "
                     "--lora-rank use rollback or halt")
    if args.lora_mlp and args.lora_rank <= 0:
        parser.error("--lora-mlp requires --lora-rank > 0")
    if args.lora_mlp and args.n_experts > 0:
        parser.error("--lora-mlp adapts the dense MLP only (MoE experts are "
                     "not adapted)")
    if args.min_chips and not args.elastic:
        parser.error("--min-chips requires --elastic")

    common.init_all(logging.DEBUG if args.verbose else logging.INFO)
    from hivedscheduler_tpu_torch.parallel import distributed

    # the rank, read from the gang handoff before any process group, so
    # that only rank 0 spools the journal and goodput
    gang = distributed.gang_from_env()
    # the elastic floor: the offered slice is the gang's world size (the
    # GPUs the bind annotation granted; one for an unscheduled run). Every
    # rank reads the same annotation, so every rank exits here, before a
    # process group or a weight exists
    offered = 1 if gang is None else gang[2]
    if args.elastic and args.min_chips and offered < args.min_chips:
        raise SystemExit(
            f"elastic job floor not met: offered {offered} chip(s), "
            f"--min-chips {args.min_chips}")
    if args.journal_file and (gang is None or gang[1] == 0):
        from hivedscheduler_tpu_torch.obs import journal as obs_journal

        obs_journal.enable(spool_path=args.journal_file)
    # goodput ledger: anchors the process wallclock here (phase `init`),
    # BEFORE the torch import, so bring-up is attributed, not leaked
    from hivedscheduler_tpu_torch.obs import goodput as obs_goodput

    if args.goodput_file and (gang is None or gang[1] == 0):
        obs_goodput.enable(spool_path=args.goodput_file)

    # 1. the process group from the scheduler's gang handoff (one rank when
    #    the run was not placed by the scheduler)
    rank, world = distributed.initialize_from_gang(device=args.device)
    try:
        return _train(parser, args, rank, world)
    finally:
        distributed.shutdown()


def start_profile(profile_dir: str, rank: int, device):
    """A running ``torch.profiler`` over CPU and, on the card, CUDA
    activity; on stop it writes this rank's trace into ``profile_dir``
    through ``tensorboard_trace_handler``."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(
                       profile_dir, worker_name=f"rank{rank}"))
    prof.start()
    return prof


def kernel_events(prof) -> int:
    """The CUDA kernel events of a stopped profiler (copies and memsets
    left out)."""
    from torch.autograd import DeviceType

    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and not e.name().startswith(("Memcpy", "Memset")))


def stop_profile(prof, device) -> None:
    """Wait for the device, stop the profiler (which writes the trace)
    and, on the card, require kernel events in it: CUPTI can drop the CUDA
    activity with no more than a warning."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    if device.type == "cuda" and kernel_events(prof) == 0:
        raise RuntimeError("the profiler trace holds no CUDA kernel event: the "
                           "CUDA activity was not recorded")


def _step_range(prof, step: int):
    """The ``train/step N`` range of a profiled step; nothing otherwise."""
    if prof is None:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(f"train/step {step}")


def _train(parser: argparse.ArgumentParser, args, rank: int, world: int) -> int:
    if rank:
        logging.getLogger().setLevel(logging.WARNING)  # rank 0 logs
    import torch

    from hivedscheduler_tpu_torch import resolve_device
    from hivedscheduler_tpu_torch.models import transformer as tm
    from hivedscheduler_tpu_torch.obs import goodput as obs_goodput
    from hivedscheduler_tpu_torch.obs import journal as obs_journal
    from hivedscheduler_tpu_torch.obs import trace as obs_trace
    from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt
    from hivedscheduler_tpu_torch.parallel import data as data_lib
    from hivedscheduler_tpu_torch.parallel import distributed
    from hivedscheduler_tpu_torch.parallel import supervisor as sup_lib
    from hivedscheduler_tpu_torch.parallel import topology
    from hivedscheduler_tpu_torch.parallel.train import (
        make_sharded_lora_train_step,
        make_sharded_train_step,
    )
    from hivedscheduler_tpu_torch.runtime.metrics import REGISTRY as metrics

    device = resolve_device(args.device)
    # 2. the mesh over the gang's GPUs; dp takes what tp, sp, fsdp and ep
    #    leave. Elastic mode derives a valid mesh for the offered slice
    #    instead of asserting the requested shape
    try:
        if args.elastic:
            axes = topology.elastic_axes(
                world, tp=args.tp, sp=args.sp, fsdp=args.fsdp, pp=args.pp,
                ep=args.ep, n_heads=args.n_heads,
                n_kv_heads=args.n_kv_heads or args.n_heads,
                global_batch=args.batch, seq_len=args.seq_len)
            requested = (args.tp, args.sp, args.fsdp, args.pp, args.ep)
            if (axes.tp, axes.sp, axes.fsdp, axes.pp, axes.ep) != requested:
                log.warning(
                    "elastic: requested (tp, sp, fsdp, pp, ep)=%s does not fit "
                    "the offered %d-chip slice; derived mesh %s", requested,
                    world, axes)
        else:
            axes = topology.infer_axes(world, tp=args.tp, sp=args.sp,
                                       fsdp=args.fsdp, pp=args.pp, ep=args.ep)
    except ValueError as err:
        parser.error(str(err))
    mesh = topology.make_mesh(axes, device.type)
    data_index, data_count = data_lib.data_split(mesh)
    log.info("rank %s/%s: mesh %s, data rows %s of %s", rank, world, axes,
             data_index, data_count)
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
        moe_aux_weight=args.moe_aux_weight,
        moe_zloss_weight=args.moe_zloss,
        expert_capacity_factor=args.expert_capacity_factor,
        rope_theta=args.rope_theta,
        remat=args.remat,
        attn_block_q=args.block_q,
        attn_block_k=args.block_k,
        lora_rank=args.lora_rank,
        lora_alpha=args.lora_alpha,
        lora_mlp=args.lora_mlp,
        # elastic mode may have shrunk pp away: pipelining follows the
        # derived mesh
        pipeline_microbatches=args.microbatches if axes.pp > 1 else 0,
    )
    log.info("device %s, config %s", device, cfg)
    # the step updates these tensors and this optimizer in place; restores
    # load into them too, so the optimizer's references stay valid
    generator = torch.Generator(device=device).manual_seed(0)
    lora_mode = args.lora_rank > 0
    if lora_mode:
        lora_step, init_fn, token_sharding = make_sharded_lora_train_step(
            cfg, mesh, grad_accum=args.grad_accum, ce_chunk=args.ce_chunk)
        base_params, lora_params, opt_state = init_fn(generator)
        # the whole tree (the same tensors): what checkpoints hold
        params = tm.combine_lora_params(base_params, lora_params)

        def step_fn(params, opt_state, tokens):
            _, opt_state, loss = lora_step(base_params, lora_params, opt_state, tokens)
            return params, opt_state, loss
    else:
        step_fn, init_fn, token_sharding = make_sharded_train_step(
            cfg, mesh, grad_accum=args.grad_accum, ce_chunk=args.ce_chunk,
            skip_nonfinite=args.on_nan == "skip")
        params, opt_state = init_fn(generator)

    # warm start: params only, the optimizer stays fresh; for LoRA the
    # frozen pretrained base the adapters tune
    if args.init_from:
        ckpt.restore_params(args.init_from, base_params if lora_mode else params)
        log.info("warm-started params from %s", args.init_from)

    def restore_state():
        """Restore the newest committed checkpoint into the live state;
        returns (step, the marker's metadata). The restore loads in place,
        so the base and adapter trees of a LoRA run, which hold the same
        tensors, see it too."""
        step_no, _, _ = ckpt.restore(args.checkpoint_dir, params, opt_state)
        return step_no, ckpt.read_metadata(args.checkpoint_dir, step_no)

    # resume if this gang incarnation has a previous checkpoint
    start_step = 0
    resume_meta: dict = {}
    if args.checkpoint_dir:
        last = ckpt.latest_step(args.checkpoint_dir)
        if last is not None:
            source_mesh = ckpt.validate_resume_metadata(
                ckpt.read_metadata(args.checkpoint_dir, last), axes, cfg,
                global_batch=args.batch, seq_len=args.seq_len,
            )
            if source_mesh is not None:
                # the templates carry this run's layout: DCP reshards
                log.warning(
                    "cross-topology resume: the checkpoint was saved on mesh "
                    "%s, restoring onto %s", source_mesh,
                    {n: s for n, s in zip(axes.names, axes.shape)})
            start_step, resume_meta = restore_state()
            metrics.inc("tpu_hive_train_resumes_total")
            if obs_journal.JOURNAL.enabled:
                obs_journal.emit("train_resume", "train", step=start_step,
                                 crossTopology=source_mesh is not None)
            if source_mesh is not None:
                metrics.inc("tpu_hive_train_cross_topology_resumes_total")
            log.info("resumed from checkpoint step %s", start_step)

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

    def make_loader(loader_dict, fast_forward_to):
        """The checkpointable batch stream: restored from checkpoint
        metadata when present, else fresh (fast-forwarded for a checkpoint
        whose marker carries no loader state)."""
        if loader_dict:
            return data_lib.CheckpointableBatches.from_dict(
                loader_dict, dataset, args.batch, args.seq_len,
                process_index=data_index, process_count=data_count)
        loader = data_lib.CheckpointableBatches(
            dataset, args.batch, args.seq_len, process_index=data_index,
            process_count=data_count, seed=args.data_seed)
        if fast_forward_to:
            loader.skip(fast_forward_to)
        return loader

    # data positions the divergence guard decided to skip (rollback policy)
    skip_positions: set = set()

    def stream(loader):
        """Yield (host_batch, loader_state_snapshot): the snapshot rides
        along so checkpoints commit the loader position of the NEXT
        unconsumed batch even while prefetch reads ahead."""
        while True:
            while loader.step in skip_positions:
                log.warning("skipping poisoned data position %s", loader.step)
                loader.skip(1)
            batch = next(loader)
            yield batch, loader.to_dict()

    sup = sup_lib.Supervisor(
        grace_secs=args.grace_secs, watchdog_secs=args.watchdog_secs,
        spike_factor=args.loss_spike_factor,
        max_rollbacks=args.max_rollbacks, record_dir=args.checkpoint_dir,
    )
    loader = make_loader(resume_meta.get("loader"), start_step)
    loader_snap = loader.to_dict()
    # the commit-marker sidecar: loader state of record + the resume
    # identity (source mesh, model geometry, data stream, shape ladder)
    elastic_meta = None
    if args.elastic:
        elastic_meta = {
            "min_chips": args.min_chips,
            "requested": {"tp": args.tp, "sp": args.sp, "fsdp": args.fsdp,
                          "pp": args.pp, "ep": args.ep},
        }
    train_meta = ckpt.train_metadata(axes, cfg, global_batch=args.batch,
                                     seq_len=args.seq_len, elastic=elastic_meta)

    def save_checkpoint(step_no):
        if not args.checkpoint_dir:
            return
        if ckpt.latest_step(args.checkpoint_dir) == step_no:
            return  # already committed (e.g. preempted right after a save)
        ckpt.save(args.checkpoint_dir, step_no, params, opt_state,
                  extra={"loader": loader_snap, **train_meta})

    tokens_per_step = args.batch * args.seq_len
    timeline = open(args.timeline, "w") if args.timeline and rank == 0 else None
    if args.profile_dir and args.steps - start_step < PROFILE_START + 1:
        log.warning(
            "--profile-dir needs at least 2 steps to trace (step 1 is "
            "compile); %s step(s) will run — no trace will be written",
            args.steps - start_step)
    prof = None
    preempted = False
    diverged = None
    step = start_step
    t0 = time.perf_counter()

    with sup:
        # no stop event: the ranks decide preemption together at the top
        # of each step, so every rank runs the step it agreed to
        batches = data_lib.prefetch(stream(loader), depth=args.prefetch)
        try:
            while step < args.steps:
                if distributed.any_rank(sup.preempt_requested, device):
                    preempted = True
                    break
                sup.heartbeat(step)
                # chaos hooks (inert unless HIVED_FAULT_* env vars arm them)
                sup.faults.pace()
                sup.faults.maybe_hang(step + 1)
                # a LoRA run poisons its adapters, the leaves it trains
                sup.faults.take_nan(step + 1, lora_params if lora_mode else params)
                if args.profile_dir:
                    rel = step - start_step
                    if rel == PROFILE_START and prof is None:
                        prof = start_profile(args.profile_dir, rank, device)
                        log.info("profiler trace started -> %s", args.profile_dir)
                    elif rel == PROFILE_STOP and prof is not None:
                        stop_profile(prof, device)
                        prof = None
                        log.info("profiler trace written to %s", args.profile_dir)
                step_t0 = time.perf_counter()
                with _step_range(prof, step + 1):
                    obs_goodput.phase("data_wait")
                    local_batch, snap = next(batches)
                    # compile / rework / step_compute, decided against the
                    # step high-water mark (rework = re-doing steps a kill
                    # threw away)
                    obs_goodput.note_step(step + 1, is_compile=step == start_step)
                    tokens = data_lib.device_put_global(local_batch, token_sharding,
                                                        args.batch)
                    params, opt_state, loss = step_fn(params, opt_state, tokens)
                    # waits for the device: per-step times are true, the
                    # watchdog sees completed work and the guard sees the
                    # loss before the next checkpoint can commit it
                    loss_f = float(loss)
                    obs_goodput.note_step_done(step + 1)
                loader_snap = snap
                if timeline is not None:
                    wall = time.perf_counter() - step_t0
                    timeline.write(json.dumps({
                        "step": step + 1,
                        "wall_s": round(wall, 6),
                        "tokens_per_sec": round(tokens_per_step / max(wall, 1e-9), 1),
                        "loss": loss_f,
                        "compile": step == start_step,
                    }) + "\n")
                    timeline.flush()
                    obs_trace.complete("train/step", step_t0, time.perf_counter(),
                                       cat="train", step=step + 1,
                                       compile=step == start_step)
                if args.on_nan == "skip":
                    if not math.isfinite(loss_f):
                        log.warning("non-finite loss at step %s: update skipped",
                                    step + 1)
                else:
                    reason = sup.check_loss(step + 1, loss_f)
                    if reason is not None:
                        can_roll = (
                            args.on_nan == "rollback" and args.checkpoint_dir
                            and ckpt.latest_step(args.checkpoint_dir) is not None
                        )
                        if can_roll and sup.note_rollback():
                            bad_pos = snap["step"] - 1
                            skip_positions.add(bad_pos)
                            batches.close()
                            step, meta = restore_state()
                            loader = make_loader(meta.get("loader"), step)
                            loader_snap = loader.to_dict()
                            batches = data_lib.prefetch(stream(loader),
                                                        depth=args.prefetch)
                            log.warning(
                                "divergence (%s): rolled back to checkpoint "
                                "step %s; data position %s will be skipped",
                                reason, step, bad_pos)
                            continue
                        diverged = reason
                        break
                step += 1
                if step % args.log_every == 0:
                    dt = time.perf_counter() - t0
                    log.info(STEP_LOG, step, loss_f,
                             (step - start_step) * tokens_per_step / max(dt, 1e-9))
                if args.checkpoint_dir and step % args.checkpoint_every == 0:
                    save_checkpoint(step)
            if prof is not None:
                # fewer than 4 steps ran after the trace started
                stop_profile(prof, device)
                log.info("profiler trace written to %s", args.profile_dir)
        finally:
            batches.close()
            if timeline is not None:
                timeline.close()
                log.info("step timeline written to %s", args.timeline)
        obs_goodput.phase("idle")  # loop done; the final save spans itself
        if diverged is not None:
            log.error("divergence: %s; halting with the last committed "
                      "checkpoint intact (exit %s)", diverged,
                      sup_lib.EXIT_DIVERGED)
            return sup_lib.EXIT_DIVERGED
        save_checkpoint(step)
        if preempted:
            log.info("preemption: committed checkpoint at step %s and exiting "
                     "cleanly within the %.1fs grace period", step,
                     args.grace_secs)
            return 0
    log.info("training complete: %s steps", args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
