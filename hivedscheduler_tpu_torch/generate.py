"""Generation CLI: KV-cache autoregressive decoding on one device or a
serving mesh.

Counterpart of ``hivedscheduler_tpu/generate.py``, with its flags and
defaults and the same output, one line of space-separated token ids per
sequence:

    python -m hivedscheduler_tpu_torch.generate --new-tokens 32 ...

``--device`` (default ``cuda``) is the one addition; ``--device cpu`` runs
on the CPU. ``--checkpoint-dir`` restores the parameters of the newest
committed checkpoint of a ``train`` run; without it random weights from
``--seed`` demo the decode path. ``--quantize int8`` serves int8 weights,
``--draft-layers`` decodes speculatively with a random draft model.
``--lora-rank`` (with the run's ``--lora-alpha`` and ``--lora-mlp``)
restores a LoRA fine-tune's checkpoint and merges its adapters into the
base weights before decoding (and before ``--quantize int8``).
A mixture-of-experts model (``--n-experts``, ``--moe-top-k``) decodes
with the no-drop inference capacity.

``--tp``/``--dp`` above 1, or a process the scheduler placed in a gang
(its handoff in the environment, as ``train`` reads it), decode on a
``("dp", "tp")`` serving mesh, one process a GPU: the process group comes
from the gang handoff and its ranks must be exactly dp x tp (one process
asked for ``--tp 2`` is a usage error). Every rank builds the same
weights and prompts from the seed, keeps its local leaves
(``decode.make_sharded_generate``, or ``speculative.
make_sharded_speculative`` with ``--draft-layers``; LoRA merged and int8
quantized before the layout) and its dp block of rows; rank 0 alone prints
the rows.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

from hivedscheduler_tpu_torch.common import utils as common

log = logging.getLogger(__name__)

# the decode's timing line: rows, new tokens, seconds, generated tokens/s
DECODE_LOG = "generated %s x %s tokens in %.3fs (%.1f tok/s)"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="tpu-hive-torch-generate")
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--prompt-len", type=int, default=8,
                        help="random prompt length (demo input)")
    parser.add_argument("--new-tokens", type=int, default=32)
    parser.add_argument("--temperature", type=float, default=0.0,
                        help="0 = greedy")
    parser.add_argument("--top-k", type=int, default=0,
                        help="sample only from the k most likely tokens (0 = off)")
    parser.add_argument("--top-p", type=float, default=1.0,
                        help="nucleus sampling: smallest prefix with cumulative "
                        "probability >= p (1.0 = off)")
    parser.add_argument("--decode-steps", type=int, default=1,
                        help="token steps per decode window (>= 1; output "
                        "identical for any value). Each token step is one "
                        "eager call here, so it has no effect until a "
                        "CUDA-graph decode window exists. Ignored by the "
                        "speculative path (--draft-layers)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--expert-capacity-factor", type=float, default=1.25,
                        help="MoE expert capacity factor (must match the "
                        "checkpoint's training value)")
    parser.add_argument("--rope-theta", type=float, default=10000.0,
                        help="RoPE base frequency (must match the "
                        "checkpoint's training value)")
    parser.add_argument("--vocab-size", type=int, default=32000)
    parser.add_argument("--d-model", type=int, default=512)
    parser.add_argument("--n-layers", type=int, default=8)
    parser.add_argument("--n-heads", type=int, default=8)
    parser.add_argument("--n-kv-heads", type=int, default=0,
                        help="GQA shared k/v heads (compact cache)")
    parser.add_argument("--d-ff", type=int, default=1408)
    parser.add_argument("--n-experts", type=int, default=0)
    parser.add_argument("--moe-top-k", type=int, default=1)
    parser.add_argument("--checkpoint-dir", default="",
                        help="restore params from a training checkpoint")
    parser.add_argument("--lora-rank", type=int, default=0,
                        help="the checkpoint is a LoRA run of this rank: "
                        "its adapters merge into the base at load")
    parser.add_argument("--lora-alpha", type=float, default=16.0)
    parser.add_argument("--lora-mlp", action="store_true",
                        help="the checkpoint's adapters also cover the "
                             "dense-MLP projections")
    parser.add_argument("--quantize", choices=["none", "int8"], default="none",
                        help="weight-only int8 post-training quantization "
                        "(matmuls stay in the model dtype)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel serving over a tp mesh axis")
    parser.add_argument("--dp", type=int, default=1,
                        help="batch-parallel serving over a dp mesh axis")
    parser.add_argument("--draft-layers", type=int, default=0,
                        help="speculative decoding: layers of the draft model "
                        "(0 = off; demo uses random draft weights)")
    parser.add_argument("--draft-d-model", type=int, default=0,
                        help="draft width (default: half the target)")
    parser.add_argument("--gamma", type=int, default=4,
                        help="draft tokens proposed per verification round")
    parser.add_argument("--goodput-file", default="",
                        help="enable the workload goodput ledger and append "
                        "this run's step-phase records to this JSONL spool")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)

    common.init_all(logging.DEBUG if args.verbose else logging.INFO)
    if args.tp < 1 or args.dp < 1:
        log.error("--dp/--tp must be >= 1, got dp=%s tp=%s", args.dp, args.tp)
        return 1
    from hivedscheduler_tpu_torch.parallel import distributed

    # a mesh when one is asked for or the scheduler placed this process in
    # a gang (a gang of one GPU gives the world-1 mesh)
    sharded = args.tp > 1 or args.dp > 1 or distributed.gang_from_env() is not None
    if sharded and args.batch % args.dp:
        log.error("--batch %s must be divisible by --dp %s", args.batch, args.dp)
        return 1
    from hivedscheduler_tpu_torch.obs import goodput as obs_goodput

    if args.goodput_file:
        obs_goodput.enable(spool_path=args.goodput_file)
    if not sharded:
        return _generate(args, None, 0)
    from hivedscheduler_tpu_torch import resolve_device
    from hivedscheduler_tpu_torch.parallel import topology

    # the serving mesh over the gang's GPUs: one process a GPU
    rank, world = distributed.initialize_from_gang(device=args.device)
    try:
        if rank:
            logging.getLogger().setLevel(logging.WARNING)  # rank 0 logs
        try:
            mesh = topology.serving_mesh(args.dp, args.tp,
                                         resolve_device(args.device).type)
        except ValueError as err:
            parser.error(str(err))
        log.info("serving mesh dp=%s tp=%s: rank %s of %s", args.dp, args.tp,
                 rank, world)
        return _generate(args, mesh, rank)
    finally:
        distributed.shutdown()


def _generate(args, mesh, rank: int) -> int:
    """Decode the seeded prompts on one device (``mesh`` None) or as rank
    ``rank`` of the serving mesh; rank 0 prints the rows."""
    import torch

    from hivedscheduler_tpu_torch import resolve_device
    from hivedscheduler_tpu_torch.models import decode, transformer as tm
    from hivedscheduler_tpu_torch.obs import goodput as obs_goodput
    from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt

    device = resolve_device(args.device)
    log.info("device %s", device)

    def seeded(offset: int) -> torch.Generator:
        return torch.Generator(device=device).manual_seed(args.seed + offset)

    cfg = tm.TransformerConfig(
        vocab_size=args.vocab_size,
        d_model=args.d_model,
        n_heads=args.n_heads,
        n_kv_heads=args.n_kv_heads,
        n_layers=args.n_layers,
        d_ff=args.d_ff,
        max_seq_len=args.prompt_len + args.new_tokens,
        n_experts=args.n_experts,
        moe_top_k=args.moe_top_k,
        expert_capacity_factor=args.expert_capacity_factor,
        rope_theta=args.rope_theta,
    )
    if args.top_k > cfg.vocab_size:
        log.error("--top-k %s exceeds --vocab-size %s", args.top_k, cfg.vocab_size)
        return 1
    if args.decode_steps < 1:
        log.error("--decode-steps must be >= 1, got %s", args.decode_steps)
        return 1
    if args.draft_layers > 0 and args.gamma < 1:
        log.error("--gamma must be >= 1, got %s", args.gamma)
        return 1
    try:
        params, step = ckpt.restore_serving_params(
            cfg, args.checkpoint_dir, seeded(0), lora_rank=args.lora_rank,
            lora_alpha=args.lora_alpha, lora_mlp=args.lora_mlp)
    except FileNotFoundError as e:
        log.error("%s", e)
        return 1
    if step is not None:
        log.info("restored params from step %s", step)
    if args.lora_rank > 0:
        log.info("merged rank-%s LoRA adapters into the base weights",
                 args.lora_rank)
    if args.quantize == "int8":
        # with --draft-layers the (big) target quantizes; the draft is small
        # enough that its float weights are not the bandwidth term
        from hivedscheduler_tpu_torch.models import quant

        params = quant.quantize_params(params, cfg)
        log.info("quantized weights to int8 (per-output-channel scales)")
    else:
        # serving holds weights in the compute dtype: decode is bound by
        # memory bandwidth, and f32 weights would move twice the bytes
        params = tm.cast_params(params, cfg.dtype)

    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=seeded(1), device=device)
    gen = seeded(2) if args.temperature > 0 else None
    sampling = dict(temperature=args.temperature, top_k=args.top_k,
                    top_p=args.top_p)
    t0 = time.perf_counter()
    obs_goodput.phase("step_compute")
    if args.draft_layers > 0:
        from hivedscheduler_tpu_torch.models.speculative import (
            derive_draft_config,
            generate_speculative,
        )

        try:
            dft_cfg = derive_draft_config(cfg, args.draft_layers,
                                          args.draft_d_model)
        except ValueError as e:
            log.error("%s", e)
            return 1
        dft_params = tm.cast_params(
            tm.init_params(dft_cfg, seeded(3), device), dft_cfg.dtype)
        if mesh is not None:
            from hivedscheduler_tpu_torch.models.speculative import (
                make_sharded_speculative,
            )

            try:
                run, tgt_layout, dft_layout, prompt_layout = make_sharded_speculative(
                    cfg, dft_cfg, mesh, args.new_tokens, gamma=args.gamma,
                    quantized_target=args.quantize == "int8", **sampling)
            except ValueError as e:
                log.error("%s", e)
                return 1
            # rebinding drops the whole trees: this rank keeps its slices
            params, dft_params = tgt_layout(params), dft_layout(dft_params)
            out, stats = run(params, dft_params, prompt_layout(prompt), gen)
        else:
            out, stats = generate_speculative(
                params, dft_params, prompt, cfg, dft_cfg, args.new_tokens,
                gamma=args.gamma, generator=gen, **sampling)
        log.info(
            "speculation: %s rounds, %s/%s draft tokens accepted (%.0f%%)",
            stats.rounds, stats.accepted, stats.drafted,
            100.0 * stats.accepted / max(1, stats.drafted),
        )
    elif mesh is not None:
        try:
            run, param_layout, prompt_layout = decode.make_sharded_generate(
                cfg, mesh, args.new_tokens, quantized=args.quantize == "int8",
                decode_steps=args.decode_steps, **sampling)
        except ValueError as e:
            # user errors (head counts, vocab or d_ff vs --tp) get the same
            # one-line treatment as the JAX CLI's
            log.error("%s", e)
            return 1
        params = param_layout(params)  # this rank's slices; the whole tree goes
        out = run(params, prompt_layout(prompt), gen)
    else:
        out = decode.generate(params, prompt, cfg, args.new_tokens,
                              decode_steps=args.decode_steps, generator=gen,
                              **sampling)
    rows = out.tolist()  # the host sync: decode ends here
    obs_goodput.phase("idle")
    dt = time.perf_counter() - t0
    log.info(DECODE_LOG, args.batch, args.new_tokens, dt,
             args.batch * args.new_tokens / max(dt, 1e-9))
    if rank == 0:
        for row in rows:
            print(" ".join(str(t) for t in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
