"""Generation CLI: KV-cache autoregressive decoding on one device.

Counterpart of ``hivedscheduler_tpu/generate.py``, with its flags and
defaults and the same output, one line of space-separated token ids per
sequence:

    python -m hivedscheduler_tpu_torch.generate --new-tokens 32 ...

``--device`` (default ``cuda``) is the one addition; ``--device cpu`` runs
on the CPU. ``--checkpoint-dir`` restores the parameters of the newest
committed checkpoint of a ``train`` run; without it random weights from
``--seed`` demo the decode path. ``--quantize int8`` serves int8 weights,
``--draft-layers`` decodes speculatively with a random draft model.
A mixture-of-experts model (``--n-experts``, ``--moe-top-k``) decodes
with the no-drop inference capacity. ``--tp/--dp`` above 1 (MoE on a
mesh with them) and LoRA are not yet ported and exit with an error rather
than being ignored.
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


def _reject_unported(parser: argparse.ArgumentParser, args) -> None:
    for flag in ("tp", "dp"):
        if getattr(args, flag) > 1:
            parser.error(f"--{flag} > 1 is not yet ported: the port serves "
                         "on one device")
    if args.lora_rank > 0:
        parser.error("--lora-rank > 0 (merging LoRA adapters) is not yet ported")


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
                        help="the checkpoint is a LoRA run of this rank "
                        "(not yet ported)")
    parser.add_argument("--lora-alpha", type=float, default=16.0)
    parser.add_argument("--lora-mlp", action="store_true",
                        help="the checkpoint's adapters also cover the "
                             "dense-MLP projections")
    parser.add_argument("--quantize", choices=["none", "int8"], default="none",
                        help="weight-only int8 post-training quantization "
                        "(matmuls stay in the model dtype)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel serving (not yet ported)")
    parser.add_argument("--dp", type=int, default=1,
                        help="batch-parallel serving (not yet ported)")
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
    _reject_unported(parser, args)

    common.init_all(logging.DEBUG if args.verbose else logging.INFO)
    from hivedscheduler_tpu_torch.obs import goodput as obs_goodput

    if args.goodput_file:
        obs_goodput.enable(spool_path=args.goodput_file)
    import torch

    from hivedscheduler_tpu_torch import resolve_device
    from hivedscheduler_tpu_torch.models import decode, transformer as tm
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
            cfg, args.checkpoint_dir, seeded(0), lora_rank=args.lora_rank)
    except FileNotFoundError as e:
        log.error("%s", e)
        return 1
    if step is not None:
        log.info("restored params from step %s", step)
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
                    top_p=args.top_p, generator=gen)
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
        out, stats = generate_speculative(
            params, dft_params, prompt, cfg, dft_cfg, args.new_tokens,
            gamma=args.gamma, **sampling)
        log.info(
            "speculation: %s rounds, %s/%s draft tokens accepted (%.0f%%)",
            stats.rounds, stats.accepted, stats.drafted,
            100.0 * stats.accepted / max(1, stats.drafted),
        )
    else:
        out = decode.generate(params, prompt, cfg, args.new_tokens,
                              decode_steps=args.decode_steps, **sampling)
    rows = out.tolist()  # the host sync: decode ends here
    obs_goodput.phase("idle")
    dt = time.perf_counter() - t0
    log.info(DECODE_LOG, args.batch, args.new_tokens, dt,
             args.batch * args.new_tokens / max(dt, 1e-9))
    for row in rows:
        print(" ".join(str(t) for t in row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
