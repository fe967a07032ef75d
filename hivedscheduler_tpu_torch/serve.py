"""Continuous-batching serving CLI on one device.

Counterpart of ``hivedscheduler_tpu/serve.py``'s single-engine path, with
its flags, defaults and output: a synthetic stream of requests (random
prompts of 2-16 tokens after an optional shared system prompt, budgets of
4..``--max-new-tokens``, one arrival every ``--arrival-every`` engine
steps, every ``--high-priority-every``-th at priority 10) is served through
``models.serving.ServingEngine``; one ``[rid] tokens`` line per request
goes to stdout, and the summary (TTFT, tokens/s, occupancy, fused windows,
prefix hits, the paged pool) to the log:

    python -m hivedscheduler_tpu_torch.serve --requests 8 --max-batch 4 ...

``--device`` (default ``cuda``) is the one addition; ``--device cpu`` runs
on the CPU. The synthetic trace is drawn from a numpy generator seeded with
``--seed + 1``. SIGTERM/SIGINT (or ``HIVED_FAULT_SERVE_PREEMPT_AT``) drains
the engine within ``--drain-deadline`` seconds and exits 0 with a drain
report. ``--spec-decode`` (or ``--draft-layers`` above 0) serves
speculatively: a draft of ``--draft-layers`` (2 when unset) layers and
``--draft-d-model`` width (half the target's by default), random weights
from ``--seed + 3``, proposes ``--gamma`` tokens a round, and the summary
reports its acceptance. ``--lora-rank`` (with the run's ``--lora-alpha``
and ``--lora-mlp``) merges a LoRA fine-tune's adapters at load. A
mixture-of-experts model (``--n-experts``, ``--moe-top-k``) serves with the
no-drop inference capacity.

Observability, as in the JAX CLI: ``--metrics-dump PATH`` turns the span
tracer on before the engine is built and at exit writes the metrics
registry's Prometheus exposition to PATH and the Chrome trace (request
spans, journal and goodput lanes) to ``PATH.trace.json``;
``--journal-file`` spools the event journal with one ``serve/<rid>`` request
flight a request; an SLO tracker (``--slo-ttft-p99``, ``--slo-window-s``)
observes every finished request's TTFT and TPOT with its dominant leg and
logs its summary at exit. Not yet ported, and refused with an error: the
fleet (``--fleet``, ``--disaggregate``, ``--autoscale``,
``--route-policy``, ``--prefill-replicas``, ``--fleet-*`` and
``--fleet-config``, whose SLO defaults therefore do not apply) and
``--tp/--dp`` above 1.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

from hivedscheduler_tpu_torch.common import utils as common

log = logging.getLogger(__name__)

# the summary's throughput line: requests, tokens, seconds, tokens/s,
# occupancy percent, decode steps
SUMMARY_LOG = ("%s requests, %s tokens in %.2fs (%.1f tok/s), occupancy %.0f%% "
               "over %s decode steps")

# flags of paths not yet ported: refused when given at all (default None)
_UNPORTED_FLAGS = (
    ("fleet", "the fleet router (--fleet)"),
    ("disaggregate", "prefill/decode disaggregation (--disaggregate)"),
    ("prefill_replicas", "the fleet's --prefill-replicas"),
    ("route_policy", "fleet routing (--route-policy)"),
    ("autoscale", "the fleet autoscaler (--autoscale)"),
    ("fleet_min", "the fleet autoscaler (--fleet-min)"),
    ("fleet_max", "the fleet autoscaler (--fleet-max)"),
    ("fleet_config", "the fleet config (--fleet-config)"),
)


def _reject_unported(parser: argparse.ArgumentParser, args) -> None:
    for flag in ("tp", "dp"):
        if getattr(args, flag) > 1:
            parser.error(f"--{flag} > 1 is not yet ported: the port serves on "
                         "one device")
    for name, what in _UNPORTED_FLAGS:
        if getattr(args, name) is not None:
            parser.error(f"{what} is not yet ported to hivedscheduler_tpu_torch")


def _log_slo(tracker) -> None:
    """One SLO summary block at exit: windowed quantiles and, for each
    declared objective, compliance, burn rate and violation attribution by
    dominant leg (the tracker's snapshot, logged)."""
    snap = tracker.snapshot()
    s = snap["series"]["ttft"]
    if s["count"]:
        log.info("slo: ttft p50 %.0f ms, p95 %.0f ms, p99 %.0f ms over "
                 "%s requests (window %ss)", 1e3 * s["p50"],
                 1e3 * s["p95"], 1e3 * s["p99"], s["count"],
                 snap["windowS"])
    for o in snap["objectives"]:
        log.info(
            "slo objective %s: ceiling %.0f ms, observed %.0f ms, "
            "compliance %s, burn rate %s, violation attribution %s",
            o["name"], 1e3 * o["ceilingS"], 1e3 * o["value"],
            "n/a" if o["compliance"] is None else f"{o['compliance']:.4f}",
            "n/a" if o["burnRate"] is None else f"{o['burnRate']:.2f}",
            o["attribution"] or "{}",
        )


def synthetic_trace(seed: int, n_requests: int, vocab_size: int,
                    max_new_tokens: int, system_prompt_len: int = 0):
    """The CLI's requests, ``[(prompt, budget)]``, from a numpy generator
    seeded with ``seed``: an optional shared system prompt, then 2-16
    random tokens; budgets 4..``max_new_tokens``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    system = [int(t) for t in rng.integers(0, vocab_size, system_prompt_len)]
    pending = []
    for _ in range(n_requests):
        plen = int(rng.integers(2, 17))
        budget = 4 if max_new_tokens < 4 else int(rng.integers(4, max_new_tokens + 1))
        prompt = system + [int(t) for t in rng.integers(0, vocab_size, plen)]
        pending.append((prompt, budget))
    return pending


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="tpu-hive-torch-serve")
    parser.add_argument("--requests", type=int, default=8)
    parser.add_argument("--max-batch", type=int, default=4,
                        help="engine slots (concurrent sequences)")
    parser.add_argument("--max-len", type=int, default=256,
                        help="KV-cache arena length per slot")
    parser.add_argument("--max-new-tokens", type=int, default=32)
    parser.add_argument("--arrival-every", type=int, default=3,
                        help="admit a new request every N engine steps "
                        "(0 = all up front)")
    parser.add_argument("--age-boost-secs", type=float, default=0.0,
                        help="bounded-wait aging: one effective priority "
                        "level per this many seconds queued (0 = strict "
                        "priority)")
    parser.add_argument("--queue-timeout", type=float, default=0.0,
                        help="shed requests whose queue wait exceeds this "
                        "many seconds (finish_reason=shed); 0 = never shed")
    parser.add_argument("--high-priority-every", type=int, default=0,
                        help="submit every Nth request at priority 10 (0 = all "
                        "priority 0); per-class TTFT is reported")
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--top-k", type=int, default=0)
    parser.add_argument("--top-p", type=float, default=1.0)
    parser.add_argument("--eos-id", type=int, default=-1, help="-1 = none")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--vocab-size", type=int, default=32000)
    parser.add_argument("--d-model", type=int, default=512)
    parser.add_argument("--n-layers", type=int, default=8)
    parser.add_argument("--n-heads", type=int, default=8)
    parser.add_argument("--n-kv-heads", type=int, default=0)
    parser.add_argument("--d-ff", type=int, default=1408)
    parser.add_argument("--n-experts", type=int, default=0,
                        help="experts per MoE layer (0 = dense MLP)")
    parser.add_argument("--moe-top-k", type=int, default=1)
    parser.add_argument("--expert-capacity-factor", type=float, default=1.25,
                        help="MoE expert capacity factor (must match the "
                        "checkpoint's training value)")
    parser.add_argument("--rope-theta", type=float, default=10000.0,
                        help="RoPE base frequency (must match the "
                        "checkpoint's training value)")
    parser.add_argument("--tp", type=int, default=1, help="not yet ported")
    parser.add_argument("--dp", type=int, default=1, help="not yet ported")
    parser.add_argument("--page-size", type=int, default=0,
                        help="paged KV cache: tokens per block (0 = dense "
                        "per-slot slabs; HIVED_PAGED_KV=0 forces dense)")
    parser.add_argument("--num-blocks", type=int, default=0,
                        help="paged KV pool size in blocks (0 = capacity "
                        "parity with the dense slabs: max_batch * "
                        "ceil(max_len/page_size) + 1)")
    parser.add_argument("--prefix-cache", type=int, default=0,
                        help="prompt prefix cache entries (0 = off); the "
                        "synthetic load then shares a system prompt")
    parser.add_argument("--system-prompt-len", type=int, default=24,
                        help="shared prompt prefix length of the synthetic "
                        "load (only with --prefix-cache)")
    parser.add_argument("--decode-steps", type=int, default=1,
                        help="fuse up to K decode iterations per engine step "
                        "(a CUDA graph of one iteration replayed K times on "
                        "the card); streams are exact for any K; ignored by "
                        "the speculative engine")
    parser.add_argument("--spec-decode", action="store_true",
                        help="speculative serving: ServingEngine(spec_decode=...) "
                        "with a draft of --draft-layers (2 when unset) and "
                        "--gamma proposals a round")
    parser.add_argument("--draft-layers", type=int, default=0,
                        help="speculative serving: draft layers (0 = off "
                        "unless --spec-decode; random draft weights)")
    parser.add_argument("--draft-d-model", type=int, default=0,
                        help="draft width (default: half the target)")
    parser.add_argument("--gamma", type=int, default=4,
                        help="draft tokens proposed per verify round")
    parser.add_argument("--prefill-chunk", type=int, default=0,
                        help="absorb prompts at most this many tokens per "
                        "engine step (0 = whole prompt at admission)")
    parser.add_argument("--quantize", choices=["none", "int8"], default="none",
                        help="weight-only int8 serving")
    parser.add_argument("--kv-quantize", choices=["none", "int8"], default="none",
                        help="int8 KV cache (per-token-per-head scales)")
    parser.add_argument("--lora-rank", type=int, default=0,
                        help="the checkpoint is a LoRA run of this rank: its "
                        "adapters merge into the base at load")
    parser.add_argument("--lora-alpha", type=float, default=16.0)
    parser.add_argument("--lora-mlp", action="store_true")
    parser.add_argument("--drain-deadline", type=float, default=10.0,
                        help="on SIGTERM/SIGINT stop admitting, finish "
                        "in-flight requests for up to this many seconds, then "
                        "exit; the rest finish as preempted")
    parser.add_argument("--checkpoint-dir", default="")
    parser.add_argument("--metrics-dump", default="",
                        help="after the run, write the Prometheus exposition "
                        "text (per-priority TTFT/TPOT/queue-wait histograms) "
                        "to this path and a Chrome-trace/Perfetto JSON of "
                        "request lifecycles to <path>.trace.json")
    parser.add_argument("--journal-file", default="",
                        help="enable the event journal and append its request "
                        "admission/shed/preemption events, with each "
                        "request's flight legs, to this JSONL spool (one "
                        "line per event, flushed per append)")
    parser.add_argument("--goodput-file", default="",
                        help="enable the workload goodput ledger and append "
                        "this run's step-phase records to this JSONL spool")
    parser.add_argument("--slo-ttft-p99", type=float, default=0.0,
                        help="declare a p99 TTFT objective (seconds): the "
                        "SLO tracker then reports windowed compliance, "
                        "error-budget burn rate and violation attribution by "
                        "dominant request leg (0 = no objective; quantiles "
                        "are tracked either way)")
    parser.add_argument("--slo-window-s", type=float, default=-1.0,
                        help="SLO tracker sliding window in seconds (-1 = the "
                        "HIVED_SLO_WINDOW_S default, 0 = no time window: a "
                        "last-N ring)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # not yet ported: refused when given
    parser.add_argument("--fleet", type=int, default=None)
    parser.add_argument("--disaggregate", action="store_const", const=True,
                        default=None)
    parser.add_argument("--prefill-replicas", type=int, default=None)
    parser.add_argument("--route-policy", default=None)
    parser.add_argument("--autoscale", action="store_const", const=True,
                        default=None)
    parser.add_argument("--fleet-min", type=int, default=None)
    parser.add_argument("--fleet-max", type=int, default=None)
    parser.add_argument("--fleet-config", default=None)
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)
    _reject_unported(parser, args)
    if args.prefix_cache > 0:
        # synthetic prompts are system + up to 16 tokens: fail fast rather
        # than let a mid-run submit() raise
        worst = args.system_prompt_len + 16 + args.max_new_tokens
        if worst > args.max_len:
            parser.error(
                f"--system-prompt-len {args.system_prompt_len} + prompt tail "
                f"(16) + --max-new-tokens {args.max_new_tokens} = {worst} "
                f"exceeds --max-len {args.max_len}")

    common.init_all(logging.DEBUG if args.verbose else logging.INFO)
    from hivedscheduler_tpu_torch.obs import journal as obs_journal
    from hivedscheduler_tpu_torch.obs import slo as obs_slo
    from hivedscheduler_tpu_torch.obs import trace as obs_trace

    if args.metrics_dump:
        # request-lifecycle spans only reach the ring while tracing is on
        obs_trace.enable()
    if args.journal_file:
        obs_journal.enable(spool_path=args.journal_file)
    from hivedscheduler_tpu_torch.obs import goodput as obs_goodput

    if args.goodput_file:
        obs_goodput.enable(spool_path=args.goodput_file)
    import torch

    from hivedscheduler_tpu_torch import resolve_device
    from hivedscheduler_tpu_torch.models import serving, transformer as tm
    from hivedscheduler_tpu_torch.parallel import checkpoint as ckpt
    from hivedscheduler_tpu_torch.parallel import supervisor as sup_lib

    device = resolve_device(args.device)
    log.info("device %s", device)
    cfg = tm.TransformerConfig(
        vocab_size=args.vocab_size,
        d_model=args.d_model,
        n_heads=args.n_heads,
        n_kv_heads=args.n_kv_heads,
        n_layers=args.n_layers,
        d_ff=args.d_ff,
        max_seq_len=args.max_len,
        n_experts=args.n_experts,
        moe_top_k=args.moe_top_k,
        expert_capacity_factor=args.expert_capacity_factor,
        rope_theta=args.rope_theta,
    )
    try:
        params, step = ckpt.restore_serving_params(
            cfg, args.checkpoint_dir,
            torch.Generator(device=device).manual_seed(args.seed),
            lora_rank=args.lora_rank, lora_alpha=args.lora_alpha,
            lora_mlp=args.lora_mlp)
    except FileNotFoundError as e:
        log.error("%s", e)
        return 1
    if step is not None:
        log.info("restored params from step %s", step)
    if args.lora_rank > 0:
        log.info("merged rank-%s LoRA adapters into the base weights",
                 args.lora_rank)
    if args.quantize == "int8":
        from hivedscheduler_tpu_torch.models import quant

        params = quant.quantize_params(params, cfg)
        log.info("quantized weights to int8 (per-output-channel scales)")
    else:
        # serving streams the weights every step: hold them in the compute dtype
        params = tm.cast_params(params, cfg.dtype)
    speculative = args.spec_decode or args.draft_layers > 0
    spec_cfg = None
    if speculative:
        from hivedscheduler_tpu_torch.models.speculative import (
            SpecDecodeConfig,
            derive_draft_config,
        )

        if args.decode_steps > 1:
            log.warning("--decode-steps is ignored by the speculative engine "
                        "(a verify round already amortizes the host round-trip)")
        try:
            dft_cfg = derive_draft_config(cfg, args.draft_layers or 2,
                                          args.draft_d_model)
        except ValueError as e:
            log.error("%s", e)
            return 1
        dft_params = tm.cast_params(tm.init_params(
            dft_cfg, torch.Generator(device=device).manual_seed(args.seed + 3),
            device), dft_cfg.dtype)
        spec_cfg = SpecDecodeConfig(draft_params=dft_params, draft_cfg=dft_cfg,
                                    gamma=args.gamma)
    try:
        eng = serving.ServingEngine(
            params, cfg, max_batch=args.max_batch, max_len=args.max_len,
            temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
            eos_id=None if args.eos_id < 0 else args.eos_id, seed=args.seed,
            prefix_cache_size=args.prefix_cache, prefill_chunk=args.prefill_chunk,
            kv_dtype=None if args.kv_quantize == "none" else args.kv_quantize,
            queue_timeout_s=args.queue_timeout if args.queue_timeout > 0 else None,
            age_boost_secs=args.age_boost_secs if args.age_boost_secs > 0 else None,
            decode_steps=args.decode_steps, page_size=args.page_size,
            num_blocks=args.num_blocks, spec_decode=spec_cfg)
    except ValueError as e:
        log.error("%s", e)
        return 1
    if args.journal_file or obs_journal.JOURNAL.enabled:
        # single-engine flights: serve/<rid> legs and terminal in the journal
        eng.record_flights = True
    slo_tracker = obs_slo.SLOTracker(
        objectives=obs_slo.objectives_from_knobs(ttft_p99_s=args.slo_ttft_p99),
        window_s=None if args.slo_window_s < 0 else args.slo_window_s)
    system_len = args.system_prompt_len if args.prefix_cache > 0 else 0
    pending = synthetic_trace(args.seed + 1, args.requests, cfg.vocab_size,
                              args.max_new_tokens, system_len)

    def prio_of(i: int) -> int:
        hp = args.high_priority_every
        return 10 if hp > 0 and (i + 1) % hp == 0 else 0

    # graceful preemption: SIGTERM/SIGINT request a drain instead of dying
    # mid-decode; HIVED_FAULT_SERVE_PREEMPT_AT triggers the same path
    listener = sup_lib.PreemptionListener().install()
    faults = sup_lib.FaultInjection.from_env()
    reqs = []
    rejected = 0
    drained = True
    t0 = time.perf_counter()
    steps = 0
    try:
        if args.arrival_every == 0:  # all up front
            while pending:
                prompt, budget = pending.pop(0)
                reqs.append(eng.submit(prompt, budget, priority=prio_of(len(reqs))))
        while pending or (reqs and not all(r.done for r in reqs)):
            if faults.take_serve_preempt(steps):
                listener.trigger()
            if listener.requested:
                break
            if pending and steps % args.arrival_every == 0:
                prompt, budget = pending.pop(0)
                reqs.append(eng.submit(prompt, budget, priority=prio_of(len(reqs))))
                log.info("admitted request %s (prompt %s, budget %s, prio %s)",
                         reqs[-1].rid, len(prompt), budget, reqs[-1].priority)
            obs_goodput.phase("step_compute")
            eng.step()
            steps += 1
        obs_goodput.phase("idle")
        if listener.requested:
            # admission off first (the not-yet-submitted arrivals are
            # rejected), then finish in-flight requests within the deadline
            eng.begin_drain()
            for prompt, budget in pending:
                try:
                    eng.submit(prompt, budget)
                except serving.EngineDraining:
                    rejected += 1
            pending.clear()
            drained = eng.drain(args.drain_deadline)
    finally:
        listener.uninstall()
    dt = time.perf_counter() - t0

    total_tokens = sum(len(r.tokens_out) for r in reqs)
    for r in reqs:
        print(f"[{r.rid}] " + " ".join(str(t) for t in r.tokens_out))
    for r in reqs:
        if not r.done:
            continue
        dom = (obs_journal.JOURNAL.request_dominant_leg(f"serve/{r.rid}")
               if obs_journal.JOURNAL.enabled else "")
        if r.ttft_s is not None:
            slo_tracker.observe("ttft", r.ttft_s, priority=r.priority, leg=dom,
                                at=r.done_at)
        if r.tpot_s is not None:
            slo_tracker.observe("tpot", r.tpot_s, priority=r.priority, leg=dom,
                                at=r.done_at)
    _log_slo(slo_tracker)
    ttfts = sorted(r.ttft_s for r in reqs if r.ttft_s is not None)
    if ttfts:
        log.info("time-to-first-token: p50 %.0f ms, max %.0f ms",
                 1e3 * ttfts[len(ttfts) // 2], 1e3 * ttfts[-1])
        if args.high_priority_every > 0:
            for cls in sorted({r.priority for r in reqs}, reverse=True):
                cl = sorted(r.ttft_s for r in reqs
                            if r.priority == cls and r.ttft_s is not None)
                if cl:
                    log.info("  priority-%s TTFT: p50 %.0f ms over %s requests",
                             cls, 1e3 * cl[len(cl) // 2], len(cl))
    log.info(SUMMARY_LOG, len(reqs), total_tokens, dt, total_tokens / dt,
             100.0 * eng.occupancy, eng.steps)
    shed = [r for r in reqs if r.finish_reason == "shed"]
    if shed:
        log.info("shed %s request(s) on the %.1fs queue-wait deadline: %s",
                 len(shed), args.queue_timeout, " ".join(str(r.rid) for r in shed))
    if listener.requested:
        preempted = [r for r in reqs if r.finish_reason == "preempted"]
        log.info(
            "preemption drain: rejected %s not-yet-admitted arrival(s) "
            "(503 + Retry-After path), %s in-flight finished, %s preempted "
            "at the %.1fs deadline (%s)",
            rejected, sum(1 for r in reqs if r.done and r.finish_reason
                          in ("eos", "length")),
            len(preempted), args.drain_deadline,
            "fully drained" if drained else "deadline expired")
    if args.decode_steps > 1 and not speculative:
        log.info("fused decode: %s multi-step windows (decode_steps=%s) over "
                 "%s device steps, %s from the CUDA graph", eng.fused_windows,
                 args.decode_steps, eng.steps, eng.graph_windows)
    if speculative:
        log.info("speculation: %s/%s draft tokens accepted (%.0f%%)",
                 eng.accepted, eng.drafted, 100.0 * eng.acceptance)
    if args.prefix_cache > 0:
        log.info("prefix cache: %s hits, %s prompt tokens reused (%s entries held)",
                 eng.prefix_hits, eng.prefix_tokens_reused, len(eng._prefix_cache))
    if eng.paged:
        log.info("paged KV: %s/%s blocks in use at exit, %s prefix block hits, "
                 "%s COW copies, %s pool preemptions",
                 eng.blocks_in_use, eng.num_blocks - 1, eng.prefix_block_hits,
                 eng.blocks_cow, eng.pool_preempted)
    if args.metrics_dump:
        from hivedscheduler_tpu_torch.runtime.metrics import REGISTRY

        with open(args.metrics_dump, "w") as f:
            f.write(REGISTRY.render())
        trace_path = args.metrics_dump + ".trace.json"
        obs_trace.write_chrome_trace(trace_path)
        log.info("metrics exposition -> %s; Chrome trace -> %s "
                 "(open in https://ui.perfetto.dev)", args.metrics_dump, trace_path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
