"""Continuous-batching serving CLI on one device or a serving mesh.

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
flight a request (``fleet/<fid>`` in fleet mode); an SLO tracker
(``--slo-ttft-p99``, ``--slo-window-s``) observes every finished request's
TTFT and TPOT with its dominant leg and logs its summary at exit.

The fleet, as in the JAX CLI: ``--fleet N`` serves the trace through a
``fleet.FleetRouter`` over N replicas in this process, each a fresh engine
over the same params (``--route-policy``; shed, preempted and lost streams
retry on another replica). ``--disaggregate`` splits prefill (the first
``--prefill-replicas``) from decode, with the KV handoff that
``HIVED_FLEET_KV_SHIP`` selects (a prefix cache of 8 entries a replica
when shipping and none was given). ``--autoscale`` runs the
``FleetAutoscaler`` between ``--fleet-min`` and ``--fleet-max``, building
replicas in-process. ``--fleet-config`` reads those knobs and the SLO
defaults from a YAML's ``fleet:`` section; explicit flags win. One
``[fid] tokens`` line per request, and the fleet summary (TTFT, tokens/s,
handoffs, retries, affinity hits, autoscaler actions) in the log.

``--tp``/``--dp`` above 1, or a process the scheduler placed in a gang
(its handoff in the environment, as ``train`` reads it) and not asked for
``--fleet``, serve on a ``("dp", "tp")`` serving mesh
(``ServingEngine(mesh=)``), one process a GPU: the process group comes
from the gang handoff and its ranks must be exactly dp x tp (one process asked for ``--tp 2`` is a usage
error). Every rank builds the same weights and trace from the seed and
makes the same engine calls; a preemption signal on any rank drains every
rank at the same step. Rank 0 alone prints the streams and the summary and
writes ``--journal-file`` and ``--metrics-dump``. ``--fleet`` does not
compose with them, as in the JAX CLI.
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


def _run_fleet(args, router, autoscaler, pending, prio_of) -> int:
    """Drive the synthetic load through the FleetRouter (the --fleet
    path): staggered arrivals, an autoscaler tick a step, and a fleet
    summary beside the single-engine report's."""
    from hivedscheduler_tpu_torch import fleet as fleet_pkg

    reqs = []
    steps = 0
    t0 = time.perf_counter()
    try:
        if args.arrival_every == 0:  # all up front
            while pending:
                prompt, budget = pending.pop(0)
                reqs.append(router.submit(prompt, budget, priority=prio_of(len(reqs))))
        while pending or (reqs and not all(f.done for f in reqs)):
            if pending and steps % args.arrival_every == 0:
                prompt, budget = pending.pop(0)
                reqs.append(router.submit(prompt, budget, priority=prio_of(len(reqs))))
            if autoscaler is not None:
                autoscaler.tick()
            router.step()
            steps += 1
    finally:
        fleet_pkg.publish(None)
    dt = time.perf_counter() - t0

    total_tokens = sum(len(f.tokens_out) for f in reqs)
    for f in reqs:
        print(f"[{f.fid}] " + " ".join(str(t) for t in f.tokens_out))
    ttfts = sorted(f.ttft_s for f in reqs if f.ttft_s is not None)
    if ttfts:
        log.info("fleet time-to-first-token: p50 %.0f ms, max %.0f ms",
                 1e3 * ttfts[len(ttfts) // 2], 1e3 * ttfts[-1])
    snap = router.snapshot()
    log.info("fleet: %s requests, %s tokens in %.2fs (%.1f tok/s) over %s "
             "replicas (policy %s%s)", len(reqs), total_tokens, dt,
             total_tokens / dt, len(snap["replicas"]), router.policy,
             ", disaggregated" if router.disaggregate else "")
    if router.disaggregate:
        log.info("fleet handoffs: %s shipped, %s missed, %s re-prefilled "
                 "(HIVED_FLEET_KV_SHIP=%s)", router.handoffs["ship"],
                 router.handoffs["miss"], router.handoffs["reprefill"],
                 "1" if router.kv_ship else "0")
    if router.retried:
        log.info("fleet retries: %s shed/preempted/lost legs re-routed",
                 router.retried)
    if router.policy == "prefix_affinity":
        log.info("fleet prefix-affinity hits: %s", router.affinity_hits)
    _log_slo(router.slo)
    if autoscaler is not None:
        ups = sum(1 for a in autoscaler.actions
                  if a["direction"] == "up" and a["phase"] == "added")
        downs = sum(1 for a in autoscaler.actions if a["phase"] == "removed")
        log.info("fleet autoscaler: %s scale-ups, %s drain-based removals, %s "
                 "live replicas at exit", ups, downs,
                 sum(1 for r in snap["replicas"]
                     if r["state"] in ("active", "draining")))
    if args.metrics_dump:
        _write_metrics_dump(args.metrics_dump)
    return 0


def _write_metrics_dump(path: str) -> None:
    """The registry's exposition to ``path``, the Chrome trace beside it."""
    from hivedscheduler_tpu_torch.obs import trace as obs_trace
    from hivedscheduler_tpu_torch.runtime.metrics import REGISTRY

    with open(path, "w") as f:
        f.write(REGISTRY.render())
    trace_path = path + ".trace.json"
    obs_trace.write_chrome_trace(trace_path)
    log.info("metrics exposition -> %s; Chrome trace -> %s "
             "(open in https://ui.perfetto.dev)", path, trace_path)


def _merge_fleet_config(parser: argparse.ArgumentParser, args):
    """--fleet-config: the YAML's ``fleet:`` knobs fill every fleet and SLO
    flag left at its default. Returns the FleetConfig (or None)."""
    if not args.fleet_config:
        return None
    from hivedscheduler_tpu_torch.fleet import FleetConfig

    try:
        fleet_cfg = FleetConfig.from_yaml(args.fleet_config)
    except (OSError, ValueError) as e:
        parser.error(f"--fleet-config {args.fleet_config}: {e}")
    if fleet_cfg is None:
        parser.error(f"{args.fleet_config} has no `fleet:` section")
    if args.fleet == 0:
        args.fleet = fleet_cfg.replicas
    if not args.disaggregate:
        args.disaggregate = fleet_cfg.disaggregate
    if args.prefill_replicas == 1:
        args.prefill_replicas = fleet_cfg.prefill_replicas
    if args.route_policy == "least_blocks":
        args.route_policy = fleet_cfg.policy
    if not args.autoscale:
        args.autoscale = fleet_cfg.autoscale
    if args.fleet_min == 1:
        args.fleet_min = fleet_cfg.min_replicas
    if args.fleet_max == 0 and fleet_cfg.autoscale:
        args.fleet_max = fleet_cfg.max_replicas
    if args.slo_ttft_p99 == 0.0:
        args.slo_ttft_p99 = fleet_cfg.slo_ttft_p99_s
    if args.slo_window_s < 0:
        args.slo_window_s = fleet_cfg.slo_window_s
    log.info("fleet config %s: %s", args.fleet_config, fleet_cfg)
    return fleet_cfg


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
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel serving over a tp mesh axis")
    parser.add_argument("--dp", type=int, default=1,
                        help="shard engine slots over a dp mesh axis "
                        "(--max-batch must divide it)")
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
    parser.add_argument("--fleet", type=int, default=0,
                        help="serve through a FleetRouter over this many "
                        "replicas (0 = single engine). Each replica is a "
                        "fresh engine over the same weights; requests are "
                        "routed by --route-policy, shed/preempted streams "
                        "retry on another replica")
    parser.add_argument("--disaggregate", action="store_true",
                        help="fleet mode: split prefill from decode: the "
                        "first --prefill-replicas replicas take prefill "
                        "legs, the rest decode legs, with the KV handoff "
                        "selected by HIVED_FLEET_KV_SHIP (1 = ship block "
                        "contents host-side, 0 = re-prefill through the "
                        "decode replica's prefix cache). Token-exact vs "
                        "single-replica either way")
    parser.add_argument("--prefill-replicas", type=int, default=1,
                        help="with --disaggregate: replicas dedicated to "
                        "prefill legs (the rest decode)")
    parser.add_argument("--route-policy", default="least_blocks",
                        choices=["least_blocks", "prefix_affinity"],
                        help="fleet routing policy: least outstanding KV "
                        "blocks, or prefix-affinity (route to the replica "
                        "whose prefix cache holds the prompt's leading "
                        "blocks, falling back to least-blocks)")
    parser.add_argument("--autoscale", action="store_true",
                        help="fleet mode: run the FleetAutoscaler over the "
                        "replica set (hysteresis + cooldown; scale-down is "
                        "always drain-based) between --fleet-min and "
                        "--fleet-max replicas; --fleet sizes the starting set")
    parser.add_argument("--fleet-min", type=int, default=1,
                        help="autoscaler floor (replicas)")
    parser.add_argument("--fleet-max", type=int, default=0,
                        help="autoscaler ceiling (0 = the --fleet value)")
    parser.add_argument("--fleet-config", default="",
                        help="YAML with a `fleet:` section (see example/"
                        "config/design/fleet.yaml) providing fleet/"
                        "disaggregation/autoscaler knobs; explicit fleet "
                        "flags override it")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)
    common.init_all(logging.DEBUG if args.verbose else logging.INFO)
    fleet_cfg = _merge_fleet_config(parser, args)
    sharded = args.tp > 1 or args.dp > 1
    if args.fleet > 0:
        if args.disaggregate and not 0 < args.prefill_replicas < args.fleet:
            parser.error(
                f"--disaggregate needs 0 < --prefill-replicas "
                f"{args.prefill_replicas} < --fleet {args.fleet} (at least "
                f"one prefill and one decode replica)")
        if sharded:
            parser.error("--fleet does not compose with --tp/--dp (each "
                         "replica is a single-host engine in this CLI)")
    if args.prefix_cache > 0:
        # synthetic prompts are system + up to 16 tokens: fail fast rather
        # than let a mid-run submit() raise
        worst = args.system_prompt_len + 16 + args.max_new_tokens
        if worst > args.max_len:
            parser.error(
                f"--system-prompt-len {args.system_prompt_len} + prompt tail "
                f"(16) + --max-new-tokens {args.max_new_tokens} = {worst} "
                f"exceeds --max-len {args.max_len}")

    from hivedscheduler_tpu_torch.obs import journal as obs_journal
    from hivedscheduler_tpu_torch.obs import trace as obs_trace
    from hivedscheduler_tpu_torch.parallel import distributed

    # the rank, read from the gang handoff before any process group, so
    # that only rank 0 traces, spools and dumps; a process placed in a gang
    # serves on the gang's mesh (a gang of one GPU gives the world-1 mesh)
    gang = None if args.fleet > 0 else distributed.gang_from_env()
    sharded = sharded or gang is not None
    lead = gang is None or gang[1] == 0
    if args.metrics_dump and lead:
        # request-lifecycle spans only reach the ring while tracing is on
        obs_trace.enable()
    if args.journal_file and lead:
        obs_journal.enable(spool_path=args.journal_file)
    from hivedscheduler_tpu_torch.obs import goodput as obs_goodput

    if args.goodput_file and lead:
        obs_goodput.enable(spool_path=args.goodput_file)
    if not sharded:
        return _serve(args, fleet_cfg, None, 0)
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
        return _serve(args, fleet_cfg, mesh, rank)
    finally:
        distributed.shutdown()


def _serve(args, fleet_cfg, mesh, rank: int) -> int:
    """Build the params and the engine (or the fleet) and serve the
    synthetic trace; on a mesh every rank runs this and rank 0 reports."""
    import torch

    from hivedscheduler_tpu_torch.obs import goodput as obs_goodput
    from hivedscheduler_tpu_torch.obs import journal as obs_journal
    from hivedscheduler_tpu_torch.obs import slo as obs_slo

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
    kw = dict(
        max_batch=args.max_batch, max_len=args.max_len,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        eos_id=None if args.eos_id < 0 else args.eos_id, seed=args.seed,
        prefix_cache_size=args.prefix_cache, prefill_chunk=args.prefill_chunk,
        kv_dtype=None if args.kv_quantize == "none" else args.kv_quantize,
        queue_timeout_s=args.queue_timeout if args.queue_timeout > 0 else None,
        age_boost_secs=args.age_boost_secs if args.age_boost_secs > 0 else None,
        decode_steps=args.decode_steps, page_size=args.page_size,
        num_blocks=args.num_blocks, mesh=mesh)

    def build_engine():
        # every replica shares the one set of params
        return serving.ServingEngine(params, cfg, spec_decode=spec_cfg, **kw)

    slo_tracker = obs_slo.SLOTracker(
        objectives=obs_slo.objectives_from_knobs(
            ttft_p99_s=args.slo_ttft_p99,
            tpot_p95_s=fleet_cfg.slo_tpot_p95_s if fleet_cfg else 0.0,
            per_priority_ttft_p99=(fleet_cfg.slo_ttft_p99_by_priority
                                   if fleet_cfg else None)),
        window_s=None if args.slo_window_s < 0 else args.slo_window_s)
    router = autoscaler = None
    try:
        if args.fleet > 0:
            from hivedscheduler_tpu_torch import fleet as fleet_pkg

            router = fleet_pkg.FleetRouter(policy=args.route_policy,
                                           disaggregate=args.disaggregate,
                                           slo=slo_tracker)
            if args.disaggregate and router.kv_ship and kw["prefix_cache_size"] == 0:
                # the handoff payload travels through the prefix cache
                kw["prefix_cache_size"] = 8
                log.info("fleet: --disaggregate with KV shipping needs a "
                         "prefix cache; defaulting to 8 entries/replica")
            for i in range(args.fleet):
                role = "serve"
                if args.disaggregate:
                    role = "prefill" if i < args.prefill_replicas else "decode"
                router.add_replica(f"r{i}-{role}", build_engine(), role=role)
            fleet_pkg.publish(router)
            if args.autoscale:
                seq = [0]

                def factory(role):
                    seq[0] += 1
                    return f"auto{seq[0]}-{role}", build_engine()

                autoscaler = fleet_pkg.FleetAutoscaler(
                    router, fleet_pkg.LocalScaleBackend(factory),
                    fleet_pkg.AutoscalePolicy(
                        min_replicas=args.fleet_min,
                        max_replicas=args.fleet_max or args.fleet))
        else:
            eng = build_engine()
            # the engine holds its own leaves (on a mesh, this rank's
            # slices): drop the whole trees, which only a fleet's later
            # replicas would need
            del params, spec_cfg
            if args.journal_file or obs_journal.JOURNAL.enabled:
                # single-engine flights: serve/<rid> legs and terminal in the
                # journal (the fleet's router opens fleet/<fid> flights)
                eng.record_flights = True
    except ValueError as e:
        log.error("%s", e)
        return 1
    system_len = args.system_prompt_len if args.prefix_cache > 0 else 0
    pending = synthetic_trace(args.seed + 1, args.requests, cfg.vocab_size,
                              args.max_new_tokens, system_len)

    def prio_of(i: int) -> int:
        hp = args.high_priority_every
        return 10 if hp > 0 and (i + 1) % hp == 0 else 0

    if router is not None:
        return _run_fleet(args, router, autoscaler, pending, prio_of)

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
            # a signal on any rank drains every rank at this step; on a
            # mesh the same collective agrees the step's clock reading
            if eng.sync_step(listener.requested):
                listener.trigger()
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
    if rank:
        return 0  # rank 0 reports
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
        _write_metrics_dump(args.metrics_dump)
    return 0


if __name__ == "__main__":
    sys.exit(main())
