"""Prometheus-format metrics registry of the port.

A copy of ``hivedscheduler_tpu/runtime/metrics.py``: counters, gauges and
histograms keyed by name and label set, rendered in the Prometheus text
exposition format by :meth:`Registry.render` (``serve --metrics-dump``
writes it), with the reference's latency buckets and help texts, so the
same calls render the same text in either package.

The families described here are the workload's: serving, training and the
supervisor, the journal's wait and request-leg histograms, the SLO tracker
and the goodput ledger. The scheduler's families (HTTP, the extender
routines, binds, the batched watch events of ``HIVED_EVENT_BATCH``,
defrag, backfill, elastic offers, the fleet and its ``HIVED_FLEET_KV_SHIP``
handoffs, the capacity ledger) stay out: nothing in the port emits them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from hivedscheduler_tpu_torch.common import lockcheck

_LATENCY_BUCKETS = [0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0]


class Registry:
    def __init__(self):
        self._lock = lockcheck.make_lock("metrics_lock", late=True)
        self._counters: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
        # gauges key like counters: (name, sorted label items) — plain
        # set_gauge(name, v) is the ()-labels series
        self._gauges: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], float] = {}
        # (name, labels) -> (bucket counts, sum, count)
        self._histograms: Dict[
            Tuple[str, Tuple[Tuple[str, str], ...]],
            Tuple[List[int], float, int],
        ] = {}
        self._help: Dict[str, str] = {}

    def describe(self, name: str, help_text: str) -> None:
        self._help[name] = help_text

    def inc(self, name: str, amount: float = 1.0, **labels: str) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + amount

    def set_gauge(self, name: str, value: float, **labels: str) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._gauges[key] = value

    def observe(self, name: str, seconds: float, **labels: str) -> None:
        """Record one histogram sample. ``labels`` mirror ``inc`` (e.g. the
        serving histograms split by priority class); each label set keeps
        its own buckets/sum/count, rendered as separate series."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            buckets, total, count = self._histograms.get(
                key, ([0] * (len(_LATENCY_BUCKETS) + 1), 0.0, 0)
            )
            buckets = list(buckets)
            for i, bound in enumerate(_LATENCY_BUCKETS):
                if seconds <= bound:
                    buckets[i] += 1
                    break
            else:
                buckets[-1] += 1
            self._histograms[key] = (buckets, total + seconds, count + 1)

    @staticmethod
    def _fmt(value: float) -> str:
        """Full-precision sample rendering: %g quantizes above ~1e6, which
        would flatline rate() on long-lived counters."""
        if float(value).is_integer():
            return str(int(value))
        return repr(float(value))

    def render(self) -> str:
        """Prometheus text exposition format."""
        out: List[str] = []
        with self._lock:
            names = sorted({n for n, _ in self._counters})
            for name in names:
                if name in self._help:
                    out.append(f"# HELP {name} {self._help[name]}")
                out.append(f"# TYPE {name} counter")
                for (n, labels), value in sorted(self._counters.items()):
                    if n != name:
                        continue
                    label_str = (
                        "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"
                        if labels
                        else ""
                    )
                    out.append(f"{name}{label_str} {self._fmt(value)}")
            gauge_names = sorted({n for n, _ in self._gauges})
            for name in gauge_names:
                if name in self._help:
                    out.append(f"# HELP {name} {self._help[name]}")
                out.append(f"# TYPE {name} gauge")
                for (n, labels), value in sorted(self._gauges.items()):
                    if n != name:
                        continue
                    label_str = (
                        "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"
                        if labels
                        else ""
                    )
                    out.append(f"{name}{label_str} {self._fmt(value)}")
            hist_names = sorted({n for n, _ in self._histograms})
            for name in hist_names:
                if name in self._help:
                    out.append(f"# HELP {name} {self._help[name]}")
                out.append(f"# TYPE {name} histogram")
                for (n, labels), (buckets, total, count) in sorted(
                    self._histograms.items()
                ):
                    if n != name:
                        continue
                    base = ",".join(f'{k}="{v}"' for k, v in labels)
                    sep = "," if base else ""
                    series = "{" + base + "}" if base else ""
                    cumulative = 0
                    for i, bound in enumerate(_LATENCY_BUCKETS):
                        cumulative += buckets[i]
                        out.append(
                            f'{name}_bucket{{{base}{sep}le="{bound}"}} {cumulative}'
                        )
                    cumulative += buckets[-1]
                    out.append(
                        f'{name}_bucket{{{base}{sep}le="+Inf"}} {cumulative}'
                    )
                    out.append(f"{name}_sum{series} {self._fmt(total)}")
                    out.append(f"{name}_count{series} {count}")
        return "\n".join(out) + "\n"



REGISTRY = Registry()
REGISTRY.describe("tpu_hive_serve_queue_wait_seconds",
                  "Serving request wait from submit to slot admission")
REGISTRY.describe("tpu_hive_serve_ttft_seconds",
                  "Serving time-to-first-token (queue wait + prefill)")
REGISTRY.describe("tpu_hive_serve_tpot_seconds",
                  "Serving time-per-output-token after the first token")
REGISTRY.describe("tpu_hive_serve_requests_total",
                  "Serving requests completed by priority class")
REGISTRY.describe("tpu_hive_serve_shed_total",
                  "Serving requests shed on queue-wait deadline by priority "
                  "class")
REGISTRY.describe("tpu_hive_serve_drain_rejected_total",
                  "Serving requests rejected at submit because the engine "
                  "is draining (preemption; the 503 + Retry-After path)")
REGISTRY.describe("tpu_hive_serve_fused_decode_windows_total",
                  "Multi-step fused decode windows executed (ServingEngine "
                  "decode_steps > 1: K tokens per host round-trip)")
REGISTRY.describe("tpu_hive_serve_block_pool_occupancy",
                  "Fraction of allocatable KV blocks currently referenced "
                  "(paged serving; 1.0 = pool pressure, admission gates)")
REGISTRY.describe("tpu_hive_serve_prefix_block_hits_total",
                  "KV blocks reused by reference from the block-granular "
                  "prefix cache at admission (each is a whole block of "
                  "prompt prefill skipped AND not re-stored)")
REGISTRY.describe("tpu_hive_serve_block_cow_total",
                  "Copy-on-write block copies (a stream wrote into a "
                  "block still shared with the prefix cache or another "
                  "stream)")
REGISTRY.describe("tpu_hive_serve_pool_preempted_total",
                  "Streams truncated (finish_reason=preempted) to relieve "
                  "KV block-pool exhaustion after cache reclaim ran dry")
REGISTRY.describe("tpu_hive_serve_spec_acceptance_ratio",
                  "Per-verify-round speculative acceptance fraction "
                  "(accepted draft tokens / gamma) as a histogram")
REGISTRY.describe("tpu_hive_train_resumes_total",
                  "Training incarnations that resumed from a committed "
                  "checkpoint (preemption/crash restarts)")
REGISTRY.describe("tpu_hive_train_rollbacks_total",
                  "Divergence-guard rollbacks to the last good checkpoint "
                  "(non-finite or spiking loss)")
REGISTRY.describe("tpu_hive_watchdog_stalls_total",
                  "Watchdog step-deadline expiries (hung step; the process "
                  "exits nonzero so the gang restarts)")
REGISTRY.describe("tpu_hive_gang_wait_seconds",
                  "Closed gang wait intervals by attribution bucket "
                  "(reason label: vc_quota, fragmentation, capacity, "
                  "bad_hardware, reservation_hold, priority, "
                  "elastic_degraded, unknown — obs/journal.py "
                  "WAIT_BUCKETS)")
REGISTRY.describe("tpu_hive_request_leg_seconds",
                  "Closed request-flight legs by leg name (leg label: "
                  "route, router_queue, retry, admission_wait, prefill, "
                  "handoff_ship, handoff_import, first_decode — "
                  "obs/journal.py REQUEST_LEGS; TTFT legs sum to the "
                  "measured ttft_s)")
REGISTRY.describe("tpu_hive_slo_violations_total",
                  "Observations exceeding a declared SLO ceiling, by "
                  "objective and the request's dominant leg "
                  "(leg=unattributed when the flight recorder is off)")
REGISTRY.describe("tpu_hive_slo_ttft_p99_seconds",
                  "Windowed p99 TTFT over the SLO tracker's window — the "
                  "same number the autoscaler reads as up-pressure and "
                  "/v1/inspect/slo serves")
REGISTRY.describe("tpu_hive_slo_burn_rate",
                  "Worst error-budget burn rate across declared "
                  "objectives (violating fraction / (1 - quantile) over "
                  "the window; 1.0 = burning exactly at budget)")
REGISTRY.describe("tpu_hive_train_cross_topology_resumes_total",
                  "Training incarnations that restored a checkpoint saved "
                  "on a DIFFERENT (dp, fsdp, pp, ep, tp, sp) mesh "
                  "(reshard-on-load; loss allclose, not bit-exact)")
REGISTRY.describe("tpu_hive_goodput_seconds_total",
                  "Closed workload step-phase intervals by phase (phase "
                  "label: obs/goodput.py STEP_PHASES — init, compile, "
                  "step_compute, data_wait, checkpoint_save, "
                  "checkpoint_restore, rework, eval, drain, idle; the "
                  "phases sum to the process wallclock, the conservation "
                  "invariant; step_compute alone is goodput)")
