"""The ``HIVED_*`` environment flags the port reads: its own registry.

Counterpart of ``hivedscheduler_tpu/common/envflags.py`` for the flags of
the ported workload path, with the same names, defaults and meanings.
:func:`get` refuses a name that has no row here, so a new flag is declared
before it is read.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class Flag:
    name: str
    default: str  # effective value when unset
    doc: str  # one line
    module: str  # repo-relative owning module (the canonical reader)


REGISTRY: Dict[str, Flag] = {f.name: f for f in [
    Flag("HIVED_GOODPUT", "0",
         "`1` enables the workload goodput ledger at import time "
         "(`goodput.enable()` or the CLIs' `--goodput-file` otherwise).",
         "hivedscheduler_tpu_torch/obs/goodput.py"),
    Flag("HIVED_FAULT_HANG_AT", "unarmed",
         "Wedge the workload at this step index (watchdog chaos hook; "
         "fires at most once per process).",
         "hivedscheduler_tpu_torch/parallel/supervisor.py"),
    Flag("HIVED_FAULT_NAN_AT", "unarmed",
         "Poison the parameters with NaN at this step index (on-nan "
         "chaos hook).",
         "hivedscheduler_tpu_torch/parallel/supervisor.py"),
    Flag("HIVED_FAULT_SERVE_PREEMPT_AT", "unarmed",
         "Trigger the serving drain path deterministically at this engine "
         "step.",
         "hivedscheduler_tpu_torch/parallel/supervisor.py"),
    Flag("HIVED_PAGED_KV", "1",
         "`0` forces the dense ragged KV cache: the differential reference "
         "for the paged block-pool path.",
         "hivedscheduler_tpu_torch/models/serving.py"),
    Flag("HIVED_FAULT_STEP_DELAY", "0.0",
         "Pad every workload step by this many seconds so the chaos "
         "harness can land signals at deterministic step windows.",
         "hivedscheduler_tpu_torch/parallel/supervisor.py"),
    Flag("HIVED_JOURNAL", "0",
         "`1` enables the event journal and its request flights at import "
         "time (`journal.enable()` or the CLIs' `--journal-file` "
         "otherwise).",
         "hivedscheduler_tpu_torch/obs/journal.py"),
    Flag("HIVED_TRACE", "0",
         "`1` enables the span tracer at import time (`trace.enable()` or "
         "`serve --metrics-dump` otherwise).",
         "hivedscheduler_tpu_torch/obs/trace.py"),
    Flag("HIVED_SLO_WINDOW_S", "60",
         "Default sliding window (seconds) of the SLO tracker's quantiles "
         "and burn rates; `0` disables time-windowing (last-N ring). "
         "Overridden by `serve --slo-window-s`.",
         "hivedscheduler_tpu_torch/obs/slo.py"),
    Flag("HIVED_LOCKCHECK", "0",
         "`1` swaps the registered locks to CheckedLock: per-thread "
         "lock-order assertions.",
         "hivedscheduler_tpu_torch/common/lockcheck.py"),
]}


def get(name: str, default: Optional[str] = None) -> Optional[str]:
    """Registered-flag environment read. Raises ``KeyError`` for a name
    not in :data:`REGISTRY`."""
    if name not in REGISTRY:
        raise KeyError(
            f"{name!r} is not a registered HIVED flag of the port — add it "
            f"to hivedscheduler_tpu_torch/common/envflags.py REGISTRY")
    return os.environ.get(name, default)
