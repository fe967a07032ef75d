"""Serving fleet tier: the cross-replica layer between user traffic and the
port's per-replica ``ServingEngine``\\ s.

The port's copy of ``hivedscheduler_tpu/fleet``:

- :mod:`~hivedscheduler_tpu_torch.fleet.router` — :class:`FleetRouter`
  owns N replica handles (engine + gang id + role), routes each request by
  a policy (least outstanding blocks, or prefix affinity through a
  content-hash prefix index), retries shed/preempted/lost requests on
  another replica, and in disaggregated mode splits each request into a
  prefill leg and a decode leg with a KV handoff (``HIVED_FLEET_KV_SHIP=1``
  ships block contents host-side; ``0`` re-prefills through the decode
  replica's prefix cache).
- :mod:`~hivedscheduler_tpu_torch.fleet.autoscaler` —
  :class:`FleetAutoscaler` reads the engines' gauges (pool occupancy,
  queue depth, TTFT) and decides a target replica count per role with
  hysteresis and cooldown; scale-down is always drain-based, scale-up goes
  through an in-process :class:`LocalScaleBackend`.
- :class:`FleetConfig` — the ``fleet:`` section of a config YAML, which
  ``serve --fleet-config`` reads. The port does not import yaml:
  :func:`read_fleet_section` is a reader of its own for that section.

Chaos invariants: ``chaos.invariants.check_fleet`` and ``check_requests``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

from hivedscheduler_tpu_torch.fleet.router import (  # noqa: F401
    FleetRequest,
    FleetRouter,
    Replica,
    kv_ship_enabled,
    publish,
    published,
)
from hivedscheduler_tpu_torch.fleet.autoscaler import (  # noqa: F401
    AutoscalePolicy,
    FleetAutoscaler,
    LocalScaleBackend,
)

# the one nested key the fleet section holds: priority class -> seconds
_NESTED_KEYS = ("slo_ttft_p99_by_priority",)
_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)")
# YAML 1.1's float form (PyYAML's resolver): a dot is required, and an
# exponent carries its sign
_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?")
_BARE = re.compile(r"[A-Za-z_][A-Za-z0-9_.\-/]*")
_BOOLS = {"true": True, "True": True, "TRUE": True,
          "false": False, "False": False, "FALSE": False}
# the plain YAML 1.1 words that mean a boolean or null: refused rather than
# read as strings, which yaml would not do
_AMBIGUOUS = {"yes", "no", "on", "off", "y", "n", "null", "~"}


def _refuse(path: str, lineno: int, what: str) -> ValueError:
    return ValueError(f"{path}:{lineno}: the fleet section reader does not "
                      f"accept {what} (flat scalars, comments and one "
                      f"int-to-float map only)")


def _strip_comment(text: str) -> str:
    """Drop a trailing `` # comment`` (a ``#`` at the start or after
    whitespace begins one)."""
    m = re.search(r"(^|\s)#", text)
    return (text[:m.start()] if m else text).rstrip()


def _scalar(raw: str, path: str, lineno: int):
    if raw == "":
        return None  # yaml's null: an empty value
    if raw[0] in "[]{}&*!|>'\"%@`-" and not (_INT.fullmatch(raw) or _FLOAT.fullmatch(raw)):
        raise _refuse(path, lineno, f"the value {raw!r} (flow, anchor, alias, "
                                    f"tag, quoted or block scalar, or list)")
    if _INT.fullmatch(raw):
        return int(raw)
    if _FLOAT.fullmatch(raw):
        return float(raw)
    if raw in _BOOLS:
        return _BOOLS[raw]
    if raw.lower() in _AMBIGUOUS or not _BARE.fullmatch(raw):
        raise _refuse(path, lineno, f"the value {raw!r}")
    return raw


def _key_value(text: str, path: str, lineno: int) -> Tuple[str, str]:
    key, sep, rest = text.partition(":")
    if not sep or (rest and not rest[0].isspace()) or not key or key != key.strip():
        raise _refuse(path, lineno, f"the line {text!r} (not `key: value`)")
    return key, _strip_comment(rest).strip()


def read_fleet_section(path: str) -> Optional[Dict[str, Any]]:
    """The top-level ``fleet:`` mapping of the YAML file at ``path`` as a
    dict, or None when the file has no such section (or it is empty). Every
    other top-level section is skipped unread. Inside ``fleet:`` the reader
    takes ``key: value`` lines of flat scalars (ints, floats, ``true``/
    ``false``, bare strings), comments, and one nested map of int keys to
    numbers (``slo_ttft_p99_by_priority``); it raises ``ValueError`` on
    anything else (lists, flow ``{}``/``[]``, anchors, multi-line or quoted
    strings, tabs)."""
    with open(path) as f:
        lines = f.read().splitlines()
    section: List[Tuple[int, str]] = []
    found = inside = False
    for lineno, line in enumerate(lines, 1):
        body = line.strip()
        if not body or body.startswith("#"):
            continue
        if not line[0].isspace():  # a top-level line
            inside = False
            key = line.split(":", 1)[0]
            if key == "fleet":
                if found:
                    raise _refuse(path, lineno, "a second `fleet:` section")
                _key, value = _key_value(line, path, lineno)
                if value:
                    raise _refuse(path, lineno, f"`fleet: {value}` (the section "
                                                f"must be a block mapping)")
                found = inside = True
            continue
        if inside:
            if "\t" in line:
                raise _refuse(path, lineno, "a tab")
            section.append((lineno, line))
    if not section:
        return None
    out: Dict[str, Any] = {}
    indent = len(section[0][1]) - len(section[0][1].lstrip(" "))
    i = 0
    while i < len(section):
        lineno, line = section[i]
        depth = len(line) - len(line.lstrip(" "))
        text = line.strip()
        if depth != indent:
            raise _refuse(path, lineno, "a line indented off the section's "
                                        "keys (a multi-line value or nesting)")
        if text.startswith("- ") or text == "-":
            raise _refuse(path, lineno, "a list")
        key, raw = _key_value(text, path, lineno)
        if key in out:
            raise _refuse(path, lineno, f"a second `{key}`")
        i += 1
        nested = []
        while i < len(section):
            sub_no, sub = section[i]
            if len(sub) - len(sub.lstrip(" ")) <= indent:
                break
            nested.append((sub_no, sub))
            i += 1
        if not nested:
            out[key] = _scalar(raw, path, lineno)
            continue
        if raw or key not in _NESTED_KEYS:
            raise _refuse(path, nested[0][0], f"nested lines under `{key}`")
        sub_indent = len(nested[0][1]) - len(nested[0][1].lstrip(" "))
        table: Dict[int, Any] = {}
        for sub_no, sub in nested:
            if len(sub) - len(sub.lstrip(" ")) != sub_indent:
                raise _refuse(path, sub_no, "a line nested more than one level")
        for sub_no, sub in nested:
            k, v = _key_value(sub.strip(), path, sub_no)
            if not _INT.fullmatch(k) or int(k) in table:
                raise _refuse(path, sub_no, f"the key {k!r} under `{key}` (one "
                                            f"int key a line)")
            val = _scalar(v, path, sub_no)
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                raise _refuse(path, sub_no, f"the value {v!r} under `{key}`")
            table[int(k)] = val
        out[key] = table
    return out


@dataclasses.dataclass
class FleetConfig:
    """The ``fleet:`` section of a config YAML
    (example/config/design/fleet.yaml): router, disaggregation and
    autoscaler knobs for ``serve --fleet-config``. Unknown keys raise: a
    typo'd knob must not silently fall back to a default."""

    replicas: int = 2
    prefill_replicas: int = 1
    disaggregate: bool = False
    policy: str = "least_blocks"
    autoscale: bool = False
    min_replicas: int = 1
    max_replicas: int = 4
    occ_high: float = 0.75
    occ_low: float = 0.25
    queue_high: float = 4.0
    cooldown_s: float = -1.0
    up_stable_ticks: int = 2
    down_stable_ticks: int = 4
    # declared SLOs (obs/slo.py): 0 = the objective is not declared.
    # slo_window_s < 0 reads HIVED_SLO_WINDOW_S (0 = no time window);
    # slo_ttft_p99_by_priority maps priority class -> ceiling seconds
    slo_ttft_p99_s: float = 0.0
    slo_tpot_p95_s: float = 0.0
    slo_window_s: float = -1.0
    slo_ttft_p99_by_priority: Dict[int, float] = dataclasses.field(
        default_factory=dict)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "FleetConfig":
        fields = {f.name for f in dataclasses.fields(FleetConfig)}
        unknown = sorted(set(d) - fields)
        if unknown:
            raise ValueError(f"unknown fleet config keys: {unknown} "
                             f"(known: {sorted(fields)})")
        d = dict(d)
        if "slo_ttft_p99_by_priority" in d:
            d["slo_ttft_p99_by_priority"] = {
                int(k): float(v)
                for k, v in (d["slo_ttft_p99_by_priority"] or {}).items()}
        return FleetConfig(**d)

    @staticmethod
    def from_yaml(path: str) -> Optional["FleetConfig"]:
        """The ``fleet:`` section of ``path`` (None when absent). The rest
        of the file is an ordinary scheduler config: one YAML serves both
        the scheduler boot and the serving-fleet CLI."""
        section = read_fleet_section(path)
        if section is None:
            return None
        return FleetConfig.from_dict(section)

    def autoscale_policy(self) -> AutoscalePolicy:
        return AutoscalePolicy(
            min_replicas=self.min_replicas,
            max_replicas=self.max_replicas,
            occ_high=self.occ_high, occ_low=self.occ_low,
            queue_high=self.queue_high, cooldown_s=self.cooldown_s,
            up_stable_ticks=self.up_stable_ticks,
            down_stable_ticks=self.down_stable_ticks,
        )

    def slo_tracker(self, clock=None, metrics: bool = True):
        """Build the router's :class:`obs.slo.SLOTracker` from the
        declared ``slo_*`` knobs (objectives may be empty: the tracker
        still feeds the autoscaler's quantile signal)."""
        import time as _time

        from hivedscheduler_tpu_torch.obs import slo as obs_slo

        return obs_slo.SLOTracker(
            objectives=obs_slo.objectives_from_knobs(
                ttft_p99_s=self.slo_ttft_p99_s,
                tpot_p95_s=self.slo_tpot_p95_s,
                per_priority_ttft_p99=self.slo_ttft_p99_by_priority),
            window_s=None if self.slo_window_s < 0 else self.slo_window_s,
            clock=clock or _time.perf_counter, metrics=metrics,
        )
