"""The port's serve CLI in fleet mode (``--fleet`` and its flags) on the CPU.

Each fleet run prints the streams the single-engine CLI prints on the same
weights and trace, in both ``HIVED_FLEET_KV_SHIP`` modes, dense and paged,
and logs the JAX CLI's fleet summary lines (TTFT, tokens/s over the
replicas, handoffs, retries, affinity hits, the autoscaler's actions).
``--fleet-config`` fills the fleet and SLO flags from a YAML's ``fleet:``
section; ``--prefill-replicas`` is checked against ``--fleet``; a
speculative fleet serves under re-prefill and is refused in ship mode;
``--journal-file`` spools one ``fleet/<fid>`` flight a request and
``--metrics-dump`` the fleet's counters.
"""

import json
import logging

import pytest
import torch

from hivedscheduler_tpu_torch import fleet as tfleet
from hivedscheduler_tpu_torch import serve as tserve
from hivedscheduler_tpu_torch.chaos import invariants as tinv
from hivedscheduler_tpu_torch.common import lockcheck as tlock
from hivedscheduler_tpu_torch.obs import goodput as tgp
from hivedscheduler_tpu_torch.obs import journal as tjournal
from hivedscheduler_tpu_torch.obs import trace as ttrace
from hivedscheduler_tpu_torch.runtime import metrics as tmetrics

torch.set_num_threads(1)

MODEL = dict(vocab_size=96, d_model=64, n_heads=4, n_kv_heads=2, n_layers=2, d_ff=128)
RUN = dict(requests=6, max_batch=2, max_len=64, max_new_tokens=6, arrival_every=2, seed=3)
CLI = [a for k, v in {**MODEL, **RUN}.items()
       for a in (f"--{k.replace('_', '-')}", str(v))] + ["--device", "cpu"]
# a shared system prompt over two blocks of 8, so prefixes ship and match
SHARED = ["--prefix-cache", "4", "--system-prompt-len", "16", "--page-size", "8"]


def _reset():
    for mod in (tjournal,):
        mod.disable()
        mod.JOURNAL.clear()
    ttrace.disable()
    ttrace.TRACER.clear()
    tgp.disable()
    tgp.GOODPUT.clear()
    registry = tmetrics.REGISTRY
    with registry._lock:
        registry._counters.clear()
        registry._gauges.clear()
        registry._histograms.clear()
    tlock._tls.stack = []
    tfleet.publish(None)


@pytest.fixture(autouse=True)
def _isolation():
    _reset()
    yield
    _reset()


class _Messages(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture
def log_lines():
    """The port's log messages (the CLI's and the autoscaler's), with
    logging enabled while it runs."""
    disabled = logging.root.manager.disable
    logging.disable(logging.NOTSET)
    handler = _Messages()
    logger = logging.getLogger("hivedscheduler_tpu_torch")
    logger.addHandler(handler)
    yield handler.lines
    logger.removeHandler(handler)
    logging.disable(disabled)


def _run(capsys, *extra):
    capsys.readouterr()
    rc = tserve.main(CLI + list(extra))
    streams = {}
    for line in capsys.readouterr().out.splitlines():
        rid, _, toks = line.partition("] ")
        streams[int(rid.lstrip("["))] = [int(t) for t in toks.split()]
    return rc, streams


_SINGLE = {}


def single(capsys, *extra):
    """The single-engine CLI's streams for the same flags."""
    if extra not in _SINGLE:
        rc, streams = _run(capsys, *extra)
        assert rc == 0 and streams
        _SINGLE[extra] = streams
    return _SINGLE[extra]


def _said(lines, prefix):
    return [m for m in lines if m.startswith(prefix)]


def test_fleet_of_two_serves_the_single_engines_streams(capsys, log_lines):
    rc, streams = _run(capsys, "--fleet", "2")
    assert rc == 0 and streams == single(capsys)
    summary = _said(log_lines, "fleet: ")
    assert summary and f"{RUN['requests']} requests" in summary[0]
    assert "over 2 replicas (policy least_blocks)" in summary[0] and "tok/s" in summary[0]
    assert _said(log_lines, "fleet time-to-first-token: p50")
    assert not _said(log_lines, "fleet handoffs")  # not disaggregated


@pytest.mark.parametrize("ship, paged", [("1", True), ("0", True), ("1", False)],
                         ids=["ship-paged", "reprefill-paged", "ship-dense"])
def test_disaggregated_fleet_serves_the_single_engines_streams(capsys, log_lines,
                                                               monkeypatch, ship, paged):
    monkeypatch.setenv("HIVED_FLEET_KV_SHIP", ship)
    flags = SHARED if paged else ["--prefix-cache", "4", "--system-prompt-len", "16"]
    rc, streams = _run(capsys, "--fleet", "3", "--disaggregate", "--prefill-replicas", "1",
                       *flags)
    assert rc == 0 and streams == single(capsys, *flags)
    handoffs = _said(log_lines, "fleet handoffs: ")
    assert handoffs and f"(HIVED_FLEET_KV_SHIP={ship})" in handoffs[0]
    shipped, _, rest = handoffs[0][len("fleet handoffs: "):].partition(" shipped, ")
    missed, reprefilled = int(rest.split()[0]), int(rest.split(", ")[1].split()[0])
    if ship == "1":
        # every prompt extends the 16-token system prompt: each handoff ships
        assert int(shipped) == RUN["requests"] and missed == reprefilled == 0
    else:
        assert reprefilled == RUN["requests"] and int(shipped) == 0
    assert "disaggregated" in _said(log_lines, "fleet: ")[0]


def test_ship_mode_defaults_a_prefix_cache(capsys, log_lines):
    rc, streams = _run(capsys, "--fleet", "2", "--disaggregate", "--page-size", "8")
    assert rc == 0 and streams == single(capsys, "--page-size", "8")
    assert _said(log_lines, "fleet: --disaggregate with KV shipping needs a prefix cache")


def test_prefix_affinity_routes_to_the_caching_replica(capsys, log_lines):
    rc, streams = _run(capsys, "--fleet", "2", "--route-policy", "prefix_affinity", *SHARED)
    assert rc == 0 and streams == single(capsys, *SHARED)
    hits = _said(log_lines, "fleet prefix-affinity hits: ")
    assert hits and int(hits[0].split()[-1]) > 0


def test_autoscale_grows_the_fleet_under_queue_pressure(capsys, log_lines):
    """Twelve requests up front fill the one replica's slots and queue: the
    autoscaler adds one replica (up to --fleet-max 2), and the streams do
    not move."""
    extra = ["--requests", "12", "--arrival-every", "0"]
    rc, streams = _run(capsys, "--fleet", "1", "--autoscale", "--fleet-min", "1",
                       "--fleet-max", "2", *extra)
    assert rc == 0 and streams == single(capsys, *extra)
    said = _said(log_lines, "fleet autoscaler: ")
    assert said[-1].startswith("fleet autoscaler: 1 scale-ups, 0 drain-based removals")
    assert _said(log_lines, "fleet autoscaler: serve scaled up to 2 (occupancy")


def test_fleet_config_fills_the_fleet_flags(capsys, log_lines):
    """example/config/design/fleet.yaml: 3 replicas, one prefill,
    disaggregated, prefix affinity, autoscaled 1-3, a 0.5 s p99 TTFT
    objective and one for priority 10."""
    rc, streams = _run(capsys, "--fleet-config", "example/config/design/fleet.yaml", *SHARED)
    assert rc == 0 and streams == single(capsys, *SHARED)
    knobs = _said(log_lines, "fleet config example/config/design/fleet.yaml: FleetConfig(")
    assert knobs and "replicas=3" in knobs[0] and "cooldown_s=5.0" in knobs[0]
    summary = _said(log_lines, "fleet: ")[0]
    assert "over 3 replicas (policy prefix_affinity, disaggregated)" in summary
    assert _said(log_lines, "fleet autoscaler: ")
    objectives = _said(log_lines, "slo objective ")
    assert [m.split(":")[0] for m in objectives] == ["slo objective ttft_p99",
                                                     "slo objective ttft_p99/p10"]
    assert "ceiling 500 ms" in objectives[0]


def test_fleet_config_without_a_section_or_with_a_bad_one_exits(capsys, tmp_path):
    p = tmp_path / "nofleet.yaml"
    p.write_text("physicalCluster: {}\n")
    with pytest.raises(SystemExit) as exc:
        tserve.main(CLI + ["--fleet-config", str(p)])
    assert exc.value.code != 0 and "has no `fleet:` section" in capsys.readouterr().err
    p.write_text("fleet:\n  replicsa: 3\n")
    with pytest.raises(SystemExit) as exc:
        tserve.main(CLI + ["--fleet-config", str(p)])
    assert exc.value.code != 0 and "unknown fleet config keys" in capsys.readouterr().err


@pytest.mark.parametrize("prefill", ["0", "2"])
def test_disaggregate_checks_prefill_replicas(capsys, prefill):
    with pytest.raises(SystemExit) as exc:
        tserve.main(CLI + ["--fleet", "2", "--disaggregate", "--prefill-replicas", prefill])
    assert exc.value.code != 0
    assert (f"--disaggregate needs 0 < --prefill-replicas {prefill} < --fleet 2"
            in capsys.readouterr().err)


def test_speculative_fleet_serves_under_reprefill(capsys, log_lines, monkeypatch):
    spec = ["--spec-decode", "--gamma", "2", "--page-size", "8"]
    monkeypatch.setenv("HIVED_FLEET_KV_SHIP", "0")
    rc, streams = _run(capsys, "--fleet", "2", "--disaggregate", *spec)
    assert rc == 0 and streams == single(capsys, *spec)
    assert "re-prefilled" in _said(log_lines, "fleet handoffs: ")[0]


def test_speculative_fleet_is_refused_in_ship_mode(capsys, log_lines, monkeypatch):
    monkeypatch.setenv("HIVED_FLEET_KV_SHIP", "1")
    rc, streams = _run(capsys, "--fleet", "2", "--disaggregate", "--spec-decode")
    assert rc == 1 and streams == {}
    assert any("HIVED_FLEET_KV_SHIP=0" in m for m in log_lines)


def test_journal_file_spools_one_fleet_flight_a_request(capsys, tmp_path):
    spool, dump = tmp_path / "journal.jsonl", tmp_path / "metrics.txt"
    rc, streams = _run(capsys, "--fleet", "3", "--disaggregate", "--journal-file",
                       str(spool), "--metrics-dump", str(dump), *SHARED)
    assert rc == 0 and streams == single(capsys, *SHARED)
    text = dump.read_text()
    assert f'tpu_hive_fleet_requests_total{{outcome="length"}} {RUN["requests"]}' in text
    assert f'tpu_hive_fleet_handoffs_total{{mode="ship"}} {RUN["requests"]}' in text
    assert (tmp_path / "metrics.txt.trace.json").exists()
    records = [json.loads(line) for line in spool.read_text().splitlines()]
    done = [r for r in records if r["type"] == "request_done"]
    assert sorted(r["gang"] for r in done) == [f"fleet/{i}" for i in range(RUN["requests"])]
    assert all(abs(r["args"]["ttftGapS"]) <= 1e-6 for r in done)
    flights = tjournal.JOURNAL.flights()
    for fid in range(RUN["requests"]):
        fl = flights[f"fleet/{fid}"]
        legs = [leg for leg, _, _ in fl["legs"]]
        assert fl["terminals"] == 1 and legs[0] == "route"
        assert {"handoff_ship", "handoff_import", "first_decode"} <= set(legs)
    tinv.check_journal()  # every cause backward, one close an episode
