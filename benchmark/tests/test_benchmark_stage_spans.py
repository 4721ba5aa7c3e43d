"""The readers of the program's stage spans (``*_device_ms``,
``overflow_gather_device_ms``, ``program_idle_pct``) on a fake tally and a
fake trace, and a tiny traced run on the CPU, where they read nothing."""

from types import SimpleNamespace

import pytest

from benchmark import measure, spec, trace
from benchmark.tests import tiny
from dgraph_tpu_torch import obs

STAGES = {
    "hop1_device_ms": ("two_hop.hop1",),
    "dedup_device_ms": ("two_hop.dedup",),
    "hop2_device_ms": ("two_hop.hop2",),
    "checksum_device_ms": ("two_hop.checksum",),
    "overflow_gather_device_ms": ("expand.overflow",),
}
DEVICE_MS = {"two_hop.batch": 40.0, "two_hop.hop1": 6.0, "two_hop.dedup": 4.0,
             "two_hop.hop2": 28.0, "two_hop.checksum": 2.0,
             "expand.inline": 3.0, "expand.slotmap": 1.0, "expand.overflow": 26.0}


def _tally(batches=4, device=True, drop=()):
    return {n: {"count": 2 * batches if n.startswith("expand.") else batches,
                "host_s": 0.001, "device_ms": ms if device else None}
            for n, ms in DEVICE_MS.items() if n not in drop}


def _run(batches=4, device=(), host=(), window=(0.0, 100.0)):
    return SimpleNamespace(trace=trace.Trace(list(device), list(host), window,
                                             batches))


@pytest.fixture
def totals(monkeypatch):
    """Set the program's span totals to a fake tally."""
    def put(tally):
        monkeypatch.setattr(obs, "span_totals", lambda reset=False: tally,
                            raising=False)
    return put


@pytest.mark.parametrize("metric", sorted(STAGES))
def test_a_stage_reads_its_device_ms_a_batch(metric, totals):
    totals(_tally())
    want = sum(DEVICE_MS[n] for n in STAGES[metric]) / 4
    assert spec.reader(metric)(_run()) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(STAGES))
@pytest.mark.parametrize("case", ["no_batch", "other_run", "cpu", "no_stage",
                                  "no_trace"])
def test_a_stage_reads_nothing_without_a_matching_tally(metric, case, totals):
    totals({"no_batch": _tally(drop=("two_hop.batch",)),
            "other_run": _tally(batches=5),
            "cpu": _tally(device=False),
            "no_stage": _tally(drop=STAGES[metric]),
            "no_trace": _tally()}[case])
    run = SimpleNamespace(trace=None) if case == "no_trace" else _run()
    assert spec.reader(metric)(run) is None


@pytest.mark.parametrize("metric", sorted(STAGES))
def test_a_program_without_totals_reads_nothing(metric, monkeypatch):
    monkeypatch.delattr(obs, "span_totals", raising=False)
    assert spec.reader(metric)(_run()) is None


BUSY = [("k", 0.0, 15.0), ("k", 20.0, 40.0), ("k", 45.0, 65.0), ("k", 75.0, 100.0)]


def test_program_idle_counts_idle_only_inside_open_batches():
    # idle 15-20 (inside the first batch), 40-45 (outside), 65-75 (inside)
    host = [("two_hop.batch", 10.0, 30.0), ("two_hop.hop1", 11.0, 18.0),
            ("two_hop.batch", 60.0, 80.0), ("bench.wait", 40.0, 46.0)]
    run = _run(device=BUSY, host=host)
    assert spec.reader("program_idle_pct")(run) == pytest.approx(15.0)
    assert spec.reader("device_idle_pct")(run) == pytest.approx(20.0)


def test_program_idle_clips_batches_to_the_window():
    host = [("two_hop.batch", -50.0, 17.0), ("two_hop.batch", 70.0, 150.0)]
    run = _run(device=BUSY, host=host)
    # 15-17 and 70-75 idle inside the window
    assert spec.reader("program_idle_pct")(run) == pytest.approx(7.0)


@pytest.mark.parametrize("host,device", [
    ([("bench.submit", 0.0, 50.0)], BUSY),      # the parent: no batch range
    ([("two_hop.batch", 0.0, 50.0)], []),       # no device op (a CPU run)
])
def test_program_idle_reads_nothing_without_batch_ranges_or_device(host, device):
    assert spec.reader("program_idle_pct")(_run(device=device, host=host)) is None
    assert spec.reader("program_idle_pct")(SimpleNamespace(trace=None)) is None


@pytest.mark.parametrize("name", [w["name"] for w in spec.load_benchmark()["workloads"]])
def test_a_tiny_traced_run_tallies_its_slice_and_reads_nothing_on_cpu(name):
    obs.span_totals(reset=True)
    cell = tiny.cell(name)
    run, _checks, _failed, _info = measure.run_cell(cell, 2**31 + 5, 0.5, True,
                                                    tiny.CPU)
    tot = obs.span_totals()
    assert tot["two_hop.batch"]["count"] == run.trace.batches > 0
    assert tot["expand.overflow"]["count"] == 2 * run.trace.batches
    assert all(t["device_ms"] is None for t in tot.values())
    opened = [n for n, _s, _e in run.trace.host if n == "two_hop.batch"]
    assert len(opened) == run.trace.batches
    for metric in list(STAGES) + ["program_idle_pct"]:
        assert spec.reader(metric)(run) is None
    obs.span_totals(reset=True)
