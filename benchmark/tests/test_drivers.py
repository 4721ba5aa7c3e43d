"""Drivers found by name: a cell whose traffic names a driver of its own
runs from new files and entries alone, a traffic that names
``batched_2hop`` runs as one that names none, an unknown driver stops the
run before anything is printed, and a cell's driver gets its cards."""

import functools
import hashlib
import json
import shutil
import subprocess
import sys

import pytest

from benchmark import data, spec
from benchmark.tests import test_benchmark_harness as harness
from benchmark.tests import tiny

# A closed-loop driver of its own: each query sums a run of ``width``
# consecutive uids on the device, held to the same sum worked out on the
# host.  It builds on measure.py's loop and a dataclass of its own.
SUMS = '''"""Sums of runs of uids, one a query."""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from benchmark import data
from benchmark.measure import IN_FLIGHT, Run, _Fetch, _loop

MOD = 2**31 - 1


@dataclass
class Plan:
    width: int
    n_cycle: int


def run_cell(cell, seed, seconds, tracing, devices, t_start=None):
    t_start = time.perf_counter() if t_start is None else t_start
    device, tr = devices[0], cell.traffic
    q = tr["batch"]
    plan = Plan(cell.config["width"], tr["pool"] // q)
    starts = data.run_rng(seed, 1).integers(1, cell.config["nodes"], tr["pool"])
    rows = torch.as_tensor(starts[:, None] + np.arange(plan.width), device=device)

    def call(b):
        block = rows[b * q:(b + 1) * q]
        return ((block.sum(1) % MOD).to(torch.int32),
                torch.full((q,), plan.width, dtype=torch.int32, device=device), None)

    fetch = [_Fetch(q, device) for _ in range(IN_FLIGHT)]
    _loop(call, fetch, plan.n_cycle, float("inf"), max_batches=plan.n_cycle)
    run = Run(batch_q=q)
    run.setup_s = time.perf_counter() - t_start
    run.window = _loop(call, fetch, plan.n_cycle, seconds)
    want = (starts * plan.width + plan.width * (plan.width - 1) // 2) % MOD
    failed = 0
    for b, chk in zip(run.window.batch, run.window.checksums):
        failed += int((chk != want[b * q:(b + 1) * q]).sum())
        run.queries += q
        run.window.edges += q * plan.width
    checks = {"sum_mismatch": {"value": failed, "limit": 0}}
    info = {"memory_peak_bytes": 0, "batches": len(run.window.batch),
            "queries": run.queries, "pool": tr["pool"],
            "devices": [str(d) for d in devices]}
    return run, checks, failed, info
'''

# A driver that touches no device: it reports the devices it was handed.
ECHO = '''from benchmark.measure import Phase, Run


def run_cell(cell, seed, seconds, tracing, devices, t_start=None):
    run = Run(batch_q=1, setup_s=0.5, queries=1,
              window=Phase(latency_s=[0.01], seconds=1.0, edges=1))
    info = {"memory_peak_bytes": 0, "batches": 1, "queries": 1,
            "devices": [str(d) for d in devices]}
    return run, {"nothing": {"value": 0, "limit": 0}}, 0, info
'''

TWO_HOP = "ldbc-snb-sf100.fof1"


def _tree(root):
    """{path under benchmark/: sha256} of a checkout's benchmark."""
    base = root / "benchmark"
    return {str(p.relative_to(base)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def _checkout(tmp_path, files, workloads, into=(), configs=()):
    """A copy of the checkout's ``BENCHMARK.json`` and ``benchmark/`` with
    ``files`` ({path under benchmark/: text}) dropped in, ``configs`` and
    ``workloads`` added, and each workload added to the end-to-end metrics
    named in ``into``."""
    shutil.copytree(spec.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, text in files.items():
        (tmp_path / "benchmark" / rel).write_text(text)
    bench = spec.load_benchmark()
    bench["configs"] += list(configs)
    bench["workloads"] += workloads
    for m in bench["end_to_end"]:
        if m["name"] in into:
            m["workloads"] += [w["name"] for w in workloads]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def _sums_checkout(tmp_path, driver="toy_sums", chips=1):
    return _checkout(tmp_path, {
        f"drivers/{driver}.py": SUMS if driver == "toy_sums" else ECHO,
        "configs/toy-runs.json": json.dumps({"name": "toy-runs", "nodes": 100_000,
                                             "width": 64, "reduced": []}),
        "traffic/sums.json": json.dumps({"driver": driver, "pool": 96, "batch": 12}),
        "tiny/toy-runs.sums.json": json.dumps({"config": {"nodes": 1000},
                                               "traffic": {"pool": 36}}),
    }, [{"name": "toy-runs.sums", "config": "toy-runs", "traffic": "sums",
         "chips": chips, "why": "a test"}], into=("edges_per_s", "query_p95_ms"),
        configs=[{"name": "toy-runs", "source": "a test", "reduced": [],
                  "why": "a test", "file": "benchmark/configs/toy-runs.json"}])


@pytest.mark.parametrize("tracing", [False, True])
def test_a_cell_of_a_new_driver_runs_from_new_files_alone(tmp_path, monkeypatch,
                                                          tracing):
    """A driver, a configuration, a traffic naming the driver and a tiny
    size, each a new file, and a workload entry: the cell loads at its
    tiny size, runs through its own driver, and the shared readers read
    its line.  No file that was there before changes."""
    before = _tree(spec.ROOT)
    root = _sums_checkout(tmp_path)
    cell = tiny.cell("toy-runs.sums", root=root)
    assert cell.config["nodes"] == 1000 and cell.traffic["pool"] == 36
    assert spec.driver(cell).__file__ == str(root / "benchmark/drivers/toy_sums.py")
    out, info = harness.one_run(cell, tracing)
    assert out["correct"] is True and out["failed"] == 0 and info["pool"] == 36
    assert set(out["metrics"]) == ({"edges_per_s", "query_p95_ms", "setup_s"}
                                   if not tracing else set())
    if not tracing:
        assert out["metrics"]["edges_per_s"]["value"] > 0
    # the test parametrised over BENCHMARK.json's cells takes this one too
    monkeypatch.setattr(tiny, "cell", functools.partial(tiny.cell, root=root))
    harness.test_tiny_run_is_correct_and_its_line_has_the_keys("toy-runs.sums", tracing)
    after = _tree(root)
    added = {"drivers/toy_sums.py", "configs/toy-runs.json", "traffic/sums.json",
             "tiny/toy-runs.sums.json"}
    assert set(after) == set(before) | added
    assert {k: after[k] for k in before} == before


def test_naming_batched_2hop_is_naming_no_driver(tmp_path):
    """A traffic that names ``batched_2hop`` gives the line of the same
    traffic naming none, at the same seed, but for what the clock sets."""
    fof1 = json.loads((spec.ROOT / "benchmark/traffic/fof1.json").read_text())
    root = _checkout(tmp_path, {
        "traffic/fof1-named.json": json.dumps(dict(fof1, driver="batched_2hop")),
        f"tiny/{TWO_HOP}-named.json":
            (spec.ROOT / f"benchmark/tiny/{TWO_HOP}.json").read_text(),
    }, [{"name": f"{TWO_HOP}-named", "config": "ldbc-snb-sf100",
         "traffic": "fof1-named", "chips": 1, "why": "a test"}],
        into=("edges_per_s", "query_p95_ms"))
    lines = []
    for name in (TWO_HOP, f"{TWO_HOP}-named"):
        cell = tiny.cell(name, root=root)
        driver = spec.driver(cell).__file__
        assert driver == str(root / "benchmark/drivers/batched_2hop.py")
        out, info = harness.one_run(cell, seed=2**31 + 29, seconds=0.3)
        clocked = ("batches", "queries", "edges", "hop2_edges", "window_s",
                   "setup_s", "layout_s", "plan_s", "reference_s")
        lines.append((list(out), out["correct"], out["failed"], out["checks"],
                      sorted(out["metrics"]), out["device"],
                      {k: v for k, v in info.items() if k not in clocked}))
    assert lines[0] == lines[1]
    assert lines[0][1] is True


def test_an_unknown_driver_exits_nonzero_with_no_result(tmp_path):
    root = _checkout(tmp_path, {
        "traffic/nowhere.json": json.dumps({"driver": "no_such_driver",
                                            "pool": 12, "batch": 12}),
    }, [{"name": "ldbc-snb-sf100.nowhere", "config": "ldbc-snb-sf100",
         "traffic": "nowhere", "chips": 1, "why": "a test"}])
    got = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "ldbc-snb-sf100.nowhere", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=root, capture_output=True, text=True,
                         timeout=300)
    assert got.returncode != 0 and got.stdout == ""
    said = [line for line in got.stderr.splitlines() if line.startswith("benchmark:")]
    assert len(said) == 1
    assert "no_such_driver" in said[0] and "drivers/no_such_driver.py" in said[0]


FOUR_CARDS = """
import sys
import torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 4
torch.cuda.get_device_name = lambda device=None: "a faked card"
from benchmark import run
sys.exit(run.main(["--workload", "toy-runs.sums", "--seed", "3", "--seconds", "1",
                   "--trace", "0"]))
"""


def test_a_four_card_cell_hands_its_driver_four_cards(tmp_path):
    """With torch made to see four cards, ``run.main`` hands a ``chips: 4``
    cell's driver ``cuda:0`` to ``cuda:3`` and reports a count of 4."""
    root = _sums_checkout(tmp_path, driver="toy_echo", chips=4)
    got = subprocess.run([sys.executable, "-c", FOUR_CARDS], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]
    info_line, result = (json.loads(s) for s in got.stdout.strip().splitlines()[-2:])
    assert info_line["info"]["devices"] == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert info_line["info"]["cards"] == 4
    assert info_line["info"]["card"] == "a faked card"
    assert result["device"]["count"] == 4 and result["device"]["platform"] == "gpu"
    assert result["correct"] is True and list(result)[-1] == "checks"


def test_fewer_cards_than_the_cell_asks_for_stop_the_run(tmp_path):
    root = _sums_checkout(tmp_path, driver="toy_echo", chips=4)
    got = subprocess.run([sys.executable, "-c",
                          FOUR_CARDS.replace("lambda: 4", "lambda: 3")],
                         cwd=root, capture_output=True, text=True, timeout=300)
    assert got.returncode != 0 and got.stdout == ""
    assert "needs 4 CUDA card(s); torch sees 3" in got.stderr


def test_batched_2hop_wants_whole_batches_before_set_up(monkeypatch):
    def no_set_up(*_a, **_k):
        raise AssertionError("set-up began")

    monkeypatch.setattr(data, "build_inputs", no_set_up)
    cell = tiny.cell(TWO_HOP)
    cell.traffic["pool"] += 1
    with pytest.raises(ValueError,
                       match="traffic 'fof1': the pool must hold whole batches"):
        tiny.run(cell, 1, 0.1)


def test_a_cell_without_a_tiny_size_names_the_missing_file(tmp_path):
    root = _checkout(tmp_path, {}, [{
        "name": "ldbc-snb-sf100.fanout4096", "config": "ldbc-snb-sf100",
        "traffic": "fanout4096", "chips": 1, "why": "a test"}])
    with pytest.raises(FileNotFoundError,
                       match=r"benchmark/tiny/ldbc-snb-sf100\.fanout4096\.json"):
        tiny.cell("ldbc-snb-sf100.fanout4096", root=root)

