"""The harness end to end on the CPU at tiny sizes, with the port's
plain versions: the result line, the comparison against planted faults,
the import check, the data-driven lookup and BENCHMARK.json's contract.
The checks of what a run's process has loaded run in a child interpreter,
so that they see the harness's modules and not the test runner's."""

import json
import re
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import run, spec
from benchmark.tests import tiny
from dgraph_tpu_torch import bench2hop
from dgraph_tpu_torch.ops.sets import SENT

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def one_run(cell, tracing=False, seed=2**31 + 17, seconds=0.5):
    r, checks, failed, info = tiny.run(cell, seed, seconds, tracing)
    return run.result_line(cell, r, checks, failed, info, tracing,
                           tiny.devices(cell)), info


def child(code, *args):
    """``code`` run by a fresh interpreter from the checkout's root, with
    ``args`` as ``sys.argv[1:]``."""
    return subprocess.run([sys.executable, "-c", code, *map(str, args)],
                          cwd=spec.ROOT, capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("tracing", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_is_correct_and_its_line_has_the_keys(name, tracing):
    cell = tiny.cell(name)
    out, info = one_run(cell, tracing)
    line = json.loads(json.dumps(out))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] == info["queries"] > 0
    assert all(c["value"] == 0 == c["limit"] for c in line["checks"].values())
    wanted = {m["name"] for m in (cell.per_layer if tracing else cell.end_to_end)}
    assert set(line["metrics"]) <= wanted
    host_only = {"plan_s", "layout_s", "dispatch_ms", "hop2_lane_use_pct"}
    assert (host_only & wanted) <= set(line["metrics"]) if tracing else \
        set(line["metrics"]) == wanted
    assert line["device"]["count"] == cell.workload["chips"] == 1
    assert "memory_peak_bytes" in line["device"]


def _fault(kind):
    real = bench2hop.two_hop_batch
    prev = {}

    def broken(metap, ov, fm, plan):
        if kind == "half":  # half of the batch left out, the rest repeated
            h = fm.shape[0] // 2
            c, t, (i2, o2) = real(metap, ov, fm[:h], plan)
            return (torch.cat([c, c]), torch.cat([t, t]),
                    (torch.cat([i2, i2]), torch.cat([o2, o2])))
        c, t, (i2, o2) = real(metap, ov, fm, plan)
        if kind == "stale":  # the previous batch's answers, unchanged
            out = prev.get("out", (c, t, (i2, o2)))
            prev["out"] = (c, t, (i2, o2))
            return out
        if kind == "answer":  # one checksum altered where it is produced
            c = c.clone()
            c[0] += 1
        if kind == "lane":  # one target lane of every row altered
            i2 = i2.clone()
            i2[:, 0, 0] = plan.mask
        return c, t, (i2, o2)

    return broken


@pytest.mark.parametrize("kind", ["stale", "half", "answer", "lane"])
@pytest.mark.parametrize("name", ["synth21m.fanout4096", "ldbc-snb-sf100.fof1"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, kind):
    monkeypatch.setattr(bench2hop, "two_hop_batch", _fault(kind))
    out, _info = one_run(tiny.cell(name))
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


def test_the_sample_holds_the_mixs_rows_and_the_sentinel_is_the_ports():
    assert SENT == 2**31 - 1
    cell = tiny.cell("ldbc-snb-sf100.fof1")
    _out, info = one_run(cell)
    assert info["sampled_rows"] >= cell.traffic["check_sets"]


@pytest.mark.parametrize("names,found", [
    (["dgraph_tpu_torch", "dgraph_tpu_torch.ops", "numpy", "torch"], []),
    (["dgraph_tpu"], ["dgraph_tpu"]),
    (["dgraph_tpu.ops.sets", "torch"], ["dgraph_tpu.ops.sets"]),
    (["jax", "jax.numpy", "jaxlib", "flax.linen", "jaxtyping"],
     ["flax.linen", "jax", "jax.numpy", "jaxlib"]),
])
def test_forbidden_modules_compare_whole_top_level_names(names, found):
    assert run.forbidden_modules(names) == found


HARNESS = """
import json, sys
from benchmark import (compare, control, data, measure, reference, roofline, run,
                       spec, trace)
from benchmark.tests import tiny
from dgraph_tpu_torch import bench2hop
bench = spec.load_benchmark()
for w in bench["workloads"]:
    spec.driver(spec.load_cell(w["name"], bench))
for m in bench["end_to_end"] + bench["per_layer"]:
    spec.reader(m["name"])
print(json.dumps(run.forbidden_modules(list(sys.modules))))
"""


def test_the_harness_imports_no_jax():
    """The harness's modules, every cell's driver and every metric's reader,
    and the program, loaded by a fresh interpreter, load no JAX."""
    got = child(HARNESS)
    assert got.returncode == 0, got.stderr[-2000:]
    assert json.loads(got.stdout.strip().splitlines()[-1]) == []


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def _checkout_with(tmp_path, files, configs=(), workloads=(), end_to_end=()):
    """A copy of the checkout's benchmark with ``files`` ({path under
    benchmark/: text}) dropped in and the entries added to BENCHMARK.json."""
    shutil.copytree(spec.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel, text in files.items():
        (tmp_path / "benchmark" / rel).write_text(text)
    bench = spec.load_benchmark()
    bench["configs"] += list(configs)
    bench["workloads"] += list(workloads)
    bench["end_to_end"] += list(end_to_end)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


RING = """import numpy as np


def make(cfg, device):
    n, k = cfg["nodes"], cfg["ring_degree"]
    src = np.repeat(np.arange(1, n + 1), k)
    dst = (src - 1 + np.tile(np.arange(1, k + 1), n)) % n + 1
    return src, dst
"""

FIRST_UIDS = """import numpy as np


def draw(n_nodes, traffic):
    k = traffic["seeds_per_query"]
    return [np.arange(1 + i, 1 + i + k) for i in range(traffic["pool"])]
"""


@pytest.mark.parametrize("generator,pool_law", [
    ("knows_chung_lu", "uniform_draws"), ("tiny_ring", "first_uids")])
def test_new_files_are_found_by_name(tmp_path, generator, pool_law):
    """A configuration, a traffic mix, a metric, a graph generator and a
    pool law, each dropped in as a new file, run with no edit to the
    harness."""
    root = _checkout_with(tmp_path, {
        "configs/tiny-social.json": json.dumps({
            "name": "tiny-social", "generator": generator, "nodes": 2500,
            "knows_edges": 60_000, "ring_degree": 24, "structure_seed": 5,
            "degree_law": {"sigma": 1.0, "max_degree": 400, "oversample": 1.05}}),
        "traffic/fof2.json": json.dumps({
            "pool_law": pool_law, "pool": 48, "pool_seed": 9,
            "seeds_per_query": 2, "batch": 12, "check_sets": 4}),
        "metrics/batches_per_s.py":
            "def read(run):\n    return len(run.window.batch) / run.window.seconds\n",
        "generators/tiny_ring.py": RING,
        "pool_laws/first_uids.py": FIRST_UIDS,
    }, configs=[{"name": "tiny-social", "source": "a test",
                 "file": "benchmark/configs/tiny-social.json",
                 "reduced": [], "why": "a test"}],
        workloads=[{"name": "tiny-social.fof2", "config": "tiny-social",
                    "traffic": "fof2", "chips": 1, "why": "a test"}],
        end_to_end=[{"name": "batches_per_s", "unit": "1/s", "better": "higher",
                     "bound": 0.05, "source": "host_clock",
                     "workloads": ["tiny-social.fof2"]}])
    cell = spec.load_cell("tiny-social.fof2", root=root)
    assert cell.traffic["pool"] == 48 and cell.config["nodes"] == 2500
    assert "batches_per_s" in [m["name"] for m in cell.end_to_end]
    out, info = one_run(cell)
    assert out["correct"] is True
    assert out["metrics"]["batches_per_s"]["value"] > 0
    if generator == "tiny_ring":  # 2 seeds, each 24 targets, each 24 more
        assert info["stored_edges"] == 2500 * 24
        assert info["edges"] == info["queries"] * (2 * 24 + 25 * 24)
    assert "batches_per_s" not in [m["name"] for m in tiny.cell(CELLS[0]).end_to_end]


REPORT = """
import sys
from pathlib import Path
sys.path.insert(0, sys.argv[3])  # a stub jax, where one is given
from benchmark import run
from benchmark.tests import tiny
cell = tiny.cell(sys.argv[1], root=Path(sys.argv[2]))
r, checks, failed, info = tiny.run(cell, int(sys.argv[4]), 0.3)
sys.exit(run.report(cell, r, checks, failed, info, False, tiny.devices(cell)))
"""


def test_a_reader_that_loads_jax_stops_the_result(tmp_path):
    """A metric's reader is loaded while the result is built, after the
    window: if it loads JAX, the run exits 3 and prints no result."""
    stub = tmp_path / "stubs" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("")
    root = _checkout_with(tmp_path / "co", {
        "metrics/loads_jax.py": "import jax  # noqa: F401\n\n\n"
                                "def read(run):\n    return 1.0\n"},
        end_to_end=[{"name": "loads_jax", "unit": "1", "better": "higher",
                     "bound": 0.05, "source": "host_clock",
                     "workloads": [CELLS[0]]}])
    got = child(REPORT, CELLS[0], root, tmp_path / "stubs", 5)
    assert got.returncode == 3, got.stderr[-2000:]
    assert got.stdout == "" and "forbidden modules loaded: jax" in got.stderr


def test_a_clean_run_reports_its_result(tmp_path):
    got = child(REPORT, CELLS[0], spec.ROOT, tmp_path / "no-stubs", 6)
    assert got.returncode == 0, got.stderr[-2000:]
    lines = got.stdout.strip().splitlines()
    assert list(json.loads(lines[0])) == ["info"]
    assert json.loads(lines[-1])["correct"] is True


# -- BENCHMARK.json against the benchmark's contract ---------------------------

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_json_meets_the_contract():
    raw = (spec.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert 1 <= len(b["command"]) <= 32 and all(_text(w) for w in b["command"])
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch") and (spec.ROOT / p).is_dir()
    rs = b["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200

    configs = {c["name"]: c for c in b["configs"]}
    assert 1 <= len(configs) == len(b["configs"]) <= 24
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text(c["source"]) and _text(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        f = json.loads((spec.ROOT / c["file"]).read_text())
        assert f["name"] == c["name"] and f["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    assert len({c["file"] for c in b["configs"]}) == len(configs)

    cells = {w["name"]: w for w in b["workloads"]}
    assert 1 <= len(cells) == len(b["workloads"]) <= 24
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == len(cells)
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= max(1, len(cells) // 4)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4) and _text(w["why"])
        assert (spec.ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").exists()
    assert {w["config"] for w in b["workloads"]} == set(configs)

    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert 1 <= len(e2e) == len(b["end_to_end"]) <= 16 and "setup_s" in e2e
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    per = b["per_layer"]
    assert 1 <= len(per) <= 128
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert _text(m["layer"]) and m["moves"] in e2e
    names = [m["name"] for m in b["end_to_end"] + per]
    assert len(set(names)) == len(names)
    for m in b["end_to_end"] + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (spec.ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        assert all(c in cells for c in m.get("workloads", []))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for name in cells:
        c = spec.load_cell(name)
        got = {m["name"] for m in c.end_to_end}
        assert "setup_s" in got and len(got) >= 2 and c.per_layer
