"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is the ``file`` of its ``configs`` entry; its
traffic mix is ``benchmark/traffic/<traffic>.json``; each metric is read
by ``benchmark/metrics/<name>.py``, whose ``read(run)`` returns the value
or None when the run holds nothing to read.  A configuration's graph is
made by ``benchmark/generators/<generator>.py`` and a mix's pool by
``benchmark/pool_laws/<pool_law>.py`` (``benchmark/data.py``).  The timed
loop is the driver that the mix names, ``benchmark/drivers/<driver>.py``
(``batched_2hop`` where it names none), and a cell's size for the CPU
tests is ``benchmark/tiny/<cell>.json``, overrides of its configuration
and traffic (``{"config": {...}, "traffic": {...}}``).

A driver's ``run_cell(cell, seed, seconds, tracing, devices, t_start)``
gets the cell's ``chips`` devices (``cuda:0`` up) and the process's start
on ``time.perf_counter``, and returns ``(run, checks, failed, info)``:

- ``run``: what the cell's readers read.  Every cell's ``setup_s``
  reads ``run.setup_s``, the seconds from ``t_start`` to the window;
  ``edges_per_s`` and ``query_p95_ms`` read ``run.window`` (its
  ``edges``, ``seconds`` and ``latency_s``, one latency a batch) and
  ``run.batch_q``, the queries a batch (``benchmark/measure.py``'s
  ``Run`` and ``Phase`` carry them); ``run.queries`` is the result's
  ``attempted``, and a traced run's ``run.trace`` gives its ``busy_s``,
  ``window_s`` and ``breakdown``;
- ``checks``: ``{name: {"value", "limit"}}``, each number compared with
  the reference beside the limit that the driver owns;
  ``compare.is_correct`` and ``compare.print_checks`` judge and print
  them;
- ``failed``: the completed queries whose answers were wrong;
- ``info``: a dict printed on the result's ``info`` line, holding at
  least ``memory_peak_bytes`` (on the fullest card), ``batches`` and
  ``queries``.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]  # the checkout
DEFAULT_DRIVER = "batched_2hop"  # the driver of a traffic mix that names none


@dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]   # the cell's end-to-end metrics
    per_layer: List[dict]    # the cell's per-layer metrics
    root: Path = ROOT        # the checkout whose files it was read from


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root) if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {', '.join(sorted(work))})")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (root / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    per = [m for m in bench["per_layer"] if _applies(m, name)]
    return Cell(w, config, traffic, e2e, per, root)


def plugin(folder: str, name: str, root: Path = ROOT) -> ModuleType:
    """The module ``benchmark/<folder>/<name>.py`` of ``root``, loaded from
    its path."""
    path = root / "benchmark" / folder / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no {folder} file for {name!r} at {path}")
    mod_name = f"benchmark_{folder}_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod  # as an import would, for dataclasses in it
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell) -> ModuleType:
    """The module of the driver that ``cell``'s traffic names."""
    return plugin("drivers", cell.traffic.get("driver", DEFAULT_DRIVER), cell.root)


def reader(metric: str, root: Path = ROOT) -> Callable:
    """``read`` of ``benchmark/metrics/<metric>.py``."""
    return plugin("metrics", metric, root).read


def read_metrics(metrics: List[dict], run, root: Path = ROOT) -> Dict[str, dict]:
    """{name: {"value", "unit"}} of each metric whose reader found a value."""
    out = {}
    for m in metrics:
        v = reader(m["name"], root)(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
