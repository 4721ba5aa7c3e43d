"""Tiny versions of the cells for the CPU tests: the same generators,
traffic, driver and comparison at a size the CPU runs in seconds.  A
cell's size is ``benchmark/tiny/<cell>.json``: ``{"config": {...},
"traffic": {...}}``, overrides of its configuration and traffic mix."""

import json

import torch

from benchmark import spec

CPU = torch.device("cpu")


def cells(driver: str, root=spec.ROOT):
    """The names of BENCHMARK.json's cells whose traffic runs ``driver``."""
    names = [w["name"] for w in spec.load_benchmark(root)["workloads"]]
    return [n for n in names
            if spec.load_cell(n, root=root).traffic.get("driver", spec.DEFAULT_DRIVER)
            == driver]


def devices(cell):
    """One CPU device for each card the cell asks for."""
    return [CPU] * int(cell.workload["chips"])


def cell(name: str, root=spec.ROOT):
    """The cell ``name`` of BENCHMARK.json cut to its tiny size."""
    path = root / "benchmark" / "tiny" / f"{name}.json"
    if not path.exists():
        raise FileNotFoundError(f"no tiny size for cell {name!r} at {path}")
    c = spec.load_cell(name, root=root)
    size = json.loads(path.read_text())
    c.config.update(size.get("config", {}))
    c.traffic.update(size.get("traffic", {}))
    return c


def run(cell, seed: int, seconds: float, tracing: bool = False):
    """One run of ``cell`` through its own driver on the CPU, one CPU
    device a card: (run, checks, failed, info)."""
    return spec.driver(cell).run_cell(cell, seed, seconds, tracing, devices(cell))
