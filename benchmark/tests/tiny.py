"""Tiny versions of the cells for the CPU tests: the same generators,
traffic and comparison at a size the CPU runs in seconds."""

import torch

from benchmark import spec

CPU = torch.device("cpu")

SIZES = {
    "synth21m.fanout4096": ({"nodes": 20_000, "generated_edges": 210_000},
                               {"pool": 40, "batch": 10, "seeds_per_query": 256}),
    "ldbc-snb-sf100.fof1": ({"nodes": 3_000, "knows_edges": 120_000},
                            {"pool": 64, "batch": 16}),
}


def cell(name: str, root=spec.ROOT):
    """The cell ``name`` of BENCHMARK.json cut to its tiny size."""
    c = spec.load_cell(name, root=root)
    cfg, tr = SIZES[name]
    c.config.update(cfg)
    c.traffic.update(tr)
    return c
