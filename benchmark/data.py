"""The cells' graphs and query pools, made from the run's seed.

A configuration's ``generator`` names ``benchmark/generators/<name>.py``,
whose ``make(cfg, device)`` returns the graph's (src, dst) edges; a
traffic mix's ``pool_law`` names ``benchmark/pool_laws/<name>.py``, whose
``draw(n_nodes, traffic)`` returns its pool of seed frontiers.  Both are
found by name, as the metrics' readers are.

Each configuration fixes its graph's structure (``structure_seed``) and
each traffic mix its pool of queries (``pool_seed``).  The run's
``--seed`` relabels the uids by a permutation and reorders the pool, so
every seed gets the same sizes and the same work (the pool's heaviest
query sets the batch's planned capacities) on different arrays.

The port receives only the arrays made here; the reference builds its
own CSR from the same arrays.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np
import torch

from benchmark import spec

_U64 = (1 << 64) - 1


def run_rng(seed: int, stream: int) -> np.random.Generator:
    """An independent generator for one use of the run's seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) & _U64, stream]))


@dataclass
class Inputs:
    """What one run hands the program and the reference."""

    n_nodes: int
    src: np.ndarray          # int64 edge sources (uids 1..n_nodes)
    dst: np.ndarray          # int64 edge targets
    pool: List[np.ndarray]   # the queries' seed frontiers, sorted-unique uids


def build_inputs(cfg: dict, traffic: dict, seed: int, device: torch.device,
                 root: Path = spec.ROOT) -> Inputs:
    """The graph of ``cfg`` and the pool of ``traffic``, relabelled by a
    permutation of the uids drawn from ``seed`` and reordered by it.  A
    generator that draws on the card gives the same graph for a seed on
    any card, and another one on the CPU."""
    n = int(cfg["nodes"])
    src, dst = spec.plugin("generators", cfg["generator"], root).make(cfg, device)
    pool = spec.plugin("pool_laws", traffic["pool_law"], root).draw(n, traffic)
    label = np.empty(n + 1, np.int64)
    label[0] = 0
    label[1:] = run_rng(seed, 1).permutation(n) + 1
    order = run_rng(seed, 2).permutation(len(pool))
    return Inputs(n, label[src], label[dst],
                  [np.sort(label[pool[i]]) for i in order])
