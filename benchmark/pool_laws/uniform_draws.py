"""Seed frontiers of uniform draws over the uids, deduped.

A traffic mix that names ``"pool_law": "uniform_draws"`` gives ``pool``
(queries), ``seeds_per_query`` (draws a query) and ``pool_seed``.
"""

from typing import List

import numpy as np


def draw_frontiers(n_nodes: int, n_seeds: int, iters: int, seed: int) -> List[np.ndarray]:
    """``iters`` seed frontiers of ``n_seeds`` uniform draws each, deduped.

    Frozen copy of ``dgraph_tpu_torch/bench2hop.py:draw_frontiers`` (there
    the seed is the constant ``FRONTIER_SEED`` 3)."""
    rng = np.random.default_rng(seed)
    return [np.unique(rng.integers(1, n_nodes + 1, size=n_seeds))
            for _ in range(iters)]


def draw(n_nodes: int, traffic: dict) -> List[np.ndarray]:
    """The mix's pool of queries over uids 1..n_nodes."""
    return draw_frontiers(n_nodes, traffic["seeds_per_query"], traffic["pool"],
                          traffic["pool_seed"])
