"""The repo's synthetic 2-hop graph: uniform sources, half the targets
uniform and half Pareto(1.2) (celebrity uids get most edges).

A configuration that names ``"generator": "pareto_celebrity"`` gives
``nodes``, ``generated_edges`` and ``structure_seed``.
"""

import numpy as np


def gen_edges(n_nodes: int, n_edges: int, seed: int):
    """The bench graph's edges: uniform sources, half the targets uniform
    and half pareto-skewed (celebrity uids get most edges).

    Frozen copy of ``dgraph_tpu_torch/bench2hop.py:gen_edges`` (there the
    seed is the constant ``GRAPH_SEED`` 7)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, n_nodes + 1, size=n_edges)
    pop = (rng.pareto(1.2, size=n_edges).astype(np.float64) + 1.0)
    dst = (np.clip(pop / pop.max(), 1e-9, 1.0) * (n_nodes - 1)).astype(np.int64) + 1
    half = n_edges // 2
    dst[:half] = rng.integers(1, n_nodes + 1, size=half)
    return src, dst


def make(cfg: dict, device):
    """(src, dst) int64 host arrays of the configuration's graph."""
    return gen_edges(cfg["nodes"], cfg["generated_edges"], cfg["structure_seed"])
