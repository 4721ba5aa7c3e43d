"""An undirected friendship graph, Chung-Lu over lognormal weights.

A configuration that names ``"generator": "knows_chung_lu"`` gives
``nodes``, ``knows_edges``, ``structure_seed`` and ``degree_law``
(``sigma``, ``max_degree``, ``oversample``).
"""

import torch


def knows_edges(persons: int, knows: int, sigma: float, max_degree: int,
                oversample: float, seed: int, device: torch.device):
    """An undirected friendship graph of exactly ``knows`` distinct pairs
    over uids 1..persons, returned both ways (2 * knows entries) as int64
    host arrays.

    Chung-Lu: each person's expected degree is a lognormal weight of
    shape ``sigma`` scaled to the mean ``2 * knows / persons`` and cut at
    ``max_degree``; pair ends are drawn in proportion to it.  Self pairs
    are dropped, and the first ``knows`` distinct pairs in draw order are
    kept (more are drawn until there are that many).  Drawn on ``device``
    by a ``torch.Generator`` seeded with ``seed``, in a few large calls."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    f64 = dict(dtype=torch.float64, device=device)
    w = torch.empty(persons, **f64).log_normal_(0.0, sigma, generator=g)
    w = torch.clamp(w * (2.0 * knows / w.sum()), max=float(max_degree))
    cdf = torch.cumsum(w, 0)
    cdf /= cdf[-1].clone()
    keys = torch.empty(0, dtype=torch.int64, device=device)
    draw = int(knows * oversample)
    while True:
        u = torch.rand(2 * draw, generator=g, **f64)
        ends = torch.searchsorted(cdf, u, right=True).clamp_(max=persons - 1) + 1
        lo = torch.minimum(ends[:draw], ends[draw:])
        hi = torch.maximum(ends[:draw], ends[draw:])
        keys = torch.cat([keys, (lo * (persons + 1) + hi)[lo != hi]])
        sk, order = torch.sort(keys, stable=True)
        first = torch.ones_like(sk, dtype=torch.bool)
        first[1:] = sk[1:] != sk[:-1]
        firsts = order[first]
        if len(firsts) >= knows:
            break
        draw = int((knows - len(firsts)) * 1.5) + 1024
    keep = keys[torch.sort(firsts).values[:knows]]
    lo, hi = keep // (persons + 1), keep % (persons + 1)
    return (torch.cat([lo, hi]).cpu().numpy(),
            torch.cat([hi, lo]).cpu().numpy())


def make(cfg: dict, device: torch.device):
    """(src, dst) int64 host arrays of the configuration's graph."""
    law = cfg["degree_law"]
    return knows_edges(cfg["nodes"], cfg["knows_edges"], law["sigma"],
                       law["max_degree"], law["oversample"],
                       cfg["structure_seed"], device)
