"""The plain reference of the batched 2-hop: numpy over its own CSR.

A query is a seed frontier of uids.  Hop 1 takes every edge of every
seed; its targets, deduplicated, are hop 2's rows; hop 2 takes every
edge of those.  The answer is the edge count of both hops, the int32
checksum (the sum, modulo 2^32, of every hop-2 target, duplicates
included) and the set of hop-2 targets.  A source's edges are a set, as
a posting list is: duplicate pairs count once.

Rewritten from ``dgraph_tpu_torch/bench2hop.py`` (``np_expand``,
``np_two_hop``), which read the port's arena; this module imports nothing
of the program.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np


@dataclass
class Csr:
    """Dense CSR: row u holds uid u's distinct targets, ascending."""

    offsets: np.ndarray   # int64[n_nodes + 2]
    dst: np.ndarray       # int64[edges]
    degree: np.ndarray    # int64[n_nodes + 1]
    row_sum: np.ndarray   # int64[n_nodes + 1]: the sum of each row's targets


def sorted_unique(x: np.ndarray) -> np.ndarray:
    """The distinct values of ``x``, ascending, by a sort.  (numpy 2.3's
    ``np.unique`` hashes int64 keys: 34 s for 21M keys on an H100 host's
    CPU, where this sort takes under 1 s.)"""
    x = np.sort(x)
    keep = np.ones(len(x), bool)
    keep[1:] = x[1:] != x[:-1]
    return x[keep]


def build_csr(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> Csr:
    keys = sorted_unique(np.asarray(src, np.int64) * (n_nodes + 1)
                         + np.asarray(dst, np.int64))
    s, d = np.divmod(keys, n_nodes + 1)
    degree = np.bincount(s, minlength=n_nodes + 1).astype(np.int64)
    offsets = np.zeros(n_nodes + 2, np.int64)
    np.cumsum(degree, out=offsets[1:])
    row_sum = np.zeros(n_nodes + 1, np.int64)
    nz = degree > 0
    row_sum[nz] = np.add.reduceat(d, offsets[:-1][nz])
    return Csr(offsets, d, degree, row_sum)


def expand(csr: Csr, rows: np.ndarray) -> np.ndarray:
    """Every target of every row, in row order (rows may repeat)."""
    rows = np.asarray(rows, np.int64)
    starts = csr.offsets[rows]
    degs = csr.degree[rows]
    total = int(degs.sum())
    if total == 0:
        return np.empty(0, np.int64)
    cum = np.cumsum(degs)
    within = np.arange(total) - np.repeat(cum - degs, degs)
    return csr.dst[np.repeat(starts, degs) + within]


def wrap_int32(x) -> np.int32:
    """An int64 sum modulo 2^32, as a signed int32."""
    return np.array(int(x) & 0xFFFFFFFF, np.uint32).view(np.int32)[()]


def two_hop(csr: Csr, frontier: np.ndarray) -> Tuple[int, int, np.int32]:
    """(hop-1 edges, hop-2 edges, checksum) of one query.  Hop 2's count
    and checksum are its rows' degrees and target sums."""
    out1 = expand(csr, frontier)
    f1 = sorted_unique(out1)
    return (len(out1), int(csr.degree[f1].sum()),
            wrap_int32(csr.row_sum[f1].sum()))


def two_hop_set(csr: Csr, frontier: np.ndarray, cap1=None, cap2=None):
    """(edge count, checksum, sorted hop-2 target set) by walking both
    hops.  ``cap1`` / ``cap2`` keep only each hop's first that many edges
    (the control's capacity cut; None keeps all)."""
    out1 = expand(csr, frontier)[:cap1]
    out2 = expand(csr, sorted_unique(out1))[:cap2]
    return len(out1) + len(out2), wrap_int32(out2.sum()), sorted_unique(out2)


def answers(csr: Csr, pool: List[np.ndarray]):
    """Every pool query's (hop-1 edges, hop-2 edges, checksum) as arrays."""
    res = [two_hop(csr, f) for f in pool]
    return (np.array([r[0] for r in res], np.int64),
            np.array([r[1] for r in res], np.int64),
            np.array([r[2] for r in res], np.int32))
