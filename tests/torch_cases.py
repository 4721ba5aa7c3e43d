"""Edge-case inputs for the port's slot-map and intersect kernels, made
with numpy from fixed seeds: the shapes where the kernels' tiling could
go wrong.  csrc/slotmap.cu walks each query in tiles of SLOTMAP_TILE
rows; csrc/intersect.cu cuts row 0 into tiles of INTERSECT_TILE lanes and
stages the ranges of the other rows a tile meets in a shared buffer of
16,384 entries, as many as fit (the others it searches in device
memory).

The card holds each kernel against its plain version on these
(tests/test_torch_cuda.py, chip_smoke.py); the CPU holds the plain
versions against numpy oracles on them (tests/test_torch_slotmap.py,
tests/test_torch_intersect.py).  Imports numpy only."""

import numpy as np

SENT = 2**31 - 1
SLOTMAP_TILE = 4096     # csrc/slotmap.cu kTile
INTERSECT_TILE = 1024   # csrc/intersect.cu kTile


def grouped(rng, q: int, pcap: int, fill: float = 0.5):
    """q random grouped prefixes: up to ``fill``·pcap productive rows with
    strictly ascending chunk starts (cd 1..5, gaps 0..2), zero tail."""
    cs = np.zeros((q, pcap), np.int32)
    cd = np.zeros((q, pcap), np.int32)
    for i in range(q):
        n = int(rng.integers(0, int(pcap * fill) + 1))
        d = rng.integers(1, 6, size=n)
        cs[i, :n] = np.cumsum(rng.integers(0, 3, size=n)) + np.cumsum(d) - d
        cd[i, :n] = d
    return cs, cd


def _tile_edge_rows(t: int):
    """Six queries of exactly T-1, T, T+1, 2T-1, 2T, 2T+1 productive rows
    of one chunk each (T the kernel's tile), so totals and row ends sit
    on the tile boundaries."""
    ns = (t - 1, t, t + 1, 2 * t - 1, 2 * t, 2 * t + 1)
    cs = np.zeros((len(ns), 3 * t), np.int32)
    cd = np.zeros((len(ns), 3 * t), np.int32)
    for q, n in enumerate(ns):
        cs[q, :n] = np.arange(n) * 2 + q
        cd[q, :n] = 1
    return cs, cd


def slotmap_case(name: str):
    """(cs, cd, capc) for one of SLOTMAP_CASES."""
    t = SLOTMAP_TILE
    rng = np.random.default_rng(sum(map(ord, name)))
    if name in ("pcap_3T_plus_1", "pcap_3T_plus_1_truncated"):
        cs, cd = grouped(rng, 5, 3 * t + 1, fill=1.0)
        return cs, cd, 9000 if name.endswith("truncated") else 40960
    if name == "row_over_capc":
        # one row owns more slots than capc: first row; a row inside the
        # second tile after zero-cd rows; the first row of the second tile
        capc = 3000
        cs, cd = grouped(rng, 3, 2 * t, fill=0.2)
        cs[0, 0], cd[0, 0] = 7, capc + 100
        cd[1, :5000] = 0
        cd[1, 10], cs[1, 5000], cd[1, 5000] = 2, 50, 5000
        cd[2, :t] = 0
        cs[2, t], cd[2, t] = 3, 2 * capc
        return cs, cd, capc
    if name == "q1":
        cs, cd = grouped(rng, 1, 20000, fill=0.8)
        return cs, cd, 65536
    if name == "large_q":
        cs, cd = grouped(rng, 20000, 64, fill=1.0)
        return cs, cd, 256
    if name == "tile_edge_totals":
        return (*_tile_edge_rows(t), 2 * t)
    if name == "tile_edge_totals_capc_T":
        return (*_tile_edge_rows(t), t)
    raise KeyError(name)


SLOTMAP_CASES = ["pcap_3T_plus_1", "pcap_3T_plus_1_truncated", "row_over_capc",
                 "q1", "large_q", "tile_edge_totals", "tile_edge_totals_capc_T"]


def _padded(values, L: int) -> np.ndarray:
    out = np.full(L, SENT, np.int32)
    out[: len(values)] = values
    return out


def _draw(rng, size: int, hi: int, L: int) -> np.ndarray:
    return _padded(np.unique(rng.integers(0, hi, size=size)), L)


def intersect_case(name: str) -> np.ndarray:
    """int32[B, K, L] for one of INTERSECT_CASES."""
    t = INTERSECT_TILE
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "identical_full":
        # every lane survives: tile b's prefix is exactly (b + 1)·T
        L = 5 * t
        return np.stack([np.stack([np.arange(L, dtype=np.int32) * 3 + b] * 3)
                         for b in range(2)])
    if name == "last_tile_only":
        # survivors only in the last (ragged) tile of row 0
        L = 8 * t + 100
        row0 = np.arange(L, dtype=np.int32) * 2
        tail = row0[8 * t:]
        odd = np.unique(rng.integers(0, L, size=4000)) * 2 + 1
        rows = [row0] + [_padded(np.union1d(tail, odd), L) for _ in range(2)]
        return np.stack(rows)[None]
    if name == "dense_row_j":
        # row 1's range under one tile of row 0 holds 16,000-50,000
        # entries, mostly more than the kernel stages; row 2's 1,800-5,400
        L = 1 << 20
        return np.stack([_draw(rng, 20000, L, L), _draw(rng, 2_000_000, L, L),
                         _draw(rng, 100_000, L, L)])[None]
    if name == "thin_L2_21":
        # survivors spread thin over many tiles of a 2^21-lane row 0
        L, hi = 1 << 21, 1 << 24
        return np.stack([_draw(rng, 1_600_000, hi, L), _draw(rng, 2_000_000, hi, L),
                         _draw(rng, 400_000, hi, L)])[None]
    if name == "B1024":
        L = 4 * t
        return np.stack([np.stack([_draw(rng, 3500, 6000, L) for _ in range(3)])
                         for _ in range(1024)])
    raise KeyError(name)


INTERSECT_CASES = ["identical_full", "last_tile_only", "dense_row_j", "thin_L2_21",
                   "B1024"]

# the ordering case: one matrix intersected this many times in a loop,
# every result compared (a flaky order between a tile's SENT stores and a
# later tile's survivor stores would show as a differing repeat)
REPEATS = 200


def intersect_fold(mat: np.ndarray) -> list:
    """Numpy oracle: per batch row, the valid entries of row 0 present in
    every other row (np.intersect1d fold), ascending."""
    out = []
    for m in mat:
        acc = m[0][m[0] != SENT]
        for row in m[1:]:
            acc = np.intersect1d(acc, row[row != SENT])
        out.append(acc)
    return out
