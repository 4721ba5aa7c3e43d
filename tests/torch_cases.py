"""Edge-case inputs for the port's gather, slot-map and intersect
kernels, made with numpy from fixed seeds: the shapes where the kernels'
tiling could go wrong.  csrc/gather.cu scans the frontier in contiguous
row ranges, one per block, then expands tiles of GATHER_TILE output
slots, staging GATHER_WINDOW rows at a time; csrc/slotmap.cu walks each
query in tiles of SLOTMAP_TILE rows; csrc/intersect.cu cuts row 0 into
tiles of INTERSECT_TILE lanes and stages the ranges of the other rows a
tile meets in a shared buffer of 16,384 entries, as many as fit (the
others it searches in device memory).

The card holds each kernel against its plain version on these
(tests/test_torch_cuda.py, chip_smoke.py); the CPU holds the plain
versions against numpy oracles on them (tests/test_torch_gather.py,
tests/test_torch_slotmap.py, tests/test_torch_intersect.py).  Imports
numpy only."""

import numpy as np

SENT = 2**31 - 1
GATHER_TILE = 1024      # csrc/gather.cu kTile
GATHER_WINDOW = 256     # csrc/gather.cu kWin
SLOTMAP_TILE = 4096     # csrc/slotmap.cu kTile
INTERSECT_TILE = 1024   # csrc/intersect.cu kTile


def _resident(degs, rng):
    """(offsets int32[n+1], dst int32) of a CSR whose rows have these
    degrees, dst in the resident layout (round_up(E, 128) + 128 lanes,
    SENT past the live edges)."""
    off = np.concatenate([[0], np.cumsum(degs)]).astype(np.int32)
    e = int(off[-1])
    dst = np.full(-(-e // 128) * 128 + 128, SENT, np.int32)
    dst[:e] = rng.integers(1, 1 << 30, size=e)
    return off, dst


def _light(rng, n: int, hi: int):
    """n row degrees in [0, hi), a tenth of them 0."""
    d = rng.integers(1, hi, size=n)
    d[rng.random(n) < 0.1] = 0
    return d


def gather_case(name: str):
    """(offsets, dst, rows, cap) for one of GATHER_CASES: int32 arrays,
    rows negative = skip."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "heavy_row":
        # one 10^6-edge row among light rows, twice in the frontier
        degs = np.array([1_000_000, 3, 0, 7, 1])
        off, dst = _resident(degs, rng)
        return off, dst, np.array([1, 0, -1, 3, 4, 2, 0, -1], np.int32), 1 << 21
    if name == "b_2_20":
        # B 2^20: a block's row range holds about a thousand rows
        degs = _light(rng, 50_000, 3)
        off, dst = _resident(degs, rng)
        rows = rng.integers(-1, len(degs), size=1 << 20).astype(np.int32)
        return off, dst, rows, 1 << 21
    # light rows, and three long rows (5000, 3000, 2500) that cross tiles
    degs = _light(rng, 6000, 17)
    long_rows = np.array([100, 2000, 4000])
    degs[long_rows] = (5000, 3000, 2500)
    off, dst = _resident(degs, rng)
    light = np.nonzero((degs > 0) & (degs < 17))[0]

    def cum(rows):
        return np.cumsum(np.where(rows >= 0, degs[np.maximum(rows, 0)], 0))

    if name == "b1":
        return off, dst, np.array([light[7]], np.int32), 16
    if name == "b_ragged":
        # B not a multiple of any block's row range
        rows = rng.integers(-1, len(degs), size=3001).astype(np.int32)
        return off, dst, rows, 1 << int(cum(rows)[-1] - 1).bit_length()
    if name == "total_is_cap":
        rows = rng.integers(-1, len(degs), size=500).astype(np.int32)
        return off, dst, rows, int(cum(rows)[-1])
    if name == "cap_cuts_a_row":
        rows = rng.permutation(np.concatenate([light[:300], long_rows])).astype(np.int32)
        c = cum(rows)
        k = int(np.nonzero(degs[rows] >= 8)[0][150])
        return off, dst, rows, int(c[k] - degs[rows[k]] // 2)
    if name == "tile_starts_in_long_row":
        # about 700 slots of light rows, then the 5000-edge row: every tile
        # from the first boundary on starts inside it; light rows after
        rows = np.concatenate([light[:90], long_rows[:1], light[90:200]]).astype(np.int32)
        return off, dst, rows, 1 << int(cum(rows)[-1] - 1).bit_length()
    if name == "zero_and_skip_runs":
        # productive rows between runs of 300-700 zero-degree or skipped
        # rows: more than GATHER_WINDOW rows that own no slot
        zero = np.nonzero(degs == 0)[0]
        parts = []
        for p in light[:24]:
            run = rng.choice(zero, size=int(rng.integers(300, 701)))
            run[rng.random(len(run)) < 0.5] = -1
            parts += [np.array([p]), run]
        rows = np.concatenate(parts).astype(np.int32)
        return off, dst, rows, 1 << int(cum(rows)[-1] - 1).bit_length()
    if name == "all_skip":
        return off, dst, np.full(5000, -1, np.int32), 1024
    raise KeyError(name)


GATHER_CASES = ["b1", "b_ragged", "b_2_20", "total_is_cap", "cap_cuts_a_row",
                "tile_starts_in_long_row", "heavy_row", "zero_and_skip_runs",
                "all_skip"]
# the cases whose Pallas grid (one step per frontier row) runs short
# enough in interpret mode on a CPU; B 2^20 takes minutes there
GATHER_INTERPRET_MAX_B = 1 << 14


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
    if name == "B70000":
        # more batch rows than a grid's y axis holds (65,535): K 3, L 16
        # sorted-unique draws from [0, 24), SENT-padded
        mat = np.sort(rng.integers(0, 24, size=(70000, 3, 16)), axis=-1).astype(np.int32)
        mat[..., 1:][mat[..., 1:] == mat[..., :-1]] = SENT
        return np.sort(mat, axis=-1)
    raise KeyError(name)


INTERSECT_CASES = ["identical_full", "last_tile_only", "dense_row_j", "thin_L2_21",
                   "B1024", "B70000"]

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
