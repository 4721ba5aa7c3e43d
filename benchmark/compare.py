"""The comparison that decides ``correct``.

Every query the window completed is held to the reference: its edge
count (hop 1's plus hop 2's) and its int32 checksum of hop 2's targets.
A sample of the last batch's rows, drawn from the seed with the batch's
heaviest query in it, is held whole: the set of hop-2 targets decoded
from the lanes the program returned, and the count of those lanes that
hold a target.  Each number is a count of differences, and its limit is
0: the answers are exact.
"""

from __future__ import annotations

import sys
from typing import Dict, Sequence, Tuple

import numpy as np

from benchmark import reference

LIMITS = {
    "count_mismatch": 0,     # completed queries whose edge count differs
    "checksum_mismatch": 0,  # completed queries whose checksum differs
    "set_mismatch": 0,       # sampled queries whose hop-2 target set differs
    "lane_gap": 0,           # |target lanes returned - hop-2 edges| over the sample
}


def compare(csr: reference.Csr, pool: Sequence[np.ndarray],
            ref: Tuple[np.ndarray, np.ndarray, np.ndarray],
            done: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
            sampled: Sequence[Tuple[int, np.ndarray, int]]):
    """``done``: (pool indices, counts, checksums) of each completed batch;
    ``sampled``: (pool index, hop-2 target set, target lanes) of each
    sampled row.  Returns (checks, failed queries)."""
    c1, c2, chk = ref
    edges = c1 + c2
    bad_count = bad_chk = failed = 0
    for idx, cnt, got in done:
        wc = cnt.astype(np.int64) != edges[idx]
        wk = got != chk[idx]
        bad_count += int(wc.sum())
        bad_chk += int(wk.sum())
        failed += int((wc | wk).sum())
    bad_set = lane_gap = 0
    for i, got_set, lanes in sampled:
        _n, _k, want = reference.two_hop_set(csr, pool[i])
        bad_set += int(not np.array_equal(got_set, want))
        lane_gap += abs(int(lanes) - int(c2[i]))
    values = {"count_mismatch": bad_count, "checksum_mismatch": bad_chk,
              "set_mismatch": bad_set, "lane_gap": lane_gap}
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}
    return checks, failed


def is_correct(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def print_checks(checks: Dict[str, dict]) -> None:
    """Each compared number beside its limit, the last lines of stderr."""
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
