"""Delta repair of cached hop expansions — the segmented-array math
(copy of ``dgraph_tpu/ivm/repair.py``).

A tier-1 hop-cache entry is ``(out_flat, seg_ptr)`` for a frontier
``src``: targets grouped by frontier row, ascending within each group
(cache/hop.py).  A small uid-edge delta against the SAME predicate
changes that value in a purely local way — an added edge ``(s, d)``
inserts ``d`` into the segment of every row whose frontier uid is
``s``; a deleted edge removes it — so the entry can be repaired with
one ``np.delete`` + one ``np.insert`` pass instead of being dropped and
re-expanded on the next hit.  The result is byte-identical to
re-running the expansion over the post-delta arena: the CSR flat layout
is sorted by (row, dst), which is exactly the order the insert positions
reproduce.

Callers (models/arena.py → cache/hop.py) gate the work with
``query/planner.py::repair_route`` and only hand over deltas the store
journal vouches for: adds did not exist, deletes did.  A delete naming
an absent target means the entry does NOT reflect the pre-delta store —
``None`` tells the caller to drop it rather than guess.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def repair_hop_entry(
    out: np.ndarray,
    seg_ptr: np.ndarray,
    src: np.ndarray,
    adds: np.ndarray,
    dels: np.ndarray,
) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Apply ``adds``/``dels`` (int64[k, 2] (src, dst) pairs) to one
    cached expansion over frontier ``src``.  Returns the repaired
    ``(out, seg_ptr)`` — fresh arrays, the entry value is shared with
    readers and must never mutate in place — or None when the delta is
    inconsistent with the entry.  Delta edges whose source is not in
    the frontier are no-ops (the expansion never read that row)."""
    n = len(src)
    # uid → frontier rows (duplicates legal: ordered roots may repeat)
    order = np.argsort(src, kind="stable")
    ssrc = src[order]
    ins: list = []      # (original position, value, row)
    del_pos: list = []  # (original position, row)
    for arr, sign in ((dels, -1), (adds, +1)):
        for s, d in arr:
            lo = int(np.searchsorted(ssrc, s, side="left"))
            hi = int(np.searchsorted(ssrc, s, side="right"))
            for i in order[lo:hi]:
                i = int(i)
                a, b = int(seg_ptr[i]), int(seg_ptr[i + 1])
                j = a + int(np.searchsorted(out[a:b], d))
                if sign > 0:
                    ins.append((j, int(d), i))
                else:
                    if j >= b or int(out[j]) != d:
                        return None  # entry predates a state with (s, d)
                    del_pos.append((j, i))
    if not ins and not del_pos:
        return out, seg_ptr
    row_delta = np.zeros(n, dtype=np.int64)
    dp = np.array(sorted(p for p, _i in del_pos), dtype=np.int64)
    out2 = np.delete(out, dp) if len(dp) else np.asarray(out)
    for _p, i in del_pos:
        row_delta[i] -= 1
    if ins:
        # positions were computed against the ORIGINAL array: shift each
        # by the deletions before it, and keep (pos, value) order so
        # same-position inserts land ascending within their segment
        ins.sort(key=lambda t: (t[0], t[1]))
        pos = np.array([p for p, _v, _i in ins], dtype=np.int64)
        vals = np.array([v for _p, v, _i in ins], dtype=out.dtype)
        pos -= np.searchsorted(dp, pos, side="left")
        out2 = np.insert(out2, pos, vals)
        for _p, _v, i in ins:
            row_delta[i] += 1
    seg2 = np.asarray(seg_ptr).copy()
    seg2[1:] += np.cumsum(row_delta)
    return out2.astype(np.int64, copy=False), seg2
