"""Multi-hop frontier expansion with the frontier kept on the device
(PyTorch port of ``expand_ascending`` and ``multi_hop`` of
``dgraph_tpu/ops/batch.py``).

- **`expand_ascending`**: CSR expansion of a row vector into a densely
  packed target vector (valid prefix, SENT tail) and the total degree.
  The reference telescopes a slot map with a scatter and a prefix sum;
  here it is the ``out`` half of the resident gather (``gather_packed``,
  the hand-written kernel on a CUDA tensor), which packs the same way.
- **`multi_hop`**: ``n_hops`` expansions back to back, each frontier
  deduplicated on the device and fed to the next hop, optionally as a
  level-synchronous BFS that drops visited uids.  The reference runs it
  as one ``lax.scan`` with donated carries; here it is a Python loop of
  device ops.  Every capacity is planned on the host beforehand, so no
  hop waits for the device: nothing in the loop reads a value back.

The reference's spans, device guard, failpoints and segmented dispatch
have no counterpart: a device fault propagates to the caller.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dgraph_tpu_torch import ops
from dgraph_tpu_torch.ops.sets import SENT, frontier_rows, member_mask, sort_unique


def lut_rows(lut: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Frontier uids -> arena rows through a dense uid->row table
    (``CSRArena.lut`` layout); -1 for padding, uids beyond the table and
    row-less uids."""
    n = lut.shape[0]
    ok = (f >= 0) & (f < n) & (f != SENT)
    return torch.where(ok, lut[f.clamp(0, n - 1)], -1)


def expand_ascending(
    offsets: torch.Tensor, dst: torch.Tensor, rows: torch.Tensor, cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """CSR expansion of ``rows`` (int32 arena rows, -1 skips) into a
    densely packed target vector.

    Returns (out int32[cap]: each row's targets in row order, then SENT;
    total int32: the rows' degree sum, which exceeds ``cap`` when the
    output truncates).  Unlike the reference the rows need not ascend."""
    out = ops.gather_packed(offsets, dst, rows, cap)[:cap]
    valid = rows >= 0
    r = torch.where(valid, rows, 0)
    deg = torch.where(valid, offsets[r + 1] - offsets[r], 0)
    return out, deg.sum(dtype=torch.int32)


def multi_hop(
    offsets: torch.Tensor,
    dst: torch.Tensor,
    frontier: torch.Tensor,
    visited: torch.Tensor,
    n_hops: int,
    cap: int,
    track_visited: bool = False,
    lut: Optional[torch.Tensor] = None,
):
    """``n_hops`` hops from ``frontier``, the frontier device-resident
    between them.

    Every hop has one capacity ``cap`` (the expansion width and the
    frontier width), planned by the caller from the worst hop.  Rows are
    the frontier uids themselves (dense arenas: row i == uid i) unless
    ``lut`` maps uid -> row (``CSRArena.lut``).  With ``track_visited``
    the walk is a level-synchronous BFS: each hop's frontier drops the
    uids already visited (the reachMap dedup of query/recurse.go:110-145)
    and joins the visited set.

    frontier: int32[cap] sorted-unique, SENT-padded; visited: int32[cap]
    (read only with ``track_visited``).  Returns (frontiers int32[n_hops,
    cap]: the deduplicated frontier each hop produced, edge counts
    int32[n_hops], the final visited int32[cap])."""
    f, vis = frontier, visited
    fs, totals = [], []
    for _ in range(n_hops):
        rows = frontier_rows(f) if lut is None else lut_rows(lut, f)
        out, total = expand_ascending(offsets, dst, rows, cap)
        f = sort_unique(out)
        if track_visited:
            f = torch.sort(torch.where(member_mask(f, vis), SENT, f)).values
            vis = sort_unique(torch.cat([vis, f]))[:cap]
        fs.append(f)
        totals.append(total)
    return torch.stack(fs), torch.stack(totals), vis
