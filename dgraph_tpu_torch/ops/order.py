"""Segmented order-by on the device (PyTorch port of
``dgraph_tpu/ops/order.py``).

Instead of fetching values per uid and sorting each uid-matrix row on
the host, the engine gathers *value ranks* from the predicate's
``ValueArena`` with one vectorized binary search and orders the whole
flattened uid matrix with one stable sort keyed on (segment, ±rank).

Ranks, not raw floats: the ValueArena stores each value's dense rank in
the sorted order of the exact float64 values, so the order is exact —
float32 rounding on the ``vals`` tensor can never swap two close keys.
Ties (equal values) keep their input order because the sort is stable,
matching the host path's stable ``sorted``.  Missing values (the uid has
no value for the predicate) sort last ascending and first descending,
like the host key ``(9,)`` under ``reverse=``.

Both functions are plain torch ops on the tensors' device: the
reference computes them in XLA outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from dgraph_tpu_torch.ops.sets import SENT

# larger than any rank or segment index; pushes padding to the tail
_BIG = 1 << 30


def gather_ranks(
    src: torch.Tensor, ranks: torch.Tensor, uids: torch.Tensor
) -> torch.Tensor:
    """Map uids → value ranks through the ValueArena's sorted ``src``
    column (int32, SENT-padded).  Returns int32[B]: -1 where the uid has
    no value or is padding (SENT)."""
    pos = torch.searchsorted(src, uids).clamp_(0, src.shape[0] - 1)
    hit = (src[pos] == uids) & (uids != SENT)
    return torch.where(hit, ranks[pos], -1)


def segmented_sort_perm(
    seg: torch.Tensor, ranks: torch.Tensor, desc: bool
) -> torch.Tensor:
    """Stable permutation ordering each segment by value rank.

    ``seg`` int32[cap]: segment id per slot, -1 = padding (sorts to the
    tail).  ``ranks`` int32[cap]: value rank per slot, -1 = missing.
    Returns int64[cap] ``p`` such that ``x[p]`` is grouped by segment
    (ascending), each segment ordered by rank (descending when ``desc``),
    missing values last ascending / first descending, ties in input
    order — the reference's ``lexsort((key, segk))`` as one stable sort
    of the composite int64 key ``segk << 32 | (key + _BIG)``."""
    r = ranks.to(torch.int64)
    if desc:
        key = torch.where(r < 0, -_BIG, -r)
    else:
        key = torch.where(r < 0, _BIG, r)
    s = seg.to(torch.int64)
    segk = torch.where(s < 0, _BIG, s)
    # key + _BIG lies in [0, 2^31], segk in [0, 2^30]: the composite
    # fits an int64 and orders (segk, key) lexicographically
    comp = (segk << 32) | (key + _BIG)
    return torch.sort(comp, stable=True).indices
