"""Sorted-set kernels over int32 uid tensors (PyTorch).

The port of ``dgraph_tpu/ops/sets.py`` for the subset the 2-hop query
path calls.  Same representation (docs/sets-contract.md): a uid set is
an int32 vector, sorted ascending, padded with ``SENT`` (int32 max), so
padding always sorts last; row vectors use ``-1`` as the skip marker.
Every op returns int32 tensors byte-equal to its JAX counterpart on the
same inputs, on whatever device the inputs live.

Torch's ``cumsum``/``arange``/``searchsorted`` default to int64; every
call here names its dtype so results stay int32 like the reference.
"""

from __future__ import annotations

import numpy as np
import torch

# Padding sentinel: int32 max. Sorts after every valid uid.
SENT = (1 << 31) - 1


def bucket(n: int, floor: int = 8) -> int:
    """Round ``n`` up to a power of two (>= floor): bounds the number of
    distinct capacities (and kernel launch shapes) the engine produces."""
    b = floor
    while b < n:
        b <<= 1
    return b


def pad_to(x: np.ndarray, size: int, fill: int = SENT) -> np.ndarray:
    """Pad a host int array to ``size`` with ``fill`` (host-side helper)."""
    x = np.asarray(x, dtype=np.int32)
    out = np.full(size, fill, dtype=np.int32)
    out[: x.shape[0]] = x
    return out


def pad_rows(x: np.ndarray, size: int) -> np.ndarray:
    """Pad a host row-index array to ``size`` with -1 (the 'skip' marker
    expand_csr expects — NOT the SENT uid sentinel)."""
    return pad_to(x, size, fill=-1)


def _sort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, dim=-1).values


def count_valid(x: torch.Tensor) -> torch.Tensor:
    """Number of non-padding entries (int32 scalar)."""
    return (x != SENT).sum(dtype=torch.int32)


def sort_unique(x: torch.Tensor) -> torch.Tensor:
    """Sort and deduplicate a padded vector: sort, replace adjacent
    duplicates with SENT, re-sort (same length as the input)."""
    x = _sort(x)
    dup = torch.zeros_like(x, dtype=torch.bool)
    dup[1:] = x[1:] == x[:-1]
    return _sort(torch.where(dup, SENT, x))


def member_mask(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Which entries of ``a`` are present in sorted-unique ``s`` (padding
    entries map to False) — a vectorized binary search."""
    pos = torch.searchsorted(s, a, out_int32=True).clamp(0, s.shape[0] - 1)
    return (s[pos] == a) & (a != SENT)


def intersect(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ∩ b for sorted-unique-padded sets (result shaped like ``a``)."""
    return _sort(torch.where(member_mask(a, b), a, SENT))


def difference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a \\ b for sorted-unique-padded sets."""
    keep = (~member_mask(a, b)) & (a != SENT)
    return _sort(torch.where(keep, a, SENT))


def union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ∪ b, result capacity |a|+|b|."""
    return sort_unique(torch.cat([a, b]))


def _intersect_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise a ∩ b over [P, L] batches of sorted-UNIQUE rows: an
    element of the merged sort equal to its successor is in both sets."""
    z = _sort(torch.cat([a, b], dim=1))
    dup = torch.zeros_like(z, dtype=torch.bool)
    dup[:, :-1] = (z[:, :-1] == z[:, 1:]) & (z[:, :-1] != SENT)
    return _sort(torch.where(dup, z, SENT))[:, : a.shape[1]]


def intersect_many(mat: torch.Tensor) -> torch.Tensor:
    """Intersect the K rows of a [K, L] padded matrix as a log-depth tree
    reduction (rows pair off each round; an odd round duplicates the last
    row, a no-op for intersection)."""
    while mat.shape[0] > 1:
        if mat.shape[0] % 2:
            mat = torch.cat([mat, mat[-1:]])
        mat = _intersect_pairs(mat[0::2], mat[1::2])
    return mat[0]


def union_many(mat: torch.Tensor) -> torch.Tensor:
    """Union of the K rows of a [K, L] padded matrix (one flat sort)."""
    return sort_unique(mat.reshape(-1))


def rows_of(src: torch.Tensor, uids: torch.Tensor) -> torch.Tensor:
    """Map uids to arena row indices via the sorted ``src`` column;
    int32[B], -1 where the uid has no row (or is padding)."""
    pos = torch.searchsorted(src, uids, out_int32=True).clamp(
        0, src.shape[0] - 1
    )
    hit = (src[pos] == uids) & (uids != SENT)
    return torch.where(hit, pos, -1)


def expand_csr(
    offsets: torch.Tensor, dst: torch.Tensor, rows: torch.Tensor, cap: int
):
    """Batched posting-list gather (the staged, order-agnostic route).

    Args:
      offsets: int32[S+1] CSR row offsets of the arena.
      dst:     int32[E] packed target uids, ascending within each row.
      rows:    int32[B] arena row indices to expand; negative = skip.
      cap:     output capacity (bucketed total degree).

    Returns (out int32[cap], seg int32[cap], total int32): targets grouped
    by source in ``rows`` order, SENT-padded; seg = index into ``rows``
    that produced each slot, -1-padded; total = the true slot count
    (the output silently truncates at ``cap``).
    """
    dev = offsets.device
    if dst.shape[0] == 0 or rows.shape[0] == 0:
        return (
            torch.full((cap,), SENT, dtype=torch.int32, device=dev),
            torch.full((cap,), -1, dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.int32, device=dev),
        )
    valid = rows >= 0
    r = torch.where(valid, rows, 0)
    deg = torch.where(valid, offsets[r + 1] - offsets[r], 0)
    cum = torch.cumsum(deg, 0, dtype=torch.int32)
    total = cum[-1]
    start = cum - deg
    # owner of output slot i = the first row whose inclusive cumsum
    # exceeds i (zero-degree and skipped rows never own a slot)
    i = torch.arange(cap, dtype=torch.int32, device=dev)
    seg = torch.searchsorted(cum, i, right=True, out_int32=True).clamp(
        max=rows.shape[0] - 1
    )
    edge = offsets[r[seg]] + i - start[seg]
    ok = i < total
    out = torch.where(ok, dst[edge.clamp(0, dst.shape[0] - 1)], SENT)
    return out, torch.where(ok, seg, -1), total
