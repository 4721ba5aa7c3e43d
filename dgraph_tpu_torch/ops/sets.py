"""Sorted-set kernels over int32 uid tensors (PyTorch).

The port of ``dgraph_tpu/ops/sets.py`` for the subset the 2-hop query
path and the batched 2-hop pipeline (``bench2hop.py``) call.  Same
representation (docs/sets-contract.md): a uid set is an int32 vector,
sorted ascending, padded with ``SENT`` (int32 max), so padding always
sorts last; row vectors use ``-1`` as the skip marker.  Every op returns
int32 tensors byte-equal to its JAX counterpart on the same inputs, on
whatever device the inputs live.

The inline-head expansions take a batch of frontiers ``rows[Q, B]`` (the
reference ``vmap``s its 1-D functions over queries; here the batch
dimension is written out) and equally a single ``rows[B]``.

Torch's ``cumsum``/``arange``/``searchsorted`` default to int64; every
call here names its dtype so results stay int32 like the reference.
"""

from __future__ import annotations

import numpy as np
import torch

# Padding sentinel: int32 max. Sorts after every valid uid.
SENT = (1 << 31) - 1

INLINE = 6  # inline posting-head lanes in the meta-plus row (32B granule)

# Grouped (skey) coding for inline arenas: stored target ids carry a
# "no-overflow" bit above the uid, so one value sort groups the rows WITH
# overflow chunks into an ascending prefix and the slot-map runs on that
# prefix alone.  uid < 2^29: the largest skey, (2^29 - 1) | 2^29 =
# 2^30 - 1, stays below SENT, so padding still sorts strictly last.
GROUP_BIT = 29
GROUP_MASK = (1 << GROUP_BIT) - 1


def bucket(n: int, floor: int = 8) -> int:
    """Round ``n`` up to a power of two (>= floor): bounds the number of
    distinct capacities (and kernel launch shapes) the engine produces."""
    b = floor
    while b < n:
        b <<= 1
    return b


def bucket_fine(n: int, floor: int = 8) -> int:
    """Round ``n`` up to a 1/8-step of a power of two (>= floor): at most
    12.5 % waste, for long batches served at one capacity."""
    if n <= floor:
        return floor
    k = (int(n) - 1).bit_length() - 1
    base = 1 << k
    step = max(1, base >> 3)
    return base + -(-(n - base) // step) * step


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
    """Sort and deduplicate padded vectors along the last axis: sort,
    replace adjacent duplicates with SENT, re-sort (same shape as the
    input; a ``[Q, L]`` batch is Q independent vectors)."""
    x = _sort(x)
    dup = torch.zeros_like(x, dtype=torch.bool)
    dup[..., 1:] = x[..., 1:] == x[..., :-1]
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


# -- inline-head layout: grouped expansion and its slot-map ------------------


def skey_encode(uids: np.ndarray, has_ov: np.ndarray) -> np.ndarray:
    """Host-side: pack uid + no-overflow group bit (see GROUP_BIT)."""
    return (uids | (np.where(has_ov, 0, 1) << GROUP_BIT)).astype(np.int32)


def skey_uid(v: torch.Tensor) -> torch.Tensor:
    """Decode a packed skey lane to its uid; SENT passes through."""
    return torch.where(v == SENT, SENT, v & GROUP_MASK)


def frontier_rows(f: torch.Tensor) -> torch.Tensor:
    """Frontier uids -> row indices for a *dense* arena (row i == uid i):
    just map padding to the skip marker."""
    return torch.where(f == SENT, -1, f).to(torch.int32)


def _ov_slot_map(cs: torch.Tensor, cd: torch.Tensor, capc: int):
    """Overflow slot -> chunk map over the last axis, as scatter + prefix
    sums (the reference's XLA chain): returns (chunkid[..., capc],
    ok[..., capc], cstart, productive).  The chunk-id offset of each
    productive row is scattered at its first slot, telescoped against the
    running max of earlier rows' chunk ends, and one cumsum spreads it."""
    ccum = torch.cumsum(cd, -1, dtype=torch.int32)
    cstart = ccum - cd
    productive = cd > 0
    end = torch.where(productive, cs + cd, 0)
    pe = torch.zeros_like(end)
    pe[..., 1:] = torch.cummax(end, -1).values[..., :-1]
    # non-productive rows and starts past capc land in a spare column
    slot = torch.where(productive, cstart, capc).clamp(max=capc).to(torch.int64)
    dvec = torch.zeros(cs.shape[:-1] + (capc + 1,), dtype=torch.int32,
                       device=cs.device)
    dvec.scatter_(-1, slot, torch.where(productive, cs - pe, 0))
    i = torch.arange(capc, dtype=torch.int32, device=cs.device)
    chunkid = torch.cumsum(dvec[..., :capc], -1, dtype=torch.int32) + i
    total = cd.sum(-1, keepdim=True, dtype=torch.int32)
    return chunkid, i < total, cstart, productive


def _inline_gather(metap: torch.Tensor, rows: torch.Tensor):
    """One metap row gather per frontier row: (m[..., B, 8], valid,
    inline[..., B, INLINE], degree, total)."""
    valid = rows >= 0
    m = metap[torch.where(valid, rows, 0)]
    inline = torch.where(valid[..., None], m[..., 2:], SENT)
    dg = torch.where(valid, m[..., 1], 0)
    return m, valid, inline, dg, dg.sum(-1, dtype=torch.int32)


def _prefix_chunks(m, valid, dg, pcap: int):
    """(cs, cd) of the slot-map prefix ``rows[..., :pcap]``: each row's
    first overflow chunk and its overflow chunk count."""
    vp = valid[..., :pcap]
    cs = torch.where(vp, m[..., :pcap, 0], 0)
    cd = (torch.clamp(torch.where(vp, dg[..., :pcap], 0) - INLINE, min=0) + 7) >> 3
    return cs, cd


def ov_slotmap_inputs(metap: torch.Tensor, rows: torch.Tensor, pcap: int):
    """The slot-map's inputs ``(cs, cd)`` for a grouped expansion of
    ``rows`` (what the kernel receives; for holding it against its plain
    version at the pipeline's real shapes)."""
    m, valid, _inline, dg, _total = _inline_gather(metap, rows)
    return _prefix_chunks(m, valid, dg, pcap)


def _ov_rows(ov_chunks: torch.Tensor, chunkid: torch.Tensor, ok: torch.Tensor):
    nc = ov_chunks.shape[0]
    ov = ov_chunks[torch.where(ok, chunkid, 0).clamp(0, nc - 1)]
    return torch.where(ok[..., None], ov, SENT)


def expand_inline_grouped(
    metap: torch.Tensor,
    ov_chunks: torch.Tensor,
    rows: torch.Tensor,
    capc: int,
    pcap: int,
):
    """Inline-head expansion over GROUP-ORDERED frontiers: every row with
    overflow chunks sits in ``rows[..., :pcap]`` (what sorting skey-coded
    values produces — see skey_encode).  The metadata gather covers every
    row (inline lanes); the overflow slot-map runs on the prefix only.

    Layout (CSRArena.inline_layout): metap int32[S, 8] — lane0 = first
    overflow chunk, lane1 = degree, lanes 2..7 = the first INLINE targets
    (SENT pad); ov_chunks int32[NCov, 8] — targets INLINE.. of each row,
    8 per chunk.

    Args:
      rows: int32[Q, B] (or [B]) row ids, ascending-distinct within each
            group, -1 skips; rows beyond pcap have degree <= INLINE.
      capc: overflow-chunk capacity (the output silently truncates).
    Returns (inline int32[Q, B, INLINE], ov int32[Q, capc, 8], total
    int32[Q]), SENT-padded; targets carry whatever coding the layout
    stores (decode grouped layouts with skey_uid)."""
    m, valid, inline, dg, total = _inline_gather(metap, rows)
    cs, cd = _prefix_chunks(m, valid, dg, pcap)
    chunkid, ok, _cstart, _productive = _ov_slot_map(cs, cd, capc)
    return inline, _ov_rows(ov_chunks, chunkid, ok), total


def expand_inline_grouped_kernel(
    metap: torch.Tensor,
    ov_chunks: torch.Tensor,
    rows: torch.Tensor,
    capc: int,
    pcap: int,
):
    """expand_inline_grouped with the overflow slot-map computed by the
    slot-map kernel (ops/slotmap.py, csrc/slotmap.cu) in place of the
    scatter/scan chain — the same outputs under the same invariants."""
    from dgraph_tpu_torch.ops.slotmap import slotmap

    m, valid, inline, dg, total = _inline_gather(metap, rows)
    cs, cd = _prefix_chunks(m, valid, dg, pcap)
    lead = cs.shape[:-1]
    cid = slotmap(
        cs.reshape(-1, cs.shape[-1]).contiguous(),
        cd.reshape(-1, cd.shape[-1]).contiguous(),
        capc,
    ).reshape(lead + (capc,))
    return inline, _ov_rows(ov_chunks, cid, cid >= 0), total


def expand_inline(
    metap: torch.Tensor,
    ov_chunks: torch.Tensor,
    rows: torch.Tensor,
    capc: int,
):
    """Inline-head expansion of ungrouped frontiers: the grouped
    expansion with the slot-map prefix spanning every row."""
    return expand_inline_grouped(metap, ov_chunks, rows, capc, rows.shape[-1])

