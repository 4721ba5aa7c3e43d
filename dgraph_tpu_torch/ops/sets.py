"""Sorted-set kernels over int32 uid tensors (PyTorch).

The port of ``dgraph_tpu/ops/sets.py``.  Same
representation (docs/sets-contract.md): a uid set is an int32 vector,
sorted ascending, padded with ``SENT`` (int32 max), so padding always
sorts last; row vectors use ``-1`` as the skip marker.  Every op returns
int32 tensors byte-equal to its JAX counterpart on the same inputs, on
whatever device the inputs live.

The grouped inline-head expansions take a batch of frontiers
``rows[Q, B]`` (the reference ``vmap``s its 1-D functions over queries;
here the batch dimension is written out) and equally a single
``rows[B]``; ``expand_chunked`` and ``expand_inline_seg`` take one
``rows[B]``, as the reference's do.  Their slot -> chunk maps are the
reference's scatter and prefix sums in torch ops, except
``expand_inline_seg``'s, which is the slot-map kernel's (``ops/slotmap.py``)
with Q = 1: the engine's inline route launches it on the card.  Their
32-byte row gathers (the metap and meta8 rows, the overflow chunks) are
the granule gather's (``ops/granules.py``), which launches its kernel on
a CUDA tensor.

Torch's ``cumsum``/``arange``/``searchsorted`` default to int64; every
call here names its dtype so results stay int32 like the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from dgraph_tpu_torch import obs
from dgraph_tpu_torch.ops.granules import gather_granules

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


def sort_desc_free(x: torch.Tensor) -> torch.Tensor:
    """Ascending value sort along the last axis (the reference's unstable
    bare-value sort: with values alone, stability is meaningless)."""
    return torch.sort(x, dim=-1).values



def compact(x: torch.Tensor) -> torch.Tensor:
    """Re-establish the invariant after masking: sort so SENT pads the tail."""
    return sort_desc_free(x)


def count_valid(x: torch.Tensor) -> torch.Tensor:
    """Number of non-padding entries (int32 scalar)."""
    return (x != SENT).sum(dtype=torch.int32)


def sort_unique(x: torch.Tensor) -> torch.Tensor:
    """Sort and deduplicate padded vectors along the last axis: sort,
    replace adjacent duplicates with SENT, re-sort (same shape as the
    input; a ``[Q, L]`` batch is Q independent vectors)."""
    x = sort_desc_free(x)
    dup = torch.zeros_like(x, dtype=torch.bool)
    dup[..., 1:] = x[..., 1:] == x[..., :-1]
    return sort_desc_free(torch.where(dup, SENT, x))


def member_mask(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Which entries of ``a`` are present in sorted-unique ``s`` (padding
    entries map to False) — a vectorized binary search."""
    pos = torch.searchsorted(s, a, out_int32=True).clamp(0, s.shape[0] - 1)
    return (s[pos] == a) & (a != SENT)


def intersect(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ∩ b for sorted-unique-padded sets (result shaped like ``a``)."""
    return sort_desc_free(torch.where(member_mask(a, b), a, SENT))


def difference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a \\ b for sorted-unique-padded sets."""
    keep = (~member_mask(a, b)) & (a != SENT)
    return sort_desc_free(torch.where(keep, a, SENT))


def union(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ∪ b, result capacity |a|+|b|."""
    return sort_unique(torch.cat([a, b]))


def _intersect_pairs(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise a ∩ b over [P, L] batches of sorted-UNIQUE rows: an
    element of the merged sort equal to its successor is in both sets."""
    z = sort_desc_free(torch.cat([a, b], dim=1))
    dup = torch.zeros_like(z, dtype=torch.bool)
    dup[:, :-1] = (z[:, :-1] == z[:, 1:]) & (z[:, :-1] != SENT)
    return sort_desc_free(torch.where(dup, z, SENT))[:, : a.shape[1]]


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


def mask_to_set(values: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Select ``values`` where ``keep``, as a sorted-unique-padded set."""
    return sort_unique(torch.where(keep, values, SENT))


def unique_dense(x: torch.Tensor, n_universe: int, cap: int) -> torch.Tensor:
    """Sort-free dedup for dense uid spaces: a presence mask over
    [0, n_universe], then its first ``cap`` set positions, ascending and
    SENT-padded (silently truncated beyond ``cap`` distinct values).
    Values outside [0, n_universe] (padding included) are dropped."""
    mask = torch.zeros(n_universe + 2, dtype=torch.bool, device=x.device)
    ok = (x >= 0) & (x <= n_universe)
    mask[torch.where(ok, x, n_universe + 1).to(torch.int64)] = True
    mask[n_universe + 1] = False
    idx = torch.nonzero(mask).reshape(-1).to(torch.int32)[:cap]
    out = torch.full((cap,), SENT, dtype=torch.int32, device=x.device)
    out[: idx.shape[0]] = idx
    return out


def unique_rows_sorted(x: torch.Tensor) -> torch.Tensor:
    """Deduplicate a padded uid vector into dense-arena row form without
    compaction: sort, then mark duplicates and padding -1 (the expansion
    kernels' skip marker); the result keeps the input's capacity."""
    x = sort_desc_free(x)
    first = torch.ones_like(x, dtype=torch.bool)
    first[..., 1:] = x[..., 1:] != x[..., :-1]
    return torch.where(first & (x != SENT), x, -1).to(torch.int32)


def range_rows(lo, hi, cap: int, device=None):
    """Row indices [lo, hi) as an int32[cap] vector, -1 padded, and the
    true count ``hi - lo`` (int32; above ``cap`` the vector truncated)."""
    lo = torch.as_tensor(lo, dtype=torch.int32, device=device)
    hi = torch.as_tensor(hi, dtype=torch.int32, device=lo.device)
    i = torch.arange(cap, dtype=torch.int32, device=lo.device)
    n = hi - lo
    return torch.where(i < n, lo + i, -1), n


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


def _ov_owner_map(cstart: torch.Tensor, productive: torch.Tensor,
                  capc: int) -> torch.Tensor:
    """Owner of each overflow chunk slot (1-D): the ordinal of the owning
    productive row by scatter + prefix sum, mapped back to its position
    in the row vector."""
    dev = cstart.device
    nrows = cstart.shape[0]
    slot = torch.where(productive, cstart, capc).clamp(max=capc).to(torch.int64)
    ivec = torch.zeros(capc + 1, dtype=torch.int32, device=dev)
    ivec[slot] = 1
    k = torch.cumsum(ivec[:capc], 0, dtype=torch.int32) - 1
    k_row = torch.cumsum(productive.to(torch.int32), 0, dtype=torch.int32) - 1
    pos_of_ord = torch.zeros(nrows + 1, dtype=torch.int32, device=dev)
    pos_of_ord[torch.where(productive, k_row, nrows).to(torch.int64)] = torch.arange(
        nrows, dtype=torch.int32, device=dev)
    return pos_of_ord[k.clamp(0, nrows - 1)]


CHUNK = 8  # chunk width in uids: 8 × int32 = 32 bytes, one aligned granule


def expand_chunked(
    meta8: torch.Tensor,
    chunk_dst: torch.Tensor,
    rows: torch.Tensor,
    capc: int,
    with_seg: bool = False,
):
    """Chunked CSR expansion over the chunk-packed layout
    (``CSRArena.chunked``): one row gather of CHUNK targets a slot.

    Args:
      meta8:     int32[Sb, 8] per-row (chunk_start, chunk_count, degree).
      chunk_dst: int32[NCb, CHUNK] chunk-packed targets, SENT pad lanes.
      rows:      int32[B] row ids, ascending over the valid entries, each
                 valid row distinct; -1 = skip (anywhere).
      capc:      chunk capacity of the output (silently truncates).
      with_seg:  also return the index into ``rows`` owning each slot.

    Returns (out int32[capc, CHUNK] SENT-padded, total int32 — the true
    edge count —, seg int32[capc] with -1 pad, or None)."""
    m = _row_gather(meta8, rows, 0)  # a skipped row all 0
    cs, cd = m[:, 0], m[:, 1]
    total = m[:, 2].sum(dtype=torch.int32)
    chunkid, ok, cstart, productive = _ov_slot_map(cs, cd, capc)
    out = gather_granules(chunk_dst, torch.where(ok, chunkid, -1), SENT)
    if not with_seg:
        return out, total, None
    seg = _ov_owner_map(cstart, productive, capc)
    return out, total, torch.where(ok, seg, -1)


def _row_gather(table: torch.Tensor, rows: torch.Tensor, fill: int) -> torch.Tensor:
    """A per-row table's rows (meta8, metap) by ``rows``, ``fill`` in every
    lane of a skipped row (< 0): one granule gather.  The arena's rows
    lie below the table's length by construction; the granule gather
    would read its last row for one past it, so a CPU tensor is checked
    (as the index gather raised) and the card, which cannot check
    without a host sync, relies on the construction."""
    if rows.device.type == "cpu" and rows.numel() and int(rows.max()) >= table.shape[0]:
        raise IndexError(f"row {int(rows.max())} is past the table's {table.shape[0]} rows")
    return gather_granules(table, rows, fill)


def _inline_gather(metap: torch.Tensor, rows: torch.Tensor):
    """One metap row gather per frontier row, a skipped row all SENT:
    (m[..., B, 8], valid, inline[..., B, INLINE], degree, total).  The
    inline lanes are the view ``m[..., 2:]``: their readers' strided
    reads cost the batched 2-hop less than a copy would."""
    valid = rows >= 0
    m = _row_gather(metap, rows, SENT)
    dg = torch.where(valid, m[..., 1], 0)
    return m, valid, m[..., 2:], dg, dg.sum(-1, dtype=torch.int32)


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
    return inline, gather_granules(ov_chunks, torch.where(ok, chunkid, -1), SENT), total


def expand_inline_grouped_kernel(
    metap: torch.Tensor,
    ov_chunks: torch.Tensor,
    rows: torch.Tensor,
    capc: int,
    pcap: int,
):
    """expand_inline_grouped with the overflow slot-map computed by the
    slot-map kernel (ops/slotmap.py, csrc/slotmap.cu) in place of the
    scatter/scan chain — the same outputs under the same invariants.

    Spans, each timed on ``rows``' device: ``expand.inline`` (the metap
    gather), ``expand.slotmap`` (the prefix and the kernel) and
    ``expand.overflow`` (the gather over every planned lane; attribute
    ``lanes``, Q·capc·8 from the shapes)."""
    from dgraph_tpu_torch.ops.slotmap import slotmap

    dev = rows.device
    with obs.child("expand.inline", device=dev):
        m, valid, inline, dg, total = _inline_gather(metap, rows)
    with obs.child("expand.slotmap", device=dev):
        cs, cd = _prefix_chunks(m, valid, dg, pcap)
        lead = cs.shape[:-1]
        cid = slotmap(
            cs.reshape(-1, cs.shape[-1]).contiguous(),
            cd.reshape(-1, cd.shape[-1]).contiguous(),
            capc,
        ).reshape(lead + (capc,))
    with obs.child("expand.overflow", device=dev) as sp:
        if sp.recording:
            sp.set_attr("lanes", cid.numel() * ov_chunks.shape[-1])
        ov = gather_granules(ov_chunks, cid, SENT)
    return inline, ov, total


def expand_inline_grouped_auto(
    metap: torch.Tensor,
    ov_chunks: torch.Tensor,
    rows: torch.Tensor,
    capc: int,
    pcap: int,
):
    """The grouped expansion that grouped-frontier consumers call (the
    reference's knob-dispatched seam): the slot-map kernel on a CUDA
    tensor, its plain version on a CPU tensor."""
    return expand_inline_grouped_kernel(metap, ov_chunks, rows, capc, pcap)


def expand_inline_seg(
    metap: torch.Tensor,
    ov_chunks: torch.Tensor,
    rows: torch.Tensor,
    capc: int,
):
    """Inline-head expansion of one frontier plus the owner of each
    overflow chunk: the engine's inline route.

    rows: int32[B] row ids, ascending-distinct over the valid entries, -1
    skips anywhere.  Returns (inline int32[B, INLINE], ov int32[capc, 8],
    total int32, ovseg int32[capc]) where ovseg[j] is the index into
    ``rows`` owning overflow chunk j, -1 on padding.  The slot -> chunk
    map is the slot-map kernel with Q = 1 (on a CUDA tensor it launches
    or raises; a CPU tensor runs its plain version): for ascending rows
    it equals the reference's scatter and prefix sums, and a row that
    owns no chunk (cd = 0, a skip among them) owns no slot in either."""
    from dgraph_tpu_torch.ops.slotmap import slotmap

    m, valid, inline, dg, total = _inline_gather(metap, rows)
    cs, cd = _prefix_chunks(m, valid, dg, rows.shape[-1])
    cid = slotmap(cs[None].contiguous(), cd[None].contiguous(), capc)[0]
    ccum = torch.cumsum(cd, 0, dtype=torch.int32)
    ovseg = _ov_owner_map(ccum - cd, cd > 0, capc)
    return (inline, gather_granules(ov_chunks, cid, SENT), total,
            torch.where(cid >= 0, ovseg, -1))


def expand_inline(
    metap: torch.Tensor,
    ov_chunks: torch.Tensor,
    rows: torch.Tensor,
    capc: int,
):
    """Inline-head expansion of ungrouped frontiers: the grouped
    expansion with the slot-map prefix spanning every row."""
    return expand_inline_grouped(metap, ov_chunks, rows, capc, rows.shape[-1])

