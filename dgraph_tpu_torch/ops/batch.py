"""Batched set ops, fused hops and degree-classed hop programs (the
PyTorch port of ``dgraph_tpu/ops/batch.py``).  The reference computes
all of them in XLA; here they are torch ops, except where a hop goes
through the resident gather (``expand_ascending``).

- **Rowwise set ops** (`intersect_batch`, `difference_batch`,
  `union_many_batch`, `member_mask_batch`, `sort_unique_batch`): the
  ``[B, L]`` forms of the sorted-unique-padded set ops, B independent
  sets a call.
- **`expand_filter_compact`** (and its ``[B, R]`` batch): expand →
  keep-set filters → sort-unique in one call; the raw edge count is
  returned beside the frontier.
- **`ClassedExpander`**: rows partitioned on the host by
  ⌈log2(degree)⌉; class c expands as one 2-D gather
  ``dst[o0[:, None] + iota(2^c)]`` masked by degree, rows above
  ``2^LOG_W_MAX`` through `expand_ascending` (the residual bucket).
  Its plans (capacity tuple, mode) are cached per expander;
  capacities are bucketed, so a steady workload builds a handful.  The
  engine's ``classed`` route (``expand_rows``) and the batched 2-hop's
  host-dedup arm (``bench2hop.run_host_dedup``) run on it.
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

Where ``segments.plan`` returns k > 0, a scheduler yield point
(``segments.seam``: cancellation, preemption) sits between every k hops,
the reference's segmented dispatch.  A sampled request records the
whole pass as one ``multi_hop`` span (or one ``multi_hop_seg`` span a
segment), with its hops, capacity and ``device_sync_ms``, the wait for
the pass's results on a CUDA event.  Each segment runs under the device
guard (utils/devguard.py, failpoint site ``device.multi_hop``) and ends
with a sync on its results, so a fault raises ``DeviceFaultError`` from
the guard that launched it; the seams sit between the guarded segments.
The callers (the fused chain and the fused recurse) decline to their
per-level route on an out-of-memory fault and let every other fault
propagate.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dgraph_tpu_torch import ops
from dgraph_tpu_torch.ops.sets import (
    SENT, bucket, bucket_fine, frontier_rows, member_mask, sort_unique,
)
from dgraph_tpu_torch.utils.planconfig import class_w_max

# widest per-row gather class: rows with degree above 2^LOG_W_MAX go to
# the residual bucket (a few celebrity rows must not force a huge class
# matrix on everyone).  Bound once, at import, as in the reference: the
# split shapes every plan (DGRAPH_TPU_CLASS_W_MAX)
LOG_W_MAX = class_w_max()


# -- rowwise set ops ----------------------------------------------------------


def member_mask_batch(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """[B, L] probed against sorted-unique [B, Ls], row by row (padding
    entries map to False)."""
    pos = torch.searchsorted(s, a, out_int32=True).clamp(0, s.shape[-1] - 1)
    return (s.gather(-1, pos.to(torch.int64)) == a) & (a != SENT)


def intersect_batch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, L] ∩ [B, Ls] rowwise (result shaped like ``a``)."""
    return torch.sort(torch.where(member_mask_batch(a, b), a, SENT), -1).values


def difference_batch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, L] \\ [B, Ls] rowwise."""
    keep = (~member_mask_batch(a, b)) & (a != SENT)
    return torch.sort(torch.where(keep, a, SENT), -1).values


def union_many_batch(mat: torch.Tensor) -> torch.Tensor:
    """[B, K, L] → [B, K*L]: the K-way union of each batch row."""
    return sort_unique(mat.reshape(mat.shape[0], -1))


def sort_unique_batch(x: torch.Tensor) -> torch.Tensor:
    """Rowwise sort + dedup of a [B, L] batch."""
    return sort_unique(x)


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


def expand_filter_compact(
    offsets: torch.Tensor,
    dst: torch.Tensor,
    rows: torch.Tensor,
    cap: int,
    keeps: Tuple[torch.Tensor, ...] = (),
    cap_out: Optional[int] = None,
):
    """One hop: expansion → keep-set filters → sort-unique.

    ``keeps`` are sorted-unique-padded uid sets (one per fused filter
    predicate), applied before the dedup.  Returns (frontier
    int32[cap_out or cap] sorted-unique-padded, total int32 — the raw
    edge count BEFORE filtering)."""
    out, total = expand_ascending(offsets, dst, rows, cap)
    for k in keeps:
        out = torch.where(member_mask(out, k), out, SENT)
    u = sort_unique(out)
    if cap_out is not None:
        u = u[:cap_out]
    return u, total


def expand_filter_compact_batch(
    offsets: torch.Tensor,
    dst: torch.Tensor,
    rows: torch.Tensor,
    cap: int,
    keeps: Tuple[torch.Tensor, ...] = (),
    cap_out: Optional[int] = None,
):
    """[B, R] rows → ([B, cap_out or cap] frontiers, [B] totals), each
    row as ``expand_filter_compact`` (the keeps shared by the batch)."""
    res = [expand_filter_compact(offsets, dst, r, cap, keeps, cap_out)
           for r in rows]
    return torch.stack([u for u, _ in res]), torch.stack([t for _, t in res])


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
    from dgraph_tpu_torch import obs
    from dgraph_tpu_torch.sched import segments
    from dgraph_tpu_torch.utils import devguard
    from dgraph_tpu_torch.utils.failpoints import fail

    k = segments.plan(n_hops, cap, "multi_hop")
    if not 0 < k < n_hops:
        k = n_hops
    # sampled requests record each dispatched segment as ONE span (the
    # whole pass when unsegmented); unsampled: no span
    sp = obs.current_span()
    name = "multi_hop" if k == n_hops else "multi_hop_seg"
    guarded = devguard.enabled()

    def _dispatch(f, vis, hops):
        fail.point("device.multi_hop")
        fs_seg, tot_seg = [], []
        for _ in range(hops):
            rows = frontier_rows(f) if lut is None else lut_rows(lut, f)
            out, total = expand_ascending(offsets, dst, rows, cap)
            f = sort_unique(out)
            if track_visited:
                f = torch.sort(
                    torch.where(member_mask(f, vis), SENT, f)
                ).values
                vis = sort_unique(torch.cat([vis, f]))[:cap]
            fs_seg.append(f)
            tot_seg.append(total)
        # under the guard the sync sits inside the watchdog bracket: a
        # wedged or faulted pass surfaces here, on the guard's worker,
        # not at the caller's later fetch
        sync_ms = (
            obs.block_ready_ms((f, tot_seg[-1], vis))
            if sp is not None or guarded else None
        )
        return fs_seg, tot_seg, f, vis, sync_ms

    guard = devguard.get()
    f, vis = frontier, visited
    fs, totals = [], []
    for lo in range(0, n_hops, k):
        if lo:
            segments.seam("multi_hop")
        hops = min(k, n_hops - lo)
        ms = obs.NOOP if sp is None else sp.child(name)
        with ms:
            fs_seg, tot_seg, f, vis, sync_ms = guard.run(
                "device.multi_hop",
                lambda f=f, vis=vis, hops=hops: _dispatch(f, vis, hops),
            )
            fs += fs_seg
            totals += tot_seg
            if sp is not None:
                ms.set_attr("hops", int(hops))
                ms.set_attr("cap", int(cap))
                ms.set_attr("track_visited", bool(track_visited))
                ms.set_attr("device_sync_ms", round(sync_ms, 3))
    return torch.stack(fs), torch.stack(totals), vis


# -- degree-classed hop programs ----------------------------------------------


# two's-complement int32 wraparound: the sign bit and the modulus (an
# arithmetic identity, not a route gate)
_INT32_SIGN = 1 << 31
_UINT32_MOD = 1 << 32


def wrap_int32(s: torch.Tensor) -> torch.Tensor:
    """int64 sums -> int32 modulo 2^32, signed (the reference's int32
    wraparound sum, ``jnp.sum(dtype=int32)``)."""
    s = s & (_UINT32_MOD - 1)
    return torch.where(s >= _INT32_SIGN, s - _UINT32_MOD, s).to(torch.int32)


class ClassedExpander:
    """Scatter- and sort-free hop plans over one CSR arena.

    On the host, rows partition by degree class (``partition``); on the
    device, each class is one 2-D gather masked by degree.  Plans cache
    per (capacity tuple, mode) in ``_programs`` (one plan serves a
    frontier and a [B, ...] batch of them alike); capacities are
    bucketed (pow2 per query on the engine's path, ``bucket_fine`` for
    one stream-wide plan), so the cache stays small.

    Built once per arena from its device tensors and host offsets."""

    def __init__(self, offsets: torch.Tensor, dst: torch.Tensor,
                 h_offsets: np.ndarray):
        self.offsets = offsets
        self.dst = dst
        self.h_deg = np.asarray(h_offsets[1:] - h_offsets[:-1], dtype=np.int64)
        maxdeg = int(self.h_deg.max()) if len(self.h_deg) else 0
        self.n_cls = min(
            max(1, int(np.ceil(np.log2(max(2, maxdeg)))) + 1), LOG_W_MAX + 1
        )
        self.widths = [1 << c for c in range(self.n_cls)]
        self._programs: Dict[tuple, object] = {}

    # -- host planning --------------------------------------------------------

    def cls_of(self, deg: np.ndarray) -> np.ndarray:
        """Class index per degree: ⌈log2(deg)⌉ clamped to the class count;
        degree above 2^LOG_W_MAX means class n_cls (heavy)."""
        deg = np.asarray(deg)
        c = np.zeros(deg.shape, np.int64)
        for t in range(self.n_cls - 1):
            c += deg > (1 << t)
        if self.n_cls == LOG_W_MAX + 1:  # heavy rows possible
            c = np.where(deg > (1 << (self.n_cls - 1)), self.n_cls, c)
        return c

    def class_sort(self, rows: np.ndarray):
        """Stable class partition of a row vector: (rows class-major,
        ascending within a class; int64[n_cls+2] class boundaries;
        their degrees; their positions in the input).  Negative and
        degree-0 rows drop."""
        rows = np.asarray(rows)
        pos0 = np.arange(len(rows))
        keep = rows >= 0
        rows, pos0 = rows[keep], pos0[keep]
        deg = self.h_deg[rows]
        keep = deg > 0
        rows, pos0, deg = rows[keep], pos0[keep], deg[keep]
        c = self.cls_of(deg)
        order = np.argsort(c, kind="stable")
        counts = np.bincount(c, minlength=self.n_cls + 1)
        starts = np.zeros(self.n_cls + 2, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        return rows[order], starts, deg[order], pos0[order]

    def class_counts(self, rows: np.ndarray):
        """(per-class row counts, heavy row count, heavy edge total) of
        one frontier: ``plan_caps``'s inputs.  Negative rows skip."""
        rows = np.asarray(rows)
        deg = self.h_deg[rows[rows >= 0]]
        deg = deg[deg > 0]
        c = self.cls_of(deg)
        counts = np.bincount(c, minlength=self.n_cls + 1)
        n_heavy = int(counts[self.n_cls])
        heavy_edges = int(deg[c == self.n_cls].sum()) if n_heavy else 0
        return counts[: self.n_cls], n_heavy, heavy_edges

    def plan_caps(self, counts, n_heavy: int, heavy_edges: int,
                  fine: bool = True) -> tuple:
        """Bucket per-class row counts (and the heavy bucket) into the
        capacity tuple that keys a plan.  ``fine``: 1/8-step buckets, for
        one plan serving a long stream (the bench); per-query planning
        (the engine) must pass ``fine=False`` (pow2), or the cache grows
        with every frontier."""
        b = bucket_fine if fine else bucket
        caps = tuple(int(b(max(1, int(c)), floor=8)) for c in counts)
        hr = int(bucket(max(1, n_heavy), floor=8)) if n_heavy else 0
        he = int(b(max(1, heavy_edges))) if n_heavy else 0
        return caps + (hr, he)

    def partition(self, rows: np.ndarray, caps: tuple):
        """Split a row vector into per-class -1-padded int32 mats and the
        heavy-row mat; returns (mats, positions): positions[c] = each
        class row's index in the input."""
        rs, starts, _deg, pos = self.class_sort(rows)
        mats, positions = [], []
        for k in range(self.n_cls + 1):
            m = np.full(max(caps[k], 1) if k == self.n_cls else caps[k], -1,
                        dtype=np.int32)
            lo, hi = int(starts[k]), int(starts[k + 1])
            m[: hi - lo] = rs[lo:hi]
            mats.append(m)
            positions.append(pos[lo:hi])
        return tuple(mats), positions

    # -- device plans ---------------------------------------------------------

    def _build(self, caps: tuple, mode: str):
        offsets, dst = self.offsets, self.dst
        n_cls, widths = self.n_cls, self.widths
        he_cap = caps[n_cls + 1]
        last = dst.shape[0] - 1

        def run(mats, keeps):
            # mats: per class int32[cap] ([B, cap] batched), -1 pad
            lead = mats[0].shape[:-1]
            dev = offsets.device
            total = torch.zeros(lead, dtype=torch.int32, device=dev)
            chk = torch.zeros(lead, dtype=torch.int64, device=dev)
            parts = []
            for k in range(n_cls):
                r = mats[k]
                lv = r >= 0
                uc = torch.where(lv, r, 0)
                o0 = offsets[uc]
                dg = torch.where(lv, offsets[uc + 1] - o0, 0)
                iot = torch.arange(widths[k], dtype=torch.int32, device=dev)
                vals = dst[(o0[..., None] + iot).clamp(0, last)]
                vals = torch.where(iot < dg[..., None], vals, SENT)
                total = total + dg.sum(-1, dtype=torch.int32)
                for s in keeps:
                    vals = torch.where(member_mask(vals, s), vals, SENT)
                if mode == "checksum":
                    chk = chk + torch.where(vals == SENT, 0, vals).sum(
                        (-2, -1), dtype=torch.int64)
                else:
                    parts.append(vals.reshape(lead + (-1,)))
            if he_cap:
                hm = mats[n_cls]
                res = [expand_ascending(offsets, dst, h, he_cap)
                       for h in hm.reshape(-1, hm.shape[-1])]
                hout = torch.stack([o for o, _ in res]).reshape(lead + (he_cap,))
                total = total + torch.stack([t for _, t in res]).reshape(lead)
                for s in keeps:
                    hout = torch.where(member_mask(hout, s), hout, SENT)
                if mode == "checksum":
                    chk = chk + torch.where(hout == SENT, 0, hout).sum(
                        -1, dtype=torch.int64)
                else:
                    parts.append(hout)
            if mode == "checksum":
                return wrap_int32(chk), total
            lanes = torch.cat(parts, -1)
            if mode == "frontier":
                return sort_unique(lanes), total
            return lanes, total

        return run

    def program(self, caps: tuple, mode: str = "materialize"):
        """Fetch-or-build the hop plan for a capacity tuple.

        mode: "materialize" (flat SENT-masked lanes + edge total — the
        engine's matrix source), "frontier" (sorted-unique next frontier
        + total), or "checksum" (int32 wraparound sum of produced uids +
        total).  A plan takes (mats, keeps): the class mats of
        ``partition`` as int32 tensors on the arena's device ([cap], or
        [B, cap] each for a batch of B frontiers) and a tuple of
        keep-sets."""
        key = (caps, mode)
        p = self._programs.get(key)
        if p is None:
            p = self._build(caps, mode)
            self._programs[key] = p
        return p

    def lanes_of(self, caps: tuple) -> int:
        """Flat lane count of a materialize-mode output for ``caps``."""
        return sum(
            caps[c] * self.widths[c] for c in range(self.n_cls)
        ) + caps[self.n_cls + 1]

    # -- single-frontier expansion (the engine's classed route) ---------------

    def expand_rows(self, rows: np.ndarray, degs: np.ndarray):
        """One-plan expansion of an ascending-distinct row vector into
        the engine's (out_flat int64, seg_ptr int64) uid-matrix layout:
        one upload of the class mats, one fetch, reassembly on the host
        from the known per-row degrees.  A sampled request records it as
        a ``hop.program`` span (rows, heavy rows, caps, device_sync_ms)."""
        from dgraph_tpu_torch import obs

        sp = obs.current_span()
        if sp is None:
            return self._expand_rows(rows, degs, None)
        with sp.child("hop.program") as hs:
            return self._expand_rows(rows, degs, hs)

    def _expand_rows(self, rows: np.ndarray, degs: np.ndarray, span):
        counts, n_heavy, heavy_edges = self.class_counts(rows)
        caps = self.plan_caps(counts, n_heavy, heavy_edges, fine=False)
        mats, positions = self.partition(rows, caps)
        dev = self.offsets.device
        lanes_dev, _total = self.program(caps, mode="materialize")(
            tuple(torch.from_numpy(m).to(dev) for m in mats), ())
        if span is not None:
            from dgraph_tpu_torch import obs

            span.set_attr("rows", int(len(rows)))
            span.set_attr("heavy_rows", int(n_heavy))
            span.set_attr("caps", [int(c) for c in caps])
            span.set_attr("device_sync_ms",
                          round(obs.block_ready_ms(lanes_dev), 3))
        # the classed pass's one fetch, unguarded as the reference's
        # np.asarray (ops/batch.py); sampled, block_ready_ms above already
        # waited
        # graftlint: ignore[naked-device-sync]
        lanes = lanes_dev.cpu().numpy()
        degs = np.asarray(degs)
        seg_ptr = np.zeros(len(rows) + 1, dtype=np.int64)
        np.cumsum(np.where(degs > 0, degs, 0), out=seg_ptr[1:])
        out_flat = np.empty(int(seg_ptr[-1]), dtype=np.int64)
        off = 0
        for k in range(self.n_cls + 1):
            p = positions[k]
            if k < self.n_cls:
                w = self.widths[k]
                blk = lanes[off: off + caps[k] * w].reshape(caps[k], w)
                off += caps[k] * w
                if not len(p):
                    continue
                d = degs[p]
                vals = blk[: len(p)][np.arange(w)[None, :] < d[:, None]]
            else:
                blk = lanes[off: off + caps[self.n_cls + 1]]
                if not len(p):
                    continue
                d = degs[p]
                vals = blk[: int(d.sum())]
            # this class's per-row runs to their frontier slots
            within = np.arange(int(d.sum())) - np.repeat(np.cumsum(d) - d, d)
            out_flat[np.repeat(seg_ptr[p], d) + within] = vals
        return out_flat, seg_ptr


def classed_for_arena(arena) -> ClassedExpander:
    """The arena's ClassedExpander, built lazily and owned by the arena
    (``CSRArena._classed``: dropped with its plans on a delta, counted by
    ``ArenaManager.residency``).  Rebuilt when the staged device tensors
    were re-uploaded since it was built."""
    arena.ensure_device()
    ce = arena._classed
    if ce is None or ce.offsets is not arena.offsets:
        ce = ClassedExpander(arena.offsets, arena.dst, arena.h_offsets)
        arena._classed = ce
    return ce
