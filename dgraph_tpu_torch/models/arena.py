"""Device-resident posting-list arenas (PyTorch).

The port of ``dgraph_tpu/models/arena.py`` for the 2-hop slice: per
predicate, CSR tensors on the engine's device with host mirrors for
planning —

- **data arena**: sorted source uids + offsets + packed sorted target
  uids (uid predicates); **reverse arena**: the inverted edge set.
- **index arenas**: host-side sorted token table + token-row -> uid CSR.
- **resident arena** (:class:`ResidentArena`): the CSR pinned on the
  device for the resident gather kernel (``ops/gather.py``), kept fresh
  by a device-side merge of each mutation's delta pairs.

- **inline layouts** (``CSRArena.inline_layout`` / ``_grouped``): per
  row one 8-lane record holding the overflow chunk start, the degree and
  the first INLINE targets, plus an 8-wide overflow chunk table — the
  layout of the batched 2-hop pipeline (``bench2hop.py``).
- **value arenas** (:class:`ValueArena`): a predicate's numeric values
  as sorted uids + exact dense ranks on the device, for the order-by
  (``ops/order.py``).
- **chain planning** (``CSRArena.lut``, ``n_distinct_dst``,
  ``topm_deg_cumsum``): the dense uid->row table on the device and the
  host bounds the fused chain (``query/chain.py``) plans capacities
  with; all three are dropped by every applied delta.
- **join tier** (``CSRArena.tiles``, ``tile_blocks``,
  ``degree_histogram``): the adjacency as blocked boolean tiles on the
  device (``ops/spgemm.py``), their block count, and the log2 degree
  histogram the join planner reads for skew.

Arenas are rebuilt per dirty predicate from the host store, or patched
in place from the store's delta journal (``ArenaManager.refresh``).  A
patch repairs what it can in place (IVM): the degree histogram always,
the tiles and the tier-1 hop-cache entries (``cache/hop.py``) behind one
repair-vs-rebuild gate (``_ivm_repair_gate``); what is not repaired is
dropped.  The manager drops an arena's hop-cache entries when the arena
is evicted or rebuilt.

- **mesh sharding** (``ArenaManager.sharded_csr``): with a mesh
  (``parallel/mesh.py``), a predicate whose arena ``use_mesh_for``
  accepts is row-sharded over the mesh's model axis, each shard on its
  chip, placed by the ``MeshPlan`` (``mesh/plan.py``) and served by the
  ``MeshExecutor`` (``mesh/executor.py``); the elastic fault domain
  (``mesh/fault.py``) re-shards onto surviving chips.  Sharded views
  count against the residency budget like any arena.

Not ported yet: the chunked layout.
"""

from __future__ import annotations

import bisect
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dgraph_tpu_torch import ops
from dgraph_tpu_torch import tok as tokmod
from dgraph_tpu_torch.device import resolve
from dgraph_tpu_torch.models.store import PostingStore
from dgraph_tpu_torch.models.types import numeric
from dgraph_tpu_torch.obs import ledger as _ledger
from dgraph_tpu_torch.ops import spgemm
from dgraph_tpu_torch.ops.sets import SENT
from dgraph_tpu_torch.utils import planconfig
from dgraph_tpu_torch.utils.metrics import (
    ARENA_EVICTIONS,
    IVM_REPAIR_EDGES,
    IVM_REPAIRS,
    JOIN_TILE_BUILDS,
    JOIN_TILE_BYTES,
)

# Shared lock for the lazy resident build and for host-mirror deltas
# (a build that sampled the mirrors pre-delta must not cache a torn view).
_BUILD_LOCK = threading.RLock()


def _nbytes(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.numel() * t.element_size()


@dataclass
class CSRArena:
    """One CSR posting structure on a device, with host mirrors for
    planning."""

    src: Optional[torch.Tensor]     # int32[Sb] sorted row-key uids; None if rows are implicit
    offsets: torch.Tensor           # int32[Sb+1]; padded rows have degree 0
    dst: torch.Tensor               # int32[Eb], SENT-padded
    h_src: np.ndarray               # int64[S] (exact, unpadded)
    h_offsets: np.ndarray           # int64[S+1]
    n_rows: int
    n_edges: int
    _h_dst: np.ndarray              # int32[E] host mirror of dst

    def degree_of_rows(self, rows: np.ndarray) -> np.ndarray:
        """Host-side degree lookup for capacity planning."""
        rows = np.asarray(rows)
        ok = rows >= 0
        r = np.where(ok, rows, 0)
        return np.where(ok, self.h_offsets[r + 1] - self.h_offsets[r], 0)

    @property
    def avg_degree(self) -> float:
        """Mean out-degree — the O(1) fan-out estimate the cohort hop
        merger's gate and the hop cache's admission pre-screen read
        before paying for exact per-row degrees (query/engine.py
        DeviceExpander._expand_cached)."""
        return self.n_edges / max(1, self.n_rows)

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def host_dst(self) -> np.ndarray:
        """Host mirror of the packed dst column (int32[E])."""
        return self._h_dst

    def expand_host(self, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized numpy CSR expansion over the host mirror: returns
        (out, seg_ptr) in the engine's layout — out grouped by input row
        (ascending within each group), seg_ptr[i]:seg_ptr[i+1] slicing row
        i's targets.  Rows < 0 skip (degree 0)."""
        rows = np.asarray(rows)
        n = len(rows)
        ok = rows >= 0
        r = np.where(ok, rows, 0)
        degs = np.where(ok, self.h_offsets[r + 1] - self.h_offsets[r], 0)
        total = int(degs.sum())
        seg_ptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(degs, out=seg_ptr[1:])
        if total == 0:
            return np.empty(0, dtype=np.int64), seg_ptr
        starts = np.where(ok, self.h_offsets[r], 0)
        within = np.arange(total) - np.repeat(seg_ptr[:-1], degs)
        out = self.host_dst()[np.repeat(starts, degs) + within].astype(np.int64)
        return out, seg_ptr

    def device_bytes(self) -> int:
        """Device footprint of this arena's tensors, built inline layouts
        and resident tier included — the residency manager's accounting
        unit."""
        n = (_nbytes(self.src) + _nbytes(self.offsets) + _nbytes(self.dst)
             + _nbytes(self._lut))
        for pair in (self._chunked, self._inline, self._inline_grouped):
            if pair is not None:
                n += sum(_nbytes(t) for t in pair)
        if self._resident is not None:
            n += self._resident.device_bytes()
        if self._tiles is not None:
            n += self._tiles.device_bytes()
        return n

    def rows_for_uids_host(self, uids: np.ndarray) -> np.ndarray:
        pos = np.searchsorted(self.h_src, uids)
        pos = np.clip(pos, 0, max(0, self.n_rows - 1))
        if self.n_rows == 0:
            return np.full(len(uids), -1, dtype=np.int64)
        hit = self.h_src[pos] == uids
        return np.where(hit, pos, -1)

    # -- chain planning (query/chain.py) --------------------------------------

    _lut: Optional[torch.Tensor] = None
    _n_distinct_dst: Optional[int] = None
    _topm_deg: Optional[np.ndarray] = None

    def lut(self) -> torch.Tensor:
        """Dense uid->row table on the device: int32[bucket(last source
        uid + 1)], -1 where the uid has no row (``ops.batch.lut_rows``
        maps uids past its end to -1 as well).  One elementwise gather
        maps a device frontier to rows.  Kept until the next applied
        delta (a new source row renumbers every later row)."""
        cur = self._lut
        if cur is not None:
            return cur
        with _BUILD_LOCK:
            if self._lut is None:
                top = int(self.h_src[-1]) if self.n_rows else 0
                t = np.full(ops.bucket(top + 1), -1, dtype=np.int32)
                t[self.h_src] = np.arange(self.n_rows, dtype=np.int32)
                self._lut = _to_device(t, self.device)
            return self._lut

    def n_distinct_dst(self) -> int:
        """Number of distinct target uids (cached): bounds the unique
        frontier any expansion over this arena can produce, row-less
        leaf uids included."""
        if self._n_distinct_dst is None:
            self._n_distinct_dst = (
                int(len(np.unique(self.host_dst()))) if self.n_edges else 0
            )
        return self._n_distinct_dst

    def topm_deg_cumsum(self) -> np.ndarray:
        """Cumsum of the row degrees sorted descending, with a leading 0
        (cached): entry m bounds the edges of ANY m distinct rows."""
        if self._topm_deg is None:
            deg = np.sort(self.h_offsets[1:] - self.h_offsets[:-1])[::-1]
            self._topm_deg = np.concatenate([[0], np.cumsum(deg)])
        return self._topm_deg

    # -- join tier (ops/spgemm.py) --------------------------------------------

    _tiles: Optional[spgemm.PredTiles] = None  # lazy blocked adjacency
    _tile_blocks: Optional[tuple] = None      # (t, block count, universe)
    _deg_hist: Optional[np.ndarray] = None

    def tile_blocks(self) -> Tuple[int, int]:
        """(non-empty adjacency block count, universe) at the current
        tile size: the join planner's byte estimate, without building
        the tiles (one O(E) unique pass, cached per tile size until the
        next applied delta)."""
        t = spgemm.tile_size()
        cached = self._tile_blocks
        if cached is not None and cached[0] == t:
            return cached[1], cached[2]
        if self.n_edges == 0:
            k, uni = 0, 0
        else:
            k, uni = spgemm.count_tile_blocks(
                self.h_src, self.h_offsets, self.host_dst(), t
            )
        self._tile_blocks = (t, k, uni)
        return k, uni

    def tiles(self) -> Optional[spgemm.PredTiles]:
        """Blocked boolean adjacency tiles on the arena's device, built
        lazily from the host mirrors and cached (``device_bytes`` counts
        them, so the manager's budget governs them).  None — never
        cached — when the footprint exceeds DGRAPH_TPU_TILE_BUDGET or the
        arena has no edge; the planner then stays on the gather tier."""
        pt = self._tiles
        t = spgemm.tile_size()
        if pt is not None and pt.t == t:
            return pt
        if self.n_edges == 0:
            return None
        k, _uni = self.tile_blocks()
        if spgemm.est_tile_bytes(k, t) > spgemm.tile_budget():
            return None
        with _BUILD_LOCK:
            pt = self._tiles
            if pt is not None and pt.t == t:
                return pt
            pt = spgemm.build_tiles(
                self.h_src, self.h_offsets, self.host_dst(), t=t,
                device=self.device,
            )
            if pt is not None:
                self._tiles = pt
                JOIN_TILE_BUILDS.add()
                JOIN_TILE_BYTES.add(pt.device_bytes())
            return pt

    def degree_histogram(self) -> np.ndarray:
        """Log2-bucketed out-degree histogram: slot c counts rows with
        ⌈log2(degree)⌉ == c (degree ≥ 1; slot 0 holds degree-1 rows).
        Cached, and moved row by row on a delta; the join planner reads
        it to spot heavy-tailed predicates."""
        h = self._deg_hist
        if h is None:
            deg = (self.h_offsets[1:] - self.h_offsets[:-1]).astype(np.int64)
            deg = deg[deg > 0]
            if len(deg):
                c = np.ceil(np.log2(deg, where=deg > 1, out=np.zeros(len(deg))))
                h = np.bincount(c.astype(np.int64), minlength=32)
            else:
                h = np.zeros(32, dtype=np.int64)
            self._deg_hist = h
        return h

    def _degrees_of_uids(self, uids: np.ndarray) -> np.ndarray:
        """Out-degree per ROW-KEY uid (0 where the uid has no row) — the
        histogram repair's before/after probe."""
        if not len(uids):
            return np.zeros(0, dtype=np.int64)
        if self.n_rows == 0:
            return np.zeros(len(uids), dtype=np.int64)
        pos = np.searchsorted(self.h_src, uids)
        pos = np.clip(pos, 0, self.n_rows - 1)
        hit = self.h_src[pos] == uids
        deg = self.h_offsets[pos + 1] - self.h_offsets[pos]
        return np.where(hit, deg, 0).astype(np.int64)

    def _hist_move(self, old_deg: int, new_deg: int) -> None:
        """Shift one row between log2 degree buckets (degree-0 rows are
        uncounted)."""
        h = self._deg_hist
        for deg, step in ((old_deg, -1), (new_deg, +1)):
            if deg <= 0:
                continue
            b = (int(deg) - 1).bit_length()
            if b >= len(h):
                h = self._deg_hist = np.concatenate(
                    [h, np.zeros(b + 1 - len(h), dtype=h.dtype)]
                )
            h[b] += step

    # -- chunk-packed layout (ops/sets.py expand_chunked) --------------------

    _chunked: Optional[tuple] = None  # lazy (meta8, chunk_dst)

    def chunked(self) -> tuple:
        """Chunk-packed layout for ops.expand_chunked, built lazily from
        the host mirrors and uploaded once.

        Returns (meta8, chunk_dst): int32[Sb, 8] per-row (chunk_start,
        chunk_count, degree) and int32[NCb, CHUNK] chunk-packed targets
        with SENT pad lanes.  A delta drops it; host capacity planning
        uses chunk_degree_of_rows."""
        if self._chunked is not None:
            return self._chunked
        with _BUILD_LOCK:
            if self._chunked is not None:  # lost the build race: reuse
                return self._chunked
            C = ops.CHUNK
            S, E = self.n_rows, self.n_edges
            deg = self.h_offsets[1:] - self.h_offsets[:-1]
            cdeg = (deg + C - 1) // C
            coff = np.zeros(S + 1, dtype=np.int64)
            np.cumsum(cdeg, out=coff[1:])
            chunk = np.full((ops.bucket(max(1, int(coff[-1]))), C), SENT,
                            dtype=np.int32)
            if E:
                rowid = np.repeat(np.arange(S, dtype=np.int64), deg)
                within = np.arange(E, dtype=np.int64) - np.repeat(
                    self.h_offsets[:-1], deg
                )
                chunk[coff[rowid] + within // C, within % C] = self.host_dst()
            # sized from the host mirrors: the staged device tensors may be
            # stale until ensure_device()
            meta = np.zeros((ops.bucket(max(1, S)), 8), dtype=np.int32)
            meta[:S, 0] = coff[:-1]
            meta[:S, 1] = cdeg
            meta[:S, 2] = deg
            self._chunked = (_to_device(meta, self.device),
                             _to_device(chunk, self.device))
            return self._chunked

    def chunk_degree_of_rows(self, rows: np.ndarray) -> np.ndarray:
        """Host chunk-count lookup (ceil(degree/CHUNK)) for planning."""
        C = ops.CHUNK
        return (self.degree_of_rows(rows) + C - 1) // C

    # -- degree-classed hop plans (ops/batch.py) ------------------------------

    # the arena's ClassedExpander and its cached plans, built by
    # ops.classed_for_arena; dropped with the other derived layouts on a
    # delta and counted by ArenaManager.residency
    _classed: Optional[object] = None

    # -- inline-head layouts (ops/sets.py expand_inline*) --------------------

    _inline: Optional[tuple] = None          # lazy (metap, ov_chunks)
    _inline_grouped: Optional[tuple] = None  # lazy, skey-coded

    def _inline_host(self) -> Tuple[np.ndarray, np.ndarray]:
        """Host arrays of the inline-head layout (see inline_layout)."""
        INL = ops.INLINE
        S = self.n_rows
        deg = self.h_offsets[1:] - self.h_offsets[:-1]
        ovdeg = np.maximum(deg - INL, 0)
        cdeg = (ovdeg + 7) >> 3
        coff = np.zeros(S + 1, dtype=np.int64)
        np.cumsum(cdeg, out=coff[1:])
        NCov = int(coff[-1])
        Sb = ops.bucket(max(1, S))
        metap = np.full((Sb, 8), SENT, dtype=np.int32)
        metap[:, :2] = 0
        metap[:S, 0] = coff[:-1]
        metap[:S, 1] = deg
        h_dst = self.host_dst() if self.n_edges else np.zeros(0, np.int32)
        starts = self.h_offsets[:-1]
        for j in range(INL):
            sel = deg > j
            metap[:S][sel, 2 + j] = h_dst[starts[sel] + j]
        ov = np.full((max(1, NCov), 8), SENT, dtype=np.int32)
        rows = np.nonzero(deg > INL)[0]
        if len(rows):
            # tail-edge index set without a per-row loop: within = 0..od-1
            # per row by the repeat/cumsum trick
            od = ovdeg[rows]
            rowid = np.repeat(rows, od)
            ends = np.cumsum(od)
            within = np.arange(int(ends[-1]), dtype=np.int64) - np.repeat(
                ends - od, od
            )
            e = starts[rowid] + INL + within
            ov[coff[rowid] + (within >> 3), within & 7] = h_dst[e]
        return metap, ov

    def inline_layout(self) -> tuple:
        """Inline-head layout for ops.expand_inline, built lazily on the
        host and uploaded once.

        Returns (metap, ov_chunks): int32[Sb, 8] per-row records with
        lane0 = overflow chunk start, lane1 = degree, lanes 2..7 = the
        first INLINE targets (SENT pad); int32[NCov, 8] overflow chunks
        (targets INLINE.. of each row, 8 per chunk), unpadded row count.
        One row gather serves the metadata and every short posting list."""
        if self._inline is not None:
            return self._inline
        with _BUILD_LOCK:
            if self._inline is None:
                metap, ov = self._inline_host()
                self._inline = (_to_device(metap, self.device),
                                _to_device(ov, self.device))
            return self._inline

    def ov_chunk_degree_of_rows(self, rows: np.ndarray) -> np.ndarray:
        """Host overflow-chunk-count lookup for inline_layout planning."""
        d = np.maximum(self.degree_of_rows(rows) - ops.INLINE, 0)
        return (d + 7) >> 3

    def inline_layout_grouped(self) -> tuple:
        """inline_layout with skey-coded target lanes (ops.skey_encode):
        stored targets carry the no-overflow group bit, so sorting an
        expansion's output groups overflow-bearing rows into an ascending
        prefix and ops.expand_inline_grouped runs its slot-map on that
        prefix alone.  Dense arenas only (row i == uid i) with uids below
        2^GROUP_BIT — raises ValueError beyond that; callers catch it and
        use inline_layout().  Built from the host arrays; the ungrouped
        layout is not uploaded for it."""
        if self._inline_grouped is not None:
            return self._inline_grouped
        max_uid = self.n_rows
        if self.n_edges:
            max_uid = max(max_uid, int(self.host_dst().max()) + 1)
        if max_uid >= (1 << ops.GROUP_BIT):
            raise ValueError(
                f"uid space too large for grouped inline layout "
                f"({max_uid} >= 2^{ops.GROUP_BIT}); use inline_layout()"
            )
        with _BUILD_LOCK:
            if self._inline_grouped is not None:
                return self._inline_grouped
            metap, ov = self._inline_host()
            S = self.n_rows
            deg = self.h_offsets[1:] - self.h_offsets[:-1]
            # overflow bit by TARGET uid; uids without a row have no edges,
            # hence no overflow
            has_ov_of_uid = np.zeros(max_uid + 1, bool)
            has_ov_of_uid[:S] = deg > ops.INLINE
            for tab in (metap[:, 2:], ov):
                valid = tab != SENT
                u = tab[valid]
                tab[valid] = ops.skey_encode(u, has_ov_of_uid[u])
            self._inline_grouped = (_to_device(metap, self.device),
                                    _to_device(ov, self.device))
            return self._inline_grouped

    # -- device-resident tier (ops/gather.py) --------------------------------

    _resident: Optional["ResidentArena"] = None
    epoch: int = 0  # bumped once per applied delta

    def resident(self) -> "ResidentArena":
        """Device-pinned CSR view for the resident gather, built lazily
        from the host mirrors and kept fresh by ``apply_delta`` (device
        merge, or a reseed on structural change)."""
        ra = self._resident
        if ra is not None:
            return ra
        with _BUILD_LOCK:
            if self._resident is None:
                self._resident = ResidentArena.seed(
                    self.h_offsets, self.host_dst(), self.n_rows,
                    self.n_edges, self.device,
                )
            return self._resident

    # -- incremental refresh ------------------------------------------------

    _device_stale: bool = False

    def apply_delta(self, adds: np.ndarray, dels: np.ndarray) -> None:
        """Apply a small mutation batch to the HOST mirrors in place of a
        full rebuild (np.insert/np.delete on the (row, dst)-sorted flat
        dst); the staged device tensors go stale until ``ensure_device``,
        and a built resident arena merges the delta on the device.

        adds/dels: int64[n, 2] (src, dst) arrays; adds must not already
        exist, dels must exist (the store journal guarantees both)."""
        with _BUILD_LOCK:
            self._apply_delta_locked(adds, dels)

    def _apply_delta_locked(self, adds: np.ndarray, dels: np.ndarray) -> None:
        pre_rows = self.n_rows  # new source rows shift every row index
        # degree-histogram repair: the touched rows' PRE-delta degrees,
        # so their log2 buckets move instead of the histogram dropping
        hist = self._deg_hist
        touched = old_degs = None
        if hist is not None:
            touched = np.unique(np.concatenate(
                [np.empty(0, np.int64)]
                + [np.asarray(a[:, 0], dtype=np.int64) for a in (adds, dels)
                   if len(a)]
            ))
            old_degs = self._degrees_of_uids(touched)
        h_dst = self.host_dst().astype(np.int64, copy=False)
        # absolute edge positions via the composite (row, dst) key — the
        # CSR flat dst IS sorted by it
        for arr, sign in ((dels, -1), (adds, +1)):
            if not len(arr):
                continue
            srcs = arr[:, 0]
            dsts = arr[:, 1]
            if sign > 0:
                # new source rows first (degree 0), keeping h_src sorted
                newsrc = np.setdiff1d(srcs, self.h_src)
                if len(newsrc):
                    at = np.searchsorted(self.h_src, newsrc)
                    self.h_src = np.insert(self.h_src, at, newsrc)
                    self.h_offsets = np.insert(
                        self.h_offsets, at + 1, self.h_offsets[at]
                    )
                    self.n_rows = len(self.h_src)
            rows = np.searchsorted(self.h_src, srcs)
            keys = (rows.astype(np.int64) << 32) | dsts
            edge_rows = np.repeat(
                np.arange(self.n_rows, dtype=np.int64),
                np.diff(self.h_offsets),
            )
            edge_keys = (edge_rows << 32) | h_dst
            order = np.argsort(keys, kind="stable")
            keys, rows, dsts = keys[order], rows[order], dsts[order]
            pos = np.searchsorted(edge_keys, keys)
            if sign > 0:
                h_dst = np.insert(h_dst, pos, dsts)
            else:
                h_dst = np.delete(h_dst, pos)
            cnt = np.bincount(rows, minlength=self.n_rows)
            self.h_offsets = self.h_offsets.copy()
            self.h_offsets[1:] += sign * np.cumsum(cnt)
        self._h_dst = h_dst.astype(np.int32)
        self.n_edges = len(h_dst)
        # derived layouts and planning caches are rebuilt from the new
        # mirrors at next use
        self._chunked = None
        self._classed = None
        self._inline = None
        self._inline_grouped = None
        self._lut = None
        self._n_distinct_dst = None
        self._topm_deg = None
        self._tile_blocks = None
        if touched is not None:
            new_degs = self._degrees_of_uids(touched)
            for od, nd in zip(old_degs.tolist(), new_degs.tolist()):
                if od != nd:
                    self._hist_move(od, nd)
        # tile repair: a small delta sets lanes of the stored blocks in
        # place; a structurally impossible repair (new block, grown
        # universe) or a closed gate drops the tiles for a rebuild
        pt = self._tiles
        if pt is not None:
            repaired = None
            n_delta = len(adds) + len(dels)
            if n_delta > 0 and _ivm_repair_gate(n_delta, self.n_edges):
                repaired = spgemm.apply_tile_delta(pt, adds, dels)
                IVM_REPAIRS.add(
                    ("tile", "repaired" if repaired is not None else "rebuild")
                )
                if repaired is not None:
                    IVM_REPAIR_EDGES.add(n_delta)
                    led = _ledger.current()
                    if led is not None:
                        led.repairs += 1
            self._tiles = repaired
        if len(adds) or len(dels):
            self.epoch += 1
            ra = self._resident
            if ra is not None:
                if self.n_rows != pre_rows or self.n_edges + 128 > ra.ecap:
                    # structural change (new source rows renumber every
                    # row) or the 128-lane slack would be breached: a
                    # fresh upload becomes the next epoch, the old
                    # buffers the shadow
                    nra = ResidentArena.seed(
                        self.h_offsets, self._h_dst, self.n_rows,
                        self.n_edges, self.device,
                    )
                    nra._prev = (ra.off, ra.dst)
                    self._resident = nra
                else:
                    # device-side delta application: only the (row, dst)
                    # pairs cross host->device
                    def _pack(arr):
                        rows = np.searchsorted(self.h_src, arr[:, 0])
                        b = ops.bucket(max(1, len(arr)))
                        return (
                            _to_device(
                                ops.pad_to(rows.astype(np.int32), b),
                                self.device,
                            ),
                            _to_device(
                                ops.pad_to(arr[:, 1].astype(np.int32), b),
                                self.device,
                            ),
                        )

                    ar, ad = _pack(adds)
                    dr, dd = _pack(dels)
                    ra.apply_delta(ar, ad, dr, dd, self.n_edges)
        self._device_stale = True

    def ensure_device(self) -> None:
        """Re-upload the staged device tensors from the host mirrors if a
        delta made them stale."""
        if not self._device_stale:
            return
        with _BUILD_LOCK:
            if not self._device_stale:
                return
            fresh = _csr_from_arrays(
                self.h_src, self.h_offsets, self._h_dst, self.device
            )
            self.src = fresh.src
            self.offsets = fresh.offsets
            self.dst = fresh.dst
            self._device_stale = False
            led = _ledger.current()
            if led is not None:
                led.bytes_h2d += (
                    _nbytes(self.src) + _nbytes(self.offsets)
                    + _nbytes(self.dst)
                )


def _ivm_repair_gate(n_delta: int, entry_edges: float) -> bool:
    """The repair-vs-rebuild decision for one derived view: off when the
    IVM gate is, else ``planner.repair_route``, which prices a repair of
    ``n_delta`` edges against refills of an ``entry_edges``-edge view
    (recorded like every other route decision, at /debug/planner)."""
    from dgraph_tpu_torch.ivm import ivm_enabled
    from dgraph_tpu_torch.query import planner

    if not ivm_enabled():
        return False
    ok, dec = planner.repair_route(n_delta, entry_edges)
    if dec is not None:
        planner.record(None, dec)
    return ok


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _resident_cap(n_edges: int) -> int:
    """Capacity of the resident dst buffer: live edges plus growth
    headroom (~1/8th, floor 1024) so point-mutation bursts merge on
    device instead of reseeding, rounded to 128 lanes PLUS one slack
    tile — the reference's layout, kept so footprints and the reseed
    rule match it (the CUDA kernel never reads past a live span)."""
    head = max(n_edges // 8, 1024)
    return ((n_edges + head + 127) // 128) * 128 + 128


def _resident_merge(
    off: torch.Tensor,
    dst: torch.Tensor,
    add_r: torch.Tensor,
    add_d: torch.Tensor,
    del_r: torch.Tensor,
    del_d: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment merge on the device: the NEXT epoch's (offsets, dst) from
    the live buffers plus padded (row, dst) delta pairs — the device twin
    of ``CSRArena._apply_delta_locked``'s host merge, with sorts in place
    of np.insert/np.delete.

    Order of the merge sort is (row, dst, tag).  Rows and dsts are
    non-negative int32, so (row << 32) | dst is an exact int64 key; tag
    (0 = live or add, 1 = del) cannot be folded in as well without
    overflowing int64, and need not be: the concatenation below already
    lists every tag-0 entry before every tag-1 entry, so one STABLE sort
    by the key orders equal keys by tag.  Adds must not exist and dels
    must exist (the store journal contract), so a del lands right after
    its one live twin and both are removed.  Delta pads carry
    (SENT, SENT) and sort past every live row."""
    dev = off.device
    sb1 = off.shape[0]                 # Sb + 1
    big = sb1                          # > any live row index
    ecap = dst.shape[0]
    idx = torch.arange(ecap, dtype=torch.int32, device=dev)
    # row of each packed edge slot; off[-1] == E by the pad contract
    er = torch.searchsorted(off[1:], idx, right=True, out_int32=True)
    live = idx < off[-1]
    rows0 = torch.where(live, er, big)
    dst0 = torch.where(live, dst, SENT)
    rows_c = torch.cat([rows0, add_r, del_r]).to(torch.int64)
    dst_c = torch.cat([dst0, add_d, del_d]).to(torch.int64)
    tag = torch.zeros(rows_c.shape[0], dtype=torch.bool, device=dev)
    tag[ecap + add_r.shape[0]:] = True
    o = torch.sort((rows_c << 32) | dst_c, stable=True).indices
    r_s, d_s, t_s = rows_c[o], dst_c[o], tag[o]
    nxt_del = torch.zeros_like(t_s)
    nxt_del[:-1] = t_s[1:]
    same = torch.zeros_like(t_s)
    same[:-1] = (r_s[1:] == r_s[:-1]) & (d_s[1:] == d_s[:-1])
    remove = t_s | (nxt_del & same)
    r_f = torch.where(remove, big, r_s)
    d_f = torch.where(remove, SENT, d_s)
    o2 = torch.sort((r_f << 32) | d_f, stable=True).indices
    r_f = r_f[o2][:ecap].to(torch.int32)
    d_f = d_f[o2][:ecap].to(torch.int32)
    # new offsets by rank: off[r] == E' for every padding row r > S,
    # dst SENT-padded
    new_off = torch.searchsorted(
        r_f, torch.arange(sb1, dtype=torch.int32, device=dev),
        out_int32=True,
    )
    return new_off, d_f


class ResidentArena:
    """Device-pinned CSR (offsets + packed dst) walked directly by the
    resident gather kernel.  Mutations merge ON the device
    (``_resident_merge``) into the next epoch's buffers; the previous
    epoch's buffers stay referenced as the shadow until the next flip.
    ``device_bytes()`` counts live and shadow, each once."""

    def __init__(self, off: torch.Tensor, dst: torch.Tensor, n_edges: int):
        self.off = off              # int32[Sb+1], live epoch
        self.dst = dst              # int32[Ecap], SENT slack-padded
        self.n_edges = int(n_edges)
        self._prev: Optional[tuple] = None  # shadow: previous epoch

    @property
    def ecap(self) -> int:
        return int(self.dst.shape[0])

    @classmethod
    def seed(cls, h_offsets, h_dst, n_rows: int, n_edges: int,
             device: torch.device):
        """Initial (or reseed) upload from the host mirrors, charged h2d."""
        Sb = ops.bucket(max(1, n_rows))
        E = int(n_edges)
        off = np.full(Sb + 1, E, dtype=np.int32)
        off[: n_rows + 1] = h_offsets.astype(np.int32)
        dstp = np.full(_resident_cap(E), SENT, dtype=np.int32)
        if E:
            dstp[:E] = np.asarray(h_dst[:E], dtype=np.int32)
        ra = cls(_to_device(off, device), _to_device(dstp, device), E)
        led = _ledger.current()
        if led is not None:
            led.bytes_h2d += _nbytes(ra.off) + _nbytes(ra.dst)
        return ra

    def apply_delta(self, add_r, add_d, del_r, del_d, n_edges: int) -> None:
        """Merge padded device delta pairs into the NEXT epoch's buffers
        and flip; only the delta pairs crossed host->device."""
        new_off, new_dst = _resident_merge(
            self.off, self.dst, add_r, add_d, del_r, del_d
        )
        led = _ledger.current()
        if led is not None:
            led.bytes_h2d += sum(_nbytes(t) for t in (add_r, add_d, del_r, del_d))
        self._prev = (self.off, self.dst)
        self.off = new_off
        self.dst = new_dst
        self.n_edges = int(n_edges)

    def expand_packed(self, rows: torch.Tensor, cap: int) -> torch.Tensor:
        """Packed frontier expansion ``concat([out, seg])`` against the
        LIVE epoch buffers, device-in and device-out."""
        return ops.gather_packed(self.off, self.dst, rows, cap)

    def device_bytes(self) -> int:
        n = _nbytes(self.off) + _nbytes(self.dst)
        if self._prev is not None:
            n += sum(_nbytes(t) for t in self._prev)
        return n


def _build_csr(rows_to_dsts: Dict[int, np.ndarray], device) -> CSRArena:
    """Build a CSR arena from {row_key: array-of-dst} (host)."""
    keys = np.array(sorted(rows_to_dsts.keys()), dtype=np.int64)
    S = len(keys)
    degs = np.array([len(rows_to_dsts[k]) for k in keys], dtype=np.int64)
    offsets = np.zeros(S + 1, dtype=np.int64)
    np.cumsum(degs, out=offsets[1:])
    E = int(offsets[-1])
    dst = np.empty(E, dtype=np.int32)
    for i, k in enumerate(keys):
        d = np.sort(np.asarray(list(rows_to_dsts[k]), dtype=np.int32))
        dst[offsets[i] : offsets[i + 1]] = d
    return _csr_from_arrays(keys, offsets, dst, device)


def _edges_columnar(edges: Dict[int, set]) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten a dict-of-sets edge map into parallel (src, dst) arrays in
    one pass (two C-speed slice assignments per row)."""
    n = sum(len(s) for s in edges.values())
    src = np.empty(n, dtype=np.int64)
    dst = np.empty(n, dtype=np.int64)
    i = 0
    for u, s in edges.items():
        k = len(s)
        src[i : i + k] = u
        dst[i : i + k] = list(s)
        i += k
    return src, dst


def _sorted_unique_edges(src: np.ndarray, dst: np.ndarray):
    """Sort edge pairs by (src, dst) and drop duplicates (vectorized)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    order = np.lexsort((dst, src))
    s, d = src[order], dst[order]
    if len(s):
        keep = np.ones(len(s), dtype=bool)
        keep[1:] = (s[1:] != s[:-1]) | (d[1:] != d[:-1])
        s, d = s[keep], d[keep]
    return s, d


def csr_from_edges(
    src: np.ndarray, dst: np.ndarray, device,
    row_universe: Optional[np.ndarray] = None,
) -> CSRArena:
    """Vectorized bulk CSR construction from parallel edge arrays (one
    global lexsort).  ``row_universe`` adds degree-0 rows for uids beyond
    the edge sources (the has() arena needs rows for value-only uids)."""
    s, d = _sorted_unique_edges(src, dst)
    ekeys, counts = np.unique(s, return_counts=True)
    if row_universe is not None and len(row_universe):
        keys = np.union1d(ekeys, np.asarray(row_universe, dtype=np.int64))
        full = np.zeros(len(keys), dtype=np.int64)
        full[np.searchsorted(keys, ekeys)] = counts
        counts = full
    else:
        keys = ekeys
    offsets = np.zeros(len(keys) + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return _csr_from_arrays(keys, offsets, d.astype(np.int32), device)


def csr_dense_from_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int,
                         device) -> CSRArena:
    """Dense CSR: one row per uid in [0, n_nodes] (degree 0 where
    absent), so frontier uids ARE row indices — no row lookup on the
    query path.  The layout of the batched 2-hop pipeline."""
    s, d = _sorted_unique_edges(src, dst)
    counts = np.bincount(s, minlength=n_nodes + 1)
    offsets = np.zeros(n_nodes + 2, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    keys = np.arange(n_nodes + 1, dtype=np.int64)
    return _csr_from_arrays(keys, offsets, d.astype(np.int32), device)


def _csr_from_arrays(keys: np.ndarray, offsets: np.ndarray, dst: np.ndarray,
                     device) -> CSRArena:
    S, E = len(keys), len(dst)
    Sb = ops.bucket(max(1, S))
    Eb = ops.bucket(max(1, E))
    src_pad = np.full(Sb, SENT, dtype=np.int32)
    src_pad[:S] = keys.astype(np.int32)
    off_pad = np.full(Sb + 1, offsets[-1] if S else 0, dtype=np.int32)
    off_pad[: S + 1] = offsets.astype(np.int32)
    dst_pad = np.full(Eb, SENT, dtype=np.int32)
    dst_pad[:E] = dst
    return CSRArena(
        src=_to_device(src_pad, device),
        offsets=_to_device(off_pad, device),
        dst=_to_device(dst_pad, device),
        h_src=keys,
        h_offsets=offsets,
        n_rows=S,
        n_edges=E,
        _h_dst=np.asarray(dst, dtype=np.int32),
    )


@dataclass
class IndexArena:
    """Secondary index: host token table + device token-row -> uids CSR."""

    tokenizer: str
    tokens: list                    # sorted token keys (host)
    csr: CSRArena                   # rows aligned with ``tokens``
    lossy: bool

    def row_of(self, token) -> int:
        i = bisect.bisect_left(self.tokens, token)
        if i < len(self.tokens) and self.tokens[i] == token:
            return i
        return -1

    def device_bytes(self) -> int:
        return self.csr.device_bytes()

    def row_range(self, lo=None, hi=None, lo_open=False, hi_open=False) -> Tuple[int, int]:
        """Token rows t with lo <=(<) t <=(<) hi, as [start, end)."""
        start = 0
        end = len(self.tokens)
        if lo is not None:
            start = (
                bisect.bisect_right(self.tokens, lo)
                if lo_open
                else bisect.bisect_left(self.tokens, lo)
            )
        if hi is not None:
            end = (
                bisect.bisect_left(self.tokens, hi)
                if hi_open
                else bisect.bisect_right(self.tokens, hi)
            )
        return start, max(start, end)


@dataclass
class ValueArena:
    """A predicate's numeric values on the device, for the order-by."""

    src: torch.Tensor               # int32[Sb] sorted uids, SENT-padded
    vals: torch.Tensor              # float32[Sb]; padding slots hold NaN
    ranks: torch.Tensor             # int32[Sb] dense rank of the EXACT
                                    # float64 value (ordering by rank is
                                    # exact; float32 vals are not);
                                    # padding slots hold -1
    h_src: np.ndarray               # int64[S]
    h_vals: np.ndarray              # float64[S]
    h_ranks: np.ndarray             # int32[S] host mirror of ranks (exact)
    n: int
    langless: bool = True           # no lang-tagged values existed for the
                                    # predicate — untagged host lookup and
                                    # this arena agree uid-for-uid

    def device_bytes(self) -> int:
        return sum(_nbytes(t) for t in (self.src, self.vals, self.ranks))


def default_budget_bytes(device: torch.device) -> int:
    """Arena residency budget when none is given: on a CUDA device three
    quarters of the memory free when the manager is built
    (``torch.cuda.mem_get_info``); 0 (unlimited) on the CPU."""
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return free * 3 // 4
    return 0


class ArenaManager:
    """Builds and caches arenas on one device; invalidates on store dirty
    marks, or patches cached uid arenas from the store's delta journal.

    Builds run under the cache lock (the port's server serializes
    requests, so per-key build locks would buy nothing yet).  Least
    recently used arenas are evicted whole once the device bytes of the
    cached arenas exceed ``budget_bytes`` (0 = unlimited)."""

    # the LRU accounting is bumped from every query thread — the armed
    # lockset witness (analysis/witness.py) holds it to the _cache_lock
    # discipline.  The reference also lists its full-store-clear build
    # generation (_inval_gen_star); builds here run under the cache lock
    # and keep no such generation.  expand_device_min is deliberately
    # NOT listed: it is a GIL-atomic planner knob (the engine setter
    # rebinds an int; readers take either value and both are valid).
    __race_fields__ = frozenset({"_lru_total"})

    def __init__(
        self,
        store: PostingStore,
        device=None,
        budget_bytes: Optional[int] = None,
        mesh=None,
        shard_threshold: int = 4096,
    ):
        self.store = store
        self.device = resolve(device)
        # the device mesh big predicates row-shard over (the
        # intra-predicate sharding upstream lacks, SURVEY.md §5); None =
        # unsharded execution.  ``self.mesh`` is a property: with the
        # elastic fault domain live it reads the CURRENT surviving
        # sub-mesh, so every consumer follows a re-shard through one swap
        self._mesh = mesh
        self.shard_threshold = shard_threshold
        self.mesh_plan = None
        self._mesh_exec = None
        self.mesh_fault = None
        # every kernel built and bound now, never inside a guarded
        # dispatch's watchdog (ops.bind_kernels; a no-op off CUDA)
        ops.bind_kernels(self.device)
        # single source of truth for host-vs-device expansion routing
        # (engine and FuncResolver both read it; the engine may retune)
        self.expand_device_min = planconfig.expand_device_min()
        # the same for k-way intersections (query/joinplan.py)
        self.kway_device_min = planconfig.kway_device_min()
        self._data: Dict[str, CSRArena] = {}
        self._reverse: Dict[str, CSRArena] = {}
        self._index: Dict[Tuple[str, str], IndexArena] = {}
        self._values: Dict[str, ValueArena] = {}
        # (pred, reverse) -> (source arena, ShardedArena, plan offset)
        self._sharded: Dict[Tuple[str, bool], tuple] = {}
        self._cache_lock = threading.RLock()
        self.budget_bytes = int(
            budget_bytes if budget_bytes is not None
            else default_budget_bytes(self.device)
        )
        self._lru: "OrderedDict[tuple, int]" = OrderedDict()  # (cache id, key) -> bytes
        self._lru_total = 0
        self.evictions = 0  # arenas dropped by the budget, cumulative
        self._caches_by_id = {
            id(self._data): self._data,
            id(self._reverse): self._reverse,
            id(self._index): self._index,
            id(self._values): self._values,
            id(self._sharded): self._sharded,
        }
        # tier-1 hop-expansion cache (cache/hop.py): expansion results
        # are arena-snapshot state, so the cache lives and dies with this
        # manager and hears about arena evictions (id-keyed entries may
        # never outlive the arena object).  None when DGRAPH_TPU_CACHE=0
        # — the expander then skips every probe.
        from dgraph_tpu_torch.cache import HopCache, cache_enabled

        self.hop_cache = HopCache() if cache_enabled() else None
        if mesh is not None:
            # predicate→shard placement and, with more than one chip to
            # lose, the elastic fault domain (DGRAPH_TPU_MESH_ELASTIC=0
            # keeps the one latching plane)
            from dgraph_tpu_torch.mesh.plan import MeshPlan

            self.mesh_plan = MeshPlan.load(int(mesh.shape["model"]))
            if int(mesh.shape["model"]) > 1:
                from dgraph_tpu_torch.mesh import fault as _mesh_fault

                if _mesh_fault.elastic_enabled():
                    self.mesh_fault = _mesh_fault.MeshFaultDomain(self, mesh)

    def _drop_hops(self, arena) -> None:
        """Drop the hop-cache entries of an arena leaving the cache NOW,
        while the object is alive: a later allocation recycling its
        id() must never alias a dead entry's key."""
        if arena is not None and self.hop_cache is not None:
            self.hop_cache.drop_arena(id(arena))

    def _get_or_build(self, cache, key, build, valid=None):
        """cache[key], built under the cache lock when missing or when
        ``valid`` rejects the cached entry (sharded_csr checks its source
        arena, width and placement)."""
        with self._cache_lock:
            a = cache.get(key)
            if a is None or (valid is not None and not valid(a)):
                a = build()
                cache[key] = a
            self._touch((id(cache), key), a)
            return a

    def _touch(self, lkey: tuple, obj) -> None:
        """LRU bookkeeping under _cache_lock: refresh recency + size (the
        resident arena built after caching grows the footprint)."""
        if lkey[0] == id(self._sharded):
            obj = obj[1]  # (source arena, ShardedArena, offset)
        new = obj.device_bytes()
        self._lru_total += new - self._lru.get(lkey, 0)
        self._lru[lkey] = new
        self._lru.move_to_end(lkey)
        if not self.budget_bytes:
            return
        while self._lru_total > self.budget_bytes and len(self._lru) > 1:
            if next(iter(self._lru)) == lkey:
                break
            self._pop_lru_victim()

    def _pop_lru_victim(self) -> None:
        """Evict the least recently used entry (caller holds
        _cache_lock and knows the LRU is not empty)."""
        victim, vbytes = self._lru.popitem(last=False)
        self._lru_total -= vbytes
        self.evictions += 1
        ARENA_EVICTIONS.add(1)
        cache = self._caches_by_id[victim[0]]
        gone = cache.pop(victim[1], None)
        if cache is self._sharded:
            return
        self._drop_hops(gone)
        if cache is self._data or cache is self._reverse:
            # the sharded view holds the arena: it would pin its memory
            self._drop_sharded_key((victim[1], cache is self._reverse))

    def evict_for_oom(self, n: int = 2) -> int:
        """Device-memory pressure valve (utils/devguard.py): a dispatch
        just failed out of memory, so drop up to ``n`` LRU entries
        whatever the budget says (the budget is an estimate, the
        allocator's verdict is ground truth), always keeping one, to give
        the one retry headroom.  Returns how many were dropped; 0 means
        nothing is left to free.  An in-flight expansion holding a
        dropped arena keeps its reference, and the caching allocator gets
        the arena's blocks back only when the last reference dies."""
        with self._cache_lock:
            dropped = 0
            while dropped < n and len(self._lru) > 1:
                self._pop_lru_victim()
                dropped += 1
            return dropped

    def residency(self) -> dict:
        """Device-residency + program-cache snapshot (obs/device.py's
        data source).  ``resident_bytes`` is the budget accountant's
        running total — the number eviction decisions are made on — so
        the telemetry can never disagree with the enforcement.
        ``tile_bytes`` walks the cached uid arenas' tile sets (the tile
        join tier's dense blocks); ``program_caches`` counts the cached
        arenas' classed expanders and their cached plans."""
        with self._cache_lock:
            resident = self._lru_total
            entries = len(self._lru)
            evictions = self.evictions
            arenas = list(self._data.values()) + list(self._reverse.values())
            sharded = [e[1] for e in self._sharded.values()]
        tile_bytes = 0
        tile_sets = 0
        classed = 0
        classed_programs = 0
        for a in arenas:
            pt = a._tiles
            if pt is not None:
                tile_bytes += pt.device_bytes()
                tile_sets += 1
            ce = a._classed
            if ce is not None:
                classed += 1
                classed_programs += len(ce._programs)
        return {
            "resident_bytes": resident,
            "budget_bytes": self.budget_bytes,
            "headroom_bytes": (
                max(0, self.budget_bytes - resident)
                if self.budget_bytes else None
            ),
            "entries": entries,
            "evictions": evictions,
            "tile_bytes": tile_bytes,
            "sharded_bytes": sum(sa.device_bytes() for sa in sharded),
            "program_caches": {
                "classed_expanders": classed,
                "classed_programs": classed_programs,
                "tile_sets": tile_sets,
            },
        }

    def _lru_drop(self, cache, key) -> None:
        b = self._lru.pop((id(cache), key), None)
        if b is not None:
            self._lru_total -= b

    def refresh(self) -> None:
        """Drop or incrementally update cached arenas for predicates
        mutated since the last refresh: small uid-edge deltas (the store's
        bounded journal) patch cached data/reverse arenas in place; value
        mutations, bulk loads and journal overflow rebuild."""
        with self._cache_lock:
            # never blanket-clear the dirty set: a ClusterStore's
            # ``dirty`` drains replica marks under its own locks
            # (_cache_lock → _snap_lock → the group's _lock), and marks
            # added between this read and the loop below must survive
            # for the next refresh — only processed marks are discarded
            dirty = self.store.dirty
            if not dirty:
                return
            if "*" in dirty:  # full-store replacement
                if self.hop_cache is not None:
                    self.hop_cache.clear()
                for c in (self._data, self._reverse, self._index,
                          self._values, self._sharded):
                    c.clear()
                self._lru.clear()
                self._lru_total = 0
                dirty.discard("*")
            # a store with no mutation journal (ClusterStore: replica
            # applies only mark predicates dirty) takes the rebuild path
            deltas = getattr(self.store, "delta", {})
            bases = getattr(self.store, "delta_base", {})
            for p in list(dirty):
                delta = deltas.pop(p, None)
                # the journal window's repair base is consumed WITH the
                # journal: a stale base must never re-key a later window
                base = bases.pop(p, None)
                if delta is not None and self._try_apply_delta(p, delta, base):
                    dirty.discard(p)
                    continue
                for key in [k for k in self._data if k == p or k.startswith(p + "\x00")]:
                    self._drop_hops(self._data.pop(key, None))
                    self._lru_drop(self._data, key)
                self._drop_hops(self._reverse.pop(p, None))
                self._lru_drop(self._reverse, p)
                for key in [k for k in self._index if k[0] == p]:
                    self._index.pop(key, None)
                    self._lru_drop(self._index, key)
                self._values.pop(p, None)
                self._lru_drop(self._values, p)
                for sk in ((p, False), (p, True)):
                    self._drop_sharded_key(sk)
                dirty.discard(p)

    def _try_apply_delta(self, pred: str, delta: list, base=None) -> bool:
        """Incrementally update the cached data (and reverse) arena for
        ``pred``.  False when no cached arena exists (the next access
        builds fresh anyway), a has-rows variant is cached (its row
        universe can shift), or delete churn left too many empty rows.

        After the arenas absorb the delta, the predicate's cached hop
        expansions absorb it too: repaired in place and re-keyed from
        ``base`` (the pred version every live entry carries, recorded
        when the journal window opened) to the post-mutation version,
        behind the repair-vs-rebuild gate.  Entries a repair cannot fix
        are dropped."""
        a = self._data.get(pred)
        if a is None or (pred + "\x00has") in self._data:
            return False
        # the sharded views re-shard from the patched host mirrors at
        # their next read (the reference rebuilds the whole arena)
        for sk in ((pred, False), (pred, True)):
            self._drop_sharded_key(sk)
        _E = np.zeros((0, 2), dtype=np.int64)
        if not delta:
            # facet-only touches: arenas unaffected, and the cached
            # expansions still exact — a zero-delta repair re-keys them
            # to the new pred version
            self._repair_hop_entries(pred, a, _E, _E, base, gate=True)
            return True
        zero_rows = int(np.count_nonzero(np.diff(a.h_offsets) == 0))
        if zero_rows > max(4096, a.n_rows // 4):
            return False
        net: Dict[Tuple[int, int], int] = {}
        for s, d, sign in delta:
            net[(s, d)] = net.get((s, d), 0) + sign
        adds = np.array(
            [k for k, v in net.items() if v > 0], dtype=np.int64
        ).reshape(-1, 2)
        dels = np.array(
            [k for k, v in net.items() if v < 0], dtype=np.int64
        ).reshape(-1, 2)
        a.apply_delta(adds, dels)
        r = self._reverse.get(pred)
        if r is not None:
            r.apply_delta(adds[:, ::-1], dels[:, ::-1])
        n_delta = len(adds) + len(dels)
        self._repair_hop_entries(
            pred, a, adds, dels, base,
            # the gate prices a typical warm entry as a 32-row frontier
            # at this arena's mean fan-out
            gate=(n_delta > 0 and _ivm_repair_gate(
                n_delta, max(1.0, a.avg_degree) * 32.0
            )),
        )
        # entries the repair did not carry to the new epoch describe a
        # snapshot that no longer exists: drop them now
        if self.hop_cache is not None and n_delta > 0:
            for x in (a, r):
                if x is not None:
                    self.hop_cache.drop_stale_epoch(id(x), x.epoch)
        return True

    def _repair_hop_entries(
        self, pred: str, a: CSRArena, adds, dels, base, gate: bool
    ) -> None:
        """Repair (or zero-delta re-key) the tier-1 entries for ``pred``
        on both directions' arenas.  Skips entirely when the gate said
        rebuild, IVM is off (entries are keyed on the global version),
        the journal window carried no base, or a change that cannot be
        scoped to predicates (the floor) landed inside the window."""
        if self.hop_cache is None or not gate or base is None:
            return
        from dgraph_tpu_torch.ivm import ivm_enabled

        if not ivm_enabled():
            return
        new_v = self.store.pred_versions.get(pred, 0)
        if new_v <= base or self.store.pred_floor > base:
            return
        from dgraph_tpu_torch import obs

        repaired = dropped = 0
        with obs.child("ivm.repair") as sp:
            for arena, ad, dl in (
                (a, adds, dels),
                (self._reverse.get(pred), adds[:, ::-1], dels[:, ::-1]),
            ):
                if arena is None:
                    continue
                rev = arena is not a
                # the delta that drives this repair bumped the arena
                # epoch exactly once (zero-delta re-keys bump nothing)
                ne = arena.epoch
                oe = ne - 1 if (len(adds) or len(dels)) else ne
                rep, drop = self.hop_cache.repair_pred(
                    id(arena), pred, rev, ad, dl, base, new_v,
                    old_epoch=oe, new_epoch=ne,
                )
                repaired += rep
                dropped += drop
            sp.set_attr("pred", pred)
            sp.set_attr("delta", len(adds) + len(dels))
            sp.set_attr("repaired", repaired)
            sp.set_attr("dropped", dropped)
        if repaired:
            IVM_REPAIRS.add(("hop", "repaired"))
            IVM_REPAIR_EDGES.add((len(adds) + len(dels)) * repaired)
            led = _ledger.current()
            if led is not None:
                # attributed to the request whose refresh drove the
                # repair (usually the mutation; sometimes the first
                # reader after it — the spans' attribution rule)
                led.repairs += repaired
        if dropped:
            IVM_REPAIRS.add(("hop", "rebuild"))

    # -- mesh sharding ------------------------------------------------------

    @property
    def mesh(self):
        """The CURRENT serving mesh: the boot mesh, or the surviving
        sub-mesh the elastic fault domain re-sharded onto.  None =
        unsharded execution."""
        if self.mesh_fault is not None:
            return self.mesh_fault.mesh
        return self._mesh

    @mesh.setter
    def mesh(self, m):
        self._mesh = m

    def _drop_sharded_key(self, key) -> None:
        # caller holds _cache_lock (or is the only thread)
        self._sharded.pop(key, None)
        self._lru_drop(self._sharded, key)

    @staticmethod
    def _shard(a: CSRArena, mesh, offset_of):
        """``a`` row-sharded over ``mesh``'s model axis on the host,
        rolled by the placement offset ``offset_of(host shards)`` returns,
        each shard then moved onto its chip.  Returns (ShardedArena,
        offset)."""
        from dgraph_tpu_torch.mesh.plan import MeshPlan
        from dgraph_tpu_torch.parallel.mesh import shard_arena_rows

        n = int(mesh.shape["model"])
        sa = shard_arena_rows(a.h_src, a.h_offsets, a.host_dst(), n)
        off = offset_of(sa)
        return MeshPlan.rolled(sa, off % n).to(mesh.model_devices()), off

    def sharded_csr(self, pred: str, reverse: bool = False):
        """Row-sharded view of a predicate's CSR over the mesh's model
        axis, cached against the source arena's identity (rebuilds follow
        the arena's own dirty invalidation), the mesh width (an elastic
        re-shard changes it) and the MeshPlan offset it was placed under
        (a ``rebalance()`` moves a predicate's offset)."""
        a = self.reverse(pred) if reverse else self.data(pred)
        pkey = ("~" + pred) if reverse else pred

        def offset_of(sa):
            # placement is assigned on first sight (least-loaded chip)
            if self.mesh_plan is None:
                return 0
            self.mesh_plan.offset_for(pkey, sa.device_bytes())
            return self.mesh_plan.placement.get(pkey, 0)

        def build():
            sa, off = self._shard(a, self.mesh, offset_of)
            return (a, sa, off)

        def valid(e):
            if e[0] is not a:
                return False
            if e[1].n_shards != int(self.mesh.shape["model"]):
                return False
            if self.mesh_plan is None:
                return True
            return self.mesh_plan.placement.get(pkey, 0) == e[2]

        return self._get_or_build(
            self._sharded, (pred, reverse), build, valid=valid
        )[1]

    def mesh_executor(self):
        """The memoized serving-path executor (mesh/executor.py) over
        this manager's mesh; None when unsharded."""
        if self.mesh is None:
            return None
        if self._mesh_exec is None:
            from dgraph_tpu_torch.mesh.executor import MeshExecutor

            self._mesh_exec = MeshExecutor(self)
        return self._mesh_exec

    def use_mesh_for(self, arena: CSRArena) -> bool:
        """Route this arena's expansions through the row-sharded mesh?

        Never below ``shard_threshold`` rows (``DGRAPH_TPU_MESH_SHARD_ROWS``).
        At or above it, the policy follows what the mesh is:
          - virtual chips of one card, or a 1-wide mesh: shard — the
            caller built the mesh to run the sharded plane;
          - more than one distinct card: the crossover model
            (parallel/crossover.py, the card's measured constants) —
            shard when it predicts sharded wins for a typical query
            against this arena's size, or when one card cannot hold it."""
        mesh = self.mesh
        if mesh is None or arena.n_rows < self.shard_threshold:
            return False
        n = int(mesh.shape["model"])
        if n < 2 or not mesh.distinct:
            return True
        from dgraph_tpu_torch.parallel.crossover import should_shard

        arena_bytes = 12 * arena.n_rows + 4 * arena.n_edges
        avg_deg = arena.n_edges / max(1, arena.n_rows)
        return should_shard(arena_bytes, arena.n_rows, avg_deg, n)

    def drop_sharded(self) -> None:
        """Drop every sharded view — the elastic re-shard's cache
        surgery: the evicted width's views are dead weight on the new
        sub-mesh, and the survivors re-seed lazily through sharded_csr
        under the same budget (this IS the re-seeding mechanism)."""
        with self._cache_lock:
            for key in list(self._sharded):
                self._drop_sharded_key(key)

    def warm_sharded(self, mesh):
        """Pre-build sharded views at a rejoin CANDIDATE mesh's width —
        the warm half of warm-then-cutover, run on the fault domain's
        probe thread while live traffic keeps serving the current
        sub-mesh.  Offsets come from the plan's ``preview`` of the
        candidate width, so the cutover's ``rebalance`` finds the adopted
        entries valid.  Build failures propagate: an unprovable warm
        means no cutover."""
        from dgraph_tpu_torch.mesh.fault import StagedShards

        n_model = int(mesh.shape["model"])
        staged = StagedShards(n_model)
        with self._cache_lock:
            keys = list(self._sharded)
        preview = (
            self.mesh_plan.preview(n_model)
            if self.mesh_plan is not None
            else {}
        )
        for pred, reverse in keys:
            a = self.reverse(pred) if reverse else self.data(pred)
            pkey = ("~" + pred) if reverse else pred
            sa, off = self._shard(
                a, mesh, lambda _sa, k=pkey: preview.get(k, 0) % n_model
            )
            staged.views[(pred, reverse)] = (a, sa, off)
        return staged

    def adopt_sharded(self, staged) -> None:
        """The cutover half of warm-then-cutover: install the staged views
        with budget accounting as if each had just been built (a stage
        whose width no longer matches the live mesh is discarded)."""
        if self.mesh is None or int(self.mesh.shape["model"]) != staged.width:
            return
        with self._cache_lock:
            for key, entry in staged.views.items():
                self._sharded[key] = entry
                self._touch((id(self._sharded), key), entry)

    # -- data / reverse ----------------------------------------------------

    def data(self, pred: str) -> CSRArena:
        self.refresh()
        return self._get_or_build(
            self._data, pred, lambda: self._build_data(pred)
        )

    def _build_data(self, pred: str) -> CSRArena:
        pd = self.store.peek(pred)
        if pd is not None and pd.edges:
            return csr_from_edges(*_edges_columnar(pd.edges), self.device)
        return _build_csr({}, self.device)

    def has_rows(self, pred: str) -> CSRArena:
        """Arena whose rows are every uid with *any* posting (edge or
        value) for the predicate — serves has(pred)."""
        self.refresh()
        pd = self.store.peek(pred)
        if pd is None or not pd.values:
            return self.data(pred)
        return self._get_or_build(
            self._data, pred + "\x00has", lambda: self._build_has(pred)
        )

    def _build_has(self, pred: str) -> CSRArena:
        pd = self.store.peek(pred)
        universe = np.fromiter(pd.uids_with_data(), dtype=np.int64)
        src, dst = _edges_columnar(pd.edges)
        return csr_from_edges(src, dst, self.device, row_universe=universe)

    def reverse(self, pred: str) -> CSRArena:
        self.refresh()
        return self._get_or_build(
            self._reverse, pred, lambda: self._build_reverse(pred)
        )

    def _build_reverse(self, pred: str) -> CSRArena:
        pd = self.store.peek(pred)
        if pd is not None and pd.edges:
            src, dst = _edges_columnar(pd.edges)
            return csr_from_edges(dst, src, self.device)  # inverted
        return _build_csr({}, self.device)

    # -- secondary indexes ---------------------------------------------------

    def index(self, pred: str, tokenizer: str) -> IndexArena:
        self.refresh()
        return self._get_or_build(
            self._index,
            (pred, tokenizer),
            lambda: self._build_index(pred, tokenizer),
        )

    def _build_index(self, pred: str, tokenizer: str) -> IndexArena:
        tk = tokmod.get_tokenizer(tokenizer)
        pd = self.store.peek(pred)
        buckets: Dict[object, set] = {}
        if pd is not None:
            for (uid, _lang), val in pd.values.items():
                try:
                    # fulltext analyzes under the VALUE's language tag
                    toks = tokmod.tokens_for_value_lang(tk.name, val, _lang)
                except (ValueError, TypeError, OverflowError):
                    continue  # unindexable value (wrong type, inf, ...)
                for t in toks:
                    buckets.setdefault(t, set()).add(uid)
        tokens = sorted(buckets.keys())
        rows = {
            i: np.fromiter(buckets[t], dtype=np.int64, count=len(buckets[t]))
            for i, t in enumerate(tokens)
        }
        csr = _build_csr(rows, self.device)
        csr.src = None  # implicit rows: row i of the CSR == tokens[i]
        return IndexArena(tokenizer=tokenizer, tokens=tokens, csr=csr, lossy=tk.lossy)

    # -- numeric values ------------------------------------------------------

    def values(self, pred: str) -> ValueArena:
        self.refresh()
        return self._get_or_build(
            self._values, pred, lambda: self._build_values(pred)
        )

    def _build_values(self, pred: str) -> ValueArena:
        pd = self.store.peek(pred)
        pairs: Dict[int, float] = {}
        langless = True
        if pd is not None:
            # deterministic language choice: the untagged value wins, else
            # the lexicographically first language (stable across ingest
            # order, unlike dict iteration)
            for (uid, lang) in sorted(
                pd.values.keys(), key=lambda k: (k[0], k[1] != "", k[1])
            ):
                if lang:
                    langless = False
                if uid in pairs:
                    continue
                x = numeric(pd.values[(uid, lang)])
                if x is not None:
                    pairs[uid] = x
        uids = np.array(sorted(pairs.keys()), dtype=np.int64)
        vals = np.array([pairs[u] for u in uids], dtype=np.float64)
        S = len(uids)
        Sb = ops.bucket(max(1, S))
        su = np.full(Sb, SENT, dtype=np.int32)
        su[:S] = uids.astype(np.int32)
        vv = np.full(Sb, np.nan, dtype=np.float32)
        vv[:S] = vals.astype(np.float32)
        # dense rank of the exact float64 value: the device order-by sorts
        # by rank, immune to float32 rounding collisions
        rk = np.full(Sb, -1, dtype=np.int32)
        if S:
            rk[:S] = np.searchsorted(np.unique(vals), vals).astype(np.int32)
        return ValueArena(
            src=_to_device(su, self.device),
            vals=_to_device(vv, self.device),
            ranks=_to_device(rk, self.device),
            h_src=uids,
            h_vals=vals,
            h_ranks=rk[:S].copy(),
            n=S,
            langless=langless,
        )
