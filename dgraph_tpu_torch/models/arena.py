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

Arenas are rebuilt per dirty predicate from the host store, or patched
in place from the store's delta journal (``ArenaManager.refresh``).
Not ported yet: the chunked layout, MXU tiles, the hop cache, IVM repair
and mesh sharding.
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
from dgraph_tpu_torch.ops.sets import SENT
from dgraph_tpu_torch.utils import planconfig

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
        for pair in (self._inline, self._inline_grouped):
            if pair is not None:
                n += sum(_nbytes(t) for t in pair)
        if self._resident is not None:
            n += self._resident.device_bytes()
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
        self._inline = None
        self._inline_grouped = None
        self._lut = None
        self._n_distinct_dst = None
        self._topm_deg = None
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

    def __init__(
        self,
        store: PostingStore,
        device=None,
        budget_bytes: Optional[int] = None,
    ):
        self.store = store
        self.device = resolve(device)
        # single source of truth for host-vs-device expansion routing
        # (engine and FuncResolver both read it; the engine may retune)
        self.expand_device_min = planconfig.expand_device_min()
        # the same for k-way intersections (query/joinplan.py)
        self.kway_device_min = planconfig.kway_device_min()
        self._data: Dict[str, CSRArena] = {}
        self._reverse: Dict[str, CSRArena] = {}
        self._index: Dict[Tuple[str, str], IndexArena] = {}
        self._values: Dict[str, ValueArena] = {}
        self._cache_lock = threading.RLock()
        self.budget_bytes = int(
            budget_bytes if budget_bytes is not None
            else default_budget_bytes(self.device)
        )
        self._lru: "OrderedDict[tuple, int]" = OrderedDict()  # (cache id, key) -> bytes
        self._lru_total = 0
        self._caches_by_id = {
            id(self._data): self._data,
            id(self._reverse): self._reverse,
            id(self._index): self._index,
            id(self._values): self._values,
        }

    def _get_or_build(self, cache, key, build):
        with self._cache_lock:
            a = cache.get(key)
            if a is None:
                a = build()
                cache[key] = a
            self._touch((id(cache), key), a)
            return a

    def _touch(self, lkey: tuple, obj) -> None:
        """LRU bookkeeping under _cache_lock: refresh recency + size (the
        resident arena built after caching grows the footprint)."""
        new = obj.device_bytes()
        self._lru_total += new - self._lru.get(lkey, 0)
        self._lru[lkey] = new
        self._lru.move_to_end(lkey)
        if not self.budget_bytes:
            return
        while self._lru_total > self.budget_bytes and len(self._lru) > 1:
            victim, vbytes = next(iter(self._lru.items()))
            if victim == lkey:
                break
            self._lru.pop(victim)
            self._lru_total -= vbytes
            self._caches_by_id[victim[0]].pop(victim[1], None)

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
            dirty = self.store.dirty
            if not dirty:
                return
            if "*" in dirty:  # full-store replacement
                for c in (self._data, self._reverse, self._index, self._values):
                    c.clear()
                self._lru.clear()
                self._lru_total = 0
                dirty.discard("*")
            deltas = self.store.delta
            for p in list(dirty):
                delta = deltas.pop(p, None)
                if delta is not None and self._try_apply_delta(p, delta):
                    dirty.discard(p)
                    continue
                for key in [k for k in self._data if k == p or k.startswith(p + "\x00")]:
                    self._data.pop(key, None)
                    self._lru_drop(self._data, key)
                self._reverse.pop(p, None)
                self._lru_drop(self._reverse, p)
                for key in [k for k in self._index if k[0] == p]:
                    self._index.pop(key, None)
                    self._lru_drop(self._index, key)
                self._values.pop(p, None)
                self._lru_drop(self._values, p)
                dirty.discard(p)

    def _try_apply_delta(self, pred: str, delta: list) -> bool:
        """Incrementally update the cached data (and reverse) arena for
        ``pred``.  False when no cached arena exists (the next access
        builds fresh anyway), a has-rows variant is cached (its row
        universe can shift), or delete churn left too many empty rows."""
        a = self._data.get(pred)
        if a is None or (pred + "\x00has") in self._data:
            return False
        if not delta:
            return True  # facet-only touches: arenas unaffected
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
        return True

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
