"""Query execution (PyTorch port of ``dgraph_tpu/query/engine.py``).

Level-batched execution: each (level × predicate) becomes ONE expansion
over the arena instead of per-key posting-list loops; filters combine
uid sets on the host, ordering runs on the host, and the JSON encoding
is the reference's, so responses are byte-identical to the JAX engine's.

Expansion routes (``DeviceExpander``), in the reference's order:
``empty``, ``mesh`` (a predicate the arena manager shards over the
engine's mesh: ``mesh/executor.py``, each chip expanding its uid range
and the segments reassembled on the devices), ``host`` (numpy over the
host mirror, where the planner prices it cheaper:
``query/planner.py``), ``resident`` (the
hand-written gather kernel over the device-resident CSR, the default on
a CUDA device), ``classed`` (``ops.ClassedExpander``: one masked 2-D
gather per degree class, torch ops; an ascending frontier, by default
on a CPU device only), ``inline`` (``ops.expand_inline_seg`` over the
inline-head layout, its slot map the slot-map kernel; an ascending
frontier) and ``csr`` (torch ``expand_csr`` over the staged CSR: any
frontier order).
Before any per-level expansion, a uid child tries the fused chain
(``query/chain.py``): where the planner prices it cheaper than per-level
execution (the static ``chain_threshold`` when it is off) a whole
chain of levels runs on the device through the same expansion call,
one fetch for all of them, and its levels are consumed from their
``chain_stash``.  ``@recurse`` (``query/recurse.py``; an internal
single-template one as one fused BFS), ``shortest``
(``query/shortest.py``) and ``@groupby`` (``query/groupby.py``) expand
through the same ``DeviceExpander``.  The join tier
(``query/joinplan.py``): a light chain may run as one mask chain over
adjacency tiles (``try_mxu_route``, called by the fused chain), and,
unless ``DGRAPH_TPU_MXU_JOIN=0``, an ``@filter`` AND with at least two
leaves that resolve without the frontier intersects them with the
candidates in one ``kway_intersect`` call, on the intersect kernel
where the planner prices it cheaper than the host fold.  Order-by on a
numeric, date or bool predicate runs on the device above
``expand_device_min``
(``_device_order_perm``: value ranks from the predicate's
``ValueArena``, one stable segmented sort); string keys,
language-tagged values and value variables sort on the host.  Above
the routing, each expansion probes the tier-1 hop cache
(``cache/hop.py``) and, on a cohort member of the scheduler
(``sched/scheduler.py``), merges with the same hop of other requests
into one union expansion (``DeviceExpander.submit_hop``); every hop is
a cancellation checkpoint (``QueryEngine.checkpoint``).  Every device
dispatch runs under the device guard (``utils/devguard.py``); a fault
raises to the caller, never to a host route.  The one failover is the
mesh's: a level whose mesh dispatch faulted (or whose mesh plane is
latched sick) re-plans on the card's unsharded routes, disclosed as
``degraded.device``; a level served on a surviving sub-mesh after a chip
loss is disclosed as ``degraded.mesh``.  Filters other than the k-way
AND and a fused chain's keep-sets fold on the host.  With
``dump_shapes`` set (the server's ``--dumpsg``) each request leaves the
execution shape of its blocks in ``last_dump``
(``query/subgraph.dump_dict``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dgraph_tpu_torch import gql, ivm, obs, ops
from dgraph_tpu_torch.obs import ledger as _ledger
from dgraph_tpu_torch.gql.ast import FilterTree, MathTree, referenced_preds
from dgraph_tpu_torch.models.arena import ArenaManager
from dgraph_tpu_torch.models.store import PostingStore
from dgraph_tpu_torch.models.types import TypeID, TypedValue, numeric, sort_key
from dgraph_tpu_torch.query.functions import FuncResolver, QueryError
from dgraph_tpu_torch.query.subgraph import SubGraph, build_subgraph
from dgraph_tpu_torch.query import (
    chain, groupby, joinplan, outputnode, planner, recurse, shortest,
)
from dgraph_tpu_torch.sched import segments as _segments
from dgraph_tpu_torch.utils import devguard, planconfig
from dgraph_tpu_torch.utils.failpoints import fail
from dgraph_tpu_torch.utils.metrics import DEVICE_FAILOVER

_EMPTY = np.empty(0, dtype=np.int64)


def _plan_rows(arena, src: np.ndarray) -> Tuple[np.ndarray, int]:
    """``src``'s arena rows (-1 where a uid has none) and their edge
    count: what a level's routing and the fused chain's estimate read."""
    if arena.n_edges == 0:
        return np.full(len(src), -1, dtype=np.int64), 0
    rows = arena.rows_for_uids_host(src)
    return rows, int(arena.degree_of_rows(rows).sum())


def _fresh_stats() -> dict:
    """Per-request engine stats: edges traversed, per-stage wall time
    (ms: expansions by route, resolver expansions, fused-chain attempts
    with their planning, k-way intersections, device order-by, JSON-tree
    encoding), the count of each expansion route and each k-way route
    taken, the count of order-by sorts run on the device, the join-route
    decisions of the tile join tier (query/joinplan.py) with its tile
    builds and mask chains (``tile_build_ms``, ``mxu_join_ms``), the
    levels consumed from fused chains,
    why chain attempts fell back to per-level execution (bounded), and
    the gather calls the fused chain, multi-hop pass and fused
    @recurse made (``fused_gathers``; per-level gathers count under
    ``routes["resident"]``), and the root filters that stopped early on
    ``first: k`` (``first_early_exit``).  The planner's priced decisions
    land under ``planner`` (query/planner.py::record)."""
    return {
        "edges": 0,
        "host_expand_ms": 0.0,
        "device_expand_ms": 0.0,
        "resolver_expand_ms": 0.0,
        "chain_ms": 0.0,
        "kway_ms": 0.0,
        "device_order_ms": 0.0,
        "encode_ms": 0.0,
        "routes": {},
        "kway_device": 0,
        "kway_host": 0,
        "device_order": 0,
        "join_routes": [],
        "chain_fused_levels": 0,
        "chain_reject": [],
        "fused_gathers": 0,
        "tile_build_ms": 0.0,
        "mxu_join_ms": 0.0,
        "first_early_exit": 0,
    }


def _packed_expand_inline(metap, ov_chunks, rows: torch.Tensor,
                          capc: int) -> torch.Tensor:
    """The inline route's expansion, concatenated on the device for one
    fetch: ``[inline.ravel | ov.ravel | ovseg]``."""
    inline, ov, _total, ovseg = ops.expand_inline_seg(metap, ov_chunks, rows, capc)
    return torch.cat([inline.reshape(-1), ov.reshape(-1), ovseg])


def _seg_ptr_of(seg: np.ndarray, n: int) -> np.ndarray:
    seg_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(seg, minlength=n), out=seg_ptr[1:])
    return seg_ptr


class DeviceExpander:
    """Per-level expansion routing: ONE device dispatch (or one host
    numpy pass) per (level × predicate).

    Routing per call, the reference's order: ``empty`` (no edges to
    walk) → ``mesh`` (an arena ``ArenaManager.use_mesh_for`` shards:
    ``_mesh_expand``) → ``host`` (the planner's ``expand_route`` prices numpy
    cheaper; with the planner off or the knob pinned, a fan-out below
    ``expand_device_min``; never for a level the mesh failed over) → ``resident`` (the gather kernel over the
    arena's device-resident CSR) → ``classed`` (an ascending frontier:
    ``ops.ClassedExpander``'s masked class gathers) → ``inline`` (an
    ascending frontier: ``ops.expand_inline_seg``, whose slot map is the
    slot-map kernel) → ``csr`` (torch ``expand_csr`` over the staged CSR
    tensors, any frontier order).  The resident route is taken when
    ``_use_resident()``: DGRAPH_TPU_RESIDENT '0' never, '1' (default) on
    a CUDA device, 'force' on any device — on the CPU the gather wrapper
    then runs its plain version (the parity tests).  ``fused_hop`` is the
    reference's DGRAPH_TPU_FUSED_HOP: '0' turns the classed route, the
    chain's multi-hop pass and the fused var-block @recurse off; '1' takes
    the classed route on a CPU device (as the reference does on its CPU
    backend); 'force' on any device.  A bool assigned to it reads as
    '1' (True) or '0' (False).  On a CPU tensor the slot-map wrapper
    runs its plain version.  Above the routing sit the tier-1 hop
    cache and, under the cohort scheduler, the cross-request hop merger
    (``_expand_cached``).  Each device expansion — the rows' upload, the
    launch and the one fetch — runs under the device guard
    (utils/devguard.py, failpoint site ``device.hop``): an out-of-memory
    fault evicts LRU arenas and retries once on the card
    (``_run_guarded``); any other fault, a wedged dispatch or a domain
    latched sick raises ``DeviceFaultError`` (the server's 503).  There
    is no host failover."""

    def __init__(self, engine: "QueryEngine"):
        self.engine = engine
        self.resident_mode = planconfig.resident()
        self.fused_hop = planconfig.fused_hop()
        # cross-request hop coalescing: the cohort scheduler
        # (sched/scheduler.py) installs one HopMerger per cohort so
        # same-(arena, predicate, direction) expansions from different
        # requests sharing a snapshot merge into ONE expansion
        self.hop_merger = None
        # the route the last expansion took (empty/host/resident/csr)
        self._route = ""
        # the planner's decision of the expansion in flight, closed with
        # its measured latency by _expand_one
        self._expand_dec = None

    @property
    def fused_hop(self) -> str:
        return self._fused_hop

    @fused_hop.setter
    def fused_hop(self, value) -> None:
        # the reference's string; a bool (the older spelling) maps onto
        # it, so False turns the fused routes off rather than on
        if isinstance(value, bool):
            value = "1" if value else "0"
        self._fused_hop = value

    def _use_resident(self) -> bool:
        if self.resident_mode == "0":
            return False
        if self.resident_mode == "force":
            return True
        return self.engine.device.type == "cuda"

    def _use_classed(self) -> bool:
        if self.fused_hop == "0":
            return False
        if self.fused_hop == "force":
            return True
        return self.engine.device.type == "cpu"

    def expand(
        self, arena, src: np.ndarray, attr: str = "", reverse: bool = False,
        plan=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Per-level expansion entry: returns (out, seg_ptr) — targets
        grouped by source row, seg_ptr[i]:seg_ptr[i+1] slicing row i's.
        ``plan``: ``src``'s (rows, edge count) when the caller already
        looked them up (``_plan_rows``); it serves the solo expansion
        only — a merged hop looks up the union's rows afresh.

        When the request is SAMPLED (obs/spans.py), each call records
        one ``hop`` span carrying the predicate, frontier size, edges
        traversed, the route the expansion took (cache/merged/host/
        resident/classed/inline/csr/empty) and the device/host split — on the device
        routes ``device_sync_ms``, the wait for the gather's result
        measured on a CUDA event before the fetch.  The unsampled path
        branches away before any span object exists.

        This call IS the hop boundary: the request's CancelToken
        (sched/qos.py) is checkpointed here — a cancelled or
        deadline-lapsed request stops BEFORE its next launch — and the
        ``engine.hop`` failpoint lets chaos tests stretch exactly this
        seam."""
        self.engine.checkpoint()
        fail.point("engine.hop")
        sp = obs.current_span()
        if sp is None:  # unsampled hot path: zero allocations, no waits
            out, seg_ptr = self._expand_cached(arena, src, attr, reverse, plan)
        else:
            st = self.engine.stats
            e0 = st["edges"]
            d0 = st["device_expand_ms"]
            h0 = st["host_expand_ms"]
            with sp.child("hop") as hs:
                out, seg_ptr = self._expand_cached(arena, src, attr, reverse, plan)
                hs.set_attr("pred", attr)
                if reverse:
                    hs.set_attr("reverse", True)
                hs.set_attr("n_src", int(len(src)))
                hs.set_attr("edges", int(st["edges"] - e0))
                hs.set_attr("route", self._route)
                dm = st["device_expand_ms"] - d0
                hm = st["host_expand_ms"] - h0
                if dm:
                    hs.set_attr("device_ms", round(dm, 3))
                if hm:
                    hs.set_attr("host_ms", round(hm, 3))
        routes = self.engine.stats["routes"]
        routes[self._route] = routes.get(self._route, 0) + 1
        led = _ledger.current()
        if led is not None:
            led.note_hop(self._route)
        return out, seg_ptr

    def _expand_cached(
        self, arena, src: np.ndarray, attr: str, reverse: bool, plan=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Tier-1 hop cache first (a repeat expansion over an unchanged
        predicate returns the memoized arrays: no launch, no copy), then
        the cohort hop merger when one is installed AND the expansion is
        big enough to be device-routed — merging a host-route numpy
        expansion costs more in union bookkeeping than it saves, while a
        gather launch and its round trip amortize across members."""
        hc = self.engine.arenas.hop_cache
        ver = hkey = None
        if hc is not None and attr and len(src):
            # pre-screen on the ESTIMATED result bytes: a frontier whose
            # expansion cannot be admitted should not even pay for the
            # digest
            est = (len(src) + len(src) * arena.avg_degree) * 8
            if est <= hc.max_entry_bytes:
                # predicate-scoped freshness (ivm/versions.py): writes to
                # other predicates leave the entry a hit
                ver = ivm.hop_version(self.engine.store, attr)
        if ver is not None:
            # one digest per call: the miss path re-uses it for the fill
            hkey = hc.key_for(arena, attr, reverse, src)
            cached = hc.get(arena, attr, reverse, src, ver, key=hkey)
            if cached is not None:
                self.engine.stats["edges"] += len(cached[0])
                self._route = "cache"
                return cached
        if (
            self.hop_merger is not None
            and attr
            and len(src)
            and planner.merge_gate(
                len(src) * arena.avg_degree, self.engine.expand_device_min
            )
        ):
            self._route = "merged"
            out, seg_ptr = self.submit_hop(arena, src, attr, reverse)
        else:
            out, seg_ptr = self._expand_one(arena, src, plan, attr, reverse)
        if ver is not None:
            # ``ver`` was read BEFORE the expansion: an entry can only
            # land under an older version — stale-keyed, never
            # stale-served
            hc.put(arena, attr, reverse, src, ver, out, seg_ptr, key=hkey)
        return out, seg_ptr

    def submit_hop(
        self, arena, src: np.ndarray, attr: str = "", reverse: bool = False
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Rendezvous this level's expansion with concurrent cohort
        members: same-(arena, predicate, direction) submissions merge
        into one union-frontier expansion — one gather launch on the
        device route — and each request gets its exact per-source
        segments back (sched/cohort.py::HopMerger: byte-identical to a
        solo expansion).  The leader's stats carry the union's edges and
        device time."""
        key = (attr, bool(reverse), id(arena))
        return self.hop_merger.submit(
            key, src,
            lambda union: self._expand_one(arena, union, None, attr, reverse),
        )

    def _host_expand(self, arena, rows) -> Tuple[np.ndarray, np.ndarray]:
        """Small expansions: vectorized numpy over the host CSR mirror."""
        eng = self.engine
        self._route = "host"
        with obs.stage(eng.stats, "host_expand_ms"):
            out, seg_ptr = arena.expand_host(rows)
        eng.stats["edges"] += len(out)
        return out, seg_ptr

    def _expand_one(
        self, arena, src: np.ndarray, plan=None, attr: str = "",
        reverse: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Wrapper around the expansion: closes the planner's host/device
        decision (made inside, where the exact fan-out is known) with
        the measured stage latency, which the mispredict check and the
        online rate refinement read."""
        st = self.engine.stats
        before = st["device_expand_ms"] + st["host_expand_ms"]
        self._expand_dec = None
        out, seg_ptr = self._expand_one_inner(arena, src, plan, attr, reverse)
        dec = self._expand_dec
        if dec is not None:
            self._expand_dec = None
            actual_ms = st["device_expand_ms"] + st["host_expand_ms"] - before
            planner.note_served_outcome(dec, actual_ms * 1e3)
        return out, seg_ptr

    def _mesh_expand(self, src, attr: str, reverse: bool, cap: int, total: int):
        """The sharded expansion under the ``"mesh"`` fault domain,
        dispatched through the mesh serving plane (mesh/executor.py —
        the guard bracket and the ledger's mesh attribution live there).
        Returns (out, seg_ptr), or None when the mesh plane is latched
        sick or its dispatch faulted without a chip to own it: the
        caller then re-plans this level on the card's unsharded routes,
        and the response discloses the failover (``degraded.device``)."""
        eng = self.engine
        ex = eng.arenas.mesh_executor()
        if ex is None or not ex.allowed():
            devguard.count_failover("unsharded", eng.stats, "mesh")
            return None
        # route:mesh is priced: the decision records the mesh estimate
        # against the best unsharded route, and _expand_one closes it with
        # the measured stage time (refining mesh_edge_us)
        _, dec = planner.mesh_route(total, ex.width)
        if dec is not None:
            planner.record(eng.stats, dec)
            self._expand_dec = dec
        try:
            out, seg_ptr = ex.expand(attr, reverse, src, cap, eng.stats)
        except devguard.DeviceFaultError:
            # a failed dispatch is not a rate sample for the mesh route
            self._expand_dec = None
            devguard.count_failover("unsharded", eng.stats, "mesh")
            return None
        self._route = "mesh"
        eng.stats["edges"] += len(out)
        return out, seg_ptr

    def _expand_one_inner(
        self, arena, src: np.ndarray, plan=None, attr: str = "",
        reverse: bool = False,
    ) -> Tuple[np.ndarray, np.ndarray]:
        eng = self.engine
        n = len(src)
        if n == 0 or arena.n_edges == 0:
            self._route = "empty"
            return _EMPTY, np.zeros(n + 1, dtype=np.int64)
        rows, total = _plan_rows(arena, src) if plan is None else plan
        if total == 0:
            self._route = "empty"
            return _EMPTY, np.zeros(n + 1, dtype=np.int64)
        failed_over = False
        if attr and eng.arenas.use_mesh_for(arena):
            got = self._mesh_expand(src, attr, reverse, ops.bucket(total), total)
            if got is not None:
                return got
            # the mesh plane is latched or its dispatch faulted: the
            # level re-plans on the card's unsharded routes below, never
            # on the host
            failed_over = True
        # host/device: the priced break-even by default, the static
        # expand_device_min compare when the planner is off or the knob
        # is pinned
        use_resident = self._use_resident()
        use_device = True
        if not failed_over:
            use_device, dec = planner.expand_route(
                total, eng.expand_device_min, resident=use_resident
            )
            if dec is not None:
                planner.record(eng.stats, dec)
                self._expand_dec = dec
        if not use_device:
            # a device dispatch costs a round trip that dwarfs the work
            return self._host_expand(arena, rows)
        if not use_resident and self._ascending(rows):
            # the classed and inline routes need ASCENDING-distinct rows;
            # an ordered root permutes the frontier, which only the
            # order-agnostic csr route takes
            if self._use_classed():
                return self._expand_classed(arena, rows)
            return self._expand_inline(arena, rows)
        cap = ops.bucket(total)
        padded = ops.pad_rows(rows, ops.bucket(n))
        # the hop span ``expand`` opened (a merged hop's union runs in
        # its leader's thread, under the leader's span); None unsampled
        hs = obs.current_span()
        self._route = "resident" if use_resident else "csr"

        def _dispatch():
            # upload, expansion and the ONE fetch, all inside the device
            # guard's watchdog: an OOM staging the rows classifies like
            # a launch's, and the fetch surfaces an asynchronous fault
            # here.  Plain data out: stats, ledger and span writes stay
            # on the caller's thread, so a wedged worker that wakes up
            # later writes nothing a newer request owns
            fail.point("device.hop")
            t = {}
            with obs.stage(t, "ms"):
                dev = self.expand_rows(
                    arena, torch.from_numpy(padded).to(arena.device), cap
                )
                # sampled: split the device's compute from the host fetch
                sync_ms = obs.block_ready_ms(dev) if hs is not None else None
                # one fetch: out|seg concatenated on the device
                packed = dev.cpu().numpy()
            return packed, sync_ms, t["ms"]

        packed, sync_ms, ms = self._run_guarded("device.hop", _dispatch)
        self._account(ms, sync_ms, hs, padded.nbytes, packed.nbytes)
        out = packed[:total].astype(np.int64)
        seg = packed[cap : cap + total].astype(np.int64)
        eng.stats["edges"] += len(out)
        return out, _seg_ptr_of(seg, n)

    @staticmethod
    def _ascending(rows: np.ndarray) -> bool:
        valid = rows[rows >= 0]
        return bool(np.all(valid[1:] > valid[:-1]))

    def _account(self, ms: float, sync_ms, hs, h2d: int, d2h: int) -> None:
        """A device expansion's stage time, its ``device_sync_ms`` (on the
        hop span and the ledger) and its transfers.  The stage is the
        dispatch's own time on the guard's worker, without the hand-off:
        the planner refines the device rate from it."""
        self.engine.stats["device_expand_ms"] += ms
        led = _ledger.current()
        if sync_ms is not None:
            hs.set_attr("device_sync_ms", round(sync_ms, 3))
            if led is not None:
                led.device_sync_ms += sync_ms
        if led is not None:
            led.bytes_h2d += int(h2d)
            led.bytes_d2h += int(d2h)

    def _expand_classed(self, arena, rows: np.ndarray):
        """The classed route: one plan of the arena's ClassedExpander
        (ops/batch.py) over the ascending rows, one fetch, the uid
        matrix reassembled on the host from the rows' degrees."""
        self._route = "classed"
        degs = arena.degree_of_rows(rows)

        def _dispatch():
            fail.point("device.hop")
            t = {}
            with obs.stage(t, "ms"):
                # re-uploads the staged CSR after host deltas
                ce = ops.classed_for_arena(arena)
                out, seg_ptr = ce.expand_rows(rows, degs)
            return out, seg_ptr, t["ms"]

        out, seg_ptr, ms = self._run_guarded("device.hop", _dispatch)
        self._account(ms, None, None, rows.nbytes, out.nbytes + seg_ptr.nbytes)
        self.engine.stats["edges"] += len(out)
        return out, seg_ptr

    def _expand_inline(self, arena, rows: np.ndarray):
        """The inline route: ``ops.expand_inline_seg`` over the arena's
        inline-head layout (one metadata row gather serves a row's first
        INLINE targets, overflow chunks through the slot-map kernel),
        concatenated on the device for one fetch and unpacked into the
        uid matrix on the host (``chain.packed_inline_to_matrix``)."""
        n = len(rows)
        B = ops.bucket(n)
        capov = ops.bucket(
            max(1, int(arena.ov_chunk_degree_of_rows(rows).sum()))
        )
        padded = ops.pad_rows(rows, B)
        hs = obs.current_span()
        self._route = "inline"

        def _dispatch():
            fail.point("device.hop")
            # the layout's staging inside the bracket: an out-of-memory
            # uploading it classifies like a launch's
            metap, ov_chunks = arena.inline_layout()
            t = {}
            with obs.stage(t, "ms"):
                dev = _packed_expand_inline(
                    metap, ov_chunks, torch.from_numpy(padded).to(arena.device),
                    capov,
                )
                sync_ms = obs.block_ready_ms(dev) if hs is not None else None
                packed = dev.cpu().numpy()
            return packed, sync_ms, t["ms"]

        packed, sync_ms, ms = self._run_guarded("device.hop", _dispatch)
        self._account(ms, sync_ms, hs, padded.nbytes, packed.nbytes)
        out, seg_ptr = chain.packed_inline_to_matrix(packed, B, capov, n)
        self.engine.stats["edges"] += len(out)
        return out, seg_ptr

    def _run_guarded(self, op: str, fn):
        """Run one dispatch-and-fetch closure under the device guard
        (utils/devguard.py; the twin of the reference's ``_run_guarded``
        without its host landing).  An out-of-memory fault gets LRU
        eviction (``ArenaManager.evict_for_oom``) and ONE retry on the
        card; any other fault, a second one, or an OOM with nothing left
        to evict raises ``DeviceFaultError`` (the server's 503).  A
        failed dispatch is no rate sample: the planner's expand decision
        is dropped, never closed."""
        g = devguard.get()
        try:
            return g.run(op, fn)
        except devguard.DeviceFaultError as e:
            if e.kind != "oom" or not self.engine.arenas.evict_for_oom():
                self._expand_dec = None
                raise
        # the budget is an estimate, the allocator's verdict is ground
        # truth: LRU arenas are gone, re-prove the dispatch once
        DEVICE_FAILOVER.add("evict_retry")
        g.note_evict_retry()
        try:
            return g.run(op, fn)
        except devguard.DeviceFaultError:
            self._expand_dec = None
            raise

    def expand_rows(self, arena, rows: torch.Tensor, cap: int) -> torch.Tensor:
        """Device expansion of int32 ``rows`` (-1 skips) on this route:
        the packed ``concat([out, seg])`` int32[2·cap], device-in and
        device-out (the per-level route's and the fused chain's call).
        It sets no expander state: it runs inside guarded closures, and
        the caller names the route."""
        if self._use_resident():
            # the CSR pinned on the device: no re-staging rides this
            # dispatch
            return arena.resident().expand_packed(rows, cap)
        arena.ensure_device()  # re-upload after host deltas
        out_d, seg_d, _t = ops.expand_csr(arena.offsets, arena.dst, rows, cap)
        return torch.cat([out_d, seg_d])

    def csr_buffers(self, arena) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (offsets, dst) device buffers this route walks: the
        resident CSR's live epoch, or the staged CSR (what the multi-hop
        pass gathers from)."""
        if self._use_resident():
            ra = arena.resident()
            return ra.off, ra.dst
        arena.ensure_device()
        return arena.offsets, arena.dst


class QueryEngine:
    """One engine instance per request at a time; concurrent requests
    run on engine shells of their own over one shared ArenaManager (the
    cohort scheduler's members, sched/scheduler.py), as the reference
    runs per-request goroutines over shared immutable posting state."""

    def __init__(
        self,
        store: PostingStore,
        device=None,
        arenas: Optional[ArenaManager] = None,
        arena_budget_bytes: Optional[int] = None,
        mesh=None,
        shard_threshold: int = 4096,
    ):
        """``device`` is where the arenas live and the kernels run:
        ``cuda`` by default (raises without a GPU), ``"cpu"`` on request.
        ``arenas`` shares a warm ArenaManager (and its device) between
        engine instances.  ``mesh`` (``parallel.make_mesh``) row-shards
        every predicate of at least ``shard_threshold`` rows over its
        model axis (the ``mesh`` route)."""
        self.store = store
        self.arenas = (
            arenas
            if arenas is not None
            else ArenaManager(
                store, device=device, budget_bytes=arena_budget_bytes,
                mesh=mesh, shard_threshold=shard_threshold,
            )
        )
        # per-level expansion routing — see DeviceExpander
        self.expander = DeviceExpander(self)
        # minimum estimated fan-out before a uid chain fuses
        # (query/chain.py); assigning it pins the gate
        self.chain_threshold = planconfig.chain_threshold()
        # whether the block being executed is a var block: its chains
        # run light (query/chain.py)
        self._cur_block_internal = False
        # the planner's decision of a chain that ran, closed with the
        # chain's measured latency (query/chain.py sets it)
        self._pending_chain_dec = None
        # per-request execution stats (reset by run_parsed)
        self.stats = _fresh_stats()
        # --dumpsg: with dump_shapes set (by the server), each request
        # leaves its blocks' execution shapes (never the result-bearing
        # trees) in last_dump, reset per request
        self.dump_shapes = False
        self.last_dump = None
        # cooperative cancellation (sched/qos.py): the scheduler installs
        # the request's CancelToken here; checkpoint() probes it at hop
        # boundaries.  None (embedded engines, QoS off) costs one
        # attribute read per checkpoint.
        self.cancel = None

    def checkpoint(self) -> None:
        """Cooperative cancellation checkpoint: raises
        QueryCancelledError when this request's token flipped (deadline
        lapse, client disconnect).  Placed at hop boundaries only — a
        launched kernel always completes, so cancellation latency is
        bounded by one hop.  A checkpoint is also a scheduler yield
        point: after the token probe it offers the seam to a queued
        higher-priority cohort (sched/segments.py)."""
        tok = self.cancel
        if tok is not None:
            tok.check()
        ctx = _segments.current()
        if ctx is not None and ctx.preempt is not None:
            ctx.preempt()

    @property
    def device(self) -> torch.device:
        return self.arenas.device

    @property
    def expand_device_min(self) -> int:
        return self.arenas.expand_device_min

    @expand_device_min.setter
    def expand_device_min(self, v: int) -> None:
        self.arenas.expand_device_min = v

    # -- public ------------------------------------------------------------

    def run(self, text: str, variables: Optional[Dict[str, str]] = None) -> dict:
        """Parse and execute a request; returns the JSON-able response dict
        (the analog of ProcessWithMutation + ToFastJSON)."""
        return self.run_parsed(gql.parse(text, variables))

    def run_parsed(self, parsed: "gql.ParsedResult") -> dict:
        """Execute an already-parsed request — the single request pipeline
        shared by the embedded path (run) and the HTTP server."""
        self.stats = _fresh_stats()
        self.last_dump = None
        # arm the fused hop loops' segment seams for this request.  A
        # scheduler-installed context contributes the preempt hook (and
        # the token it registered); with none active (embedded engines,
        # DGRAPH_TPU_SCHED=0) a token-only context still bounds mid-chain
        # cancellation to one segment.  Either way the stats binding is
        # re-made here — the line above just replaced the dict the outer
        # context captured.
        outer = _segments.current()
        prev = _segments.activate(_segments.SegmentContext(
            token=outer.token if outer is not None else self.cancel,
            preempt=outer.preempt if outer is not None else None,
            stats=self.stats,
        ))
        try:
            return self._run_parsed_inner(parsed)
        finally:
            _segments.deactivate(prev)

    def _run_parsed_inner(self, parsed: "gql.ParsedResult") -> dict:
        out: dict = {}
        if parsed.mutation is not None:
            from dgraph_tpu_torch.serve.mutations import (
                apply_mutation,
                format_assigned_uids,
            )

            blanks = apply_mutation(self.store, parsed.mutation)
            if blanks:
                # assigned blank-node uids, as the reference's mutation
                # response carries (protos AssignedUids)
                out["uids"] = format_assigned_uids(blanks)
        if parsed.schema_request is not None:
            out["schema"] = self._schema_response(parsed.schema_request)
        if parsed.queries:
            out.update(self.execute(parsed))
            # graceful degradation (ClusterStore.degraded_info): when any
            # owner group's snapshots are served from cache because the
            # owners are unreachable, the response says so — stale-but-
            # correct data WITH a freshness disclosure instead of an
            # error page.  Scoped to the predicates THIS query can read
            # (None = not statically knowable, e.g. expand(): node-wide
            # view); passed as a thunk so the AST walk only runs when
            # something IS degraded
            deg = getattr(self.store, "degraded_info", None)
            if deg is not None:
                info = deg(preds=lambda: referenced_preds(parsed.queries))
                if info:
                    out["degraded"] = info
            # the mesh's failover (a level re-planned on the card's
            # unsharded routes) says so: the results are byte-identical,
            # only the route changed.  Absent on every fault-free request
            if self.stats.get("device_failover"):
                out.setdefault("degraded", {})["device"] = {
                    "failovers": int(self.stats["device_failover"]),
                    "domains": {
                        d: {
                            "state": st["state"],
                            "last_fault": st["last_fault"],
                            "retry_after": st["cooldown_s"],
                        }
                        for d, st in devguard.summary().items()
                        if st["state"] != "healthy" or st["faults"]
                    },
                }
            # the elastic mesh fault domain (mesh/fault.py): a request
            # served on a SURVIVING sub-mesh, or drained and resumed
            # across an epoch flip, carries the epoch and capacity (gRPC
            # mirrors the epoch as a dgraph-mesh-epoch trailer)
            if self.stats.get("mesh_degraded"):
                out.setdefault("degraded", {})["mesh"] = dict(
                    self.stats["mesh_degraded"]
                )
        elif parsed.mutation is not None and "schema" not in out:
            out["code"] = "Success"
            out["message"] = "Done"
        return out

    def execute(self, parsed: gql.ParsedResult) -> dict:
        uid_vars: Dict[str, np.ndarray] = {}
        value_vars: Dict[str, Dict[int, TypedValue]] = {}
        blocks = [build_subgraph(q) for q in parsed.queries]
        deps = parsed.query_vars

        done = [False] * len(blocks)
        out: dict = {}
        for _round in range(len(blocks) + 1):
            progressed = False
            for i, sg in enumerate(blocks):
                if done[i]:
                    continue
                defines = deps[i][0] if i < len(deps) else []
                needs = deps[i][1] if i < len(deps) else []
                # a block may consume vars it defines itself (math over
                # sibling-defined vars); only external needs gate scheduling
                if any(
                    n not in uid_vars and n not in value_vars and n not in defines
                    for n in needs
                ):
                    continue
                self._exec_block(sg, uid_vars, value_vars)
                done[i] = True
                progressed = True
            if all(done):
                break
            if not progressed:
                raise QueryError("circular variable dependency between blocks")

        if self.dump_shapes:
            from dgraph_tpu_torch.query.subgraph import dump_dict

            self.last_dump = [dump_dict(sg) for sg in blocks]
        with obs.stage(self.stats, "encode_ms"):
            for sg in blocks:
                if sg.params.is_internal:
                    continue
                name = sg.params.alias or "me"
                if sg.params.is_shortest:
                    outputnode.encode_path(self.store, sg, out)
                    continue
                out.setdefault(name, []).extend(
                    outputnode.encode_block(self.store, sg)
                )
        return out

    # -- block execution ---------------------------------------------------

    def _exec_block(self, sg: SubGraph, uid_vars, value_vars):
        resolver = FuncResolver(
            self.store, self.arenas, uid_vars, value_vars, stats=self.stats,
            cancel=self.cancel,
        )
        # var blocks are never encoded: chains under them may leave their
        # result matrices on the device (light mode, query/chain.py)
        self._cur_block_internal = bool(sg.params.is_internal)
        if sg.params.is_shortest:
            shortest.shortest_path(self, sg, resolver)
            self._collect_vars(sg, uid_vars, value_vars)
            return
        dest = self._root_uids(sg, resolver)
        if sg.filter is not None:
            dest = self._apply_root_filter(sg, dest, resolver)
        dest = self._order_and_paginate_root(sg, dest, value_vars)
        sg.dest_uids = dest
        if sg.params.is_groupby:
            groupby.process_groupby(self, sg, value_vars)  # root @groupby
        elif sg.params.is_recurse:
            recurse.recurse(self, sg, resolver)
        else:
            self._exec_children(sg, resolver, uid_vars, value_vars)
        self._collect_vars(sg, uid_vars, value_vars)

    def _root_uids(self, sg: SubGraph, resolver: FuncResolver) -> np.ndarray:
        if sg.func is None:
            # func-less block: legal when every child is an aggregation /
            # math / val fetch (the reference's aggregation-only blocks,
            # e.g. `total() { s as sum(val(c)) }`)
            if sg.children and all(
                c.attr in ("val", "math") or c.params.agg_func for c in sg.children
            ):
                return _EMPTY
            raise QueryError(f"block {sg.params.alias!r} needs func: or id:")
        return resolver.resolve(sg.func)

    # -- children ----------------------------------------------------------

    def _exec_children(self, sg: SubGraph, resolver, uid_vars, value_vars):
        src = sg.dest_uids
        self._expand_expand_nodes(sg, value_vars)
        for child in sg.children:
            self.checkpoint()
            self._exec_child(child, src, resolver, uid_vars, value_vars)
        if sg.params.cascade and sg.children:
            self._cascade_prune(sg)

    def _cascade_prune(self, sg: SubGraph):
        """Execution-time @cascade: drop uids from dest_uids (and the uid
        matrix) that lack a result in ANY non-internal child — so vars
        bound under @cascade see the pruned set, not just the encoder
        (populateVarMap, query.go:1330-1350)."""
        dest = sg.dest_uids
        if not len(dest):
            return
        keep_mask = np.ones(len(dest), dtype=bool)
        for child in sg.children:
            if child.params.is_internal or child.attr in ("_uid_", "uid"):
                continue
            if child.counts is not None:
                continue  # counts exist for every src uid
            if child.values:
                # one vectorized membership probe per child instead of a
                # dict-lookup per (dest uid × child) — @cascade on a wide
                # result was O(U×V) python
                vk = np.fromiter(
                    child.values.keys(), dtype=np.int64, count=len(child.values)
                )
                has = np.isin(dest, vk)
            elif len(child.seg_ptr) > 1:
                # child expanded with dest as its src: row-degree > 0
                degs = np.diff(child.seg_ptr)
                has = (degs > 0) if len(degs) == len(dest) else np.zeros(
                    len(dest), dtype=bool
                )
            else:
                has = np.zeros(len(dest), dtype=bool)
            keep_mask &= has
            if not keep_mask.any():
                break
        if keep_mask.all():
            return
        sg.dest_uids = dest[keep_mask]
        if len(sg.out_flat):
            self._mask_matrix(sg, sg.dest_uids)

    def _expand_expand_nodes(self, sg: SubGraph, value_vars):
        """expand(_all_) / expand(val(v)) → concrete children
        (query/query.go:1780-1813)."""
        import copy

        if not any(c.params.expand for c in sg.children):
            return
        new_children: List[SubGraph] = []
        for c in sg.children:
            if not c.params.expand:
                new_children.append(c)
                continue
            if c.params.expand == "_all_":
                preds = [p for p in self.store.predicates() if not p.startswith("_")]
            else:
                vmap = value_vars.get(c.params.expand, {})
                names = set()
                for tv in vmap.values():
                    v = tv.value
                    names.update(v if isinstance(v, list) else [v])
                preds = sorted(names)
            for pr in preds:
                nc = SubGraph(attr=pr)
                nc.children = [copy.deepcopy(g) for g in c.children]
                new_children.append(nc)
        sg.children = new_children

    def _exec_child(self, child: SubGraph, src: np.ndarray, resolver, uid_vars, value_vars):
        self._exec_child_inner(child, src, resolver, uid_vars, value_vars)
        # bind vars immediately: later siblings (math, aggregations) and
        # later blocks read them (populateVarMap happens per-node in the
        # reference too, query/query.go:1755 assignVars)
        self._bind_var(child, uid_vars, value_vars)

    def _bind_var(self, sg: SubGraph, uid_vars, value_vars):
        p = sg.params
        if p.var:
            if sg.counts is not None:
                value_vars[p.var] = {
                    int(u): TypedValue(TypeID.INT, int(c))
                    for u, c in zip(sg.src_uids.tolist(), sg.counts.tolist())
                }
            elif sg.values:
                value_vars[p.var] = dict(sg.values)
            elif len(sg.dest_uids):
                uid_vars[p.var] = sg.dest_uids
            else:
                uid_vars.setdefault(p.var, _EMPTY)
        if p.facets and p.facets.aliases and sg.edge_facets:
            for key, var in p.facets.aliases.items():
                m = {}
                for (s, d), fs in sg.edge_facets.items():
                    if key in fs:
                        m[int(d)] = fs[key]
                value_vars[var] = m

    def _exec_child_inner(self, child: SubGraph, src: np.ndarray, resolver, uid_vars, value_vars):
        attr = child.attr
        p = child.params
        if attr in ("_uid_", "uid", ""):
            child.src_uids = src
            return
        if attr == "val":
            # val(x) fetch: values come from the variable map
            v = child.needs_var[0] if child.needs_var else ""
            vmap = value_vars.get(v, {})
            child.src_uids = src
            child.values = {int(u): vmap[int(u)] for u in src.tolist() if int(u) in vmap}
            if p.agg_func:
                self._aggregate(child, src, value_vars)
            return
        if attr == "math":
            child.src_uids = src
            child.values = self._eval_math(child.math_exp, src, value_vars)
            return
        if attr == "_predicate_":
            child.src_uids = src
            # one vectorized membership probe per predicate (cached sorted
            # mirror, store.uids_with_data_sorted) — remaining Python work
            # is proportional to the OUTPUT (uid, pred) pairs, not to
            # |preds| × |uids| (VERDICT r4 weak #4)
            src64 = np.asarray(src, dtype=np.int64)
            acc: List[List[str]] = [[] for _ in range(len(src64))]
            for pr in self.store.predicates():
                wd = self.store.pred(pr).uids_with_data_sorted()
                if not len(wd):
                    continue
                pos = np.searchsorted(wd, src64)
                hit = (pos < len(wd)) & (wd[np.minimum(pos, len(wd) - 1)] == src64)
                for i in np.nonzero(hit)[0]:
                    acc[i].append(pr)
            child.values = {
                int(u): TypedValue(TypeID.STRING, acc[i])
                for i, u in enumerate(src64)
            }
            return
        if child.func is not None and child.func.name == "checkpwd":
            child.src_uids = src
            ok = resolver.resolve(child.func, src)
            okset = set(ok.tolist())
            child.values = {
                int(u): TypedValue(TypeID.BOOL, int(u) in okset) for u in src.tolist()
            }
            return

        tid = self.store.schema.type_of(attr)
        is_uid_pred = tid == TypeID.UID or (
            self.store.peek(attr) is not None and bool(self.store.pred(attr).edges)
        )

        if p.do_count:
            arena = self.arenas.reverse(attr) if child.reverse else self.arenas.data(attr)
            rows = arena.rows_for_uids_host(src)
            child.src_uids = src
            child.counts = arena.degree_of_rows(rows).astype(np.int64)
            return

        if not is_uid_pred:
            # value leaf: fetch typed values for each src uid — direct
            # dict probes on the predicate's value map (no store.value
            # call overhead on the hot loop)
            child.src_uids = src
            # reference v0.7 lang semantics (query_test.go TestLang*):
            # no @ → untagged only; @a:b → first EXACT match in chain
            # order, no implicit fallback; '.' → untagged else any lang
            langs = child.langs or [""]
            vals = {}
            pd = self.store.peek(attr)
            if pd is not None:
                pv = pd.values
                if langs == [""]:
                    # vectorized untagged fetch: one searchsorted over the
                    # predicate's sorted value mirror instead of a Python
                    # dict probe per uid (VERDICT r3 weak #6)
                    hit, pos, mv = pd.untagged_lookup(src)
                    if hit.any():
                        hs = src[hit].tolist()
                        hv = mv[pos[hit]].tolist()
                        vals = dict(zip(map(int, hs), hv))
                else:
                    any_map = _any_value_map(pd) if "." in langs else None
                    for u in src.tolist():
                        for l in langs:
                            tv = any_map.get(u) if l == "." else pv.get((u, l))
                            if tv is not None:
                                vals[u] = tv
                                break
            child.values = vals
            if pd is not None and pd.value_facets and child.params.facets:
                child.value_facets = {
                    int(u): pd.value_facets[int(u)]
                    for u in src.tolist()
                    if int(u) in pd.value_facets
                }
            return

        # uid expansion.  A big fusable chain runs as one device pass
        # (query/chain.py), staged here and consumed level by level as the
        # recursion descends; everything else is one batched expansion per
        # (level × predicate)
        arena = self.arenas.reverse(attr) if child.reverse else self.arenas.data(attr)
        plan = None
        if child.chain_stash is None:
            # the level's rows and edge count: the chain's estimate starts
            # from them, and the per-level expansion reuses them
            plan = _plan_rows(arena, src)
            # failed attempts count too: planning cost must show in SOME
            # bucket or the breakdown misleads
            c0 = self.stats["chain_ms"]
            with obs.stage(self.stats, "chain_ms"):
                chain.try_run_chain(self, child, src, resolver, plan[1])
            # close the planner's chain decision with the measured latency
            # (set only when a priced chain actually ran)
            cdec = self._pending_chain_dec
            if cdec is not None:
                self._pending_chain_dec = None
                planner.note_outcome(cdec, (self.stats["chain_ms"] - c0) * 1e3)
        if child.chain_stash is not None and child.chain_stash[0] == "light":
            _tag, dest, stash_src, n_edges = child.chain_stash
            child.chain_stash = None
            if stash_src is None or len(stash_src) == len(src):
                # var-block level: the matrix stayed on the device; only
                # the deduped frontier came back (and only where a var or
                # a sibling subtree consumes it — dest None otherwise)
                child.src_uids = src
                child.out_flat = _EMPTY
                child.seg_ptr = np.zeros(len(src) + 1, dtype=np.int64)
                child.dest_uids = dest if dest is not None else _EMPTY
                self.stats["edges"] += n_edges
                self.stats["chain_fused_levels"] += 1
                self._exec_children(child, resolver, uid_vars, value_vars)
                return
            # misaligned light stash: the per-level expansion below must
            # apply filter and order again
            child.chain_filtered = False
            child.chain_ordered = False
        if child.chain_stash is not None:
            _tag, out_flat, seg_ptr, stash_src = child.chain_stash
            child.chain_stash = None
            if len(stash_src) != len(src):  # defensive: never mis-align
                child.chain_filtered = False
                child.chain_ordered = False
                out_flat, seg_ptr = self._expand(
                    arena, src, attr=attr, reverse=child.reverse
                )
            else:
                self.stats["edges"] += len(out_flat)
                self.stats["chain_fused_levels"] += 1
        else:
            out_flat, seg_ptr = self._expand(
                arena, src, attr=attr, reverse=child.reverse, plan=plan
            )
        child.src_uids = src
        child.out_flat = out_flat
        child.seg_ptr = seg_ptr
        dest = np.unique(out_flat)

        if child.filter is not None and not child.chain_filtered:
            dest = self._apply_filter(child.filter, dest, resolver)
            self._mask_matrix(child, dest)
        self._load_edge_facets(child)
        if child.params.facets_filter is not None:
            self._apply_facet_filter(child)
        if not child.chain_ordered:
            self._order_and_paginate_child(child, value_vars)
        child.dest_uids = np.unique(child.out_flat)
        if p.is_groupby:
            groupby.process_groupby(self, child, value_vars)
            return
        self._exec_children(child, resolver, uid_vars, value_vars)

    def _expand(
        self, arena, src: np.ndarray, attr: str = "", reverse: bool = False,
        plan=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One batched device gather for a whole level — routing lives on
        the DeviceExpander (see class docstring)."""
        return self.expander.expand(
            arena, src, attr=attr, reverse=reverse, plan=plan
        )

    # -- filters -----------------------------------------------------------

    def _apply_root_filter(
        self, sg: SubGraph, dest: np.ndarray, resolver
    ) -> np.ndarray:
        """The root filter with ``first: k`` early exit: when the block
        has a positive ``first`` and no order, the final dest is the
        first ``offset + first`` (past ``after``) survivors in uid order,
        so the filter runs over ascending chunks of the candidates
        (doubling from max(1024, 8·need)) and stops once enough survive
        (stat ``first_early_exit``).  Filters are per-candidate
        membership tests, so filtering commutes with chunking and the
        bytes equal the whole-set pass.  Other shapes, unsorted
        candidates and DGRAPH_TPU_QOS=0 filter the whole set."""
        p = sg.params
        need = (p.first or 0) + max(p.offset or 0, 0)
        from dgraph_tpu_torch.sched.qos import qos_enabled

        if (
            (p.first or 0) <= 0
            or p.order_attr
            or (p.offset or 0) < 0
            or not qos_enabled()
        ):
            return self._apply_filter(sg.filter, dest, resolver)
        # chunk floor: global leaves (index functions) resolve again per
        # chunk, so start big enough that doubling reaches the whole set
        # in a few rounds
        chunk = max(1024, 8 * need)
        if len(dest) <= chunk or not bool(np.all(dest[1:] > dest[:-1])):
            return self._apply_filter(sg.filter, dest, resolver)
        after = p.after or 0
        parts: List[np.ndarray] = []
        got = 0
        pos = 0
        while pos < len(dest):
            self.checkpoint()
            part = self._apply_filter(
                sg.filter, dest[pos : pos + chunk], resolver
            )
            parts.append(part)
            got += int((part > after).sum()) if after else len(part)
            pos += chunk
            if got >= need:
                if pos < len(dest):
                    self.stats["first_early_exit"] += 1
                break
            chunk *= 2
        return np.concatenate(parts)

    def _apply_filter(self, ft: FilterTree, candidates: np.ndarray, resolver) -> np.ndarray:
        if ft.func is not None:
            return resolver.resolve(ft.func, candidates)
        if ft.op == "and":
            # the join tier's k-way entry (query/joinplan.py): leaves that
            # resolve WITHOUT the frontier — index funcs, has(), uid sets —
            # intersect with the candidates as ONE k-way call (size-routed
            # host fold / intersect kernel) instead of k narrowing passes.
            # AND children are set filters, so the intersection commutes:
            # frontier-dependent leaves and nested trees apply afterwards,
            # and the output is byte-identical to the sequential fold
            glob = [
                c for c in ft.children
                if c.func is not None and joinplan.filter_leaf_global(c.func)
            ] if joinplan.mxu_mode() != "0" else []
            if len(glob) >= 2:
                sets = [resolver.resolve(c.func, None) for c in glob]
                out = joinplan.kway_intersect(
                    [candidates] + sets, stats=self.stats,
                    device=self.device,
                    device_min=self.arenas.kway_device_min,
                )
                gids = {id(c) for c in glob}
                for c in ft.children:
                    if id(c) not in gids:
                        out = self._apply_filter(c, out, resolver)
                return out
            out = candidates
            for c in ft.children:
                out = self._apply_filter(c, out, resolver)
            return out
        if ft.op == "or":
            parts = [self._apply_filter(c, candidates, resolver) for c in ft.children]
            out = parts[0]
            for s in parts[1:]:
                out = np.union1d(out, s)
            return out
        if ft.op == "not":
            sub = self._apply_filter(ft.children[0], candidates, resolver)
            return np.setdiff1d(candidates, sub)
        raise QueryError(f"bad filter op {ft.op!r}")

    def _mask_matrix(self, sg: SubGraph, keep: np.ndarray):
        """Filter out_flat to uids in ``keep`` (updateUidMatrix analog)."""
        if len(sg.out_flat) == 0:
            return
        _apply_edge_mask(sg, np.isin(sg.out_flat, keep))

    # -- facets ------------------------------------------------------------

    def _load_edge_facets(self, sg: SubGraph):
        pd = self.store.peek(sg.attr)
        if pd is None or not pd.edge_facets:
            return
        if sg.params.facets is None and sg.params.facets_filter is None:
            return
        counts = np.diff(sg.seg_ptr)
        owner = np.repeat(np.arange(len(counts)), counts)
        srcs = sg.src_uids[owner]
        dsts = sg.out_flat
        ef = pd.edge_facets
        if pd._efmirror is None and len(dsts) * 8 < len(ef):
            # cold mirror + small result: direct dict probes beat paying
            # an O(F log F) mirror rebuild for a handful of edges (the
            # mirror amortizes across queries once built; any facet WRITE
            # invalidates it, so mutate-then-query workloads land here)
            for src, dst in zip(srcs.tolist(), dsts.tolist()):
                f = ef.get((dst, src) if sg.reverse else (src, dst))
                if f:
                    sg.edge_facets[(src, dst)] = f
            return
        # one vectorized probe over the predicate's sorted facet mirror
        # (the per-edge dict loop was the r3-flagged host bottleneck)
        if sg.reverse:
            hit, pos, mv = pd.edge_facets_lookup(dsts, srcs)
        else:
            hit, pos, mv = pd.edge_facets_lookup(srcs, dsts)
        if hit.any():
            hs = srcs[hit].tolist()
            hd = dsts[hit].tolist()
            hf = mv[pos[hit]].tolist()
            for src, dst, f in zip(hs, hd, hf):
                sg.edge_facets[(int(src), int(dst))] = f

    def _apply_facet_filter(self, sg: SubGraph):
        """@facets(eq(key, val)): keep edges whose facets satisfy the tree.

        Vectorized (VERDICT r4 weak #4): the tree is evaluated as boolean
        COLUMNS over the edge list, not a Python closure per edge.  Only
        facet-BEARING edges (sg.edge_facets, loaded by _load_edge_facets)
        are touched at all; each leaf gathers its facet column once,
        groups by value tid, converts the filter arg once per (leaf, tid),
        and compares the whole group with one numpy op.  and/or/not are
        mask algebra, so facetless edges cost nothing anywhere.
        """
        tree = sg.params.facets_filter
        from dgraph_tpu_torch.models.types import compare_vals, convert

        E = len(sg.out_flat)
        counts = np.diff(sg.seg_ptr)
        owner = np.repeat(np.arange(len(counts)), counts)
        srcs = sg.src_uids[owner]
        ef = sg.edge_facets

        # flat-edge position of every facet-bearing edge: one searchsorted
        # over the (src<<32|dst) keys (edges are unique per (row, dst))
        if ef:
            keys = (srcs.astype(np.int64) << 32) | sg.out_flat.astype(np.int64)
            order = np.argsort(keys)
            skeys = keys[order]
            fkeys = np.fromiter(
                ((s << 32) | d for (s, d) in ef.keys()),
                dtype=np.int64,
                count=len(ef),
            )
            pos = np.clip(np.searchsorted(skeys, fkeys), 0, max(0, E - 1))
            # guard: a facet key whose edge is no longer in the list (an
            # earlier mask pruned it after loading) must be DROPPED, not
            # land on an arbitrary clipped position
            hit = skeys[pos] == fkeys if E else np.zeros(len(fkeys), bool)
            fpos = order[pos[hit]]
            fdicts = [
                f for f, h in zip(ef.values(), hit.tolist()) if h
            ]
        else:
            fpos = np.zeros(0, np.int64)
            fdicts = []

        conv_memo: Dict[tuple, Optional[TypedValue]] = {}

        def leaf_mask(ft: FilterTree) -> np.ndarray:
            out = np.zeros(E, dtype=bool)
            key = ft.func.attr
            # gather this leaf's facet column (facet-bearing edges only)
            groups: Dict[object, list] = {}
            for j, f in enumerate(fdicts):
                fv = f.get(key)
                if fv is not None:
                    groups.setdefault(fv.tid, []).append(j)
            for tid, js in groups.items():
                mk = (id(ft.func), tid)
                if mk not in conv_memo:
                    try:
                        conv_memo[mk] = convert(
                            TypedValue(TypeID.STRING, ft.func.args[0]), tid
                        )
                    except (ValueError, IndexError):
                        conv_memo[mk] = None
                target = conv_memo[mk]
                if target is None:
                    continue
                vals = [fdicts[j][key] for j in js]
                idx = fpos[np.asarray(js, dtype=np.int64)]
                if tid in (TypeID.INT, TypeID.FLOAT):
                    a = np.fromiter(
                        (float(v.value) for v in vals), np.float64, len(vals)
                    )
                    b = float(target.value)
                else:
                    a = np.empty(len(vals), dtype=object)
                    for i, v in enumerate(vals):
                        a[i] = v.value
                    b = target.value
                op = ft.func.name
                try:
                    if op == "eq":
                        m = a == b
                    elif op == "lt":
                        m = a < b
                    elif op == "le":
                        m = a <= b
                    elif op == "gt":
                        m = a > b
                    elif op == "ge":
                        m = a >= b
                    else:
                        raise ValueError(op)
                    m = np.asarray(m, dtype=bool)
                except (ValueError, TypeError):
                    # heterogenous values that defeat the columnar compare
                    # fall back to the scalar semantics, element by element
                    m = np.fromiter(
                        (_cmp_quiet(compare_vals, op, v, target) for v in vals),
                        dtype=bool,
                        count=len(vals),
                    )
                out[idx] = m
            return out

        def ev(ft: FilterTree) -> np.ndarray:
            if ft.func is not None:
                return leaf_mask(ft)
            if ft.op == "and":
                m = np.ones(E, dtype=bool)
                for c in ft.children:
                    m &= ev(c)
                return m
            if ft.op == "or":
                m = np.zeros(E, dtype=bool)
                for c in ft.children:
                    m |= ev(c)
                return m
            if ft.op == "not":
                return ~ev(ft.children[0])
            return np.zeros(E, dtype=bool)

        _apply_edge_mask(sg, ev(tree))

    # -- order & pagination --------------------------------------------------

    def _value_key_fn(self, attr: str, langs: List[str], value_vars, is_var: bool):
        if is_var:
            vmap = value_vars.get(attr, {})

            def key(u: int):
                v = vmap.get(u)
                return sort_key(v) if v is not None else (9,)

            return key

        def key(u: int):
            v = None
            for l in langs or [""]:
                v = (
                    self.store.any_value(attr, u)
                    if l == "."
                    else self.store.value(attr, u, l)
                )
                if v is not None:
                    break
            return sort_key(v) if v is not None else (9,)

        return key

    # device order-by eligibility: types whose host sort_key orders
    # identically to the ValueArena's exact-float64 value ranks
    _DEVICE_ORDER_TIDS = (
        TypeID.INT, TypeID.FLOAT, TypeID.DATETIME, TypeID.DATE, TypeID.BOOL,
    )

    def _device_order_perm(
        self, out: np.ndarray, owner: np.ndarray, attr: str, desc: bool
    ) -> Optional[np.ndarray]:
        """Segmented order-by over value ranks (the reference's
        ``_device_order_perm``; worker/sort.go:123-149 in Dgraph): gather
        each uid's rank from the ValueArena with one batched binary
        search, then one stable sort over (segment, ±rank).  Returns the
        permutation, or None when the host path must order (string keys,
        lang-tagged values).  Below ``expand_device_min`` items the sort
        runs in numpy over the rank mirror, above it on ``self.device``."""
        tid = self.store.schema.type_of(attr)
        if tid not in self._DEVICE_ORDER_TIDS:
            return None
        va = self.arenas.values(attr)
        if not va.langless:
            return None
        n = len(out)
        if n == 0:
            return np.empty(0, dtype=np.int64)
        if n < self.expand_device_min:
            # small sorts: numpy lexsort over the host rank mirror beats a
            # device round trip (the size routing of _expand); missing
            # values sort last ascending / first descending, as on the
            # device (ops/order.py segmented_sort_perm)
            miss = np.int64(1) << 40
            if va.n:
                pos = np.clip(np.searchsorted(va.h_src, out), 0, va.n - 1)
                hit = va.h_src[pos] == out
                key = np.where(hit, va.h_ranks[pos].astype(np.int64), miss)
            else:
                key = np.full(n, miss, dtype=np.int64)
            if desc:
                key = np.where(key == miss, -miss, -key)
            return np.lexsort((key, owner)).astype(np.int64)
        with obs.stage(self.stats, "device_order_ms"):
            cap = ops.bucket(n)
            seg = np.full(cap, -1, dtype=np.int32)
            seg[:n] = owner
            uids = torch.from_numpy(ops.pad_to(out, cap)).to(va.src.device)
            ranks = ops.gather_ranks(va.src, va.ranks, uids)
            perm = ops.segmented_sort_perm(
                torch.from_numpy(seg).to(va.src.device), ranks, bool(desc)
            )
            # the order-by's one fetch of its permutation, unguarded as the
            # reference's np.asarray (query/engine.py): it follows a hop the
            # guard already served on this card
            # graftlint: ignore[naked-device-sync]
            perm = perm[:n].cpu().numpy()  # padding sorts to the tail
        self.stats["device_order"] += 1
        return perm

    def _host_order_perm(
        self, n_items: int, owner: np.ndarray, n_segs: int, key_at, desc: bool
    ) -> np.ndarray:
        """Per-segment stable python sort (string keys / vars / facet
        keys).  ``key_at(j)`` keys by flat item index; returns a
        permutation of range(n_items)."""
        perm = np.arange(n_items, dtype=np.int64)
        starts = np.zeros(n_segs + 1, dtype=np.int64)
        np.cumsum(np.bincount(owner, minlength=n_segs), out=starts[1:])
        for i in range(n_segs):
            lo, hi = int(starts[i]), int(starts[i + 1])
            if hi - lo > 1:
                perm[lo:hi] = sorted(range(lo, hi), key=key_at, reverse=desc)
        return perm

    def _order_and_paginate_root(self, sg: SubGraph, dest: np.ndarray, value_vars) -> np.ndarray:
        p = sg.params
        if p.after:
            dest = dest[dest > p.after]
        if p.order_attr:
            perm = None
            if not (p.order_is_var or p.order_langs):
                perm = self._device_order_perm(
                    dest, np.zeros(len(dest), dtype=np.int64), p.order_attr,
                    p.order_desc,
                )
            if perm is not None:
                dest = dest[perm]
            else:
                key = self._value_key_fn(
                    p.order_attr, p.order_langs, value_vars, p.order_is_var
                )
                lst = sorted(dest.tolist(), key=key, reverse=p.order_desc)
                dest = np.array(lst, dtype=np.int64)
        dest = _paginate(dest, p.offset, p.first)
        return dest

    def _order_and_paginate_child(self, sg: SubGraph, value_vars):
        p = sg.params
        if not (p.first or p.offset or p.after or p.order_attr or
                (p.facets and p.facets.order_key)):
            return
        counts = np.diff(sg.seg_ptr)
        n_segs = len(counts)
        out = sg.out_flat
        owner = np.repeat(np.arange(n_segs), counts)

        # -- ordering (commutes with the 'after' uid filter) ----------------
        if p.facets and p.facets.order_key:
            fkey_name = p.facets.order_key

            def fkey_at(j: int):
                src = int(sg.src_uids[owner[j]])
                v = sg.edge_facets.get((src, int(out[j])), {}).get(fkey_name)
                return sort_key(v) if v is not None else (9,)

            perm = self._host_order_perm(
                len(out), owner, n_segs, fkey_at, p.facets.order_desc
            )
            out, owner = out[perm], owner[perm]
        elif p.order_attr:
            perm = None
            if not (p.order_is_var or p.order_langs):
                perm = self._device_order_perm(out, owner, p.order_attr, p.order_desc)
            if perm is None:
                key = self._value_key_fn(
                    p.order_attr, p.order_langs, value_vars, p.order_is_var
                )
                perm = self._host_order_perm(
                    len(out), owner, n_segs,
                    lambda j: key(int(out[j])), p.order_desc,
                )
            out, owner = out[perm], owner[perm]

        # -- after + per-segment windowing (vectorized, no python loop) -----
        if p.after:
            m = out > p.after
            out, owner = out[m], owner[m]
        out, owner = _window_segments(out, owner, n_segs, p.offset, p.first)
        sg.out_flat = out
        sg.seg_ptr = np.zeros(n_segs + 1, dtype=np.int64)
        np.cumsum(np.bincount(owner, minlength=n_segs), out=sg.seg_ptr[1:])

    # -- vars / aggregation / math -------------------------------------------

    def _collect_vars(self, sg: SubGraph, uid_vars, value_vars):
        self._bind_var(sg, uid_vars, value_vars)
        for c in sg.children:
            self._collect_vars(c, uid_vars, value_vars)

    def _aggregate(self, child: SubGraph, src: np.ndarray, value_vars):
        """min/max/sum/avg over a value variable (valueVarAggregation).
        min/max preserve the operand type (min of datetimes is a datetime,
        query/aggregator.go ApplyVal); sum/avg promote to numeric."""
        v = child.needs_var[0] if child.needs_var else ""
        vmap = value_vars.get(v, {})
        fn = child.params.agg_func
        if fn in ("min", "max"):
            vals = list(vmap.values())
            if not vals:
                child.values = {}
                return
            pick = min if fn == "min" else max
            tv = pick(vals, key=sort_key)
        else:
            nums = [numeric(tv) for tv in vmap.values()]
            nums = [x for x in nums if x is not None]
            if not nums:
                child.values = {}
                return
            r = sum(nums) if fn == "sum" else sum(nums) / len(nums)
            tv = TypedValue(TypeID.FLOAT, float(r))
        # one value for the block (reference emits it on the block root)
        child.values = {int(u): tv for u in src.tolist()} or {0: tv}
        if child.params.var:
            value_vars[child.params.var] = dict(child.values)

    def _eval_math(self, mt: MathTree, src: np.ndarray, value_vars) -> Dict[int, TypedValue]:
        """Evaluate math() over the value-variable environment
        (query/math.go evalMathTree) — vectorized: the whole expression
        tree runs elementwise over one uid-aligned float64 array instead
        of a python interpreter loop per uid.  Error semantics match the
        per-uid path: a uid is dropped when a variable is missing or the
        arithmetic is undefined there (div-zero/log-domain/overflow all
        surface as non-finite lanes)."""
        uids = set()
        self._math_uids(mt, value_vars, uids)
        if not uids:
            uids = {int(u) for u in src.tolist()}
        ua = np.array(sorted(uids), dtype=np.int64)
        with np.errstate(all="ignore"):
            vals, ok = _eval_math_vec(mt, ua, value_vars)
            ok = ok & np.isfinite(vals)
        return {
            int(u): TypedValue(TypeID.FLOAT, float(v))
            for u, v in zip(ua[ok].tolist(), vals[ok].tolist())
        }

    def _math_uids(self, mt: MathTree, value_vars, acc: set):
        if mt.var and mt.var in value_vars:
            acc.update(value_vars[mt.var].keys())
        for c in mt.children:
            self._math_uids(c, value_vars, acc)

    # -- schema introspection -------------------------------------------------

    def _schema_response(self, req) -> List[dict]:
        preds = req.predicates or self.store.schema.predicates()
        fields = req.fields or ["type"]
        out = []
        for pr in preds:
            s = self.store.schema.peek(pr)
            if s is None:
                continue
            item = {"predicate": pr}
            for f in fields:
                if f == "type":
                    item["type"] = s.tid.name.lower()
                elif f == "index":
                    item["index"] = bool(s.tokenizers)
                elif f == "tokenizer":
                    item["tokenizer"] = list(s.tokenizers)
                elif f == "reverse":
                    item["reverse"] = s.reverse
                elif f == "count":
                    item["count"] = s.count
            out.append(item)
        return out


def _cmp_quiet(compare_vals, op: str, a, b) -> bool:
    """compare_vals with the facet-filter's 'mismatch means False'."""
    try:
        return compare_vals(op, a, b)
    except (ValueError, TypeError):
        return False


def _apply_edge_mask(sg: SubGraph, mask: np.ndarray) -> None:
    """Apply a per-edge boolean mask to (out_flat, seg_ptr) keeping the
    segmented CSR consistent — the one shared place segment accounting
    happens after filtering."""
    counts = np.diff(sg.seg_ptr)
    owner = np.repeat(np.arange(len(counts)), counts)
    kept = np.bincount(owner[mask], minlength=len(counts))
    sg.out_flat = sg.out_flat[mask]
    sg.seg_ptr = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(kept, out=sg.seg_ptr[1:])


def _any_value_map(pd) -> Dict[int, TypedValue]:
    """uid → value under '.' fallback: untagged wins, else the
    lexicographically-first language (deterministic; list.go:835)."""
    out: Dict[int, TypedValue] = {}
    for (u, l) in sorted(pd.values.keys(), key=lambda k: (k[0], k[1] != "", k[1])):
        if u not in out:
            out[u] = pd.values[(u, l)]
    return out


def _window_segments(
    out: np.ndarray, owner: np.ndarray, n_segs: int, offset: int, first: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Apply _paginate's offset/first window to every segment at once:
    position-within-segment is computed vectorized, so pagination costs
    O(edges) numpy work regardless of segment count."""
    if not (offset or first) or len(out) == 0:
        return out, owner
    offset = max(offset, 0)  # _paginate ignores non-positive offsets
    counts = np.bincount(owner, minlength=n_segs)
    starts = np.zeros(n_segs + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(out), dtype=np.int64) - starts[owner]
    keep = np.ones(len(out), dtype=bool)
    if offset > 0:
        keep &= pos >= offset
    if first > 0:
        keep &= pos < offset + first
    elif first < 0:
        # negative first = last |first| entries of the post-offset slice
        eff = np.maximum(counts[owner] - max(offset, 0), 0)
        keep &= pos >= max(offset, 0) + np.maximum(eff + first, 0)
    return out[keep], owner[keep]


def _paginate(arr: np.ndarray, offset: int, first: int) -> np.ndarray:
    """first/offset windowing (x.PageRange analog: negative first = from
    the end)."""
    n = len(arr)
    if offset > 0:
        arr = arr[min(offset, n):]
    if first > 0:
        arr = arr[:first]
    elif first < 0:
        arr = arr[first:]
    return arr


_MATH_BIN = {
    "+": lambda a, b: a + b,
    "-": lambda a, b: a - b,
    "*": lambda a, b: a * b,
    "/": lambda a, b: a / b,
    "%": np.fmod,
    "<": lambda a, b: (a < b).astype(np.float64),
    ">": lambda a, b: (a > b).astype(np.float64),
    "<=": lambda a, b: (a <= b).astype(np.float64),
    ">=": lambda a, b: (a >= b).astype(np.float64),
    "==": lambda a, b: (a == b).astype(np.float64),
    "!=": lambda a, b: (a != b).astype(np.float64),
    "pow": lambda a, b: np.power(a, b),
    "logbase": lambda a, b: np.log(a) / np.log(b),
}

_MATH_UNARY = {
    "u-": np.negative,
    "exp": np.exp,
    "ln": np.log,
    "sqrt": np.sqrt,
    "floor": np.floor,
    "ceil": np.ceil,
}


def _eval_math_vec(mt: MathTree, ua: np.ndarray, value_vars):
    """Elementwise tree evaluation over uid-aligned arrays.  Returns
    (float64[n] values, bool[n] defined-mask); undefined lanes carry NaN.
    Boolean results are 1.0/0.0 (the per-uid path's float(bool))."""
    n = len(ua)
    if mt.var:
        vmap = value_vars.get(mt.var, {})
        vals = np.full(n, np.nan, dtype=np.float64)
        ok = np.zeros(n, dtype=bool)
        for i, u in enumerate(ua.tolist()):
            tv = vmap.get(u)
            if tv is None:
                continue
            x = numeric(tv)
            if x is not None:
                vals[i] = x
                ok[i] = True
        return vals, ok
    if mt.const is not None:
        return (
            np.full(n, float(mt.const), dtype=np.float64),
            np.ones(n, dtype=bool),
        )
    fn = mt.fn
    kid_vals = []
    ok = np.ones(n, dtype=bool)
    for c in mt.children:
        v, o = _eval_math_vec(c, ua, value_vars)
        kid_vals.append(v)
        # a non-finite lane in ANY subexpression drops the uid — the
        # per-uid path evaluated every child eagerly, so an undefined
        # untaken cond() branch also killed the uid there
        ok &= o & np.isfinite(v)
    if fn in _MATH_BIN and len(kid_vals) == 2:
        return _MATH_BIN[fn](kid_vals[0], kid_vals[1]), ok
    if fn in _MATH_UNARY and len(kid_vals) == 1:
        return _MATH_UNARY[fn](kid_vals[0]), ok
    if fn == "since":
        import time

        # since() is wall-clock BY DEFINITION: it subtracts a stored,
        # user-visible timestamp from "now" — monotonic time has no
        # relation to stored epochs.
        # graftlint: ignore[wallclock-duration]
        return time.time() - kid_vals[0], ok
    if fn == "max":
        return np.maximum.reduce(kid_vals), ok
    if fn == "min":
        return np.minimum.reduce(kid_vals), ok
    if fn == "cond":
        return np.where(kid_vals[0] != 0, kid_vals[1], kid_vals[2]), ok
    raise QueryError(f"unknown math fn {fn!r}")
