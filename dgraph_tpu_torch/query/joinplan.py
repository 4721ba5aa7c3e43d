"""Join-route choice (the PyTorch port of ``dgraph_tpu/query/joinplan.py``):
dense tile products or pairwise expansion, per query.

- **`try_mxu_route`** — the pattern entry: a light (var-block) uid chain
  whose levels are plain expansions or globally resolvable ``@filter``
  levels (index functions, ``uid(var)`` cycle-closing sets) may run as
  one mask chain over the predicates' adjacency tiles
  (``ops.spgemm.run_mask_chain``).  Triangle-shaped subqueries — two
  legs plus a closing keep-set — are exactly this shape.  The route is
  costed from arena degree statistics (``CSRArena.avg_degree``,
  ``degree_histogram``) against the gather tier's per-level dispatch and
  per-edge cost; tiles must fit ``DGRAPH_TPU_TILE_BUDGET``, the mask
  ``DGRAPH_TPU_MXU_MASK_MAX``.
- **`kway_intersect`** — the k-way set-intersection router: the host
  ``np.intersect1d`` fold or one call of the intersect kernel
  (``ops.kway.intersect_batch``), priced by the planner
  (``planner.kway_route``; the static size gate ``kway_device_min`` /
  ``DGRAPH_TPU_KWAY_DEVICE_MIN`` when it is off or the gate is
  pinned).  The engine's ``@filter`` AND, the fused chain's and this
  tier's keep-set ANDs and the resolver's token / trigram folds route
  through here.
- **decision recording** — every route decision of the tile tier lands
  in the per-request ``engine.stats["join_routes"]`` (bounded), a
  process-level ring with counts (``debug_summary``, served at
  ``/debug/store``) and the ``dgraph_join_route_total`` /
  ``dgraph_kway_intersect_total`` counters.

Gate: ``DGRAPH_TPU_MXU_JOIN`` — ``0`` disables the tier (and sends every
k-way intersection to the host fold), ``1`` (default) arms it behind the
cost model, ``force`` skips the cost comparison (structural eligibility
still applies) and sends every k-way intersection of at most
``KWAY_K_MAX`` sets to the device.

The tile tier's cost compare reads the planner's live rates
(``query/planner.py::rates``) while the planner is on, and the
reference's planner-off constants (``_STATIC_RATES``) under
``DGRAPH_TPU_PLANNER=0``; a k-way intersection is priced by
``planner.kway_route`` (the static ``kway_device_min`` gate when the
planner is off or the gate is pinned), so the decisions equal the
reference's under the same calibration.  A sampled request records the
tile chain as one ``hop`` span (route ``mxu``) and a device k-way step
as a ``kway`` span (the
port's addition), each with its ``device_sync_ms``.  Both run under the
device guard (utils/devguard.py, failpoint site ``device.spgemm``): a
sick domain makes the tile route raise ``DeviceSickError`` up front, a
faulted k-way step raises, and a faulted tile chain raises to the fused
chain, which declines an out-of-memory fault to the per-level route.
Where the reference folds on the host after a fault, the port does not.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from dgraph_tpu_torch import device as devmod
from dgraph_tpu_torch import obs, ops
from dgraph_tpu_torch.ops import spgemm
from dgraph_tpu_torch.ops.kway import intersect_batch
from dgraph_tpu_torch.ops.sets import SENT
from dgraph_tpu_torch.utils import devguard, planconfig
from dgraph_tpu_torch.utils.failpoints import fail
from dgraph_tpu_torch.utils.metrics import JOIN_ROUTES, KWAY_INTERSECTS

_EMPTY = np.empty(0, dtype=np.int64)

# the reference's bound on the sets of one device k-way call
KWAY_K_MAX = 16

# Cost rates (µs) of the reference's planner-off compare, verbatim
# (DGRAPH_TPU_PLANNER=0; the planner's live rates otherwise): the
# decision only has to be right about which side of a ~100× shape gap a
# query sits on, and every decision is recorded with both estimates.
# _GATHER_EDGE_US is the gather tier's per-edge cost including host
# conversion.
_STATIC_RATES = {
    "dispatch_us": 120.0,
    "tile_mac_us": 1.2e-4,
    "combine_us_per_mac": 2e-5,
    "tile_build_us_per_lane": 1.8e-4,
    "tile_build_amortize": 8.0,
}
_GATHER_EDGE_US = 0.02


def mxu_mode() -> str:
    """DGRAPH_TPU_MXU_JOIN: '0' off, '1' auto (default), 'force' always
    (structural eligibility permitting).  Read per call."""
    return planconfig.mxu_mode()


def mask_max_lanes() -> int:
    """Largest frontier-mask length the tile route may allocate."""
    return planconfig.mask_max_lanes()


# -- decision recording -------------------------------------------------------

_ROUTE_LOCK = threading.Lock()
_RECENT: "deque[dict]" = deque(maxlen=16)
_COUNTS = {"mxu": 0, "pairwise": 0, "kway_device": 0, "kway_host": 0}


def record_route(stats: Optional[dict], decision: dict) -> None:
    """Log one tile-tier route decision where it must be visible: the
    per-request engine stats (bounded), the process ring and the
    counter."""
    route = decision["route"]
    JOIN_ROUTES.add(route)
    with _ROUTE_LOCK:
        _RECENT.append(decision)
        _COUNTS[route] = _COUNTS.get(route, 0) + 1
    if stats is not None:
        rj = stats.setdefault("join_routes", [])
        if len(rj) < 8:
            rj.append(decision)


def debug_summary() -> dict:
    """Process-level routing summary: counts by route, last decisions."""
    with _ROUTE_LOCK:
        return {"counts": dict(_COUNTS), "recent": list(_RECENT)}


def _reset_for_tests() -> None:
    with _ROUTE_LOCK:
        _RECENT.clear()
        for k in list(_COUNTS):
            _COUNTS[k] = 0


# -- k-way set intersection ---------------------------------------------------


def kway_intersect(
    sets: List[np.ndarray],
    stats: Optional[dict] = None,
    device=None,
    device_min: Optional[int] = None,
) -> np.ndarray:
    """Intersection of k sorted-unique uid sets, routed by
    ``DGRAPH_TPU_MXU_JOIN``: '0' or more than ``KWAY_K_MAX`` sets fold on
    the host; 'force' takes the intersect kernel on ``device`` (default
    cuda); '1' asks the planner (``planner.kway_route``), or, when it is
    off or the gate is pinned, takes the kernel once the total size
    reaches ``device_min`` (default ``planconfig.kway_device_min()``).
    Byte-identical either way (sorted-unique int64); each route is
    counted in ``stats``, the process counts and the
    ``dgraph_kway_intersect_total`` counter, and a priced decision is
    recorded and closed with the measured ``kway_ms``."""
    from dgraph_tpu_torch.query import planner

    sets = [np.asarray(s, dtype=np.int64) for s in sets]
    if not sets:
        return _EMPTY
    if len(sets) == 1:
        return sets[0]
    if min(len(s) for s in sets) == 0:
        return _EMPTY
    total = sum(len(s) for s in sets)
    k = len(sets)
    mode = mxu_mode()
    dec = None
    if mode == "0" or k > KWAY_K_MAX:
        use_device = False
    elif mode == "force":
        use_device = True
    else:
        use_device, dec = planner.kway_route(total, k, device_min)
        if use_device is None:
            gate = (
                planconfig.kway_device_min() if device_min is None
                else device_min
            )
            use_device = total >= gate
    if dec is not None:
        planner.record(stats, dec)
    st = stats if stats is not None else {}
    k0 = st.get("kway_ms", 0.0)
    if use_device:
        dev = devmod.resolve(device)
        # sampled: the device k-way step records a ``kway`` span (the
        # port's addition: the reference records none) with its shape
        # and the wait for the intersect kernel's result
        sp = obs.current_span()
        ks = sp.child("kway") if sp is not None else obs.NOOP
        L = ops.bucket(max(len(s) for s in sets))

        def _dispatch():
            # staging, the kernel and the fetch inside the device guard's
            # watchdog; a fault (an OOM too) propagates: no host fold
            fail.point("device.spgemm")
            t = {}
            with obs.stage(t, "ms"):
                mat = np.stack([ops.pad_to(s, L) for s in sets])
                out = intersect_batch(torch.from_numpy(mat).to(dev)[None])[0]
                sync_ms = obs.block_ready_ms(out) if sp is not None else None
                out = out.cpu().numpy()
            return out, sync_ms, t["ms"]

        with ks:
            out, sync_ms, ms = devguard.get().run("device.spgemm", _dispatch)
            # the step's own time on the worker, without the guard's
            # hand-off (the planner refines the kernel's rate from it)
            st["kway_ms"] = st.get("kway_ms", 0.0) + ms
            res = out[out != SENT].astype(np.int64)
            if sp is not None:
                ks.set_attr("route", "device")
                ks.set_attr("k", k)
                ks.set_attr("lanes", int(L))
                ks.set_attr("device_sync_ms", round(sync_ms, 3))
                ks.set_attr("out", int(len(res)))
        route = "kway_device"
    else:
        with obs.stage(st, "kway_ms"):
            res = sets[0]
            for s in sets[1:]:
                res = np.intersect1d(res, s)
        route = "kway_host"
    KWAY_INTERSECTS.add(route[len("kway_"):])
    with _ROUTE_LOCK:
        _COUNTS[route] += 1
    if stats is not None:
        stats[route] = stats.get(route, 0) + 1
        planner.note_served_outcome(dec, (stats["kway_ms"] - k0) * 1e3)
    return res


def filter_leaf_global(fn) -> bool:
    """Does this filter Function resolve to a uid set WITHOUT the
    candidate frontier?  Index functions, ``has()`` and ``uid(...)`` —
    a bound uid variable is a global set (the cycle-closing shape), it
    only looks frontier-dependent — but not value-variable compares,
    counts, functions that read variables, ``uid_in`` or ``checkpwd``."""
    if fn.name == "uid":
        return True
    return not (
        fn.is_val_var
        or fn.is_count
        or fn.needs_vars
        or fn.name in ("uid_in", "checkpwd")
    )


def _mxu_filter_ok(ft) -> bool:
    """Filter tree resolvable to one global keep-set (no 'not': it needs
    the candidate universe)."""
    if ft.func is not None:
        return filter_leaf_global(ft.func)
    if ft.op == "not":
        return False
    return all(_mxu_filter_ok(c) for c in ft.children)


# -- the tile chain / triangle route ------------------------------------------


def _mxu_level_ok(engine, sg) -> bool:
    """A chain level the mask tier can run: plain uid expansion, with at
    most a globally resolvable @filter; no ordering, windowing or facets
    (they need the uid matrix the masks drop)."""
    from dgraph_tpu_torch.models.types import TypeID

    p = sg.params
    if sg.attr in ("", "_uid_", "uid", "val", "math", "_predicate_"):
        return False
    if sg.func is not None:
        return False
    if p.do_count or p.is_groupby or p.expand:
        return False
    if p.facets is not None or p.facets_filter is not None:
        return False
    if p.order_attr or p.first or p.offset or p.after:
        return False
    if sg.filter is not None and not _mxu_filter_ok(sg.filter):
        return False
    tid = engine.store.schema.type_of(sg.attr)
    pd = engine.store.peek(sg.attr)
    return tid == TypeID.UID or (pd is not None and bool(pd.edges))


def _collect_mxu_chain(engine, child) -> List:
    levels = [child]
    node = child
    while True:
        nxt = [c for c in node.children if _mxu_level_ok(engine, c)]
        if len(nxt) != 1:
            break
        levels.append(nxt[0])
        node = nxt[0]
    return levels


def _resolve_keep(engine, ft, resolver) -> np.ndarray:
    """Resolve a global filter tree to ONE sorted keep-set (leaves
    pre-checked by _mxu_filter_ok; AND folds route through the k-way
    intersection router)."""
    if ft.func is not None:
        return np.asarray(resolver.resolve(ft.func, None), dtype=np.int64)
    if ft.op == "and":
        parts = [_resolve_keep(engine, c, resolver) for c in ft.children]
        return kway_intersect(
            parts, stats=engine.stats, device=engine.device,
            device_min=engine.arenas.kway_device_min,
        )
    if ft.op == "or":
        out = _resolve_keep(engine, ft.children[0], resolver)
        for c in ft.children[1:]:
            out = np.union1d(out, _resolve_keep(engine, c, resolver))
        return out
    raise ValueError(f"filter op {ft.op!r} is not globally resolvable")


def _mask_of(uids: np.ndarray, m: int, dev) -> torch.Tensor:
    padded = ops.pad_to(uids, ops.bucket(max(1, len(uids))))
    return spgemm.uids_to_mask(torch.from_numpy(padded).to(dev), m)


def try_mxu_route(engine, child, src: np.ndarray, resolver) -> bool:
    """Attempt the tile route for the chain rooted at ``child``: a
    per-query choice between a mask chain over the predicates' tiles and
    pairwise expansion, costed from arena degree statistics and recorded
    in ``engine.stats["join_routes"]``.  On success, stages light-mode
    chain stashes on every level (the contract ``query/chain.py``'s
    passes produce) and returns True; a device fault propagates."""
    mode = mxu_mode()
    if mode == "0" or len(src) == 0:
        return False
    # device fault domain latched sick: the tile tier is device work, so
    # it raises (the server's 503) where the reference declines it and
    # the host serves
    devguard.get().check("device.spgemm")
    # light (var-block) chains only: masks carry SETS, not uid matrices,
    # so any level whose results must be encoded cannot ride this tier
    if not engine._cur_block_internal:
        return False
    if not _mxu_level_ok(engine, child):
        return False
    levels = _collect_mxu_chain(engine, child)
    if any(sg.params.cascade for sg in levels):
        return False
    arenas = []
    for sg in levels:
        a = (
            engine.arenas.reverse(sg.attr)
            if sg.reverse
            else engine.arenas.data(sg.attr)
        )
        if a.n_edges == 0 or engine.arenas.use_mesh_for(a):
            break  # a mesh arena's levels run per level, over the mesh
        arenas.append(a)
    levels = levels[: len(arenas)]
    if len(levels) < 2:
        return False

    # --- fan-out estimate (the chain tier's own threshold discipline) ---
    from dgraph_tpu_torch.query import planner

    rows0 = arenas[0].rows_for_uids_host(np.asarray(src))
    est_edges = int(arenas[0].degree_of_rows(rows0).sum())
    est_total = est_u = est_edges
    for a in arenas[1:]:
        est_u = min(est_u, a.n_rows)
        lvl = int(est_u * a.avg_degree)
        est_total += lvl
        est_u = lvl
    if mode != "force" and not planner.mxu_fanout_ok(
        engine, est_total, len(levels)
    ):
        return False

    # --- structural feasibility: tiles + mask sizes ---
    t = spgemm.tile_size()
    blocks = []
    universe = 0
    for a in arenas:
        k, uni = a.tile_blocks()
        if spgemm.est_tile_bytes(k, t) > spgemm.tile_budget():
            record_route(engine.stats, _decision(
                "pairwise", levels, est_total, 0.0, 0.0,
                reason=f"tile budget exceeded for {a.n_edges}-edge arena",
            ))
            return False
        blocks.append(k)
        universe = max(universe, uni)
    m = spgemm.mask_lanes(universe, t)
    if m > mask_max_lanes():
        record_route(engine.stats, _decision(
            "pairwise", levels, est_total, 0.0, 0.0,
            reason=f"mask {m} lanes over DGRAPH_TPU_MXU_MASK_MAX",
        ))
        return False
    # the reference's structural bound on its one-hot combine operand (a
    # dense [K, NB] float32), checked even under 'force'.  The port's
    # index_add_ combine materialises no such operand; the check stays
    # so the two packages decide alike.
    for k in blocks:
        if ops.bucket(max(1, k)) * (m // t) * 4 > spgemm.tile_budget():
            record_route(engine.stats, _decision(
                "pairwise", levels, est_total, 0.0, 0.0,
                reason="one-hot combine operand over tile budget",
            ))
            return False

    # --- cost model: gather tier vs one fused tile pass ---
    # degree-histogram skew: the gather tier plans capacity from top-m
    # degree sums, so a heavy-tailed predicate pads its buckets far past
    # the real work; dense tiles are immune
    pad = 1.2
    for a in arenas:
        h = a.degree_histogram()
        nz = np.nonzero(h)[0]
        if len(nz) and h.sum():
            mean_cls = float((nz * h[nz]).sum()) / float(h.sum())
            if nz[-1] >= mean_cls + 4:
                pad = 2.0
                break
    # rate table: the planner's live rates while it is on (the gather
    # tier's per-edge cost is the device gather plus the per-level host
    # conversion, chain_route's split of the flat 0.02), the reference's
    # planner-off constants verbatim under DGRAPH_TPU_PLANNER=0
    planner_on = planner.enabled()
    if planner_on:
        r = planner.rates()
        gather_edge_us = r["device_edge_us"] + r["host_touch_us"]
    else:
        r = _STATIC_RATES
        gather_edge_us = _GATHER_EDGE_US
    est_pairwise = len(levels) * r["dispatch_us"] + est_total * (
        gather_edge_us * pad
    )
    nbm = m // t
    per_pass = sum(
        k * t * t * r["tile_mac_us"] + k * nbm * t * r["combine_us_per_mac"]
        for k in blocks
    )
    build = sum(
        k * t * t * r["tile_build_us_per_lane"]
        for a, k in zip(arenas, blocks)
        if a._tiles is None
    )
    est_mxu = r["dispatch_us"] + per_pass + build / r["tile_build_amortize"]
    if mode != "force" and est_mxu >= est_pairwise:
        record_route(engine.stats, _decision(
            "pairwise", levels, est_total, est_pairwise, est_mxu,
            reason="cost model favors gather tier",
        ))
        return False

    # --- resolve fused keep-sets (host, once) ---
    from dgraph_tpu_torch.query.functions import QueryError

    keeps_np: List[Optional[np.ndarray]] = []
    try:
        for sg in levels:
            keeps_np.append(
                _resolve_keep(engine, sg.filter, resolver)
                if sg.filter is not None
                else None
            )
    except (QueryError, ValueError):
        record_route(engine.stats, _decision(
            "pairwise", levels, est_total, est_pairwise, est_mxu,
            reason="keep-set resolution failed",
        ))
        return False

    # --- build tiles (cached per arena) BEFORE recording the route: a
    # build can still refuse, and one query logs exactly ONE decision ---
    with obs.stage(engine.stats, "tile_build_ms"):
        tiles = [a.tiles() for a in arenas]
    if any(pt is None for pt in tiles):
        record_route(engine.stats, _decision(
            "pairwise", levels, est_total, est_pairwise, est_mxu,
            reason="tile build refused (budget)",
        ))
        return False
    record_route(engine.stats, _decision(
        "mxu", levels, est_total, est_pairwise, est_mxu,
        reason="generic join over densified tiles",
    ))
    # its twin in the planner's ring (kind mxu), so the post-hoc check
    # covers the tile tier too; only while the planner is on
    pdec = None
    if planner_on:
        pdec = {
            "kind": "mxu", "route": "mxu", "units": int(est_total),
            "est_chosen_us": round(float(est_mxu), 1),
            "est_other_us": round(float(est_pairwise), 1),
            "reason": "generic join over densified tiles",
        }
        planner.record(engine.stats, pdec)
    mxu_ms0 = engine.stats.get("mxu_join_ms", 0.0)

    dev = engine.device
    src64 = np.asarray(src, dtype=np.int64)
    tile_ops = tuple((pt.bi, pt.bj, pt.tiles) for pt in tiles)
    degvs = tuple(pt.degs for pt in tiles)
    # the dest sets the engine needs back: a level binding a var, feeding
    # several children, or the last one; the other masks stay on the card
    need = [
        bool(sg.params.var) or len(sg.children) > 1 or i == len(levels) - 1
        for i, sg in enumerate(levels)
    ]
    # segment seams (sched/segments): k levels of the mask chain per
    # run, the frontier mask threaded on the device between segments and
    # a scheduler yield point at every seam; k = 0 runs one segment
    from dgraph_tpu_torch.sched import segments

    seg_k = segments.plan(
        len(levels), max(1, est_total // max(1, len(levels))), "mask_chain"
    )
    if seg_k <= 0:
        seg_k = len(levels)
    dests: List[Optional[np.ndarray]] = [None] * len(levels)
    totals = np.zeros(len(levels), dtype=np.int64)
    # sampled: ONE hop span for the whole tile chain (it replaces the
    # per-level hops), its device wait summed over the segments
    sp = obs.current_span()
    hs = sp.child("hop") if sp is not None else obs.NOOP
    sync_ms = 0.0

    def _dispatch(x, keep_masks, lo, hi):
        # one segment under the device guard: mask staging (the first
        # segment stages the root and keep masks, device-resident for
        # the later ones), the tile chain and the fetches.  Plain data
        # out; the caller writes the stats and stashes
        fail.point("device.spgemm")
        if x is None:
            x = _mask_of(src64, m, dev)
            keep_masks = [
                None if ks is None else _mask_of(ks, m, dev)
                for ks in keeps_np
            ]
        masks, tot = spgemm.run_mask_chain(
            tile_ops[lo:hi], keep_masks[lo:hi], degvs[lo:hi], x
        )
        seg_sync = obs.block_ready_ms((masks, tot)) if sp is not None else 0.0
        seg_dests = {
            i: spgemm.mask_to_uids(masks[i - lo])
            for i in range(lo, hi) if need[i]
        }
        nxt = masks[-1]
        return (tot.cpu().numpy(), seg_dests, nxt, keep_masks,
                bool(nxt.any()), seg_sync)

    guard = devguard.get()
    with hs, obs.stage(engine.stats, "mxu_join_ms"):
        x = keep_masks = None
        lo = 0
        while lo < len(levels):
            if lo:
                segments.seam("mask_chain")
            hi = min(lo + seg_k, len(levels))
            tot, seg_dests, x, keep_masks, live, seg_sync = guard.run(
                "device.spgemm",
                lambda x=x, km=keep_masks, lo=lo, hi=hi: _dispatch(x, km, lo, hi),
            )
            sync_ms += seg_sync
            totals[lo:hi] = tot
            for i, d in seg_dests.items():
                dests[i] = d
            lo = hi
            if lo < len(levels) and not live:
                # drained frontier: every remaining level is an empty
                # mask with a zero total — stop dispatching
                segments.early_exit("mask_chain")
                for i in range(lo, len(levels)):
                    if need[i]:
                        dests[i] = _EMPTY
                break
        if sp is not None:
            hs.set_attr("route", "mxu")
            hs.set_attr("levels", len(levels))
            hs.set_attr("preds", [sg.attr for sg in levels])
            hs.set_attr("mask_lanes", int(m))
            hs.set_attr("tiles", [int(pt.n_tiles) for pt in tiles])
            hs.set_attr("device_sync_ms", round(sync_ms, 3))
    planner.note_outcome(
        pdec, (engine.stats.get("mxu_join_ms", 0.0) - mxu_ms0) * 1e3
    )

    # --- stage light-mode stashes (the chain consumer's contract) ---
    src_list: Optional[np.ndarray] = src64
    for i, sg in enumerate(levels):
        dest = dests[i]
        sg.chain_filtered = sg.filter is not None
        sg.chain_ordered = False
        sg.chain_stash = ("light", dest, src_list, int(totals[i]))
        src_list = dest
    return True


def _decision(
    route: str, levels, est_total: int, est_pairwise: float,
    est_mxu: float, reason: str,
) -> dict:
    shape = "triangle" if (
        len(levels) == 2 and levels[-1].filter is not None
    ) else "chain"
    return {
        "route": route,
        "shape": shape,
        "levels": len(levels),
        "preds": [sg.attr for sg in levels],
        "est_edges": int(est_total),
        "est_pairwise_us": round(float(est_pairwise), 1),
        "est_mxu_us": round(float(est_mxu), 1),
        "reason": reason,
    }
