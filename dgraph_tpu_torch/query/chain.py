"""Fused multi-level uid-chain execution (PyTorch port of
``dgraph_tpu/query/chain.py``): the engine's device fast path.

The per-level engine pays one dispatch and one host round trip per
(level × predicate).  This module runs a maximal chain of uid
expansions as one pass of device work: the frontier stays on the device
between levels (rows through the arena's dense uid->row table,
``CSRArena.lut``; dedup by sort), and ONE fetch brings every level's
result to the host.

Eligibility per level (the reference's): a uid expansion without count,
facets, groupby, expand or var functions, optionally decorated with

- an ``@filter`` that resolves without the frontier (index functions,
  ``has``, uid literals, and/or of them): resolved once on the host into
  a keep-set, applied on the device as one ``member_mask``;
- ``orderasc``/``orderdesc`` on a numeric, date or bool predicate without
  languages (its ``ValueArena``) and/or ``first``/``offset``: a
  per-parent segmented rank sort and window on the device.

Anything else runs per level, the general implementation.  Whether an
eligible chain fuses is the planner's priced verdict
(``planner.chain_route``: one fused pass against per-level execution,
recorded in ``stats["planner"]`` and closed with the chain's measured
``chain_ms``; the static ``est_total >= chain_threshold`` compare when the
planner is off or the threshold is pinned).  A light
(var-block) chain may first be taken by the tile join tier
(``joinplan.try_mxu_route``: a mask chain over adjacency tiles, where
its cost model picks it).  A light, same-predicate, undecorated chain
on an arena the mesh shards runs as the mesh's multi-hop program
(``_try_mesh_chain``, mesh/executor.py), the exchange on the devices
between hops; otherwise a light, same-arena, undecorated chain runs the
multi-hop pass (``ops.multi_hop``, ``_try_chain_scan``); every other
chain the staged pass ``_run_fused``, truncated at the first mesh arena
(its levels then run per level, over the mesh).

Layout.  The reference expands each level through its inline-head layout
(``expand_inline_seg``), which serves the TPU gather's 32-byte index
granule, and rebuilds every slot's owner on the host.  Here each level is
one call of the per-level route's own expansion
(``DeviceExpander.expand_rows``: the resident gather kernel on a CUDA
device, ``expand_csr`` over the staged CSR otherwise).  Its packed
``[out | seg]`` output names each slot's owner directly, grouped by row
in frontier order, so neither a slot map nor an owner rebuild is needed,
and the chain reads the same epoch of the resident CSR as the per-level
route.  Capacities therefore count edges, not the reference's 8-slot
chunks: ``CHAIN_MAX_CAP(_LIGHT)`` are its chunk bounds times 8, the same
memory.

Capacity planning is overflow-free: level 0 is exact (host degrees of the
root rows), deeper levels use the arena's top-m degree cumsum (the m
largest rows bound any m-row frontier).  A plan over the cap is rejected
before any dispatch.  Where ``segments.plan`` returns k > 0, a scheduler
yield point (``segments.seam``) sits between every k levels of the
staged pass, as between every k hops of ``ops.multi_hop``.

Device faults (utils/devguard.py).  Each pass runs under the device
guard (failpoint sites ``device.chain``, ``device.multi_hop``,
``device.spgemm``).  A sick domain makes the chain raise
``DeviceSickError`` up front; an out-of-memory fault of any fused pass
declines to the per-level route, recorded in ``chain_reject``; every
other fault propagates (the server's 503).  A faulted mesh chain that no
chip owns declines too: its levels re-plan per level.  Nothing falls
back to the host.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from dgraph_tpu_torch import ops
from dgraph_tpu_torch.models.types import TypeID
from dgraph_tpu_torch.ops.batch import lut_rows
from dgraph_tpu_torch.ops.sets import SENT
from dgraph_tpu_torch.query import joinplan, planner
from dgraph_tpu_torch.query.functions import QueryError
from dgraph_tpu_torch.sched import segments
from dgraph_tpu_torch.utils import devguard
from dgraph_tpu_torch.utils.failpoints import fail

# largest per-level plan, in edges: full-mode chains fetch their
# matrices (transfer-sized), light-mode (var-block) chains fetch only
# frontiers and counts (device-memory-sized)
CHAIN_MAX_CAP = 1 << 24
CHAIN_MAX_CAP_LIGHT = 1 << 26


def _filter_fusable(ft) -> bool:
    """Can this filter tree resolve to a uid keep-set WITHOUT the
    frontier?  val()/count()/uid_in/checkpwd leaves depend on each
    candidate; everything else (index funcs, has, regexp, geo, uid
    literals, and/or combinations) resolves globally once."""
    if ft.func is not None:
        f = ft.func
        return not (
            f.is_val_var
            or f.is_count
            or f.needs_vars
            or f.name in ("uid_in", "checkpwd")
        )
    if ft.op == "not":
        # complementing needs the candidate universe (the per-level path
        # complements against the level's dest set)
        return False
    return all(_filter_fusable(c) for c in ft.children)


def _order_fusable(engine, sg) -> bool:
    """Per-parent order (+ first/offset window) fuses under exactly the
    engine's device-order preconditions (``_device_order_perm``):
    rank-sortable type, lang-less value arena, not a var; ``after`` and
    negative windows ("last N") stay on the host path."""
    p = sg.params
    if p.after:
        return False
    if (p.first or 0) < 0 or (p.offset or 0) < 0:
        return False
    if not p.order_attr:
        return True  # nothing to do, or a window in matrix order
    if p.order_is_var or p.order_langs:
        return False
    tid = engine.store.schema.type_of(p.order_attr)
    if tid not in type(engine)._DEVICE_ORDER_TIDS:
        return False
    va = engine.arenas.values(p.order_attr)
    return va.langless and va.n > 0


def eligible_level(engine, sg) -> bool:
    """Is this SubGraph a fusable uid expansion (plain, filtered and/or
    ordered — see the module docstring)?"""
    p = sg.params
    if sg.attr in ("", "_uid_", "uid", "val", "math", "_predicate_"):
        return False
    if sg.func is not None:
        return False
    if sg.filter is not None and not _filter_fusable(sg.filter):
        return False
    if p.do_count or p.is_groupby or p.expand:
        return False
    if p.facets is not None or p.facets_filter is not None:
        return False
    if not _order_fusable(engine, sg):
        return False
    tid = engine.store.schema.type_of(sg.attr)
    pd = engine.store.peek(sg.attr)
    return tid == TypeID.UID or (pd is not None and bool(pd.edges))


def collect_chain(engine, child) -> List:
    """Maximal fusable chain starting at ``child`` (itself eligible)."""
    levels = [child]
    node = child
    while True:
        nxt = [c for c in node.children if eligible_level(engine, c)]
        if len(nxt) != 1:
            break
        levels.append(nxt[0])
        node = nxt[0]
    return levels


def _order_window(flat, seg, order, order_static):
    """One level's per-parent order and ``offset``/``first`` window on the
    device: a stable segmented sort (by value rank, or by parent alone
    for a bare window), then each parent's slots outside the window
    become padding."""
    desc, off, first, has_vals = order_static
    if has_vals:
        vsrc, vranks = order
        perm = ops.segmented_sort_perm(
            seg, ops.gather_ranks(vsrc, vranks, flat), desc
        )
    else:
        perm = ops.segmented_sort_perm(seg, torch.zeros_like(flat), False)
    flat, seg = flat[perm], seg[perm]
    iota = torch.arange(flat.shape[0], dtype=torch.int32, device=flat.device)
    is_first = torch.ones_like(seg, dtype=torch.bool)
    is_first[1:] = seg[1:] != seg[:-1]
    start = torch.cummax(torch.where(is_first, iota, 0), 0).values
    pos = iota - start
    w = (seg >= 0) & (pos >= off)
    if first:
        w &= pos < off + first
    return torch.where(w, flat, SENT), torch.where(w, seg, -1)


def _run_fused(engine, root_vec, arenas, luts, keeps, orders, caps, light):
    """Every level of the chain as device work, ONE packed int32 output
    fetched to the host.

    root_vec: int32[B] sorted-unique root uids, SENT-padded, on the
      device.
    arenas, luts: per level, the CSRArena and its uid->row table.
    keeps: per level, a sorted-unique SENT-padded keep-set or None.
    orders: per level, None or the order predicate's (src, ranks).
    caps: per level (cap, cap_u, need_dest, decorated, order_static):
      cap = expansion capacity in edges, cap_u bounds the deduplicated
      frontier fed to the next level, order_static = None or (desc,
      offset, first, has_vals).
    light: var-block mode — only edge counts, and the frontiers the host
      consumes, come back.

    Packed layout per level:
      full:  [out | owner | nxt | total]   (cap, cap, cap_u, 1)
      light: [nxt]? [total]
    out/owner are slot-aligned: each slot's target and its row in the
    level's frontier (-1 past the total or where a keep-set or window
    dropped it), grouped by owner ascending.

    Each segment of levels (all of them unless ``segments.plan`` asks
    for seams) is one closure under the device guard (``device.chain``)
    that ends with its fetch, so a fault surfaces inside the guard that
    launched it; the next segment's frontier stays on the device, and
    the seams sit between the closures."""
    ex = engine.expander
    n = len(arenas)
    # segment seams (sched/segments.py): a scheduler yield point every
    # seg_k levels, where the planner asks for one
    seg_k = segments.plan(n, max(c[0] for c in caps), "chain")
    if not 0 < seg_k < n:
        seg_k = n
    guard = devguard.get()

    def _dispatch(u, lo, hi):
        fail.point("device.chain")
        parts = []
        for i in range(lo, hi):
            cap, cap_u, need_dest, _dec, ostat = caps[i]
            packed = ex.expand_rows(arenas[i], lut_rows(luts[i], u), cap)
            flat, seg = packed[:cap], packed[cap:]
            total = (seg >= 0).sum(dtype=torch.int32).reshape(1)
            if keeps[i] is not None:
                kept = ops.member_mask(flat, keeps[i])
                flat = torch.where(kept, flat, SENT)
                seg = torch.where(kept, seg, -1)
            if ostat is not None:
                flat, seg = _order_window(flat, seg, orders[i], ostat)
            nxt = ops.sort_unique(flat)[:cap_u]
            if not light:
                parts += [flat, seg, nxt, total]
            elif need_dest:
                parts += [nxt, total]
            else:
                parts.append(total)
            u = nxt
        return torch.cat(parts).cpu().numpy(), u

    host_parts = []
    u = root_vec
    for lo in range(0, n, seg_k):
        if lo:
            segments.seam("chain")
        hi = min(lo + seg_k, n)
        host, u = guard.run(
            "device.chain", lambda u=u, lo=lo, hi=hi: _dispatch(u, lo, hi)
        )
        host_parts.append(host)
    if ex._use_resident():
        engine.stats["fused_gathers"] += n
    return host_parts[0] if len(host_parts) == 1 else np.concatenate(host_parts)


def packed_inline_to_matrix(packed, B: int, capov: int, n_src: int):
    """Unpack the engine inline route's fetched ``[inline.ravel |
    ov.ravel | ovseg]`` buffer (``ops.expand_inline_seg`` over ``B``
    padded rows, ``capov`` overflow chunks) into the uid matrix."""
    inline = packed[: B * ops.INLINE].reshape(B, ops.INLINE)
    ovflat = packed[B * ops.INLINE: B * ops.INLINE + capov * ops.CHUNK]
    ovseg = packed[B * ops.INLINE + capov * ops.CHUNK:]
    return inline_to_matrix(inline, ovflat, ovseg, n_src)


def inline_to_matrix(inline, ovflat, ovseg, n_src: int):
    """Host assembly of the engine's uid matrix from an inline-head
    expansion: per row, its inline heads (the first min(deg, INLINE)
    targets, ascending) then its overflow tail (ascending too), so the
    concatenation keeps each row ascending.

    inline: int32[B, INLINE]; ovflat: int32[capc*CHUNK]; ovseg:
    int32[capc] (owner row per overflow chunk, -1 pad); n_src: the true
    row count (<= B).  Returns (out_flat int64[total], seg_ptr
    int64[n_src+1])."""
    iv = inline[:n_src] != SENT
    ci = iv.sum(axis=1)
    ow = np.repeat(ovseg, ops.CHUNK)
    ovalid = (ovflat != SENT) & (ow >= 0) & (ow < n_src)
    ovals = ovflat[ovalid].astype(np.int64)
    ow = ow[ovalid]
    counts = ci + np.bincount(ow, minlength=n_src)[:n_src]
    seg_ptr = np.zeros(n_src + 1, dtype=np.int64)
    np.cumsum(counts, out=seg_ptr[1:])
    out_flat = np.empty(int(seg_ptr[-1]), dtype=np.int64)
    within_i = np.cumsum(iv, axis=1) - iv
    dest_i = seg_ptr[:n_src, None] + within_i
    out_flat[dest_i[iv]] = inline[:n_src][iv].astype(np.int64)
    if len(ovals):
        idx = np.arange(len(ow))
        first = np.r_[True, ow[1:] != ow[:-1]]
        run_start = idx[first][np.cumsum(first) - 1]
        out_flat[seg_ptr[ow] + ci[ow] + (idx - run_start)] = ovals
    return out_flat, seg_ptr


def try_run_chain(
    engine, child, src: np.ndarray, resolver=None, first_edges=None
) -> bool:
    """Attempt fused execution of the chain rooted at ``child`` with
    frontier ``src`` (``first_edges``: the edges ``src`` owns in the
    first level's arena, when the caller has counted them).  On success, stages each level's result on it
    (``chain_stash``) and returns True; when the chain is not fusable,
    records why in ``stats["chain_reject"]`` and returns False, and the
    caller runs the level per level."""
    def reject(reason: str) -> bool:
        rj = engine.stats["chain_reject"]
        if len(rj) < 8:
            rj.append(reason)
        return False

    if len(src) == 0 or not eligible_level(engine, child):
        return reject("root level not fusable" if len(src) else "empty frontier")
    # device fault domain latched sick: every fused route below is
    # device work, so the chain raises (the server's 503) where the
    # reference prices the device out and runs per level on the host
    devguard.get().check("device.chain")
    try:
        return _fuse(engine, child, np.asarray(src), resolver, first_edges, reject)
    except devguard.DeviceFaultError as e:
        if e.kind != "oom":
            raise
        # a fused pass out of device memory declines to the per-level
        # route: still the card and the same gather kernel, and its own
        # OOM answer is LRU eviction and one retry
        return reject("device oom: chain fell back to per-level")


def _fuse(engine, child, src: np.ndarray, resolver, first_edges, reject) -> bool:
    """``try_run_chain``'s body past the root checks: the tile route,
    then the multi-hop pass, then the staged pass."""
    if not np.all(src[1:] > src[:-1]):
        # an order-by at the root permutes dest_uids: the stashed
        # matrices are aligned with an ascending-distinct frontier
        return reject("frontier not ascending-distinct")
    # the tile join tier (query/joinplan.py): light chains — the cyclic
    # triangle shape included (two legs + a globally resolvable closing
    # @filter) — may run as one mask chain over adjacency tiles when the
    # per-query cost model picks it over pairwise expansion.  Declines
    # fall through to the gather passes below; every decision lands in
    # engine.stats["join_routes"]
    if joinplan.try_mxu_route(engine, child, src, resolver):
        return True
    levels = collect_chain(engine, child)
    if len(levels) < 2:
        return reject("chain shorter than 2 levels")
    # the mesh's multi-hop program: a light same-predicate undecorated
    # chain on a shard-eligible arena, the exchange on the devices
    got = _try_mesh_chain(engine, levels, src, first_edges, reject)
    if got is not None:
        return got
    arenas = []
    for sg in levels:
        a = (
            engine.arenas.reverse(sg.attr)
            if sg.reverse
            else engine.arenas.data(sg.attr)
        )
        if a.n_edges == 0 or engine.arenas.use_mesh_for(a):
            break  # truncate the chain here; the tail runs per level
        arenas.append(a)
    levels = levels[: len(arenas)]
    if len(levels) < 2:
        return reject("chain truncated below 2 levels (empty/mesh arena)")

    # --- whole-chain fan-out estimate and the route decision ---
    if first_edges is None:
        rows0 = arenas[0].rows_for_uids_host(src)
        first_edges = int(arenas[0].degree_of_rows(rows0).sum())
    est_edges = first_edges
    # propagate by average out-degree so a modest first level does not
    # hide a multi-million-edge tail
    est_total = est_u = est_edges
    for a in arenas[1:]:
        est_u = min(est_u, a.n_rows)
        lvl = int(est_u * (a.n_edges / max(1, a.n_rows)))
        est_total += lvl
        est_u = lvl
    # route decision: the priced compare by default, the static threshold
    # when the planner is off or the knob is pinned (plan_dec None then,
    # so the static reject message stays as it was)
    fuse, plan_dec = planner.chain_route(engine, est_total, len(levels))
    if not fuse:
        if plan_dec is not None:
            # the per-level verdict is final: record it now
            planner.record(engine.stats, plan_dec)
            return reject(
                f"fan-out estimate {est_total}: calibrated model favors "
                f"per-level ({plan_dec['est_other_us']}us fused vs "
                f"{plan_dec['est_chosen_us']}us per-level)"
            )
        return reject(
            f"fan-out estimate {est_total} below threshold "
            f"{engine.chain_threshold}"
        )
    # var blocks encode nothing, so result matrices never leave the
    # device (unless a level takes part in @cascade, which prunes them)
    light = bool(
        engine._cur_block_internal
        and not any(sg.params.cascade for sg in levels)
    )
    max_cap = CHAIN_MAX_CAP_LIGHT if light else CHAIN_MAX_CAP

    # --- fused filters to keep-sets, order specs (host, once) ---
    dev = engine.device
    keeps: List = []
    orders: List = []
    order_statics: List = []
    for sg in levels:
        keep = None
        if sg.filter is not None:
            if resolver is None:
                return reject("filtered level without a resolver")
            try:
                kset = _resolve_filter_global(engine, sg.filter, resolver)
            except QueryError:
                return reject("filter keep-set resolution failed")
            keep = torch.from_numpy(
                ops.pad_to(kset, ops.bucket(max(1, len(kset))))
            ).to(dev)
        keeps.append(keep)
        p = sg.params
        if p.order_attr or p.first or p.offset:
            has_vals = bool(p.order_attr)
            order_statics.append(
                (bool(p.order_desc), int(p.offset or 0), int(p.first or 0), has_vals)
            )
            if has_vals:
                va = engine.arenas.values(p.order_attr)
                orders.append((va.src, va.ranks))
            else:
                orders.append(None)
        else:
            order_statics.append(None)
            orders.append(None)

    # --- multi-hop pass: light, same-arena, undecorated chains ---
    undecorated = all(k is None for k in keeps) and all(
        o is None for o in order_statics
    )
    if (
        light
        and undecorated
        and all(a is arenas[0] for a in arenas)
        # the fused-hop kill switch (DGRAPH_TPU_FUSED_HOP=0) turns the
        # multi-hop pass off, as in the reference
        and engine.expander.fused_hop != "0"
        and _try_chain_scan(engine, levels, arenas[0], src, est_edges)
    ):
        # the chain ran: record the decision and hand it to the engine's
        # chain_ms bracket for the post-hoc check
        _ran(engine, plan_dec)
        return True

    # --- staged pass: capacity planning (overflow-free) ---
    caps = []
    m = len(src)  # bound on the distinct frontier entering each level
    for i, (sg, a) in enumerate(zip(levels, arenas)):
        e = est_edges if i == 0 else _topm_deg_sum(a, m)
        cap = ops.bucket(max(1, e))
        if cap > max_cap:
            return reject(
                f"level {i} capacity {cap} edges exceeds "
                f"{'light' if light else 'full'} cap {max_cap}"
            )
        # the distinct next frontier is bounded by the level's edges and
        # by the arena's distinct targets (NOT its source-uid universe:
        # row-less leaf uids exceed it)
        m = min(e, max(1, a.n_distinct_dst()))
        need_dest = _needs_dest(levels, i)
        decorated = keeps[i] is not None or order_statics[i] is not None
        caps.append((cap, ops.bucket(max(1, m)), need_dest, decorated,
                     order_statics[i]))

    luts = [a.lut() for a in arenas]
    root_vec = torch.from_numpy(
        ops.pad_to(src, ops.bucket(max(1, len(src))))
    ).to(dev)
    # ONE device round trip for the whole chain (one a segment)
    packed = _run_fused(
        engine, root_vec, arenas, luts, keeps, orders, caps, light
    )

    # --- host conversion: packed buffer -> engine results per level ---
    src_list = np.asarray(src, dtype=np.int64)
    pos = 0
    for sg, (cap, cap_u, need_dest, decorated, ostat) in zip(levels, caps):
        # the device already applied these; the engine must not apply
        # them to the stashed matrices again
        sg.chain_filtered = decorated and sg.filter is not None
        sg.chain_ordered = decorated and ostat is not None
        if light:
            dest = None
            if need_dest:
                nxt = packed[pos : pos + cap_u]
                pos += cap_u
                dest = nxt[nxt != SENT].astype(np.int64)
            total = int(packed[pos])
            pos += 1
            # src None = "trusted": the previous level's dest stayed on
            # the device, so the consumer skips the alignment check
            sg.chain_stash = ("light", dest, src_list, total)
            src_list = dest
            continue
        flat = packed[pos : pos + cap]
        owner = packed[pos + cap : pos + 2 * cap]
        nxt = packed[pos + 2 * cap : pos + 2 * cap + cap_u]
        pos += 2 * cap + cap_u + 1  # the total: lengths say it in full mode
        valid = owner >= 0
        n_src = len(src_list)
        seg_ptr = np.zeros(n_src + 1, dtype=np.int64)
        np.cumsum(np.bincount(owner[valid], minlength=n_src)[:n_src],
                  out=seg_ptr[1:])
        sg.chain_stash = ("full", flat[valid].astype(np.int64), seg_ptr, src_list)
        src_list = nxt[nxt != SENT].astype(np.int64)
    _ran(engine, plan_dec)
    return True


def _ran(engine, plan_dec) -> None:
    """A priced chain ran: record its decision, and leave it for the
    engine to close with the chain's measured latency."""
    if plan_dec is not None:
        planner.record(engine.stats, plan_dec)
    engine._pending_chain_dec = plan_dec


def _resolve_filter_global(engine, ft, resolver) -> np.ndarray:
    """Resolve a fused filter tree to ONE sorted uid keep-set without the
    frontier (leaves and ops pre-checked by ``_filter_fusable``; 'not' is
    excluded there — it needs the candidate universe).  An AND is one
    k-way call (``joinplan.kway_intersect``: the intersect kernel above
    the engine's ``kway_device_min``)."""
    if ft.func is not None:
        return np.asarray(resolver.resolve(ft.func, None), dtype=np.int64)
    if ft.op == "and":
        parts = [_resolve_filter_global(engine, c, resolver) for c in ft.children]
        if not parts:
            return np.empty(0, np.int64)
        return joinplan.kway_intersect(
            parts, stats=engine.stats, device=engine.device,
            device_min=engine.arenas.kway_device_min,
        )
    if ft.op == "or":
        parts = [_resolve_filter_global(engine, c, resolver) for c in ft.children]
        out = parts[0]
        for s in parts[1:]:
            out = np.union1d(out, s)
        return out
    raise QueryError("not-filter is not chain-fusable")


def _topm_deg_sum(arena, m: int) -> int:
    """Upper bound on the edges of ANY m distinct rows of ``arena``."""
    cs = arena.topm_deg_cumsum()
    return int(cs[min(m, len(cs) - 1)])


def scan_cap(arena, n_src: int, est_edges: int, n_hops: int):
    """The multi-hop pass's one capacity for ``n_hops`` hops over
    ``arena`` from ``n_src`` uids whose first hop walks ``est_edges``
    edges: the worst hop's edge bound (deeper hops by the top-m degree
    cumsum), or None when it exceeds the light cap."""
    nd = max(1, arena.n_distinct_dst())
    caps = [est_edges]
    m = min(est_edges, nd)
    for _ in range(n_hops - 1):
        e = _topm_deg_sum(arena, m)
        caps.append(e)
        m = min(e, nd)
    cap = ops.bucket(max(max(caps), n_src, 1))
    return None if cap > CHAIN_MAX_CAP_LIGHT else cap


def _try_mesh_chain(engine, levels, src, first_edges, reject):
    """The fused multi-hop over the mesh serving plane (mesh/executor.py)
    for light same-predicate undecorated chains on a shard-eligible
    arena — the sharded twin of ``_try_chain_scan``.

    Tri-state: ``True`` the chain ran and every level is stashed;
    ``False`` the planner's verdict was per-level (recorded and
    rejected); ``None`` the chain is not mesh-fusable (decorated,
    mixed-predicate, over the light cap, or a fault no chip owns) and the
    caller goes on to the staged pass, which truncates at the mesh arena
    so those levels run per level."""
    ex = engine.arenas.mesh_executor()
    if ex is None:
        return None
    first = levels[0]
    attr, rev = first.attr, bool(first.reverse)
    if any(sg.attr != attr or bool(sg.reverse) != rev for sg in levels):
        return None
    if any(sg.filter is not None for sg in levels):
        return None
    if any(
        sg.params.cascade or sg.params.order_attr or sg.params.first
        or sg.params.offset
        for sg in levels
    ):
        return None
    # var blocks only (result matrices never leave the device) and the
    # fused-hop kill switch, as the unsharded multi-hop pass
    if not engine._cur_block_internal or engine.expander.fused_hop == "0":
        return None
    a = engine.arenas.reverse(attr) if rev else engine.arenas.data(attr)
    if a.n_edges == 0 or not engine.arenas.use_mesh_for(a):
        return None
    if not ex.allowed():
        return None
    src = np.asarray(src)
    if first_edges is None:
        first_edges = int(a.degree_of_rows(a.rows_for_uids_host(src)).sum())
    cap = scan_cap(a, len(src), first_edges, len(levels))
    if cap is None:
        return None
    est_total = est_u = first_edges
    for _ in levels[1:]:
        est_u = min(est_u, a.n_rows)
        lvl = int(est_u * (a.n_edges / max(1, a.n_rows)))
        est_total += lvl
        est_u = lvl
    fuse, plan_dec = planner.chain_route(engine, est_total, len(levels))
    if not fuse:
        if plan_dec is not None:
            planner.record(engine.stats, plan_dec)
            return reject(
                f"fan-out estimate {est_total}: calibrated model favors "
                f"per-level ({plan_dec['est_other_us']}us fused vs "
                f"{plan_dec['est_chosen_us']}us per-level)"
            )
        return reject(
            f"fan-out estimate {est_total} below threshold "
            f"{engine.chain_threshold}"
        )
    try:
        fs, totals = ex.multi_hop(attr, rev, src, len(levels), cap, engine.stats)
    except devguard.DeviceFaultError:
        # a fault no chip owns: decline the fused program, counted and
        # disclosed (``degraded.device``) — the staged pass truncates at
        # this arena and its levels re-plan per level
        devguard.count_failover("unsharded", engine.stats, "mesh")
        return None
    src_list = np.asarray(src, dtype=np.int64)
    for i, sg in enumerate(levels):
        sg.chain_filtered = False
        sg.chain_ordered = False
        dest = fs[i][fs[i] != SENT].astype(np.int64)
        sg.chain_stash = ("light", dest, src_list, int(totals[i]))
        src_list = dest
    _ran(engine, plan_dec)
    return True


def _needs_dest(levels, i: int) -> bool:
    """Does anything on the host consume level ``i``'s dest set (a var,
    a sibling subtree, or the end of the chain)?"""
    sg = levels[i]
    return bool(sg.params.var) or len(sg.children) > 1 or i == len(levels) - 1


def _try_chain_scan(engine, levels, arena, src, est_edges) -> bool:
    """Run a light same-arena undecorated chain through the multi-hop
    pass (``ops.multi_hop``): one gather a hop, the frontier on the
    device throughout, one fetch of the frontiers the host consumes and
    the edge counts.  Returns False when the uniform capacity
    (``scan_cap``) would exceed the light cap; the staged pass then plans
    level by level."""
    n = len(levels)
    cap = scan_cap(arena, len(src), est_edges, n)
    if cap is None:
        return False
    offsets, dst = engine.expander.csr_buffers(arena)
    f = torch.from_numpy(ops.pad_to(src, cap)).to(offsets.device)
    vis = torch.full((cap,), SENT, dtype=torch.int32, device=offsets.device)
    fs, totals, _vis = ops.multi_hop(
        offsets, dst, f, vis, n, cap, lut=arena.lut()
    )
    engine.stats["fused_gathers"] += n
    need = [i for i in range(n) if _needs_dest(levels, i)]
    # ONE fetch: the consumed frontiers, then every hop's edge count
    # ops.multi_hop's guarded dispatch already waited for these buffers
    # (ops/batch.py); the one fetch copies ready data, as the reference's
    # np.asarray does
    # graftlint: ignore[naked-device-sync]
    host = torch.cat([fs[need].reshape(-1), totals]).cpu().numpy()
    src_list = np.asarray(src, dtype=np.int64)
    for i, sg in enumerate(levels):
        sg.chain_filtered = False
        sg.chain_ordered = False
        dest = None
        if i in need:
            k = need.index(i)
            fi = host[k * cap : (k + 1) * cap]
            dest = fi[fi != SENT].astype(np.int64)
        sg.chain_stash = ("light", dest, src_list, int(host[len(need) * cap + i]))
        # src None downstream = "trusted", as in the staged light pass
        src_list = dest
    return True
