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

Anything else runs per level, the general implementation.  A light
(var-block), same-arena, undecorated chain runs the multi-hop pass
(``ops.multi_hop``, ``_try_chain_scan``); every other chain the staged
pass ``_run_fused``.

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
before any dispatch.  Nothing falls back after a dispatch: a device fault
propagates, as on the per-level route.
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
    """Every level of the chain as device work, ONE packed int32 output.

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
    dropped it), grouped by owner ascending."""
    ex = engine.expander
    gathers = ex._use_resident()
    u = root_vec
    parts = []
    for a, lut, keep, order, (cap, cap_u, need_dest, _dec, ostat) in zip(
        arenas, luts, keeps, orders, caps
    ):
        packed = ex.expand_rows(a, lut_rows(lut, u), cap)
        if gathers:
            engine.stats["fused_gathers"] += 1
        flat, seg = packed[:cap], packed[cap:]
        total = (seg >= 0).sum(dtype=torch.int32).reshape(1)
        if keep is not None:
            kept = ops.member_mask(flat, keep)
            flat = torch.where(kept, flat, SENT)
            seg = torch.where(kept, seg, -1)
        if ostat is not None:
            flat, seg = _order_window(flat, seg, order, ostat)
        nxt = ops.sort_unique(flat)[:cap_u]
        if not light:
            parts += [flat, seg, nxt, total]
        elif need_dest:
            parts += [nxt, total]
        else:
            parts.append(total)
        u = nxt
    return torch.cat(parts)


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
    src = np.asarray(src)
    if not np.all(src[1:] > src[:-1]):
        # an order-by at the root permutes dest_uids: the stashed
        # matrices are aligned with an ascending-distinct frontier
        return reject("frontier not ascending-distinct")
    levels = collect_chain(engine, child)
    if len(levels) < 2:
        return reject("chain shorter than 2 levels")
    arenas = []
    for sg in levels:
        a = (
            engine.arenas.reverse(sg.attr)
            if sg.reverse
            else engine.arenas.data(sg.attr)
        )
        if a.n_edges == 0:
            break  # truncate the chain here; the tail runs per level
        arenas.append(a)
    levels = levels[: len(arenas)]
    if len(levels) < 2:
        return reject("chain truncated below 2 levels (empty arena)")

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
    if not planner.chain_route(est_total, engine.chain_threshold):
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
        and engine.expander.fused_hop
        and _try_chain_scan(engine, levels, arenas[0], src, est_edges)
    ):
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
    # ONE device round trip for the whole chain
    packed = _run_fused(
        engine, root_vec, arenas, luts, keeps, orders, caps, light
    ).cpu().numpy()

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
    return True


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
