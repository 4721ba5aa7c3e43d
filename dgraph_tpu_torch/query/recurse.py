"""@recurse execution: level-synchronous frontier expansion (PyTorch port
of ``dgraph_tpu/query/recurse.py``; query/recurse.go expandRecurse:31,
Recurse:164 in Dgraph).

The same child template re-expands level by level; each realized level
and template is one ``engine._exec_child``, so the ``DeviceExpander``
routes it (the gather kernel where the planner prices it).  Already
visited targets are masked out of each level (the reference's per-edge
reachMap, recurse.go:110-145, as sorted visited-uid sets), value leaves
are fetched again for every new frontier, and the walk stops at
``depth`` levels, when a level adds nothing new, or past 1M edges
(recurse.go:148).

An internal (var-block) recursion over ONE plain uid template, with
nothing else under it, runs as one fused BFS instead
(``_try_fused_recurse``, the reference's gates): ``ops.multi_hop`` with
``track_visited``, one gather a level on the device, the frontier and
the visited set device-resident, one fetch.  The level-by-level loop
answers every other shape, and the same bytes for that one.  Each
realized level-template and each value-leaf fetch is preceded by a
cancellation checkpoint (``engine.checkpoint()``), as in the reference;
the fused BFS yields at the segment seams of ``ops.multi_hop``.
"""

from __future__ import annotations

import copy
from typing import List

import numpy as np
import torch

from dgraph_tpu_torch import ops
from dgraph_tpu_torch.models.types import TypeID
from dgraph_tpu_torch.ops.sets import SENT
from dgraph_tpu_torch.query.chain import _topm_deg_sum
from dgraph_tpu_torch.query.subgraph import SubGraph
from dgraph_tpu_torch.utils import devguard

MAX_EDGES = 1_000_000


def recurse(engine, sg: SubGraph, resolver):
    depth = sg.params.depth or (1 << 30)
    # children split: value leaves re-evaluated per level; uid templates drive
    uid_templates = [c for c in sg.children if _is_uid_child(engine, c)]
    if not uid_templates:
        raise ValueError("recurse query needs at least one uid predicate child")

    if _try_fused_recurse(engine, sg, uid_templates):
        return

    frontier = sg.dest_uids
    visited = frontier.copy()
    # per-level realized children attach under the previous level's nodes
    cur_parents: List[SubGraph] = [sg]
    edges = 0
    level = 0
    while level < depth and len(frontier) and edges < MAX_EDGES:
        next_frontier_parts = []
        new_parents: List[SubGraph] = []
        for parent in cur_parents:
            src = parent.dest_uids
            if not len(src):
                continue
            for tmpl in uid_templates:
                # cancellation checkpoint per realized level-template:
                # a cancelled @recurse stops before its next expansion
                engine.checkpoint()
                child = SubGraph(
                    attr=tmpl.attr,
                    alias=tmpl.alias,
                    langs=list(tmpl.langs),
                    params=copy.deepcopy(tmpl.params),
                    func=tmpl.func,
                    filter=tmpl.filter,
                    reverse=tmpl.reverse,
                )
                # value leaves of the template are re-instantiated each level
                child.children = [
                    copy.deepcopy(c) for c in sg.children if not _is_uid_child(engine, c)
                ]
                engine._exec_child(child, src, resolver, {}, {})
                # drop already-visited targets (reachMap dedup)
                keep = np.setdiff1d(child.dest_uids, visited)
                engine._mask_matrix(child, keep)
                child.dest_uids = np.unique(child.out_flat)
                # re-fetch value leaves for the new frontier
                for vc in child.children:
                    engine.checkpoint()
                    engine._exec_child(vc, child.dest_uids, resolver, {}, {})
                edges += len(child.out_flat)
                parent.children = parent.children + [child]
                new_parents.append(child)
                if len(child.dest_uids):
                    next_frontier_parts.append(child.dest_uids)
        if not next_frontier_parts:
            break
        frontier = np.unique(np.concatenate(next_frontier_parts))
        frontier = np.setdiff1d(frontier, visited)
        visited = np.union1d(visited, frontier)
        cur_parents = new_parents
        level += 1

    # the templates themselves are replaced by realized levels (by
    # identity: SubGraph's dataclass == would compare numpy fields)
    tids = {id(t) for t in uid_templates}
    sg.children = [c for c in sg.children if id(c) not in tids]
    # root-level value leaves for the root frontier
    for vc in sg.children:
        engine.checkpoint()
        if not _is_uid_child(engine, vc) and not vc.values:
            engine._exec_child(vc, sg.dest_uids, resolver, {}, {})


def fused_cap(arena, n_frontier: int, depth: int):
    """Capacity of a fused BFS of ``depth`` levels from ``n_frontier``
    uids over ``arena``, or None when its edge bound exceeds MAX_EDGES:
    each level's edges are bounded by the top-m degree cumsum, and the
    uniform width holds the frontier and the visited set."""
    nd = max(1, arena.n_distinct_dst())
    bounds = []
    m = n_frontier
    for _ in range(depth):
        e = _topm_deg_sum(arena, min(m, arena.n_rows))
        bounds.append(e)
        m = min(e, nd)
    if sum(bounds) > MAX_EDGES:
        return None
    return ops.bucket(max(max(bounds), n_frontier + nd, 1))


def _try_fused_recurse(engine, sg: SubGraph, uid_templates) -> bool:
    """Internal (var-block) recursion over ONE plain uid template as one
    fused BFS (``ops.multi_hop``, ``track_visited``): a gather per level,
    frontier and visited set on the device, one fetch, instead of one
    expansion plus host setdiff/union per level.  Var blocks encode
    nothing, so the realized levels carry dest frontiers only — the
    light contract of the fused chain (query/chain.py).

    Strictly gated (the reference's gates): any decoration (filters,
    ordering, value leaves, @cascade, unbounded depth), an arena the mesh
    shards, or an edge bound
    over MAX_EDGES falls back to the level-by-level loop, decided before
    any dispatch.  An out-of-memory device fault falls back to the loop
    too; any other device fault propagates."""
    p = sg.params
    if not p.is_internal or p.cascade or len(uid_templates) != 1:
        return False
    if engine.expander.fused_hop == "0":
        return False
    if any(not _is_uid_child(engine, c) for c in sg.children):
        return False  # value leaves re-evaluate per level: loop path
    tmpl = uid_templates[0]
    tp = tmpl.params
    if tmpl.filter is not None or tmpl.func is not None or tmpl.children:
        return False
    if (
        tp.do_count or tp.is_groupby or tp.expand
        or tp.facets is not None or tp.facets_filter is not None
        or tp.order_attr or tp.first or tp.offset or tp.after
    ):
        return False
    depth = p.depth or 0
    if not 0 < depth <= 64:  # the walk's length must be bounded and sane
        return False
    frontier = np.asarray(sg.dest_uids)
    if not len(frontier):
        sg.children = [c for c in sg.children if c is not tmpl]
        return True
    if not np.all(frontier[1:] > frontier[:-1]):
        # an ordered root permutes dest_uids; the visited-set member_mask
        # needs a sorted-unique frontier (same guard as try_run_chain)
        return False
    arena = (
        engine.arenas.reverse(tmpl.attr)
        if tmpl.reverse
        else engine.arenas.data(tmpl.attr)
    )
    if arena.n_edges == 0 or engine.arenas.use_mesh_for(arena):
        # a mesh arena's levels run per level, over the mesh
        return False
    cap = fused_cap(arena, len(frontier), depth)
    if cap is None:
        return False
    try:
        offsets, dst = engine.expander.csr_buffers(arena)
        f = torch.from_numpy(ops.pad_to(frontier, cap)).to(offsets.device)
        # guarded inside ops.multi_hop (device.multi_hop)
        fs, totals, _vis = ops.multi_hop(
            offsets, dst, f, f, depth, cap,
            track_visited=True, lut=arena.lut(),
        )
    except devguard.DeviceFaultError as e:
        if e.kind != "oom":
            raise
        # out of device memory: the level-by-level loop takes over,
        # still on the card, where the per-level OOM retry evicts
        return False
    engine.stats["fused_gathers"] += depth
    # ops.multi_hop's guarded dispatch already waited for these buffers
    # (ops/batch.py); the one fetch copies ready data, as the reference's
    # np.asarray does
    # graftlint: ignore[naked-device-sync]
    host = torch.cat([fs.reshape(-1), totals]).cpu().numpy()  # ONE fetch
    engine.stats["edges"] += int(host[depth * cap :].astype(np.int64).sum())
    parent = sg
    prev = sg.dest_uids
    for i in range(depth):
        fi = host[i * cap : (i + 1) * cap]
        dest = fi[fi != SENT].astype(np.int64)
        if not len(dest):
            break
        child = SubGraph(
            attr=tmpl.attr,
            alias=tmpl.alias,
            langs=list(tmpl.langs),
            params=copy.deepcopy(tp),
            reverse=tmpl.reverse,
        )
        child.src_uids = prev
        child.out_flat = np.empty(0, dtype=np.int64)
        child.seg_ptr = np.zeros(len(prev) + 1, dtype=np.int64)
        child.dest_uids = dest
        parent.children = parent.children + [child]
        parent = child
        prev = dest
    sg.children = [c for c in sg.children if c is not tmpl]
    return True


def _is_uid_child(engine, c: SubGraph) -> bool:
    if c.attr in ("_uid_", "uid", "val", "math", "", "_predicate_"):
        return False
    if c.params.do_count:
        return False
    tid = engine.store.schema.type_of(c.attr)
    if tid == TypeID.UID:
        return True
    pd = engine.store.peek(c.attr)
    return pd is not None and bool(pd.edges)
