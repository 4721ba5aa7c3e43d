"""@recurse execution: level-synchronous frontier expansion (PyTorch port
of ``dgraph_tpu/query/recurse.py``; query/recurse.go expandRecurse:31,
Recurse:164 in Dgraph).

The same child template re-expands level by level; each realized level
and template is one ``engine._exec_child``, so the ``DeviceExpander``
routes it (the gather kernel above ``expand_device_min``).  Already
visited targets are masked out of each level (the reference's per-edge
reachMap, recurse.go:110-145, as sorted visited-uid sets), value leaves
are fetched again for every new frontier, and the walk stops at
``depth`` levels, when a level adds nothing new, or past 1M edges
(recurse.go:148).

Not ported: the reference's fused recurse (``_try_fused_recurse``: an
internal var block over one plain uid template as one device BFS
program, ``ops.multi_hop``), which waits for the chain tier.  This
level-by-level loop is the reference's own path wherever the fused one
declines, so the responses agree.  The port has no cancellation token,
so the reference's per-level cancellation checkpoints are left out.
"""

from __future__ import annotations

import copy
from typing import List

import numpy as np

from dgraph_tpu_torch.models.types import TypeID
from dgraph_tpu_torch.query.subgraph import SubGraph

MAX_EDGES = 1_000_000


def recurse(engine, sg: SubGraph, resolver):
    depth = sg.params.depth or (1 << 30)
    # children split: value leaves re-evaluated per level; uid templates drive
    uid_templates = [c for c in sg.children if _is_uid_child(engine, c)]
    if not uid_templates:
        raise ValueError("recurse query needs at least one uid predicate child")

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
        if not _is_uid_child(engine, vc) and not vc.values:
            engine._exec_child(vc, sg.dest_uids, resolver, {}, {})


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
