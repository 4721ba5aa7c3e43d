"""shortest(from:, to:, numpaths:) — uniform-cost / k-shortest paths
(PyTorch port of ``dgraph_tpu/query/shortest.py``; query/shortest.go in
Dgraph).

Dijkstra over an adjacency cache built by lazy frontier expansion
(expandOut:134) — each expansion is one ``engine._exec_child`` per
predicate, so the ``DeviceExpander`` routes it (the gather kernel above
``expand_device_min``); edge costs come from a ``weight`` facet when
present, else 1 (getCost:102); k-shortest keeps per-path copies
(KShortestPath:274).  The edge cap mirrors shortest.go:214 (10M edges).
Every predicate expansion and every pop of the search is preceded by a
cancellation checkpoint (``engine.checkpoint()``), as in the reference.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Tuple

import numpy as np

from dgraph_tpu_torch.models.types import numeric
from dgraph_tpu_torch.query.subgraph import SubGraph

MAX_EDGES = 10_000_000


def shortest_path(engine, sg: SubGraph, resolver):
    src, dst = sg.params.path_from, sg.params.path_to
    k = max(1, sg.params.num_paths)
    if not src or not dst:
        raise ValueError("shortest needs from: and to:")
    preds = [c for c in sg.children if c.attr not in ("_uid_", "uid")]
    if not preds:
        raise ValueError("shortest needs at least one predicate child")

    # adjacency cache: uid -> list of (neighbor, cost, facets, attr)
    adj: Dict[int, List[Tuple[int, float, dict, str]]] = {}
    expanded: set = set()
    edges = 0

    def expand(frontier: np.ndarray):
        nonlocal edges
        todo = np.array([u for u in frontier.tolist() if u not in expanded], dtype=np.int64)
        if not len(todo):
            return
        for u in todo.tolist():
            adj.setdefault(int(u), [])
            expanded.add(int(u))
        for tmpl in preds:
            # cancellation checkpoint per predicate expansion: Dijkstra
            # over a big fan-out must stop at the next hop, not at the
            # end of the search
            engine.checkpoint()
            child = SubGraph(attr=tmpl.attr, params=tmpl.params, filter=tmpl.filter,
                             reverse=tmpl.reverse)
            engine._exec_child(child, np.sort(todo), resolver, {}, {})
            pd = engine.store.peek(tmpl.attr)
            counts = np.diff(child.seg_ptr)
            owner = np.repeat(np.arange(len(counts)), counts)
            for j, d in enumerate(child.out_flat.tolist()):
                s = int(child.src_uids[owner[j]])
                facets = {}
                if pd is not None:
                    facets = pd.edge_facets.get((s, int(d)), {})
                cost = 1.0
                w = facets.get("weight")
                if w is not None:
                    x = numeric(w)
                    if x is not None:
                        cost = x
                adj[s].append((int(d), cost, facets, tmpl.attr))
                edges += 1

    # uniform-cost search, expanding lazily per frontier ring
    found: List[Tuple[float, List[int]]] = []
    heap: List[Tuple[float, int, List[int]]] = [(0.0, src, [src])]
    best_count: Dict[int, int] = {}
    while heap and len(found) < k and edges < MAX_EDGES:
        engine.checkpoint()
        cost, u, path = heapq.heappop(heap)
        if best_count.get(u, 0) >= k:
            continue
        best_count[u] = best_count.get(u, 0) + 1
        if u == dst:
            found.append((cost, path))
            continue
        if u not in expanded:
            expand(np.array([u], dtype=np.int64))
        for (v, c, _f, _a) in adj.get(u, ()):
            if v in path:  # simple paths only (matches reference)
                continue
            heapq.heappush(heap, (cost + c, v, path + [v]))

    sg.paths = []
    for cost, path in found:
        elems = []
        for i, u in enumerate(path):
            facets = {}
            attr_out = ""
            if i + 1 < len(path):
                # predicate of the outgoing hop keys the nested object
                # (createPathSubgraph keys hops by traversed attr)
                for (v, _c, _f, a) in adj.get(u, ()):
                    if v == path[i + 1]:
                        attr_out = a
                        break
            if i > 0:
                # facets of the edge that led here
                for (v, _c, f, _a) in adj.get(path[i - 1], ()):
                    if v == u:
                        facets = f
                        break
            elems.append({"uid": u, "facets": facets, "attr_out": attr_out or "path"})
        sg.paths.append(elems)

    # dest_uids = the union of path nodes (for the attribute block render)
    uids = sorted({u for _c, p in found for u in p})
    sg.dest_uids = np.array(uids, dtype=np.int64)
