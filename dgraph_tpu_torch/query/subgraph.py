"""SubGraph: the executable query tree.

Equivalent of the reference's query.SubGraph (query/query.go:162) and its
construction from the AST (ToSubGraph:850, treeCopy:665).  Results are
held CSR-style — a flat dst array plus per-source segment offsets aligned
with src_uids — which is exactly the device layout expand_csr produces
(the reference's uidMatrix, task.proto:52, as two vectors).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from dgraph_tpu_torch.gql.ast import FacetsSpec, FilterTree, Function, GraphQuery, MathTree


@dataclass
class Params:
    alias: str = ""
    first: int = 0
    offset: int = 0
    after: int = 0
    order_attr: str = ""
    order_desc: bool = False
    order_is_var: bool = False
    order_langs: List[str] = field(default_factory=list)
    do_count: bool = False          # count(pred) node
    is_internal: bool = False       # var block / internal node: no output
    normalize: bool = False
    cascade: bool = False
    ignore_reflex: bool = False
    expand: str = ""
    var: str = ""
    agg_func: str = ""
    is_groupby: bool = False
    groupby_attrs: List[Tuple[str, str]] = field(default_factory=list)
    facets: Optional[FacetsSpec] = None
    facets_filter: Optional[FilterTree] = None
    # recurse / shortest
    is_recurse: bool = False
    is_shortest: bool = False
    depth: int = 0
    path_from: int = 0
    path_to: int = 0
    num_paths: int = 1


@dataclass
class SubGraph:
    attr: str = ""
    alias: str = ""
    langs: List[str] = field(default_factory=list)
    params: Params = field(default_factory=Params)
    func: Optional[Function] = None
    filter: Optional[FilterTree] = None
    math_exp: Optional[MathTree] = None
    needs_var: List[str] = field(default_factory=list)
    children: List["SubGraph"] = field(default_factory=list)

    # --- results (filled by the engine) ---
    src_uids: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    # CSR: out_flat[seg_ptr[i]:seg_ptr[i+1]] = targets of src_uids[i]
    out_flat: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    seg_ptr: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))
    dest_uids: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    counts: Optional[np.ndarray] = None          # per src uid (count nodes)
    values: Dict[int, Any] = field(default_factory=dict)  # uid -> TypedValue
    value_var: Dict[int, Any] = field(default_factory=dict)  # bound var map
    # facets on edges: (src, dst) -> {key: TypedValue}; on values: uid -> {...}
    edge_facets: Dict[Tuple[int, int], Dict[str, Any]] = field(default_factory=dict)
    value_facets: Dict[int, Dict[str, Any]] = field(default_factory=dict)
    groups: Optional[List[dict]] = None          # groupby results
    reverse: bool = False                        # ~pred expansion
    # fused-chain results staged by query/chain.py for this node, consumed
    # by the engine instead of a per-level _expand: ("full", out_flat,
    # seg_ptr, src) or ("light", dest or None, src or None, edge count)
    chain_stash: Optional[tuple] = None
    # the fused chain already applied this level's @filter / order and
    # window to the stashed matrix: the engine must not apply them again
    chain_filtered: bool = False
    chain_ordered: bool = False

    def row_targets(self, i: int) -> np.ndarray:
        return self.out_flat[self.seg_ptr[i] : self.seg_ptr[i + 1]]

    def is_value_node(self) -> bool:
        """Leaf value fetch (no uid expansion happened)."""
        return not len(self.out_flat) and bool(self.values)


def dump_dict(sg: "SubGraph") -> dict:
    """A block's execution SHAPE as a JSON-able dict (the reference's
    ``--dumpsg`` dump, cmd/dgraph/main.go:347-358): attrs, params, edge
    counts, frontier sizes and chain fusion flags, without the result
    payload — what to diff when a plan regresses.  Keys whose value is
    None, False or 0 are left out (``attr`` always stays)."""
    p = sg.params
    d = {
        "attr": ("~" if sg.reverse else "") + (sg.attr or ""),
        "alias": sg.alias or None,
        "func": sg.func.name if sg.func is not None else None,
        "filtered": sg.filter is not None,
        "order": p.order_attr or None,
        "first": p.first or None,
        "offset": p.offset or None,
        "n_src": int(len(sg.src_uids)) if sg.src_uids is not None else 0,
        "n_edges": int(len(sg.out_flat)) if sg.out_flat is not None else 0,
        "n_dest": int(len(sg.dest_uids)) if sg.dest_uids is not None else 0,
        "chain_fused": bool(sg.chain_filtered or sg.chain_ordered),
    }
    kids = [dump_dict(c) for c in sg.children]
    if kids:
        d["children"] = kids
    return {k: v for k, v in d.items() if v not in (None, False, 0) or k == "attr"}


def build_subgraph(gq: GraphQuery) -> SubGraph:
    """AST → SubGraph (ToSubGraph:850 + params fill query.go:789-848)."""
    sg = SubGraph()
    sg.attr = gq.attr
    sg.alias = gq.alias if gq.attr else ""   # root: alias is block name
    if not gq.attr:
        sg.params.alias = gq.alias
    sg.langs = list(gq.langs)
    sg.func = gq.func
    sg.filter = gq.filter
    sg.math_exp = gq.math_exp
    sg.needs_var = [v.name for v in gq.needs_var]

    p = sg.params
    p.var = gq.var
    p.is_internal = gq.is_internal
    p.normalize = gq.normalize
    p.cascade = gq.cascade
    p.ignore_reflex = gq.ignore_reflex
    p.expand = gq.expand
    p.do_count = gq.is_count
    p.agg_func = gq.agg_func
    p.is_groupby = gq.is_groupby
    p.groupby_attrs = list(gq.groupby_attrs)
    p.facets = gq.facets
    p.facets_filter = gq.facets_filter

    args = gq.args
    if "first" in args:
        p.first = int(args["first"])
    if "offset" in args:
        p.offset = int(args["offset"])
    if "after" in args:
        p.after = _uid_of(args["after"])
    for key, desc in (("orderasc", False), ("orderdesc", True)):
        if key in args:
            v = args[key]
            p.order_desc = desc
            if v.startswith("val:"):
                p.order_attr = v[4:]
                p.order_is_var = True
            else:
                if "@" in v:
                    v, _, lang = v.partition("@")
                    p.order_langs = lang.split("@")
                p.order_attr = v
    if "depth" in args:
        p.depth = int(args["depth"])
    if gq.alias == "recurse" or args.get("recurse") == "true":
        p.is_recurse = True
    if gq.alias == "shortest":
        p.is_shortest = True
        p.path_from = _uid_of(args.get("from", "0"))
        p.path_to = _uid_of(args.get("to", "0"))
        p.num_paths = int(args.get("numpaths", "1"))

    if gq.uid_list:
        f = Function(name="uid", uid_args=list(gq.uid_list))
        sg.func = sg.func or f

    for c in gq.children:
        child = build_subgraph(c)
        if child.attr.startswith("~"):
            child.reverse = True
            child.attr = child.attr[1:]
        sg.children.append(child)
    if p.cascade:
        _mark_cascade(sg)
    return sg


def _mark_cascade(sg: SubGraph) -> None:
    """@cascade applies to the whole subtree below the annotated node
    (the reference copies Cascade into every treeCopy, query.go:702)."""
    for c in sg.children:
        c.params.cascade = True
        _mark_cascade(c)


def _uid_of(s: str) -> int:
    s = s.strip()
    if not s:
        return 0
    if s.lower().startswith("0x"):
        return int(s, 16)
    return int(s)
