"""Result encoding: SubGraph tree → JSON-able dicts.

Equivalent of the reference's query/outputnode.go fastJsonNode encoder
driven by the preTraverse DFS (query/query.go:375-551).  Key shapes match
the reference's goldens (query_test.go):

- uids as hex strings under "_uid_"
- counts as "count(attr)" (or alias), bare count() as its own {"count":N}
- value variables as "val(x)", aggregates like "min(val(x))"
- edge facets on the child object under "@facets":{"_":{k:v}}; value
  facets on the parent under "@facets":{attr:{k:v}}
- @normalize flattens aliased leaves into one object per DFS path
- @groupby results under "@groupby"
"""

from __future__ import annotations

import datetime as _dt
from typing import Any, Dict, List, Optional

import numpy as np

from dgraph_tpu_torch.models.store import PostingStore
from dgraph_tpu_torch.models.types import TypeID, TypedValue
from dgraph_tpu_torch.query.subgraph import SubGraph


# ?debug=true attaches "_uid_" to every emitted node, as the reference's
# queryHandler debug context does (cmd/dgraph/main.go:226)
import contextvars

DEBUG_UIDS: "contextvars.ContextVar[bool]" = contextvars.ContextVar(
    "debug_uids", default=False
)


def _uid_hex(u: int) -> str:
    return hex(int(u))


def json_value(v: TypedValue) -> Any:
    if v.tid in (TypeID.DATETIME, TypeID.DATE):
        d = v.value
        if isinstance(d, _dt.datetime) and d.tzinfo is None:
            return d.isoformat() + "Z"
        return d.isoformat() if hasattr(d, "isoformat") else str(d)
    if v.tid == TypeID.GEO:
        return v.value.to_geojson()
    if v.tid == TypeID.BINARY:
        import base64

        return base64.b64encode(bytes(v.value)).decode()
    return v.value


def _facets_json(f: Dict[str, TypedValue], spec=None) -> Dict[str, Any]:
    """Facet map → JSON, restricted to the requested keys when @facets
    named specific ones (query/outputnode.go facet selection)."""
    if spec is not None and spec.keys and not spec.all_keys:
        return {k: json_value(v) for k, v in f.items() if k in spec.keys}
    return {k: json_value(v) for k, v in f.items()}


def _display_key(sg: SubGraph) -> str:
    if sg.alias:
        return sg.alias
    key = sg.attr
    if sg.reverse:
        key = "~" + key
    if sg.langs:
        key += "@" + ":".join(sg.langs)
    return key


def _src_index(sg: SubGraph, uid: int) -> int:
    i = int(np.searchsorted(sg.src_uids, uid))
    if i < len(sg.src_uids) and sg.src_uids[i] == uid:
        return i
    return -1


def encode_node(
    store: PostingStore,
    sg: SubGraph,
    uid: int,
    path: frozenset = frozenset(),
    ignore_reflex: bool = False,
) -> Optional[dict]:
    """One result object for ``uid`` at node ``sg`` (preTraverse analog).

    ``path``/``ignore_reflex``: @ignorereflex drops targets already on the
    ancestor path (parentIds stack, query/query.go:365-375)."""
    path = path | {uid}
    obj: dict = {}
    cascade_fail = False
    for child in sg.children:
        if child.params.is_internal and not child.params.var:
            continue
        if child.params.is_internal and child.attr not in ("val", "math") :
            continue
        key = _display_key(child)
        attr = child.attr
        if attr in ("_uid_", "uid"):
            obj[child.alias or "_uid_"] = _uid_hex(uid)
            continue
        if child.params.do_count and attr == "":
            continue  # bare count() handled at list level
        if child.params.do_count:
            i = _src_index(child, uid)
            n = int(child.counts[i]) if (child.counts is not None and i >= 0) else 0
            obj[child.alias or f"count({'~' if child.reverse else ''}{attr})"] = n
            continue
        if attr == "val":
            v = child.values.get(uid)
            var = child.needs_var[0] if child.needs_var else ""
            if child.params.agg_func:
                if v is not None:
                    obj[child.alias or f"{child.params.agg_func}(val({var}))"] = json_value(v)
            elif v is not None:
                obj[child.alias or f"val({var})"] = json_value(v)
            elif sg.params.cascade:
                cascade_fail = True
            continue
        if attr == "math":
            if child.params.is_internal:
                continue
            v = child.values.get(uid)
            if v is not None:
                obj[child.alias or "math"] = json_value(v)
            continue
        if attr == "_predicate_":
            v = child.values.get(uid)
            if v is not None:
                obj[child.alias or "_predicate_"] = v.value
            continue
        if child.params.is_groupby:
            if child.groups is not None:
                obj[key] = [{"@groupby": child.groups}]
            continue
        if child.func is not None and child.func.name == "checkpwd":
            v = child.values.get(uid)
            if v is not None:
                # reference shape: "pwd": [{"checkpwd": true}]
                obj[child.alias or attr] = [{"checkpwd": bool(v.value)}]
            continue
        if child.is_value_node() or (not len(child.out_flat) and child.values):
            v = child.values.get(uid)
            if v is not None:
                obj[key] = json_value(v)
                f = child.value_facets.get(uid)
                if f and child.params.facets:
                    fj = _facets_json(f, child.params.facets)
                    if fj:
                        obj.setdefault("@facets", {})[key] = fj
            elif sg.params.cascade:
                cascade_fail = True
            continue
        if len(child.seg_ptr) > 1 or len(child.out_flat):
            # uid child
            i = _src_index(child, uid)
            items: List[dict] = []
            if i >= 0:
                for dst in child.row_targets(i).tolist():
                    if ignore_reflex and int(dst) in path:
                        continue
                    sub = encode_node(store, child, int(dst), path, ignore_reflex)
                    if sub is None:
                        continue
                    f = child.edge_facets.get((uid, int(dst)))
                    if f and child.params.facets is not None:
                        fj = _facets_json(f, child.params.facets)
                        if fj:
                            sub = {**sub, "@facets": {"_": fj}}
                    if sub:
                        items.append(sub)
                for gc in child.children:
                    if gc.params.do_count and gc.attr == "":
                        items.append({"count": len(child.row_targets(i))})
                        break
            if items:
                obj[key] = items
            elif sg.params.cascade or child.params.cascade:
                cascade_fail = True
            continue
        # empty expansion (no data): under cascade this kills the node
        if child.values:
            v = child.values.get(uid)
            if v is not None:
                obj[key] = json_value(v)
                continue
        if sg.params.cascade:
            cascade_fail = True
    if cascade_fail:
        return None
    if DEBUG_UIDS.get() and obj:
        obj.setdefault("_uid_", _uid_hex(uid))
    return obj


def _normalize_flatten(store, sg: SubGraph, uid: int) -> Optional[List[dict]]:
    """@normalize: one flat object per DFS path, aliased leaves only."""
    base: dict = {}
    for child in sg.children:
        if child.alias and (child.is_value_node() or child.values):
            v = child.values.get(uid)
            if v is not None:
                base[child.alias] = json_value(v)
        elif child.alias and child.params.do_count:
            i = _src_index(child, uid)
            if child.counts is not None and i >= 0:
                base[child.alias] = int(child.counts[i])
        elif child.alias and child.attr in ("_uid_", "uid"):
            base[child.alias] = _uid_hex(uid)
    branch_lists: List[List[dict]] = []
    for child in sg.children:
        if (len(child.seg_ptr) > 1 or len(child.out_flat)) and child.children:
            i = _src_index(child, uid)
            if i < 0:
                continue
            subs: List[dict] = []
            for dst in child.row_targets(i).tolist():
                got = _normalize_flatten(store, child, int(dst))
                if got:
                    subs.extend(got)
            if subs:
                branch_lists.append(subs)
    if not branch_lists:
        return [base] if base else []
    out = [base]
    for subs in branch_lists:
        out = [{**o, **s} for o in out for s in subs]
    return out


def encode_block(store: PostingStore, sg: SubGraph) -> List[dict]:
    if sg.params.is_groupby and sg.groups is not None:
        return [{"@groupby": sg.groups}]  # root-level @groupby (GroupByRoot)
    out: List[dict] = []
    bare_count = any(
        c.params.do_count and c.attr == "" for c in sg.children
    )
    if bare_count:
        out.append({"count": int(len(sg.dest_uids))})
    if not len(sg.dest_uids) and sg.func is None:
        # aggregation-only block (`total() { sum(val(c)) ... }`): values
        # live under the synthetic uid 0
        obj = encode_node(store, sg, 0)
        return [obj] if obj else []
    for uid in sg.dest_uids.tolist():
        if sg.params.normalize:
            got = _normalize_flatten(store, sg, int(uid))
            if got:
                out.extend(got)
            continue
        obj = encode_node(
            store, sg, int(uid), ignore_reflex=sg.params.ignore_reflex
        )
        if obj:
            out.append(obj)
    return out


def encode_path(store: PostingStore, sg: SubGraph, out: dict):
    """shortest blocks render under "_path_" (query/shortest.go
    createPathSubgraph:598) plus a regular block for requested attrs."""
    paths = getattr(sg, "paths", None) or []
    objs = []
    for path in paths:
        node: Optional[dict] = None
        for elem in reversed(path):
            cur = {"_uid_": _uid_hex(elem["uid"])}
            if elem.get("facets"):
                cur["@facets"] = {"_": _facets_json(elem["facets"])}
            if node is not None:
                cur[elem["attr_out"]] = [node]
            node = cur
        if node:
            objs.append(node)
    out.setdefault("_path_", []).extend(objs)
    if sg.children:
        out.setdefault(sg.params.alias or "_path_", [])
