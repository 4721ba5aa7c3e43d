"""@groupby execution (PyTorch port of ``dgraph_tpu/query/groupby.py``;
processGroupBy, query/groupby.go:194 in Dgraph).

Groups the node's expanded destination uids by the value (or target uid)
of the groupby attribute, then evaluates the node's children — count or
aggregations — per group.  A host module: one arena row lookup (the CSR
arena's host mirrors) and one searchsorted over the untagged value
mirror compute every uid's group-key part per attribute; only lang-chain
lookups probe per uid.  The grouping is a host dict (group keys are
heterogeneous display tuples).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from dgraph_tpu_torch.models.types import numeric
from dgraph_tpu_torch.query.outputnode import json_value, _uid_hex
from dgraph_tpu_torch.query.subgraph import SubGraph


def _attr_parts(engine, attr: str, lang: str, dest: np.ndarray):
    """Vectorized per-uid (key_part, display) columns for one groupby
    attribute: uid-valued rows group by their FIRST (smallest) target,
    value rows by the stringified value — the same precedence as the
    per-uid original."""
    n = len(dest)
    parts: List[tuple] = [("v", attr, None)] * n
    disps: List[object] = [None] * n
    pd = engine.store.peek(attr)
    if pd is None:
        return parts, disps
    covered = np.zeros(n, dtype=bool)
    if pd.edges:
        a = engine.arenas.data(attr)
        rows = a.rows_for_uids_host(dest)
        ok = rows >= 0
        if ok.any():
            deg = a.degree_of_rows(rows)
            has = ok & (deg > 0)
            # first target of each row: posting lists are sorted, so it
            # is the row's first packed entry
            starts = a.h_offsets[np.where(has, rows, 0)]
            firsts = a.host_dst()[starts] if a.n_edges else np.zeros(0)
            for i in np.flatnonzero(has):
                t = int(firsts[i])
                parts[i] = ("u", attr, t)
                disps[i] = _uid_hex(t)
            covered |= has
    rest = np.flatnonzero(~covered)
    if len(rest) == 0:
        return parts, disps
    langs = lang.split(":") if lang else [""]
    if langs == [""]:
        sub = dest[rest]
        hit, pos, mv = pd.untagged_lookup(sub)
        for j, i in enumerate(rest):
            if hit[j]:
                v = mv[pos[j]]
                parts[i] = ("v", attr, str(v.value))
                disps[i] = json_value(v)
        return parts, disps
    # lang-chain fallback (rare): per-uid probes in chain order
    for i in rest:
        u = int(dest[i])
        v = None
        for l in langs:
            v = (
                engine.store.any_value(attr, u)
                if l == "."
                else engine.store.value(attr, u, l)
            )
            if v is not None:
                break
        if v is not None:
            parts[i] = ("v", attr, str(v.value))
            disps[i] = json_value(v)
    return parts, disps


def process_groupby(engine, sg: SubGraph, value_vars=None):
    value_vars = value_vars or {}
    dest = sg.dest_uids
    groups: Dict[Tuple, dict] = {}
    members: Dict[Tuple, List[int]] = {}

    attrs = sg.params.groupby_attrs
    cols = [_attr_parts(engine, attr, lang, dest) for attr, lang in attrs]
    dest_list = dest.tolist()
    for i, u in enumerate(dest_list):
        key = tuple(parts[i] for parts, _d in cols)
        if key not in groups:
            disp = {}
            for (attr, _lang), (_parts, disps) in zip(attrs, cols):
                if disps[i] is not None:
                    disp[attr] = disps[i]
            groups[key] = disp
            members[key] = []
        members[key].append(int(u))

    out = []
    for key, disp in groups.items():
        item = dict(disp)
        for child in sg.children:
            if child.params.do_count:
                item["count"] = len(members[key])
            elif child.params.agg_func and child.needs_var:
                # aggregate a value var over group members
                var = child.needs_var[0]
                vmap = value_vars.get(var, {})
                nums = [numeric(vmap[u]) for u in members[key] if u in vmap]
                nums = [x for x in nums if x is not None]
                if nums:
                    fn = child.params.agg_func
                    r = (
                        min(nums) if fn == "min" else max(nums) if fn == "max"
                        else sum(nums) if fn == "sum" else sum(nums) / len(nums)
                    )
                    item[child.alias or f"{fn}(val({var}))"] = float(r)
        out.append(item)
    # deterministic order: by the first group attr's display value
    out.sort(key=lambda d: str(sorted(d.items())))
    sg.groups = out
