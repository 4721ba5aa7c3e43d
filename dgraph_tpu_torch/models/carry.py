"""State carried into the port: build a ``PostingStore`` from plain data,
or a ``CSRArena`` from another arena's host mirrors.

A snapshot is a dict of Python and numpy values only, so any producer —
the reference engine's store, an export, a generator — can hand its
graph to the port without sharing a class with it::

    {
      "schema": [{"name": str, "type": int (TypeID), "tokenizers": [str],
                  "reverse": bool, "count": bool}, ...],
      "uids": {"xids": {xid: uid}, "next": int},
      "preds": {
        name: {
          "edges": (src int64[E], dst int64[E]),
          "values": [(uid, lang, value), ...],
          "edge_facets": [(src, dst, [(key, value), ...]), ...],
          "value_facets": [(uid, [(key, value), ...]), ...],
        },
      },
    }

where every ``value`` is ``(tid, payload)``: ``tid`` a ``TypeID`` int,
``payload`` the Python value (``datetime`` for dates, ``(kind, coords)``
for geometry).  Lists keep their producer's order, so dict iteration
order — and with it the order of facet keys in responses — carries over.
The arenas are built from the store on first use.

An arena is carried as its host CSR mirrors (``csr_arena_from_host``):
row offsets, packed targets and the two counts, as plain numpy — what
any CSR producer holds, the reference's ``CSRArena`` included.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from dgraph_tpu_torch.models.arena import CSRArena, _csr_from_arrays
from dgraph_tpu_torch.models.geo import Geom
from dgraph_tpu_torch.models.schema import PredicateSchema
from dgraph_tpu_torch.models.store import PostingStore
from dgraph_tpu_torch.models.types import TypeID, TypedValue


def typed_value(v) -> TypedValue:
    """A snapshot ``(tid, payload)`` pair as the port's TypedValue."""
    tid, payload = v
    tid = TypeID(int(tid))
    if tid == TypeID.GEO:
        kind, coords = payload
        payload = Geom(kind, coords)
    return TypedValue(tid, payload)


def _facets(items) -> dict:
    return {k: typed_value(v) for k, v in items}


def store_from_snapshot(snap: dict) -> PostingStore:
    """The port's PostingStore holding exactly ``snap``'s graph."""
    st = PostingStore()
    for ent in snap.get("schema", ()):
        st.schema.set(PredicateSchema(
            name=ent["name"],
            tid=TypeID(int(ent["type"])),
            tokenizers=list(ent.get("tokenizers", ())),
            reverse=bool(ent.get("reverse", False)),
            count=bool(ent.get("count", False)),
        ))
    uids = snap.get("uids")
    if uids is not None:
        st.uids.restore(uids["xids"], uids["next"])
    for name, p in snap.get("preds", {}).items():
        pd = st.pred(name)
        src, dst = p.get("edges", ((), ()))
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        groups = defaultdict(set)
        for s, d in zip(src.tolist(), dst.tolist()):
            groups[s].add(d)
        pd.edges = dict(groups)
        for uid, lang, v in p.get("values", ()):
            pd.values[(int(uid), lang)] = typed_value(v)
        for s, d, items in p.get("edge_facets", ()):
            pd.edge_facets[(int(s), int(d))] = _facets(items)
        for uid, items in p.get("value_facets", ()):
            pd.value_facets[int(uid)] = _facets(items)
    return st


def csr_arena_from_host(h_offsets, h_dst, n_rows: int, n_edges: int,
                        device) -> CSRArena:
    """The port's dense CSRArena (row i == uid i) over the same CSR as
    another dense arena's host mirrors: ``h_offsets`` int[n_rows + 1] and
    ``h_dst`` int[>= n_edges] (packed targets, ascending within each
    row).  The device tensors are padded as the port builds its own."""
    n_rows, n_edges = int(n_rows), int(n_edges)
    keys = np.arange(n_rows, dtype=np.int64)
    offsets = np.asarray(h_offsets, dtype=np.int64)[: n_rows + 1]
    dst = np.asarray(h_dst)[:n_edges].astype(np.int32)
    return _csr_from_arrays(keys, offsets, dst, device)
