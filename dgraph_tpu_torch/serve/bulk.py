"""Native-accelerated bulk ingest (port of ``dgraph_tpu/serve/bulk.py``).

The set-mutation hot path: scan N-Quads with the C++ tokenizer
(native/nquad_scan.cpp), resolve each distinct subject/object/predicate
string exactly once, then apply plain uid edges in vectorized
per-predicate groups (store.bulk_set_uid_edges — one WAL record per
group) and values/complex quads through the ordinary edge path.

Returns None — the caller then parses with the Python parser, so error
surfaces are identical — under ``DGRAPH_TPU_NO_NATIVE`` or when the
scanner declines the body (a grammar corner it rejects, stars in a set
block).  A scanner that fails to build raises.  The reference's
equivalent throughput lever is the loader's pipelined goroutines +
badger batch writes (cmd/dgraphloader/main.go:151, posting/lists.go
gentle commit); ours is native scanning + grouped application.

Ordering note: within one set block, plain uid edges apply grouped by
predicate before value edges and faceted/complex quads.  Set operations
commute except for repeated writes of the same (pred, src, lang) value
or the same facet edge, whose relative order IS preserved (values and
complex quads each apply in input order).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from dgraph_tpu_torch.models.password import hash_password
from dgraph_tpu_torch.models.store import Edge, PostingStore
from dgraph_tpu_torch.models.types import TypeID, TypedValue, convert
from dgraph_tpu_torch.rdf.parse import _unescape, parse_facets_body, typed_literal


def fast_apply_set(
    store: PostingStore, text: str, blanks: Dict[str, int]
) -> Optional[int]:
    """Apply a set-mutation body via the native scanner.  Returns the
    number of quads applied, or None to request the Python fallback."""
    from dgraph_tpu_torch import native

    try:
        r = native.scan(text)
    except ValueError:
        return None  # let the Python parser produce its ParseError
    if r is None:
        return None  # DGRAPH_TPU_NO_NATIVE
    if r.n == 0:
        return 0
    from dgraph_tpu_torch.native import (
        F_HAS_FACETS,
        F_HAS_LABEL,
        F_HAS_LANG,
        F_HAS_TYPE,
        F_LIT_ESCAPED,
        F_OBJ_LITERAL,
        F_OBJ_STAR,
        F_PRED_STAR,
        F_SUBJ_STAR,
    )

    buf = r.buf
    flags = r.flags.astype(np.int32)

    # '*' anywhere is delete-only syntax; stars in a set block are an
    # error — let the Python path raise it
    if np.any(flags & (F_SUBJ_STAR | F_PRED_STAR | F_OBJ_STAR)):
        return None

    # -- resolve unique tables ---------------------------------------------
    from dgraph_tpu_torch.serve.mutations import resolve_uid

    subj_uid = r.subj_uid.copy()
    obj_uid = r.obj_uid.copy()
    # reserve the explicit uid range FIRST: fresh blank-node uids must not
    # collide with uids named later in the same block
    explicit_max = int(subj_uid.max()) if len(subj_uid) else 0
    if len(obj_uid):
        explicit_max = max(explicit_max, int(obj_uid.max()))
    if explicit_max > 0:
        store.uids.reserve_through(explicit_max)
    for i in np.flatnonzero(subj_uid < 0).tolist():
        s, e = r.subj_spans[i]
        subj_uid[i] = resolve_uid(store, buf[s:e].decode("utf-8"), blanks)
    for i in np.flatnonzero(obj_uid < 0).tolist():
        s, e = r.obj_spans[i]
        obj_uid[i] = resolve_uid(store, buf[s:e].decode("utf-8"), blanks)

    preds = r.strings(r.pred_spans)
    langs = r.strings(r.lang_spans)
    types = r.strings(r.type_spans)

    is_complex = (flags & (F_HAS_FACETS | F_HAS_LABEL)) != 0
    is_uid_edge = (~is_complex) & (r.obj_idx >= 0)
    is_value = (~is_complex) & ((flags & F_OBJ_LITERAL) != 0)

    # -- values and faceted/labeled quads: build + validate ALL of them
    # BEFORE the first durable write.  Facet parsing and schema type
    # conversion can raise; the whole set block must fail all-or-nothing,
    # matching the Python fallback (which converts in nquad_to_edge before
    # apply_many).  Only after every quad validates do we touch the store.
    #
    # Ordering: plain uid edges commute with everything — a faceted uid
    # edge's facet map is set independently of the edge bit — but repeated
    # VALUE writes of the same (pred, src, lang) are last-write-wins, so
    # value-bearing quads apply strictly in input order regardless of
    # whether they carry facets.
    src_all = subj_uid[r.subj_idx]
    schema_tid: Dict[int, TypeID] = {}
    ordered_edges = []
    # plain values divert to the bulk path (one dict pass per predicate)
    # ONLY when no complex quad carries a literal: a faceted value write
    # of the same (pred, src, lang) must keep its input-order position
    # relative to plain writes (last-write-wins), and splitting the two
    # streams would reorder them.
    complex_has_value = bool(
        np.any(is_complex & ((flags & F_OBJ_LITERAL) != 0))
    )
    bulk_vals: Dict[int, list] = {}
    for i in np.flatnonzero(is_value | is_complex).tolist():
        pi = int(r.pred_idx[i])
        facets = None
        if flags[i] & F_HAS_FACETS:
            body = buf[r.facet_s[i] : r.facet_e[i]].decode("utf-8")
            facets = parse_facets_body(body, body)
        if r.obj_idx[i] >= 0:
            ordered_edges.append(
                Edge(pred=preds[pi], src=int(src_all[i]),
                     dst=int(obj_uid[r.obj_idx[i]]), facets=facets))
            continue
        body = buf[r.lit_s[i] : r.lit_e[i]].decode("utf-8")
        if flags[i] & F_LIT_ESCAPED:
            body = _unescape(body)
        tname = types[r.type_idx[i]] if flags[i] & F_HAS_TYPE else ""
        val = typed_literal(body, tname)
        tid = schema_tid.get(pi)
        if tid is None:  # NOT setdefault: it would call type_of per line
            tid = schema_tid[pi] = store.schema.type_of(preds[pi])
        if tid not in (TypeID.DEFAULT, TypeID.UID):
            val = convert(val, tid)
            if tid == TypeID.PASSWORD:
                val = TypedValue(TypeID.PASSWORD, hash_password(str(val.value)))
        lang = langs[r.lang_idx[i]] if flags[i] & F_HAS_LANG else ""
        if facets is None and not complex_has_value:
            bulk_vals.setdefault(pi, []).append((int(src_all[i]), lang, val))
        else:
            ordered_edges.append(Edge(pred=preds[pi], src=int(src_all[i]),
                                      value=val, lang=lang, facets=facets))

    batch_cm = store.batch() if hasattr(store, "batch") else None
    if batch_cm is not None:
        batch_cm.__enter__()
    try:
        # -- plain uid edges: vectorized per predicate ----------------------
        if np.any(is_uid_edge):
            dst_all = np.where(r.obj_idx >= 0, obj_uid[np.clip(r.obj_idx, 0, None)], 0)
            for pi in np.unique(r.pred_idx[is_uid_edge]).tolist():
                g = is_uid_edge & (r.pred_idx == pi)
                store.bulk_set_uid_edges(preds[pi], src_all[g], dst_all[g])

        # plain values: one dict pass + one WAL/proposal record per
        # predicate group (input order preserved within each group)
        for pi, items in bulk_vals.items():
            store.bulk_set_values(preds[pi], items)

        # one batched apply: a single WAL flush standalone, one proposal
        # batch per group under replication
        if ordered_edges:
            store.apply_many(ordered_edges)
    finally:
        if batch_cm is not None:
            batch_cm.__exit__(None, None, None)
    return int(r.n)
