"""Mutation application: parsed mutation blocks → store edits.

Equivalent of the reference's query/mutation.go (ToInternal:174,
AssignUids:109) + worker/mutation.go runMutations: N-Quads become edges,
blank nodes get fresh uids (scoped per request), string xids resolve
through the uid dictionary, values are converted to the schema type
(validateAndConvert, worker/mutation.go:270), passwords are hashed.
"""

from __future__ import annotations

from typing import Dict, List

from dgraph_tpu_torch.gql.ast import Mutation
from dgraph_tpu_torch.models.password import hash_password

from dgraph_tpu_torch.models.store import Edge, PostingStore
from dgraph_tpu_torch.models.types import TypeID, TypedValue, convert
from dgraph_tpu_torch.rdf import NQuad, parse_nquads
from dgraph_tpu_torch.utils.metrics import BULK_QUADS


def resolve_uid(store: PostingStore, ref: str, blanks: Dict[str, int]) -> int:
    """subject/object id string → internal uid (AssignUids analog)."""
    if ref.startswith("_:"):
        u = blanks.get(ref)
        if u is None:
            u = store.uids.fresh(1)[0]
            blanks[ref] = u
        return u
    if ref.lower().startswith("0x"):
        u = int(ref, 16)
        store.uids.reserve_through(u)
        return u
    # NOTE: bare digits are a string xid, not an explicit uid — only 0x
    # ids are literal uids (rdf/parse.go treats <123> as an external id)
    return store.uids.assign(ref)


def nquad_to_edge(
    store: PostingStore, nq: NQuad, blanks: Dict[str, int], op: str
) -> List[Edge]:
    if nq.predicate == "*" and op != "del":
        raise ValueError("'*' predicate only allowed in delete")
    src = resolve_uid(store, nq.subject, blanks)
    if op == "del" and (nq.is_star or nq.predicate == "*"):
        preds = (
            store.predicates() if nq.predicate == "*" else [nq.predicate]
        )
        out = []
        for pr in preds:
            pd = store.peek(pr)
            if pd is None:
                continue
            for d in list(pd.edges.get(src, ())):
                out.append(Edge(pred=pr, src=src, dst=d, op="del"))
            for (u, lang) in [k for k in pd.values if k[0] == src]:
                out.append(
                    Edge(pred=pr, src=src, value=TypedValue(TypeID.DEFAULT, ""),
                         lang=lang, op="del")
                )
        return out
    if nq.object_id:
        dst = resolve_uid(store, nq.object_id, blanks)
        return [Edge(pred=nq.predicate, src=src, dst=dst,
                     facets=nq.facets or None, op=op)]
    val = nq.object_value
    tid = store.schema.type_of(nq.predicate)
    if tid not in (TypeID.DEFAULT, TypeID.UID) and val is not None:
        val = convert(val, tid)
        if tid == TypeID.PASSWORD:
            val = TypedValue(TypeID.PASSWORD, hash_password(str(val.value)))
    return [Edge(pred=nq.predicate, src=src, value=val, lang=nq.lang,
                 facets=nq.facets or None, op=op)]


def format_assigned_uids(blanks: Dict[str, int]) -> Dict[str, str]:
    """Blank-node assignments → response 'uids' map: strip the '_:' prefix
    and hex-format, as the reference's StripBlankNode does
    (cmd/dgraph/main.go:432)."""
    return {
        (k[2:] if k.startswith("_:") else k): f"0x{v:x}" for k, v in blanks.items()
    }


def apply_mutation(store: PostingStore, mu: Mutation) -> Dict[str, int]:
    """Apply a mutation block; returns the blank-node → uid assignments
    (the reference returns these as 'uids' in the response)."""
    blanks: Dict[str, int] = {}
    if mu.schema:
        from dgraph_tpu_torch.models.schema import split_entries

        store.apply_schema(mu.schema)  # journaled when the store is durable
        # schema changes may alter index/reverse arenas for those preds
        for entry in split_entries(mu.schema):
            if ":" in entry:
                store.dirty.add(entry.split(":", 1)[0].strip())
    # parse AND convert deletes up front: a malformed delete (bad quad or
    # unconvertible uid ref) must fail the request before the fast path
    # durably applies any sets.  Star-deletes therefore expand against the
    # pre-mutation store, which matches the Python-only path (conversion
    # happens before apply_many there too).
    del_quads = parse_nquads(mu.del_nquads) if mu.del_nquads else []
    _reserve_explicit_uids(store, del_quads)
    del_edges: List[Edge] = []
    for nq in del_quads:
        del_edges.extend(nquad_to_edge(store, nq, blanks, "del"))
    applied = None
    if mu.set_nquads:
        from dgraph_tpu_torch.serve.bulk import fast_apply_set

        applied = fast_apply_set(store, mu.set_nquads, blanks)
        if applied is not None:
            BULK_QUADS.add("native", applied)
    edges: List[Edge] = []
    if applied is None and mu.set_nquads:
        set_quads = parse_nquads(mu.set_nquads)
        BULK_QUADS.add("python", len(set_quads))
        # reserve the whole explicit uid range BEFORE assigning blank-node
        # uids, or a fresh uid can alias an explicit uid named later in
        # the same block (the reference assigns uids in a pre-pass too,
        # query/mutation.go:109 AssignUids)
        _reserve_explicit_uids(store, set_quads)
        for nq in set_quads:
            edges.extend(nquad_to_edge(store, nq, blanks, "set"))
    edges.extend(del_edges)
    store.apply_many(edges)
    return blanks


def _reserve_explicit_uids(store: PostingStore, quads) -> None:
    mx = 0
    for nq in quads:
        for ref in (nq.subject, nq.object_id):
            if ref and ref.lower().startswith("0x"):
                try:
                    mx = max(mx, int(ref, 16))
                except ValueError:
                    pass
    if mx:
        store.uids.reserve_through(mx)
