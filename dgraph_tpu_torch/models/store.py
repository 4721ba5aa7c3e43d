"""Host-side posting store with Set/Del mutation semantics.

Equivalent of the reference's posting/ package (list.go mutation layer +
lists.go store): the mutable source of truth that the immutable device
arenas are built from.  The reference overlays a sorted mutation layer on
an immutable protobuf layer per list (posting/list.go:321-410); here the
host store is a straightforward per-predicate edge/value map with dirty
tracking, and "commit" = rebuilding the affected predicate's arena
(models/arena.py) — the analog of SyncIfDirty + lcache refresh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Set, Tuple

from dgraph_tpu_torch.models.types import TypedValue
from dgraph_tpu_torch.models.schema import SchemaState
from dgraph_tpu_torch.models.uids import UidMap


@dataclass
class Edge:
    """A directed edge mutation (protos DirectedEdge, task.proto:103)."""

    pred: str
    src: int
    dst: int = 0                      # uid edges
    value: Optional[TypedValue] = None  # value edges
    lang: str = ""
    facets: Optional[Dict[str, TypedValue]] = None
    op: str = "set"                   # "set" | "del"


class PredicateData:
    """All postings for one predicate: uid edges and/or values."""

    __slots__ = ("edges", "values", "edge_facets", "value_facets",
                 "_has_langs",  # lazy lang-presence flag (functions.py)
                 "_untagged",   # lazy vectorized value mirror (below)
                 "_efmirror",   # lazy vectorized edge-facet mirror
                 "_wdmirror")   # lazy sorted uids-with-data mirror

    def __init__(self):
        # src uid -> set of dst uids
        self.edges: Dict[int, Set[int]] = {}
        # (src uid, lang) -> TypedValue ; lang "" is the default value
        self.values: Dict[Tuple[int, str], TypedValue] = {}
        # (src, dst) -> facets
        self.edge_facets: Dict[Tuple[int, int], Dict[str, TypedValue]] = {}
        # src -> facets (on value edges)
        self.value_facets: Dict[int, Dict[str, TypedValue]] = {}
        self._untagged = None
        self._efmirror = None
        self._wdmirror = None

    def untagged_mirror(self):
        """Vectorized mirror of the untagged values: (sorted int64 uid
        array, aligned object array of TypedValues).  The engine's
        value-leaf fetch probes this with ONE searchsorted instead of a
        Python dict probe per uid (VERDICT r3 weak #6: at 21M-corpus
        fan-outs the per-uid loop becomes the bottleneck once expansion
        is fast).  Invalidated on every value mutation (apply/apply_many
        clear the slot)."""
        m = self._untagged
        if m is None:
            import numpy as _np

            uids = sorted(u for (u, l) in self.values.keys() if l == "")
            arr = _np.fromiter(uids, dtype=_np.int64, count=len(uids))
            vals = _np.empty(len(uids), dtype=object)
            for i, u in enumerate(uids):
                vals[i] = self.values[(u, "")]
            m = self._untagged = (arr, vals)
        return m

    def untagged_lookup(self, uids):
        """Vectorized untagged-value probe: (hit_mask, positions) into the
        mirror's value array for ``uids`` (int64 ndarray).  Shared by the
        engine's value-leaf fetch and groupby."""
        import numpy as _np

        mu, mv = self.untagged_mirror()
        if not len(mu):
            return _np.zeros(len(uids), bool), _np.zeros(len(uids), _np.int64), mv
        pos = _np.clip(_np.searchsorted(mu, uids), 0, len(mu) - 1)
        return mu[pos] == uids, pos, mv

    def edge_facets_lookup(self, srcs, dsts):
        """Vectorized edge-facet probe: for parallel src/dst arrays return
        (hit_mask, positions, facet_dict_array) — one searchsorted over a
        sorted (src<<32|dst) mirror instead of a Python dict probe per
        edge (VERDICT r3 weak #6).  Mirror invalidated on facet writes."""
        import numpy as _np

        m = self._efmirror
        if m is None:
            keys = _np.fromiter(
                ((s << 32) | d for (s, d) in self.edge_facets.keys()),
                dtype=_np.int64,
                count=len(self.edge_facets),
            )
            order = _np.argsort(keys)
            keys = keys[order]
            vals = _np.empty(len(keys), dtype=object)
            items = list(self.edge_facets.values())
            for i, oi in enumerate(order):
                vals[i] = items[oi]
            m = self._efmirror = (keys, vals)
        mk, mv = m
        if not len(mk):
            return _np.zeros(len(srcs), bool), _np.zeros(len(srcs), _np.int64), mv
        q = (_np.asarray(srcs, _np.int64) << 32) | _np.asarray(dsts, _np.int64)
        pos = _np.clip(_np.searchsorted(mk, q), 0, len(mk) - 1)
        return mk[pos] == q, pos, mv

    def uids_with_data(self) -> Set[int]:
        out = set(self.edges.keys())
        out.update(u for (u, _l) in self.values.keys())
        return out

    def uids_with_data_sorted(self):
        """Sorted int64 array of uids_with_data, cached until the next
        mutation (apply() clears the slot unconditionally).  The engine's
        ``_predicate_`` probe runs ONE searchsorted per predicate over
        this instead of a Python set probe per uid × per predicate."""
        m = self._wdmirror
        if m is None:
            import numpy as _np

            s = self.uids_with_data()
            m = _np.fromiter(s, dtype=_np.int64, count=len(s))
            m.sort()
            self._wdmirror = m
        return m


class PostingStore:
    """The mutable graph: schema + uid dictionary + per-predicate postings."""

    # per-predicate mutation journal cap: deltas beyond this fall back to
    # a full arena rebuild (bulk loads overflow immediately, point
    # mutations stay incremental — the gentle-commit amortization analog,
    # posting/lists.go:109-215)
    DELTA_MAX = 65536

    # version covers EVERY observable change: anything readable through
    # this store changes only via a version bump.  The tier-2 result
    # cache (cache/result.py) requires this — a hit short-circuits
    # execution entirely.
    strict_snapshot_versions = True

    def __init__(self, schema: Optional[SchemaState] = None):
        self.schema = schema if schema is not None else SchemaState()
        self.uids = UidMap()
        self._preds: Dict[str, PredicateData] = {}
        self.dirty: Set[str] = set()
        # monotonic snapshot version: bumps on every mutation batch.
        # Consumers: the cohort scheduler's admission signature
        # (sched/cohort.py) and, through ivm/versions.py, both query
        # cache tiers
        self.version = 0
        # pred -> [(src, dst, +1|-1), ...] since the last arena refresh;
        # None = overflowed (full rebuild required).  Only uid-edge ops
        # journal here; value mutations always force a full refresh of
        # the value/index arenas (cheap: those arenas are value-sized).
        self.delta: Dict[str, Optional[List[Tuple[int, int, int]]]] = {}
        # per-predicate freshness (ivm/versions.py): pred_versions maps
        # each predicate to the version of the LAST mutation that
        # touched it; pred_floor is the version of the last change that
        # cannot be scoped to predicates (a schema mutation).  Cache
        # tiers key entries on max(floor, max(pred_versions[footprint]))
        # instead of the global version, so a mutation only invalidates
        # entries that read its predicates.  delta_base records, per
        # journaled predicate, the pred version BEFORE the journal's first
        # delta — the version every live cache entry for that predicate
        # carries, which the delta repair (models/arena.py) re-keys from.
        self.pred_versions: Dict[str, int] = {}
        self.pred_floor = 0
        self.delta_base: Dict[str, int] = {}
        # mutation delta stream (ivm/deltas.py), attached by the serving
        # layer for live-query subscriptions; None costs one attribute
        # read per mutation
        self.delta_stream = None
        # cluster membership carried by MEMBER records (models/wal.py);
        # member_hook fires on their replay
        self.members: Dict[str, tuple] = {}
        self.member_hook = None

    # -- access ------------------------------------------------------------

    def predicates(self) -> List[str]:
        return sorted(self._preds)

    def pred(self, name: str) -> PredicateData:
        p = self._preds.get(name)
        if p is None:
            p = PredicateData()
            self._preds[name] = p
        return p

    def peek(self, name: str) -> Optional[PredicateData]:
        return self._preds.get(name)

    def value(self, pred: str, uid: int, lang: str = "") -> Optional[TypedValue]:
        """Exact-language lookup: a tagged request does NOT fall back to
        the untagged value — matching the reference's v0.7 semantics
        (query_test.go TestLangSingleFallback: name@cn with no @cn value
        yields nothing).  Fallback is explicit: the '.' element of a lang
        chain maps to any_value()."""
        p = self._preds.get(pred)
        if p is None:
            return None
        return p.values.get((uid, lang))

    def any_value(self, pred: str, uid: int) -> Optional[TypedValue]:
        """The untagged value, else any language's value (list.go:835)."""
        p = self._preds.get(pred)
        if p is None:
            return None
        v = p.values.get((uid, ""))
        if v is not None:
            return v
        for (u, _l), val in p.values.items():
            if u == uid:
                return val
        return None

    def _journal_delta(self, pred: str, src: int, dst: int, sign: int) -> None:
        d = self.delta.get(pred, [])
        if d is None:
            return  # already overflowed
        if pred not in self.delta:
            # fresh journal window: remember the pred version its views
            # were built at (repair re-keys entries FROM this version)
            self.delta_base[pred] = self.pred_versions.get(pred, 0)
        if len(d) >= self.DELTA_MAX:
            self.delta[pred] = None
            return
        d.append((src, dst, sign))
        self.delta[pred] = d

    def _journal_touch(self, pred: str) -> None:
        """Journal a no-op/facet-only touch: arenas are unaffected, so
        an EMPTY entry lets refresh skip the rebuild (an overflow None
        is preserved) — but the window still needs its repair base."""
        if pred not in self.delta:
            self.delta_base[pred] = self.pred_versions.get(pred, 0)
            self.delta[pred] = []

    def _delta_overflow(self, pred: str) -> None:
        self.delta[pred] = None

    def _note_pred_mutation(self, pred: str, stream_kind: str = "",
                            src: int = 0, dst: int = 0, sign: int = 0) -> None:
        """Per-predicate freshness and delta-stream publication for ONE
        mutation (the version was already bumped).  ``stream_kind``:
        "edge" publishes the exact edge delta, "pred" a whole-predicate
        change, "" nothing."""
        self.pred_versions[pred] = self.version
        ds = self.delta_stream
        if ds is None or not stream_kind:
            return
        if stream_kind == "edge":
            ds.publish_edge(pred, src, dst, sign, self.version)
        else:
            ds.publish_pred(pred, self.version)

    def note_global_change(self) -> None:
        """Record a change that cannot be scoped to predicates (a schema
        mutation, a full-store replacement): the floor advances to the
        current version, so EVERY footprint-keyed cache entry goes
        stale, and the delta stream publishes an epoch."""
        self.pred_floor = self.version
        ds = self.delta_stream
        if ds is not None:
            ds.publish_epoch(self.version)

    def apply(self, e: Edge) -> None:
        """Apply one edge mutation (AddMutationWithIndex analog,
        posting/index.go:273 — index derivation happens at arena build)."""
        p = self.pred(e.pred)
        self.dirty.add(e.pred)
        self.version += 1
        p._wdmirror = None  # any mutation can change uids-with-data
        # the delta stream's shape of this mutation: an exact edge delta
        # when one exists, else a whole-predicate change (value and
        # facet edits have no per-edge form)
        kind, sign = "pred", 0
        if e.op == "set":
            if e.value is not None:
                p.values[(e.src, e.lang)] = e.value
                if not e.lang:  # the mirror indexes untagged values only
                    p._untagged = None
                self._delta_overflow(e.pred)  # value/index arenas rebuild
                if e.lang:
                    # invalidate the lazy lang-presence flag (functions.py
                    # caches it on this live object)
                    try:
                        del p._has_langs
                    except AttributeError:
                        pass
                if e.facets:
                    p.value_facets[e.src] = dict(e.facets)
            else:
                tgt = p.edges.setdefault(e.src, set())
                if e.dst not in tgt:
                    tgt.add(e.dst)
                    self._journal_delta(e.pred, e.src, e.dst, +1)
                    kind, sign = "edge", +1
                else:
                    # facet-only / no-op touch: arenas unaffected — keep
                    # an (empty) journal entry so refresh skips the
                    # rebuild (an overflow None is preserved)
                    self._journal_touch(e.pred)
                if e.facets:
                    p.edge_facets[(e.src, e.dst)] = dict(e.facets)
                    p._efmirror = None
        elif e.op == "del":
            if e.value is not None or e.dst == 0:
                p.values.pop((e.src, e.lang), None)
                if not e.lang:
                    p._untagged = None
                p.value_facets.pop(e.src, None)
                self._delta_overflow(e.pred)
                if e.lang:
                    try:
                        del p._has_langs
                    except AttributeError:
                        pass
            else:
                s = p.edges.get(e.src)
                if s is not None and e.dst in s:
                    s.discard(e.dst)
                    if not s:
                        del p.edges[e.src]
                    self._journal_delta(e.pred, e.src, e.dst, -1)
                    kind, sign = "edge", -1
                else:
                    self._journal_touch(e.pred)  # no-op delete
                if p.edge_facets.pop((e.src, e.dst), None) is not None:
                    p._efmirror = None
        else:
            raise ValueError(f"unknown mutation op {e.op!r}")
        self._note_pred_mutation(e.pred, kind, e.src, e.dst, sign)

    def apply_many(self, edges: Iterable[Edge]) -> int:
        n = 0
        for e in edges:
            self.apply(e)
            n += 1
        return n

    # bulk_set_uid_edges batches at or under this size journal per-edge
    # deltas like apply() instead of overflowing: the serving path's
    # fast mutation scanner (serve/bulk.py) routes EVERY set mutation
    # here — including the single-edge point writes whose cached views
    # the IVM layer repairs in place — and an unconditional overflow
    # forced a full arena rebuild (and killed every repairable entry)
    # per point write.  Genuine bulk loads sail past it into the
    # rebuild-is-cheaper path unchanged.
    BULK_JOURNAL_MAX = 256

    def bulk_set_uid_edges(self, pred: str, src, dst) -> None:
        """Vectorized ingest of plain uid edges (no facets): group-by-src
        with one sort instead of a dict/set round trip per edge.  The
        native bulk path (serve/bulk.py) feeds whole predicate groups
        here; semantics identical to apply(set) per edge."""
        import numpy as np

        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if len(src) == 0:
            return
        p = self.pred(pred)
        self.dirty.add(pred)
        self.version += 1
        p._wdmirror = None  # uids-with-data changes under bulk adds too
        if len(src) <= self.BULK_JOURNAL_MAX:
            # point-write shape: per-edge journal entries (new edges
            # +1, duplicates an empty touch) so arena delta refresh and
            # IVM view repair keep working through the serving path
            edges = p.edges
            for s, d in zip(src.tolist(), dst.tolist()):
                tgt = edges.setdefault(s, set())
                if d not in tgt:
                    tgt.add(d)
                    self._journal_delta(pred, s, d, +1)
                else:
                    self._journal_touch(pred)
            self._note_pred_mutation(pred, "pred")
            return
        self._delta_overflow(pred)  # bulk volume: full rebuild is cheaper
        order = np.argsort(src, kind="stable")
        s = src[order]
        d = dst[order]
        bounds = np.flatnonzero(np.concatenate(([True], s[1:] != s[:-1])))
        ends = np.append(bounds[1:], len(s))
        edges = p.edges
        for b0, b1 in zip(bounds.tolist(), ends.tolist()):
            u = int(s[b0])
            tgt = edges.get(u)
            if tgt is None:
                edges[u] = set(d[b0:b1].tolist())
            else:
                tgt.update(d[b0:b1].tolist())
        self._note_pred_mutation(pred, "pred")  # bulk: no per-edge stream

    def bulk_set_values(self, pred: str, items) -> None:
        """Vectorized ingest of plain (facet-less) value edges: ONE dict
        update pass per predicate group instead of an Edge object +
        apply() dispatch per value.  ``items`` = [(src, lang, TypedValue)]
        in input order — last-write-wins per (src, lang) is preserved by
        insertion order.  Semantics identical to apply(set) per edge."""
        if not items:
            return
        p = self.pred(pred)
        self.dirty.add(pred)
        self.version += 1
        p._wdmirror = None
        self._delta_overflow(pred)  # value/index arenas rebuild
        vals = p.values
        any_untagged = any_lang = False
        for src, lang, v in items:
            vals[(src, lang)] = v
            if lang:
                any_lang = True
            else:
                any_untagged = True
        if any_untagged:
            p._untagged = None
        if any_lang:
            try:
                del p._has_langs
            except AttributeError:
                pass
        self._note_pred_mutation(pred, "pred")

    def delete_predicate(self, pred: str) -> None:
        """posting.DeletePredicate analog (posting/index.go:666)."""
        self._preds.pop(pred, None)
        self.dirty.add(pred)
        self.version += 1
        self._delta_overflow(pred)
        self._note_pred_mutation(pred, "pred")

    def apply_schema(self, text: str) -> None:
        """Parse schema text into this store's schema state; journaled
        subclasses override (schema mutations, worker/mutation.go:94)."""
        from dgraph_tpu_torch.models.schema import parse_schema

        parse_schema(text, into=self.schema)
        self.version += 1
        # schema changes (type/index/reverse semantics) are not scoped
        # to a predicate's postings
        self.note_global_change()
