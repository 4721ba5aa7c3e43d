"""Root/filter function resolution: Function AST node → sorted uid set.

The port of ``dgraph_tpu/query/functions.py``: each function is resolved
against the arenas (index posting lists expanded through the torch
``expand_csr`` or numpy, as the planner prices them: query/planner.py),
then — for lossy
tokenizers (float/year/term-eq/trigram/geo) — exact-rechecked on the
host.  k-way intersections (allofterms / alloftext, term-eq, trigram AND)
route through ``joinplan.kway_intersect``: the host fold or the
intersect kernel, as the planner prices them.
"""

from __future__ import annotations

import json
import re
from typing import Dict, List, Optional

import numpy as np

import torch

from dgraph_tpu_torch import obs, ops
from dgraph_tpu_torch.ops.sets import SENT
from dgraph_tpu_torch import tok as tokmod
from dgraph_tpu_torch.models import geo as geomod
from dgraph_tpu_torch.models.arena import ArenaManager, IndexArena
from dgraph_tpu_torch.models.store import PostingStore
from dgraph_tpu_torch.models.types import (
    TypeID,
    TypedValue,
    compare_vals,
    convert,
)
from dgraph_tpu_torch.gql.ast import Function

class QueryError(ValueError):
    pass


_EMPTY = np.empty(0, dtype=np.int64)

_INEQ = {"le", "ge", "lt", "gt", "eq"}


class FuncResolver:
    """Resolves functions against a store+arenas+variable environment."""

    def __init__(
        self,
        store: PostingStore,
        arenas: ArenaManager,
        uid_vars: Dict[str, np.ndarray],
        value_vars: Dict[str, Dict[int, TypedValue]],
        stats: Optional[dict] = None,
        cancel=None,
    ):
        self.store = store
        self.arenas = arenas
        self.uid_vars = uid_vars
        self.value_vars = value_vars
        # per-request engine stats (QueryEngine passes its own)
        self.stats = stats
        # cooperative cancellation (sched/qos.py): index probes that
        # loop over per-token/cell expansions checkpoint this token
        self.cancel = cancel

    def checkpoint(self) -> None:
        """Cancellation checkpoint for resolver-side expansion loops
        (the graftlint ``unchecked-hop-loop`` contract)."""
        tok = self.cancel
        if tok is not None:
            tok.check()

    # -- public ------------------------------------------------------------

    def resolve(
        self, fn: Function, candidates: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """uid set satisfying ``fn``; ``candidates`` bounds val()/count()
        style functions that are only meaningful relative to a set."""
        name = fn.name
        if name == "uid":
            out = np.array(sorted(set(fn.uid_args)), dtype=np.int64)
            for ref in fn.needs_vars:
                if ref.name in self.uid_vars:
                    out = np.union1d(out, self.uid_vars[ref.name])
                elif ref.name in self.value_vars:
                    # uid(v) over a VALUE var uses its uid keys
                    # (uid(val-var) semantics, query.go fillVars)
                    vm = self.value_vars[ref.name]
                    out = np.union1d(
                        out, np.fromiter(vm.keys(), dtype=np.int64, count=len(vm))
                    )
            if candidates is not None:
                out = np.intersect1d(out, candidates)
            return out
        if fn.is_val_var:
            return self._val_var_compare(fn, candidates)
        if fn.is_count:
            return self._count_compare(fn, candidates)
        if name in _INEQ:
            return self._bound(self._ineq(fn), candidates)
        if name in ("allofterms", "anyofterms"):
            return self._bound(self._terms(fn, "term", name == "allofterms"), candidates)
        if name in ("alloftext", "anyoftext"):
            return self._bound(self._terms(fn, "fulltext", name == "alloftext"), candidates)
        if name == "has":
            a = self.arenas.has_rows(fn.attr)
            pd = self.store.peek(fn.attr)
            if pd is None or not pd.values:
                # plain data arena: incremental deltas leave degree-0
                # rows behind after deletes — has() must not report them
                n = len(a.h_src)
                deg = a.h_offsets[1 : n + 1] - a.h_offsets[:n]
                return self._bound(a.h_src[deg > 0].copy(), candidates)
            return self._bound(a.h_src.copy(), candidates)
        if name == "regexp":
            return self._bound(self._regexp(fn), candidates)
        if name in ("near", "within", "contains", "intersects"):
            return self._bound(self._geo(fn), candidates)
        if name == "checkpwd":
            return self._checkpwd(fn, candidates)
        if name == "uid_in":
            return self._uid_in(fn, candidates)
        raise QueryError(f"unknown function {fn.name!r}")

    # -- helpers -----------------------------------------------------------

    def _bound(self, uids: np.ndarray, candidates: Optional[np.ndarray]) -> np.ndarray:
        if candidates is None:
            return uids
        return np.intersect1d(uids, candidates)

    def _expand_rows(self, arena, rows: np.ndarray) -> np.ndarray:
        """Union of the posting lists at ``rows`` (expand + unique),
        size-routed host/device like QueryEngine._expand through the
        same priced break-even (query/planner.py::expand_route; the
        static expand_device_min compare when the planner is off or the
        knob is pinned), recorded and closed like an engine hop."""
        from dgraph_tpu_torch.query import planner

        rows = np.asarray(rows, dtype=np.int64)
        rows = rows[rows >= 0]
        if rows.size == 0 or arena.n_edges == 0:
            return _EMPTY
        total = int(arena.degree_of_rows(rows).sum())
        if total == 0:
            return _EMPTY
        use_device, dec = planner.expand_route(
            total, self.arenas.expand_device_min
        )
        if dec is not None:
            planner.record(self.stats, dec)
        st = self.stats if self.stats is not None else {}
        r0 = st.get("resolver_expand_ms", 0.0)
        if not use_device:
            with obs.stage(st, "resolver_expand_ms"):
                out, _seg = arena.expand_host(rows)
                res = np.unique(out)
            planner.note_served_outcome(dec, (st["resolver_expand_ms"] - r0) * 1e3)
            return res
        with obs.stage(st, "resolver_expand_ms"):
            cap = ops.bucket(total)
            arena.ensure_device()  # stale after incremental host deltas
            rows_t = torch.from_numpy(
                ops.pad_rows(rows, ops.bucket(len(rows)))
            ).to(arena.device)
            out, _seg, _t = ops.expand_csr(arena.offsets, arena.dst, rows_t, cap)
            # the resolver's one fetch of its expansion, unguarded as the
            # reference's np.asarray (query/functions.py)
            # graftlint: ignore[naked-device-sync]
            u = ops.sort_unique(out).cpu().numpy()
            res = u[u != SENT].astype(np.int64)
        planner.note_served_outcome(dec, (st["resolver_expand_ms"] - r0) * 1e3)
        return res

    def _kway(self, sets: List[np.ndarray]) -> np.ndarray:
        """k-way intersection of sorted-unique sets, size-routed through
        the join tier (query/joinplan.py) on the arenas' device."""
        from dgraph_tpu_torch.query import joinplan

        return joinplan.kway_intersect(
            sets, stats=self.stats, device=self.arenas.device,
            device_min=self.arenas.kway_device_min,
        )

    def _pred_index(self, pred: str, prefer_sortable: bool) -> IndexArena:
        toks = self.store.schema.tokenizers(pred)
        if not toks:
            raise QueryError(f"predicate {pred!r} is not indexed")
        name = None
        if prefer_sortable:
            name = self.store.schema.sortable_tokenizer(pred)
        if name is None:
            name = toks[0]
        return self.arenas.index(pred, name)

    def _typed_value(self, pred: str, raw: str) -> TypedValue:
        tid = self.store.schema.type_of(pred)
        if tid == TypeID.DEFAULT:
            tid = TypeID.STRING
        return convert(TypedValue(TypeID.STRING, raw), tid)

    def _host_recheck(self, pred: str, uids: np.ndarray, op: str, val: TypedValue, lang: str = "") -> np.ndarray:
        out = []
        langs = lang.split(",") if lang else [""]
        for u in uids.tolist():
            v = None
            for l in langs:
                v = (
                    self.store.any_value(pred, int(u))
                    if l == "."
                    else self.store.value(pred, int(u), l)
                )
                if v is not None:
                    break
            if v is not None and compare_vals(op, v, val):
                out.append(u)
        return np.array(out, dtype=np.int64)

    # -- function families ---------------------------------------------------

    def _ineq(self, fn: Function) -> np.ndarray:
        if not fn.args:
            raise QueryError(f"{fn.name} needs a value argument")
        # eq may take multiple values — varargs or a bracket list, both
        # meaning "any of" (gql parseFunction list args)
        vals: List[str] = []
        for raw in fn.args if fn.name == "eq" else fn.args[:1]:
            if fn.name == "eq" and raw.startswith("["):
                try:
                    items = json.loads(raw)
                except json.JSONDecodeError:
                    vals.append(raw)
                    continue
                for x in items:
                    # the bracket-list parser floats all numbers (geo
                    # coords); integral floats must round-trip as ints or
                    # int-typed predicates choke on "19.0"
                    if isinstance(x, float) and x.is_integer():
                        vals.append(str(int(x)))
                    else:
                        vals.append(str(x))
                continue
            vals.append(raw)
        out = _EMPTY
        for raw in vals:
            out = np.union1d(out, self._ineq_one(fn, raw))
        return out

    def _ineq_one(self, fn: Function, raw: str) -> np.ndarray:
        pred, op = fn.attr, fn.name
        val = self._typed_value(pred, raw)
        idx = self._pred_index(pred, prefer_sortable=True)
        tk = tokmod.get_tokenizer(idx.tokenizer)
        if op == "eq" and not tk.sortable:
            # term/fulltext-indexed eq: token intersection + exact recheck.
            # fulltext tokens reduce under the function's @lang tag, the
            # same per-language analyzer the index build used
            # (tok.tokens_for_value_lang) — mismatched stemmers would
            # miss every lang-tagged value
            toks = tokmod.tokens_for_value_lang(tk.name, val, fn.lang)
            rows = [idx.row_of(t) for t in toks]
            if any(r < 0 for r in rows) or not rows:
                return _EMPTY
            sets = [self._expand_rows(idx.csr, np.array([r])) for r in rows]
            cand = self._kway(sets)
            return self._host_recheck(pred, cand, "eq", val, fn.lang)
        if not tk.sortable and op != "eq":
            raise QueryError(
                f"inequality on {pred!r} needs a sortable index (have {idx.tokenizer})"
            )
        token = tk.fn(val)[0]
        if op == "eq":
            lo, hi = idx.row_range(lo=token, hi=token)
        elif op == "le":
            lo, hi = idx.row_range(hi=token)
        elif op == "lt":
            lo, hi = idx.row_range(hi=token, hi_open=True)
        elif op == "ge":
            lo, hi = idx.row_range(lo=token)
        else:  # gt
            lo, hi = idx.row_range(lo=token, lo_open=True)
        cand = self._expand_rows(idx.csr, np.arange(lo, hi))
        if tk.lossy or fn.lang or self._pred_has_langs(pred):
            # lossy buckets include near-misses; lang-tagged functions
            # must verify the match against the TAGGED value only; and an
            # UNtagged function over a predicate with tagged values must
            # re-check against the untagged value — the index spans every
            # language (task.go:612-661 lang filters), so a tagged token
            # can land inside the untagged comparison range
            cand = self._host_recheck(pred, cand, op, val, fn.lang)
        return cand

    def _pred_has_langs(self, pred: str) -> bool:
        """Does the predicate carry any lang-tagged values?  Cached on the
        PredicateData snapshot (replaced wholesale on dirty refresh)."""
        pd = self.store.peek(pred)
        if pd is None:
            return False
        flag = getattr(pd, "_has_langs", None)
        if flag is None:
            flag = any(lang for (_u, lang) in pd.values.keys())
            try:
                pd._has_langs = flag
            except AttributeError:
                pass  # slotted/foreign store impl: recompute per call
        return flag

    def _terms(self, fn: Function, tokenizer: str, all_of: bool) -> np.ndarray:
        if not fn.args:
            raise QueryError(f"{fn.name} needs a value argument")
        toks_avail = self.store.schema.tokenizers(fn.attr)
        if tokenizer not in toks_avail:
            raise QueryError(f"{fn.name} on {fn.attr!r} needs @index({tokenizer})")
        idx = self.arenas.index(fn.attr, tokenizer)
        text = " ".join(fn.args)
        qtoks = (
            tokmod.term_tokens(text)
            if tokenizer == "term"
            else tokmod.fulltext_tokens(text, fn.lang.split(",")[0] if fn.lang else "en")
        )
        if not qtoks:
            return _EMPTY
        sets = []
        for t in qtoks:
            self.checkpoint()
            r = idx.row_of(t)
            if r < 0:
                if all_of:
                    return _EMPTY
                sets.append(_EMPTY)
            else:
                sets.append(self._expand_rows(idx.csr, np.array([r])))
        if all_of:
            # allofterms = k-way intersection of token posting sets
            return self._kway(sets)
        out = sets[0]
        for s in sets[1:]:
            out = np.union1d(out, s)
        return out

    def _regexp(self, fn: Function) -> np.ndarray:
        if not fn.args:
            raise QueryError("regexp needs a pattern")
        raw = fn.args[0]
        flags = 0
        if not raw.startswith("/") or "/" not in raw[1:]:
            # reference requires /pattern/[flags] (parser.go regexp arg)
            raise QueryError(f"regexp argument must be /pattern/: got {raw!r}")
        body, _, tail = raw[1:].rpartition("/")
        pat = body
        if "i" in tail:
            flags |= re.IGNORECASE
        try:
            rx = re.compile(pat, flags)
        except re.error as e:
            raise QueryError(f"bad regexp {pat!r}: {e}")
        # trigram candidate generation (worker/trigram.go:36): extract
        # literal runs >= 3 chars and AND their trigram lists.  Only sound
        # for pure concatenation with exact case: alternation/optional
        # groups make runs disjunctive, and the index stores case-
        # preserving trigrams — in those cases fall back to a full scan
        # (still correct: the regex re-check below is exact).
        cand = None
        prunable = (
            "trigram" in self.store.schema.tokenizers(fn.attr)
            and not (flags & re.IGNORECASE)
            and not re.search(r"[|?]|\(\?", pat)
        )
        if prunable:
            idx = self.arenas.index(fn.attr, "trigram")
            tsets = []
            for lit in _literal_runs(pat):
                for tg in tokmod.trigram_tokens(lit):
                    self.checkpoint()
                    r = idx.row_of(tg)
                    tsets.append(
                        self._expand_rows(idx.csr, np.array([r]))
                        if r >= 0
                        else _EMPTY
                    )
            if tsets:
                # trigram AND over every literal's posting set
                cand = self._kway(tsets)
        if cand is None:
            pd = self.store.peek(fn.attr)
            cand = (
                np.array(sorted({u for (u, _l) in pd.values.keys()}), dtype=np.int64)
                if pd
                else _EMPTY
            )
        langs = fn.lang.split(",") if fn.lang else [""]
        if langs == [""]:
            # untagged fast path: ONE searchsorted over the cached value
            # mirror replaces the per-uid store.value dict chain; the
            # remaining per-candidate cost is rx.search itself (C code)
            pd = self.store.peek(fn.attr)
            if pd is None or not len(cand):
                return _EMPTY
            hit, pos, mv = pd.untagged_lookup(cand)
            uids = cand[hit]
            vals = mv[pos[hit]]
            keep = np.fromiter(
                (rx.search(str(v.value)) is not None for v in vals),
                dtype=bool,
                count=len(vals),
            )
            return np.unique(uids[keep])
        out = []
        for u in cand.tolist():
            for l in langs:
                v = (
                    self.store.any_value(fn.attr, int(u))
                    if l == "."
                    else self.store.value(fn.attr, int(u), l)
                )
                if v is not None and rx.search(str(v.value)):
                    out.append(u)
                    break
        return np.array(sorted(set(out)), dtype=np.int64)

    def _geo(self, fn: Function) -> np.ndarray:
        if not fn.args:
            raise QueryError(f"{fn.name} needs coordinates")
        coords = json.loads(fn.args[0])
        max_m = float(fn.args[1]) if len(fn.args) > 1 else None
        if fn.name == "near":
            q = geomod.Geom("Point", tuple(coords))
        elif isinstance(coords[0], (int, float)):
            q = geomod.Geom("Point", tuple(coords))
        else:
            ring = tuple(tuple(c) for c in (coords[0] if isinstance(coords[0][0], list) else coords))
            q = geomod.Geom("Polygon", ring)
        if "geo" not in self.store.schema.tokenizers(fn.attr):
            raise QueryError(f"{fn.name} on {fn.attr!r} needs @index(geo)")
        idx = self.arenas.index(fn.attr, "geo")
        if fn.name == "near":
            if max_m is None:
                raise QueryError("near needs a distance argument")
            # candidate cells: the query point's ancestors plus neighbors
            # found via the coarse cells of an expanded bbox
            import math as _m

            dlat = max_m / 111_320.0  # meters per degree latitude
            lng, lat = q.coords
            # longitude degrees shrink by cos(lat) away from the equator
            dlng = dlat / max(_m.cos(_m.radians(lat)), 1e-6)
            ring = (
                (lng - dlng, lat - dlat), (lng + dlng, lat - dlat),
                (lng + dlng, lat + dlat), (lng - dlng, lat + dlat),
            )
            cells = geomod.polygon_cells(ring)
        else:
            cells = geomod.query_cells(q)
        cand = None
        sets = []
        for c in cells:
            self.checkpoint()
            r = idx.row_of(c)
            if r >= 0:
                sets.append(self._expand_rows(idx.csr, np.array([r])))
        cand = np.unique(np.concatenate(sets)) if sets else _EMPTY
        # exact post-filter (types/geofilter.go FilterGeoUids:325),
        # vectorized: ONE searchsorted over the untagged value mirror
        # replaces the per-uid store.value probe, and near()'s haversine
        # runs over the whole Point column in one numpy pass.  Polygon
        # predicates (within/contains/intersects) still walk per geometry
        # — ring math is data-dependent — but over mirror-gathered values.
        pd = self.store.peek(fn.attr)
        if pd is None or not len(cand):
            return _EMPTY
        hit, pos, mv = pd.untagged_lookup(cand)
        uids = cand[hit]
        geoms = mv[pos[hit]]
        if fn.name == "near":
            is_pt = np.fromiter(
                (v.value.kind == "Point" for v in geoms),
                dtype=bool,
                count=len(geoms),
            )
            uids = uids[is_pt]
            pts = geoms[is_pt]
            if not len(pts):
                return _EMPTY
            lngs = np.fromiter((v.value.coords[0] for v in pts), np.float64, len(pts))
            lats = np.fromiter((v.value.coords[1] for v in pts), np.float64, len(pts))
            keep = geomod.haversine_m_vec(q.coords, lngs, lats) <= max_m
        else:
            keep = np.fromiter(
                (geomod.matches_filter(fn.name, q, v.value) for v in geoms),
                dtype=bool,
                count=len(geoms),
            )
        return np.sort(uids[keep])

    def _count_compare(self, fn: Function, candidates: Optional[np.ndarray]) -> np.ndarray:
        if not fn.args:
            raise QueryError("count comparison needs a value")
        n = int(fn.args[0])
        arena = self.arenas.data(fn.attr)
        degs = arena.h_offsets[1:] - arena.h_offsets[:-1]
        src = arena.h_src
        # incremental deletes leave degree-0 rows in patched arenas; a
        # row-less uid and a zero-degree row must behave identically
        # (count-0 matches only through the explicit candidates union)
        live = degs > 0
        src, degs = src[live], degs[live]
        op = fn.name
        mask = {
            "eq": degs == n,
            "le": degs <= n,
            "lt": degs < n,
            "ge": degs >= n,
            "gt": degs > n,
        }[op]
        out = src[mask]
        # uids with zero edges have no arena row; include them whenever a
        # count of 0 satisfies the comparison (ge 0, le N, eq 0, ...)
        zero_satisfies = {
            "eq": n == 0, "le": 0 <= n, "lt": 0 < n, "ge": 0 >= n, "gt": 0 > n,
        }[op]
        if candidates is not None and zero_satisfies:
            out = np.union1d(out, np.setdiff1d(candidates, src))
        return self._bound(out, candidates)

    def _val_var_compare(self, fn: Function, candidates: Optional[np.ndarray]) -> np.ndarray:
        vmap = self.value_vars.get(fn.attr, {})
        if not fn.args:
            raise QueryError(f"{fn.name}(val({fn.attr})) needs a value")
        target_raw = fn.args[0]
        out = []
        uids = candidates if candidates is not None else np.array(sorted(vmap), dtype=np.int64)
        for u in uids.tolist():
            v = vmap.get(int(u))
            if v is None:
                continue
            tv = (
                convert(TypedValue(TypeID.STRING, target_raw), v.tid)
                if not isinstance(target_raw, TypedValue)
                else target_raw
            )
            if compare_vals(fn.name, v, tv):
                out.append(u)
        return np.array(out, dtype=np.int64)

    def _checkpwd(self, fn: Function, candidates: Optional[np.ndarray]) -> np.ndarray:
        from dgraph_tpu_torch.models.password import verify_password

        out = []
        uids = candidates if candidates is not None else _EMPTY
        for u in uids.tolist():
            v = self.store.value(fn.attr, int(u))
            if v is not None and verify_password(fn.args[0], str(v.value)):
                out.append(u)
        return np.array(out, dtype=np.int64)

    def _uid_in(self, fn: Function, candidates: Optional[np.ndarray]) -> np.ndarray:
        """uid_in(pred, uid): candidates having a ``pred`` edge to uid."""
        if not fn.args and not fn.uid_args:
            raise QueryError("uid_in needs a target uid")
        target = fn.uid_args[0] if fn.uid_args else int(fn.args[0], 0)
        rev = self.arenas.reverse(fn.attr)
        rows = rev.rows_for_uids_host(np.array([target], dtype=np.int64))
        sources = self._expand_rows(rev, rows)
        return self._bound(sources, candidates)


def _literal_runs(pattern: str) -> List[str]:
    """Literal substrings of a regex usable for trigram candidates —
    conservative: strip groups/classes/escapes; runs must not merge
    across removed metacharacters (separator is \\x00, never space,
    since literals may contain spaces)."""
    s = re.sub(r"\\.|\[[^\]]*\]|\(\?[^)]*\)", "\x00", pattern)
    # anything directly before *, ?, or {m,n} may occur zero (or many)
    # times — NOT a required literal; drop it with its quantifier
    # (codesearch's RegexpQuery does the same cut).  Groups resolve
    # innermost-first: a quantified group is dropped whole, a plain
    # group is transparent for its contents but splits runs at its
    # edges (conservative), iterated to a fixpoint for nesting.
    prev = None
    while prev != s:
        prev = s
        s = re.sub(r"\([^()]*\)(\{[^}]*\}|[*?+])", "\x00", s)
        s = re.sub(r"\(([^()]*)\)", "\x00\\1\x00", s)
    s = re.sub(r".\{[^}]*\}", "\x00", s)
    s = re.sub(r".[*?]", "\x00", s)
    s = re.sub(r"[(){}|^$.*+?]", "\x00", s)
    return [seg for seg in s.split("\x00") if len(seg.strip()) >= 3]
