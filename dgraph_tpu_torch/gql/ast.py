"""AST node types for GraphQL±.

Mirrors the reference's gql.GraphQuery (gql/parser.go:41), FilterTree
(parser.go:74), Function (parser.go:56), MathTree (gql/math.go) and
facet parameters — as plain dataclasses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

UID_VAR = "uid"
VALUE_VAR = "value"


@dataclass
class VarRef:
    """A variable a query needs (NeedsVar), with its kind."""

    name: str
    typ: str  # UID_VAR | VALUE_VAR


@dataclass
class Function:
    """A function application: func name, attribute, args.

    Forms of the first argument (gql/parser.go parseFunction:1362):
    plain attr, attr@lang, val(var), count(attr) — flagged here.
    """

    name: str = ""
    attr: str = ""
    lang: str = ""
    args: List[str] = field(default_factory=list)
    needs_vars: List[VarRef] = field(default_factory=list)
    is_count: bool = False      # gt(count(friends), 10)
    is_val_var: bool = False    # gt(val(a), 10)
    uid_args: List[int] = field(default_factory=list)  # uid(0x1, 0x2)


@dataclass
class FilterTree:
    """Boolean filter tree: op in {"and","or","not",""}; leaf has func."""

    op: str = ""
    children: List["FilterTree"] = field(default_factory=list)
    func: Optional[Function] = None


@dataclass
class FacetsSpec:
    """@facets directive params (keys to fetch / order / var bindings)."""

    all_keys: bool = False
    keys: List[str] = field(default_factory=list)
    aliases: Dict[str, str] = field(default_factory=dict)   # key -> var name
    order_key: str = ""
    order_desc: bool = False


@dataclass
class MathTree:
    """math(...) expression tree (gql/math.go)."""

    fn: str = ""                 # operator/function name; "" for leaf
    var: str = ""                # leaf: value-variable name
    const: Optional[float] = None  # leaf: numeric constant
    children: List["MathTree"] = field(default_factory=list)

    def debug(self) -> str:
        if self.fn:
            return "(" + " ".join([self.fn] + [c.debug() for c in self.children]) + ")"
        if self.var:
            return self.var
        return repr(self.const)


@dataclass
class GraphQuery:
    """One node of the query tree (block root or attribute child)."""

    attr: str = ""
    alias: str = ""
    langs: List[str] = field(default_factory=list)
    func: Optional[Function] = None
    args: Dict[str, str] = field(default_factory=dict)  # first/offset/after/orderasc/...
    filter: Optional[FilterTree] = None
    children: List["GraphQuery"] = field(default_factory=list)
    uid_list: List[int] = field(default_factory=list)   # explicit root uids

    is_count: bool = False          # count(pred)
    is_internal: bool = False       # var-only node (no output)
    is_groupby: bool = False
    expand: str = ""                # "_all_" or a value-var name
    var: str = ""                   # "x as pred" definition
    needs_var: List[VarRef] = field(default_factory=list)
    agg_func: str = ""              # min/max/sum/avg over val(...)
    math_exp: Optional[MathTree] = None
    facets: Optional[FacetsSpec] = None
    facets_filter: Optional[FilterTree] = None
    groupby_attrs: List[Tuple[str, str]] = field(default_factory=list)  # (attr, lang)

    normalize: bool = False
    cascade: bool = False
    ignore_reflex: bool = False

    # shortest-path / recurse args resolved by the engine from ``args``


def referenced_preds(queries: List["GraphQuery"]) -> Optional[set]:
    """The set of predicate names a parsed query can read, or None when
    the set is not statically determinable (``expand()`` and
    ``_predicate_`` blocks read schema-driven predicate lists only known
    at execution time).  Used to scope the query caches' versions to the
    predicates a request reads (ivm/versions.py).  Collection errs on the
    side of INCLUSION — an extra name costs a spurious miss, a missed one
    would serve a stale entry."""
    out: set = set()

    def add(name: str) -> None:
        if name:
            # "~pred" reads the same predicate's data through its reverse
            # index; "pred@lang" order args keep the raw form
            out.add(name.lstrip("~").split("@", 1)[0])

    def walk_fn(fn: Optional[Function]) -> None:
        if fn is not None:
            add(fn.attr)

    def walk_filter(ft: Optional[FilterTree]) -> None:
        if ft is None:
            return
        walk_fn(ft.func)
        for c in ft.children:
            walk_filter(c)

    def walk(gq: "GraphQuery") -> bool:
        if gq.expand:
            return False  # schema/var-driven: preds unknown until run time
        if gq.attr == "_predicate_":
            return False  # reads every predicate of the node
        add(gq.attr)
        walk_fn(gq.func)
        walk_filter(gq.filter)
        walk_filter(gq.facets_filter)
        for key in ("orderasc", "orderdesc"):
            v = gq.args.get(key, "")
            if v and not v.startswith("val("):
                add(v)
        for attr, _lang in gq.groupby_attrs:
            add(attr)
        return all(walk(c) for c in gq.children)

    for gq in queries:
        if not walk(gq):
            return None
    return out


@dataclass
class Mutation:
    """Raw mutation bodies; RDF parsing happens in dgraph_tpu.rdf."""

    set_nquads: str = ""
    del_nquads: str = ""
    schema: str = ""


@dataclass
class SchemaRequest:
    predicates: List[str] = field(default_factory=list)
    fields: List[str] = field(default_factory=list)


@dataclass
class ParsedResult:
    queries: List[GraphQuery] = field(default_factory=list)
    mutation: Optional[Mutation] = None
    schema_request: Optional[SchemaRequest] = None
    # per-block (defines, needs) for scheduling (gql checkDependency:605)
    query_vars: List[Tuple[List[str], List[str]]] = field(default_factory=list)
