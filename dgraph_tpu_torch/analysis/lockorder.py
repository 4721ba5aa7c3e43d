"""Static lock-order graph over the package's ``with <lock>`` nesting.

Nineteen modules take locks; a deadlock needs only two of them to
disagree about order once, under load, on a path no test drives.  This
pass extracts a conservative *lock-class* graph the way the kernel's
lockdep does — every lock CLASS is its declaration site (an attribute
assigned ``threading.Lock()``/``RLock()``/``Condition()``/``RWLock()``,
or a module-global), and an edge A→B means "somewhere, B is acquired
while A is held".  A cycle in that graph is a potential ABBA deadlock.

Scope (kept deliberately conservative so a cycle report is credible):

- ``with`` nesting inside one function body, including multi-item
  ``with a, b:`` forms and locks reached through local aliases
  (``bl = self._build_locks.setdefault(...)`` / ``with bl:``);
- ``self.method()`` calls made while a lock is held propagate the
  callee's acquisitions (fixpoint over same-class methods, plus
  module-level functions for bare calls);
- ``obj.attr`` locks resolve when the attribute name maps to exactly
  one declared lock class in the package (e.g. ``srv._engine_lock``);
  ambiguous names are dropped, not guessed.

Cross-object call chains (scheduler → engine → arena) are exactly what
the static pass CANNOT see — the runtime witness recorder
(:mod:`.witness`), armed for the whole tier-1 run, covers those with
observed acquisition orders.  The two are a pair, not alternatives.

RLock self-nesting is legal and skipped; a self-edge on a plain Lock or
Condition is reported as a finding (it would self-deadlock).
"""

from __future__ import annotations

import ast
import re
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from dgraph_tpu_torch.analysis.framework import iter_py_files

_LOCK_CTORS = {
    "threading.Lock": "Lock",
    "threading.RLock": "RLock",
    "threading.Condition": "Condition",
    "RWLock": "RWLock",
    "Lock": "Lock",
    "RLock": "RLock",
    "Condition": "Condition",
}


def _dotted(node: ast.AST) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _lock_ctor_kind(node: ast.AST) -> Optional[str]:
    """'Lock'/'RLock'/... when ``node`` constructs a lock, else None."""
    if isinstance(node, ast.Call):
        return _LOCK_CTORS.get(_dotted(node.func))
    return None


@dataclass
class LockClass:
    name: str      # canonical: module.Class.attr / module.attr
    kind: str      # Lock | RLock | Condition | RWLock
    site: str      # path:line of the declaration


@dataclass
class Edge:
    src: str
    dst: str
    site: str      # path:line of the inner acquisition
    via: str = ""  # call chain note, "" for direct nesting


@dataclass
class LockGraph:
    classes: Dict[str, LockClass] = field(default_factory=dict)
    edges: Dict[Tuple[str, str], Edge] = field(default_factory=dict)
    self_nesting: List[Edge] = field(default_factory=list)

    def add_edge(self, src: str, dst: str, site: str, via: str = "") -> None:
        if src == dst:
            kind = self.classes.get(src, LockClass(src, "Lock", site)).kind
            if kind != "RLock":
                self.self_nesting.append(Edge(src, dst, site, via))
            return
        self.edges.setdefault((src, dst), Edge(src, dst, site, via))

    def cycles(self) -> List[List[Edge]]:
        """Elementary cycles via DFS over the edge set (the graph is
        tiny — tens of nodes)."""
        adj: Dict[str, List[Edge]] = defaultdict(list)
        for e in self.edges.values():
            adj[e.src].append(e)
        out: List[List[Edge]] = []
        seen_cycles: Set[Tuple[str, ...]] = set()

        def dfs(node: str, path: List[Edge], on_path: Dict[str, int]):
            for e in adj[node]:
                if e.dst in on_path:
                    cyc = path[on_path[e.dst]:] + [e]
                    key = tuple(sorted(x.src for x in cyc))
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        out.append(cyc)
                    continue
                on_path[e.dst] = len(path) + 1
                dfs(e.dst, path + [e], on_path)
                del on_path[e.dst]

        for start in list(adj):
            dfs(start, [], {start: 0})
        return out

    def render(self) -> str:
        lines = [f"lock classes: {len(self.classes)}, edges: {len(self.edges)}"]
        for e in sorted(self.edges.values(), key=lambda e: (e.src, e.dst)):
            via = f"  (via {e.via})" if e.via else ""
            lines.append(f"  {e.src} -> {e.dst}  [{e.site}]{via}")
        return "\n".join(lines)


# -- extraction -------------------------------------------------------------

class _FileInfo:
    def __init__(self, path: str, tree: ast.AST, module: str):
        self.path = path
        self.tree = tree
        self.module = module


def _module_name(f: Path, base: Path) -> str:
    try:
        rel = f.resolve().relative_to(base.resolve())
    except ValueError:
        rel = Path(f.name)
    return ".".join(rel.with_suffix("").parts)


def build_lock_graph(
    roots: Iterable[str],
    repo_root: Optional[str] = None,
    exclude: Sequence[str] = (),
) -> LockGraph:
    base = Path(repo_root) if repo_root else Path(".")
    files: List[_FileInfo] = []
    for f in iter_py_files(roots, exclude=exclude):
        try:
            tree = ast.parse(f.read_text(encoding="utf-8"))
        except SyntaxError:
            continue
        rel = f.as_posix()
        try:
            rel = f.resolve().relative_to(base.resolve()).as_posix()
        except ValueError:
            pass
        files.append(_FileInfo(rel, tree, _module_name(f, base)))

    g = LockGraph()
    # attr name -> set of canonical names (for obj.attr resolution)
    by_attr: Dict[str, Set[str]] = defaultdict(set)
    # (module, class|None, attr) -> canonical
    exact: Dict[Tuple[str, Optional[str], str], str] = {}

    for fi in files:
        _collect_classes(fi, g, by_attr, exact)
    for fi in files:
        _collect_edges(fi, g, by_attr, exact)
    return g


def _collect_classes(fi, g, by_attr, exact) -> None:
    def declare(cls: Optional[str], attr: str, kind: str, lineno: int):
        name = f"{fi.module}.{cls}.{attr}" if cls else f"{fi.module}.{attr}"
        if name not in g.classes:
            g.classes[name] = LockClass(name, kind, f"{fi.path}:{lineno}")
        by_attr[attr].add(name)
        exact[(fi.module, cls, attr)] = name

    for node in ast.walk(fi.tree):
        if isinstance(node, ast.ClassDef):
            for sub in ast.walk(node):
                if isinstance(sub, ast.Assign):
                    kind = _lock_ctor_kind(sub.value)
                    if kind is None:
                        continue
                    for t in sub.targets:
                        if (
                            isinstance(t, ast.Attribute)
                            and isinstance(t.value, ast.Name)
                            and t.value.id == "self"
                        ):
                            declare(node.name, t.attr, kind, sub.lineno)
                        elif isinstance(t, ast.Name):
                            declare(node.name, t.id, kind, sub.lineno)
    for node in fi.tree.body if isinstance(fi.tree, ast.Module) else []:
        if isinstance(node, ast.Assign):
            kind = _lock_ctor_kind(node.value)
            if kind is None:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    declare(None, t.id, kind, node.lineno)


def _strip_rw(expr: ast.AST) -> ast.AST:
    """``x.read()`` / ``x.write()`` (RWLock context managers) → ``x``."""
    if (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Attribute)
        and expr.func.attr in ("read", "write")
        and not expr.args
    ):
        return expr.func.value
    return expr


class _FuncAcq:
    """Per-function facts: directly-acquired locks, locks acquired while
    holding each lock, and calls made while holding each lock."""

    def __init__(self, qual: str):
        self.qual = qual                       # module.Class.meth / module.fn
        self.acquires: Set[str] = set()        # any acquisition in body
        self.nested: List[Tuple[str, str, str]] = []   # (held, inner, site)
        self.calls_under: List[Tuple[str, str, str]] = []  # (held, callee, site)


def _collect_edges(fi, g, by_attr, exact) -> None:
    funcs: Dict[str, _FuncAcq] = {}

    def resolve(expr: ast.AST, cls: Optional[str], aliases) -> Optional[str]:
        expr = _strip_rw(expr)
        if isinstance(expr, ast.Attribute):
            base = expr.value
            attr = expr.attr
            if isinstance(base, ast.Name) and base.id == "self" and cls:
                hit = exact.get((fi.module, cls, attr))
                if hit:
                    return hit
            cands = by_attr.get(attr, set())
            if len(cands) == 1:
                return next(iter(cands))
            return None
        if isinstance(expr, ast.Name):
            if expr.id in aliases:
                return aliases[expr.id]
            hit = exact.get((fi.module, None, expr.id))
            if hit:
                return hit
            cands = by_attr.get(expr.id, set())
            if len(cands) == 1:
                return next(iter(cands))
        return None

    def lock_alias_value(v: ast.AST, cls: Optional[str]) -> Optional[str]:
        """An expression that *produces* a lock: dict-held per-key locks
        (``d.setdefault(k, threading.Lock())``) become the synthetic
        class ``module.Class.dictattr[]``."""
        if isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute):
            if v.func.attr in ("setdefault", "get") and len(v.args) >= 2:
                kind = _lock_ctor_kind(v.args[1])
                if kind is not None:
                    d = v.func.value
                    if (
                        isinstance(d, ast.Attribute)
                        and isinstance(d.value, ast.Name)
                        and d.value.id == "self"
                    ):
                        name = f"{fi.module}.{cls}.{d.attr}[]"
                        if name not in g.classes:
                            g.classes[name] = LockClass(
                                name, kind, f"{fi.path}:{v.lineno}"
                            )
                        by_attr.setdefault(d.attr, set()).add(name)
                        return name
        if _lock_ctor_kind(v) is not None:
            name = f"{fi.module}.<local>:{v.lineno}"
            g.classes.setdefault(
                name, LockClass(name, _lock_ctor_kind(v), f"{fi.path}:{v.lineno}")
            )
            return name
        return None

    def walk_fn(fn: ast.AST, qual: str, cls: Optional[str]) -> None:
        fa = funcs.setdefault(qual, _FuncAcq(qual))
        aliases: Dict[str, str] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Name
            ):
                got = lock_alias_value(node.value, cls)
                if got:
                    aliases[node.targets[0].id] = got

        def visit(stmts, held: List[str]) -> None:
            for st in stmts:
                if isinstance(st, ast.With):
                    acquired: List[str] = []
                    for item in st.items:
                        lk = resolve(item.context_expr, cls, aliases)
                        if lk is not None:
                            fa.acquires.add(lk)
                            site = f"{fi.path}:{st.lineno}"
                            for h in held + acquired:
                                fa.nested.append((h, lk, site))
                            acquired.append(lk)
                    visit(st.body, held + acquired)
                    continue
                if held:
                    # walk WITHOUT descending into nested defs/lambdas:
                    # a closure defined under the lock runs later,
                    # possibly without it — attributing its calls here
                    # would fabricate phantom edges (same scope
                    # discipline as WallClockDuration._walk_scope)
                    stack = [st]
                    while stack:
                        sub = stack.pop()
                        if isinstance(
                            sub,
                            (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda),
                        ):
                            continue
                        if isinstance(sub, ast.Call):
                            callee = _callee_qual(sub, fi.module, cls)
                            if callee:
                                site = f"{fi.path}:{sub.lineno}"
                                for h in held:
                                    fa.calls_under.append((h, callee, site))
                        stack.extend(ast.iter_child_nodes(sub))
                # containers that carry nested statements
                for attr in ("body", "orelse", "finalbody"):
                    sub = getattr(st, attr, None)
                    if sub and not isinstance(st, ast.With):
                        visit(sub, held)
                for h in getattr(st, "handlers", []) or []:
                    visit(h.body, held)

        visit(fn.body, [])

    def _callee_qual(call: ast.Call, module: str, cls: Optional[str]):
        f = call.func
        if (
            isinstance(f, ast.Attribute)
            and isinstance(f.value, ast.Name)
            and f.value.id == "self"
            and cls
        ):
            return f"{module}.{cls}.{f.attr}"
        if isinstance(f, ast.Name):
            return f"{module}.{f.id}"
        return None

    for node in fi.tree.body if isinstance(fi.tree, ast.Module) else []:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            walk_fn(node, f"{fi.module}.{node.name}", None)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    walk_fn(
                        sub, f"{fi.module}.{node.name}.{sub.name}", node.name
                    )

    # direct nesting edges
    for fa in funcs.values():
        for held, inner, site in fa.nested:
            g.add_edge(held, inner, site)

    # call propagation: transitive acquires per function (fixpoint),
    # then held-lock -> callee's acquires
    callees: Dict[str, Set[str]] = defaultdict(set)
    for fa in funcs.values():
        for _h, callee, _s in fa.calls_under:
            callees[fa.qual].add(callee)
        # also propagate through calls made while NOT holding: they
        # matter only for computing transitive acquire sets
    trans: Dict[str, Set[str]] = {q: set(fa.acquires) for q, fa in funcs.items()}
    changed = True
    while changed:
        changed = False
        for q, cs in callees.items():
            for c in cs:
                extra = trans.get(c, set()) - trans[q]
                if extra:
                    trans[q] |= extra
                    changed = True
    for fa in funcs.values():
        for held, callee, site in fa.calls_under:
            for lk in trans.get(callee, ()):  # callee's (transitive) locks
                g.add_edge(held, lk, site, via=callee)


# -- thread-entry discovery -------------------------------------------------
#
# One entry model shared by the static passes: the lock-order graph and
# the thread-escape pass (analysis/escape.py) must agree about *which*
# functions run on their own thread, or the two reports contradict each
# other.  An entry is any function handed to the threading runtime:
#
#   threading.Thread(target=self.x) / Thread(target=fn)   kind="thread"
#   <tracked executor>.submit(fn, ...)                    kind="executor"
#   threading.Timer(t, fn)                                kind="timer"
#   do_GET/do_POST on a *RequestHandler class             kind="conn-handler"
#   public methods on a *Servicer class                   kind="handler"
#   # graftlint: thread-entry   (on/above the def line)   kind="pragma"
#
# ``multi`` means the entry can be live on MORE than one thread at once:
# spawned inside a loop/comprehension, submitted to a pool, or invoked
# per-connection by a server.  Escape analysis counts a multi entry as
# two contexts on its own.
#
# Executor receivers are *tracked*: only ``.submit`` on a local or
# self-attribute that was assigned a ``*PoolExecutor(...)`` counts —
# ``self.hop_merger.submit(...)`` (a plain object with a submit method)
# is not a thread entry and must not be classified as one.

_ENTRY_PRAGMA_RE = re.compile(r"#\s*graftlint:\s*thread-entry\b")
_EXECUTOR_CTOR_RE = re.compile(r"(^|\.)(Thread|Process)PoolExecutor$")


@dataclass(frozen=True)
class ThreadEntry:
    qual: str    # module.Class.meth or module.fn
    site: str    # path:line of the spawn/registration/def site
    kind: str    # thread | executor | timer | handler | pragma
    multi: bool  # can run on >1 thread concurrently


def _is_executor_ctor(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and bool(
        _EXECUTOR_CTOR_RE.search(_dotted(node.func))
    )


def _callable_quals(
    expr: ast.AST, module: str, cls: Optional[str]
) -> List[str]:
    """Resolve a callable expression to qualified name(s).

    ``self.x`` → ``module.Class.x``; a bare name → ``module.name``;
    a lambda resolves to every ``self.meth(...)`` call in its body
    (``target=lambda: self._loop(arg)``).  Unresolvable receivers
    (``srv.serve_forever``) yield nothing — dropped, not guessed.
    """
    if isinstance(expr, ast.Lambda):
        out: List[str] = []
        for sub in ast.walk(expr.body):
            if isinstance(sub, ast.Call):
                q = _call_target_qual(sub.func, module, cls)
                if q:
                    out.append(q)
        return out
    q = _call_target_qual(expr, module, cls)
    return [q] if q else []


def _call_target_qual(
    f: ast.AST, module: str, cls: Optional[str]
) -> Optional[str]:
    if (
        isinstance(f, ast.Attribute)
        and isinstance(f.value, ast.Name)
        and f.value.id == "self"
        and cls
    ):
        return f"{module}.{cls}.{f.attr}"
    if isinstance(f, ast.Name):
        return f"{module}.{f.id}"
    return None


def discover_thread_entries(
    tree: ast.AST,
    module: str,
    path: str,
    source_lines: Optional[Sequence[str]] = None,
) -> List[ThreadEntry]:
    """All thread entry points declared in one parsed module."""
    entries: List[ThreadEntry] = []
    lines = source_lines or []

    def has_entry_pragma(lineno: int) -> bool:
        for ln in (lineno, lineno - 1):
            if 1 <= ln <= len(lines) and _ENTRY_PRAGMA_RE.search(lines[ln - 1]):
                return True
        return False

    def scan_callable(fn: ast.AST, cls: Optional[str], exec_attrs: Set[str]):
        """Find spawn sites anywhere in ``fn`` (closures included — a
        Thread started from a nested def still starts)."""
        # locals assigned an executor ctor, incl. `with ...Executor() as ex:`
        exec_locals: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and _is_executor_ctor(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        exec_locals.add(t.id)
            elif isinstance(node, ast.With):
                for item in node.items:
                    if _is_executor_ctor(item.context_expr) and isinstance(
                        item.optional_vars, ast.Name
                    ):
                        exec_locals.add(item.optional_vars.id)

        loopy: Set[int] = set()  # id() of Call nodes under a lexical loop

        def mark_loops(node: ast.AST, in_loop: bool) -> None:
            if isinstance(node, ast.Call) and in_loop:
                loopy.add(id(node))
            nxt = in_loop or isinstance(
                node,
                (ast.For, ast.AsyncFor, ast.While,
                 ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp),
            )
            for ch in ast.iter_child_nodes(node):
                mark_loops(ch, nxt)

        mark_loops(fn, False)

        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            dq = _dotted(node.func)
            site = f"{path}:{node.lineno}"
            if dq in ("threading.Thread", "Thread"):
                for kw in node.keywords:
                    if kw.arg == "target":
                        for q in _callable_quals(kw.value, module, cls):
                            entries.append(ThreadEntry(
                                q, site, "thread", id(node) in loopy
                            ))
            elif dq in ("threading.Timer", "Timer") and len(node.args) >= 2:
                for q in _callable_quals(node.args[1], module, cls):
                    entries.append(ThreadEntry(q, site, "timer", False))
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "submit"
                and node.args
            ):
                recv = node.func.value
                tracked = (
                    isinstance(recv, ast.Name) and recv.id in exec_locals
                ) or (
                    isinstance(recv, ast.Attribute)
                    and isinstance(recv.value, ast.Name)
                    and recv.value.id == "self"
                    and recv.attr in exec_attrs
                )
                if tracked:
                    for q in _callable_quals(node.args[0], module, cls):
                        entries.append(ThreadEntry(q, site, "executor", True))

    def class_executor_attrs(cd: ast.ClassDef) -> Set[str]:
        out: Set[str] = set()
        for node in ast.walk(cd):
            if isinstance(node, ast.Assign) and _is_executor_ctor(node.value):
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        out.add(t.attr)
        return out

    body = tree.body if isinstance(tree, ast.Module) else []
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scan_callable(node, None, set())
            if has_entry_pragma(node.lineno):
                entries.append(ThreadEntry(
                    f"{module}.{node.name}", f"{path}:{node.lineno}",
                    "pragma", True,
                ))
        elif isinstance(node, ast.ClassDef):
            exec_attrs = class_executor_attrs(node)
            base_names = [_dotted(b) for b in node.bases]
            is_http_handler = any("RequestHandler" in b for b in base_names)
            is_servicer = node.name.endswith("Servicer") or any(
                b.endswith("Servicer") for b in base_names
            )
            for sub in node.body:
                if not isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                qual = f"{module}.{node.name}.{sub.name}"
                scan_callable(sub, node.name, exec_attrs)
                if has_entry_pragma(sub.lineno):
                    entries.append(ThreadEntry(
                        qual, f"{path}:{sub.lineno}", "pragma", True
                    ))
                elif is_http_handler and re.fullmatch(r"do_[A-Z]+", sub.name):
                    # one handler INSTANCE per connection: the methods
                    # run on many threads, but each instance is
                    # single-threaded — escape analysis must not treat
                    # instance attrs of a conn-handler as shared
                    entries.append(ThreadEntry(
                        qual, f"{path}:{sub.lineno}", "conn-handler", True
                    ))
                elif is_servicer and not sub.name.startswith("_"):
                    entries.append(ThreadEntry(
                        qual, f"{path}:{sub.lineno}", "handler", True
                    ))
    return entries


# -- entry ------------------------------------------------------------------

def check_lock_order(
    roots: Iterable[str],
    repo_root: Optional[str] = None,
    exclude: Sequence[str] = (),
) -> Tuple[LockGraph, List[str]]:
    """Returns (graph, problem strings) — problems are cycles and
    self-nesting on non-reentrant locks."""
    g = build_lock_graph(roots, repo_root=repo_root, exclude=exclude)
    problems: List[str] = []
    for cyc in g.cycles():
        chain = " -> ".join(e.src for e in cyc) + f" -> {cyc[-1].dst}"
        sites = ", ".join(e.site for e in cyc)
        problems.append(f"lock-order cycle: {chain}  [{sites}]")
    for e in g.self_nesting:
        problems.append(
            f"self-nesting on non-reentrant lock {e.src} at {e.site} "
            "(would self-deadlock)"
        )
    return g, problems
