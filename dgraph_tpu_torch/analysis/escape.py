"""Static thread-escape analysis — graftcheck tier 3's static half.

The lock-order pass proves the locks we take can't deadlock; this pass
asks the prior question: which state needed a lock in the first place?
Following the Eraser discipline (Savage et al.), a field is a race
candidate when it can be *written* from two or more thread contexts and
any write site is outside a ``with <lock>`` scope.

Model (deliberately per-class and conservative, like lockorder):

- **Thread contexts** come from the shared entry model in
  :func:`lockorder.discover_thread_entries` — ``Thread(target=...)``
  (bound-method and bare spellings), tracked ``Executor.submit``,
  ``threading.Timer``, servicer/handler methods, and
  ``# graftlint: thread-entry`` pragmas.  An entry spawned in a
  loop/comprehension or submitted to a pool is *multi*: it counts as
  two contexts on its own.  Everything reachable from an entry via
  intra-class ``self.meth()`` calls (fixpoint) runs in that context;
  public methods additionally run in the "external callers" context.
- **Writes** are ``self.attr = / += ...`` and ``self.attr[k] = ...``
  targets (depth one — ``self.a.b = ...`` mutates another object and
  is out of per-class scope), plus module globals (``global`` rebinds
  and item-stores on module-level names).  ``__init__`` writes are
  exempt: they happen-before any thread this object starts.
- **Locked** means lexically inside ``with <lock-like>`` (reusing
  lockorder's lock-class spellings: declared lock attrs anywhere in the
  package, ``*lock*/*mu*/*cond*``-named receivers, RWLock
  ``.read()/.write()``, per-key ``setdefault(k, Lock())`` aliases), or
  inside a private method whose every intra-class call site is locked
  (the "caller holds the lock" discipline, computed as a fixpoint).
  Closures defined under a lock run later, possibly without it — their
  writes do NOT inherit the lock scope.
- **Exempt**: fields holding locks/executors themselves,
  ``threading.local()`` and ``ContextVar`` fields (per-thread by
  construction), per-connection ``*RequestHandler`` instances (one
  instance per thread; their *global* writes still count).

What this pass cannot see — cross-object writes (``st.failures += 1``
on a struct owned by another class), reader-side races, dynamic
hand-offs — is exactly what the runtime lockset witness
(:mod:`.witness`) covers under tier-1.  The two are a pair.

Sanctioning a deliberate case:

- ``# graftlint: shared[attr] <why>`` on any write site (or the line
  above) accepts the field class-wide; the WHY text is mandatory.
- the manifest ``analysis/shared.json`` (multiset fingerprint baseline,
  shipped empty) accepts findings wholesale — for adopting the pass on
  a tree with standing debt, not for silencing new ones.
"""

from __future__ import annotations

import ast
import re
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from dgraph_tpu_torch.analysis.framework import FileContext, Finding, iter_py_files
from dgraph_tpu_torch.analysis.lockorder import (
    _dotted,
    _is_executor_ctor,
    _lock_ctor_kind,
    _module_name,
    _strip_rw,
    discover_thread_entries,
)

RULE_ESCAPE = "thread-escape"
RULE_GLOBAL = "global-escape"
RULE_WHY = "shared-needs-why"

_SHARED_RE = re.compile(r"#\s*graftlint:\s*shared\[([A-Za-z0-9_, ]+)\]\s*(.*)")
# receiver names that read as locks even without a visible declaration
# (cross-module attrs like `srv._engine_lock`, local `lock_cm` aliases)
_LOCKY_NAME_RE = re.compile(
    r"(^|_)(lock|rlock|mu|mutex|cond|condition|sem|semaphore|cv)s?(_|$)"
)
_PER_THREAD_CTORS = {
    "threading.local", "local", "contextvars.ContextVar", "ContextVar",
}

_EXT = "ext"     # context token: unknown external caller (counts once)
_INIT = "init"   # context token: __init__ — happens-before thread start


@dataclass
class _Write:
    name: str      # field or global name
    lineno: int
    locked: bool   # lexically under a lock-like `with`
    func: str      # enclosing method/function name


class _FileInfo:
    def __init__(self, path: str, tree: ast.AST, module: str, source: str):
        self.path = path
        self.tree = tree
        self.module = module
        self.source = source
        self.lines = source.splitlines()


# -- package-wide prep ------------------------------------------------------

def _parse_files(
    roots: Iterable[str],
    repo_root: Optional[str],
    exclude: Sequence[str],
) -> List[_FileInfo]:
    base = Path(repo_root) if repo_root else Path(".")
    out: List[_FileInfo] = []
    for f in iter_py_files(roots, exclude=exclude):
        src = f.read_text(encoding="utf-8")
        try:
            tree = ast.parse(src)
        except SyntaxError:
            continue
        rel = f.as_posix()
        try:
            rel = f.resolve().relative_to(base.resolve()).as_posix()
        except ValueError:
            pass
        out.append(_FileInfo(rel, tree, _module_name(f, base), src))
    return out


def _collect_lock_names(files: Sequence[_FileInfo]) -> Set[str]:
    """Every attr/global name assigned a lock ctor anywhere in the
    package — `with self.<name>:` / `with obj.<name>:` then counts as a
    lock scope even when the name itself isn't lock-ish."""
    names: Set[str] = set()
    for fi in files:
        for node in ast.walk(fi.tree):
            if isinstance(node, ast.Assign) and _lock_ctor_kind(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Attribute):
                        names.add(t.attr)
                    elif isinstance(t, ast.Name):
                        names.add(t.id)
    return names


def _name_locky(name: str, lock_names: Set[str]) -> bool:
    return name in lock_names or bool(_LOCKY_NAME_RE.search(name))


def _produces_lock(v: ast.AST, lock_names: Set[str]) -> bool:
    """Does this rvalue evaluate to a lock (for local alias tracking)?"""
    v = _strip_rw(v)
    if _lock_ctor_kind(v) is not None:
        return True
    if isinstance(v, ast.IfExp):
        return _produces_lock(v.body, lock_names) or _produces_lock(
            v.orelse, lock_names
        )
    if isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute):
        if v.func.attr in ("setdefault", "get") and len(v.args) >= 2:
            if _lock_ctor_kind(v.args[1]) is not None:
                return True
    if isinstance(v, ast.Attribute):
        return _name_locky(v.attr, lock_names)
    if isinstance(v, ast.Name):
        return _name_locky(v.id, lock_names)
    return False


def _is_lock_like(
    expr: ast.AST, aliases: Set[str], lock_names: Set[str]
) -> bool:
    expr = _strip_rw(expr)
    if isinstance(expr, ast.Name):
        return expr.id in aliases or _name_locky(expr.id, lock_names)
    if isinstance(expr, ast.Attribute):
        return _name_locky(expr.attr, lock_names)
    if isinstance(expr, ast.IfExp):
        # `nullcontext() if local else lock.read()`: optimistic — treat
        # the scope as locked rather than spray findings on every
        # conditional-lock site; the runtime witness sees the truth
        return _is_lock_like(expr.body, aliases, lock_names) or _is_lock_like(
            expr.orelse, aliases, lock_names
        )
    if isinstance(expr, ast.Call):
        if _lock_ctor_kind(expr) is not None:
            return True
        if isinstance(expr.func, ast.Attribute):
            if expr.func.attr in ("setdefault", "get") and len(expr.args) >= 2:
                return _lock_ctor_kind(expr.args[1]) is not None
    return False


# -- per-function scan ------------------------------------------------------

class _FnScan:
    def __init__(self):
        self.writes: List[_Write] = []     # instance-attr writes
        self.gwrites: List[_Write] = []    # module-global writes
        self.sites: List[Tuple[str, bool]] = []  # (self-callee, locked)


def _scan_function(
    fn: ast.AST,
    name: str,
    methods: Set[str],
    lock_names: Set[str],
    module_globals: Set[str],
) -> _FnScan:
    out = _FnScan()
    declared_global: Set[str] = set()
    local_names: Set[str] = set()
    aliases: Set[str] = set()

    for node in ast.walk(fn):
        if isinstance(node, ast.Global):
            declared_global.update(node.names)
        elif isinstance(node, ast.Assign):
            if _produces_lock(node.value, lock_names):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        aliases.add(t.id)
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        for a in (
            fn.args.args + fn.args.posonlyargs + fn.args.kwonlyargs
        ):
            local_names.add(a.arg)

    def scan_stmt_exprs(st: ast.AST, held: int) -> None:
        """Writes and self-call sites in ONE statement's expressions —
        nested statement bodies are visited separately, and closures are
        skipped (they run later, maybe without the lock)."""
        stack: List[ast.AST] = []
        for fname, val in ast.iter_fields(st):
            if fname in ("body", "orelse", "finalbody", "handlers"):
                continue
            if isinstance(val, ast.AST):
                stack.append(val)
            elif isinstance(val, list):
                stack.extend(x for x in val if isinstance(x, ast.AST))
        while stack:
            node = stack.pop()
            if isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                continue
            if isinstance(node, ast.Attribute) and isinstance(
                node.ctx, ast.Store
            ):
                if isinstance(node.value, ast.Name) and node.value.id == "self":
                    out.writes.append(
                        _Write(node.attr, node.lineno, held > 0, name)
                    )
            elif isinstance(node, ast.Subscript) and isinstance(
                node.ctx, ast.Store
            ):
                base = node.value
                if (
                    isinstance(base, ast.Attribute)
                    and isinstance(base.value, ast.Name)
                    and base.value.id == "self"
                ):
                    out.writes.append(
                        _Write(base.attr, node.lineno, held > 0, name)
                    )
                elif (
                    isinstance(base, ast.Name)
                    and base.id in module_globals
                    and base.id not in local_names
                ):
                    out.gwrites.append(
                        _Write(base.id, node.lineno, held > 0, name)
                    )
            elif isinstance(node, ast.Name) and isinstance(
                node.ctx, ast.Store
            ):
                if node.id in declared_global:
                    out.gwrites.append(
                        _Write(node.id, node.lineno, held > 0, name)
                    )
                else:
                    local_names.add(node.id)
            elif isinstance(node, ast.Call):
                f = node.func
                if (
                    isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "self"
                    and f.attr in methods
                ):
                    out.sites.append((f.attr, held > 0))
            stack.extend(ast.iter_child_nodes(node))

    def visit(stmts: Sequence[ast.stmt], held: int) -> None:
        for st in stmts:
            if isinstance(st, (ast.With, ast.AsyncWith)):
                locked_here = any(
                    _is_lock_like(i.context_expr, aliases, lock_names)
                    for i in st.items
                )
                scan_stmt_exprs(st, held)
                visit(st.body, held + (1 if locked_here else 0))
                continue
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit(st.body, 0)  # closure: lock scope does not carry
                continue
            scan_stmt_exprs(st, held)
            for attr in ("body", "orelse", "finalbody"):
                sub = getattr(st, attr, None)
                if sub:
                    visit(sub, held)
            for h in getattr(st, "handlers", []) or []:
                visit(h.body, held)

    visit(fn.body, 0)
    return out


# -- context propagation ----------------------------------------------------

def _method_contexts(
    methods: Dict[str, ast.AST],
    roots: Dict[str, bool],          # meth -> multi
    scans: Dict[str, _FnScan],
) -> Dict[str, Set]:
    """Token sets per method: ("r", meth, multi) | "ext" | "init",
    propagated along intra-class call edges to a fixpoint."""
    ctxs: Dict[str, Set] = {m: set() for m in methods}
    for m in methods:
        if m in roots:
            ctxs[m].add(("r", m, roots[m]))
        if m == "__init__":
            ctxs[m].add(_INIT)
        elif not m.startswith("_") or (m.startswith("__") and m.endswith("__")):
            ctxs[m].add(_EXT)
    changed = True
    while changed:
        changed = False
        for caller, scan in scans.items():
            for callee, _locked in scan.sites:
                extra = ctxs[caller] - ctxs.get(callee, set())
                if callee in ctxs and extra:
                    ctxs[callee] |= extra
                    changed = True
    for m in methods:  # private, never called: caller unknown — assume shared
        if not ctxs[m]:
            ctxs[m].add(_EXT)
    return ctxs


def _always_locked(
    methods: Dict[str, ast.AST],
    roots: Dict[str, bool],
    scans: Dict[str, _FnScan],
) -> Set[str]:
    """Private methods whose EVERY intra-class call site is under a lock
    (directly, or inside another always-locked method) — the "caller
    holds self._lock" discipline."""
    sites_by_callee: Dict[str, List[Tuple[str, bool]]] = defaultdict(list)
    for caller, scan in scans.items():
        for callee, locked in scan.sites:
            sites_by_callee[callee].append((caller, locked))
    al = {
        m for m in methods
        if m.startswith("_") and not m.endswith("__")
        and m not in roots and sites_by_callee[m]
    }
    changed = True
    while changed:
        changed = False
        for m in list(al):
            for caller, locked in sites_by_callee[m]:
                if not locked and caller not in al:
                    al.discard(m)
                    changed = True
                    break
    return al


def _weight(tokens: Set) -> int:
    w = 0
    for t in tokens:
        if t == _EXT:
            w += 1
        elif isinstance(t, tuple) and t[0] == "r":
            w += 2 if t[2] else 1
    return w


def _describe(tokens: Set) -> str:
    parts = []
    for t in sorted(tokens, key=str):
        if t == _EXT:
            parts.append("external callers")
        elif isinstance(t, tuple) and t[0] == "r":
            parts.append(f"thread:{t[1]}" + (" (multi)" if t[2] else ""))
    return ", ".join(parts)


# -- pragma handling --------------------------------------------------------

def _shared_pragmas(
    ctx: FileContext, linenos: Iterable[int]
) -> Tuple[Set[str], List[int]]:
    """(sanctioned names, pragma lines missing a WHY) across the given
    write sites (each checked on its line and the line above)."""
    sanctioned: Set[str] = set()
    missing_why: List[int] = []
    seen: Set[int] = set()
    for wl in linenos:
        for ln in (wl, wl - 1):
            if ln in seen:
                continue
            seen.add(ln)
            m = _SHARED_RE.search(ctx.line(ln))
            if not m:
                continue
            names = {s.strip() for s in m.group(1).split(",")}
            # a WHY-less pragma still sanctions: the one actionable
            # finding is "write the why", not a duplicate escape report
            if not m.group(2).strip():
                missing_why.append(ln)
            sanctioned |= names
    return sanctioned, missing_why


# -- per-file analysis ------------------------------------------------------

def _check_file(fi: _FileInfo, lock_names: Set[str]) -> List[Finding]:
    ctx = FileContext(
        path=fi.path, source=fi.source, tree=fi.tree, lines=fi.lines
    )
    entries = discover_thread_entries(fi.tree, fi.module, fi.path, fi.lines)
    # qual -> (multi, set of kinds); multi if ANY spawn site is multi
    entry_map: Dict[str, Tuple[bool, Set[str]]] = {}
    for e in entries:
        multi, kinds = entry_map.get(e.qual, (False, set()))
        entry_map[e.qual] = (multi or e.multi, kinds | {e.kind})

    body = fi.tree.body if isinstance(fi.tree, ast.Module) else []

    # module-level state: assignable names and exempt (lock/per-thread)
    module_globals: Set[str] = set()
    g_exempt: Set[str] = set()
    for node in body:
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)):
            targets = [node.target]
        for t in targets:
            if isinstance(t, ast.Name):
                module_globals.add(t.id)
                val = getattr(node, "value", None)
                if val is not None and (
                    _lock_ctor_kind(val) is not None
                    or _dotted(getattr(val, "func", val)) in _PER_THREAD_CTORS
                ):
                    g_exempt.add(t.id)

    findings: List[Finding] = []
    # global writes accumulate across every function/method in the file:
    # (write, context tokens of its enclosing function)
    g_accum: List[Tuple[_Write, Set]] = []

    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qual = f"{fi.module}.{node.name}"
            scan = _scan_function(
                node, node.name, set(), lock_names, module_globals
            )
            toks: Set = {_EXT}  # any module function is externally callable
            ent = entry_map.get(qual)
            if ent:
                toks.add(("r", node.name, ent[0]))
            for w in scan.gwrites:
                g_accum.append((w, toks))
        elif isinstance(node, ast.ClassDef):
            findings.extend(
                _check_class(fi, ctx, node, entry_map, lock_names,
                             module_globals, g_accum)
            )

    # module-global verdicts
    by_global: Dict[str, List[Tuple[_Write, Set]]] = defaultdict(list)
    for w, toks in g_accum:
        if w.name not in g_exempt and not _name_locky(w.name, lock_names):
            by_global[w.name].append((w, toks))
    for gname, ws in sorted(by_global.items()):
        sanctioned, missing = _shared_pragmas(ctx, (w.lineno for w, _ in ws))
        for ln in missing:
            findings.append(_pragma_why_finding(ctx, ln))
        if gname in sanctioned or "all" in sanctioned:
            continue
        tokens: Set = set()
        for w, toks in ws:
            for t in toks:
                tokens.add(_qualify(t, None))
        unlocked = [w for w, _ in ws if not w.locked]
        if _weight(tokens) >= 2 and unlocked:
            first = min(unlocked, key=lambda w: w.lineno)
            f = Finding(
                rule=RULE_GLOBAL, path=fi.path, line=first.lineno,
                message=(
                    f"module global `{gname}` is written from "
                    f"{_weight(tokens)} thread context(s) "
                    f"[{_describe(tokens)}] and this write is outside any "
                    f"lock scope; guard it, or sanction with "
                    f"`# graftlint: shared[{gname}] <why>`"
                ),
                snippet=ctx.line(first.lineno),
            )
            if not ctx.suppressed(f):
                findings.append(f)
    return findings


def _qualify(token, cls: Optional[str]):
    """Make root tokens unique module-wide for global-write weighting."""
    if isinstance(token, tuple) and token[0] == "r" and cls:
        return ("r", f"{cls}.{token[1]}", token[2])
    return token


def _pragma_why_finding(ctx: FileContext, lineno: int) -> Finding:
    return Finding(
        rule=RULE_WHY, path=ctx.path, line=lineno,
        message=(
            "`# graftlint: shared[...]` pragma has no WHY — state the "
            "reason the unlocked sharing is safe after the closing bracket"
        ),
        snippet=ctx.line(lineno),
    )


def _check_class(
    fi: _FileInfo,
    ctx: FileContext,
    cd: ast.ClassDef,
    entry_map: Dict[str, Tuple[bool, Set[str]]],
    lock_names: Set[str],
    module_globals: Set[str],
    g_accum: List[Tuple[_Write, Set]],
) -> List[Finding]:
    methods: Dict[str, ast.AST] = {}
    for sub in cd.body:
        if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
            methods.setdefault(sub.name, sub)

    # fields that ARE synchronization or per-thread storage
    exempt: Set[str] = set()
    for node in ast.walk(cd):
        if isinstance(node, ast.Assign):
            val = node.value
            is_sync = (
                _lock_ctor_kind(val) is not None
                or _is_executor_ctor(val)
                or _dotted(getattr(val, "func", val)) in _PER_THREAD_CTORS
            )
            if is_sync:
                for t in node.targets:
                    if (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        exempt.add(t.attr)

    roots: Dict[str, bool] = {}       # instance-context roots
    conn_handler = False
    for m in methods:
        ent = entry_map.get(f"{fi.module}.{cd.name}.{m}")
        if not ent:
            continue
        multi, kinds = ent
        if kinds == {"conn-handler"}:
            conn_handler = True
            # per-connection instance: still a root for GLOBAL writes
            roots[m] = multi
        else:
            roots[m] = multi

    scans = {
        m: _scan_function(fn, m, set(methods), lock_names, module_globals)
        for m, fn in methods.items()
    }
    ctxs = _method_contexts(methods, roots, scans)
    al = _always_locked(methods, roots, scans)

    # contribute global writes with class-qualified tokens
    for m, scan in scans.items():
        toks = {_qualify(t, cd.name) for t in ctxs[m]}
        for w in scan.gwrites:
            g_accum.append((w, toks))

    if conn_handler:
        return []  # instance state is per-connection → per-thread

    by_field: Dict[str, List[_Write]] = defaultdict(list)
    for m, scan in scans.items():
        for w in scan.writes:
            by_field[w.name].append(w)

    findings: List[Finding] = []
    for field, ws in sorted(by_field.items()):
        if field in exempt or _name_locky(field, lock_names):
            continue
        sanctioned, missing = _shared_pragmas(ctx, (w.lineno for w in ws))
        for ln in missing:
            findings.append(_pragma_why_finding(ctx, ln))
        if field in sanctioned or "all" in sanctioned:
            continue
        tokens: Set = set()
        eff: List[_Write] = []
        for w in ws:
            t = ctxs[w.func] - {_INIT}
            if not t:
                continue  # init-only write: happens-before thread start
            tokens |= t
            eff.append(w)
        unlocked = [w for w in eff if not (w.locked or w.func in al)]
        if _weight(tokens) >= 2 and unlocked:
            first = min(unlocked, key=lambda w: w.lineno)
            f = Finding(
                rule=RULE_ESCAPE, path=fi.path, line=first.lineno,
                message=(
                    f"`self.{field}` of {cd.name} is written from "
                    f"{_weight(tokens)} thread context(s) "
                    f"[{_describe(tokens)}] and the write in "
                    f"{first.func}() is outside any lock scope; guard it, "
                    f"or sanction with `# graftlint: shared[{field}] <why>`"
                ),
                snippet=ctx.line(first.lineno),
            )
            if not ctx.suppressed(f):
                findings.append(f)
    return findings


# -- entry ------------------------------------------------------------------

def check_escapes(
    roots: Iterable[str],
    repo_root: Optional[str] = None,
    exclude: Sequence[str] = (),
) -> List[Finding]:
    """All escape findings over the given roots (pragma suppression
    applied; manifest subtraction is the caller's policy)."""
    files = _parse_files(roots, repo_root, exclude)
    lock_names = _collect_lock_names(files)
    out: List[Finding] = []
    for fi in files:
        out.extend(_check_file(fi, lock_names))
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def check_escape_source(
    source: str, path: str = "<snippet>", module: str = "snippet"
) -> List[Finding]:
    """Run the escape pass over an in-memory snippet (test fixtures)."""
    fi = _FileInfo(path, ast.parse(source), module, source)
    lock_names = _collect_lock_names([fi])
    return _check_file(fi, lock_names)
