"""The graftlint rule set for the port (``dgraph_tpu/analysis/rules.py``
scoped to ``dgraph_tpu_torch/``): this repo's idioms, not generic style.

Kept from the reference unchanged: ``wallclock-duration``,
``swallowed-exception``, ``naked-peer-rpc``, ``naked-atomic-write``,
``naked-stage-timing``, ``naked-route-threshold``, ``naked-version-key``,
``unchecked-hop-loop`` and ``unregistered-metric`` (which reads the
port's own catalog, ``dgraph_tpu_torch/METRICS.md``, beside
``docs/deploy.md``'s).  ``naked-collective`` keeps its rule and names
the port's homes (``dgraph_tpu_torch/mesh/``, ``dgraph_tpu_torch/
parallel/``).  Rewritten for torch:

- ``naked-device-sync``: ``.item()`` / ``.tolist()`` on a tensor,
  ``.cpu()``, ``torch.cuda.synchronize()`` or an event's / stream's
  ``.synchronize()`` on the host path of ``query/``, ``ops/``,
  ``parallel/``, ``mesh/`` or ``sched/``.  A device sync in the serving
  tree goes through the device guard's watchdog bracket
  (``utils/devguard.py``: a function handed to ``<guard>.run(op, fn)``)
  or ``obs.block_ready_ms``; a deliberate one carries the pragma with
  the WHY.  Receivers of ``.item()`` / ``.tolist()`` count as tensors
  when they come from a ``torch.*`` call, ``.to(...)`` / ``.cuda()``, or
  a name bound to one in the same scope (numpy has both methods).
- ``naked-resident-transfer``: ``.to(...)``, ``.cuda()``, ``.cpu()``,
  ``torch.as_tensor`` / ``torch.tensor(..., device=...)`` or
  ``np.asarray`` / ``np.array`` of a resident arena's buffers outside
  ``models/arena.py``.

The reference's ``host-sync-in-jit``, ``recompile-hazard`` and
``unregistered-program-factory`` have no counterpart: the port has no
jitted bodies and no ``pallas_call``; its hand kernels are covered by
the contract registry (:mod:`.programs`, ``uncovered_sites``).

Suppress a deliberate site with ``# graftlint: ignore[rule-id]`` on the
line (or the line above), with the WHY.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Iterator, List, Optional, Set, Tuple

from dgraph_tpu_torch.analysis.framework import FileContext, Finding, Rule


# -- shared AST helpers -----------------------------------------------------

def _dotted(node: ast.AST) -> str:
    """'torch.cuda.synchronize' for nested Attribute/Name chains, ''
    otherwise."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


# -- rule: wallclock-duration -----------------------------------------------

def _is_walltime_call(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and _dotted(node.func) in ("time.time", "datetime.datetime.now")
        and not node.args
    )


class WallClockDuration(Rule):
    id = "wallclock-duration"
    doc = (
        "interval math on time.time() — deadlines, tick loops and age "
        "computations must use time.monotonic()"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        # scopes: module + each function gets its own timeish-name set
        scopes: List[ast.AST] = [ctx.tree]
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes.append(node)
        seen: Set[int] = set()
        for scope in scopes:
            timeish = self._timeish_names(scope)
            for node in self._walk_scope(scope):
                if id(node) in seen:
                    continue
                hit = None
                if isinstance(node, ast.BinOp) and isinstance(
                    node.op, (ast.Add, ast.Sub)
                ):
                    if (
                        _is_walltime_call(node.left)
                        or _is_walltime_call(node.right)
                        or self._timeish(node.left, timeish)
                        or self._timeish(node.right, timeish)
                    ):
                        hit = (
                            "duration/deadline arithmetic on time.time() "
                            "drifts under NTP slew and can go backwards "
                            "on clock steps; use time.monotonic() for "
                            "intervals (wall clock is for user-visible "
                            "timestamps only)"
                        )
                elif isinstance(node, ast.Compare):
                    sides = [node.left] + list(node.comparators)
                    if any(_is_walltime_call(s) for s in sides):
                        hit = (
                            "comparing time.time() against a deadline is "
                            "interval logic; use time.monotonic()"
                        )
                if hit is not None:
                    seen.add(id(node))
                    yield ctx.finding(self.id, node, hit)

    @classmethod
    def _timeish_names(cls, scope: ast.AST) -> Set[str]:
        # same scope boundary as the expression pass (_walk_scope):
        # nested defs keep their own timeish sets — a closure's
        # `ts = time.time()` must not taint the enclosing scope's `ts`
        names: Set[str] = set()
        for node in cls._walk_scope(scope):
            if isinstance(node, ast.Assign) and _is_walltime_call(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
                    elif isinstance(t, ast.Tuple):
                        names.update(
                            e.id for e in t.elts if isinstance(e, ast.Name)
                        )
            elif isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Tuple
            ):
                # total, t0 = 0, time.time()
                for t in node.targets:
                    if isinstance(t, ast.Tuple) and len(t.elts) == len(
                        node.value.elts
                    ):
                        for tgt, val in zip(t.elts, node.value.elts):
                            if isinstance(tgt, ast.Name) and _is_walltime_call(
                                val
                            ):
                                names.add(tgt.id)
        return names

    @staticmethod
    def _timeish(node: ast.AST, timeish: Set[str]) -> bool:
        return isinstance(node, ast.Name) and node.id in timeish

    @staticmethod
    def _walk_scope(scope: ast.AST):
        """Walk a scope without descending into nested function defs
        (each gets its own pass with its own timeish set)."""
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            node = stack.pop()
            yield node
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            stack.extend(ast.iter_child_nodes(node))


# -- rule: swallowed-exception ----------------------------------------------

_BROAD = {"Exception", "BaseException"}


def _broad_handler(h: ast.ExceptHandler) -> bool:
    t = h.type
    if t is None:
        return True
    if isinstance(t, (ast.Name, ast.Attribute)):
        return _dotted(t).split(".")[-1] in _BROAD
    if isinstance(t, ast.Tuple):
        return any(
            isinstance(e, (ast.Name, ast.Attribute))
            and _dotted(e).split(".")[-1] in _BROAD
            for e in t.elts
        )
    return False


def _silent_body(body: Sequence[ast.stmt]) -> bool:
    for stmt in body:
        if isinstance(stmt, (ast.Pass, ast.Continue, ast.Break)):
            continue
        if isinstance(stmt, ast.Expr) and isinstance(
            stmt.value, ast.Constant
        ):
            continue  # docstring / ellipsis
        return False
    return True


class SwallowedException(Rule):
    id = "swallowed-exception"
    doc = (
        "broad `except Exception: pass` hides partial outages; narrow "
        "the type or count it (utils.metrics.note_swallowed)"
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if _broad_handler(node) and _silent_body(node.body):
                yield ctx.finding(
                    self.id, node,
                    "broad exception swallowed silently — a downed peer, "
                    "a bad record and a typo all vanish here; catch the "
                    "narrow type you mean, or at minimum count the drop "
                    "via utils.metrics.note_swallowed(site, exc)",
                )


# -- rule: naked-peer-rpc ---------------------------------------------------

_CHANNEL_RPC_ATTRS = {
    "unary_unary", "unary_stream", "stream_unary", "stream_stream",
}


class NakedPeerRpc(Rule):
    id = "naked-peer-rpc"
    doc = (
        "direct urlopen_peer / channel-RPC call outside cluster/"
        "peerclient.py — peer RPCs must route through PeerClient "
        "(retry budget, per-peer circuit breaker, health ordering)"
    )

    # ``urlopen_peer`` is flagged EVERYWHERE (it exists only for peer
    # calls); raw gRPC multicallables are flagged only under cluster/ —
    # serve/ChannelPool and client/ are the PUBLIC API surface, where a
    # naked channel RPC is the client's own business.
    def check(self, ctx: FileContext) -> Iterator[Finding]:
        path = ctx.path.replace("\\", "/")
        if path.endswith("cluster/peerclient.py"):
            return  # the one legitimate home of both call forms
        in_cluster = "cluster/" in path
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = _dotted(f).split(".")[-1]
            if name == "urlopen_peer":
                yield ctx.finding(
                    self.id, node,
                    "one-shot urlopen_peer call bypasses PeerClient: no "
                    "retry/backoff budget, no circuit breaker, and a "
                    "down peer costs a full connect timeout here — use "
                    "ClusterService.peerclient.urlopen(...)",
                )
            elif (
                in_cluster
                and isinstance(f, ast.Attribute)
                and f.attr in _CHANNEL_RPC_ATTRS
            ):
                yield ctx.finding(
                    self.id, node,
                    f"raw channel.{f.attr}() in the cluster peer plane "
                    "bypasses PeerClient — use peerclient.grpc_unary(...) "
                    "so retries/breakers cover this RPC too",
                )


# -- rule: naked-atomic-write -----------------------------------------------

_RENAME_FNS = {"replace", "rename", "renames"}


def _os_rename_aliases(tree: ast.AST) -> Set[str]:
    """Bare names that mean os.replace/os.rename in this file
    (``from os import replace [as rp]``)."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "os":
            for a in node.names:
                if a.name in _RENAME_FNS:
                    out.add(a.asname or a.name)
    return out


class NakedAtomicWrite(Rule):
    id = "naked-atomic-write"
    doc = (
        "direct os.replace / os.rename outside utils/atomicio.py — "
        "durable file replacement must go through atomic_write_file "
        "(tmp + fsync + replace + dir fsync) or a crash can observe "
        "half-state"
    )

    # every step of the dance matters: a replace without the tmp-fsync
    # can install a file whose BLOCKS are not on disk yet (content
    # garbage after a crash); without the directory fsync the rename
    # itself can roll back and resurrect the old name.  The helper does
    # both; a naked call almost certainly skips at least one.
    def check(self, ctx: FileContext) -> Iterator[Finding]:
        path = ctx.path.replace("\\", "/")
        if path.endswith("utils/atomicio.py"):
            return  # the one legitimate home of the raw call
        aliases = _os_rename_aliases(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            d = _dotted(f)
            named = d in ("os.replace", "os.rename", "os.renames") or (
                isinstance(f, ast.Name) and f.id in aliases
            )
            if not named:
                continue
            fn = d.split(".")[-1] if d else f.id  # type: ignore[union-attr]
            yield ctx.finding(
                self.id, node,
                f"naked os.{fn}() skips the fsync'd tmp+replace+dir-sync "
                "dance — a crash here can install unsynced content or "
                "resurrect the old name; use utils.atomicio."
                "atomic_write_file (or pragma a rename of an "
                "already-fully-synced file, with the WHY)",
            )


# -- rule: naked-stage-timing -----------------------------------------------

def _is_perf_counter_call(node: ast.AST) -> bool:
    return (
        isinstance(node, ast.Call)
        and _dotted(node.func).split(".")[-1]
        in ("perf_counter", "perf_counter_ns")
        and not node.args
    )


class NakedStageTiming(Rule):
    id = "naked-stage-timing"
    doc = (
        "direct time.perf_counter* stage bracketing in serve/, sched/, "
        "query/ or cache/ — route stage timing through the span API "
        "(dgraph_tpu_torch.obs: hop spans / obs.stage) so the number lands in "
        "traces, not a local variable"
    )

    # only the serving tree: these are the layers whose stage timings
    # the flight recorder exists to attribute.  obs/ and utils/trace.py
    # ARE the span API — the raw clock reads live there by design.
    _DIRS = ("serve/", "sched/", "query/", "cache/")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        path = ctx.path.replace("\\", "/")
        if "obs/" in path or path.endswith("utils/trace.py"):
            return
        if not any(d in path for d in self._DIRS):
            return
        # same scope discipline as wallclock-duration: names assigned
        # from perf_counter in a scope taint only that scope
        scopes: List[ast.AST] = [ctx.tree]
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes.append(node)
        seen: Set[int] = set()
        for scope in scopes:
            timers = self._timer_names(scope)
            for node in WallClockDuration._walk_scope(scope):
                if id(node) in seen:
                    continue
                if not (
                    isinstance(node, ast.BinOp)
                    and isinstance(node.op, (ast.Add, ast.Sub))
                ):
                    continue
                sides = (node.left, node.right)
                if any(_is_perf_counter_call(s) for s in sides) or any(
                    isinstance(s, ast.Name) and s.id in timers
                    for s in sides
                ):
                    seen.add(id(node))
                    yield ctx.finding(
                        self.id, node,
                        "perf_counter stage bracketing outside the span "
                        "API: this duration can never be attributed to a "
                        "trace — wrap the stage in obs.stage(stats, key) "
                        "or record it as a span attr (dgraph_tpu_torch/obs/), "
                        "or pragma the site with the WHY",
                    )

    @staticmethod
    def _timer_names(scope: ast.AST) -> Set[str]:
        names: Set[str] = set()
        for node in WallClockDuration._walk_scope(scope):
            if isinstance(node, ast.Assign) and _is_perf_counter_call(
                node.value
            ):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
            elif isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Tuple
            ):
                for t in node.targets:
                    if isinstance(t, ast.Tuple) and len(t.elts) == len(
                        node.value.elts
                    ):
                        for tgt, val in zip(t.elts, node.value.elts):
                            if isinstance(
                                tgt, ast.Name
                            ) and _is_perf_counter_call(val):
                                names.add(tgt.id)
        return names


# -- rule: naked-route-threshold --------------------------------------------

def _const_int(node: ast.AST) -> Optional[int]:
    """Fold an integer-literal expression: plain Constant, unary minus,
    and BinOps of constants (``1 << 21``, ``4 * 1024``) — the spellings
    magic thresholds actually use."""
    if isinstance(node, ast.Constant) and type(node.value) is int:
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _const_int(node.operand)
        return -v if v is not None else None
    if isinstance(node, ast.BinOp):
        l, r = _const_int(node.left), _const_int(node.right)
        if l is None or r is None:
            return None
        try:
            if isinstance(node.op, ast.LShift):
                return l << r
            if isinstance(node.op, ast.Mult):
                return l * r
            if isinstance(node.op, ast.Add):
                return l + r
            if isinstance(node.op, ast.Sub):
                return l - r
            if isinstance(node.op, ast.Pow):
                return l**r if 0 <= r <= 64 else None
        except (OverflowError, ValueError):
            return None
    return None


class NakedRouteThreshold(Rule):
    id = "naked-route-threshold"
    doc = (
        "raw numeric route-gate comparison or DGRAPH_TPU_* env read in "
        "query//ops/ — thresholds live in utils/planconfig.py (documented "
        "defaults, override detection) and decisions in query/planner.py "
        "(calibrated cost model)"
    )

    # query/ and ops/ are the layers where route gates live; the config
    # module itself sits in utils/ — outside the scanned dirs by design,
    # so it needs no exemption.  The literal floor (65536) is far above
    # any capacity/bucket constant but below every historical gate
    # (262144, 1<<21, 1<<22); disabling-style sentinels (1 << 60) are
    # exactly the pattern that belongs behind a planconfig name too.
    _DIRS = ("query/", "ops/")
    _FLOOR = 65536

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        path = ctx.path.replace("\\", "/")
        if not any(d in path for d in self._DIRS):
            return
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call):
                d = _dotted(node.func)
                knob = None
                if d in ("os.environ.get", "os.getenv") and node.args:
                    a0 = node.args[0]
                    if isinstance(a0, ast.Constant) and isinstance(
                        a0.value, str
                    ):
                        knob = a0.value
                if knob is not None and knob.startswith("DGRAPH_TPU_"):
                    yield ctx.finding(
                        self.id, node,
                        f"env read of {knob} in the routing layers: knob "
                        "reads belong in utils/planconfig.py (one table "
                        "of documented defaults the planner can treat as "
                        "overridable) — two independently-grown 262144 "
                        "twins is how we got here",
                    )
            elif isinstance(node, ast.Compare):
                operands = [node.left] + list(node.comparators)
                for op in operands:
                    v = _const_int(op)
                    if v is not None and abs(v) >= self._FLOOR:
                        yield ctx.finding(
                            self.id, node,
                            f"naked numeric gate ({v}) in a comparison: "
                            "name it in utils/planconfig.py (or derive it "
                            "from the calibrated model in "
                            "query/planner.py) so the threshold is "
                            "documented, overridable and auditable — or "
                            "pragma the site with the WHY",
                        )
                        break


# -- rule: naked-version-key --------------------------------------------------

def _storeish(node: ast.AST) -> bool:
    """Does this expression read like a store reference (``store``,
    ``self.store``, ``self._server.store``, ``self.engine.store``)?"""
    d = _dotted(node)
    return d == "store" or d.endswith(".store")


class NakedVersionKey(Rule):
    id = "naked-version-key"
    doc = (
        "bare store.version read in the cache-keying layers — "
        "predicate-scoped cache versions live in dgraph_tpu_torch/ivm/"
        "versions.py (hop_version/result_version/version_for); a new "
        "view keyed on the GLOBAL version quietly regrows one-write-"
        "invalidates-everything"
    )

    # the layers that construct cache keys / freshness probes; the ivm/
    # package is the sanctioned home and sits outside them by design.
    # Both spellings are flagged: a plain ``<x>.store.version``
    # attribute read and the duck-typed ``getattr(<store>, "version")``.
    _DIRS = ("cache/", "query/", "sched/", "serve/")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        path = ctx.path.replace("\\", "/")
        if not any(d in path for d in self._DIRS):
            return
        for node in ast.walk(ctx.tree):
            if (
                isinstance(node, ast.Attribute)
                and node.attr == "version"
                and _storeish(node.value)
            ):
                yield ctx.finding(
                    self.id, node,
                    "bare store.version read: key caches through "
                    "dgraph_tpu_torch/ivm/versions.py (predicate-scoped "
                    "freshness) — or pragma the site with WHY it is "
                    "not a cache key",
                )
            elif isinstance(node, ast.Call):
                if (
                    _dotted(node.func) == "getattr"
                    and len(node.args) >= 2
                    and isinstance(node.args[1], ast.Constant)
                    and node.args[1].value == "version"
                    and _storeish(node.args[0])
                ):
                    yield ctx.finding(
                        self.id, node,
                        "bare getattr(store, \"version\") read: key "
                        "caches through dgraph_tpu_torch/ivm/versions.py "
                        "(predicate-scoped freshness) — or pragma the "
                        "site with WHY it is not a cache key",
                    )


# -- rule: naked-device-sync --------------------------------------------------

# names whose call hands a function to the device guard's watchdog
# bracket: ``devguard.get().run(op, fn)``, the engine's
# ``_run_guarded(op, fn)``, the mesh executor's ``_run(op, fn)``
_GUARD_RUNS = {"run", "_run_guarded", "_run"}
# methods that return host data: a chain through one of them is no
# longer a device tensor (the sync is the method itself)
_HOST_RESULT = {"cpu", "numpy", "tolist", "item"}


def _bracketed_nodes(tree: ast.AST) -> Set[int]:
    """id() of every node inside a def or lambda handed to a guard run
    (``<x>.run(op, fn)`` with ``fn`` a lambda or a def of the same
    file), and inside a def of the file that such a lambda calls by
    name (``lambda u=u: _dispatch(u)``): those bodies execute on the
    guard's watchdog worker."""
    handed: Set[str] = set()
    lambdas: List[ast.AST] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or len(node.args) < 2:
            continue
        f = node.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else "")
        if name not in _GUARD_RUNS:
            continue
        for a in node.args[1:]:
            if isinstance(a, ast.Name):
                handed.add(a.id)
            elif isinstance(a, ast.Lambda):
                lambdas.append(a)
                handed.update(
                    c.func.id for c in ast.walk(a.body)
                    if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)
                )
    out: Set[int] = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name in handed:
                out.update(id(s) for s in ast.walk(node))
    for lam in lambdas:
        out.update(id(s) for s in ast.walk(lam))
    return out


def _torch_rooted(node: ast.AST, tensors: Set[str]) -> bool:
    """Does this expression evaluate to a device tensor?  Follows method
    calls, attributes and subscripts down to their root: a ``torch.*``
    call, ``.to(...)`` / ``.cuda()``, or a name in ``tensors``; stops
    (False) at a method that returns host data."""
    while True:
        if isinstance(node, ast.Call):
            f = node.func
            if _dotted(f).startswith("torch."):
                return True
            if isinstance(f, ast.Attribute):
                if f.attr in _HOST_RESULT:
                    return False
                if f.attr in ("to", "cuda"):
                    return True
                node = f.value
                continue
            return False
        if isinstance(node, ast.Subscript):
            node = node.value
            continue
        if isinstance(node, ast.Attribute):
            node = node.value
            continue
        return isinstance(node, ast.Name) and node.id in tensors


def _tensor_names(scope: ast.AST) -> Set[str]:
    """Names bound in ``scope`` (nested defs excluded) to a tensor
    expression, to a fixpoint (``a = torch.x(); b = a[1:]``)."""
    assigns: List[Tuple[List[str], ast.AST]] = []
    for node in WallClockDuration._walk_scope(scope):
        if isinstance(node, ast.Assign):
            names = []
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.append(t.id)
            if names:
                assigns.append((names, node.value))
    tensors: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for names, value in assigns:
            if _torch_rooted(value, tensors):
                for n in names:
                    if n not in tensors:
                        tensors.add(n)
                        changed = True
    return tensors


class NakedDeviceSync(Rule):
    id = "naked-device-sync"
    doc = (
        "bare .item()/.tolist() on a tensor, .cpu(), torch.cuda."
        "synchronize() or <event|stream>.synchronize() sync point in "
        "query/, ops/, parallel/, mesh/ or sched/ — device syncs in the "
        "serving tree go through the device guard (utils/devguard.py "
        "watchdog bracket) or obs.block_ready_ms, so a wedged card can "
        "never block a flush worker forever"
    )

    # the serving layers whose host orchestration launches device work;
    # utils/devguard.py (the watchdog's home) and obs/ (the
    # block_ready_ms wrapper) sit outside them by design
    _DIRS = ("query/", "ops/", "parallel/", "mesh/", "sched/")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        path = ctx.path.replace("\\", "/")
        if not any(d in path for d in self._DIRS):
            return
        if "obs/" in path or path.endswith("utils/devguard.py"):
            return
        bracketed = _bracketed_nodes(ctx.tree)
        scopes: List[ast.AST] = [ctx.tree]
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes.append(node)
        seen: Set[int] = set()
        for scope in scopes:
            tensors = _tensor_names(scope)
            for node in WallClockDuration._walk_scope(scope):
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                seen.add(id(node))
                if id(node) in bracketed:
                    continue
                hit = self._sync_of(node, tensors)
                if hit is None:
                    continue
                yield ctx.finding(
                    self.id, node,
                    f"naked `{hit}` sync point on the host orchestration "
                    "path: a wedged launch blocks this worker with no "
                    "deadline and no failover — bracket the launch+fetch "
                    "with the device guard (utils/devguard.py run()) or "
                    "use obs.block_ready_ms so the wait is watchdogged "
                    "and span-attributed, or pragma a deliberate sync "
                    "with the WHY",
                )

    @staticmethod
    def _sync_of(node: ast.Call, tensors: Set[str]) -> Optional[str]:
        f = node.func
        d = _dotted(f)
        if d == "torch.cuda.synchronize":
            return d
        if not isinstance(f, ast.Attribute) or node.args:
            return None
        if f.attr == "synchronize":
            return "synchronize"  # an Event's or a Stream's
        if f.attr == "cpu":
            return "cpu"  # numpy arrays have no .cpu(): a tensor fetch
        if f.attr in ("item", "tolist") and _torch_rooted(f.value, tensors):
            return f.attr
        return None



# -- rule: unchecked-hop-loop -----------------------------------------------

# the expander/dispatch seam: calls that (directly or one wrapper deep)
# cost a hop dispatch per iteration.  ``expand`` as a BARE name covers
# the local-closure shape (query/shortest.py's lazy expander); the rest
# are the engine/resolver method names.
_HOP_SEAM_ATTRS = {
    "expand", "_expand", "_expand_rows", "_exec_child",
    "_exec_child_inner", "submit_hop", "multi_hop",
}
# segmented dataflow: a host loop that re-dispatches a carry through a
# bounded program segment — by convention every segment loop names its
# per-segment dispatch helper `_dispatch_segment`
# (ops/batch.py, query/chain.py, query/joinplan.py, mesh/executor.py)
_SEG_SEAM_ATTRS = {"_dispatch_segment"}
_HOP_CHECK_ATTRS = {"checkpoint"}


def _is_seam_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr in _HOP_SEAM_ATTRS
    return isinstance(f, ast.Name) and f.id == "expand"


def _is_segment_dispatch_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr in _SEG_SEAM_ATTRS
    return isinstance(f, ast.Name) and f.id in _SEG_SEAM_ATTRS


def _is_checkpoint_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute):
        if f.attr in _HOP_CHECK_ATTRS:
            return True
        # the scheduler yield point between program segments
        # (sched/segments.py): segments.seam(...) probes the token AND
        # offers preemption — it IS the checkpoint of a segment loop
        if f.attr == "seam":
            return "segment" in _dotted(f).lower()
        # direct token probe: <something>cancel/token<something>.check()
        if f.attr == "check":
            root = _dotted(f).lower()
            return "cancel" in root or "token" in root
    return isinstance(f, ast.Name) and f.id in _HOP_CHECK_ATTRS


class UncheckedHopLoop(Rule):
    id = "unchecked-hop-loop"
    doc = (
        "loop driving the expander/dispatch seam (query/) or "
        "re-dispatching a segment carry (_dispatch_segment in "
        "query//ops//mesh/) without a CancelToken checkpoint or "
        "segments.seam() yield point — cooperative cancellation and "
        "segment preemption need a probe between EVERY pair of "
        "dispatches"
    )

    # query/ is the layer that drives hop dispatches in loops; ops/
    # loops run INSIDE jitted programs where a checkpoint is impossible
    # by design (the documented cancellation granularity is one
    # dispatched program), and sched/ owns the token itself.  The ONE
    # exception to the ops//mesh/ exemption is the segmented loop: its
    # `_dispatch_segment` loop is a HOST loop between
    # bounded programs — exactly where a yield point is possible and
    # required — so those calls are checked in all three layers.
    _DIRS = ("query/",)
    _SEG_DIRS = ("query/", "ops/", "mesh/")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        path = ctx.path.replace("\\", "/")
        hop_layer = any(d in path for d in self._DIRS)
        seg_layer = any(d in path for d in self._SEG_DIRS)
        if not hop_layer and not seg_layer:
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
                continue
            has_seam = False
            has_seg = False
            has_check = False
            for sub in ast.walk(node):
                if hop_layer and _is_seam_call(sub):
                    has_seam = True
                elif seg_layer and _is_segment_dispatch_call(sub):
                    has_seg = True
                elif _is_checkpoint_call(sub):
                    has_check = True
            if (has_seam or has_seg) and not has_check:
                what = (
                    "re-dispatches a program-segment carry"
                    if has_seg
                    else "dispatches hop expansions"
                )
                yield ctx.finding(
                    self.id, node,
                    f"this loop {what} but never probes the request's "
                    "CancelToken or yield point: a deadline-expired, "
                    "disconnected, or preemptable query keeps burning "
                    "engine time here — call engine.checkpoint() / "
                    "segments.seam() / <token>.check() between "
                    "dispatches, or pragma the site with the WHY",
                )


# -- rule: unregistered-metric ------------------------------------------------

# the MetricsRegistry constructor methods (utils/metrics.py) — the only
# sanctioned way a dgraph_* series comes into existence
_METRIC_CTORS = {
    "counter", "gauge", "func_gauge", "labeled", "multilabeled",
    "labeled_gauge", "multilabeled_gauge", "histogram",
    "labeled_histogram",
}


# the catalogs the rule reads: the tree's (docs/deploy.md, shared with
# the reference) and the port's own series (dgraph_tpu_torch/METRICS.md)
_ROOT = Path(__file__).resolve().parents[2]
CATALOGS = (
    _ROOT / "docs" / "deploy.md",
    _ROOT / "dgraph_tpu_torch" / "METRICS.md",
)


def parse_catalog(doc: Path) -> Set[str]:
    """The backticked dgraph_* names of ``doc``'s "### Metric catalog"
    section (scoped to the section so prose elsewhere mentioning a
    series does not register it); empty when the file is missing."""
    names: Set[str] = set()
    if not doc.exists():
        return names
    in_section = False
    for line in doc.read_text(encoding="utf-8").splitlines():
        if line.startswith("### Metric catalog"):
            in_section = True
            continue
        if in_section and line.startswith("#"):
            break
        if in_section:
            names.update(re.findall(r"`(dgraph_[a-z0-9_]+)`", line))
    return names


class UnregisteredMetric(Rule):
    id = "unregistered-metric"
    doc = (
        "dgraph_* metric series constructed without a row in a metric "
        "catalog (docs/deploy.md, or the port's dgraph_tpu_torch/"
        "METRICS.md) — every exported series must be documented where "
        "operators build dashboards and alerts, or it is dark data with "
        "a scrape cost"
    )

    # lazily-parsed union of both catalogs.  Tests override
    # ``catalog_override`` to pin the set.
    catalog_override: Optional[Set[str]] = None
    _catalog_cache: Optional[Set[str]] = None

    @classmethod
    def catalog(cls) -> Set[str]:
        if cls.catalog_override is not None:
            return cls.catalog_override
        if cls._catalog_cache is None:
            names: Set[str] = set()
            for doc in CATALOGS:
                names |= parse_catalog(doc)
            cls._catalog_cache = names
        return cls._catalog_cache

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        catalog = self.catalog()
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not (
                isinstance(f, ast.Attribute) and f.attr in _METRIC_CTORS
            ):
                continue
            # the series name is the first positional OR the name=
            # keyword — a kwarg spelling must not slip the gate
            a0 = node.args[0] if node.args else next(
                (kw.value for kw in node.keywords if kw.arg == "name"),
                None,
            )
            if a0 is None:
                continue
            if not (
                isinstance(a0, ast.Constant)
                and isinstance(a0.value, str)
                and a0.value.startswith("dgraph_")
            ):
                continue
            name = a0.value
            # histogram exposition appends _bucket/_sum/_count; the
            # catalog documents the family name, which is what is
            # constructed here — exact match is the contract
            if name not in catalog:
                yield ctx.finding(
                    self.id, node,
                    f"series {name!r} has no row in a metric catalog "
                    "(docs/deploy.md, or dgraph_tpu_torch/METRICS.md for "
                    "a port-only series; ### Metric catalog): add one — "
                    "name, type, labels, one-line meaning — or pragma "
                    "the site with WHY the series is deliberately "
                    "undocumented",
                )


# -- rule: naked-resident-transfer --------------------------------------------

def _residentish(node: ast.AST) -> bool:
    """Does this expression reach into a resident arena's device
    buffers?  Matches any name/attribute mentioning ``resident`` (e.g.
    ``arena.resident()``, ``self._resident``) and the ``off``/``dst``
    lanes of a receiver conventionally named for one (``ra``/``nra``)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute):
            if "resident" in sub.attr:
                return True
            if sub.attr in ("off", "dst"):
                base = sub.value
                if isinstance(base, ast.Name) and base.id in (
                    "ra", "nra", "resident"
                ):
                    return True
                if (
                    isinstance(base, ast.Call)
                    and isinstance(base.func, ast.Attribute)
                    and base.func.attr == "resident"
                ):
                    return True
        elif isinstance(sub, ast.Name) and "resident" in sub.id:
            return True
    return False


class NakedResidentTransfer(Rule):
    id = "naked-resident-transfer"
    doc = (
        ".to(...) / .cuda() / .cpu() / torch.as_tensor(..., device=...) "
        "/ np.asarray on a resident arena's device buffers outside "
        "models/arena.py — the resident tier's whole contract is that "
        "the CSR never re-crosses the host/device boundary after seeding "
        "(ledger h2d/d2h = 0 for a warm hop); staging or fetching those "
        "buffers elsewhere reintroduces the transfer tax the tier "
        "deletes, uncharged"
    )

    # models/arena.py is the sanctioned home of every resident-buffer
    # staging (ResidentArena.seed / apply_delta, both ledger-charged)
    _HOME = "models/arena.py"
    _METHODS = ("to", "cuda", "cpu")
    _CTORS = ("torch.as_tensor", "torch.tensor")
    _HOST = ("np.asarray", "numpy.asarray", "np.array", "numpy.array")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if ctx.path.replace("\\", "/").endswith(self._HOME):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            d = _dotted(f)
            if isinstance(f, ast.Attribute) and f.attr in self._METHODS:
                operands = [f.value]
            elif d in self._CTORS and any(
                kw.arg == "device" for kw in node.keywords
            ):
                operands = node.args[:1]
            elif d in self._HOST:
                operands = node.args[:1]
            else:
                continue
            if any(_residentish(a) for a in operands):
                yield ctx.finding(
                    self.id, node,
                    "transfer on a resident arena buffer: the pinned CSR "
                    "must never re-cross the boundary outside "
                    "models/arena.py (seed/apply_delta, ledger-charged) "
                    "— expand via ResidentArena.expand_packed and fetch "
                    "only the packed result, or pragma the site with the "
                    "WHY",
                )


# -- rule: naked-collective ---------------------------------------------------

class NakedCollective(Rule):
    id = "naked-collective"
    doc = (
        "shard_map / psum / all_gather / ppermute outside dgraph_tpu_torch/"
        "mesh/ and dgraph_tpu_torch/parallel/ — cross-chip collectives "
        "are the mesh plane's contract surface (placement-invariant "
        "reassembly, exchange-bytes ledger attribution); a collective "
        "grown elsewhere ships none of that"
    )

    # the two sanctioned homes: parallel/ (per-hop mesh steps) and
    # mesh/ (the fused serving plane)
    _HOMES = ("dgraph_tpu_torch/mesh/", "dgraph_tpu_torch/parallel/")
    _COLLECTIVES = frozenset(
        {"shard_map", "psum", "all_gather", "ppermute"}
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        path = ctx.path.replace("\\", "/")
        if any(h in path for h in self._HOMES):
            return
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = _dotted(node.func)
            name = dotted.rsplit(".", 1)[-1]
            if name not in self._COLLECTIVES:
                continue
            yield ctx.finding(
                self.id, node,
                f"cross-chip collective `{dotted}` outside the mesh "
                "plane: collectives live in dgraph_tpu_torch/mesh/ (fused "
                "serving programs) or dgraph_tpu_torch/parallel/ (per-hop "
                "steps), where reassembly stays placement-invariant and "
                "exchange bytes are ledger-charged — move the program "
                "there or pragma the site with the WHY",
            )


ALL_RULES: Tuple[Rule, ...] = (
    WallClockDuration(),
    SwallowedException(),
    NakedPeerRpc(),
    NakedAtomicWrite(),
    NakedStageTiming(),
    NakedRouteThreshold(),
    NakedVersionKey(),
    NakedDeviceSync(),
    UncheckedHopLoop(),
    UnregisteredMetric(),
    NakedResidentTransfer(),
    NakedCollective(),
)
