"""Runtime lock-order witness and Eraser lockset witness for the port
(``dgraph_tpu/analysis/witness.py`` scoped to ``dgraph_tpu_torch``).

:func:`arm` swaps a proxy ``threading`` namespace into every loaded
``dgraph_tpu_torch.*`` module, so locks **constructed after arming** are
wrapper objects that report acquire/release to a global witness.  Like
lockdep, locks are grouped into *classes by construction site*
(``sched/scheduler.py:135`` names every scheduler's condition); the
witness keeps a per-thread held stack and a global first-seen order
table of (held, acquired) pairs.  Seeing both (A, B) and (B, A) is an
inversion; same-class pairs get a second, instance-serial table (two
instances of one class taken in both orders), while reentrancy on one
RLock instance stays exempt.  The port's RWLock (``utils/rwlock.py``) is
instrumented at the class level (read and write side both count as
holding the lock class).

Excluded: ``utils.metrics`` (hot leaf locks), ``utils.rwlock``
(instrumented at class level), locks created at import time, and
``analysis.*`` itself.

**Eraser lockset witness** (co-gated by ``DGRAPH_TPU_RACES``, default on
whenever the lock witness is armed): classes that declare
``__race_fields__ = frozenset({...})`` get their ``__setattr__`` wrapped
*at arm time*; every write to a declared field feeds the lockset state
machine (first write Exclusive; a second thread's write makes it
Shared-Modified with that thread's held set as the candidate lockset;
an empty intersection on a write by a thread other than the last writer
is a data race).  The hand-off points that establish happens-before
edges reset a struct's field states: ``obs.ledger.activate`` /
``finish`` and ``SchedRequest.complete`` / ``fail``.

:func:`instrument_rwlock` and :func:`instrument_handoffs` take any
witness through its ``note_acquire`` / ``note_release`` /
``reset_fields`` methods (or a zero-argument callable returning the
current one), so a lockset witness armed by another recorder over the
same process covers the port's hand-offs and RWLock too (the test
suite's, through ``tests/torch_witness.py``).

``Witness()`` instances can also be used directly (the seeded-inversion
tests do).
"""

from __future__ import annotations

import itertools
import os
import sys
import threading as _real_threading
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

_INFRA_FILES = ("analysis/witness.py", "utils/rwlock.py", "threading.py")

# per-wrapper monotonic serials (NOT id(): ids recycle after GC and a
# recycled id could alias a dead lock into a false inversion).  They
# start at 2^40 so that, where another recorder's witness (counting from
# 1) watches the port's RWLocks, the two never hand out the same serial
_serial = itertools.count(1 << 40)

# writer identity for the lockset state machine (NOT get_ident(): the
# OS recycles idents the moment a thread exits, so two short-lived
# sequential writers would alias into one and hide the alternation that
# defines a ping-pong race)
_thread_tokens = itertools.count(1)
_tls = _real_threading.local()


def _thread_token() -> int:
    tok = getattr(_tls, "token", None)
    if tok is None:
        tok = next(_thread_tokens)
        _tls.token = tok
    return tok


def races_enabled() -> bool:
    """Lockset-witness gate: ``DGRAPH_TPU_RACES=0`` opts out (the lock
    witness itself stays governed by ``DGRAPH_TPU_WITNESS``)."""
    return os.environ.get("DGRAPH_TPU_RACES", "1") != "0"


def _short_stack(skip: int = 2, depth: int = 4) -> str:
    """Compact caller stack (innermost first), infra frames elided."""
    try:
        f = sys._getframe(skip)
    except ValueError:  # pragma: no cover
        return "<unknown>"
    parts: List[str] = []
    while f is not None and len(parts) < depth:
        fn = f.f_code.co_filename.replace("\\", "/")
        if not any(fn.endswith(s) for s in _INFRA_FILES):
            short = "/".join(fn.rsplit("/", 3)[-3:])
            parts.append(f"{short}:{f.f_lineno}")
        f = f.f_back
    return " <- ".join(parts) or "<unknown>"


def _creation_site(skip: int = 2) -> str:
    """file:line of the nearest non-infrastructure caller frame."""
    best = None
    f = sys._getframe(skip)
    for _ in range(10):
        if f is None:
            break
        fn = f.f_code.co_filename.replace("\\", "/")
        if not any(fn.endswith(s) for s in _INFRA_FILES):
            short = "/".join(fn.rsplit("/", 3)[-3:])
            return f"{short}:{f.f_lineno}"
        if best is None:
            short = "/".join(fn.rsplit("/", 3)[-3:])
            best = f"{short}:{f.f_lineno}"
        f = f.f_back
    return best or "<unknown>"


class Witness:
    """Order table + per-thread held stacks.  All bookkeeping uses REAL
    threading primitives and never calls out while holding its own lock
    (the witness must not deadlock the system it watches)."""

    def __init__(self) -> None:
        self._mu = _real_threading.Lock()
        self._tls = _real_threading.local()
        # class level: (a, b) -> "a@siteA -> b@siteB" for the FIRST
        # observation of class b acquired while class a held
        self._order: Dict[Tuple[str, str], str] = {}
        # instance level, for SAME-class pairs only: two instances of
        # one lock class taken in both orders is the classic ABBA the
        # class table cannot see (both directions collapse to a
        # self-edge).  Keyed by wrapper serials; bounded below.
        self._inst_order: Dict[Tuple[int, int], str] = {}
        self._inst_saturated = False
        self._inversions: List[str] = []
        # Eraser lockset state: instance serial -> field -> _FieldState
        self._fields: Dict[int, Dict[str, "_FieldState"]] = {}
        self._field_count = 0
        self._field_saturated = False
        self._races: List[str] = []
        self.active = True

    _INST_CAP = 100_000  # instance-pair table bound (serials churn)
    _FIELD_CAP = 200_000  # field-state table bound (instances churn)

    # -- core events --------------------------------------------------------

    def _held(self) -> List[Tuple[str, int]]:
        h = getattr(self._tls, "held", None)
        if h is None:
            h = self._tls.held = []
        return h

    def note_acquire(self, name: str, serial: int = 0) -> None:
        if not self.active:
            return
        held = self._held()
        if held:
            site = None
            for h, hs in held:
                if h == name:
                    if not serial or not hs or hs == serial:
                        continue  # reentrant (RLock) — not an order fact
                    # same class, DIFFERENT instances: track by serial
                    if (hs, serial) not in self._inst_order:
                        if site is None:
                            site = _creation_site(2)
                        with self._mu:
                            if (hs, serial) not in self._inst_order:
                                if len(self._inst_order) < self._INST_CAP:
                                    self._inst_order[(hs, serial)] = site
                                elif not self._inst_saturated:
                                    # no silent caps: past this point
                                    # same-class inversion detection is
                                    # degraded — say so once, loudly
                                    self._inst_saturated = True
                                    print(
                                        "graftcheck witness: instance-"
                                        f"order table hit its {self._INST_CAP}"
                                        "-pair cap; same-class inversion "
                                        "detection is degraded for the "
                                        "rest of this run",
                                        file=sys.stderr,
                                    )
                                rev = self._inst_order.get((serial, hs))
                                if rev is not None:
                                    self._inversions.append(
                                        "lock-order inversion (two "
                                        f"instances of class {name}): "
                                        f"#{hs} -> #{serial} @ {site} BUT "
                                        f"#{serial} -> #{hs} @ {rev}"
                                    )
                    continue
                if (h, name) not in self._order:  # racy pre-check is fine:
                    # worst case two threads compute the site; insert
                    # below is serialized under _mu
                    if site is None:
                        site = _creation_site(2)
                    with self._mu:
                        if (h, name) not in self._order:
                            self._order[(h, name)] = f"{h} then {name} @ {site}"
                            rev = self._order.get((name, h))
                            if rev is not None:
                                self._inversions.append(
                                    f"lock-order inversion: [{name} -> {h}] "
                                    f"seen as {rev}; BUT [{h} -> {name}] "
                                    f"seen as {self._order[(h, name)]}"
                                )
        held.append((name, serial))

    def note_release(self, name: str, serial: int = 0) -> None:
        if not self.active:
            return
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == name and (not serial or held[i][1] == serial):
                del held[i]
                return

    # -- Eraser lockset (tier 3) --------------------------------------------

    def note_field_write(self, obj, name: str) -> None:
        """One write to a declared race field — drive the lockset state
        machine.  The same-owner Exclusive path is lock-free and walks
        no frames: that is the overhead bound for single-writer structs
        (ledgers between hand-offs, per-request state)."""
        if not self.active:
            return
        try:
            s = getattr(obj, "_race_serial", None)
        except Exception:  # noqa: BLE001 — exotic __getattr__: not ours
            return
        if s is None:
            try:
                s = next(_serial)
                object.__setattr__(obj, "_race_serial", s)
            except (AttributeError, TypeError):
                return  # __slots__ without a _race_serial slot
        tid = _thread_token()
        per = self._fields.get(s)
        st = per.get(name) if per is not None else None
        if st is None:
            with self._mu:
                per = self._fields.setdefault(s, {})
                st = per.get(name)
                if st is None:
                    if self._field_count >= self._FIELD_CAP:
                        if not self._field_saturated:
                            # no silent caps: say so once, loudly
                            self._field_saturated = True
                            print(
                                "graftcheck witness: field-state table "
                                f"hit its {self._FIELD_CAP}-entry cap; "
                                "race detection is degraded for the "
                                "rest of this run",
                                file=sys.stderr,
                            )
                        return
                    per[name] = _FieldState(tid, _short_stack(3))
                    self._field_count += 1
                    _bump_fields_metric()
                    return
        if not st.shared and st.owner == tid:
            return  # Exclusive, same owner: Eraser does NOT refine here
        heldset = frozenset(self._held())
        with self._mu:
            if not st.shared:
                # Exclusive -> Shared-Modified: the candidate lockset is
                # whatever the second writer holds.  Empty is the
                # tolerated single hand-off, not yet a race.
                st.shared = True
                st.lockset = heldset
                st.last_writer = tid
                st.last_site = _short_stack(3)
                return
            ls = st.lockset & heldset
            alternated = tid != st.last_writer
            prev_writer, prev_site = st.last_writer, st.last_site
            st.lockset = ls
            st.last_writer = tid
            if ls:
                # locked steady state: elide the stack walk (hot path
                # for properly-guarded shared counters)
                return
            site = _short_stack(3)
            st.last_site = site
            if alternated and not st.reported:
                st.reported = True
                self._races.append(
                    f"data race: {type(obj).__name__}.{name} "
                    f"(instance #{s}): write by thread {tid} at [{site}] "
                    "with EMPTY lockset; previous write by thread "
                    f"{prev_writer} at [{prev_site or '<locked write, stack elided>'}]; "
                    f"first write by thread {st.owner} at [{st.first_site}]"
                )

    def reset_fields(self, obj) -> None:
        """Hand-off point: forget this instance's field states so the
        next writer starts a fresh Exclusive epoch (the caller asserts a
        happens-before edge — ledger activate, request completion)."""
        try:
            s = getattr(obj, "_race_serial", None)
        except Exception:  # noqa: BLE001
            return
        if s is None:
            return
        with self._mu:
            per = self._fields.pop(s, None)
            if per:
                self._field_count -= len(per)

    # -- reporting ----------------------------------------------------------

    def inversions(self) -> List[str]:
        with self._mu:
            return list(self._inversions)

    def races(self) -> List[str]:
        with self._mu:
            return list(self._races)

    def edges(self) -> Dict[Tuple[str, str], str]:
        with self._mu:
            return dict(self._order)


class _FieldState:
    """Lockset state for ONE field of ONE instance (keyed by the
    instance's monotonic serial — ids recycle, serials don't)."""

    __slots__ = (
        "owner", "first_site", "last_writer", "last_site",
        "lockset", "shared", "reported",
    )

    def __init__(self, owner: int, first_site: str) -> None:
        self.owner = owner            # first writer's thread id
        self.first_site = first_site
        self.last_writer = owner
        self.last_site: Optional[str] = None
        self.lockset: FrozenSet = frozenset()
        self.shared = False
        self.reported = False


_fields_metric = None


def _bump_fields_metric() -> None:
    global _fields_metric
    if _fields_metric is None:
        from dgraph_tpu_torch.utils.metrics import RACE_WITNESS_FIELDS
        _fields_metric = RACE_WITNESS_FIELDS
    _fields_metric.add(1)


# -- wrapper primitives -----------------------------------------------------

class _WLock:
    """threading.Lock/RLock wrapper reporting to a witness."""

    def __init__(self, witness: Witness, name: str, inner) -> None:
        self._w = witness
        self._name = name
        self._inner = inner
        self._ws = next(_serial)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._w.note_acquire(self._name, self._ws)
        return ok

    def release(self) -> None:
        self._inner.release()
        self._w.note_release(self._name, self._ws)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover
        return f"<witnessed {self._name} {self._inner!r}>"


class _WCondition(_real_threading.Condition):
    """Condition subclass reporting to a witness.  ``wait`` releases the
    underlying lock, so the held-stack entry pops for the wait's
    duration — otherwise every post-wait acquisition would look nested
    under the condition."""

    def __init__(self, witness: Witness, name: str, lock=None) -> None:
        super().__init__(lock)
        self._wname = name
        self._w = witness
        self._ws = next(_serial)
        # threading.Condition.__init__ binds self.acquire/self.release
        # as INSTANCE attributes (the inner lock's bound methods), which
        # would shadow any class-level override — rebind them here so
        # direct cond.acquire()/release() calls are witnessed too.
        # (Condition.wait uses _release_save/_acquire_restore, which go
        # straight to the inner lock — our wait() override covers that.)
        inner_acquire, inner_release = self.acquire, self.release

        def acquire(*a, **k):
            ok = inner_acquire(*a, **k)
            if ok:
                self._w.note_acquire(self._wname, self._ws)
            return ok

        def release():
            self._w.note_release(self._wname, self._ws)
            inner_release()

        self.acquire = acquire
        self.release = release

    def __enter__(self):
        r = super().__enter__()
        self._w.note_acquire(self._wname, self._ws)
        return r

    def __exit__(self, *exc):
        self._w.note_release(self._wname, self._ws)
        return super().__exit__(*exc)

    def wait(self, timeout: Optional[float] = None):
        self._w.note_release(self._wname, self._ws)
        try:
            return super().wait(timeout)
        finally:
            self._w.note_acquire(self._wname, self._ws)
    # wait_for() is inherited and loops over wait() — covered.


class _ThreadingProxy:
    """Module-shaped object delegating to real ``threading`` with the
    lock constructors swapped for witnessing ones.  Injected into a
    module's ``threading`` global, so only dgraph_tpu_torch code sees
    it."""

    def __init__(self, witness: Witness) -> None:
        self._w = witness

    def Lock(self):
        return _WLock(self._w, _creation_site(), _real_threading.Lock())

    def RLock(self):
        return _WLock(self._w, _creation_site(), _real_threading.RLock())

    def Condition(self, lock=None):
        return _WCondition(self._w, _creation_site(), lock)

    def __getattr__(self, name: str):
        return getattr(_real_threading, name)


# -- arming -----------------------------------------------------------------

_PKG = "dgraph_tpu_torch"
_EXCLUDE_MODULES = (
    "dgraph_tpu_torch.analysis",
    "dgraph_tpu_torch.utils.metrics",   # hot leaf locks, verified no fan-out
    "dgraph_tpu_torch.utils.rwlock",    # instrumented at class level below
)

_global: Optional[Witness] = None
_patched: List[Tuple[object, str, object]] = []  # (obj, attr, original)


def _port_modules():
    """(name, module) of every loaded port module the witness covers."""
    for name, mod in list(sys.modules.items()):
        if mod is None or not (name == _PKG or name.startswith(_PKG + ".")):
            continue
        if any(name.startswith(e) for e in _EXCLUDE_MODULES):
            continue
        yield name, mod


def arm() -> Witness:
    """Install the witness into every loaded dgraph_tpu_torch module
    (modules imported later are covered when arm() is called again).
    Idempotent; returns the global witness."""
    global _global
    if _global is None:
        _global = Witness()
    w = _global
    proxy = _ThreadingProxy(w)
    for _name, mod in _port_modules():
        cur = getattr(mod, "threading", None)
        if cur is _real_threading:
            _patched.append((mod, "threading", cur))
            mod.threading = proxy
    instrument_rwlock(current)
    if races_enabled():
        _instrument_race_classes()
        instrument_handoffs(current)
    return w


def disarm() -> None:
    """Restore patched namespaces.  Wrapper locks already embedded in
    live objects keep functioning (the witness just goes inactive)."""
    global _global
    for obj, attr, orig in _patched:
        setattr(obj, attr, orig)
    _patched.clear()
    for cls, own_setattr in _race_patched:
        if own_setattr is not None:
            cls.__setattr__ = own_setattr
        else:
            try:
                del cls.__setattr__
            except AttributeError:  # pragma: no cover
                pass
        try:
            del cls._race_instrumented
        except AttributeError:  # pragma: no cover
            pass
    _race_patched.clear()
    if _global is not None:
        _global.active = False
        _global = None


def current() -> Optional[Witness]:
    return _global


def _getter(witness) -> Callable[[], object]:
    """A zero-argument getter for ``witness``: a witness object (anything
    with ``note_acquire`` / ``note_release`` / ``reset_fields``), or a
    callable that returns the current one (None while disarmed)."""
    if callable(witness) and not hasattr(witness, "note_acquire"):
        return witness
    return lambda: witness


def _live(wit) -> bool:
    return wit is not None and getattr(wit, "active", True)


# where the class-level RWLock wraps and the hand-off wraps report; set
# by the last instrument_* call (the wraps themselves install once)
_rw_source: Callable[[], object] = lambda: None  # noqa: E731
_handoff_source: Callable[[], object] = lambda: None  # noqa: E731


def instrument_rwlock(witness) -> None:
    """Patch the port's RWLock at the class level so that read and write
    side both count as holding the lock's class (an RWLock inversion is
    an inversion no matter which side each thread took — the write side
    excludes both).  Acquisitions report to ``witness``."""
    global _rw_source
    from dgraph_tpu_torch.utils import rwlock as _rw

    _rw_source = _getter(witness)
    if getattr(_rw.RWLock, "_witnessed", False):
        return
    _rw.RWLock._witnessed = True
    orig_init = _rw.RWLock.__init__
    orig = {
        m: getattr(_rw.RWLock, m)
        for m in ("acquire_read", "release_read", "acquire_write",
                  "release_write")
    }

    def __init__(self):  # noqa: N807
        orig_init(self)
        self._witness_name = _creation_site()
        self._witness_serial = next(_serial)

    def make(method, note_after_acquire: bool):
        o = orig[method]
        if note_after_acquire:
            def wrapped(self):
                o(self)
                wit = _rw_source()
                if _live(wit):
                    wit.note_acquire(
                        getattr(self, "_witness_name", "rwlock"),
                        getattr(self, "_witness_serial", 0),
                    )
        else:
            def wrapped(self):
                wit = _rw_source()
                if _live(wit):
                    wit.note_release(
                        getattr(self, "_witness_name", "rwlock"),
                        getattr(self, "_witness_serial", 0),
                    )
                o(self)
        return wrapped

    _rw.RWLock.__init__ = __init__
    _rw.RWLock.acquire_read = make("acquire_read", True)
    _rw.RWLock.acquire_write = make("acquire_write", True)
    _rw.RWLock.release_read = make("release_read", False)
    _rw.RWLock.release_write = make("release_write", False)


# -- Eraser instrumentation -------------------------------------------------

# (cls, its own pre-wrap __setattr__ or None if it inherited object's)
_race_patched: List[Tuple[type, Optional[object]]] = []


def _instrument_race_classes() -> None:
    """Wrap ``__setattr__`` on every loaded port class declaring
    ``__race_fields__``.  Installed at arm time ONLY: before arming (and
    after disarm) annotated classes keep the original slot/dict setattr
    — the unarmed serving path pays nothing and allocates nothing."""
    for _name, mod in _port_modules():
        for obj in list(vars(mod).values()):
            if isinstance(obj, type) and "__race_fields__" in vars(obj):
                _instrument_one_class(obj)


def _instrument_one_class(cls: type) -> None:
    if vars(cls).get("_race_instrumented"):
        return
    fields = frozenset(vars(cls)["__race_fields__"])
    own = vars(cls).get("__setattr__")
    orig = cls.__setattr__  # resolved: own override or object/slot setattr

    def __setattr__(self, name, value, _orig=orig, _fields=fields):
        _orig(self, name, value)
        if name in _fields:
            wit = _global
            if wit is not None and wit.active:
                wit.note_field_write(self, name)

    cls.__setattr__ = __setattr__
    cls._race_instrumented = True
    _race_patched.append((cls, own))


def instrument_handoffs(witness) -> None:
    """Wrap the hand-off points that establish happens-before edges for
    the pooled ledger: ``activate`` (the flush worker takes ownership),
    ``finish`` (the end of the struct's life under this request) and
    ``SchedRequest.complete/fail`` (``req.wait()`` releases the blocked
    handler, which owns the struct from then on).  Each wrap resets the
    struct's field states in ``witness`` — a new Exclusive epoch for the
    new owner.  ``finish`` resets BEFORE the original, so finish's own
    reset stores open a fresh epoch owned by the draining thread."""
    global _handoff_source
    _handoff_source = _getter(witness)
    led = sys.modules.get("dgraph_tpu_torch.obs.ledger")
    if led is None:
        from dgraph_tpu_torch.obs import ledger as led
    for fname in ("activate", "finish"):
        orig = getattr(led, fname)
        if getattr(orig, "_race_wrap", False):
            continue

        def _make_fn(o):
            def wrapped(l):  # noqa: E741 — ledger arg
                wit = _handoff_source()
                if _live(wit):
                    wit.reset_fields(l)
                return o(l)

            wrapped._race_wrap = True
            return wrapped

        setattr(led, fname, _make_fn(orig))
        _patched.append((led, fname, orig))

    coh = sys.modules.get("dgraph_tpu_torch.sched.cohort")
    if coh is None:
        from dgraph_tpu_torch.sched import cohort as coh
    for meth in ("complete", "fail"):
        orig = getattr(coh.SchedRequest, meth)
        if getattr(orig, "_race_wrap", False):
            continue

        def _make(o):
            def wrapped(self, *a, **k):
                wit = _handoff_source()
                if _live(wit):
                    led_obj = getattr(self, "ledger", None)
                    if led_obj is not None:
                        wit.reset_fields(led_obj)
                return o(self, *a, **k)

            wrapped._race_wrap = True
            return wrapped

        setattr(coh.SchedRequest, meth, _make(orig))
        _patched.append((coh.SchedRequest, meth, orig))
