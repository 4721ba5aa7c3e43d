"""Device fault domain: health state machine and dispatch watchdog for
the card (PyTorch port of ``dgraph_tpu/utils/devguard.py``).

- **Per-domain health state machine** — ``healthy → suspect → sick``.
  A transient fault marks the domain suspect;
  ``DGRAPH_TPU_DEVICE_SICK_AFTER`` consecutive faults (default 3) — or
  ONE wedged dispatch — latch it sick.  A sick domain sheds device work
  in microseconds (:class:`DeviceSickError`).  Domains: ``"device"``
  (the card the engine's kernels launch on), ``"mesh"`` (the mesh
  serving plane, ``dgraph_tpu_torch/mesh``: a faulted mesh dispatch
  latches it, never ``"device"``) and the mesh's per-chip sub-domains
  ``"mesh.chip<i>"`` (``sick_after=1``, made by ``mesh/fault.py``
  through :func:`ensure`).

- **Chip attribution** — :func:`chip_of` reads ``chip=N`` off a fault's
  exception chain (the failpoints' ``chip=`` selector, or
  :class:`ChipFaultError`, which the mesh raises for a fault on one of
  several distinct cards).  The ``"mesh"`` guard's ``fault_sink`` (wired
  by the elastic fault domain) takes an attributed fault to that chip's
  sub-domain and leaves the plane uncharged; ``on_readmit`` runs after a
  sub-domain's probe re-admits it (the staged rejoin).  A real CUDA
  fault on virtual chips of one card names no chip: it is the whole
  card's, and latches the plane.

- **Dispatch watchdog** — :meth:`DeviceGuard.run` executes a
  dispatch-and-fetch closure on a guard-owned worker thread and waits at
  most ``DGRAPH_TPU_DEVICE_HANG_MS`` (default 30 s).  On overrun the
  caller abandons the wedged worker (nothing can interrupt a stuck CUDA
  call; the thread exits when, if ever, the call returns), latches the
  domain sick and raises :class:`DeviceHangError`.  The flush worker of
  the cohort scheduler is never the thread that blocks.  The worker runs
  the closure on the caller's CUDA device and stream (both are
  per-thread in torch, captured at submit) and in a copy of the caller's
  context, so spans and the ledger (contextvars) reach it.  Thread-locals
  do not: the segment seams and the scheduler's donation point stay
  outside every closure.

- **Exception classifier** — :func:`classify`: a device fault is a
  type, never a guess from message text alone.  ``oom`` is
  ``torch.cuda.OutOfMemoryError`` or a kernel launch that returned
  ``cudaErrorMemoryAllocation``; ``transient`` is
  ``torch.AcceleratorError``, a ``RuntimeError`` whose text begins
  ``CUDA error`` (torch's own CUDA checks), any other failed kernel
  launch (``ops._build.KernelLaunchError``) and ``OSError`` (the
  failpoints' contract); everything else (a shape bug's ``ValueError``,
  ``IndexError`` or plain ``RuntimeError``) is ``None`` and re-raises
  unwrapped.

- **Cooldown-first re-admission** — a sick domain starts a
  :class:`CooldownProbeLoop` (utils/health.py): wait
  ``DGRAPH_TPU_DEVICE_COOLDOWN_S`` (default 2 s), then re-prove the card
  with one trivial dispatch (``torch.arange(8).sum().item()``) under the
  same watchdog, one probe at a time through :class:`HalfOpenGate`.
  Success re-admits; failure re-opens the cooldown.  After a sticky CUDA
  error (an illegal address, launch failure 719) the context is poisoned
  and every probe fails: the domain stays sick until the process is
  restarted.

No host failover.  The reference lands a faulted dispatch on its host
numpy route and prices a sick domain out of its planner; the port does
neither.  A classified fault raises
:class:`DeviceFaultError` to the caller, which the server answers 503
with ``Retry-After`` (serve/server.py); the per-level expander alone
answers an OOM with LRU eviction and one retry on the card
(query/engine.py ``_run_guarded``).  The one failover is the mesh's: a
level or chain whose mesh dispatch faulted re-plans on the card's
unsharded routes, counted by :func:`count_failover` under
``("unsharded", stats, "mesh")`` and disclosed as ``degraded.device``.

Gate: ``DGRAPH_TPU_DEVGUARD`` (default on).  ``0`` calls every closure
inline on the caller's thread: no worker, no state, no classification.

Observability: ``dgraph_device_state{domain}`` (0 healthy / 1 suspect /
2 sick), ``dgraph_device_faults_total{kind}``,
``dgraph_device_failover_total{route}`` (``evict_retry``, and
``unsharded`` for the mesh),
``dgraph_device_probes_total{outcome}``; ``/health?detail=1`` carries a
``device`` section and ``/debug/device`` a ``guard`` key, both from
:func:`summary`.  Chaos: the ``hang(ms=)`` / ``xla_oom`` failpoint
actions arm at the ``device.*`` dispatch sites and ``devguard.probe``.
"""

from __future__ import annotations

import contextvars
import math
import os
import queue
import re
import sys
import threading
import time
from typing import Callable, Dict, Optional

import torch

from dgraph_tpu_torch.utils.env import env_float
from dgraph_tpu_torch.utils.failpoints import fail
from dgraph_tpu_torch.utils.health import CooldownProbeLoop, HalfOpenGate
from dgraph_tpu_torch.utils.metrics import (
    DEVICE_FAULTS,
    DEVICE_PROBES,
    DEVICE_STATE,
)

HEALTHY, SUSPECT, SICK = "healthy", "suspect", "sick"
_STATE_GAUGE = {HEALTHY: 0, SUSPECT: 1, SICK: 2}

# cudaErrorMemoryAllocation: what a kernel entry point returns when its
# launch could not allocate
CUDA_ERROR_MEMORY_ALLOCATION = 2


def enabled() -> bool:
    """The DGRAPH_TPU_DEVGUARD gate (default on); ``0`` calls every
    guarded closure inline."""
    return os.environ.get("DGRAPH_TPU_DEVGUARD", "1") != "0"


class DeviceFaultError(RuntimeError):
    """A classified device fault at a dispatch seam.  ``kind`` ∈ {hang,
    oom, transient, sick}.  The server answers it 503 with
    ``Retry-After``."""

    def __init__(self, domain: str, op: str, kind: str, detail: str = ""):
        self.domain = domain
        self.op = op
        self.kind = kind
        super().__init__(
            f"device fault [{domain}/{op}]: {kind}"
            + (f" ({detail})" if detail else "")
        )


class DeviceSickError(DeviceFaultError):
    """Shed without dispatch: the domain is latched sick and the
    half-open probe has not re-proved it yet."""

    def __init__(self, domain: str, op: str):
        super().__init__(domain, op, "sick", "awaiting re-admission probe")


class DeviceHangError(DeviceFaultError):
    """The watchdog deadline lapsed with the dispatch still in flight:
    the worker is abandoned, the domain latched sick."""

    def __init__(self, domain: str, op: str, hang_ms: float):
        super().__init__(
            domain, op, "hang", f"no completion within {hang_ms:g}ms"
        )


class ChipFaultError(RuntimeError):
    """A device fault raised inside one chip's share of a mesh dispatch on
    a mesh of distinct cards (``parallel/mesh.py``), tagged ``chip=N``
    for :func:`chip_of`; it classifies as its cause does."""

    def __init__(self, chip: int, cause: BaseException):
        self.chip = int(chip)
        super().__init__(
            f"{type(cause).__name__}: {cause} (chip={int(chip)})"
        )


def classify(exc: BaseException) -> Optional[str]:
    """Sort a dispatch failure by its type: "oom" / "transient" device
    faults, or None for everything that is not the device's fault —
    those re-raise unwrapped."""
    from dgraph_tpu_torch.ops._build import KernelLaunchError

    if isinstance(exc, DeviceFaultError):
        return exc.kind
    if isinstance(exc, ChipFaultError):
        return classify(exc.__cause__) if exc.__cause__ is not None else "transient"
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return "oom"
    if isinstance(exc, KernelLaunchError):
        return "oom" if exc.code == CUDA_ERROR_MEMORY_ALLOCATION else "transient"
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return "transient"
    if type(exc) is RuntimeError and str(exc).startswith("CUDA error"):
        return "transient"
    if isinstance(exc, OSError):
        # injected faults are OSError by the failpoints' contract
        return "transient"
    return None


# chip attribution: a fault whose exception chain names a chip
# ("chip=3": the failpoints' chip= selector, or ChipFaultError) is one
# mesh chip's, which the elastic mesh fault domain (mesh/fault.py) evicts
_CHIP_RE = re.compile(r"\bchip=(\d+)\b")


def chip_of(exc: BaseException) -> Optional[int]:
    """The chip index a dispatch failure names, walking the exception
    chain (a DeviceFaultError wraps the raw error); None when the fault
    cannot be attributed to one chip — a whole-plane fault."""
    seen = set()
    e: Optional[BaseException] = exc
    while e is not None and id(e) not in seen:
        seen.add(id(e))
        m = _CHIP_RE.search(f"{type(e).__name__}: {e}")
        if m:
            return int(m.group(1))
        e = e.__cause__ or e.__context__
    return None


class _Job:
    __slots__ = (
        "fn", "done", "result", "exc", "abandoned", "lock", "_race_serial",
    )
    # the dispatcher creates the job, ONE worker thread writes result/exc
    # exactly once before done.set(), and only the dispatcher flips
    # abandoned (under job.lock) — the lockset witness's single-writer
    # hand-off tolerance must keep this silent
    __race_fields__ = frozenset({"result", "exc", "abandoned"})

    def __init__(self, fn):
        self.fn = fn
        self.done = threading.Event()
        self.result = None
        self.exc: Optional[BaseException] = None
        self.abandoned = False
        self.lock = threading.Lock()


def _caller_stream():
    """The calling thread's current CUDA stream, or None where CUDA is
    not in use yet (a CPU process, or no CUDA call made so far)."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return torch.cuda.current_stream()


def _default_probe() -> None:
    """One trivial dispatch that must round-trip the card: proves the
    runtime answers again after a wedge or a fault storm."""
    fail.point("devguard.probe")
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    torch.arange(8, device=dev).sum().item()


class DeviceGuard:
    """One fault domain's health state, watchdog and probe machinery."""

    # callers, the idle-worker watchdog and the cooldown probe loop all
    # mutate the state machine — every write must carry self._lock
    # (directly or via the caller-holds helpers); the armed lockset
    # witness (analysis/witness.py) checks it
    __race_fields__ = frozenset({
        "state", "_consecutive", "failovers", "probes_ok",
        "probes_failed", "readmissions", "wedged_workers",
    })

    def __init__(
        self,
        domain: str = "device",
        hang_ms: Optional[float] = None,
        cooldown_s: Optional[float] = None,
        sick_after: Optional[int] = None,
        probe_fn: Optional[Callable[[], None]] = None,
        on_readmit: Optional[Callable[[], None]] = None,
    ):
        self.domain = domain
        # fault-attribution sink (the elastic mesh, mesh/fault.py):
        # consulted in run() after classify(); True means a sub-domain
        # (one chip's guard) owns the fault and this guard is not
        # charged — the DeviceFaultError still raises, so the seam can
        # retry under the re-sharded plan.  None: every fault charges it
        self.fault_sink: Optional[
            Callable[[str, str, BaseException], bool]
        ] = None
        # called (outside the state lock) after a probe re-admits this
        # domain: the staged rejoin of a mesh chip
        self.on_readmit = on_readmit
        self.hang_ms = (
            hang_ms
            if hang_ms is not None
            else env_float("DGRAPH_TPU_DEVICE_HANG_MS", 30_000.0)
        )
        self.cooldown_s = (
            cooldown_s
            if cooldown_s is not None
            else env_float("DGRAPH_TPU_DEVICE_COOLDOWN_S", 2.0)
        )
        self.sick_after = int(
            sick_after
            if sick_after is not None
            else env_float("DGRAPH_TPU_DEVICE_SICK_AFTER", 3)
        )
        self._probe_fn = probe_fn or _default_probe
        self._lock = threading.Lock()
        self.state = HEALTHY
        self._consecutive = 0
        self._gate = HalfOpenGate()
        self._closed = False
        self._probe_loop = CooldownProbeLoop(
            self.probe_now,
            self.cooldown_s,
            lambda: self.state == SICK and not self._closed,
            name=f"dgraph-devguard-{domain}",
        )
        # worker pool: idle workers recycle; a wedged one is abandoned
        self._idle: "queue.SimpleQueue[_IdleWorker]" = queue.SimpleQueue()
        self.faults: Dict[str, int] = {}
        self.evict_retries = 0
        self.failovers = 0
        self.probes_ok = 0
        self.probes_failed = 0
        self.readmissions = 0
        self.wedged_workers = 0
        self.last_fault = ""
        self.last_fault_op = ""
        self.last_fault_at = 0.0
        DEVICE_STATE.set(domain, 0)

    # -- state machine ------------------------------------------------------

    def allowed(self) -> bool:
        """May a seam dispatch to this domain now?  Guard off: always."""
        return not enabled() or self.state != SICK

    def check(self, op: str) -> None:
        """Raise :class:`DeviceSickError` when the domain is latched sick
        (guard on): a fused route's up-front check, before it builds
        anything for the card."""
        if not self.allowed():
            raise DeviceSickError(self.domain, op)

    def _set_state(self, state: str) -> None:
        # caller holds self._lock
        if self.state != state:
            self.state = state
            DEVICE_STATE.set(self.domain, _STATE_GAUGE[state])

    def note_fault(self, kind: str, op: str, exc=None) -> None:
        """Record a classified fault.  One wedged dispatch latches sick
        at once; other kinds walk healthy → suspect → sick over
        ``sick_after`` consecutive faults."""
        DEVICE_FAULTS.add(kind)
        start_probe = False
        with self._lock:
            self.faults[kind] = self.faults.get(kind, 0) + 1
            self._consecutive += 1
            self.last_fault = (
                f"{kind}: {type(exc).__name__}: {exc}" if exc is not None
                else kind
            )
            self.last_fault_op = op
            self.last_fault_at = time.monotonic()
            if kind == "hang" or self._consecutive >= self.sick_after:
                if self.state != SICK:
                    print(
                        f"# device fault domain [{self.domain}] latched "
                        f"SICK at {op} ({self.last_fault}); device work "
                        "answers 503 until the re-admission probe, every "
                        f"{self.cooldown_s:g}s",
                        file=sys.stderr,
                    )
                self._set_state(SICK)
                self._gate.open(time.monotonic())
                start_probe = True
            elif self.state == HEALTHY:
                self._set_state(SUSPECT)
        if start_probe and not self._closed:
            self._probe_loop.start()

    def note_ok(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self.state == SUSPECT:
                self._set_state(HEALTHY)

    def note_evict_retry(self) -> None:
        with self._lock:
            self.evict_retries += 1

    def note_failover(self) -> None:
        with self._lock:
            self.failovers += 1

    # -- the watchdog-bracketed dispatch ------------------------------------

    def run(self, op: str, fn: Callable[[], object]):
        """Execute a dispatch-and-fetch closure under this domain's guard.

        Guard off: ``fn()`` inline.  Sick: :class:`DeviceSickError`
        without touching the card.  Otherwise ``fn`` runs on a guard
        worker (the caller's stream and context) with the watchdog
        deadline; overrun abandons the worker, latches sick and raises
        :class:`DeviceHangError`; a classified failure raises
        :class:`DeviceFaultError` (chained), an unclassified one
        re-raises as itself."""
        if not enabled():
            return fn()
        if self.state == SICK:
            raise DeviceSickError(self.domain, op)
        job = self._submit(fn)
        if not job.done.wait(self.hang_ms / 1000.0):
            with job.lock:
                if not job.done.is_set():
                    job.abandoned = True
                    with self._lock:
                        self.wedged_workers += 1
                    self.note_fault("hang", op)
                    raise DeviceHangError(self.domain, op, self.hang_ms)
            # completed inside the race window: fall through to results
        if job.exc is not None:
            kind = classify(job.exc)
            if kind is None:
                raise job.exc  # not a device fault: never masked
            sink = self.fault_sink
            if sink is not None and sink(kind, op, job.exc):
                # one mesh chip owns this fault: the plane stays
                # uncharged, but the seam still hears about it
                raise DeviceFaultError(
                    self.domain, op, kind, str(job.exc)
                ) from job.exc
            self.note_fault(kind, op, job.exc)
            raise DeviceFaultError(
                self.domain, op, kind, str(job.exc)
            ) from job.exc
        self.note_ok()
        return job.result

    def _submit(self, fn) -> _Job:
        ctx = contextvars.copy_context()
        stream = _caller_stream()
        if stream is None:
            job = _Job(lambda: ctx.run(fn))
        else:
            def on_stream():
                with torch.cuda.device(stream.device), torch.cuda.stream(stream):
                    return ctx.run(fn)

            job = _Job(on_stream)
        while True:
            try:
                w = self._idle.get_nowait()
            except queue.Empty:
                w = _IdleWorker(self)
                break
            if w.alive():
                break
        w.inbox.put(job)
        return job

    def _worker_idle(self, w: "_IdleWorker") -> None:
        if self._closed:
            w.inbox.put(None)
        else:
            self._idle.put(w)

    # -- re-admission probe --------------------------------------------------

    def probe_now(self) -> bool:
        """One half-open re-admission probe (the loop calls it; tests may
        too).  Cooldown-first and single-probe via the HalfOpenGate;
        success re-admits the domain."""
        now = time.monotonic()
        with self._lock:
            if self.state != SICK:
                return True
            granted, _retry, token = self._gate.admit(
                now, self.cooldown_s, half_open=False
            )
        if not granted:
            return False
        ok = False
        try:
            job = self._submit(self._probe_fn)
            if job.done.wait(self.hang_ms / 1000.0):
                ok = job.exc is None
            else:
                with job.lock:
                    if not job.done.is_set():
                        job.abandoned = True
                        with self._lock:
                            self.wedged_workers += 1
                    else:
                        ok = job.exc is None
        finally:
            with self._lock:
                self._gate.release(token)
                if ok:
                    self.probes_ok += 1
                    self.readmissions += 1
                    self._consecutive = 0
                    self._set_state(HEALTHY)
                    print(
                        f"# device fault domain [{self.domain}] probe "
                        "succeeded; device RE-ADMITTED",
                        file=sys.stderr,
                    )
                else:
                    self.probes_failed += 1
                    self._gate.open(time.monotonic())
        DEVICE_PROBES.add("ok" if ok else "fail")
        if ok and self.on_readmit is not None:
            # outside self._lock: the staged rejoin (mesh/fault.py) runs
            # warm dispatches and may latch this guard sick again
            try:
                self.on_readmit()
            except Exception as e:  # noqa: BLE001 — a failed rejoin hook
                # must not kill the probe loop; the mesh stays on its
                # surviving sub-mesh until the next probe
                from dgraph_tpu_torch.utils.metrics import note_swallowed

                note_swallowed("devguard.on_readmit", e)
            if self.state == SICK:
                # the hook latched sick again (a failed warm): report
                # un-healed so the probe loop keeps running
                return False
        return ok

    # -- surfaces ------------------------------------------------------------

    def status(self) -> dict:
        with self._lock:
            return {
                "state": self.state,
                "consecutive_faults": self._consecutive,
                "faults": dict(self.faults),
                "evict_retries": self.evict_retries,
                "failovers": self.failovers,
                "probes_ok": self.probes_ok,
                "probes_failed": self.probes_failed,
                "readmissions": self.readmissions,
                "wedged_workers": self.wedged_workers,
                "last_fault": self.last_fault or None,
                "last_fault_op": self.last_fault_op or None,
                "last_fault_age_s": (
                    round(time.monotonic() - self.last_fault_at, 3)
                    if self.last_fault_at else None
                ),
                "hang_ms": self.hang_ms,
                "cooldown_s": self.cooldown_s,
                "sick_after": self.sick_after,
            }

    def close(self) -> None:
        """Stop the probe loop and let every idle worker exit (the
        registry drops this guard).  A wedged worker exits when its
        stuck call returns."""
        self._closed = True
        self._probe_loop.stop(join_s=1.0)
        while True:
            try:
                w = self._idle.get_nowait()
            except queue.Empty:
                return
            w.inbox.put(None)


class _IdleWorker:
    """One reusable dispatch thread.  After each job it returns itself to
    the guard's idle pool, unless the watchdog abandoned the job: then
    the thread exits when the stuck call returns and is never reused.
    An abandoned job writes only its own ``_Job``: the closures return
    plain data, and their callers do every other write."""

    __slots__ = ("inbox", "_thread", "_guard")

    def __init__(self, guard: DeviceGuard):
        self.inbox: "queue.SimpleQueue[Optional[_Job]]" = queue.SimpleQueue()
        self._guard = guard
        self._thread = threading.Thread(
            target=self._loop,
            name=f"dgraph-devguard-{guard.domain}-worker",
            daemon=True,
        )
        self._thread.start()

    def alive(self) -> bool:
        return self._thread.is_alive()

    def _loop(self) -> None:
        while True:
            job = self.inbox.get()
            if job is None:
                return  # the guard closed
            try:
                job.result = job.fn()
            except BaseException as e:  # noqa: BLE001 — transported to
                # the waiting caller verbatim, classified there
                job.exc = e
            # the closure holds its arena and buffers: an idle worker
            # must not keep them alive (an evicted arena's device blocks
            # go back to the allocator only with its last reference)
            job.fn = None
            with job.lock:
                job.done.set()
                abandoned = job.abandoned
            job = None
            if abandoned:
                return  # wedged past the watchdog: never reused
            self._guard._worker_idle(self)


# -- process-wide registry -----------------------------------------------------

_guards_lock = threading.Lock()
_guards: Dict[str, DeviceGuard] = {}


def get(domain: str = "device") -> DeviceGuard:
    """The process-wide guard of one fault domain."""
    with _guards_lock:
        g = _guards.get(domain)
        if g is None:
            g = _guards[domain] = DeviceGuard(domain)
        return g


def ensure(domain: str, **kwargs) -> DeviceGuard:
    """The registry constructor for a guard with non-default wiring
    (``hang_ms``, ``cooldown_s``, ``sick_after``, ``probe_fn``,
    ``on_readmit``: the mesh's per-chip sub-domains).  The
    first caller's kwargs win; later calls return the existing guard
    untouched."""
    with _guards_lock:
        g = _guards.get(domain)
        if g is None:
            g = _guards[domain] = DeviceGuard(domain, **kwargs)
        return g


def count_failover(
    route: str, stats: Optional[dict] = None, domain: str = "device"
) -> None:
    """The one failover bookkeeping sequence every seam shares: the
    per-request stat (the response's ``degraded.device``), the alertable
    series, and the guard's own counter.  The port's one caller is the
    mesh: ``count_failover("unsharded", stats, "mesh")``."""
    from dgraph_tpu_torch.utils.metrics import DEVICE_FAILOVER

    if stats is not None:
        stats["device_failover"] = stats.get("device_failover", 0) + 1
    DEVICE_FAILOVER.add(route)
    get(domain).note_failover()


def summary() -> Dict[str, dict]:
    """Per-domain status for /health?detail=1 and /debug/device."""
    with _guards_lock:
        guards = list(_guards.values())
    return {g.domain: g.status() for g in guards}


def retry_after_s() -> int:
    """The ``Retry-After`` of a device-fault 503: the ceiling of the
    device domain's cooldown, at least 1 s."""
    with _guards_lock:
        g = _guards.get("device")
    cooldown = g.cooldown_s if g is not None else env_float(
        "DGRAPH_TPU_DEVICE_COOLDOWN_S", 2.0
    )
    return max(1, math.ceil(cooldown))


def reset_for_tests() -> None:
    """Drop all guards (fresh state machines, fresh workers), closing
    each: its probe loop ends and its idle workers exit.  Wedged workers
    of an earlier test keep sleeping until their call returns."""
    with _guards_lock:
        guards = list(_guards.values())
        _guards.clear()
    for g in guards:
        DEVICE_STATE.set(g.domain, 0)
        g.close()
