"""Cohort formation: cross-request admission queues + hop merging (copy
of ``dgraph_tpu/sched/cohort.py``).

This module supplies the two data-plane pieces of the cohort scheduler
(sched/scheduler.py):

- **Admission signatures** (`hop_signature`): concurrent requests whose
  hop programs would compile to the same shape family — same predicate
  set, same hop depth, same bucketed root capacity, same store snapshot
  version — queue into one cohort (the shape-bucketing half of
  continuous batching in inference servers).

- **`HopMerger`**: the device-dispatch half.  Cohort members execute
  concurrently; every per-level expansion routes through
  `DeviceExpander.submit_hop`, which rendezvouses same-(arena,
  predicate, direction) expansions from different requests here.  The
  first arrival leads: it waits a short window (or until every live
  cohort member has joined), expands ONE union frontier through the
  engine's normal routing, and deals each member its exact per-source
  segments back.  K same-hop requests become one gather launch — the
  "traverse many sources as one matrix op" shape, applied across
  users.

Merging is exact, not approximate: CSR expansion is deterministic per
row, so slicing a member's rows out of the union expansion yields
byte-identical (out_flat, seg_ptr) to a solo expansion.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from dgraph_tpu_torch.utils.metrics import SCHED_MERGED_HOPS


class SchedOverloadError(RuntimeError):
    """Admission queue over capacity: shed (HTTP 429 / RESOURCE_EXHAUSTED)."""


class SchedQuotaError(SchedOverloadError):
    """Per-TENANT admission quota exceeded (sched/qos.py): shed before
    the global cap, with a tenant-scoped Retry-After — the tenant's own
    backlog sizes the hint, not the server-wide queue.  Subclasses
    SchedOverloadError so every existing 429/RESOURCE_EXHAUSTED mapping
    keeps working; handlers that know about QoS add the header."""

    def __init__(self, msg: str, tenant: str, retry_after: float):
        super().__init__(msg)
        self.tenant = tenant
        self.retry_after = retry_after


class SchedDeadlineError(RuntimeError):
    """Request budget expired while queued (HTTP 504 / DEADLINE_EXCEEDED)."""


def _bucket_pow2(n: int, floor: int = 16) -> int:
    """Power-of-two capacity bucket (ops.bucket's scheme): admission
    keys must be computable before any device work."""
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


def hop_signature(parsed, store_version: int) -> tuple:
    """Hop-program signature of a parsed request: requests with equal
    signatures ride one cohort and share one compiled shape family.

    Components: store snapshot version (mutations between enqueues MUST
    split cohorts — members of one cohort share the read-locked arena
    snapshot), sorted predicate set, root function names, hop count
    (max tree depth), and the bucketed root uid capacity (explicit uid
    lists bucket pow2, so `uid(0x1)` and `uid(0x2)` coalesce while a
    4096-uid seed list does not drag single-uid lookups into its
    shapes)."""
    preds: set = set()
    funcs: List[str] = []
    depth = 0
    root_uids = 0

    def walk(q, d: int) -> None:
        nonlocal depth
        depth = max(depth, d)
        for c in q.children:
            if c.attr:
                preds.add(c.attr)
            walk(c, d + 1)

    for q in parsed.queries:
        if q.func is not None:
            funcs.append(q.func.name)
            if q.func.attr:
                preds.add(q.func.attr)
            root_uids = max(
                root_uids, len(getattr(q.func, "uid_args", ()) or ())
            )
        if q.uid_list:
            root_uids = max(root_uids, len(q.uid_list))
        walk(q, 0)
    return (
        int(store_version),
        tuple(sorted(preds)),
        tuple(sorted(funcs)),
        depth,
        _bucket_pow2(root_uids) if root_uids else 0,
        parsed.schema_request is not None,
    )


class SchedRequest:
    """One admitted request: parsed query + completion future.

    ``key`` identifies the request TEXT (query + canonical vars + debug
    flag): cohort members with equal keys are the same deterministic
    computation, so a flush runs one of them and deals the result to
    the rest (singleflight, the groupcache thundering-herd move —
    exactly what a hot query under zipf traffic needs)."""

    __slots__ = (
        "parsed", "debug", "deadline", "enqueued", "key",
        "_done", "result", "stats", "error", "span", "queue_span",
        "tenant", "cancel", "ledger", "slot_held", "slot_released",
    )

    def __init__(self, parsed, debug: bool = False,
                 deadline: Optional[float] = None, key=None,
                 tenant: str = "", cancel=None):
        self.parsed = parsed
        self.debug = debug
        self.deadline = deadline          # absolute time.monotonic(), or None
        self.enqueued = time.monotonic()
        self.key = key                    # None = never coalesce
        # multi-tenant QoS (sched/qos.py): the admission scope ("" when
        # QoS is off — then neither field is ever read) and the
        # cooperative CancelToken the engine checkpoints against
        self.tenant = tenant
        self.cancel = cancel
        self._done = threading.Event()
        self.result: Optional[dict] = None
        self.stats: Optional[dict] = None
        self.error: Optional[BaseException] = None
        # flight recorder (obs/spans.py): ``span`` is the admitting
        # request's root span (None when unsampled — the common case),
        # carried across the handler→flush-worker thread hop so
        # execution re-roots under the right trace; ``queue_span``
        # covers admission→execution and is finished by whoever decides
        # this request's fate — execution, shed, or singleflight dealing
        self.span = None
        self.queue_span = None
        # per-query resource ledger (obs/ledger.py): the admitting
        # request's account, re-activated on whichever flush worker
        # executes it
        self.ledger = None
        # per-request tenant max_inflight accounting: slot_held
        # is set when the cohort pop reserves this member's in-flight
        # slot; slot_released makes the release idempotent so a deadline
        # lapse detected at a segment seam can free the slot BEFORE the
        # 504 surfaces without the flush finally double-releasing it
        self.slot_held = False
        self.slot_released = False

    def expired(self, now: Optional[float] = None) -> bool:
        return self.deadline is not None and (
            (time.monotonic() if now is None else now) >= self.deadline
        )

    def end_queue_wait(self, outcome: str) -> None:
        """Close the queue-wait span; first closer's outcome wins
        (execution start beats the completion fallback)."""
        qs = self.queue_span
        if qs is not None and qs.t1 is None:
            qs.set_attr("outcome", outcome)
            qs.finish()

    def complete(self, result: dict, stats: dict) -> None:
        self.end_queue_wait("done")
        self.result = result
        self.stats = stats
        self._done.set()

    def fail(self, exc: BaseException) -> None:
        self.end_queue_wait(type(exc).__name__)
        self.error = exc
        self._done.set()

    def wait(self) -> Tuple[dict, dict]:
        """Block until executed; raises the execution error if any."""
        self._done.wait()
        if self.error is not None:
            raise self.error
        return self.result, self.stats


class Cohort:
    """Requests sharing one hop-program signature (and, under QoS, one
    tenant — fairness picks BETWEEN tenants, so cohorts never mix
    scopes), awaiting a flush."""

    __slots__ = ("sig", "reqs", "born", "tenant")

    def __init__(self, sig: tuple, tenant: str = ""):
        self.sig = sig
        self.reqs: List[SchedRequest] = []
        self.born = time.monotonic()
        self.tenant = tenant


# ---------------------------------------------------------------- merging


class _MergeGroup:
    __slots__ = ("entries", "results", "error", "done", "closed")

    def __init__(self):
        self.entries: List[np.ndarray] = []
        self.results: Optional[List] = None
        self.error: Optional[BaseException] = None
        self.done = threading.Event()
        self.closed = False


def _deal_union(entries: List[np.ndarray], expand_fn: Callable):
    """Expand the union frontier once, slice each member's segments back.

    ``expand_fn(union)`` must return the engine's (out_flat, seg_ptr)
    uid-matrix layout for a sorted-ascending frontier; each member's
    rows gather their exact segments from it (CSR expansion is
    deterministic per row, so this is byte-identical to solo runs)."""
    union = np.unique(np.concatenate(entries))
    u_out, u_seg = expand_fn(union)
    u_seg = np.asarray(u_seg, dtype=np.int64)
    out = []
    for src in entries:
        idx = np.searchsorted(union, src)
        degs = u_seg[idx + 1] - u_seg[idx]
        starts = u_seg[idx]
        seg_ptr = np.zeros(len(src) + 1, dtype=np.int64)
        np.cumsum(degs, out=seg_ptr[1:])
        total = int(seg_ptr[-1])
        within = np.arange(total, dtype=np.int64) - np.repeat(
            seg_ptr[:-1], degs
        )
        out.append((u_out[np.repeat(starts, degs) + within], seg_ptr))
    return out


class HopMerger:
    """Rendezvous point for one cohort's per-hop expansions.

    ``expected`` tracks how many cohort members are still executing; a
    group whose entry count reaches it fires immediately (no window
    wait), and `leave()` shrinks it as members finish so stragglers
    never stall on peers that already completed.  Every wait is
    time-bounded — a member that misses its rendezvous merely expands
    solo, it never hangs."""

    def __init__(self, expected: int, window_s: float = 0.001):
        self._cond = threading.Condition()
        self._groups: Dict[tuple, _MergeGroup] = {}
        self._expected = max(1, int(expected))
        self.window_s = float(window_s)
        self.merged_dispatches = 0  # device programs saved (observability)

    def leave(self) -> None:
        """One member finished: shrink the rendezvous quorum."""
        with self._cond:
            self._expected = max(1, self._expected - 1)
            self._cond.notify_all()

    def submit(self, key: tuple, src: np.ndarray, expand_fn: Callable):
        """Join (or lead) the merge group for ``key``; returns this
        member's (out_flat, seg_ptr).  ``expand_fn`` runs ONCE per
        group, over the union frontier."""
        src = np.asarray(src)
        with self._cond:
            g = self._groups.get(key)
            if g is None or g.closed:
                g = _MergeGroup()
                self._groups[key] = g
                leader = True
            else:
                leader = False
            idx = len(g.entries)
            g.entries.append(src)
            if len(g.entries) >= self._expected:
                g.closed = True
                if self._groups.get(key) is g:
                    del self._groups[key]
                self._cond.notify_all()
        if leader:
            stop = time.monotonic() + self.window_s
            with self._cond:
                while not g.closed and len(g.entries) < self._expected:
                    left = stop - time.monotonic()
                    if left <= 0:
                        break
                    self._cond.wait(left)
                g.closed = True
                if self._groups.get(key) is g:
                    del self._groups[key]
                entries = list(g.entries)
            try:
                if len(entries) == 1:
                    g.results = [expand_fn(entries[0])]
                else:
                    g.results = _deal_union(entries, expand_fn)
                    saved = len(entries) - 1
                    self.merged_dispatches += saved
                    SCHED_MERGED_HOPS.add(saved)
            except BaseException as e:  # noqa: BLE001 — propagate to every member
                g.error = e
            finally:
                g.done.set()
        elif not g.done.wait(timeout=600.0):
            # leader died (should not happen): never hang — expand solo
            return expand_fn(src)
        if g.error is not None:
            raise g.error
        return g.results[idx]
