"""Segment seams: the scheduler's yield point inside a query (copy of
``dgraph_tpu/sched/segments.py``).

The reference's fused hop loops dispatch each query as one XLA program,
and segmentation splits that program into bounded k-step segments with
a ``seam()`` between dispatches.  In the port every hop of the fused
loops (``ops.multi_hop``, ``query/chain.py`` ``_run_fused``) is
already its own kernel launch, so a seam is one call between two
iterations of those loops, every k hops where :func:`plan` returns
k > 0.  One seam does three things, in order:

1. **failpoint** — ``fail.point("segment.seam")`` so tests can inject a
   per-segment delay;
2. **cancellation** — probe the request's ``CancelToken``: a deadline
   lapse or client disconnect surfaces within ONE segment;
3. **preemption** — invoke the scheduler's donation hook: when a
   strictly higher-priority cohort is queued, the running worker drains
   it inline at this seam (sched/scheduler.py ``_maybe_preempt``).

The context is thread-local and activated by the scheduler around
``engine.run_parsed`` (token + preempt hook + stats), or by the engine
itself token-only when no scheduler is driving.  ``seam()`` with no
active context is a cheap no-op.  ``early_exit`` counts a segmented
loop (a mask chain of ``query/joinplan.py``, a mesh multi-hop) that
stopped at a drained frontier; ``resume`` counts a mesh query's
drain-and-resume across an epoch flip (``mesh/executor.py``).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from dgraph_tpu_torch.utils.failpoints import fail
from dgraph_tpu_torch.utils.metrics import (
    QUERY_RESUMED,
    SEGMENT_DISPATCHES,
    SEGMENT_YIELDS,
)

_tls = threading.local()


class SegmentContext:
    """Per-request yield-point wiring: the cancel token to probe at each
    seam, the scheduler's preemption-donation hook, and the request's
    stats dict."""

    __slots__ = ("token", "preempt", "stats")

    def __init__(
        self,
        token=None,
        preempt: Optional[Callable[[], None]] = None,
        stats: Optional[dict] = None,
    ):
        self.token = token
        self.preempt = preempt
        self.stats = stats


def activate(ctx: Optional[SegmentContext]) -> Optional[SegmentContext]:
    """Install ``ctx`` as this thread's active context; returns the
    PREVIOUS one so callers restore it in a finally — preemption
    donation runs a whole other query inline on the donor's thread, and
    the donor's context must survive it."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prev


def deactivate(prev: Optional[SegmentContext] = None) -> None:
    _tls.ctx = prev


def current() -> Optional[SegmentContext]:
    return getattr(_tls, "ctx", None)


def seam(loop: str) -> None:
    """One scheduler yield point, called by a fused hop loop BETWEEN
    segments (never before the first or after the last).

    Order matters: cancellation first (a dead query must not donate its
    slot to drain someone else's cohort), preemption second.  A token
    raise propagates — the loop's partial device state is simply
    dropped with the query."""
    fail.point("segment.seam")
    ctx = current()
    if ctx is None:
        return
    tok = ctx.token
    if tok is not None:
        try:
            tok.check()
        except BaseException:
            SEGMENT_YIELDS.add("cancel")
            raise
    if ctx.preempt is not None:
        ctx.preempt()


def early_exit(loop: str) -> None:
    """Record an early exit: the frontier drained mid-chain, and the
    remaining segments are never dispatched."""
    SEGMENT_YIELDS.add("early_exit")


def resume(loop: str, reason: str) -> None:
    """Record one drain-and-resume of the elastic mesh fault domain
    (mesh/fault.py): an in-flight mesh query observed an epoch flip at a
    seam, or lost its chip mid-segment, and continued from its host
    carry under the new sub-mesh.  ``reason`` ∈ ``epoch`` (flip seen at a
    seam), ``loss`` (its own dispatch hit the evicted chip), ``hang``
    (wedged dispatch: the remaining hops finished unsharded on the
    card).  Counted in ``dgraph_query_resumed_total{reason}`` and the
    request's ``stats["resumed"]``."""
    QUERY_RESUMED.add(reason)
    ctx = current()
    if ctx is not None and ctx.stats is not None:
        r = ctx.stats.setdefault("resumed", {})
        r[reason] = r.get(reason, 0) + 1


def plan(n_steps: int, est_step_units: int, loop: str) -> int:
    """The segment size for one run of a fused hop loop
    (planner.segment_route): k hops between seams, 0 = no seam at all.
    Records a priced decision into the active request's stats and counts
    the segmented runs."""
    from dgraph_tpu_torch.query import planner

    k, dec = planner.segment_route(n_steps, est_step_units, loop)
    if dec is not None:
        ctx = current()
        planner.record(ctx.stats if ctx is not None else None, dec)
    if k > 0:
        SEGMENT_DISPATCHES.add(loop)
    return k
