"""Continuous micro-batching of concurrent read queries onto the engine
(copy of ``dgraph_tpu/sched/scheduler.py``).

`CohortScheduler` sits between the serving surface (serve/server.py)
and the query engine.  Eligible requests — pure
reads; mutations keep their exclusive write-lock path untouched — are
admitted into shape-bucketed cohorts (sched/cohort.py) instead of
grabbing the read lock one by one, the way continuous batching fills
the batch axis in modern inference serving.

A cohort flushes on the first of three triggers (each flush records its
reason in `dgraph_sched_flushes_total{reason=...}`):

- **full** — the cohort reached ``max_batch`` members;
- **deadline** — its oldest member has waited ``flush_ms``;
- **idle** — no new request arrived for an idle beat, so waiting longer
  cannot grow any cohort (a lone client must not eat the full flush
  deadline per query).

Flushes execute on a BOUNDED worker pool (``DGRAPH_TPU_SCHED_CONCURRENCY``,
default 2) — the property that makes the batching *continuous*: while
the workers chew the current cohorts, new arrivals accumulate into the
next ones instead of each grabbing its own handler thread.

A flush takes the engine read lock ONCE for the whole cohort, runs
each member on its own engine shell over the shared arena cache, and
hands every shell one `HopMerger` — same-shape hops from different
requests coalesce into one gather launch (`DeviceExpander.submit_hop`).
Member threads enqueue on the one current CUDA stream they share: the
gather is a cooperative launch sized for the whole card, and two of
them on separate streams could not be co-resident.
IDENTICAL requests (same text/vars/debug) go further and singleflight:
one execution serves every twin, whether queued in the same cohort or
already executing over the same store snapshot — under zipf traffic the
hot queries are exactly where the duplicates are.

Admission control: a bounded queue (``queue_cap``); requests over
capacity shed immediately (`SchedOverloadError` → HTTP 429), and requests whose deadline lapses while queued
shed with `SchedDeadlineError` (→ HTTP 504)
instead of rotting in a cohort queue.

In FRONT of admission sits the tier-2 result cache (cache/result.py):
a repeat request over an unchanged store snapshot returns its memoized
response without queueing, cohort-waiting, or touching the engine at
all — singleflight's reuse window (while a twin is in flight) extended
to the whole mutation epoch.  Gated by ``DGRAPH_TPU_CACHE`` (default
on; ``0`` restores today's path byte-identically).

Admission is load-adaptive by default: while the planner is on
(``DGRAPH_TPU_PLANNER``) and neither knob is pinned, cohort size and the
flush deadline track measured queue wait and occupancy inside hard
bounds — [base, 8×base×mesh width] members, [base/8, base] deadline —
through ``query/planner.py::CohortController`` (its state at
``/debug/planner``).  Responses never depend on either knob; pinning
one (env or constructor argument) keeps the static values.

Multi-tenant QoS (sched/qos.py): requests carry a tenant scope
(``X-Dgraph-Tenant``; absent = ``default``).  Admission
enforces per-tenant queue quotas (429 + tenant-scoped Retry-After)
BEFORE the global cap, cohort pick becomes a weighted-fair
deficit-round-robin across tenants so one tenant's flood cannot starve
another's flush slots, per-tenant in-flight caps bound execution
concurrency, and every request carries a ``CancelToken`` the engine
checkpoints between hops — deadline lapse and client disconnect stop
a query at its next checkpoint.
``DGRAPH_TPU_QOS=0`` restores this docstring's pre-QoS behavior
byte-identically.

Knobs (env): ``DGRAPH_TPU_SCHED`` (gate, default on; ``0`` restores the
serial per-request path byte-identically), ``DGRAPH_TPU_SCHED_MAX_BATCH``
(default 32), ``DGRAPH_TPU_SCHED_FLUSH_MS`` (default 2.0),
``DGRAPH_TPU_SCHED_QUEUE_CAP`` (default 256),
``DGRAPH_TPU_SCHED_MERGE_MS`` (hop-merge window, default 1.0),
``DGRAPH_TPU_SCHED_CONCURRENCY`` (flush workers, default 2),
``DGRAPH_TPU_CACHE`` / ``DGRAPH_TPU_CACHE_RESULT_BYTES`` (tier-2 result
cache gate and byte budget, cache/result.py).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional

from dgraph_tpu_torch import ivm as _ivm
from dgraph_tpu_torch import obs
from dgraph_tpu_torch.obs import ledger as _ledgermod
from dgraph_tpu_torch.query import planner as _planner
from dgraph_tpu_torch.sched import qos as _qos
from dgraph_tpu_torch.sched import segments as _segments
from dgraph_tpu_torch.sched.cohort import (
    Cohort,
    HopMerger,
    SchedDeadlineError,
    SchedOverloadError,
    SchedQuotaError,
    SchedRequest,
    hop_signature,
)
from dgraph_tpu_torch.utils import planconfig as _planconfig
from dgraph_tpu_torch.utils.env import env_float as _env_f
from dgraph_tpu_torch.utils.failpoints import fail
from dgraph_tpu_torch.utils.metrics import (
    SCHED_COALESCED,
    SCHED_COHORT_OCCUPANCY,
    SCHED_FLUSHES,
    SCHED_QUEUE_DEPTH,
    SCHED_QUEUE_WAIT,
    SCHED_SHED,
    SEGMENT_PREEMPT_US,
    SEGMENT_YIELDS,
    TENANT_SHED,
)


def sched_enabled() -> bool:
    """The DGRAPH_TPU_SCHED gate (default ON)."""
    return os.environ.get("DGRAPH_TPU_SCHED", "1") != "0"


class CohortScheduler:
    """Owns the admission queues and the flush loop for one server."""

    # the armed lockset witness (analysis/witness.py) checks every write
    # to these scalars carries _cond (the adaptive knobs are the seeded
    # regression — they were once bare stores)
    __race_fields__ = frozenset({
        "_depth", "_flushes", "_last_arrival", "_stopped",
        "max_batch", "flush_s",
    })

    def __init__(
        self,
        server,
        max_batch: Optional[int] = None,
        flush_ms: Optional[float] = None,
        queue_cap: Optional[int] = None,
        merge_ms: Optional[float] = None,
        concurrency: Optional[int] = None,
    ):
        self._server = server
        # tier-2 result cache (cache/result.py): probed before admission
        # in run(); None when DGRAPH_TPU_CACHE=0 (or zero budget) — the
        # admission path is then byte-identical to the pre-cache code
        from dgraph_tpu_torch.cache import ResultCache, cache_enabled

        self.result_cache = ResultCache() if cache_enabled() else None
        self.max_batch = int(
            max_batch
            if max_batch is not None
            else _env_f("DGRAPH_TPU_SCHED_MAX_BATCH", 32)
        )
        self.flush_s = (
            flush_ms if flush_ms is not None
            else _env_f("DGRAPH_TPU_SCHED_FLUSH_MS", 2.0)
        ) / 1e3
        self.queue_cap = int(
            queue_cap
            if queue_cap is not None
            else _env_f("DGRAPH_TPU_SCHED_QUEUE_CAP", 256)
        )
        self.merge_window_s = (
            merge_ms if merge_ms is not None
            else _env_f("DGRAPH_TPU_SCHED_MERGE_MS", 1.0)
        ) / 1e3
        # idle trigger beat: how long "no arrivals" must last before
        # pending cohorts flush early; a fraction of the flush deadline
        self.idle_beat_s = max(self.flush_s / 8.0, 1e-4)
        self._cond = threading.Condition()
        # admission queues keyed (tenant, hop-signature): cohorts never
        # mix tenants, so the weighted-fair pick below chooses BETWEEN
        # scopes while shape bucketing keeps working inside each.  With
        # QoS off the tenant slot is "" for every key and all QoS
        # machinery is byte-invisible.
        self._queues: Dict[tuple, Cohort] = {}
        self._depth = 0
        self._last_arrival = 0.0  # monotonic time of the newest admit
        self._stopped = False
        self._flushes = 0   # total cohort flushes (tests/bench introspection)
        # multi-tenant QoS (sched/qos.py): per-tenant admission quotas,
        # deficit-round-robin cohort pick, and per-tenant in-flight caps.
        # None when DGRAPH_TPU_QOS=0 — the whole layer then costs one
        # None check per decision and the serving path is byte-identical
        self.qos = _qos.QosConfig.from_env() if _qos.qos_enabled() else None
        self._drr = _qos.DrrPicker()
        self._tenant_depth: Dict[str, int] = {}    # admitted − completed
        self._tenant_inflight: Dict[str, int] = {}  # executing right now
        # singleflight across EXECUTION, not just the queue window:
        # key -> [store_version, leader SchedRequest, [attached reqs]].
        # An identical request arriving while its twin executes attaches
        # and shares the result — the dedup window becomes the whole
        # service time, which under zipf traffic is where the duplicates
        # actually are.
        self._inflight: Dict[object, list] = {}
        # segmented preemption: per-thread donation depth — a
        # worker draining a higher-priority cohort at a segment seam
        # must not preempt AGAIN from inside the donated flush (the
        # critical query's own seams would otherwise recurse)
        self._donation = threading.local()
        # load-adaptive cohort admission (query/planner.py): armed only
        # when the planner is on and neither knob is pinned — an env
        # value or a constructor argument is an operator override
        self._adaptive = None
        if (
            _planner.enabled()
            and max_batch is None
            and flush_ms is None
            and not _planconfig.overridden("DGRAPH_TPU_SCHED_MAX_BATCH")
            and not _planconfig.overridden("DGRAPH_TPU_SCHED_FLUSH_MS")
        ):
            # the ceiling scales with the mesh width: N chips drain one
            # merged cohort frontier
            self._adaptive = _planner.CohortController(
                self.max_batch, self.flush_s, width=self._mesh_width()
            )
        n_workers = int(
            concurrency
            if concurrency is not None
            else _env_f("DGRAPH_TPU_SCHED_CONCURRENCY", 2)
        )
        self._workers = [
            threading.Thread(
                target=self._worker_loop, name=f"dgraph-sched-{i}",
                daemon=True,
            )
            for i in range(max(1, n_workers))
        ]
        for t in self._workers:
            t.start()

    # -- admission ---------------------------------------------------------

    def run(
        self,
        parsed,
        debug: bool = False,
        timeout_s: Optional[float] = None,
        key=None,
        tenant: str = "",
        cancel=None,
    ):
        """Admit a read-only parsed request and block until its cohort
        executed.  ``key`` (query text + canonical vars + debug) enables
        singleflight AND tier-2 result caching: equal-key cohort members
        execute once, and a repeat of an already-executed key over the
        same store snapshot skips admission entirely.  ``tenant`` /
        ``cancel`` are the QoS scope and CancelToken (sched/qos.py; ""
        and None when QoS is off).  Returns (response dict, engine
        stats); raises SchedOverloadError / SchedQuotaError /
        SchedDeadlineError on shed and QueryCancelledError on a flipped
        token."""
        # cancel-before-admission: a token that already flipped (client
        # vanished in transit, admin raced the request) does no work at
        # all — no cache probe, no admission bookkeeping
        if cancel is not None:
            cancel.check()
        # This read feeds the ADMISSION signature (snapshot bucketing for
        # cohorts + singleflight), never a cache key — the tier-2 key
        # below is predicate-scoped through ivm/versions.py.
        # graftlint: ignore[naked-version-key]
        store_ver = getattr(self._server.store, "version", None)
        sig = hop_signature(parsed, store_ver or 0)
        # tier-2 probe BEFORE admission: the version in the key is
        # captured pre-execution, so a racing mutation can only strand
        # an entry under an old version — never serve stale.  The key
        # version is SCOPED to the request's referenced-predicate
        # footprint (ivm/versions.py): a mutation to a predicate this
        # request never reads leaves its entry a hit (DGRAPH_TPU_IVM=0
        # restores the bare global version).  A store with NO version
        # has no mutation epoch to key under, and a store whose version
        # is not STRICT must never cache.
        rc_key = rc_ver = None
        rc = self.result_cache
        if (
            rc is not None
            and key is not None
            and store_ver is not None
            and getattr(self._server.store, "strict_snapshot_versions", False)
        ):
            from dgraph_tpu_torch.cache import cacheable

            if cacheable(parsed):
                rc_key = key
                rc_ver = _ivm.result_version(self._server.store, parsed)
                hit = rc.get(rc_key, rc_ver)
                if hit is not None:
                    return hit
        # timeout_s None = no budget; <= 0 = budget ALREADY spent
        # (X-Dgraph-Timeout: 0) — that sheds immediately rather than
        # silently running unbounded
        deadline = (
            time.monotonic() + max(timeout_s, 0.0)
            if timeout_s is not None
            else None
        )
        req = SchedRequest(
            parsed, debug=debug, deadline=deadline, key=key,
            tenant=tenant, cancel=cancel,
        )
        sp = obs.current_span()
        if sp is not None:
            # sampled: carry the request's root across the thread hop to
            # the flush worker, and open the queue-wait span HERE — the
            # admission→execution gap the latency map files under an
            # undifferentiated "processing"
            req.span = sp
            req.queue_span = sp.child("sched.queue")
        # the resource ledger rides the same thread hop as the span: the
        # handler thread owns it again once wait() returns (single-writer
        # hand-off)
        req.ledger = _ledgermod.current()
        try:
            self._admit(req, sig, key)
        except SchedOverloadError:
            # the queue-wait span opened above must land in the trace
            # with the shed verdict, not leak unfinished
            req.end_queue_wait("shed_overload")
            raise
        result, stats = req.wait()
        if rc_key is not None:
            # sharing the response dict is safe by the singleflight
            # argument: handlers only encode results, never mutate them
            rc.put(rc_key, rc_ver, result, stats)
        return result, stats

    def _admit(self, req: SchedRequest, sig: tuple, key) -> None:
        with self._cond:
            if self._stopped:
                raise SchedOverloadError("scheduler stopped")
            if self.qos is not None:
                # per-TENANT quota BEFORE the global cap: an antagonist
                # tenant hits its own envelope and sheds with a
                # tenant-scoped Retry-After while everyone else's
                # admission headroom stays untouched
                cfg = self.qos.tenant(req.tenant)
                td = self._tenant_depth.get(req.tenant, 0)
                if cfg.max_queued > 0 and td >= cfg.max_queued:
                    SCHED_SHED.add("tenant_quota")
                    TENANT_SHED.add(
                        (_qos.metric_label(req.tenant), "quota")
                    )
                    # sized to THIS tenant's backlog: roughly how long
                    # until its queued work drains through the cohort
                    # machinery, never the server-wide queue depth
                    ra = max(self.flush_s, 1e-3) * (
                        1.0 + td / max(1, self.max_batch)
                    )
                    raise SchedQuotaError(
                        f"tenant {req.tenant!r} over admission quota "
                        f"({td}/{cfg.max_queued} queued)",
                        tenant=req.tenant,
                        retry_after=ra,
                    )
            if self._depth >= self.queue_cap:
                SCHED_SHED.add("overload")
                if self.qos is not None:
                    TENANT_SHED.add(
                        (_qos.metric_label(req.tenant), "overload")
                    )
                raise SchedOverloadError(
                    f"admission queue over capacity ({self.queue_cap})"
                )
            ent = self._inflight.get(key) if key is not None else None
            if ent is not None and ent[0] == sig[0]:
                # an identical request is executing over the same
                # snapshot right now: attach and share its result
                ent[2].append(req)
                self._note_admitted(req)
                SCHED_QUEUE_DEPTH.set(self._depth)
                SCHED_COALESCED.add(1)
            else:
                qkey = (req.tenant, sig)
                c = self._queues.get(qkey)
                if c is None:
                    c = self._queues[qkey] = Cohort(sig, tenant=req.tenant)
                c.reqs.append(req)
                self._note_admitted(req)
                self._last_arrival = time.monotonic()
                SCHED_QUEUE_DEPTH.set(self._depth)
                self._cond.notify_all()

    # -- per-tenant bookkeeping (callers hold self._cond) -------------------

    def _note_admitted(self, req: SchedRequest) -> None:
        self._depth += 1
        if self.qos is not None:
            self._tenant_depth[req.tenant] = (
                self._tenant_depth.get(req.tenant, 0) + 1
            )

    def _release_inflight(self, tenant: str, n: int) -> None:
        """Release reserved in-flight slots (caller holds self._cond).
        A tenant leaving its cap may unblock a due cohort a worker
        skipped over — hence the notify."""
        left = self._tenant_inflight.get(tenant, 0) - n
        if left > 0:
            self._tenant_inflight[tenant] = left
        else:
            self._tenant_inflight.pop(tenant, None)
        self._cond.notify_all()

    def _release_req_slot_locked(self, req: SchedRequest) -> None:
        """Release ONE member's reserved in-flight slot, idempotently
        (caller holds self._cond).  Per-request accounting: a
        deadline lapse or cancellation detected at a segment SEAM frees
        the slot right there — before the 504/499 surfaces — instead of
        in _flush's finally after the rest of the cohort drains; the
        finally's sweep then skips the already-released members."""
        if self.qos is None or not req.slot_held or req.slot_released:
            return
        req.slot_released = True
        self._release_inflight(req.tenant, 1)

    def _release_req_slot(self, req: SchedRequest) -> None:
        with self._cond:
            self._release_req_slot_locked(req)

    def _note_done(self, reqs) -> None:
        """Depth bookkeeping for requests leaving the scheduler (shed,
        completed, or dealt a twin's result)."""
        self._depth -= len(reqs)
        if self.qos is None:
            return
        for r in reqs:
            left = self._tenant_depth.get(r.tenant, 0) - 1
            if left > 0:
                self._tenant_depth[r.tenant] = left
            else:
                self._tenant_depth.pop(r.tenant, None)

    # -- flush workers -----------------------------------------------------

    def _worker_loop(self) -> None:
        while True:
            cohort, reason = self._next_cohort()
            if cohort is None:
                return
            self._flush(cohort, reason)

    def _next_cohort(self):
        """Block until some cohort is due, pop and return it.  Priority:
        full > deadline-expired > idle (oldest first).  Under QoS,
        cohorts due in the same class are chosen by a weighted-fair
        (deficit round-robin) pick ACROSS tenants — so a flood from one
        tenant earns flush slots only in proportion to its weight — and
        tenants at their in-flight cap are skipped until a slot frees.
        While every worker is busy flushing, pending cohorts keep
        accumulating members — that accumulation IS the continuous
        batching."""
        with self._cond:
            while True:
                if self._stopped:
                    return None, None
                now = time.monotonic()
                due = self._due_cohort(now)
                if due is not None:
                    key, reason = due
                    cohort = self._queues.pop(key)
                    if self.qos is not None:
                        # reserve the in-flight slots HERE, in the same
                        # lock hold as the admissibility check — a
                        # second worker deciding before _flush ran
                        # would otherwise see stale inflight and grant
                        # the tenant workers×cap concurrency
                        self._tenant_inflight[cohort.tenant] = (
                            self._tenant_inflight.get(cohort.tenant, 0)
                            + len(cohort.reqs)
                        )
                        for r in cohort.reqs:
                            r.slot_held = True
                    return cohort, reason
                if not self._queues:
                    self._cond.wait()
                else:
                    oldest = min(c.born for c in self._queues.values())
                    wait = min(
                        oldest + self.flush_s - now,
                        self._last_arrival + self.idle_beat_s - now,
                    )
                    if wait <= 0:
                        # everything due is held back by a tenant
                        # in-flight cap: the cap release notifies this
                        # condition, so the timed wait is only a
                        # bounded fallback — never a spin
                        wait = self.idle_beat_s
                    self._cond.wait(max(wait, 1e-4))

    def _due_cohort(self, now: float):
        """(queue key, reason) of the cohort to flush now, or None.
        Caller holds self._cond."""
        full, expired = [], []
        for key, c in self._queues.items():
            if len(c.reqs) >= self.max_batch:
                full.append(key)
            elif now - c.born >= self.flush_s:
                expired.append(key)
        key = self._choose(full)
        if key is not None:
            return key, "full"
        key = self._choose(expired)
        if key is not None:
            return key, "deadline"
        if self._queues and now - self._last_arrival >= self.idle_beat_s:
            # idle beat: the system is quiet, fairness is moot — flush
            # the oldest pending cohort (legacy behavior), unless its
            # tenant is at its in-flight cap
            key = min(self._queues, key=lambda k: self._queues[k].born)
            if self._tenant_admissible(key[0]):
                return key, "idle"
        return None

    def _tenant_admissible(self, tenant: str) -> bool:
        if self.qos is None:
            return True
        cap = self.qos.tenant(tenant).max_inflight
        return cap <= 0 or self._tenant_inflight.get(tenant, 0) < cap

    def _choose(self, keys):
        """Pick one due queue key out of ``keys``.  QoS off: the first
        in iteration (insertion) order — the legacy scan's choice,
        byte-identical.  QoS on: drop tenants at their in-flight cap,
        DRR-pick a tenant by weight, then that tenant's oldest cohort."""
        if not keys:
            return None
        if self.qos is None:
            return keys[0]
        by_tenant: Dict[str, list] = {}
        for k in keys:
            if self._tenant_admissible(k[0]):
                by_tenant.setdefault(k[0], []).append(k)
        if not by_tenant:
            return None
        if len(by_tenant) == 1:
            t = next(iter(by_tenant))
        else:
            # priority class folds into the raced weight (a "high"
            # tenant at weight 1 competes like weight 2 — qos.py
            # PRIORITY_FACTORS); proportions stay deterministic
            t = self._drr.pick(
                {t: self.qos.tenant(t).effective_weight for t in by_tenant}
            )
        return min(by_tenant[t], key=lambda k: self._queues[k].born)

    # -- execution ---------------------------------------------------------

    def _flush(
        self, cohort: Cohort, reason: str, have_engine_lock: bool = False
    ) -> None:
        """Execute one popped cohort.  ``have_engine_lock=True`` is the
        segmented-preemption donation path: the donor worker
        already holds the engine read lock (it is mid-query at a segment
        seam) and utils/rwlock.py is NOT reentrant, so the donated flush
        must run under the donor's hold instead of re-acquiring."""
        SCHED_FLUSHES.add(reason)
        SCHED_COHORT_OCCUPANCY.observe(len(cohort.reqs))
        now = time.monotonic()
        live: List[SchedRequest] = []
        shed: List[SchedRequest] = []
        max_wait = 0.0
        for req in cohort.reqs:
            w = now - req.enqueued
            max_wait = max(max_wait, w)
            SCHED_QUEUE_WAIT.observe(w)
            if req.expired(now):
                self._shed_deadline(req, now)
                shed.append(req)
            else:
                live.append(req)
        with self._cond:
            # depth bounds IN-FLIGHT requests (admitted − completed):
            # only the already-shed ones leave here, the rest leave as
            # they complete — so a blocked engine (writer holding the
            # lock) backs admission up into 429s instead of unbounded
            # thread/memory growth
            self._note_done(shed)
            SCHED_QUEUE_DEPTH.set(self._depth)
            self._flushes += 1
            if self.qos is not None and shed:
                # in-flight slots were reserved for the WHOLE cohort at
                # pop time (_next_cohort); release the shed members'
                # share now — only the live ones actually execute
                # (idempotent per-request: _shed_deadline already freed
                # each slot before failing the member)
                for r in shed:
                    self._release_req_slot_locked(r)
        if not live:
            # a fully shed cohort is the strongest overload signal: its
            # queue waits must reach the controller, or the deadline
            # never tightens under the backlog it exists for
            self._adapt(len(cohort.reqs), max_wait, 0.0)
            return
        # singleflight: equal-key members are the same deterministic
        # computation — run the first of each key, deal its result to
        # the duplicates (zipf traffic makes this the big win: a hot
        # query arriving K× inside one flush window costs one execution)
        leaders: List[SchedRequest] = []
        dups: Dict[object, List[SchedRequest]] = {}
        seen: Dict[object, SchedRequest] = {}
        for req in live:
            k = req.key
            if k is not None and k in seen:
                dups.setdefault(k, []).append(req)
            else:
                if k is not None:
                    seen[k] = req
                leaders.append(req)
        n_dup = len(live) - len(leaders)
        if n_dup:
            SCHED_COALESCED.add(n_dup)
        # flight recorder: ONE shared span per cohort flush, parented to
        # the first sampled member's trace; every other sampled member's
        # engine span LINKS to it instead of pretending to own it
        flush_span = None
        for r in live:
            if r.span is not None:
                flush_span = r.span.child("sched.flush")
                flush_span.set_attr("reason", reason)
                flush_span.set_attr("occupancy", len(cohort.reqs))
                flush_span.set_attr("leaders", len(leaders))
                flush_span.set_attr("coalesced", n_dup)
                break
        # publish keyed leaders so identical arrivals during execution
        # attach instead of re-running (skip keys another flush already
        # owns — its version differs, or it registered first)
        registered: List[SchedRequest] = []
        with self._cond:
            for req in leaders:
                if req.key is not None and req.key not in self._inflight:
                    self._inflight[req.key] = [cohort.sig[0], req, []]
                    registered.append(req)
        merger = HopMerger(len(leaders), window_s=self.merge_window_s)
        srv = self._server
        try:
            # chaos hook (utils/failpoints.py): an injected flush fault
            # lands INSIDE the try, so every member fails cleanly through
            # req.fail below instead of killing the worker loop
            fail.point("sched.flush")
            lock_cm = (
                contextlib.nullcontext()
                if have_engine_lock
                else srv._engine_lock.read()
            )
            with lock_cm:  # ONE read acquisition per cohort
                # tenant in-flight cap bounds EXECUTION concurrency, not
                # just cohort pick: a batch-class tenant with
                # max_inflight=1 runs its cohort's leaders in waves of 1
                # instead of fanning the whole cohort onto threads — the
                # CPU-side half of antagonist isolation (the pick-time
                # check alone would still let one flush monopolize the
                # cores)
                wave = len(leaders)
                if self.qos is not None:
                    mi = self.qos.tenant(cohort.tenant).max_inflight
                    if mi > 0:
                        wave = min(wave, mi)
                if len(leaders) == 1:
                    self._run_one(leaders[0], merger, flush_span)
                else:
                    for lo in range(0, len(leaders), wave):
                        batch = leaders[lo : lo + wave]
                        # fresh threads per wave, not a persistent pool:
                        # spawn cost (~100µs each) is noise next to
                        # cohort service time, occupancy keeps the count
                        # small, and a shared pool would need
                        # anti-starvation sizing across concurrent
                        # flushes
                        threads = [
                            threading.Thread(
                                target=self._run_one,
                                args=(req, merger, flush_span),
                                name="dgraph-cohort", daemon=True,
                            )
                            for req in batch[1:]
                        ]
                        for t in threads:
                            t.start()
                        self._run_one(batch[0], merger, flush_span)
                        for t in threads:
                            t.join()
                for k, followers in dups.items():
                    lead = seen[k]
                    for req in followers:
                        if req.result is not None or req.error is not None:
                            continue
                        if lead.error is None:
                            # results are read-only from here on
                            # (handlers only encode them): sharing is safe
                            if req.ledger is not None:
                                # dealt a twin's result: the follower's
                                # account says "coalesced", never the
                                # leader's engine numbers twice
                                req.ledger.coalesced += 1
                            req.complete(lead.result, lead.stats)
                        elif isinstance(lead.error, SchedDeadlineError):
                            # the leader ran out of budget but this
                            # duplicate still has some: run it (rare)
                            self._run_one(req, merger, flush_span)
                        else:
                            req.fail(lead.error)
        except BaseException as e:  # noqa: BLE001 — lock failure etc.: fail, never hang
            for req in live:
                if req.result is None and req.error is None:
                    req.fail(e)
        finally:
            attached: List = []
            with self._cond:
                for req in registered:
                    ent = self._inflight.pop(req.key, None)
                    if ent is not None:
                        attached.append((req, ent[2]))
            done: List[SchedRequest] = list(live)
            for lead, followers in attached:
                for req in followers:
                    self._complete_follower(
                        req, lead, merger, have_engine_lock
                    )
                    done.append(req)
            with self._cond:
                self._note_done(done)
                SCHED_QUEUE_DEPTH.set(self._depth)
                if self.qos is not None:
                    # per-request sweep: members whose slot already
                    # freed at a segment seam (deadline/cancel) are
                    # no-ops here
                    for r in live:
                        self._release_req_slot_locked(r)
            if flush_span is not None:
                flush_span.set_attr("merged_hops", merger.merged_dispatches)
                flush_span.finish()
            # feed this flush's measurements back: occupancy, the worst
            # queue wait and the cohort's service time
            self._adapt(len(cohort.reqs), max_wait, time.monotonic() - now)

    def _mesh_width(self) -> int:
        """The serving mesh's model-axis width (1 unsharded)."""
        mesh = self._server.engine.arenas.mesh
        return int(mesh.shape["model"]) if mesh is not None else 1

    def _adapt(self, occupancy: int, max_wait: float, service_s: float) -> None:
        """Feed one flush's measurements to the adaptive controller,
        honouring a runtime planner flip: switched off, the knobs snap
        back to their static bases."""
        if self._adaptive is None:
            return
        # the elastic mesh fault domain moves the width at run time (a
        # chip eviction shrinks the sub-mesh, a rejoin widens it):
        # re-sample per flush
        self._adaptive.set_width(self._mesh_width())
        if _planner.enabled():
            mb, fs = self._adaptive.update(occupancy, max_wait, service_s)
        else:
            mb, fs = self._adaptive.base_batch, self._adaptive.base_flush_s
        # both knobs move together and _next_cohort reads them under
        # _cond: unlocked stores could publish one worker's max_batch
        # with another's flush_s
        with self._cond:
            self.max_batch, self.flush_s = mb, fs

    def _complete_follower(
        self, req, lead, merger, have_engine_lock: bool = False
    ) -> None:
        """Deal a singleflight leader's outcome to an attached twin."""
        if req.result is not None or req.error is not None:
            return
        if lead.error is None:
            if req.ledger is not None:
                req.ledger.coalesced += 1
            req.complete(lead.result, lead.stats)
        elif isinstance(lead.error, SchedDeadlineError) and not req.expired():
            # leader ran out of budget but this twin still has some: run
            # it for real (rare — needs its own read hold, unless the
            # donation path's donor already holds one)
            lock_cm = (
                contextlib.nullcontext()
                if have_engine_lock
                else self._server._engine_lock.read()
            )
            with lock_cm:
                self._run_one(req, merger)
        else:
            req.fail(lead.error)

    def _shed_deadline(self, req: SchedRequest, now: float) -> None:
        SCHED_SHED.add("deadline")
        if self.qos is not None:
            TENANT_SHED.add((_qos.metric_label(req.tenant), "deadline"))
        # free the tenant's in-flight slot BEFORE the 504 surfaces: the
        # wave-cap wait must not outlive a dead query (idempotent — a
        # member shed before its cohort popped never held a slot)
        self._release_req_slot(req)
        req.fail(SchedDeadlineError(
            "deadline expired while queued "
            f"({(now - req.enqueued) * 1e3:.1f}ms in cohort)"
        ))

    def _run_one(
        self, req: SchedRequest, merger: HopMerger, flush_span=None
    ) -> None:
        from dgraph_tpu_torch.query import outputnode
        from dgraph_tpu_torch.query.engine import QueryEngine

        srv = self._server
        ltoken = None
        try:
            if req.expired():
                # budget lapsed while the cohort waited on the engine
                # lock (a long write was in front of us): shed, don't run
                self._shed_deadline(req, time.monotonic())
                return
            if req.cancel is not None and req.cancel.cancelled:
                # cancelled between admission and execution (client
                # disconnect): never touch the engine
                self._release_req_slot(req)
                req.fail(req.cancel.error())
                return
            req.end_queue_wait("run")
            # re-root this worker thread under the admitting request's
            # trace AND ledger: the engine span parents to the REQUEST
            # (it is that query's execution) and LINKS to the shared
            # cohort-flush span that scheduled it
            es = obs.NOOP
            if req.ledger is not None:
                ltoken = _ledgermod.activate(req.ledger)
            if req.span is not None:
                es = req.span.child("engine")
                if flush_span is not None:
                    es.link(flush_span)
            with es:
                # a shell over the shared arena cache, with the served
                # engine's knobs: its chain gate and its route gates (the
                # fused hop and the resident route), which a caller may
                # have set on it
                eng = QueryEngine(srv.store, arenas=srv.engine.arenas)
                eng.chain_threshold = srv.engine.chain_threshold
                eng.expander.fused_hop = srv.engine.expander.fused_hop
                eng.expander.resident_mode = srv.engine.expander.resident_mode
                eng.expander.hop_merger = merger
                # cooperative cancellation (sched/qos.py): the engine
                # checkpoints this token at hop boundaries
                eng.cancel = req.cancel
                eng.dump_shapes = bool(srv.dumpsg_path)
                token = outputnode.DEBUG_UIDS.set(req.debug)
                # segment seams inside the fused hop loops probe this
                # context — the request's cancel token, the
                # preemption-donation hook (a higher-priority arrival
                # drains at the next seam on THIS thread), and the
                # request's stats.  DGRAPH_TPU_SEGMENT=0 leaves the
                # donation hook off with the seams
                seg_prev = _segments.activate(_segments.SegmentContext(
                    token=req.cancel,
                    preempt=(
                        (lambda: self._maybe_preempt(req))
                        if self.qos is not None
                        and _planconfig.segment_mode() != "0"
                        else None
                    ),
                    stats=eng.stats,
                ))
                try:
                    out = eng.run_parsed(req.parsed)
                finally:
                    _segments.deactivate(seg_prev)
                    outputnode.DEBUG_UIDS.reset(token)
                es.set_attr("edges", eng.stats.get("edges", 0))
            if srv.dumpsg_path and eng.last_dump:
                srv.dump_subgraphs(eng.last_dump)
            if req.ledger is not None:
                # fold this shell's stats in BEFORE completion: once
                # complete() fires, the handler thread owns the ledger
                # again (the single-writer hand-off)
                req.ledger.merge_engine_stats(eng.stats)
            req.complete(out, dict(eng.stats))
        except BaseException as e:  # noqa: BLE001 — delivered via req.fail
            if isinstance(e, (_qos.QueryCancelledError, SchedDeadlineError)):
                # died at a checkpoint/seam: free the tenant's in-flight
                # slot before the 499/504 surfaces
                self._release_req_slot(req)
            req.fail(e)
        finally:
            if ltoken is not None:
                _ledgermod.deactivate(ltoken)
            merger.leave()

    # -- segmented preemption ------------------------------------------------

    def _maybe_preempt(self, req: SchedRequest) -> None:
        """Segment-seam preemption: called by the running query's
        ``segments.seam()`` between program segments.  If a cohort from
        a STRICTLY higher priority class is queued and admissible, pop
        it and drain it inline on this thread — the preempted query's
        carry parks on this stack and resumes when the donated flush
        returns.  This turns DRR priority from admission-ordering into
        real preemption: a critical arrival runs at the standard query's
        next seam instead of behind its remaining segments.

        The donor already holds the engine read lock, so the donated
        flush runs with ``have_engine_lock=True`` (utils/rwlock.py is
        not reentrant).  A per-thread depth guard keeps the donated
        query's own seams from preempting recursively."""
        if self.qos is None or self._stopped:
            return
        if getattr(self._donation, "depth", 0) > 0:
            return
        my = _qos.PRIORITY_FACTORS.get(
            self.qos.tenant(req.tenant).priority, 1.0
        )
        with self._cond:
            best_key, best_f = None, 0.0
            for key, c in self._queues.items():
                f = _qos.PRIORITY_FACTORS.get(
                    self.qos.tenant(c.tenant).priority, 1.0
                )
                if f <= my or not self._tenant_admissible(c.tenant):
                    continue
                if (
                    best_key is None
                    or f > best_f
                    or (f == best_f
                        and c.born < self._queues[best_key].born)
                ):
                    best_key, best_f = key, f
            if best_key is None:
                return
            cohort = self._queues.pop(best_key)
            # reserve the in-flight slots in the same hold as the
            # admissibility check, exactly like _next_cohort
            self._tenant_inflight[cohort.tenant] = (
                self._tenant_inflight.get(cohort.tenant, 0)
                + len(cohort.reqs)
            )
            for r in cohort.reqs:
                r.slot_held = True
            waited = time.monotonic() - cohort.born
        SEGMENT_PREEMPT_US.observe(waited * 1e6)
        SEGMENT_YIELDS.add("preempt")
        self._donation.depth = getattr(self._donation, "depth", 0) + 1
        try:
            self._flush(cohort, "preempt", have_engine_lock=True)
        finally:
            self._donation.depth -= 1

    # -- introspection -----------------------------------------------------

    def qos_state(self) -> Optional[dict]:
        """The /debug/store "qos" snapshot: tenant table, live per-tenant
        queue depth and in-flight counts.  None when QoS is off."""
        if self.qos is None:
            return None
        with self._cond:
            depth = dict(self._tenant_depth)
            inflight = dict(self._tenant_inflight)
        return {
            "tenants": self.qos.snapshot(),
            "queued": depth,
            "inflight": inflight,
        }

    # -- lifecycle ---------------------------------------------------------

    def stop(self) -> None:
        """Stop admitting and fail whatever is still queued (callers get
        a retriable error; the server is tearing down anyway)."""
        with self._cond:
            if self._stopped:
                return
            self._stopped = True
            pending = [r for c in self._queues.values() for r in c.reqs]
            self._queues.clear()
            self._depth = 0
            self._tenant_depth.clear()
            self._tenant_inflight.clear()
            SCHED_QUEUE_DEPTH.set(0)
            self._cond.notify_all()
        for req in pending:
            req.fail(SchedOverloadError("server shutting down"))
        for t in self._workers:
            t.join(timeout=5)
