"""Live-query subscriptions: standing queries pushed on affecting writes
(PyTorch port of ``dgraph_tpu/ivm/subs.py``).

A client registers a read-only query once and the server PUSHES the
re-evaluated result whenever a mutation touches a predicate in the
query's footprint — the same ``gql.ast.referenced_preds`` walk that
scopes cache invalidation decides which subscriptions a delta wakes, so
an unrelated-predicate write costs every subscription nothing.

- :class:`SubscriptionRegistry` — one per server.  ``register`` parses
  the query (mutations refused), computes its predicate footprint,
  enforces quotas (global ``DGRAPH_TPU_SUBS_MAX``, per tenant the QoS
  table's ``max_subs`` or ``DGRAPH_TPU_SUBS_PER_TENANT``) and runs an
  initial evaluation, so the consumer starts from a snapshot.
- A single **notifier thread** tails the store's delta stream
  (ivm/deltas.py).  Edge and pred events mark the subscriptions whose
  footprint holds the predicate dirty; epoch events and ring overflow
  mark all of them.  Dirty subscriptions re-evaluate through the cohort
  scheduler when one is armed (result cache, QoS admission,
  singleflight, and the gather and intersect kernels on the card, like
  any read), debounced per subscription (``DGRAPH_TPU_SUBS_DEBOUNCE_MS``)
  so a write burst coalesces into one push.
- A push happens only when the re-evaluated response DIFFERS from the
  last pushed one (canonical-JSON digest); an unchanged re-evaluation
  counts as ``skip`` in ``dgraph_subscription_events_total``.
- Every subscription carries a :class:`CancelToken`: unsubscribe,
  server shutdown and a failed evaluation flip it, and a mid-flight
  evaluation stops at the engine's next hop checkpoint.  Retriable
  failures — a scheduler shed, or a device fault (utils/devguard.py: a
  sick or wedged card, the 503 of a client read) — defer the
  evaluation to the next notifier round instead (``deferred``).  The
  reference never sees a device fault here: it serves the read from
  the host.
- Evaluations head-sample through the flight recorder (``subs.eval``
  root span); a sampled push carries its ``trace_id``.

Transport is the serving layer's (serve/server.py): ``POST /subscribe``
(register; streams SSE inline under ``Accept: text/event-stream`` or
``?stream=1``), ``GET /subscribe?id=`` (attach) and ``POST
/subscribe/cancel?id=`` — and serve/grpc_server.py mirrors it as the
``/protos.Dgraph/Subscribe`` server-stream.  Each subscription buffers at most
``DGRAPH_TPU_SUBS_QUEUE`` undelivered events; a slower consumer loses
the OLDEST (counted ``lagged``).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Set

from dgraph_tpu_torch import obs
from dgraph_tpu_torch.sched import qos as _qos
from dgraph_tpu_torch.utils import devguard
from dgraph_tpu_torch.utils.env import env_float as _env_f
from dgraph_tpu_torch.utils.metrics import (
    SUBS_ACTIVE,
    SUBS_EVALS,
    SUBS_EVENTS,
    SUBS_SHED,
    note_swallowed,
)


def subs_enabled() -> bool:
    """DGRAPH_TPU_SUBS gate (default on; the registry additionally
    needs IVM on and a store that streams deltas)."""
    return os.environ.get("DGRAPH_TPU_SUBS", "1") != "0"


def _env_i(name: str, default: int) -> int:
    return int(_env_f(name, default))


class SubQuotaError(RuntimeError):
    """Registration refused: the tenant (or the server) is at its
    subscription cap.  Maps to HTTP 429."""

    def __init__(self, msg: str, tenant: str = "", retry_after: float = 1.0):
        super().__init__(msg)
        self.tenant = tenant
        self.retry_after = retry_after


def _digest(obj) -> bytes:
    return hashlib.blake2b(
        json.dumps(obj, sort_keys=True, default=str).encode(),
        digest_size=16,
    ).digest()


class Subscription:
    """One registered live query.  Single-consumer event queue."""

    def __init__(
        self,
        sid: str,
        text: str,
        variables: Optional[dict],
        parsed,
        footprint: Optional[Set[str]],
        tenant: str,
        queue_cap: int,
    ):
        self.id = sid
        self.text = text
        self.variables = variables
        self.parsed = parsed
        self.footprint = footprint  # None = every predicate affects it
        self.tenant = tenant
        self.token = _qos.CancelToken(None, tenant=tenant or "default")
        self.created = time.monotonic()
        self.seq = 0            # events pushed so far
        self.evals = 0
        self.dropped = 0        # events a slow consumer lost
        self.last_digest: Optional[bytes] = None
        self.last_eval = 0.0    # monotonic time of the last evaluation
        self.pending: Optional[Set[str]] = set()  # dirty preds; None=all
        self._q: List[dict] = []
        self._cap = max(1, queue_cap)
        self._cond = threading.Condition()
        # serializes evaluations of THIS subscription: the register
        # thread's snapshot eval and the notifier's update evals must
        # not interleave their seq/digest bookkeeping (snapshot-first
        # event order is part of the contract)
        self._eval_lock = threading.Lock()

    # -- consumer side -------------------------------------------------------

    def next_event(self, timeout: Optional[float] = None) -> Optional[dict]:
        """Pop the next undelivered event, blocking up to ``timeout``
        (None on timeout — the transport writes a heartbeat and keeps
        waiting).  Returns a terminal ``{"kind": "cancelled"}`` event
        once after the token flips with the queue drained."""
        with self._cond:
            self._cond.wait_for(
                lambda: self._q or self.token.cancelled, timeout=timeout
            )
            if self._q:
                return self._q.pop(0)
            if self.token.cancelled:
                return {
                    "kind": "cancelled",
                    "sub_id": self.id,
                    "reason": self.token.reason,
                }
            return None

    # -- registry side -------------------------------------------------------

    def _push(self, event: dict) -> None:
        with self._cond:
            if len(self._q) >= self._cap:
                self._q.pop(0)
                self.dropped += 1
                SUBS_EVENTS.add("lagged")
            self._q.append(event)
            self._cond.notify_all()

    def _wake(self) -> None:
        with self._cond:
            self._cond.notify_all()

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "tenant": self.tenant,
            "preds": (
                sorted(self.footprint) if self.footprint is not None else None
            ),
            "seq": self.seq,
            "evals": self.evals,
            "dropped": self.dropped,
            "cancelled": self.token.cancelled,
            "queued": len(self._q),
        }


class SubscriptionRegistry:
    """Owns the subscriptions and the delta-stream notifier thread."""

    def __init__(self, server, stream):
        self._server = server
        self._stream = stream
        self._lock = threading.Lock()
        self._subs: Dict[str, Subscription] = {}
        self._by_tenant: Dict[str, int] = {}
        self._stopped = False
        self._seq = 0
        self.max_total = _env_i("DGRAPH_TPU_SUBS_MAX", 256)
        self.per_tenant_default = _env_i("DGRAPH_TPU_SUBS_PER_TENANT", 64)
        self.queue_cap = _env_i("DGRAPH_TPU_SUBS_QUEUE", 64)
        self.debounce_s = _env_f("DGRAPH_TPU_SUBS_DEBOUNCE_MS", 10.0) / 1e3
        self.eval_timeout_s = _env_f("DGRAPH_TPU_SUBS_EVAL_TIMEOUT_S", 10.0)
        self._thread = threading.Thread(
            target=self._notify_loop, name="dgraph-subs", daemon=True
        )

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            subs = list(self._subs.values())
        for sub in subs:
            sub.token.cancel("shutdown")
            sub._wake()
        # wake the notifier out of its stream wait: one epoch-shaped
        # nudge through the ring it is already blocked on.  A server
        # constructed but never start()ed has no thread to join.
        if self._thread.ident is not None:
            self._stream.publish_epoch(-1)
            self._thread.join(timeout=5)

    # -- registration ---------------------------------------------------------

    def _tenant_cap(self, tenant: str) -> int:
        sched = self._server.scheduler
        if sched is not None and sched.qos is not None:
            cap = sched.qos.tenant(tenant).max_subs
            if cap > 0:
                return cap
        return self.per_tenant_default

    def register(
        self, text: str, variables: Optional[dict] = None, tenant: str = ""
    ) -> Subscription:
        """Parse, quota-check, admit, and run the initial snapshot
        evaluation.  Raises ValueError/ParseError on a bad or mutating
        request and SubQuotaError over quota."""
        from dgraph_tpu_torch import gql
        from dgraph_tpu_torch.gql.ast import referenced_preds

        parsed = gql.parse(text, variables)
        if parsed.mutation is not None:
            raise ValueError("subscriptions are read-only; mutation refused")
        if not parsed.queries:
            raise ValueError("subscription has no query block")
        tenant = _qos.resolve_tenant(tenant)
        footprint = referenced_preds(parsed.queries)
        sub = Subscription(
            "", text, variables, parsed, footprint, tenant, self.queue_cap,
        )
        # hold the sub's eval lock ACROSS table insertion: a mutation
        # landing between insert and the snapshot evaluation wakes the
        # notifier, which then BLOCKS here until the snapshot pushed —
        # the first delivered event is always the snapshot, and the
        # post-mutation update that follows legally dedups against it
        sub._eval_lock.acquire()
        try:
            self._admit(sub, tenant)
            self._evaluate_locked(sub, trigger=None, kind="snapshot")
        finally:
            sub._eval_lock.release()
        return sub

    def _admit(self, sub: Subscription, tenant: str) -> None:
        """Quota-check and insert (caller holds the sub's eval lock)."""
        with self._lock:
            if self._stopped:
                raise SubQuotaError("server shutting down", tenant)
            if len(self._subs) >= self.max_total:
                SUBS_SHED.add("cap")
                raise SubQuotaError(
                    f"subscription cap reached ({self.max_total})", tenant
                )
            cap = self._tenant_cap(tenant)
            have = self._by_tenant.get(tenant, 0)
            if cap > 0 and have >= cap:
                SUBS_SHED.add("quota")
                raise SubQuotaError(
                    f"tenant {tenant!r} over subscription quota "
                    f"({have}/{cap})",
                    tenant,
                )
            self._seq += 1
            sub.id = f"sub-{self._seq:x}-{os.getpid():x}"
            self._subs[sub.id] = sub
            self._by_tenant[tenant] = have + 1
            SUBS_ACTIVE.set(len(self._subs))

    def get(self, sid: str) -> Optional[Subscription]:
        with self._lock:
            return self._subs.get(sid)

    def cancel(self, sid: str, reason: str = "unsubscribe") -> bool:
        """Flip the subscription's token and drop it from the table.
        The consumer drains its queue, then sees one terminal
        ``cancelled`` event."""
        with self._lock:
            sub = self._subs.pop(sid, None)
            if sub is not None:
                left = self._by_tenant.get(sub.tenant, 0) - 1
                if left > 0:
                    self._by_tenant[sub.tenant] = left
                else:
                    self._by_tenant.pop(sub.tenant, None)
                SUBS_ACTIVE.set(len(self._subs))
        if sub is None:
            return False
        sub.token.cancel(reason)
        sub._wake()
        return True

    # -- the notifier ---------------------------------------------------------

    def _notify_loop(self) -> None:
        cursor = self._stream.seq
        next_due: Optional[float] = None
        while True:
            if next_due is None:
                self._stream.wait_for(cursor, timeout=1.0)
            else:
                self._stream.wait_for(
                    cursor, timeout=max(1e-3, next_due - time.monotonic())
                )
            if self._stopped:
                return
            events, cursor, lost = self._stream.read_since(cursor)
            dirty: Optional[Set[str]] = set()
            for _seq, _ver, pred, kind, _s, _d, _sg in events:
                if kind == "epoch":
                    dirty = None
                    break
                if dirty is not None:
                    dirty.add(pred)
            if lost:
                dirty = None  # fell off the ring: treat everything dirty
            next_due = self._mark_and_run(dirty)

    def _mark_and_run(self, dirty: Optional[Set[str]]) -> Optional[float]:
        """Fold freshly-dirty predicates into each affected
        subscription's pending set, evaluate the ones past their
        debounce window, and return the earliest debounce deadline
        still pending (None when nothing waits)."""
        with self._lock:
            subs = list(self._subs.values())
        now = time.monotonic()
        next_due = None
        for sub in subs:
            if sub.token.cancelled:
                continue
            # fold this round's triggers into what's pending.  An EMPTY
            # dirty set (idle timeout tick) adds nothing for ANY
            # footprint shape — it only gives carried-over pendings a
            # chance past their debounce window; a footprint-unknown
            # sub (expand()/_predicate_) is affected by every non-empty
            # round, never by silence.
            if dirty is None:
                sub.pending = None
            elif dirty:
                if sub.footprint is None:
                    sub.pending = None
                elif sub.pending is not None:
                    sub.pending |= dirty & sub.footprint
            if sub.pending is not None and not sub.pending:
                continue  # nothing triggered, nothing carried over
            due = sub.last_eval + self.debounce_s
            if now < due:
                next_due = due if next_due is None else min(next_due, due)
                continue
            trigger = sub.pending
            sub.pending = set()
            self._evaluate(sub, trigger=trigger, kind="update")
        return next_due

    # -- evaluation -----------------------------------------------------------

    def _evaluate(self, sub: Subscription, trigger, kind: str) -> None:
        """Re-run one subscription and push iff the result changed.
        Retryable backpressure (scheduler sheds) re-marks the triggers
        and tries again after the debounce window; hard failures cancel
        the subscription (counted, pushed as the terminal event) — a
        standing query that can no longer evaluate must say so, not
        silently go dark."""
        if sub.token.cancelled:
            return
        with sub._eval_lock:
            self._evaluate_locked(sub, trigger, kind)

    def _evaluate_locked(self, sub: Subscription, trigger, kind: str) -> None:
        """_evaluate's body; the caller holds ``sub._eval_lock``
        (register() holds it ACROSS table insertion so the snapshot
        always lands before any notifier update)."""
        from dgraph_tpu_torch.sched.cohort import (
            SchedDeadlineError,
            SchedOverloadError,
        )

        if sub.token.cancelled:
            return
        sub.last_eval = time.monotonic()
        sub.evals += 1
        SUBS_EVALS.add(1)
        root = obs.start_request("subs.eval")
        tid = None
        try:
            if root is not None:
                tid = root.trace_id
                root.set_attr("sub_id", sub.id)
                root.set_attr("kind", kind)
                if trigger:
                    root.set_attr("preds", sorted(trigger))
                root.__enter__()
            try:
                result = self._run(sub)
            finally:
                if root is not None:
                    root.__exit__(None, None, None)
        except _qos.QueryCancelledError:
            return  # token flipped mid-eval: terminal event follows
        except (
            SchedOverloadError, SchedDeadlineError, devguard.DeviceFaultError
        ) as e:
            # 429/504-class backpressure and the device's 503 are
            # RETRYABLE: keep the subscription, restore its triggers,
            # and let the next notifier round (≤1s idle tick +
            # debounce) try again — a load spike or a card awaiting its
            # re-admission probe must not tear down every standing query
            # that re-evaluated during it
            note_swallowed("subs.eval_deferred", e)
            SUBS_EVENTS.add("deferred")
            if trigger is None:
                sub.pending = None
            elif sub.pending is not None:
                sub.pending |= set(trigger)
            return
        except Exception as e:  # noqa: BLE001 — delivered, counted
            note_swallowed("subs.eval", e)
            SUBS_EVENTS.add("error")
            self.cancel(sub.id, reason=f"eval failed: {e}")
            return
        dg = _digest(result)
        if kind != "snapshot" and dg == sub.last_digest:
            SUBS_EVENTS.add("skip")
            return
        sub.last_digest = dg
        sub.seq += 1
        store_ver = getattr(self._server.store, "version", 0)
        sub._push({
            "kind": kind,
            "sub_id": sub.id,
            "seq": sub.seq,
            "version": store_ver,
            "preds": sorted(trigger) if trigger else None,
            "trace_id": tid,
            "data": result,
        })
        SUBS_EVENTS.add("push")

    def _run(self, sub: Subscription) -> dict:
        """One evaluation over the current store — through the cohort
        scheduler when armed (result cache + QoS + singleflight apply
        to subscription traffic exactly like client reads), else the
        direct read-locked path."""
        srv = self._server
        if srv.scheduler is not None:
            vkey = (
                json.dumps(sub.variables, sort_keys=True)
                if sub.variables else ""
            )
            result, _stats = srv.scheduler.run(
                sub.parsed,
                debug=False,
                timeout_s=self.eval_timeout_s,
                key=(sub.text, vkey, False),
                tenant=sub.tenant if srv.scheduler.qos is not None else "",
                cancel=sub.token,
            )
            return result
        from dgraph_tpu_torch.query.engine import QueryEngine

        with srv._engine_lock.read():
            # a shell with the served engine's knobs, as the scheduler's
            # members get
            eng = QueryEngine(srv.store, arenas=srv.engine.arenas)
            eng.chain_threshold = srv.engine.chain_threshold
            eng.expander.fused_hop = srv.engine.expander.fused_hop
            eng.expander.resident_mode = srv.engine.expander.resident_mode
            eng.cancel = sub.token
            return eng.run_parsed(sub.parsed)

    # -- introspection ---------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            subs = [s.to_dict() for s in self._subs.values()]
        return {
            "active": len(subs),
            "max_total": self.max_total,
            "per_tenant_default": self.per_tenant_default,
            "stream": self._stream.snapshot(),
            "subs": subs,
        }
