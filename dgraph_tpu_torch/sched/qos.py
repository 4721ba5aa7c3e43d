"""Multi-tenant serving QoS: tenant identity, quotas, weighted-fair
pick, and cooperative query cancellation (copy of
``dgraph_tpu/sched/qos.py``).

- **Tenant identity** — the ``X-Dgraph-Tenant`` HTTP header / the
  ``x-dgraph-tenant`` gRPC metadata key names the scope; absent means
  the ``default`` tenant.  :func:`resolve_tenant`
  normalizes.
- **Per-tenant config** (:class:`QosConfig` / :class:`TenantConfig`) —
  weight (fair-share of cohort flush slots), ``max_queued`` (admission
  quota: over it sheds 429 with a tenant-scoped ``Retry-After`` BEFORE
  the global cap), ``max_inflight`` (concurrent execution cap), a
  ``priority`` class (low/standard/high/critical) folded into the DRR
  weight (``PRIORITY_FACTORS``), and ``max_subs`` (the live-query
  subscription quota, ivm/subs.py).
  Configured via the ``DGRAPH_TPU_QOS_TENANTS`` JSON knob; unconfigured
  tenants inherit the ``DGRAPH_TPU_QOS_DEFAULT_*`` defaults (weight 1,
  no quota), so absent configuration changes nothing.
- **Weighted-fair pick** (:class:`DrrPicker`) — a deficit/credit
  round-robin over the tenants with due cohorts (the smooth-WRR
  formulation: deterministic, O(tenants), proportional to weight).
- **Cooperative cancellation** (:class:`CancelToken`) — carried on
  ``SchedRequest`` and threaded into the engine; checked at hop
  boundaries and segment seams (never inside a launched kernel, so
  cancellation latency is one hop's duration).  Three sources flip it:
  deadline lapse mid-execution (the token carries the request budget),
  client disconnect (an HTTP socket EOF peek, plain or TLS, or gRPC's
  ``context.is_active()``) and an
  operator's ``/admin/cancel?trace_id=`` (:class:`CancelRegistry`, which
  holds the tokens of sampled, scheduled reads under their trace ids).
  A cancelled query raises :class:`QueryCancelledError`; the serving
  layer records ``dgraph_query_cancelled_total{reason,tenant}``.
- **One deadline resolution** (:func:`parse_timeout` for the HTTP
  header, :func:`grpc_timeout` for a gRPC deadline): zero/negative =
  budget already spent; absent/malformed/unbounded = no budget.

Gate: ``DGRAPH_TPU_QOS`` (default on).  ``0`` restores the pre-QoS
serving path byte-identically — no tenant resolution, no tokens, no
checkpoints, no early exit.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

from dgraph_tpu_torch.utils.metrics import note_swallowed

DEFAULT_TENANT = "default"
# metric-label cardinality bound: tenant names come from a client header,
# and an attacker must not be able to mint unbounded prometheus series
_LABEL_CAP = 64


def qos_enabled() -> bool:
    """The DGRAPH_TPU_QOS gate (default ON); ``0`` restores the
    pre-QoS serving path byte-identically."""
    return os.environ.get("DGRAPH_TPU_QOS", "1") != "0"


def resolve_tenant(raw: Optional[str]) -> str:
    """Normalize a tenant header value: absent/blank → ``default``,
    else stripped and length-capped (the value is attacker-controlled;
    it becomes a metric label and a dict key, never more)."""
    if not raw:
        return DEFAULT_TENANT
    t = raw.strip()
    return t[:64] if t else DEFAULT_TENANT


_label_lock = threading.Lock()
_label_seen: set = set()


def metric_label(tenant: str) -> str:
    """Bounded-cardinality tenant label for metrics: the first
    ``_LABEL_CAP`` distinct tenants keep their names, the long tail
    collapses to ``overflow`` (the series stay alertable either way)."""
    with _label_lock:
        if tenant in _label_seen:
            return tenant
        if len(_label_seen) < _LABEL_CAP:
            _label_seen.add(tenant)
            return tenant
    return "overflow"


# ------------------------------------------------------------ cancellation


class QueryCancelledError(RuntimeError):
    """The request's CancelToken flipped: execution stopped at the next
    checkpoint.  ``reason`` ∈ {deadline, disconnect, ...};
    serving surfaces map deadline → 504/DEADLINE_EXCEEDED and the rest
    → 499/CANCELLED."""

    def __init__(self, reason: str, tenant: str = DEFAULT_TENANT):
        super().__init__(f"query cancelled ({reason})")
        self.reason = reason
        self.tenant = tenant


class CancelToken:
    """Cooperative cancellation flag carried on a SchedRequest.

    ``check()`` is THE checkpoint primitive: it raises
    :class:`QueryCancelledError` when the token was cancelled, when the
    request's deadline lapsed, or when the attached transport probe
    reports the client gone.  The probe is rate-limited (it may cost a
    syscall), the deadline read is one ``time.monotonic()``, and the
    common case — live token, no probe due — is two attribute reads, so
    checkpoints are safe at per-hop granularity."""

    __slots__ = (
        "tenant", "deadline", "_reason", "_probe", "_probe_interval",
        "_last_probe", "_lock", "_race_serial",
    )
    # the lockset witness (analysis/witness.py): cancel() publishes
    # _reason under _lock from whatever thread cancels (registry sweep,
    # disconnect probe, admin) while engine threads read it — witness
    # every store.  _last_probe is deliberately NOT listed: it is a probe
    # throttle written only by whichever single engine thread is running
    # the request's current segment, and a lost update costs one extra
    # probe, not correctness.
    __race_fields__ = frozenset({"_reason"})

    def __init__(
        self,
        timeout_s: Optional[float] = None,
        tenant: str = DEFAULT_TENANT,
    ):
        self.tenant = tenant
        # absolute monotonic deadline; None = no budget.  timeout <= 0
        # means the budget is ALREADY spent (same contract as the
        # scheduler's queued-deadline shed)
        self.deadline = (
            time.monotonic() + max(timeout_s, 0.0)
            if timeout_s is not None
            else None
        )
        self._reason: Optional[str] = None
        self._probe: Optional[Callable[[], bool]] = None
        self._probe_interval = 0.0
        self._last_probe = 0.0
        self._lock = threading.Lock()

    # -- state ------------------------------------------------------------

    @property
    def cancelled(self) -> bool:
        return self._reason is not None

    @property
    def reason(self) -> Optional[str]:
        return self._reason

    def cancel(self, reason: str) -> bool:
        """Flip the token; the FIRST reason wins (an admin cancel racing
        a deadline lapse must report one truth).  Returns whether this
        call did the flip."""
        with self._lock:
            if self._reason is not None:
                return False
            self._reason = reason
            return True

    def attach_probe(
        self, probe: Callable[[], bool], interval_s: float = 0.02
    ) -> None:
        """Attach a transport-liveness probe (returns True when the
        client is GONE).  Probed at most every ``interval_s`` from
        ``check()`` — a probe may cost a syscall, a checkpoint must
        not."""
        self._probe = probe
        self._probe_interval = max(float(interval_s), 0.0)

    def error(self) -> QueryCancelledError:
        return QueryCancelledError(self._reason or "cancelled", self.tenant)

    def check(self) -> None:
        """The checkpoint: raise if this request must stop.  Called at
        hop-dispatch boundaries only — never inside a jitted program."""
        if self._reason is not None:
            raise self.error()
        now = time.monotonic()
        if self.deadline is not None and now >= self.deadline:
            self.cancel("deadline")
            raise self.error()
        probe = self._probe
        if probe is not None and now - self._last_probe >= self._probe_interval:
            self._last_probe = now
            gone = False
            try:
                gone = bool(probe())
            except Exception as e:  # noqa: BLE001 — a broken probe must
                # never kill a healthy query; counted, not silent
                note_swallowed("qos.cancel_probe", e)
            if gone:
                self.cancel("disconnect")
                raise self.error()


class CancelRegistry:
    """trace_id → live CancelToken, for ``/admin/cancel?trace_id=``.

    Bounded: at the cap the oldest registration is evicted (its query
    merely becomes un-cancellable by trace id — deadline and disconnect
    still work).  Only sampled requests have trace ids, so the admin
    surface targets exactly the queries an operator can see in
    /debug/traces."""

    _MAX = 4096

    def __init__(self):
        self._lock = threading.Lock()
        self._m: "Dict[str, CancelToken]" = {}
        # eviction queue of (trace_id, token) pairs: unregister leaves
        # its entry behind (an O(n) list remove per request would tax
        # the hot path), so eviction must verify the entry still maps
        # to ITS token — a re-registered trace id (client retries reuse
        # trace ids) must never have its LIVE token evicted by a stale
        # queue entry
        self._order: List[tuple] = []

    def register(self, trace_id: str, token: CancelToken) -> None:
        with self._lock:
            self._m[trace_id] = token
            self._order.append((trace_id, token))
            while len(self._order) > self._MAX:
                old_id, old_tok = self._order.pop(0)
                if self._m.get(old_id) is old_tok:
                    self._m.pop(old_id, None)

    def unregister(self, trace_id: str, token: Optional[CancelToken] = None) -> None:
        """Drop a registration — identity-checked: two sampled queries
        may legally share one trace id (a distributed trace fanning out
        several DQL queries), and the first to finish must not evict
        the other's LIVE token.  ``token`` None = unconditional (tests,
        teardown)."""
        with self._lock:
            if token is None or self._m.get(trace_id) is token:
                self._m.pop(trace_id, None)
            # the matching _order entry is dropped lazily by the
            # eviction sweep (identity-checked there)

    def cancel(self, trace_id: str, reason: str = "admin") -> bool:
        with self._lock:
            tok = self._m.get(trace_id)
        if tok is None:
            return False
        tok.cancel(reason)
        return True


# process-wide registry (the serving layer registers sampled requests;
# /admin/cancel resolves against it)
REGISTRY = CancelRegistry()


def socket_disconnect_probe(sock) -> Callable[[], bool]:
    """Transport-liveness probe for cooperative cancellation: returns a
    zero-argument callable that reports True when the client is GONE.

    Plain TCP: a closed client connection makes the socket readable
    with EOF; ``MSG_PEEK`` observes that without consuming pipelined
    bytes.

    TLS (``ssl.SSLSocket``): ``recv`` flags are rejected at the SSL
    layer, so the probe peeks the RAW transport instead — a second
    socket object over the same fd, detached after the peek so the
    shared fd never closes, sees the TCP FIN exactly like the plain
    probe.  Buffered decrypted bytes (``sock.pending()``) mean the client
    was alive at least as recently as those records; a readable raw
    socket with bytes (a TLS record that must not be consumed) reads as
    connected too — only a raw EOF is a disconnect.  A close_notify
    without FIN therefore reads as still connected: a conservative miss
    that the deadline and ``/admin/cancel`` still cover."""
    import select
    import socket as _socket
    import ssl as _ssl

    if isinstance(sock, _ssl.SSLSocket):
        def gone_tls() -> bool:
            try:
                if sock.pending():
                    return False  # undrained decrypted bytes: alive
                r, _w, _x = select.select([sock], [], [], 0)
                if not r:
                    return False
                raw = _socket.socket(fileno=sock.fileno())
                try:
                    return raw.recv(1, _socket.MSG_PEEK) == b""
                finally:
                    # detach BEFORE gc: the temporary object must never
                    # close the fd it shares with the live SSLSocket
                    raw.detach()
            except ValueError:
                return False  # fd already detached mid-probe
            except OSError:
                return True   # socket already torn down
        return gone_tls

    def gone() -> bool:
        try:
            r, _w, _x = select.select([sock], [], [], 0)
            if not r:
                return False
            return sock.recv(1, _socket.MSG_PEEK) == b""
        except ValueError:
            return False  # unexpected flag rejection: fail open
        except OSError:
            return True   # socket already torn down
    return gone


# -------------------------------------------------------------- deadlines


def parse_timeout(header: Optional[str]) -> Optional[float]:
    """The ONE ``X-Dgraph-Timeout`` resolution.  Returns remaining budget in
    seconds: None for absent/malformed/NaN/unbounded (no budget —
    malformed client input must degrade, never 500), and 0.0 for zero
    or negative (budget ALREADY spent: shed immediately)."""
    if not header:
        return None
    try:
        v = float(header)
    except (TypeError, ValueError):
        return None
    if v != v or v == float("inf"):  # NaN / +inf: no bound
        return None
    return max(v, 0.0)


def grpc_timeout(context) -> Optional[float]:
    """The gRPC half of deadline resolution: ``context.time_remaining()``
    with the contract of :func:`parse_timeout` — None for no deadline
    (grpcio's huge sentinel) or a transport without deadline support;
    values ≤ 0 clamp to 0.0 (an already-lapsed deadline sheds at once)."""
    try:
        v = context.time_remaining()
    except Exception:  # noqa: BLE001 — a transport without deadlines
        return None
    if v is None or v > 1e8:  # grpcio's "no deadline" sentinel
        return None
    return max(float(v), 0.0)


# ---------------------------------------------------------- tenant config


# priority-class multipliers folded into the DRR weight.  The classes are coarse on purpose — priority expresses
# "this tenant's cohorts win the fair-share race K× more often", not a
# preemption lattice; an unknown class reads as standard (×1) so a
# config typo degrades to today's behavior instead of starving anyone.
PRIORITY_FACTORS = {
    "low": 0.5,
    "standard": 1.0,
    "high": 2.0,
    "critical": 4.0,
}


class TenantConfig:
    """One tenant's QoS envelope (see module docstring for semantics)."""

    __slots__ = (
        "name", "weight", "max_queued", "max_inflight", "priority",
        "max_subs",
    )

    def __init__(
        self,
        name: str,
        weight: float = 1.0,
        max_queued: int = 0,
        max_inflight: int = 0,
        priority: str = "standard",
        max_subs: int = 0,
    ):
        self.name = name
        self.weight = max(float(weight), 1e-3)
        self.max_queued = max(int(max_queued), 0)      # 0 = global cap only
        self.max_inflight = max(int(max_inflight), 0)  # 0 = unbounded
        self.priority = str(priority)
        # live-query subscription quota of the reference's config
        # grammar (its ivm/subs.py); parsed, unused by the port yet
        self.max_subs = max(int(max_subs), 0)

    @property
    def effective_weight(self) -> float:
        """DRR weight with the priority class folded in — the value the
        scheduler's weighted-fair pick actually races."""
        return self.weight * PRIORITY_FACTORS.get(self.priority, 1.0)

    def to_dict(self) -> dict:
        return {
            "weight": self.weight,
            "effective_weight": self.effective_weight,
            "max_queued": self.max_queued,
            "max_inflight": self.max_inflight,
            "priority": self.priority,
            "max_subs": self.max_subs,
        }


class QosConfig:
    """The tenant table.  Parsed once per scheduler construction from
    ``DGRAPH_TPU_QOS_TENANTS`` (a JSON object: tenant name → {weight,
    max_queued, max_inflight, priority}); unknown tenants inherit the
    ``DGRAPH_TPU_QOS_DEFAULT_{WEIGHT,QUEUED,INFLIGHT}`` defaults.  A
    malformed knob degrades to defaults-only (counted via
    note_swallowed) — a config typo must never refuse boot."""

    def __init__(
        self,
        tenants: Optional[Dict[str, TenantConfig]] = None,
        default_weight: float = 1.0,
        default_queued: int = 0,
        default_inflight: int = 0,
    ):
        self._tenants = dict(tenants or {})
        self._default_weight = default_weight
        self._default_queued = default_queued
        self._default_inflight = default_inflight
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls) -> "QosConfig":
        def _f(name: str, default: float) -> float:
            try:
                return float(os.environ.get(name, default))
            except (ValueError, OverflowError):
                return default

        dw = _f("DGRAPH_TPU_QOS_DEFAULT_WEIGHT", 1.0)
        dq = int(_f("DGRAPH_TPU_QOS_DEFAULT_QUEUED", 0))
        di = int(_f("DGRAPH_TPU_QOS_DEFAULT_INFLIGHT", 0))
        tenants: Dict[str, TenantConfig] = {}
        raw = os.environ.get("DGRAPH_TPU_QOS_TENANTS", "")
        if raw:
            try:
                data = json.loads(raw)
                if not isinstance(data, dict):
                    raise ValueError("DGRAPH_TPU_QOS_TENANTS must be a JSON object")
                for name, spec in data.items():
                    spec = spec or {}
                    tenants[str(name)] = TenantConfig(
                        str(name),
                        weight=spec.get("weight", dw),
                        max_queued=spec.get("max_queued", dq),
                        max_inflight=spec.get("max_inflight", di),
                        priority=spec.get("priority", "standard"),
                        max_subs=spec.get("max_subs", 0),
                    )
            except (ValueError, TypeError, OverflowError) as e:
                note_swallowed("qos.tenant_config", e)
                tenants = {}
        return cls(tenants, dw, dq, di)

    def tenant(self, name: str) -> TenantConfig:
        with self._lock:
            cfg = self._tenants.get(name)
            if cfg is None:
                cfg = TenantConfig(
                    name,
                    weight=self._default_weight,
                    max_queued=self._default_queued,
                    max_inflight=self._default_inflight,
                )
                # memoize bounded: tenant names are client input
                if len(self._tenants) < 4 * _LABEL_CAP:
                    self._tenants[name] = cfg
            return cfg

    def snapshot(self) -> Dict[str, dict]:
        with self._lock:
            return {n: c.to_dict() for n, c in sorted(self._tenants.items())}


# ------------------------------------------------------ weighted-fair pick


class DrrPicker:
    """Deficit-style weighted round-robin over tenants (the smooth-WRR
    formulation): every pick adds each candidate's weight to its credit,
    the highest credit wins and pays back the total — over any window
    the pick counts converge to the weight ratios, deterministically
    (candidates iterate sorted), with O(candidates) work and no clock.

    Used by the scheduler to choose WHICH tenant's due cohort flushes
    next, so a tenant flooding the queues earns cohort slots only in
    proportion to its weight."""

    def __init__(self):
        self._credit: Dict[str, float] = {}

    def pick(self, weights: Dict[str, float]) -> str:
        if not weights:
            raise ValueError("DrrPicker.pick needs at least one candidate")
        total = 0.0
        best = None
        best_c = 0.0
        for t in sorted(weights):
            w = max(float(weights[t]), 1e-3)
            total += w
            c = self._credit.get(t, 0.0) + w
            self._credit[t] = c
            if best is None or c > best_c:
                best, best_c = t, c
        self._credit[best] = best_c - total
        # bound the credit table: tenants that stopped sending must not
        # accrete state forever (their credit is only meaningful while
        # they compete anyway)
        if len(self._credit) > 4 * _LABEL_CAP:
            for t in list(self._credit):
                if t not in weights:
                    del self._credit[t]
        return best
