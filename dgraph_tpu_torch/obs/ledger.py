"""Per-query resource ledger: what did this request actually cost (copy
of ``dgraph_tpu/obs/ledger.py``).

One pooled :class:`Ledger` per request, installed in a context variable
for the request's thread and carried to the scheduler's flush worker
with the request; the engine charges hop routes, edges, stage time,
host<->device bytes, cache outcomes and coalescing to it, and
``finish`` drains it into bounded metric families at request end:
``dgraph_edges_traversed_total{tenant}`` (the north-star metric, edges
traversed per second, as a live per-tenant series),
``dgraph_ledger_hops_total{route}``, ``dgraph_ledger_stage_us_total{stage}``
and ``dgraph_ledger_bytes_total{dir}``.  ``/query?ledger=true`` returns
the account in the response extensions; a sampled request's trace root
carries it as its ``ledger`` attr.

Design constraints, in the flight recorder's order:

1. **One pooled struct per request, zero further allocations.**
   ``start()`` pops a recycled Ledger from a bounded free list;
   ``finish()`` drains, resets and returns it.
   ``dgraph_ledger_structs_total`` counts every ACTUAL construction
   (pool misses), so tests assert a zero delta across warm requests.
2. **``DGRAPH_TPU_LEDGER=0`` is byte-identical**: ``start()`` returns
   None, every instrumentation site branches on ``current() is None``
   first, and responses carry no ledger key in any mode unless the
   caller explicitly asked (``?ledger=true``).
3. **Attribution follows execution.**  A tier-2 result-cache hit or a
   singleflight follower records its cache/coalesced event and NO
   engine numbers; hop-merged union expansions land on the leader.
4. **Bounded label spaces.**  Tenant goes through qos.metric_label
   (cardinality-capped), routes and stages are fixed small sets.

``device_sync_ms`` is populated only on SAMPLED requests: the unsampled
path never waits on device results by design.  A request the mesh
serving plane served (``mesh/executor.py``) also carries ``mesh_ms``
(wall time inside mesh dispatches), ``mesh_chips`` (the widest mesh
they ran on) and ``exchange_bytes`` (the estimated cross-chip payload);
``finish`` drains them as the stages ``mesh`` and ``mesh_chip``
(wall × width).

Env: ``DGRAPH_TPU_LEDGER`` (default on; read per request).
"""

from __future__ import annotations

import contextvars
import os
import threading
from typing import Dict, Optional

from dgraph_tpu_torch.utils.metrics import (
    EDGES_TRAVERSED,
    LEDGER_BYTES,
    LEDGER_HOPS,
    LEDGER_STAGE_US,
    LEDGERS_CREATED,
)

_current: "contextvars.ContextVar[Optional[Ledger]]" = contextvars.ContextVar(
    "dgraph_tpu_torch_ledger", default=None
)


def enabled() -> bool:
    """The DGRAPH_TPU_LEDGER gate (default ON)."""
    return os.environ.get("DGRAPH_TPU_LEDGER", "1") != "0"


def current() -> Optional["Ledger"]:
    """The calling thread's active ledger, or None (gate off / not in a
    request).  Every instrumentation site checks this first."""
    return _current.get()


class Ledger:
    """One request's resource account.  Only ever constructed on a pool
    miss; every field is reset on release, so a recycled struct carries
    nothing across requests.

    Single-writer by construction: the handler thread owns it until the
    scheduler hands execution to a flush worker (the handler then blocks
    in ``req.wait()``), so plain ``+=`` needs no lock."""

    __slots__ = (
        "tenant", "edges", "hops", "host_ms", "device_ms",
        "device_sync_ms", "bytes_h2d", "bytes_d2h", "compiles",
        "cache_hits", "cache_misses", "cache_hit_bytes", "repairs",
        "coalesced", "exchange_bytes", "mesh_ms", "mesh_chips",
        "_race_serial",
    )
    # the single-writer claim above, checked by the armed lockset witness
    # (analysis/witness.py) with the hand-offs (activate, finish,
    # SchedRequest.complete/fail) as epoch boundaries.  ``compiles`` is
    # deliberately NOT listed: the build counter (obs/device.py) bumps it
    # from whichever thread triggered a kernel build, concurrently with
    # the request thread — a lost increment costs one count in a
    # per-request diagnostic (the process-wide dgraph_xla_compiles_total
    # twin is locked).
    __race_fields__ = frozenset({
        "tenant", "edges", "host_ms", "device_ms", "device_sync_ms",
        "bytes_h2d", "bytes_d2h", "cache_hits",
        "cache_misses", "cache_hit_bytes", "repairs", "coalesced",
        "exchange_bytes", "mesh_ms", "mesh_chips",
    })

    def __init__(self):
        LEDGERS_CREATED.add(1)
        self.hops: Dict[str, int] = {}
        self.reset()

    def reset(self) -> None:
        self.tenant = ""
        self.edges = 0
        self.hops.clear()
        self.host_ms = 0.0
        self.device_ms = 0.0
        self.device_sync_ms = 0.0
        self.bytes_h2d = 0
        self.bytes_d2h = 0
        self.compiles = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_hit_bytes = 0
        self.repairs = 0
        self.coalesced = 0
        # the mesh serving plane: wall time inside mesh dispatches, the
        # model-axis width they ran on (aggregate chip-time is
        # mesh_ms × mesh_chips) and the estimated exchange payload
        self.exchange_bytes = 0
        self.mesh_ms = 0.0
        self.mesh_chips = 0

    # -- instrumentation sites (callers checked current() is not None) ------

    def note_hop(self, route: str) -> None:
        self.hops[route] = self.hops.get(route, 0) + 1

    def note_cache(self, tier: str, event: str, nbytes: int) -> None:
        """One cache-tier probe outcome (tier ∈ hop/result; event is the
        core cache's hit/miss/stale verdict)."""
        if event == "hit":
            self.cache_hits += 1
            self.cache_hit_bytes += int(nbytes)
        else:
            self.cache_misses += 1

    def merge_engine_stats(self, stats: dict) -> None:
        """Fold one engine shell's per-request stats in at completion —
        the single source for edges and stage time, so the ledger can
        never disagree with the debug=true engine breakdown it rides
        beside.  Chain levels and tile join programs become hop routes
        here (they bypass the per-level expander entry)."""
        self.edges += int(stats.get("edges", 0))
        self.host_ms += stats.get("host_expand_ms", 0.0) + stats.get(
            "resolver_expand_ms", 0.0
        )
        self.device_ms += (
            stats.get("device_expand_ms", 0.0)
            + stats.get("chain_ms", 0.0)
            + stats.get("device_order_ms", 0.0)
            + stats.get("kway_ms", 0.0)
            + stats.get("mxu_join_ms", 0.0)
            + stats.get("tile_build_ms", 0.0)
        )
        lv = int(stats.get("chain_fused_levels", 0))
        if lv:
            self.hops["chain"] = self.hops.get("chain", 0) + lv
        mxu = sum(
            1 for r in stats.get("join_routes", ())
            if isinstance(r, dict) and r.get("route") == "mxu"
        )
        if mxu:
            self.hops["mxu"] = self.hops.get("mxu", 0) + mxu

    # -- reporting -----------------------------------------------------------

    def to_dict(self) -> dict:
        """The response-extension / span-attr rendering (stable keys, ms
        rounded).  The mesh keys appear only when a mesh dispatch ran
        this request."""
        d = {
            "edges": self.edges,
            "hops": dict(self.hops),
            "host_ms": round(self.host_ms, 3),
            "device_ms": round(self.device_ms, 3),
            "device_sync_ms": round(self.device_sync_ms, 3),
            "bytes_h2d": self.bytes_h2d,
            "bytes_d2h": self.bytes_d2h,
            "compiles": self.compiles,
            "cache_hits": self.cache_hits,
            "cache_misses": self.cache_misses,
            "cache_hit_bytes": self.cache_hit_bytes,
            "repairs": self.repairs,
            "coalesced": self.coalesced,
        }
        if self.mesh_chips:
            d["mesh_ms"] = round(self.mesh_ms, 3)
            d["mesh_chips"] = self.mesh_chips
            d["exchange_bytes"] = self.exchange_bytes
        return d


# bounded free list: at most (handler threads in flight) ledgers are live
# at once; 256 recycled structs cover any sane concurrency and the bound
# keeps a burst from pinning memory forever
_POOL_CAP = 256
_pool: list = []
_pool_lock = threading.Lock()


def start(tenant: str = "") -> Optional[Ledger]:
    """Acquire the request's pooled ledger, or None when the gate is
    off.  The caller owns activation (``activate``/``deactivate``) and
    MUST pair with ``finish``."""
    if not enabled():
        return None
    with _pool_lock:
        led = _pool.pop() if _pool else None
    if led is None:
        led = Ledger()
    led.tenant = tenant
    return led


def activate(led: Ledger):
    """Install ``led`` as the calling thread's ledger; returns the reset
    token.  The scheduler re-activates the same struct on its flush
    worker thread — one account per request, whatever thread runs it."""
    return _current.set(led)


def deactivate(token) -> None:
    _current.reset(token)


def finish(led: Ledger) -> dict:
    """Drain the ledger into the bounded metric families, recycle the
    struct, and return its final rendering (taken before the reset).
    "" (QoS off) reads as the default tenant."""
    from dgraph_tpu_torch.sched import qos as _qos

    out = led.to_dict()
    label = _qos.metric_label(led.tenant or _qos.DEFAULT_TENANT)
    if led.edges:
        EDGES_TRAVERSED.add(label, led.edges)
    for route, n in led.hops.items():
        LEDGER_HOPS.add(route, n)
    if led.host_ms:
        LEDGER_STAGE_US.add("host", int(led.host_ms * 1e3))
    if led.device_ms:
        LEDGER_STAGE_US.add("device", int(led.device_ms * 1e3))
    if led.device_sync_ms:
        LEDGER_STAGE_US.add("device_sync", int(led.device_sync_ms * 1e3))
    if led.mesh_ms:
        # every chip of a mesh dispatch is held for its wall time: "mesh"
        # is the wall clock, "mesh_chip" the aggregate chip-time
        LEDGER_STAGE_US.add("mesh", int(led.mesh_ms * 1e3))
        LEDGER_STAGE_US.add(
            "mesh_chip", int(led.mesh_ms * 1e3) * max(1, led.mesh_chips)
        )
    if led.bytes_h2d:
        LEDGER_BYTES.add("h2d", led.bytes_h2d)
    if led.bytes_d2h:
        LEDGER_BYTES.add("d2h", led.bytes_d2h)
    if led.cache_hit_bytes:
        LEDGER_BYTES.add("cache_hit", led.cache_hit_bytes)
    led.reset()
    with _pool_lock:
        if len(_pool) < _POOL_CAP:
            _pool.append(led)
    return out


def aggregate_summary() -> dict:
    """The /debug/bundle "ledger" section: process-wide aggregates of
    every family the per-request drains feed."""
    return {
        "edges_by_tenant": EDGES_TRAVERSED.snapshot(),
        "hops_by_route": LEDGER_HOPS.snapshot(),
        "stage_us": LEDGER_STAGE_US.snapshot(),
        "bytes": LEDGER_BYTES.snapshot(),
        "structs_created": LEDGERS_CREATED.value(),
    }
