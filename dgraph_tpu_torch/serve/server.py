"""HTTP serving surface of the port (the subset of
``dgraph_tpu/serve/server.py`` the port serves).

- ``POST /query`` — a query, a ``mutation {}`` block, or both; variables
  ride the ``X-Dgraph-Vars`` header; ``?debug=true`` adds the engine's
  stats to ``server_latency``, ``?ledger=true`` the request's resource
  ledger to ``extensions``.  ``X-Dgraph-Tenant`` names the request's QoS
  tenant and ``X-Dgraph-Timeout`` its budget in seconds.  The response
  body is built exactly as the reference builds it, so its JSON is
  byte-identical.  Under ``Accept: application/protobuf`` (or
  ``application/x-protobuf``) the body is the protobuf wire-format
  ``Response`` of graphresponse.proto instead (serve/proto.py), the
  bytes of the reference's ``encode_response``.  Sheds answer 429 with
  ``Retry-After`` (the global admission queue or the tenant's quota is
  full), an exhausted budget 504, a client that hung up 499, a device
  fault 503 with ``Retry-After`` (below).
- ``POST /subscribe`` — register a live query (ivm/subs.py): the body is
  a read-only query, variables and tenant ride the ``/query`` headers.
  Under ``Accept: text/event-stream`` (or ``?stream=1``) the answer is
  the subscription's server-sent-event stream on this connection,
  starting with the snapshot; otherwise its handle (``sub_id``,
  ``preds``).  ``GET /subscribe?id=`` attaches to a handle's stream,
  ``POST /subscribe/cancel?id=`` cancels it.  Over quota: 429 with
  ``Retry-After``.
- ``GET /health`` — ``OK`` while serving; ``?detail=1`` a JSON object
  with the device fault domain's state (``device``: utils/devguard.py),
  the elastic mesh fault domain's (``mesh``: epoch, chips, per-chip
  guard states, placement; mesh/fault.py) on a server with a mesh of
  more than one chip, and the storage plane's (``storage``: read-only
  latch, WAL bytes and records, sealed segments, snapshot age, the last
  recovery) when the store is durable.
- ``GET /metrics`` (and ``/debug/prometheus_metrics``) — the Prometheus
  text exposition of ``utils/metrics.py``; with ``Accept:
  application/openmetrics-text`` the OpenMetrics exposition, whose
  latency buckets carry exemplars (trace ids of the flight recorder).
- ``GET /debug/traces`` (the flight recorder's ring), ``/debug/traces/<id>``
  (one trace's spans; ``?format=chrome`` the Chrome trace_event form),
  ``/debug/slow_queries`` (the slow-query log) and ``/debug/requests``
  (the legacy sampled event ring) — 403 unless ``expose_trace``.  A
  request is sampled by the recorder's head sampler
  (``obs.configure(ratio=...)``, ``DGRAPH_TPU_TRACE_RATIO``, the CLI's
  ``--trace``) or by a sampled ``Traceparent`` header while the sampler
  is armed (ratio > 0); at ratio 0 no span is allocated.
- ``GET /debug/device`` — backend, device name, kernel builds, the
  device guard's state (``guard``) and the arenas' device residency
  (obs/device.py); ``GET /debug/bundle`` — one
  postmortem JSON (traces, slow queries, the planner's summary, qos,
  ivm, caches, device, ledger aggregates).
- ``GET /debug/planner`` — the planner (query/planner.py): calibration
  provenance and live rates, decision counts by (kind, route),
  mispredicts, the recent decisions with both estimates, the join
  tier's ring and the cohort controller's state.
- ``GET``/``POST /admin/cancel?trace_id=`` — cancel the live sampled,
  scheduled read of that trace: 200, the read answers 499; 404 when no
  live query holds the id.
- ``GET /debug/store`` — predicates with their edge and value counts,
  the query caches' occupancy (``qcache``), the predicate versions, the
  delta stream and the subscription table (``ivm``), the QoS tenant
  table (``qos``) and the join tier's route counts and recent decisions
  (``join``).
- ``GET /`` — the query console (``serve/dashboard.py``, the
  reference's page byte for byte); it fetches ``/health``, ``/query``,
  ``/debug/store`` and ``/share``.
- ``POST /share`` — keep a query text under a 16-hex id (answers
  ``{"code": "Success", "uids": {"share": id}}``); ``GET /share/<id>``
  gives it back as ``{"share": text}`` (404 when unknown).  The last
  1024 shares are kept (an LRU, not durable state).
- ``GET /admin/shutdown`` — stops the server.
- ``GET /admin/snapshot`` (``?wait=1`` blocks until the round is done)
  — one seal + compaction round of a durable store's WAL now.
- ``GET /admin/export`` — the store as gzipped N-Quads and a schema
  file under the server's export directory (``serve/export.py``).

A clustered server (``cluster=`` a ``ClusterService``, serving its
``ClusterStore``) also answers the intra-cluster plane, each endpoint
as the reference answers it: ``POST /raft/<g>`` (a raft frame),
``/raft-propose/<g>`` (a forwarded proposal; 409 with the leader hint
from a non-leader), ``/assign-uids`` and ``/join``; ``GET
/pred-snapshot?name=&since=`` (a predicate's CRC-framed record stream,
204 when unchanged since ``since``) and ``/predlist?group=``.  With a
cluster secret every one of them requires it (403 otherwise).
``/health?detail=1`` adds the peers' breakers, each group's raft state
and the degraded-read summary; ``/admin/snapshot`` compacts every
group's raft log; a read whose owner group is unreachable with nothing
cached answers 503 with ``Retry-After``.

Over a ``DurableStore`` (``models/wal.py``) every mutation is journaled
before it applies; with ``--sync`` its ack waits for a shared fsync
taken after the write lock is released (group commit), and a background
``Snapshotter`` keeps the WAL bounded.  ``DGRAPH_TPU_GROUP_COMMIT=0``
keeps the fsync inside the write lock, one a write;
``DGRAPH_TPU_SNAPSHOTTER=0`` starts no snapshotter (``/admin/snapshot``
then answers 404).  A disk fault latches the store
read-only: mutations answer 503 with ``Retry-After`` before they queue
on the write lock, while reads keep flowing.

Reads go through the cohort scheduler (``sched/scheduler.py``, gated by
``DGRAPH_TPU_SCHED``, default on): concurrent requests are admitted into
cohorts that run together under the read side of one readers-writer
lock, each member on an engine shell of its own over the shared arenas,
their same-predicate hops merged into one gather launch, a tier-2 result
cache in front.  Mutations take the write side and run on the server's
engine.  ``DGRAPH_TPU_SCHED=0`` restores the serial path: every request
under the write side on the server's engine, one at a time.  A server
given a ``profiler`` (a ``cProfile.Profile``: the CLI's ``--cpu``) runs
the serial path, the profiler enabled around each request's execution.
With ``dumpsg_path`` (the CLI's ``--dumpsg``) every request that ran a
query writes its blocks' execution shapes as one JSON file there
(``query/subgraph.dump_dict``; named by time and a sequence number).

Device faults (utils/devguard.py).  Every dispatch to the card runs
under the device guard's watchdog.  A classified fault that reaches a
request — a wedged dispatch (``DGRAPH_TPU_DEVICE_HANG_MS``), a domain
latched sick, a transient fault, or an OOM the per-level route's
eviction and retry did not cure — answers 503 ``ErrorServiceUnavailable``
with ``Retry-After`` the ceiling of ``DGRAPH_TPU_DEVICE_COOLDOWN_S``.
In a cohort each member it hit answers 503 and the flush worker lives
on.  Nothing is served from the host instead, unlike the reference.

TLS: a server given ``tls_cert`` (and ``tls_key``) terminates TLS 1.2
and up on its listener (stdlib ``ssl``; ``addr`` is then ``https://``),
the handshake deferred into each connection's thread.  The gRPC surface
(``protos.Dgraph`` and ``protos.Worker``) is ``serve/grpc_server.py``'s
``GrpcServer`` over this server, on a port of its own.
"""

from __future__ import annotations

import datetime
import hashlib
import itertools
import json
import os
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from collections import OrderedDict
from typing import Optional
from urllib.parse import parse_qs, urlparse

from dgraph_tpu_torch import gql, obs
from dgraph_tpu_torch.cluster.peerclient import StaleUnavailableError
from dgraph_tpu_torch.cluster.raft import NotLeaderError
from dgraph_tpu_torch.models.durability import (
    ReadOnlyError,
    Snapshotter,
    StorageFaultError,
)
from dgraph_tpu_torch.models.store import PostingStore
from dgraph_tpu_torch.obs import device as _device
from dgraph_tpu_torch.obs import ledger as _ledger
from dgraph_tpu_torch.query import planner as _planner
from dgraph_tpu_torch.query.engine import QueryEngine
from dgraph_tpu_torch.sched import qos as _qos
from dgraph_tpu_torch.sched.cohort import (
    SchedDeadlineError,
    SchedOverloadError,
    SchedQuotaError,
)
from dgraph_tpu_torch.sched.qos import QueryCancelledError
from dgraph_tpu_torch.sched.scheduler import CohortScheduler, sched_enabled
from dgraph_tpu_torch.serve.export import export as export_rdf
from dgraph_tpu_torch.utils import devguard as _devguard
from dgraph_tpu_torch.utils import planconfig as _planconfig
from dgraph_tpu_torch.utils.health import HealthGate
from dgraph_tpu_torch.utils.metrics import (
    NUM_QUERIES,
    PENDING_QUERIES,
    QUERY_CANCELLED,
    QUERY_LATENCY,
    TENANT_LATENCY,
    metrics,
)
from dgraph_tpu_torch.utils.rwlock import RWLock
from dgraph_tpu_torch.utils.trace import Latency, Tracer

_CORS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "POST, GET, OPTIONS",
    "Access-Control-Allow-Headers": "Content-Type",
}


class DgraphServer:
    """Owns the store + engine and serves the HTTP surface.  ``device``
    is the engine's device: ``cuda`` by default (raises without a GPU).
    ``mesh`` (``parallel.make_mesh``) row-shards every predicate of at
    least ``DGRAPH_TPU_MESH_SHARD_ROWS`` rows (default 4096) over its
    chips; None asks :func:`_auto_mesh` (``DGRAPH_TPU_MESH``).
    ``cluster`` is the ``ClusterService`` whose ``ClusterStore`` is
    ``store`` on a clustered server, else None."""

    def __init__(
        self,
        store: PostingStore,
        port: int = 0,
        bind: str = "127.0.0.1",
        device=None,
        arena_budget_mb: int = 0,
        export_path: str = "export",
        cluster=None,
        trace_ratio: float = 0.0,
        expose_trace: bool = True,
        tls_cert: str = "",
        tls_key: str = "",
        profiler=None,
        dumpsg_path: str = "",
        mesh=None,
    ):
        self.cluster = cluster
        self.store = store
        self.export_path = export_path
        # the legacy per-request event ring (/debug/requests), sampled at
        # ``trace_ratio``; the flight recorder's own head sampler is the
        # process recorder's (obs.configure, DGRAPH_TPU_TRACE_RATIO).
        # ``expose_trace`` gates the trace surfaces (403 when off)
        self.tracer = Tracer(trace_ratio)
        self.expose_trace = expose_trace
        # --dumpsg: the directory of each request's execution-shape dump
        self.dumpsg_path = dumpsg_path
        # --cpu: a cProfile.Profile enabled around each request's
        # execution; it is not thread-safe, so such a server runs the
        # serial path
        self._profiler = profiler
        # shared query texts (POST /share): a bounded LRU, not durable
        self._shares: "OrderedDict[str, str]" = OrderedDict()
        self._max_shares = 1024
        self.engine = QueryEngine(
            store, device=device,
            arena_budget_bytes=(arena_budget_mb * (1 << 20)) or None,
            mesh=mesh if mesh is not None else _auto_mesh(device),
            # rows at/above this shard over the mesh's model axis
            shard_threshold=int(
                os.environ.get("DGRAPH_TPU_MESH_SHARD_ROWS", "4096")
            ),
        )
        # planner calibration (query/planner.py): a persisted calibration
        # of this device's backend loads on every boot; the measurement
        # pass runs only under DGRAPH_TPU_CALIBRATE=1.  A measurement that
        # fails raises: a card that cannot launch the kernels is sick
        if _planner.enabled():
            _planner.boot(
                measure_now=_planconfig.calibrate_at_boot(),
                device=self.engine.device,
            )
        # RW lock: read-only queries run CONCURRENTLY over the shared
        # arenas; mutations (and every request on the serial path) take
        # the exclusive side
        self._engine_lock = RWLock()
        self._stop_lock = threading.Lock()
        # exports write a minute-stamped file; two concurrent exports
        # would interleave gzip streams into one path
        self._export_lock = threading.Lock()
        # the readiness bit behind /health: set once serving, cleared
        # at stop (the reference's HealthGate)
        self.health = HealthGate()
        self._stopped = False
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._bind = bind
        self._port = port
        # TLS termination: a PEM certificate chain (and its key, when not
        # in the same file); the gRPC listener (serve/grpc_server.py)
        # serves TLS from the same pair
        self._tls_cert = tls_cert
        self._tls_key = tls_key
        # cohort scheduler (sched/): gated by DGRAPH_TPU_SCHED (default
        # on); =0, or a profiler, restores the serial per-request path
        self.scheduler = (
            CohortScheduler(self)
            if sched_enabled() and profiler is None else None
        )
        # incremental view maintenance (ivm/): attach the mutation delta
        # stream to the store and stand up the live-query registry
        # (POST /subscribe).  A ClusterStore keeps per-predicate versions
        # for cache keys only and has no local mutation path to stream
        # (supports_ivm_stream = False): no stream, no subscriptions.  A
        # durable store is attached after its recovery, so replayed
        # records publish nothing
        self.subs = None
        from dgraph_tpu_torch import ivm as _ivm

        if (
            _ivm.ivm_enabled()
            and getattr(store, "pred_versions", None) is not None
            and getattr(store, "supports_ivm_stream", True)
        ):
            stream = _ivm.attach_stream(store)
            from dgraph_tpu_torch.ivm import subs as _subs

            if _subs.subs_enabled():
                self.subs = _subs.SubscriptionRegistry(self, stream)
        # storage plane (models/wal.py + models/durability.py), for a
        # DurableStore: group commit moves the --sync fsync out of the
        # exclusive write section into a shared post-lock barrier, so
        # concurrent writers amortize one fsync; the snapshotter's
        # seal/compact loop keeps the WAL bounded under sustained writes
        # (DGRAPH_TPU_GROUP_COMMIT=0 keeps the fsync inside the write
        # lock, DGRAPH_TPU_SNAPSHOTTER=0 starts no snapshotter)
        self.snapshotter = None
        if (
            hasattr(store, "enable_group_commit")
            and os.environ.get("DGRAPH_TPU_GROUP_COMMIT", "1") != "0"
        ):
            store.enable_group_commit()
        if (
            hasattr(store, "seal_segment")
            and os.environ.get("DGRAPH_TPU_SNAPSHOTTER", "1") != "0"
        ):
            self.snapshotter = Snapshotter(
                store, exclusive=self._engine_lock.write
            )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        # deep accept backlog: the stdlib default (5) drops connections
        # the moment a few dozen clients connect at once, and the TCP
        # retransmit turns into a phantom second of latency — the listen
        # queue must absorb a burst of the whole client fleet
        class _Server(ThreadingHTTPServer):
            request_queue_size = 128

        self._httpd = _Server((self._bind, self._port), _make_handler(self))
        if self._tls_cert:
            # TLS termination (x/tls_helper.go analog): stdlib ssl, TLS
            # 1.2 and up.  do_handshake_on_connect=False moves the
            # handshake off the accept loop into the connection's
            # handler thread, under its socket timeout: a stalled client
            # must not block accept()
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.minimum_version = ssl.TLSVersion.TLSv1_2
            ctx.load_cert_chain(self._tls_cert, self._tls_key or None)
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True,
                do_handshake_on_connect=False,
            )
        self._port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="dgraph-http", daemon=True
        )
        self._thread.start()
        if self.snapshotter is not None:
            self.snapshotter.start()
        if self.subs is not None:
            self.subs.start()
        _device.stamp_build_info(self.engine.device)
        self.health.set_ok(True)

    @property
    def port(self) -> int:
        return self._port

    @property
    def addr(self) -> str:
        scheme = "https" if self._tls_cert else "http"
        return f"{scheme}://{self._bind}:{self._port}"

    def healthy(self) -> bool:
        return self.health.ok()

    def stop(self) -> None:
        """Stop accepting, wait for the listener thread, close a durable
        store (its WAL flushed and synced) and mark the server stopped
        (idempotent)."""
        with self._stop_lock:
            if self._stopped:
                return
            self.health.set_ok(False)
            if self._httpd is not None:
                self._httpd.shutdown()
                self._httpd.server_close()
                self._httpd = None
            if self._thread is not None:
                self._thread.join(timeout=30)
            if self.subs is not None:
                # before the scheduler: the notifier's in-flight
                # re-evaluations ride it, which must still admit while
                # they drain; every subscription is cancelled
                self.subs.stop()
            if self.scheduler is not None:
                # before the write lock: queued cohorts must drain (fail
                # fast) or they would wait on a read lock that never comes
                self.scheduler.stop()
            if self.snapshotter is not None:
                # likewise before the write lock: a mid-seal snapshotter
                # holds it and must finish (or be told to stop) first
                self.snapshotter.stop()
            with self._engine_lock.write():  # in-flight requests finish
                if self.cluster is not None:
                    self.cluster.stop()
                if hasattr(self.store, "close"):
                    self.store.close()
                self._stopped = True

    def wait(self) -> None:
        """Block until the server is stopped (the CLI's main loop)."""
        while not self._stopped:
            time.sleep(0.2)

    # -- request execution -------------------------------------------------

    def run_query(
        self,
        text: str,
        variables: Optional[dict] = None,
        debug: bool = False,
        ledger_out: bool = False,
        timeout_s: Optional[float] = None,
        tenant: str = "",
        cancel_probe=None,
        trace_ctx=None,
    ) -> dict:
        """Parse, execute (mutation and/or queries) and return the
        response dict with its latency map.

        ``timeout_s`` is the caller's remaining budget (X-Dgraph-Timeout):
        a scheduled request past it sheds with SchedDeadlineError while
        queued, and — under QoS — its CancelToken stops execution at the
        next hop once the budget lapses mid-flight (504 either way).
        ``tenant`` is the QoS scope and ``cancel_probe`` an optional
        transport-liveness callable (True when the client is GONE).
        All three serve scheduled reads only; mutations and the serial
        path run to completion, as in the reference.

        ``trace_ctx`` (obs.TraceContext) is the caller's incoming W3C
        traceparent, if any: a sampled upstream makes this request's
        flight-recorder root join its trace (while the local sampler is
        armed).  When sampled, the Latency stage marks are mirrored as
        ``parsing``/``processing`` spans under the root, and a scheduled
        read's CancelToken is registered under the trace id for
        ``/admin/cancel``."""
        from dgraph_tpu_torch.query import outputnode

        NUM_QUERIES.add(1)
        PENDING_QUERIES.add(1)
        tr = self.tracer.begin()
        lat = Latency()
        t0 = time.monotonic()
        sched = self.scheduler
        qos_on = sched is not None and sched.qos is not None
        token = None
        if qos_on:
            tenant = _qos.resolve_tenant(tenant)
            token = _qos.CancelToken(timeout_s, tenant=tenant)
            if cancel_probe is not None:
                token.attach_probe(cancel_probe)
        else:
            tenant = ""
        root = obs.start_request("query", trace_ctx)
        if root is not None:
            root.set_attr("query", text[:200])
            if self.cluster is not None:
                root.set_attr("node", self.cluster.node_id)
            if qos_on:
                root.set_attr("tenant", tenant)
            root.__enter__()  # paired with __exit__ in the finally below
        # per-query resource ledger (obs/ledger.py): one pooled struct for
        # this request's whole serving path; None under
        # DGRAPH_TPU_LEDGER=0, and then every downstream site is a dead
        # None-check
        led = _ledger.start(tenant)
        ltoken = _ledger.activate(led) if led is not None else None
        try:
            with obs.child("parsing"):
                parsed = gql.parse(text, variables)
            lat.record_parsing()
            tr.printf("parsed: %d queries, mutation=%s", len(parsed.queries),
                      parsed.mutation is not None)
            if parsed.mutation is not None:
                # disk-fault read-only mode: shed mutations BEFORE they
                # queue on the write lock (reads keep flowing); the
                # handler maps this to 503 + Retry-After
                ro = getattr(self.store, "storage_readonly", None)
                if ro is not None and ro():
                    st = self.store.health
                    raise ReadOnlyError(
                        "storage is in read-only mode "
                        f"({st.last_site}: {st.last_error}); "
                        "mutations shed until the re-arm probe clears",
                        retry_after=st.probe_interval_s,
                    )
            out: dict = {}
            with obs.child("processing"):
                if sched is not None and parsed.mutation is None:
                    # read-only: ride a cohort (the member thread sets
                    # DEBUG_UIDS for the encode and folds its stats into
                    # the ledger).  The key makes equal requests
                    # singleflight-coalescible AND tier-2 result-cacheable.
                    vkey = (
                        json.dumps(variables, sort_keys=True)
                        if variables else ""
                    )
                    if token is not None and root is not None:
                        # the /admin/cancel?trace_id= hook: registered
                        # ONLY for scheduled reads — the inline mutation
                        # path has no checkpoints, and the endpoint must
                        # 404 rather than claim a cancel it cannot
                        # deliver.  Sampled requests are exactly the ones
                        # an operator can see in /debug/traces.
                        _qos.REGISTRY.register(root.trace_id, token)
                    result, stats = sched.run(
                        parsed, debug=debug, timeout_s=timeout_s,
                        key=(text, vkey, debug), tenant=tenant, cancel=token,
                    )
                    out.update(result)
                else:
                    # mutations, and every request on the serial path: the
                    # exclusive side, on the server's engine
                    debug_token = outputnode.DEBUG_UIDS.set(debug)
                    try:
                        with self._engine_lock.write():
                            stats = self._run_serial(parsed, out)
                    finally:
                        outputnode.DEBUG_UIDS.reset(debug_token)
                    if parsed.mutation is not None:
                        # group-commit durability barrier, OUTSIDE the
                        # write lock: the mutation is applied and
                        # journaled; the ack (this response) waits for a
                        # shared fsync that concurrent writers amortize
                        # (no-op unless enable_group_commit ran)
                        barrier = getattr(self.store, "sync_barrier", None)
                        if barrier is not None:
                            barrier()
                    if led is not None:
                        led.merge_engine_stats(stats)
            lat.record_processing()
            tr.printf("processed")
            lat.record_json()
            out["server_latency"] = lat.to_map()
            if ledger_out and led is not None:
                out.setdefault("extensions", {})["ledger"] = led.to_dict()
            if debug:
                # a hop MERGED across requests (HopMerger) attributes the
                # whole union's edges and device time to the member that
                # led it: cohort-attributed, as in the reference;
                # DGRAPH_TPU_SCHED=0 restores exact per-request accounting
                out["server_latency"]["engine"] = {
                    k: (round(v, 3) if isinstance(v, float) else v)
                    for k, v in stats.items()
                }
                if _devguard.enabled():
                    # the device fault domain's state beside the stats
                    # (the reference stamps it on a failed-over
                    # response; the port has no failover to stamp)
                    out["server_latency"]["engine"]["device_guard"] = (
                        _devguard.summary()
                    )
            return out
        except BaseException as e:
            if root is not None:
                root.set_attr("error", type(e).__name__)
                if isinstance(e, QueryCancelledError):
                    # a cancelled query's trace says so explicitly
                    root.set_attr("outcome", "cancelled")
            if isinstance(e, QueryCancelledError):
                QUERY_CANCELLED.add(
                    (e.reason, _qos.metric_label(tenant or e.tenant))
                )
            raise
        finally:
            PENDING_QUERIES.add(-1)
            dur = time.monotonic() - t0
            if led is not None:
                # drain to the per-tenant/per-route series and recycle
                # the struct; a sampled trace carries the same account as
                # a root attr (before __exit__ publishes it)
                _ledger.deactivate(ltoken)
                summary = _ledger.finish(led)
                if root is not None:
                    root.set_attr("ledger", summary)
            trace_id = root.trace_id if root is not None else None
            if root is not None:
                if token is not None:
                    # identity-checked: a concurrent request sharing this
                    # trace id keeps ITS registration
                    _qos.REGISTRY.unregister(root.trace_id, token)
                root.__exit__(None, None, None)  # publish to the ring
            if qos_on:
                TENANT_LATENCY.observe(_qos.metric_label(tenant), dur)
            # slow-query tail sampling is independent of the head
            # sampler: an offender at ratio 0 still gets a structured log
            # line and a synthetic trace — run it BEFORE the histogram so
            # the tail bucket's exemplar can point at that trace too
            slow_tid = obs.get_recorder().note_slow(text, dur, trace_id)
            # the latency histogram carries the trace as an OpenMetrics
            # exemplar: the bucket this request landed in links straight
            # to /debug/traces/<id>
            QUERY_LATENCY.observe(dur, trace_id=trace_id or slow_tid)
            self.tracer.finish(tr, "query", text[:120])


    def _run_serial(self, parsed, out: dict) -> dict:
        """Execute on the server's engine (the caller holds the write
        lock), the profiler enabled around it; write the request's
        execution-shape dump.  Returns the engine's stats."""
        eng = self.engine
        eng.dump_shapes = bool(self.dumpsg_path)
        if self._profiler is not None:
            self._profiler.enable()
        try:
            out.update(eng.run_parsed(parsed))
        finally:
            if self._profiler is not None:
                self._profiler.disable()
        if self.dumpsg_path and eng.last_dump:
            self.dump_subgraphs(eng.last_dump)
        return eng.stats

    _dump_seq = itertools.count()

    def dump_subgraphs(self, dump) -> None:
        """Write one request's execution-shape dump under ``dumpsg_path``
        as ``<date>.<time>.<µs>.<seq>.json``; a failed write never fails
        the query."""
        try:
            os.makedirs(self.dumpsg_path, exist_ok=True)
            # the sequence number keeps two dumps in one microsecond apart
            name = "%s.%06d.json" % (
                datetime.datetime.now().strftime("%Y%m%d.%H%M%S.%f"),
                next(self._dump_seq),
            )
            with open(os.path.join(self.dumpsg_path, name), "w") as f:
                json.dump(dump, f, indent=1, default=str)
        except (OSError, ValueError):
            pass

    def share(self, text: str) -> str:
        """Keep ``text`` under its id (the first 16 hex digits of its
        SHA-256) in the bounded LRU; returns the id."""
        sid = hashlib.sha256(text.encode()).hexdigest()[:16]
        self._shares[sid] = text
        self._shares.move_to_end(sid)
        while len(self._shares) > self._max_shares:
            self._shares.popitem(last=False)
        return sid


def _auto_mesh(device=None):
    """The mesh a server on a card builds when none is given: one over
    every visible card, whose big predicates then expand row-sharded
    through the mesh serving plane (dgraph_tpu_torch/mesh).  A server
    whose ``device`` is not CUDA (``None`` is the default ``cuda``) gets
    none.

    ``DGRAPH_TPU_MESH`` (the reference's tri-state, over
    ``torch.cuda.device_count()``):
      "0"/"off"        — never: unsharded serving;
      "1"/"auto"/unset — on when more than one card is visible; on
                         distinct cards an arena then shards only where
                         the crossover model says it wins or one card
                         cannot hold it (``ArenaManager.use_mesh_for``);
      "force"          — always: a 1-wide mesh over ``cuda:0`` on one
                         card (the mesh code paths run, results
                         unchanged); raises without a GPU.
    A mesh of virtual chips is built by the caller
    (``DgraphServer(mesh=make_mesh(devices=[cuda:0] * 4))``); the CLI has
    no flag for it."""
    import torch

    if torch.device(device if device is not None else "cuda").type != "cuda":
        return None
    mode = os.environ.get("DGRAPH_TPU_MESH", "auto")
    if mode in ("0", "off"):
        return None
    if mode != "force" and torch.cuda.device_count() < 2:
        return None
    from dgraph_tpu_torch.parallel import make_mesh

    return make_mesh()


def _make_handler(srv: DgraphServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        timeout = 60  # bounds reads AND the deferred TLS handshake below
        disable_nagle_algorithm = True
        server_version = "dgraph-tpu-torch/0.1"

        def setup(self):
            super().setup()
            # the deferred TLS handshake, in this connection's thread and
            # under this connection's timeout
            import ssl

            if isinstance(self.request, ssl.SSLSocket):
                try:
                    self.request.do_handshake()
                except (ssl.SSLError, OSError):
                    self.close_connection = True
                    raise

        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, body: bytes, ctype: str = "application/json",
                   extra_headers: Optional[dict] = None):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in _CORS.items():
                self.send_header(k, v)
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _err(self, code: int, msg: str, kind: str = "ErrorInvalidRequest",
                 extra: Optional[dict] = None, headers: Optional[dict] = None):
            body = {"code": kind, "message": msg}
            body.update(extra or {})
            self._reply(code, json.dumps(body).encode(), extra_headers=headers)

        def _disconnect_probe(self):
            """Transport-liveness probe for cooperative cancellation
            (None when QoS is off): peeks the socket for EOF without
            consuming pipelined bytes, the raw fd under TLS
            (sched/qos.py)."""
            if srv.scheduler is None or srv.scheduler.qos is None:
                return None
            return _qos.socket_disconnect_probe(self.connection)

        def _subscribe(self, body: str, qs: dict):
            """Register a live query (ivm/subs.py).  An SSE client gets
            the event stream on this connection, starting with the
            snapshot; otherwise the answer is the handle to attach to."""
            if srv.subs is None:
                return self._err(404, "subscriptions disabled "
                                      "(DGRAPH_TPU_IVM/DGRAPH_TPU_SUBS)")
            from dgraph_tpu_torch.ivm.subs import SubQuotaError

            try:
                vars_hdr = self.headers.get("X-Dgraph-Vars")
                variables = json.loads(vars_hdr) if vars_hdr else None
                sub = srv.subs.register(
                    body, variables,
                    tenant=self.headers.get("X-Dgraph-Tenant") or "",
                )
            except SubQuotaError as e:
                return self._err(
                    429, str(e), "ErrorServiceUnavailable",
                    extra={"tenant": e.tenant},
                    headers={"Retry-After": str(
                        max(1, int(round(e.retry_after))))},
                )
            except Exception as e:  # noqa: BLE001 — the reference's 400
                return self._err(400, str(e))
            stream = (
                "text/event-stream" in self.headers.get("Accept", "")
                or qs.get("stream", ["0"])[0] in ("1", "true")
            )
            if stream:
                return self._sse_stream(sub)
            return self._reply(200, json.dumps({
                "code": "Success",
                "sub_id": sub.id,
                "preds": (
                    sorted(sub.footprint) if sub.footprint is not None else None
                ),
            }).encode())

        def _sse_stream(self, sub):
            """Server-sent-events pump for one subscription: a
            close-delimited stream (no Content-Length), one ``event:``
            frame per pushed event, comment heartbeats while idle so a
            vanished client surfaces as a write error within a beat.
            The connection owns the subscription: a transport error
            cancels it."""
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            self.close_connection = True
            try:
                while True:
                    ev = sub.next_event(timeout=2.0)
                    if ev is None:
                        self.wfile.write(b": ping\n\n")
                        self.wfile.flush()
                        continue
                    frame = (
                        f"event: {ev.get('kind', 'update')}\n"
                        f"id: {ev.get('seq', 0)}\n"
                        f"data: {json.dumps(ev, default=str)}\n\n"
                    )
                    self.wfile.write(frame.encode())
                    self.wfile.flush()
                    if ev.get("kind") == "cancelled":
                        return
            except OSError:
                srv.subs.cancel(sub.id, reason="disconnect")

        def do_OPTIONS(self):
            self._reply(200, b"")

        def do_GET(self):
            u = urlparse(self.path)
            path = u.path
            qs = parse_qs(u.query)
            if path == "/health" and qs.get("detail", ["0"])[0] in ("1", "true"):
                detail = {"ok": srv.healthy()}
                if srv.cluster is not None:
                    # peer/breaker/raft-leader summary (cluster/
                    # peerclient.py); the bare /health stays OK/503
                    detail.update(srv.cluster.health_summary())
                status = getattr(srv.store, "storage_status", None)
                if status is not None:
                    detail["storage"] = status()
                # device fault domain (utils/devguard.py): per-domain
                # state, fault counts and the re-admission probe's score
                detail["device"] = {
                    "enabled": _devguard.enabled(),
                    "domains": _devguard.summary(),
                }
                # the elastic mesh fault domain (mesh/fault.py): epoch,
                # per-chip guard states, placement, drains in flight
                dom = srv.engine.arenas.mesh_fault
                if dom is not None:
                    detail["mesh"] = dom.status()
                self._reply(200 if srv.healthy() else 503,
                            json.dumps(detail).encode())
            elif path == "/health":
                if srv.healthy():
                    self._reply(200, b"OK", "text/plain")
                else:
                    self._reply(503, b"\"uninitialized\"")
            elif path == "/":
                from dgraph_tpu_torch.serve.dashboard import DASHBOARD_HTML

                self._reply(200, DASHBOARD_HTML.encode(), "text/html")
            elif path.startswith("/share/"):
                q = srv._shares.get(path.rsplit("/", 1)[1])
                if q is None:
                    self._err(404, "no such share")
                else:
                    self._reply(200, json.dumps({"share": q}).encode())
            elif path in ("/metrics", "/debug/prometheus_metrics"):
                # content negotiation: a scraper asking for OpenMetrics
                # gets histogram bucket EXEMPLARS (trace ids that
                # resolve in /debug/traces) + # EOF; everyone else the
                # classic format under its versioned content type
                if "application/openmetrics-text" in self.headers.get("Accept", ""):
                    self._reply(200, metrics.openmetrics_text().encode(),
                                "application/openmetrics-text; version=1.0.0; "
                                "charset=utf-8")
                else:
                    self._reply(200, metrics.prometheus_text().encode(),
                                "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/debug/device":
                # device telemetry (obs/device.py): backend identity,
                # residency vs budget, program caches, kernel builds —
                # the gauges refresh as a side effect
                self._reply(200, json.dumps(_device.snapshot(srv)).encode())
            elif path == "/debug/bundle":
                # ONE postmortem JSON: the traces ring, slow queries, the
                # route gates and join ring, qos, ivm, caches, device and
                # ledger aggregates, snapshotted together
                rec = obs.get_recorder()
                bundle = {
                    "generated_unix": time.time(),
                    "traces": rec.traces() if srv.expose_trace else None,
                    "slow_queries": (
                        rec.slow_queries() if srv.expose_trace else None
                    ),
                    "planner": _planner.debug_summary(
                        scheduler=srv.scheduler
                    ),
                    "qos": (
                        srv.scheduler.qos_state()
                        if srv.scheduler is not None
                        else None
                    ),
                    "ivm": _ivm_stats(srv),
                    "qcache": _qcache_stats(srv),
                    "device": _device.snapshot(srv),
                    "ledger": _ledger.aggregate_summary(),
                }
                self._reply(200, json.dumps(bundle, default=str).encode())
            elif path == "/debug/planner":
                # the route-decision view (query/planner.py): calibration
                # and live rates, decision counts with mispredicts, the
                # recent ring (both estimates, and the measured latency
                # once closed), the join ring and the cohort controller
                self._reply(
                    200,
                    json.dumps(
                        _planner.debug_summary(scheduler=srv.scheduler)
                    ).encode(),
                )
            elif path == "/debug/requests":
                if not srv.expose_trace:
                    return self._err(403, "tracing not exposed")
                self._reply(200, json.dumps(srv.tracer.recent()).encode())
            elif path == "/debug/traces" or path.startswith("/debug/traces/"):
                # the flight-recorder ring (obs/spans.py): listing, one
                # trace's merged span tree, or the Chrome trace_event
                # export (?format=chrome) for chrome://tracing / Perfetto
                if not srv.expose_trace:
                    return self._err(403, "tracing not exposed")
                rec = obs.get_recorder()
                if path == "/debug/traces":
                    return self._reply(200, json.dumps(rec.traces()).encode())
                t = rec.trace(path.rsplit("/", 1)[1])
                if t is None:
                    return self._err(404, "no such trace")
                if qs.get("format", [""])[0] == "chrome":
                    t = obs.chrome_trace(t)
                self._reply(200, json.dumps(t).encode())
            elif path == "/debug/slow_queries":
                if not srv.expose_trace:
                    return self._err(403, "tracing not exposed")
                self._reply(
                    200, json.dumps(obs.get_recorder().slow_queries()).encode()
                )
            elif path == "/admin/cancel":
                self._admin_cancel(qs)
            elif path == "/subscribe":
                # attach to a registered subscription's event stream
                if srv.subs is None:
                    return self._err(404, "subscriptions disabled")
                sid = qs.get("id", [""])[0]
                sub = srv.subs.get(sid) if sid else None
                if sub is None:
                    return self._err(404, "no such subscription")
                self._sse_stream(sub)
            elif path == "/debug/store":
                from dgraph_tpu_torch.query import joinplan

                with srv._engine_lock.read():
                    stats = _store_stats(srv.store)
                stats["qcache"] = _qcache_stats(srv)
                stats["ivm"] = _ivm_stats(srv)
                stats["qos"] = (
                    srv.scheduler.qos_state()
                    if srv.scheduler is not None
                    else None
                )
                stats["join"] = joinplan.debug_summary()
                self._reply(200, json.dumps(stats).encode())
            elif path == "/admin/export":
                try:
                    with srv._export_lock, srv._engine_lock.read():
                        info = export_rdf(srv.store, srv.export_path)
                except OSError as e:
                    return self._err(500, str(e), "ErrorInternal")
                self._reply(200, json.dumps(
                    {"code": "Success", "message": "Export completed.", **info}
                ).encode())
            elif path == "/admin/snapshot" and srv.cluster is not None:
                # clustered: compact every group's raft log (same
                # trigger machinery as the store WAL's snapshotter)
                srv.cluster.snapshot_all()
                self._reply(200, json.dumps(
                    {"code": "Success",
                     "message": "Raft snapshot requested for all groups."}
                ).encode())
            elif path == "/admin/snapshot":
                if srv.snapshotter is None:
                    return self._err(404, "store has no snapshotter")
                wait = qs.get("wait", ["0"])[0] in ("1", "true")
                if not srv.snapshotter.trigger(wait=wait):
                    return self._err(500, "snapshot failed; see /health?detail=1",
                                     "ErrorInternal")
                self._reply(200, json.dumps(
                    {"code": "Success",
                     "message": "Snapshot completed." if wait else "Snapshot triggered."}
                ).encode())
            elif path == "/admin/shutdown":
                self._reply(200, json.dumps(
                    {"code": "Success", "message": "Server is shutting down"}
                ).encode())
                threading.Thread(target=srv.stop, daemon=True).start()
            elif path == "/pred-snapshot":
                # cross-server read plane (ServeTask analog): versioned
                # predicate snapshot for groups other servers don't place
                if srv.cluster is None:
                    return self._err(404, "not clustered")
                if not self._cluster_authorized():
                    return self._err(403, "cluster secret required")
                name = qs.get("name", [""])[0]
                since = int(qs.get("since", ["-1"])[0])
                # server half of the distributed trace: a sampled remote
                # reader's traceparent makes THIS node record its leg of
                # the snapshot serve under the same trace_id
                tctx = obs.parse_traceparent(self.headers.get("Traceparent"))
                with obs.server_span("peer.pred-snapshot", tctx) as ss:
                    ss.set_attr("node", srv.cluster.node_id)
                    ss.set_attr("pred", name)
                    gid = srv.cluster.conf.belongs_to(name)
                    g = srv.cluster.groups.get(gid)
                    if g is None:
                        return self._err(404, f"group {gid} not served here")
                    from dgraph_tpu_torch.cluster.replica import pred_to_bytes

                    with g._lock:
                        ver = g.pred_version(name)
                        body = (
                            b"" if ver == since else pred_to_bytes(g.store, name)
                        )
                    ss.set_attr("bytes", len(body))
                    try:
                        self.send_response(204 if ver == since else 200)
                        self.send_header("X-Pred-Version", str(ver))
                        self.send_header("Content-Length", str(len(body)))
                        self.end_headers()
                        if ver != since:
                            self.wfile.write(body)
                    except (BrokenPipeError, ConnectionResetError):
                        # the reader's attempt timed out while the
                        # snapshot was encoded: it retries (or degrades)
                        # on its side
                        self.close_connection = True
            elif path == "/predlist":
                if srv.cluster is None:
                    return self._err(404, "not clustered")
                if not self._cluster_authorized():
                    return self._err(403, "cluster secret required")
                gid = int(qs.get("group", ["-1"])[0])
                g = srv.cluster.groups.get(gid)
                if g is None:
                    return self._err(404, f"group {gid} not served here")
                with g._lock:
                    names = sorted(g.store._preds.keys())
                self._reply(200, json.dumps(names).encode())
            else:
                self._err(404, "no such endpoint")

        def _admin_cancel(self, qs):
            """Explicit cooperative cancellation: flip the live
            CancelToken registered under this trace id (sampled,
            scheduled reads only — exactly the ones visible in
            /debug/traces).  The query stops at its next hop checkpoint
            and answers 499; this endpoint merely flips the flag (GET as
            in the reference, POST as well)."""
            tid = qs.get("trace_id", [""])[0]
            if not tid:
                return self._err(400, "trace_id required")
            if not _qos.REGISTRY.cancel(tid, reason="admin"):
                return self._err(404, "no live query under that trace_id")
            self._reply(200, json.dumps({
                "code": "Success",
                "message": f"cancel requested for trace {tid}",
            }).encode())

        def _cluster_authorized(self) -> bool:
            """Gate for the intra-cluster plane (/raft*, /assign-uids,
            /join, /pred-snapshot, /predlist): with a shared secret
            configured every peer request must carry it — these endpoints
            share the public port, and an unauthenticated one would let
            anyone with network reach inject forged raft frames or
            arbitrary proposals."""
            secret = srv.cluster.auth.secret if srv.cluster else ""
            if not secret:
                return True
            import hmac

            from dgraph_tpu_torch.cluster.transport import SECRET_HEADER

            got = self.headers.get(SECRET_HEADER, "")
            # bytes, not str: compare_digest raises on non-ASCII strings
            return hmac.compare_digest(got.encode("utf-8"), secret.encode("utf-8"))

        def _cluster_post(self, path: str, raw: bytes, length: int):
            """The intra-cluster POST endpoints; each answers what the
            reference's answers, code and body.  A peer that hung up
            mid-request (its body cut short of Content-Length, or gone
            before the answer) is dropped without a traceback: the raft
            plane retries on its own."""
            try:
                if len(raw) != length:
                    self.close_connection = True
                    return self._err(400, "truncated request body")
                return self._cluster_answer(path, raw)
            except (BrokenPipeError, ConnectionResetError):
                self.close_connection = True
                return None

        def _cluster_answer(self, path: str, raw: bytes):
            if srv.cluster is None:
                return self._err(404, "not clustered")
            if not self._cluster_authorized():
                return self._err(403, "bad cluster secret")
            tctx = obs.parse_traceparent(self.headers.get("Traceparent"))
            if path == "/assign-uids":
                # leader-only uid leasing (AssignUidsOverNetwork target)
                with obs.server_span("peer.assign-uids", tctx) as ss:
                    ss.set_attr("node", srv.cluster.node_id)
                    try:
                        want = int(raw or b"1")
                        if want < 0:  # negative = reserve an explicit uid
                            start, end = srv.cluster.reserve_local(-want)
                        else:
                            start, end = srv.cluster.assign_local(want)
                    except NotLeaderError as e:
                        return self._reply(409, (e.leader or "").encode(), "text/plain")
                    except Exception as e:  # noqa: BLE001 — the reference's 400
                        return self._err(400, str(e))
                    return self._reply(
                        200, json.dumps({"start": start, "end": end}).encode()
                    )
            if path == "/join":
                # runtime membership: a new server announces itself
                # (grpc JoinCluster analog, draft.go:1049).  Like the
                # reference, the joiner's group list is not read here.
                try:
                    req = json.loads(raw)
                    peers = srv.cluster.handle_join(str(req["id"]), str(req["addr"]))
                except Exception as e:  # noqa: BLE001 — the reference's 400
                    return self._err(400, str(e))
                return self._reply(200, json.dumps({"peers": peers}).encode())
            # raft plane: binary frames, no engine lock (RaftMessage /
            # proposeOrSend endpoints, draft.go:1017, mutation.go:319)
            try:
                gid = int(path.rsplit("/", 1)[1])
            except ValueError:
                return self._err(400, "bad group")
            if path.startswith("/raft/"):
                try:
                    srv.cluster.deliver(gid, raw)
                except Exception as e:  # noqa: BLE001 — a bad frame: 400
                    return self._err(400, str(e))
                return self._reply(200, b"{}")
            # the forwarded-proposal leg of a distributed trace: a sampled
            # forwarder's traceparent lands this node's commit work in the
            # same trace
            with obs.server_span("peer.raft-propose", tctx) as ss:
                ss.set_attr("node", srv.cluster.node_id)
                ss.set_attr("group", gid)
                try:
                    srv.cluster.propose_local(gid, raw)
                except NotLeaderError as e:
                    ss.set_attr("outcome", "not_leader")
                    return self._reply(409, (e.leader or "").encode(), "text/plain")
                except Exception as e:  # noqa: BLE001 — the reference's 500
                    return self._err(500, str(e))
                return self._reply(200, b"{}")

        def do_POST(self):
            u = urlparse(self.path)
            n = int(self.headers.get("Content-Length", 0))
            if u.path in ("/assign-uids", "/join") or u.path.startswith(
                ("/raft/", "/raft-propose/")
            ):
                return self._cluster_post(u.path, self.rfile.read(n), n)
            body = self.rfile.read(n).decode("utf-8", "replace")
            qs = parse_qs(u.query)
            if u.path == "/admin/cancel":
                return self._admin_cancel(qs)
            if u.path == "/subscribe":
                return self._subscribe(body, qs)
            if u.path == "/subscribe/cancel":
                if srv.subs is None:
                    return self._err(404, "subscriptions disabled")
                sid = qs.get("id", [""])[0]
                if not sid:
                    return self._err(400, "id required")
                if srv.subs.cancel(sid):
                    return self._reply(200, json.dumps({
                        "code": "Success",
                        "message": f"subscription {sid} cancelled",
                    }).encode())
                return self._err(404, "no such subscription")
            if u.path == "/share":
                sid = srv.share(body)
                return self._reply(200, json.dumps(
                    {"code": "Success", "uids": {"share": sid}}).encode())
            if u.path != "/query":
                return self._err(404, "no such endpoint")
            debug = qs.get("debug", ["false"])[0] == "true"
            want_ledger = qs.get("ledger", ["false"])[0] == "true"
            try:
                vars_hdr = self.headers.get("X-Dgraph-Vars")
                variables = json.loads(vars_hdr) if vars_hdr else None
                out = srv.run_query(
                    body, variables, debug=debug, ledger_out=want_ledger,
                    timeout_s=_qos.parse_timeout(
                        self.headers.get("X-Dgraph-Timeout")
                    ),
                    tenant=self.headers.get("X-Dgraph-Tenant") or "",
                    cancel_probe=self._disconnect_probe(),
                    # a malformed traceparent parses to None — an
                    # attacker-controlled header must never 500 a query
                    trace_ctx=obs.parse_traceparent(
                        self.headers.get("Traceparent")
                    ),
                )
            except SchedOverloadError as e:
                # shed under overload: retriable, not a client error.  A
                # tenant's quota shed carries a Retry-After sized to that
                # tenant's backlog; the global cap's asks for a second
                ra = max(1, int(round(getattr(e, "retry_after", 1.0))))
                extra = {"tenant": e.tenant} if isinstance(e, SchedQuotaError) else None
                return self._err(429, str(e), "ErrorServiceUnavailable",
                                 extra=extra, headers={"Retry-After": str(ra)})
            except SchedDeadlineError as e:
                return self._err(504, str(e), "ErrorDeadlineExceeded")
            except QueryCancelledError as e:
                # a deadline that lapsed MID-EXECUTION reads exactly like
                # the queued-shed 504; a disconnect gets 499 (the nginx
                # client-closed-request convention), a reply that may race
                # the vanished client
                try:
                    if e.reason == "deadline":
                        return self._err(504, str(e), "ErrorDeadlineExceeded")
                    return self._err(499, str(e), "ErrorQueryCancelled")
                except OSError:
                    self.close_connection = True
                    return None
            except _devguard.DeviceFaultError as e:
                # the card is sick, wedged or faulted (utils/devguard.py):
                # retriable once the re-admission probe re-proves it
                return self._err(503, str(e), "ErrorServiceUnavailable",
                                 headers={"Retry-After": str(
                                     _devguard.retry_after_s())})
            except StorageFaultError as e:
                # disk fault / read-only mode: the mutation was NOT
                # acknowledged; retriable once the re-arm probe clears
                # (503 + Retry-After sized to the probe interval)
                return self._err(503, str(e), "ErrorServiceUnavailable",
                                 headers={"Retry-After": str(
                                     max(1, int(round(e.retry_after))))})
            except StaleUnavailableError as e:
                # owner group unreachable AND no cached snapshot to
                # degrade to: a retriable service condition, 503 +
                # Retry-After sized to the breaker cooldown
                return self._err(503, str(e), "ErrorServiceUnavailable",
                                 headers={"Retry-After": str(
                                     max(1, int(round(e.retry_after))))})
            except (NotLeaderError, TimeoutError, OSError) as e:
                if srv.cluster is None:
                    traceback.print_exc(file=sys.stderr)
                    return self._err(500, f"{type(e).__name__}: {e}",
                                     "ErrorInternal")
                # a clustered write that could not reach its group's
                # leader (no leader yet, proposal timed out, owner not
                # announced, peer unreachable): the reference's 400 with
                # the error's message, which says to retry
                return self._err(400, str(e))
            except ValueError as e:
                # parse, query and mutation errors (ParseError, QueryError,
                # bad variables) are the client's: 400 as in the reference
                return self._err(400, str(e))
            except Exception as e:  # noqa: BLE001 — the request boundary
                # anything else (a device or kernel fault) is the server's:
                # reported as a 500 with its traceback on stderr
                traceback.print_exc(file=sys.stderr)
                return self._err(500, f"{type(e).__name__}: {e}", "ErrorInternal")
            accept = self.headers.get("Accept", "")
            if "application/protobuf" in accept or "application/x-protobuf" in accept:
                # the binary client surface: the protobuf wire-format
                # Response (graphresponse.proto), hand-encoded
                # (serve/proto.py)
                from dgraph_tpu_torch.serve import proto as _proto

                return self._reply(200, _proto.encode_response(out),
                                   "application/protobuf")
            self._reply(200, json.dumps(out).encode())

    return Handler


def _ivm_stats(srv: DgraphServer) -> Optional[dict]:
    """/debug/store "ivm" section: the predicate-version spread (how much
    invalidation scoping buys), the delta stream's occupancy and the
    subscription table (null where the store streams nothing).  None
    when IVM is off."""
    from dgraph_tpu_torch.ivm import ivm_enabled

    store = srv.store
    if not ivm_enabled():
        return None
    stream = getattr(store, "delta_stream", None)
    return {
        # debug introspection, not a cache key (the ivm/ helpers ARE
        # what this section reports on)
        # graftlint: ignore[naked-version-key]
        "version": store.version,
        "pred_floor": store.pred_floor,
        "tracked_preds": len(store.pred_versions),
        "stream": stream.snapshot() if stream is not None else None,
        "subs": srv.subs.snapshot() if srv.subs is not None else None,
    }


def _qcache_stats(srv: DgraphServer) -> dict:
    """Both query cache tiers' occupancy (None under DGRAPH_TPU_CACHE=0)."""
    hop = srv.engine.arenas.hop_cache
    rc = srv.scheduler.result_cache if srv.scheduler is not None else None
    return {
        "hop": (
            {"entries": len(hop), "bytes": hop.occupancy_bytes}
            if hop is not None
            else None
        ),
        "result": (
            {"entries": len(rc), "bytes": rc.occupancy_bytes}
            if rc is not None
            else None
        ),
    }


def _store_stats(store: PostingStore) -> dict:
    """/debug/store's store section: per predicate its edges and values."""
    preds = {}
    for p in store.predicates():
        pd = store.peek(p)
        if pd is None:
            continue
        preds[p] = {
            "edges": sum(len(s) for s in pd.edges.values()),
            "values": len(pd.values),
        }
    return {
        "predicates": preds,
        "uids": len(store.uids),
        "max_uid": store.uids.max_uid,
    }
