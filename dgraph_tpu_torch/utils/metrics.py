"""Metrics registry with Prometheus text exposition (trimmed copy of
``dgraph_tpu/utils/metrics.py``).

The counter, gauge and histogram types of the reference and the
instruments the serving plane bumps: query counts and latency, the
cohort scheduler's, QoS sheds and cancellations, segment seams, the two
query cache tiers, the tile join tier's routes and builds, IVM repairs,
the storage and cluster planes, the flight recorder, the per-request
ledger's families, device residency and kernel builds, failpoint fires
and deliberately swallowed exceptions.  ``GET /metrics`` (and
``/debug/prometheus_metrics``) serve ``metrics.prometheus_text()``, or
``metrics.openmetrics_text()`` — the same body with histogram bucket
EXEMPLARS (trace ids of the flight recorder) and ``# EOF`` — to a
scraper that asks for ``application/openmetrics-text``.

Where the port differs: the compile families
(``dgraph_xla_compiles_total``, ``dgraph_xla_compile_seconds``) count
the port's kernel builds at first use (``ops/_build.py``: one ``nvcc``
per CUDA source, one ``g++`` per host library), the counterpart of a
backend compilation; ``dgraph_build_info`` carries a ``torch`` label
where the reference's carries ``jax``.  The mesh's instruments
(``dgraph_mesh_epoch``, ``dgraph_mesh_chips_healthy``,
``dgraph_mesh_reshard_total{reason}``, ``dgraph_mesh_reshard_seconds``,
``dgraph_query_resumed_total{reason}``) are the reference's.
"""

from __future__ import annotations

import threading
import time as _time
from bisect import bisect_left
from typing import Dict, Optional


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    def value(self) -> int:
        return self._v


class Gauge:
    """Settable gauge."""

    __slots__ = ("name", "_v", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = v

    def add(self, n: float = 1) -> None:
        with self._lock:
            self._v += n

    def value(self) -> float:
        return self._v


class LabeledCounter:
    """Counter family keyed by one label."""

    def __init__(self, name: str, label: str):
        self.name = name
        self.label = label
        self._m: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._m[key] = self._m.get(key, 0) + n

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._m)


class MultiLabeledCounter:
    """Counter family keyed by a label TUPLE."""

    def __init__(self, name: str, labels):
        self.name = name
        self.labels = tuple(labels)
        self._m: Dict[tuple, int] = {}
        self._lock = threading.Lock()

    def add(self, key, n: int = 1) -> None:
        key = tuple(str(k) for k in key)
        if len(key) != len(self.labels):
            raise ValueError(
                f"{self.name}: expected {len(self.labels)} label values, "
                f"got {len(key)}"
            )
        with self._lock:
            self._m[key] = self._m.get(key, 0) + n

    def snapshot(self) -> Dict[tuple, int]:
        with self._lock:
            return dict(self._m)

    def total(self, **want) -> int:
        """Sum over series matching the given label=value filters."""
        idx = {l: i for i, l in enumerate(self.labels)}
        out = 0
        for key, v in self.snapshot().items():
            if all(key[idx[l]] == str(val) for l, val in want.items()):
                out += v
        return out


class LabeledGauge:
    """Gauge family keyed by one label (per-peer breaker state)."""

    def __init__(self, name: str, label: str):
        self.name = name
        self.label = label
        self._m: Dict[str, float] = {}
        self._lock = threading.Lock()

    def set(self, key: str, v: float) -> None:
        with self._lock:
            self._m[key] = v

    def value(self, key: str) -> float:
        with self._lock:
            return self._m.get(key, 0.0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._m)


class FuncGauge:
    """Gauge whose value is computed at scrape time (process uptime).
    The callable must be cheap and exception-free — it runs inside every
    exposition pass."""

    __slots__ = ("name", "_fn")

    def __init__(self, name: str, fn):
        self.name = name
        self._fn = fn

    def value(self) -> float:
        return float(self._fn())


class MultiLabeledGauge:
    """Gauge family keyed by a label TUPLE (``dgraph_build_info``: a
    constant-1 gauge whose labels carry the version/backend identity)."""

    def __init__(self, name: str, labels):
        self.name = name
        self.labels = tuple(labels)
        self._m: Dict[tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, key, v: float) -> None:
        key = tuple(str(k) for k in key)
        if len(key) != len(self.labels):
            raise ValueError(
                f"{self.name}: expected {len(self.labels)} label values, "
                f"got {len(key)}"
            )
        with self._lock:
            self._m[key] = float(v)

    def snapshot(self) -> Dict[tuple, float]:
        with self._lock:
            return dict(self._m)


class Histogram:
    """Fixed-bucket histogram with Prometheus ``_bucket{le=...}`` /
    ``_sum`` / ``_count`` exposition.

    Buckets optionally carry an OpenMetrics EXEMPLAR — the last
    (trace_id, value, wall timestamp) that landed in them — so a bucket
    of ``dgraph_query_latency_seconds`` links to a trace in the flight
    recorder's ring (``/debug/traces/<id>``).  Exemplars render only in
    the OpenMetrics exposition (``openmetrics_text``)."""

    __slots__ = (
        "name", "buckets", "_counts", "_sum", "_count", "_exemplars",
        "_lock",
    )

    def __init__(self, name: str, buckets):
        self.name = name
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        # per-bucket (non-cumulative) counts; +Inf bucket is the tail slot
        self._counts = [0] * (len(self.buckets) + 1)
        # per-bucket last exemplar: (trace_id, value, wall_ts) or None
        self._exemplars = [None] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, v: float, trace_id: Optional[str] = None) -> None:
        i = bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if trace_id:
                # wall timestamp STORED, never used in interval math —
                # OpenMetrics exemplar timestamps are epoch seconds
                self._exemplars[i] = (trace_id, v, _time.time())

    def exemplars(self):
        """Per-bucket (trace_id, value, wall_ts) snapshot, aligned with
        buckets + [+Inf]."""
        with self._lock:
            return list(self._exemplars)

    def snapshot(self):
        """(cumulative bucket counts aligned with self.buckets + [+Inf],
        sum, count) — one consistent view."""
        with self._lock:
            counts = list(self._counts)
            s, c = self._sum, self._count
        cum = []
        run = 0
        for n in counts:
            run += n
            cum.append(run)
        return cum, s, c


class LabeledHistogram:
    """Histogram family keyed by one label (per-tenant latency).  Series
    are created on first observe; the key space is BOUNDED
    (``max_series``) because label values may come from client input —
    the overflow tail collapses into one ``overflow`` series."""

    def __init__(self, name: str, label: str, buckets, max_series: int = 64):
        self.name = name
        self.label = label
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.max_series = max_series
        self._m: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def _get(self, key: str) -> Histogram:
        with self._lock:
            h = self._m.get(key)
            if h is None:
                if len(self._m) >= self.max_series:
                    key = "overflow"
                    h = self._m.get(key)
                if h is None:
                    h = self._m[key] = Histogram(self.name, self.buckets)
            return h

    def observe(self, key: str, v: float, trace_id: Optional[str] = None) -> None:
        self._get(str(key)).observe(v, trace_id=trace_id)

    def snapshot(self) -> Dict[str, tuple]:
        with self._lock:
            items = list(self._m.items())
        return {k: h.snapshot() for k, h in items}


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._func_gauges: Dict[str, FuncGauge] = {}
        self._labeled: Dict[str, LabeledCounter] = {}
        self._multilabeled: Dict[str, MultiLabeledCounter] = {}
        self._labeled_gauges: Dict[str, LabeledGauge] = {}
        self._multilabeled_gauges: Dict[str, MultiLabeledGauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._labeled_histograms: Dict[str, LabeledHistogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def func_gauge(self, name: str, fn) -> FuncGauge:
        with self._lock:
            g = self._func_gauges.get(name)
            if g is None:
                g = self._func_gauges[name] = FuncGauge(name, fn)
            return g

    def labeled(self, name: str, label: str = "predicate") -> LabeledCounter:
        with self._lock:
            l = self._labeled.get(name)
            if l is None:
                l = self._labeled[name] = LabeledCounter(name, label)
            return l

    def multilabeled(self, name: str, labels) -> MultiLabeledCounter:
        with self._lock:
            c = self._multilabeled.get(name)
            if c is None:
                c = self._multilabeled[name] = MultiLabeledCounter(name, labels)
            return c

    def labeled_gauge(self, name: str, label: str) -> LabeledGauge:
        with self._lock:
            g = self._labeled_gauges.get(name)
            if g is None:
                g = self._labeled_gauges[name] = LabeledGauge(name, label)
            return g

    def multilabeled_gauge(self, name: str, labels) -> MultiLabeledGauge:
        with self._lock:
            g = self._multilabeled_gauges.get(name)
            if g is None:
                g = self._multilabeled_gauges[name] = MultiLabeledGauge(
                    name, labels
                )
            return g

    def histogram(self, name: str, buckets) -> Histogram:
        with self._lock:
            h = self._histograms.get(name)
            if h is None:
                h = self._histograms[name] = Histogram(name, buckets)
            return h

    def labeled_histogram(self, name: str, label: str, buckets) -> LabeledHistogram:
        with self._lock:
            h = self._labeled_histograms.get(name)
            if h is None:
                h = self._labeled_histograms[name] = LabeledHistogram(
                    name, label, buckets
                )
            return h

    def prometheus_text(self) -> str:
        """Prometheus text exposition format."""
        lines = []
        with self._lock:
            counters = list(self._counters.values())
            gauges = list(self._gauges.values())
            func_gauges = list(self._func_gauges.values())
            labeled = list(self._labeled.values())
            multilabeled = list(self._multilabeled.values())
            labeled_gauges = list(self._labeled_gauges.values())
            multilabeled_gauges = list(self._multilabeled_gauges.values())
            histograms = list(self._histograms.values())
            labeled_histograms = list(self._labeled_histograms.values())

        def _esc(s: str) -> str:
            return s.replace("\\", "\\\\").replace('"', '\\"')

        for c in sorted(counters, key=lambda c: c.name):
            lines.append(f"# TYPE {c.name} counter")
            lines.append(f"{c.name} {c.value()}")
        for g in sorted(gauges, key=lambda g: g.name):
            lines.append(f"# TYPE {g.name} gauge")
            lines.append(f"{g.name} {g.value()}")
        for fg in sorted(func_gauges, key=lambda g: g.name):
            lines.append(f"# TYPE {fg.name} gauge")
            lines.append(f"{fg.name} {fg.value():g}")
        for l in sorted(labeled, key=lambda l: l.name):
            lines.append(f"# TYPE {l.name} counter")
            for k, v in sorted(l.snapshot().items()):
                lines.append(f'{l.name}{{{l.label}="{_esc(k)}"}} {v}')
        for ml in sorted(multilabeled, key=lambda m: m.name):
            lines.append(f"# TYPE {ml.name} counter")
            for key, v in sorted(ml.snapshot().items()):
                pairs = ",".join(
                    f'{lab}="{_esc(val)}"' for lab, val in zip(ml.labels, key)
                )
                lines.append(f"{ml.name}{{{pairs}}} {v}")
        for lg in sorted(labeled_gauges, key=lambda g: g.name):
            lines.append(f"# TYPE {lg.name} gauge")
            for k, v in sorted(lg.snapshot().items()):
                lines.append(f'{lg.name}{{{lg.label}="{_esc(k)}"}} {v:g}')
        for mg in sorted(multilabeled_gauges, key=lambda g: g.name):
            lines.append(f"# TYPE {mg.name} gauge")
            for key, v in sorted(mg.snapshot().items()):
                pairs = ",".join(
                    f'{lab}="{_esc(val)}"' for lab, val in zip(mg.labels, key)
                )
                lines.append(f"{mg.name}{{{pairs}}} {v:g}")
        for h in sorted(histograms, key=lambda h: h.name):
            cum, s, c = h.snapshot()
            lines.append(f"# TYPE {h.name} histogram")
            for b, n in zip(h.buckets, cum):
                lines.append(f'{h.name}_bucket{{le="{b:g}"}} {n}')
            lines.append(f'{h.name}_bucket{{le="+Inf"}} {c}')
            lines.append(f"{h.name}_sum {s:g}")
            lines.append(f"{h.name}_count {c}")
        for lh in sorted(labeled_histograms, key=lambda h: h.name):
            lines.append(f"# TYPE {lh.name} histogram")
            for key, (cum, s, c) in sorted(lh.snapshot().items()):
                kq = _esc(key)
                for b, n in zip(lh.buckets, cum):
                    lines.append(
                        f'{lh.name}_bucket{{{lh.label}="{kq}",le="{b:g}"}} {n}'
                    )
                lines.append(
                    f'{lh.name}_bucket{{{lh.label}="{kq}",le="+Inf"}} {c}'
                )
                lines.append(f'{lh.name}_sum{{{lh.label}="{kq}"}} {s:g}')
                lines.append(f'{lh.name}_count{{{lh.label}="{kq}"}} {c}')
        return "\n".join(lines) + "\n"

    def openmetrics_text(self) -> str:
        """OpenMetrics exposition: the classic body plus histogram
        bucket EXEMPLARS (``# {trace_id="..."} value timestamp``) and
        the mandatory ``# EOF`` terminator.  Series names match the
        classic exposition exactly (no ``_total`` re-suffixing)."""
        classic = self.prometheus_text()
        with self._lock:
            histograms = list(self._histograms.values())
        # keyed by the bucket-line PREFIX (name + le label), never the
        # count: the classic body and the exemplar snapshot are taken at
        # different instants, and a concurrent observe() between them
        # must not strip exemplars from every bucket it bumped
        ex_by_prefix: Dict[str, str] = {}
        for h in histograms:
            bounds = [f"{b:g}" for b in h.buckets] + ["+Inf"]
            for bound, ex in zip(bounds, h.exemplars()):
                if ex is None:
                    continue
                trace_id, v, ts = ex
                ex_by_prefix[f'{h.name}_bucket{{le="{bound}"}} '] = (
                    f' # {{trace_id="{trace_id}"}} {v:g} {ts:.3f}'
                )
        out = []
        for line in classic.splitlines():
            if "_bucket{" in line:
                cut = line.index("} ") + 2
                suffix = ex_by_prefix.get(line[:cut])
                if suffix is not None:
                    line += suffix
            out.append(line)
        out.append("# EOF")
        return "\n".join(out) + "\n"


# Global registry; components fetch these by name.
metrics = MetricsRegistry()

PENDING_QUERIES = metrics.gauge("dgraph_pending_queries")
NUM_QUERIES = metrics.counter("dgraph_num_queries_total")
# the gRPC surface (serve/grpc_server.py): protos.Dgraph/Run calls, and
# raft frames received over protos.Worker/RaftMessage
NUM_GRPC_RUNS = metrics.counter("dgraph_grpc_runs_total")
NUM_GRPC_RAFT = metrics.counter("dgraph_grpc_raft_frames_total")

# latency bucket ladder shared by the serving histograms (seconds):
# sub-ms through 10s, roughly ×2.5 steps — the client_golang DefBuckets
_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

# end-to-end query latency (its buckets carry exemplars: the trace id
# of a sampled or tail-sampled request) and its per-tenant twin under
# QoS (bounded series: tenant names are client input)
QUERY_LATENCY = metrics.histogram(
    "dgraph_query_latency_seconds", _LATENCY_BUCKETS
)
TENANT_LATENCY = metrics.labeled_histogram(
    "dgraph_tenant_query_latency_seconds", "tenant", _LATENCY_BUCKETS
)

# cohort scheduler surface (sched/scheduler.py): how full cohorts ride,
# why they flushed, how long requests queued
SCHED_QUEUE_WAIT = metrics.histogram(
    "dgraph_sched_queue_wait_seconds", _LATENCY_BUCKETS
)
SCHED_COHORT_OCCUPANCY = metrics.histogram(
    "dgraph_sched_cohort_occupancy", (1, 2, 4, 8, 16, 32, 64, 128)
)
SCHED_FLUSHES = metrics.labeled("dgraph_sched_flushes_total", label="reason")
SCHED_SHED = metrics.labeled("dgraph_sched_shed_total", label="reason")
SCHED_MERGED_HOPS = metrics.counter("dgraph_sched_merged_hops_total")
SCHED_COALESCED = metrics.counter("dgraph_sched_coalesced_requests_total")
SCHED_QUEUE_DEPTH = metrics.gauge("dgraph_sched_queue_depth")

# multi-tenant QoS surface (sched/qos.py): every cancelled query lands
# in QUERY_CANCELLED with {reason ∈ deadline/disconnect, tenant};
# per-tenant sheds (quota / overload / deadline) in TENANT_SHED
QUERY_CANCELLED = metrics.multilabeled(
    "dgraph_query_cancelled_total", ("reason", "tenant")
)
TENANT_SHED = metrics.multilabeled(
    "dgraph_tenant_shed_total", ("tenant", "reason")
)

# segment seams (sched/segments.py): segmented runs per fused hop
# loop, seams that yielded (cancel), and how long a higher-priority
# cohort waited for the running query's next seam
SEGMENT_DISPATCHES = metrics.labeled(
    "dgraph_segment_dispatches_total", label="loop"
)
SEGMENT_YIELDS = metrics.labeled(
    "dgraph_segment_yields_total", label="reason"
)
SEGMENT_PREEMPT_US = metrics.histogram(
    "dgraph_segment_preempt_us",
    (100.0, 500.0, 1000.0, 5000.0, 25000.0, 100000.0, 500000.0, 2000000.0),
)

# two-tier query cache surface (dgraph_tpu_torch/cache/): per-tier event
# counters (hit / miss / stale / evicted / rejected), occupancy-bytes
# gauges, and the shared hit-age histogram
QCACHE_HOP_EVENTS = metrics.labeled(
    "dgraph_qcache_hop_events_total", label="event"
)
QCACHE_RESULT_EVENTS = metrics.labeled(
    "dgraph_qcache_result_events_total", label="event"
)
QCACHE_HOP_BYTES = metrics.gauge("dgraph_qcache_hop_bytes")
QCACHE_RESULT_BYTES = metrics.gauge("dgraph_qcache_result_bytes")
QCACHE_HIT_AGE = metrics.histogram(
    "dgraph_qcache_hit_age_seconds",
    (0.001, 0.01, 0.1, 1.0, 10.0, 60.0, 600.0),
)

# measured-cost planner (query/planner.py): every route decision is
# counted per (kind, route), every post-hoc check that catches the model
# on the wrong side of a break-even lands in MISPREDICT{kind}, and every
# calibration pass that ran in CALIBRATIONS.  A sustained rise of the
# mispredict rate (mispredicts / decisions) means the persisted
# calibration no longer matches the card: re-run it
# (DGRAPH_TPU_CALIBRATE=1).
PLANNER_DECISIONS = metrics.multilabeled(
    "dgraph_planner_decisions_total", ("kind", "route")
)
PLANNER_MISPREDICTS = metrics.labeled(
    "dgraph_planner_mispredict_total", label="kind"
)
PLANNER_CALIBRATIONS = metrics.counter("dgraph_planner_calibrations_total")


# the tile join tier (ops/spgemm.py + query/joinplan.py): every route
# decision (mxu vs pairwise) and every k-way intersection's host or
# device choice is counted; tile builds and the bytes they densified
JOIN_ROUTES = metrics.labeled("dgraph_join_route_total", label="route")
KWAY_INTERSECTS = metrics.labeled(
    "dgraph_kway_intersect_total", label="route"
)
JOIN_TILE_BUILDS = metrics.counter("dgraph_join_tile_builds_total")
JOIN_TILE_BYTES = metrics.counter("dgraph_join_tile_built_bytes_total")

# incremental view maintenance: each repair-or-rebuild outcome per
# derived view (hop-cache entries, tiles) and the edges repairs absorbed
IVM_REPAIRS = metrics.multilabeled(
    "dgraph_ivm_repairs_total", ("kind", "outcome")
)
IVM_REPAIR_EDGES = metrics.counter("dgraph_ivm_repair_edges_total")
# the mutation delta stream (ivm/deltas.py): events published by kind
# (edge/pred/epoch) and the oldest events lost to ring overflow
IVM_DELTAS = metrics.labeled("dgraph_ivm_deltas_total", label="kind")
IVM_STREAM_DROPPED = metrics.counter("dgraph_ivm_stream_dropped_total")

# live-query subscriptions (ivm/subs.py): active registrations,
# re-evaluations run, events by disposition (push = a changed result
# delivered, skip = re-evaluated and unchanged, lagged = a slow
# consumer's queue dropped its oldest, deferred = a retriable shed or
# device fault put the evaluation off, error = the subscription was
# cancelled) and registration sheds by reason (quota/cap)
SUBS_ACTIVE = metrics.gauge("dgraph_subscription_active")
SUBS_EVALS = metrics.counter("dgraph_subscription_evals_total")
SUBS_EVENTS = metrics.labeled(
    "dgraph_subscription_events_total", label="kind"
)
SUBS_SHED = metrics.labeled(
    "dgraph_subscription_shed_total", label="reason"
)

# device fault domain (utils/devguard.py), under the reference's names:
# DEVICE_STATE per domain (0 healthy, 1 suspect, 2 sick), every
# classified fault by kind (hang/oom/transient), the re-admission probes
# by outcome (ok/fail).  DEVICE_FAILOVER counts ``evict_retry`` (an OOM
# on the per-level route answered by LRU eviction and one retry on the
# card) and ``unsharded`` (a faulted mesh dispatch re-planned on the
# card's unsharded routes): the reference's ``host`` failover is not
# ported, a faulted query answers 503
DEVICE_STATE = metrics.labeled_gauge("dgraph_device_state", label="domain")
DEVICE_FAULTS = metrics.labeled("dgraph_device_faults_total", label="kind")
DEVICE_FAILOVER = metrics.labeled(
    "dgraph_device_failover_total", label="route"
)
DEVICE_PROBES = metrics.labeled(
    "dgraph_device_probes_total", label="outcome"
)

# the elastic mesh fault domain (mesh/fault.py): MESH_EPOCH is the epoch
# fence every mesh dispatch carries (the MeshPlan version at the last
# re-shard) and moves exactly when the serving sub-mesh does;
# MESH_CHIPS_HEALTHY against the boot width is the capacity headline;
# MESH_RESHARD counts epoch flips by cause (loss / rejoin / manual) and
# MESH_RESHARD_SECONDS is each flip's drain window (plan rebalance,
# stale-shard drop, publication).  QUERY_RESUMED counts in-flight queries
# that resumed under a new plan (reason epoch / loss / hang)
MESH_EPOCH = metrics.gauge("dgraph_mesh_epoch")
MESH_CHIPS_HEALTHY = metrics.gauge("dgraph_mesh_chips_healthy")
MESH_RESHARD = metrics.labeled(
    "dgraph_mesh_reshard_total", label="reason"
)
MESH_RESHARD_SECONDS = metrics.histogram(
    "dgraph_mesh_reshard_seconds",
    (0.001, 0.005, 0.025, 0.1, 0.5, 2.0, 10.0, 60.0),
)
QUERY_RESUMED = metrics.labeled(
    "dgraph_query_resumed_total", label="reason"
)

# storage plane (models/wal.py + models/durability.py), under the
# reference's names: a disk fault latches read-only mode (the gauge)
# until the re-arm probe clears it, every fault counted per site;
# recovery gauges describe the LAST boot replay; WAL gauges + snapshot
# age say whether the background snapshotter keeps the log bounded; the
# group-commit pair's ratio (writes / syncs) is the fsync batching
# factor under --sync
STORAGE_ERRORS = metrics.labeled(
    "dgraph_storage_errors_total", label="site"
)
STORAGE_READONLY = metrics.gauge("dgraph_storage_readonly")
RECOVERY_RECORDS = metrics.gauge("dgraph_recovery_records")
RECOVERY_TORN_BYTES = metrics.gauge("dgraph_recovery_torn_bytes")
RECOVERY_SECONDS = metrics.gauge("dgraph_recovery_seconds")
SNAPSHOT_AGE = metrics.gauge("dgraph_snapshot_age_seconds")
SNAPSHOTS = metrics.counter("dgraph_snapshots_total")
WAL_BYTES = metrics.gauge("dgraph_wal_bytes")

# the Eraser lockset witness (analysis/witness.py): field states the
# armed witness is tracking — its own coverage proof.  Zero under an
# armed test run means the instrumentation regressed (the annotated
# classes stopped being exercised), not that the tree is race-free.
# Unarmed serving paths never touch it.
RACE_WITNESS_FIELDS = metrics.counter("dgraph_race_witness_fields_total")
WAL_SEGMENTS = metrics.gauge("dgraph_wal_sealed_segments")
GROUP_COMMIT_SYNCS = metrics.counter("dgraph_group_commit_syncs_total")
GROUP_COMMIT_WRITES = metrics.counter("dgraph_group_commit_writes_total")

# set-mutation quads by parser route (serve/mutations.py): "native", the
# C++ scanner's bulk path (serve/bulk.py), or "python", the Python
# parser (DGRAPH_TPU_NO_NATIVE=1, or a body the scanner declines)
BULK_QUADS = metrics.labeled("dgraph_bulk_set_quads_total", label="route")

# deliberately swallowed exceptions: "correct to drop" never means
# "correct to drop invisibly"
SWALLOWED_EXC = metrics.labeled(
    "dgraph_swallowed_exceptions_total", label="site"
)
FAILPOINTS_FIRED = metrics.labeled(
    "dgraph_failpoints_fired_total", label="site"
)

# cluster plane (cluster/peerclient.py, cluster/transport.py,
# cluster/service.py): every peer RPC lands in PEER_RPC as {peer, op,
# outcome} — outcome "ok", "http_error" (the peer answered with an
# application error: alive), "unavailable" (retries/budget exhausted),
# "open" (shed by the circuit breaker without touching the network).
# BREAKER_STATE is the at-a-glance gauge (0 closed, 1 half-open, 2 open),
# one series per "peer:op" because breakers are scoped per (peer, op).
PEER_RPC = metrics.multilabeled(
    "dgraph_peer_rpc_total", ("peer", "op", "outcome")
)
PEER_RPC_ATTEMPTS = metrics.histogram(
    "dgraph_peer_rpc_attempts", (1, 2, 3, 4, 6, 8)
)
PEER_BACKOFF = metrics.histogram(
    "dgraph_peer_backoff_seconds",
    (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.0),
)
BREAKER_STATE = metrics.labeled_gauge(
    "dgraph_peer_breaker_state", label="peer"
)
BREAKER_TRANSITIONS = metrics.multilabeled(
    "dgraph_peer_breaker_transitions_total", ("peer", "op", "to")
)
DEGRADED_READS = metrics.counter("dgraph_degraded_reads_total")
RAFT_DROPPED = metrics.labeled(
    "dgraph_raft_frames_dropped_total", label="peer"
)


# flight recorder (obs/spans.py): SPANS_RECORDED counts every Span object
# constructed — the proof that the unsampled hot path allocates none
# (tests assert a ZERO delta at ratio 0); TRACES_RECORDED is the ring
# intake; SLOW_QUERIES counts tail-sampled offenders (DGRAPH_TPU_SLOW_MS)
SPANS_RECORDED = metrics.counter("dgraph_trace_spans_total")
TRACES_RECORDED = metrics.counter("dgraph_traces_recorded_total")
SLOW_QUERIES = metrics.counter("dgraph_slow_queries_total")

# per-request resource ledger (obs/ledger.py): edges traversed per
# tenant, hop dispatches by route, host/device/device_sync stage time in
# integer microseconds, staged and cache-hit bytes by direction, and the
# Ledger STRUCTS constructed (pool misses: a zero delta across warm
# requests proves the pool recycles)
EDGES_TRAVERSED = metrics.labeled(
    "dgraph_edges_traversed_total", label="tenant"
)
LEDGER_HOPS = metrics.labeled("dgraph_ledger_hops_total", label="route")
LEDGER_STAGE_US = metrics.labeled(
    "dgraph_ledger_stage_us_total", label="stage"
)
LEDGER_BYTES = metrics.labeled("dgraph_ledger_bytes_total", label="dir")
LEDGERS_CREATED = metrics.counter("dgraph_ledger_structs_total")

# device telemetry (obs/device.py + models/arena.py): device-memory
# residency under the ArenaManager budget, join-tile residency, arena LRU
# evictions, program-cache occupancy per kind, and kernel builds under
# the reference's compile family names (count + seconds)
HBM_RESIDENT_BYTES = metrics.gauge("dgraph_hbm_resident_bytes")
HBM_BUDGET_BYTES = metrics.gauge("dgraph_hbm_budget_bytes")
HBM_TILE_BYTES = metrics.gauge("dgraph_hbm_tile_bytes")
ARENA_EVICTIONS = metrics.counter("dgraph_arena_evictions_total")
PROGRAM_CACHE_ENTRIES = metrics.labeled_gauge(
    "dgraph_program_cache_entries", label="kind"
)
XLA_COMPILES = metrics.counter("dgraph_xla_compiles_total")
XLA_COMPILE_SECONDS = metrics.histogram(
    "dgraph_xla_compile_seconds",
    (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0),
)

# build identity + liveness: the constant-1 gauge whose labels say what
# runs (obs/device.py stamps it at server start) and the seconds since
# import, computed at scrape time
BUILD_INFO = metrics.multilabeled_gauge(
    "dgraph_build_info", ("version", "backend", "torch")
)
_PROCESS_START = _time.monotonic()
UPTIME_SECONDS = metrics.func_gauge(
    "dgraph_uptime_seconds",
    lambda: _time.monotonic() - _PROCESS_START,
)


def note_swallowed(site: str, exc: BaseException) -> None:
    """Count an intentionally-dropped exception at ``site``.  The
    exception TYPE rides in the label so a sudden shift (OSError →
    ValueError) is visible without logs."""
    SWALLOWED_EXC.add(f"{site}:{type(exc).__name__}")
