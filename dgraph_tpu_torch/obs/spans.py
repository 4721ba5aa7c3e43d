"""Query flight recorder: propagated spans with device-time attribution
(copy of ``dgraph_tpu/obs/spans.py`` on PyTorch).

A flat per-request event ring (utils/trace.py) and the ``{parsing,
processing, json}`` latency map cannot say where a query's wall time
went once the cohort scheduler, the two cache tiers, the kernels, group
commit and the retried peer RPCs sit between the request and its
answer.  This module gives a :class:`Span` tree per sampled request,
propagated across threads (contextvars) and across nodes (W3C
``traceparent``), landing in a bounded ring served at ``/debug/traces``.

Design constraints, in priority order:

1. **The unsampled hot path allocates no span objects.**  Every
   instrumentation site branches on ``current_span() is None`` first;
   ``child()``/``server_span()``/``start_request()`` on the cold side
   only.  ``dgraph_trace_spans_total`` counts every Span constructed,
   so tests can ASSERT the zero-allocation property instead of trusting
   it.
2. **DGRAPH_TPU_TRACE=0 is a kill switch**: ``start_request`` returns
   None unconditionally, so the whole layer degrades to one dict probe
   per request and responses are byte-identical.
3. **Sampling is seeded and thread-safe** (``DGRAPH_TPU_TRACE_RATIO``
   head sampling via an owned ``random.Random`` — never the global RNG
   — + always-on slow-query tail sampling, ``DGRAPH_TPU_SLOW_MS``).
4. **One trace follows a query across groups**: ``traceparent`` is
   parsed from incoming HTTP headers and injected into every outgoing
   PeerClient call (cluster/peerclient.py), so a forwarded mutation and
   a cross-group read record spans on BOTH nodes under one trace_id.
   The gRPC surface reads it from the ``traceparent`` metadata key
   (serve/grpc_server.py), and a gRPC peer call sends it there.

Device time: :func:`block_ready_ms` waits on a CUDA event recorded on
the producing tensor's current stream (never ``torch.cuda.synchronize``,
which would also wait on other cohorts' launches), and only a recording
span calls it, so the unsampled path stays asynchronous.  A span opened
with a CUDA ``device`` instead records a pair of timing events on that
device's current stream and waits on nothing; the pair is resolved when
:func:`span_totals` is read.

A span also records while ``torch.profiler`` is collecting, sampled or
not: it then enters a ``record_function`` range of its own name, so the
program's spans sit in the profiler's trace beside the device ops they
launched, on the profiler's clock.  A span that records only because the
profiler collects (no sampled request open) belongs to no trace: it is
never the current span, lands in no ring, and only feeds the profiler
and the recorder's in-memory tally by name (:func:`span_totals`).

Span timestamps are ``time.perf_counter_ns()`` — the one monotonic,
ns-resolution clock in the process — so parent/child nesting is exact
within a node; each root also anchors a wall-clock ``started`` for
display, exemplars and the Chrome export.

Env knobs: ``DGRAPH_TPU_TRACE`` (kill switch, default on),
``DGRAPH_TPU_TRACE_RATIO`` (head sampling, default 0),
``DGRAPH_TPU_TRACE_SEED`` (pin the sampler + id RNG),
``DGRAPH_TPU_TRACE_KEEP`` (ring size, default 256),
``DGRAPH_TPU_SLOW_MS`` (slow-query log threshold, default 0 = off).
"""

from __future__ import annotations

import contextvars
import json
import os
import random
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch
from torch._C._autograd import _profiler_enabled as profiling
from torch.autograd.profiler import record_function

from dgraph_tpu_torch.utils.env import env_float
from dgraph_tpu_torch.utils.metrics import (
    SLOW_QUERIES,
    SPANS_RECORDED,
    TRACES_RECORDED,
)

# the active span of THIS thread/task (contextvars are per-thread for
# plain threads, which is exactly the propagation unit here: the
# scheduler re-roots worker threads explicitly via SchedRequest.span)
_current: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "dgraph_tpu_torch_span", default=None
)


def current_span() -> Optional["Span"]:
    """The recording span of the calling thread, or None (not sampled /
    tracing off).  THE hot-path gate: every instrumentation site checks
    this before touching anything else."""
    return _current.get()


# ------------------------------------------------------------ traceparent

class TraceContext:
    """A parsed incoming ``traceparent``: the remote caller's trace."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = sampled


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """W3C trace-context ``traceparent`` → TraceContext, or None.

    Malformed input of ANY shape returns None — an attacker-controlled
    header must never 500 a query.  Per spec: version-00 layout
    ``00-<32 lowercase hex>-<16 lowercase hex>-<2 hex flags>``, all-zero
    trace or span ids invalid, version ff invalid."""
    if not header or not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) < 4:
        return None
    ver, trace_id, span_id, flags = parts[0], parts[1], parts[2], parts[3]
    if len(ver) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return None
    if len(flags) != 2:
        return None
    try:
        int(ver, 16)
        int(trace_id, 16)
        int(span_id, 16)
        fl = int(flags, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    # the spec mandates lowercase hex throughout — and the version
    # check must happen case-blind or 'FF' slips past the ff guard
    if any(p != p.lower() for p in (ver, trace_id, span_id, flags)):
        return None
    if ver == "ff":
        return None
    return TraceContext(trace_id, span_id, bool(fl & 0x01))


def format_traceparent(span: "Span") -> str:
    """The outgoing header for a recording span (sampled flag always 01:
    only recording spans inject)."""
    return f"00-{span.trace_id}-{span.span_id}-01"


# ---------------------------------------------------------------- sampler

class Sampler:
    """Head sampler with an OWNED seeded RNG.

    The global ``random`` module is shared program state: sampling
    through it couples trace decisions to every other consumer of the
    global stream and makes 'deterministic under a pinned seed'
    impossible.  One instance, one lock, one stream."""

    def __init__(
        self, ratio: Optional[float] = None, seed: Optional[int] = None
    ):
        self.ratio = (
            ratio
            if ratio is not None
            else env_float("DGRAPH_TPU_TRACE_RATIO", 0.0)
        )
        if seed is None:
            env_seed = os.environ.get("DGRAPH_TPU_TRACE_SEED")
            seed = int(env_seed) if env_seed else None
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def decide(self) -> bool:
        r = self.ratio
        if r <= 0.0:
            return False
        if r >= 1.0:
            return True
        with self._lock:
            return self._rng.random() < r

    def new_id(self, nbits: int) -> str:
        """Fresh hex id from the owned stream (thread-safe)."""
        with self._lock:
            return f"{self._rng.getrandbits(nbits):0{nbits // 4}x}"


# ------------------------------------------------------------------- span

class Span:
    """One timed operation in a trace.  Only ever constructed on the
    recording side (a sampled request, or the profiler collecting) — the
    unsampled path sees None and a shared no-op.

    Spans are manual-finish by default; used as a context manager they
    additionally install themselves as the thread's current span so
    nested instrumentation parents correctly.  ``buf`` None marks a span
    that records only for the profiler: it belongs to no trace and is
    never installed as the current span."""

    __slots__ = (
        "trace_id", "span_id", "parent_id", "name", "attrs", "links",
        "t0", "t1", "tid", "started", "_buf", "_token", "_root",
        "_range", "_events",
    )
    recording = True

    def __init__(
        self,
        trace_id: str,
        span_id: str,
        parent_id: Optional[str],
        name: str,
        buf: Optional[list],
        root: bool = False,
        device=None,
    ):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.attrs: Dict[str, object] = {}
        self.links: List[dict] = []
        self.t0 = time.perf_counter_ns()
        self.t1: Optional[int] = None
        self.tid = threading.get_ident()
        self.started = time.time() if root else 0.0  # wall anchor, roots only
        self._buf = buf
        self._token = None
        self._root = root
        self._range = None
        if profiling():
            self._range = record_function(name)
            self._range.__enter__()
        self._events = _start_events(device)
        SPANS_RECORDED.add(1)

    # -- tree ---------------------------------------------------------------

    def child(self, name: str, device=None) -> "Span":
        """One-call child creation (the tentpole's contract): inherits
        the trace, parents to this span, shares the trace buffer.
        ``device``: time the child on that CUDA device's current stream
        (see :func:`span_totals`)."""
        if self._buf is None:
            return Span("", "", None, name, None, device=device)
        rec = recorder
        return Span(
            self.trace_id, rec.sampler.new_id(64), self.span_id, name,
            self._buf, device=device,
        )

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def link(self, other: "Span") -> None:
        """Cross-reference a span in (possibly) ANOTHER trace — how a
        merged query points at the shared cohort-flush span that did
        its work without pretending to own it."""
        self.links.append(
            {"trace_id": other.trace_id, "span_id": other.span_id}
        )

    # -- lifecycle ----------------------------------------------------------

    def finish(self) -> None:
        """Idempotent: the first call stamps t1 and lands the span in
        its trace buffer; roots publish the whole trace to the ring."""
        if self.t1 is not None:
            return
        self.t1 = time.perf_counter_ns()
        events = None
        if self._events is not None:
            start, stream = self._events
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            events = (start, end)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        recorder.tally(self.name, self.t1 - self.t0, events)
        if self._buf is None:
            return
        self._buf.append(self)
        if self._root:
            recorder.publish(self)

    def __enter__(self) -> "Span":
        if self._buf is not None:
            self._token = _current.set(self)
        return self

    def __exit__(self, et, ev, tb) -> None:
        if ev is not None and "error" not in self.attrs:
            self.attrs["error"] = type(ev).__name__
        if self._token is not None:
            _current.reset(self._token)
            self._token = None
        self.finish()

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "t0_ns": self.t0,
            "t1_ns": self.t1,
            "dur_us": (
                round((self.t1 - self.t0) / 1e3, 1)
                if self.t1 is not None
                else None
            ),
            "tid": self.tid,
            "attrs": dict(self.attrs),
            "links": list(self.links),
        }


class _NoopSpan:
    """Shared do-nothing span for `with obs.child("x"):` on unsampled
    paths — a singleton, so the cold convenience API costs zero
    allocations when tracing is off."""

    __slots__ = ()
    recording = False

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return None

    def child(self, name, device=None):
        return self

    def set_attr(self, key, value):
        pass

    def link(self, other):
        pass

    def finish(self):
        pass


NOOP = _NoopSpan()


def child(name: str, device=None):
    """Context-manager child of the current span; a span of no trace
    while only the profiler collects; the shared no-op when nothing is
    recording (one context-variable probe and one profiler-flag probe).
    ``device``: time the span on that CUDA device's current stream.  For
    sites where the kwargs/branching cost of checking current_span()
    explicitly is not worth saving."""
    sp = _current.get()
    if sp is not None:
        return sp.child(name, device)
    if not profiling() or not recorder.enabled:
        return NOOP
    return Span("", "", None, name, None, device=device)


def _start_events(device):
    """(start event, stream) recorded on ``device``'s current stream, or
    None when ``device`` is not a CUDA device."""
    if getattr(device, "type", None) != "cuda":
        return None
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    start.record(stream)
    return start, stream


# -------------------------------------------------------------- stage timer

class _Stage:
    """Accumulating stage timer for the engine's per-request stats dicts
    (host_expand_ms / device_expand_ms / ...), in milliseconds: the one
    home of perf_counter stage bracketing outside spans; the sampled
    twin of every number it accumulates rides the hop spans."""

    __slots__ = ("stats", "key", "t0")

    def __init__(self, stats: dict, key: str):
        self.stats = stats
        self.key = key

    def __enter__(self) -> "_Stage":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb) -> None:
        self.stats[self.key] = self.stats.get(self.key, 0.0) + (
            (time.perf_counter() - self.t0) * 1e3
        )


def stage(stats: dict, key: str) -> _Stage:
    return _Stage(stats, key)


def block_ready_ms(x) -> float:
    """Device-time bracketing for a sampled hop: wait until ``x`` (a
    tensor, or a tuple/list of tensors) is computed and return the
    elapsed ms.  For each CUDA device among the tensors, one event is
    recorded on that device's current stream — the stream that launched
    the producing kernels — and waited on: other streams' and other
    threads' work is not waited for.  CPU tensors are ready at once
    (0.0 when no tensor is on a CUDA device).  Called ONLY when a span
    is recording; a failure on a CUDA tensor propagates."""
    ts = x if isinstance(x, (tuple, list)) else (x,)
    devs = []
    for t in ts:
        if isinstance(t, torch.Tensor) and t.is_cuda and t.device not in devs:
            devs.append(t.device)
    if not devs:
        return 0.0
    t0 = time.perf_counter_ns()
    for d in devs:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        ev.synchronize()
    return (time.perf_counter_ns() - t0) / 1e6


# --------------------------------------------------------------- recorder

# timing pairs a span name holds before its completed ones are resolved
# unasked (each resolution is two runtime calls on the finishing thread)
_PENDING_MAX = 4096


class _Tally:
    """Totals of one span name: count, host ns, resolved device ms (None
    until a timed span resolves) and the timing pairs not yet resolved."""

    __slots__ = ("count", "host_ns", "device_ms", "pending")

    def __init__(self):
        self.count = 0
        self.host_ns = 0
        self.device_ms: Optional[float] = None
        self.pending: deque = deque()


class FlightRecorder:
    """Owns sampling, the bounded trace ring and the slow-query log."""

    def __init__(
        self,
        ratio: Optional[float] = None,
        seed: Optional[int] = None,
        keep: Optional[int] = None,
        slow_ms: Optional[float] = None,
        enabled: Optional[bool] = None,
    ):
        self.enabled = (
            enabled
            if enabled is not None
            else os.environ.get("DGRAPH_TPU_TRACE", "1") != "0"
        )
        self.sampler = Sampler(ratio, seed)
        self.slow_ms = (
            slow_ms
            if slow_ms is not None
            else env_float("DGRAPH_TPU_SLOW_MS", 0.0)
        )
        keep = int(
            keep if keep is not None else env_float("DGRAPH_TPU_TRACE_KEEP", 256)
        )
        self._ring: "deque[dict]" = deque(maxlen=max(1, keep))
        self._slow: "deque[dict]" = deque(maxlen=128)
        self._lock = threading.Lock()
        # span name -> _Tally of every recording span finished
        self._totals: Dict[str, _Tally] = {}

    # -- totals by span name ------------------------------------------------

    def tally(self, name: str, host_ns: int, events) -> None:
        """Count one finished span; ``events`` (start, end) is its device
        timing pair, or None.  Pairs wait for the reader; past
        ``_PENDING_MAX`` of a name, the completed ones are resolved here
        (``query`` never waits), so a process nobody reads stays bounded."""
        with self._lock:
            t = self._totals.get(name)
            if t is None:
                t = self._totals[name] = _Tally()
            t.count += 1
            t.host_ns += host_ns
            if events is None:
                return
            t.pending.append(events)
            if len(t.pending) > _PENDING_MAX:
                while t.pending and t.pending[0][1].query():
                    start, end = t.pending.popleft()
                    t.device_ms = (t.device_ms or 0.0) + start.elapsed_time(end)

    def span_totals(self, reset: bool = False) -> Dict[str, dict]:
        """{span name: {"count", "host_s", "device_ms"}} over every
        recording span finished (since the last reset).  ``device_ms`` is
        None for a name no span of which was timed on a CUDA device.
        Waits for the device events still pending (the caller's wait,
        never the enqueue's)."""
        with self._lock:
            totals = self._totals
            if reset:
                self._totals = {}
            items = [(n, t.count, t.host_ns, t.device_ms, list(t.pending))
                     for n, t in totals.items()]
        out = {}
        for name, count, host_ns, ms, pending in items:
            for start, end in pending:
                end.synchronize()
                ms = (ms or 0.0) + start.elapsed_time(end)
            out[name] = {"count": count, "host_s": host_ns / 1e9,
                         "device_ms": ms}
        return out

    # -- trace intake -------------------------------------------------------

    def publish(self, root: Span) -> None:
        TRACES_RECORDED.add(1)
        with self._lock:
            self._ring.append(
                {
                    "trace_id": root.trace_id,
                    "name": root.name,
                    "started": root.started,
                    "duration_ms": round((root.t1 - root.t0) / 1e6, 3),
                    "root_span_id": root.span_id,
                    "buf": root._buf,
                }
            )

    # -- queries ------------------------------------------------------------

    def traces(self) -> List[dict]:
        """Ring summaries, newest last (the /debug/traces listing)."""
        with self._lock:
            entries = list(self._ring)
        return [
            {
                "trace_id": e["trace_id"],
                "name": e["name"],
                "started": e["started"],
                "duration_ms": e["duration_ms"],
                "spans": len(e["buf"]),
            }
            for e in entries
        ]

    def trace(self, trace_id: str) -> Optional[dict]:
        """All spans recorded under ``trace_id``, merged across ring
        entries — a node that served several legs of one distributed
        trace (forwarded proposal + snapshot read) answers with all of
        them (late-finishing spans appear as they land; the buffer is
        shared with still-running legs by design)."""
        spans: List[dict] = []
        meta: Optional[dict] = None
        with self._lock:
            entries = [e for e in self._ring if e["trace_id"] == trace_id]
        for e in entries:
            if meta is None or e["started"] < (meta.get("started") or 0):
                meta = e
            for sp in list(e["buf"]):
                spans.append(sp.to_dict())
        if not entries:
            return None
        # de-dup: one buf can be referenced by one entry only, but keep
        # the contract tight if that ever changes
        seen = set()
        uniq = []
        for d in spans:
            if d["span_id"] in seen:
                continue
            seen.add(d["span_id"])
            uniq.append(d)
        uniq.sort(key=lambda d: d["t0_ns"])
        return {
            "trace_id": trace_id,
            "name": meta["name"],
            "started": meta["started"],
            "spans": uniq,
        }

    # -- root creation ------------------------------------------------------

    def start_request(
        self,
        name: str,
        ctx: Optional[TraceContext] = None,
        force: bool = False,
    ) -> Optional[Span]:
        """Root span for an inbound request, or None when not sampled.

        The decision: kill switch off → None always.  An upstream
        ``traceparent`` with the sampled flag wins — honoring the
        caller's decision is what makes one trace follow the query
        across groups — but ONLY while the local head sampler is armed
        (ratio > 0): a ratio-0 node promises the zero-overhead path,
        and an untrusted client must not be able to force span
        allocation, device-sync bracketing and ring churn on it with
        one request header (the peer plane's `server_span` still
        honors upstream unconditionally — those endpoints sit behind
        the cluster secret).  Otherwise the local head sampler decides
        and a fresh trace_id is minted."""
        if not self.enabled:
            return None
        if ctx is not None and ctx.sampled and self.sampler.ratio > 0:
            sampled = True
        elif force:
            sampled = True
        else:
            sampled = self.sampler.decide()
        if not sampled:
            return None
        trace_id = ctx.trace_id if ctx is not None else self.sampler.new_id(128)
        parent_id = ctx.span_id if ctx is not None else None
        return Span(
            trace_id, self.sampler.new_id(64), parent_id, name, [], root=True
        )

    def server_span(
        self, name: str, ctx: Optional[TraceContext]
    ) -> "Span | _NoopSpan":
        """Root span for an inbound PEER call: records only when the
        upstream sampled (peer planes never head-sample locally — the
        query that caused the call owns the decision)."""
        if not self.enabled or ctx is None or not ctx.sampled:
            return NOOP
        return Span(
            ctx.trace_id, self.sampler.new_id(64), ctx.span_id, name, [],
            root=True,
        )

    # -- slow-query log (always-on tail sampling) ---------------------------

    def note_slow(
        self,
        query: str,
        duration_s: float,
        trace_id: Optional[str],
        extra: Optional[dict] = None,
    ) -> Optional[str]:
        """Record one slow-query offender if it crossed the threshold.

        Tail sampling is ALWAYS on when slow_ms > 0: a query the head
        sampler skipped still gets a structured log line and a
        single-span synthetic trace in the ring (marked
        ``tail_sampled``), so 'the slow one' is always findable even at
        ratio 0.  Returns the trace_id used, or None below threshold."""
        if self.slow_ms <= 0 or duration_s * 1e3 < self.slow_ms:
            return None
        SLOW_QUERIES.add(1)
        if trace_id is None and self.enabled:
            # synthesize the tail-sampled trace: one root span covering
            # the whole request, backdated to the observed duration
            root = Span(
                self.sampler.new_id(128), self.sampler.new_id(64), None,
                "query", [], root=True,
            )
            root.t0 -= int(duration_s * 1e9)
            # backdated USER-VISIBLE timestamp (trace "started" display
            # field), not interval logic — the duration itself was
            # measured monotonically by the caller
            # graftlint: ignore[wallclock-duration]
            root.started = time.time() - duration_s
            root.set_attr("query", query[:200])
            root.set_attr("tail_sampled", True)
            root.finish()
            trace_id = root.trace_id
        entry = {
            "ts": time.time(),
            "duration_ms": round(duration_s * 1e3, 3),
            "trace_id": trace_id,
            "query": query[:500],
        }
        if extra:
            entry.update(extra)
        with self._lock:
            self._slow.append(entry)
        print("# slowquery " + json.dumps(entry, default=str), file=sys.stderr)
        return trace_id

    def slow_queries(self) -> List[dict]:
        with self._lock:
            return list(self._slow)


# process-wide recorder: instrumentation sites are deep in the engine/
# cache/RPC layers with no server reference in scope — a module global
# (re-read through the module attribute on every use) is the same
# pattern utils/metrics.py uses, and configure() swaps it for tests
recorder = FlightRecorder()


def configure(**kwargs) -> FlightRecorder:
    """Rebuild the process recorder (tests, CLI flags).  Accepts the
    FlightRecorder kwargs: ratio, seed, keep, slow_ms, enabled."""
    global recorder
    recorder = FlightRecorder(**kwargs)
    return recorder


def start_request(
    name: str, ctx: Optional[TraceContext] = None, force: bool = False
) -> Optional[Span]:
    return recorder.start_request(name, ctx, force=force)


def server_span(name: str, ctx: Optional[TraceContext]):
    return recorder.server_span(name, ctx)


def span_totals(reset: bool = False) -> Dict[str, dict]:
    """The process recorder's totals by span name
    (:meth:`FlightRecorder.span_totals`)."""
    return recorder.span_totals(reset)
