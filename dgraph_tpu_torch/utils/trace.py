"""Request tracing and latency breakdown (copy of
``dgraph_tpu/utils/trace.py``).

Equivalent of the reference's golang.org/x/net/trace usage: sampled
per-request traces with lazy event strings (dgraph/server.go:120-125),
served at ``/debug/requests``, plus the client-visible latency map
{parsing, processing, json} (query/query.go:102-119).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, List, Optional, Tuple


def _fmt_ns(ns: int) -> str:
    """Render a duration the way Go's time.Duration.String does
    (the reference returns e.g. '79.3ms' in latency maps)."""
    if ns < 1_000:
        return f"{ns}ns"
    if ns < 1_000_000:
        us = ns / 1_000
        return f"{us:.6g}µs"
    if ns < 1_000_000_000:
        return f"{ns / 1_000_000:.6g}ms"
    return f"{ns / 1_000_000_000:.6g}s"


class Latency:
    """Per-request stage timing; .to_map() is what goes in the response
    (mirrors query.Latency ToMap, query/query.go:102-119)."""

    def __init__(self):
        self.start = time.perf_counter_ns()
        self.parsing_ns = 0
        self.processing_ns = 0
        self.json_ns = 0

    def _mark(self) -> int:
        now = time.perf_counter_ns()
        elapsed = now - self.start
        self.start = now
        return elapsed

    def record_parsing(self) -> None:
        self.parsing_ns = self._mark()

    def record_processing(self) -> None:
        self.processing_ns = self._mark()

    def record_json(self) -> None:
        self.json_ns = self._mark()

    def total_ns(self) -> int:
        return self.parsing_ns + self.processing_ns + self.json_ns

    def to_map(self) -> dict:
        out = {"total": _fmt_ns(self.total_ns())}
        if self.parsing_ns:
            out["parsing"] = _fmt_ns(self.parsing_ns)
        if self.processing_ns:
            out["processing"] = _fmt_ns(self.processing_ns)
        if self.json_ns:
            out["json"] = _fmt_ns(self.json_ns)
        return out


class RequestTrace:
    """One request's event log; cheap no-op unless sampled."""

    __slots__ = ("active", "events", "t0")

    def __init__(self, active: bool):
        self.active = active
        self.events: List[Tuple[int, str]] = []
        self.t0 = time.perf_counter_ns() if active else 0

    def printf(self, fmt: str, *args) -> None:
        if self.active:
            self.events.append(
                (time.perf_counter_ns() - self.t0, fmt % args if args else fmt)
            )


class Tracer:
    """Sampled tracing, ratio as in --trace (cmd/dgraph/main.go:250-255).
    Finished traces are kept in a bounded ring served at /debug/requests.

    Sampling goes through an OWNED seeded sampler (obs.spans.Sampler —
    one implementation of the discipline, shared with the flight
    recorder's head sampler) instead of the global ``random`` module:
    deterministic under a pinned ``seed`` / ``DGRAPH_TPU_TRACE_SEED``,
    thread-safe, and decoupled from every other consumer of the
    process-wide random stream."""

    def __init__(self, ratio: float = 0.0, keep: int = 64,
                 seed: Optional[int] = None):
        # lazy import: obs.spans imports utils submodules — binding at
        # call time keeps the package import order a non-issue
        from dgraph_tpu_torch.obs.spans import Sampler

        self.ratio = ratio
        self._sampler = Sampler(ratio=ratio, seed=seed)
        self._done: Deque[dict] = deque(maxlen=keep)
        self._lock = threading.Lock()

    def begin(self) -> RequestTrace:
        self._sampler.ratio = self.ratio  # tests tweak .ratio live
        return RequestTrace(self._sampler.decide())

    def finish(self, tr: RequestTrace, family: str, title: str) -> None:
        if not tr.active:
            return
        with self._lock:
            self._done.append(
                {
                    "family": family,
                    "title": title,
                    "events": [
                        {"at": _fmt_ns(at), "msg": msg} for at, msg in tr.events
                    ],
                }
            )

    def recent(self) -> List[dict]:
        with self._lock:
            return list(self._done)
