"""dgraph_tpu_torch.obs — the end-to-end query flight recorder and the
per-request resource ledger (the surface of ``dgraph_tpu.obs``).

Span-based tracing across scheduler, cache, engine, WAL and peer RPCs,
with W3C ``traceparent`` propagation, head + slow-tail sampling, a
bounded trace ring (``/debug/traces``), a structured slow-query log and
Chrome ``trace_event`` export; each sampled hop's device time is waited
for on a CUDA event (``block_ready_ms``).  See obs/spans.py for the
design, obs/ledger.py for the per-request account and obs/device.py for
the device snapshot (``/debug/device``).  While ``torch.profiler``
collects, every span is also a profiler range, and ``span_totals()``
tallies spans by name (count, host seconds, device ms).
"""

from dgraph_tpu_torch.obs import device, ledger  # noqa: F401 — submodule surface
from dgraph_tpu_torch.obs.export import chrome_trace
from dgraph_tpu_torch.obs.spans import (
    NOOP,
    FlightRecorder,
    Sampler,
    Span,
    TraceContext,
    block_ready_ms,
    child,
    configure,
    current_span,
    format_traceparent,
    parse_traceparent,
    server_span,
    span_totals,
    stage,
    start_request,
)


def get_recorder() -> FlightRecorder:
    """The live process recorder (configure() swaps it; always read
    through this or the spans module attribute, never a stale import)."""
    from dgraph_tpu_torch.obs import spans

    return spans.recorder


__all__ = [
    "FlightRecorder",
    "NOOP",
    "Sampler",
    "Span",
    "TraceContext",
    "block_ready_ms",
    "child",
    "chrome_trace",
    "configure",
    "current_span",
    "format_traceparent",
    "get_recorder",
    "parse_traceparent",
    "server_span",
    "span_totals",
    "stage",
    "start_request",
]
