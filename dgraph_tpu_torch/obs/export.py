"""Trace exports: Chrome ``trace_event`` JSON for chrome://tracing /
Perfetto (copy of ``dgraph_tpu/obs/export.py``).

The flight recorder's native JSON (obs/spans.py ``FlightRecorder.trace``)
is the debugging surface; this module renders the same spans as the
Trace Event Format's complete events (``ph: "X"``) so an operator can
drop ``/debug/traces/<id>?format=chrome`` straight into Perfetto and
see the query as a flame chart — queue wait, cohort flush, per-hop
device time and remote RPC attempts on one timeline.

Thread ids become trace-event ``tid`` rows, so the handler thread, the
scheduler flush worker and the cohort threads render as separate
tracks; span attrs ride in ``args``.
"""

from __future__ import annotations

from typing import Dict, List


def chrome_trace(trace: dict) -> dict:
    """FlightRecorder.trace() dict → {"traceEvents": [...]} JSON shape.

    Timestamps are microseconds from the trace's earliest span (the
    format wants a shared epoch, not wall time); incomplete spans
    (still running when exported) render with zero duration rather than
    being dropped — seeing a stuck span IS the point."""
    spans: List[dict] = trace.get("spans", [])
    if not spans:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t_base = min(s["t0_ns"] for s in spans)
    events: List[dict] = []
    # one metadata row per thread keeps Perfetto's track names readable
    tids: Dict[int, int] = {}
    for s in spans:
        tid = tids.setdefault(s["tid"], len(tids) + 1)
        t1 = s["t1_ns"] if s["t1_ns"] is not None else s["t0_ns"]
        args = dict(s.get("attrs") or {})
        if s.get("links"):
            args["links"] = s["links"]
        args["span_id"] = s["span_id"]
        if s.get("parent_id"):
            args["parent_id"] = s["parent_id"]
        events.append(
            {
                "name": s["name"],
                "ph": "X",
                "pid": 1,
                "tid": tid,
                "ts": round((s["t0_ns"] - t_base) / 1e3, 3),
                "dur": round((t1 - s["t0_ns"]) / 1e3, 3),
                "args": args,
            }
        )
    for raw, tid in tids.items():
        events.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "args": {"name": f"thread-{raw}"},
            }
        )
    return {"traceEvents": events, "displayTimeUnit": "ms"}
