"""Reduction of a ``torch.profiler`` trace (CPU and CUDA activities) to
what the per-layer metrics read.

The device intervals are the profiler's CUDA events (kernels, copies,
fills); the card is busy over their union.  The interval arithmetic and
the event filter are copied from ``chip_smoke.py`` (``_union_us``,
``pass_profile``).  The traced window is the harness's own
``bench.window`` range on the host, so the device's idle gaps can be
named by what the host was doing during each.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

WINDOW = "bench.window"  # the harness's record_function around the traced slice

Span = Tuple[str, float, float]  # (name, start us, end us)


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def merged(spans) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class Trace:
    """One traced slice of the window."""

    device: List[Span]             # every device op
    host: List[Span]               # every host-side range (ops, runtime calls)
    window: Tuple[float, float]    # the traced slice, us
    batches: int                   # batches completed inside it
    by_name: Dict[str, float] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        lo, hi = self.window
        return union_us([(max(s, lo), min(e, hi)) for _n, s, e in self.device
                         if e > lo and s < hi]) / 1e6


def from_profile(prof, batches: int) -> Optional[Trace]:
    """The trace of ``prof`` (a stopped ``torch.profiler.profile``), or
    None when it holds no ``bench.window`` range."""
    from torch.autograd import DeviceType

    device, host = [], []
    for ev in prof.events():
        s, e = float(ev.time_range.start), float(ev.time_range.end)
        if ev.device_type == DeviceType.CUDA:
            # a record_function range is mirrored on the device's timeline:
            # it is no device op
            if not (getattr(ev, "is_user_annotation", False)
                    or ev.name.startswith("bench.")):
                device.append((ev.name, s, e))
        elif ev.device_type == DeviceType.CPU:
            host.append((ev.name, s, e))
    win = [(s, e) for n, s, e in host if n == WINDOW]
    if not win:
        return None
    t = Trace(device, host, win[0], batches)
    for n, s, e in device:
        t.by_name[n] = t.by_name.get(n, 0.0) + (e - s) / 1e6
    return t


def top_ops(t: Trace, k: int = 10) -> List[list]:
    """The ``k`` device ops that took most time: [name, seconds]."""
    return [[n, v] for n, v in sorted(t.by_name.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(t: Trace, k: int = 10) -> List[list]:
    """The device's idle time inside the window, summed by the innermost
    host range open at each gap's middle: the ``k`` largest, [name,
    seconds]."""
    lo, hi = t.window
    busy = merged([(max(s, lo), min(e, hi)) for _n, s, e in t.device
                   if e > lo and s < hi])
    gaps, cur = [], lo
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        gaps.append((cur, hi))
    host = sorted((s, e, n) for n, s, e in t.host if n != WINDOW)
    starts = [h[0] for h in host]
    out: Dict[str, float] = {}
    for s, e in gaps:
        mid = (s + e) / 2
        name = "host outside any traced range"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 256, -1), -1):
            if host[j][1] >= mid:
                name = host[j][2]
                break
        out[name] = out.get(name, 0.0) + (e - s) / 1e6
    return [[n, v] for n, v in sorted(out.items(), key=lambda kv: -kv[1])[:k]]
