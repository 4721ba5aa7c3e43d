"""The closed loop that a driver times (``benchmark/drivers/<name>.py``):
batches submitted in order, ``IN_FLIGHT`` of them in flight, each one's
answers fetched into pinned host memory behind a CUDA event, and what the
metric readers read (``Run``, a ``Phase`` a stretch of the loop).

``_loop`` drives any ``call(b) -> (checksums, counts, held)`` over batch
indices ``0, 1, ...`` of a cycle, round and round: batch k + 1 is
enqueued before batch k's answers are fetched.  A batch's latency runs
from its submission to its answers being on the host, the wait behind
the batch before it included.

A driver that traces runs the first ``TRACE_SECONDS`` of its window under
``torch.profiler`` (CPU and CUDA activities) and the rest untraced.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import trace

TRACE_SECONDS = 1.0
IN_FLIGHT = 2  # batches enqueued before the oldest one's answers are fetched


@dataclass
class Phase:
    """Batches completed in one stretch of the loop."""

    batch: List[int] = field(default_factory=list)       # index in the pool's cycle
    counts: List[np.ndarray] = field(default_factory=list)
    checksums: List[np.ndarray] = field(default_factory=list)
    latency_s: List[float] = field(default_factory=list)
    dispatch_s: List[float] = field(default_factory=list)
    seconds: float = 0.0
    edges: int = 0    # hop-1 + hop-2 edges of its queries, as the reference counts them
    held: Optional[Tuple[int, tuple]] = None             # the last batch's lanes


@dataclass
class Run:
    """What the metric readers read (``benchmark/metrics/*.py``)."""

    setup_s: float = 0.0
    layout_s: float = 0.0
    plan_s: float = 0.0
    batch_q: int = 0
    plan: dict = field(default_factory=dict)
    window: Optional[Phase] = None        # the untraced window (or its untraced rest)
    traced: Optional[Phase] = None
    trace: Optional[trace.Trace] = None
    queries: int = 0                      # completed in the window, every phase
    hop2_edges: int = 0                   # their hop-2 edges, as the reference counts them
    lanes_per_query: int = 0              # target lanes of the (inline2, ov2) a query gets


class _Fetch:
    """One in-flight slot: the batch's answers copied into host memory
    behind an event (synchronous on the CPU)."""

    def __init__(self, q: int, device: torch.device):
        self.cuda = device.type == "cuda"
        self.chk = torch.empty(q, dtype=torch.int32, pin_memory=self.cuda)
        self.cnt = torch.empty(q, dtype=torch.int32, pin_memory=self.cuda)
        self.event = torch.cuda.Event() if self.cuda else None

    def start(self, chk: torch.Tensor, cnt: torch.Tensor) -> None:
        self.chk.copy_(chk, non_blocking=self.cuda)
        self.cnt.copy_(cnt, non_blocking=self.cuda)
        if self.event is not None:
            self.event.record()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
        return self.chk.numpy().copy(), self.cnt.numpy().copy()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _loop(call, fetch: List[_Fetch], n_cycle: int, seconds: float,
          max_batches: Optional[int] = None) -> Phase:
    """Submit batches 0, 1, ... of the cycle, ``len(fetch)`` in flight,
    until ``seconds`` have passed (or ``max_batches`` were submitted),
    then drain."""
    out = Phase()
    pending: deque = deque()
    free = deque(fetch)
    k = 0
    t0 = now = time.perf_counter()

    def more() -> bool:
        return ((max_batches is None or k < max_batches)
                and time.perf_counter() - t0 < seconds)

    def submit() -> None:
        nonlocal k
        b = k % n_cycle
        k += 1
        f = free.popleft()
        with record_function("bench.submit"):
            ts = time.perf_counter()
            chk, cnt, out2 = call(b)
            td = time.perf_counter()
            f.start(chk, cnt)
        out.held = (b, out2)  # only the newest batch's lanes stay referenced
        pending.append((b, ts, td - ts, f))

    while free and more():
        submit()
    while pending:
        b, ts, disp, f = pending.popleft()
        with record_function("bench.wait"):
            chk, cnt = f.wait()
        now = time.perf_counter()
        out.batch.append(b)
        out.counts.append(cnt)
        out.checksums.append(chk)
        out.latency_s.append(now - ts)
        out.dispatch_s.append(disp)
        free.append(f)
        if more():
            submit()
    out.seconds = now - t0
    return out
