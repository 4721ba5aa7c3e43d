"""One run of a batched 2-hop cell: set-up, the measured window, the
check against the reference.

The window drives ``dgraph_tpu_torch.bench2hop.two_hop_batch`` on the
layout and plan of ``bench2hop.prepare``, closed loop with ``IN_FLIGHT``
batches in flight: batch k + 1 is enqueued before batch k's answers (its
per-query checksums and edge counts) are fetched, each fetch into pinned
host memory behind a CUDA event.  The pool is replayed in order, round
and round.  A batch's latency runs from its submission to its answers
being on the host, the wait behind the batch before it included.

With tracing on, the first ``TRACE_SECONDS`` of the window run under
``torch.profiler`` (CPU and CUDA activities) and the rest untraced.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import compare, data, reference, trace

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


def run_cell(cell, seed: int, seconds: float, tracing: bool,
             device: torch.device, t_start: Optional[float] = None):
    """One run.  Returns (Run, checks, failed queries, info)."""
    from dgraph_tpu_torch import bench2hop, ops
    from dgraph_tpu_torch.models.arena import csr_dense_from_edges
    from dgraph_tpu_torch.ops.sets import SENT

    t_start = time.perf_counter() if t_start is None else t_start
    tr = cell.traffic
    run = Run(batch_q=tr["batch"])

    # -- set-up: data, arena and layout, plan, warm-up ------------------------
    inputs = data.build_inputs(cell.config, tr, seed, device, cell.root)
    if device.type == "cuda":  # the peak is the program's, not the generator's
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    arena = csr_dense_from_edges(inputs.src, inputs.dst, inputs.n_nodes, device)
    bench2hop.layout(arena)
    _sync(device)
    run.layout_s = time.perf_counter() - t
    t = time.perf_counter()
    fcap = ops.bucket(max(len(f) for f in inputs.pool))
    metap, ov, plan, fmat = bench2hop.prepare(arena, inputs.pool, fcap)
    _sync(device)
    run.plan_s = time.perf_counter() - t
    run.plan = {k: getattr(plan, k) for k in
                ("grouped", "fcap", "pcap1", "capo1", "ucap", "pcap2", "capo2")}
    q = tr["batch"]
    n_cycle = len(inputs.pool) // q
    batches = [fmat[b * q:(b + 1) * q] for b in range(n_cycle)]

    def call(b: int):
        return bench2hop.two_hop_batch(metap, ov, batches[b], plan)

    fetch = [_Fetch(q, device) for _ in range(IN_FLIGHT)]
    _loop(call, fetch, n_cycle, float("inf"), max_batches=n_cycle)
    _sync(device)
    run.setup_s = time.perf_counter() - t_start

    # -- the window ------------------------------------------------------------
    phases = []
    if tracing:
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        with record_function(trace.WINDOW):
            run.traced = _loop(call, fetch, n_cycle, min(TRACE_SECONDS, seconds))
        _sync(device)
        prof.stop()
        phases.append(run.traced)
        rest = seconds - run.traced.seconds
        if rest > 0:
            run.window = _loop(call, fetch, n_cycle, rest)
            phases.append(run.window)
    else:
        run.window = _loop(call, fetch, n_cycle, seconds)
        phases.append(run.window)
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)

    # -- the last batch's lanes, a sample of its rows --------------------------
    last = [p for p in phases if p.batch][-1]
    b_last, (inl2, ov2) = last.held
    run.lanes_per_query = int(inl2[0].numel() + ov2[0].numel())
    cnt_last = last.counts[-1]
    rng = data.run_rng(seed, 3)
    rows = set(rng.choice(q, size=min(tr["check_sets"], q), replace=False).tolist())
    rows.add(int(np.argmax(cnt_last)))
    rows = sorted(rows)
    idx = torch.tensor(rows, device=device)
    lanes = torch.cat([inl2[idx].reshape(len(rows), -1),
                       ov2[idx].reshape(len(rows), -1)], 1).cpu().numpy()
    sampled = []
    for r, v in zip(rows, lanes):
        v = v[v != SENT]
        sampled.append((b_last * q + r, reference.sorted_unique(v & plan.mask), len(v)))
    del inl2, ov2, lanes, idx, batches, fmat, metap, ov, arena
    for p in phases:
        p.held = None
    _sync(device)
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # -- the reference, once the window has closed -----------------------------
    t = time.perf_counter()
    csr = reference.build_csr(inputs.src, inputs.dst, inputs.n_nodes)
    ref = reference.answers(csr, inputs.pool)
    done = []
    for p in phases:
        for b, cnt, chk in zip(p.batch, p.counts, p.checksums):
            ix = np.arange(b * q, (b + 1) * q)
            done.append((ix, cnt, chk))
            run.queries += q
            p.edges += int(ref[0][ix].sum() + ref[1][ix].sum())
            run.hop2_edges += int(ref[1][ix].sum())
    checks, failed = compare.compare(csr, inputs.pool, ref, done, sampled)
    ref_s = time.perf_counter() - t
    if tracing:
        run.trace = trace.from_profile(prof, len(run.traced.batch))

    info = {
        "nodes": inputs.n_nodes, "stored_edges": int(len(csr.dst)),
        "pool": len(inputs.pool), "batch": q, "plan": run.plan,
        "batches": sum(len(p.batch) for p in phases), "queries": run.queries,
        "edges": sum(p.edges for p in phases), "hop2_edges": run.hop2_edges,
        "lanes_per_query": run.lanes_per_query,
        "window_s": sum(p.seconds for p in phases),
        "setup_s": run.setup_s, "layout_s": run.layout_s, "plan_s": run.plan_s,
        "reference_s": ref_s, "memory_peak_bytes": int(peak),
        "sampled_rows": len(sampled),
    }
    return run, checks, failed, info
