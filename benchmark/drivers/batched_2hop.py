"""The batched 2-hop driver: ``dgraph_tpu_torch.bench2hop.two_hop_batch``
on the layout and plan of ``bench2hop.prepare``, on one card.

Set-up builds the cell's graph and pool (``benchmark/data.py``), the
arena and its grouped inline layout, the capacity plan over the pool,
and warms up on every batch of the pool.  The window is the closed loop
of ``benchmark/measure.py`` over the pool's batches in order.  Once it
has closed, a sample of the last batch's rows drawn from the seed, with
its heaviest query, is decoded from the returned lanes, and every
completed query and the sample are held to the plain reference
(``benchmark/reference.py``, ``benchmark/compare.py``).

A traffic mix that names no ``driver`` runs here.  Its pool must hold
whole batches.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import compare, data, reference, trace
from benchmark.measure import IN_FLIGHT, TRACE_SECONDS, Run, _Fetch, _loop, _sync


def run_cell(cell, seed: int, seconds: float, tracing: bool,
             devices: Sequence[torch.device], t_start: Optional[float] = None):
    """One run on ``devices[0]``.  Returns (Run, checks, failed queries,
    info)."""
    tr = cell.traffic
    if tr["pool"] % tr["batch"]:
        raise ValueError(f"traffic {cell.workload['traffic']!r}: "
                         "the pool must hold whole batches")
    device = devices[0]
    from dgraph_tpu_torch import bench2hop, ops
    from dgraph_tpu_torch.models.arena import csr_dense_from_edges
    from dgraph_tpu_torch.ops.sets import SENT

    t_start = time.perf_counter() if t_start is None else t_start
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
