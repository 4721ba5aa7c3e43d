"""Batched 2-hop pipeline (the port of ``bench.py``'s two arms:
``_run_device_dedup``, the headline, and ``_run_host_dedup``).

The graph is a dense CSR arena (row i == uid i) in the skey-grouped
inline-head layout on the device.  Per chunk of queries the pipeline runs
hop 1 (``expand_inline_grouped`` over the seed frontiers), an on-device
sort-unique dedup of hop 1's targets, hop 2 over that frontier, and a
per-query checksum of every hop-2 target; the frontier never leaves the
device between hops.  Each hop's overflow slot-map is the slot-map kernel
(``ops/slotmap.py``, ``csrc/slotmap.cu``); on CPU tensors its wrapper runs
the plain version.  A numpy CSR walk of the same queries is the baseline
and the oracle (``np_two_hop``).

The host-dedup arm (``run_host_dedup``) runs each hop as one batched plan
of the arena's ``ops.ClassedExpander`` (torch ops: one masked gather per
degree class) over sub-batches of 50 queries: hop 1 materialises its
targets, the host dedups them with ``np.unique`` and class-partitions
them, and hop 2 returns only per-query checksums and edge counts.  Its
capacities are planned once over the whole stream with ``bucket_fine``.
Every hop-1 sub-batch is launched up front, so the host's dedup overlaps
the device's queue.

    python -m dgraph_tpu_torch.bench2hop                # on cuda
    python -m dgraph_tpu_torch.bench2hop --device cpu   # plain versions
    python -m dgraph_tpu_torch.bench2hop --dedup both   # both arms

Environment: BENCH_NODES (2,000,000), BENCH_EDGES (21,000,000),
BENCH_SEEDS (4096 drawn seeds per query), BENCH_ITERS (1000 queries).
``--dedup`` device (default), host or both picks the arms.  Prints one
JSON line: metric, value (edges/s), unit, vs_baseline and hop_dedup of
the first arm run (device, when it runs), ``arms`` (each arm's edges/s,
vs_baseline and seconds), slotmap_launches, platform, device.  Exits
non-zero when any arm's per-query edge count or checksum, or its last
query's set, differs from numpy's.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import asdict, dataclass
from typing import List, Optional

import numpy as np
import torch

from dgraph_tpu_torch import obs, ops
from dgraph_tpu_torch.device import resolve
from dgraph_tpu_torch.models.arena import CSRArena, csr_dense_from_edges
import dgraph_tpu_torch.ops.slotmap as _slotmap
from dgraph_tpu_torch.ops.batch import wrap_int32
from dgraph_tpu_torch.ops.sets import SENT

GRAPH_SEED = 7      # bench.py build_graph's default
FRONTIER_SEED = 3   # bench.py run_bench's seed draw
CHUNK_Q = 200       # queries per batched program (bench.py's CHUNK_Q)


def gen_edges(n_nodes: int, n_edges: int):
    """The bench graph's edges: uniform sources, half the targets uniform
    and half pareto-skewed (celebrity uids get most edges)."""
    rng = np.random.default_rng(GRAPH_SEED)
    src = rng.integers(1, n_nodes + 1, size=n_edges)
    pop = (rng.pareto(1.2, size=n_edges).astype(np.float64) + 1.0)
    dst = (np.clip(pop / pop.max(), 1e-9, 1.0) * (n_nodes - 1)).astype(np.int64) + 1
    half = n_edges // 2
    dst[:half] = rng.integers(1, n_nodes + 1, size=half)
    return src, dst


def build_graph(n_nodes: int, n_edges: int, device) -> CSRArena:
    """Skewed-degree random digraph as a dense CSR arena on ``device``."""
    src, dst = gen_edges(n_nodes, n_edges)
    return csr_dense_from_edges(src, dst, n_nodes, device)


def draw_frontiers(n_nodes: int, n_seeds: int, iters: int) -> List[np.ndarray]:
    """``iters`` seed frontiers of ``n_seeds`` uniform draws each, deduped."""
    rng = np.random.default_rng(FRONTIER_SEED)
    return [np.unique(rng.integers(1, n_nodes + 1, size=n_seeds))
            for _ in range(iters)]


def np_expand(offsets, dst, rows):
    """Vectorized numpy CSR expansion (the CPU baseline's hot op)."""
    rows = rows[rows >= 0]
    if not len(rows):
        return np.empty(0, dtype=dst.dtype)
    starts = offsets[rows]
    degs = offsets[rows + 1] - starts
    total = int(degs.sum())
    if total == 0:
        return np.empty(0, dtype=dst.dtype)
    cum = np.cumsum(degs)
    within = np.arange(total) - np.repeat(cum - degs, degs)
    return dst[np.repeat(starts, degs) + within]


def np_two_hop(a, h_dst, frontier):
    # dense arena: rows are uids directly (same advantage the device gets)
    out1 = np_expand(a.h_offsets, h_dst, frontier)
    f1 = np.unique(out1)
    out2 = np_expand(a.h_offsets, h_dst, f1)
    chk = np.int32(out2.astype(np.int64).sum() & 0xFFFFFFFF)
    return len(out1) + len(out2), np.unique(out2), chk


def numpy_baseline(a: CSRArena, frontiers, reps: int = 2):
    """Best-of-``reps`` seconds of the numpy 2-hop over every query, with
    per-query edge counts (int64) and checksums (int32)."""
    h_dst = a.host_dst()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        res = [np_two_hop(a, h_dst, f) for f in frontiers]
        best = min(best, time.perf_counter() - t0)
    edges = np.array([n for n, _, _ in res], dtype=np.int64)
    chks = np.array([c for _, _, c in res], dtype=np.int32)
    return best, edges, chks


@dataclass(frozen=True)
class Plan:
    """Capacities of one batched 2-hop program, planned on the host over
    the whole query stream (untimed), and the target decode mask."""

    grouped: bool
    mask: int
    fcap: int    # seed frontier width
    pcap1: int   # hop-1 slot-map prefix (overflow-bearing seed rows)
    capo1: int   # hop-1 overflow chunks
    ucap: int    # unique hop-1 frontier width
    pcap2: int   # hop-2 slot-map prefix
    capo2: int   # hop-2 overflow chunks


def plan_caps(a: CSRArena, frontiers, fcap: int, grouped: bool) -> Plan:
    """Worst-case capacities over the stream, bucket_fine'd (bench.py's
    planning loop)."""
    h_dst = a.host_dst()
    deg_of = (a.h_offsets[1:] - a.h_offsets[:-1]).astype(np.int64)
    worst1 = worst2 = worstu = wp1 = wp2 = 1
    for f in frontiers:
        c1 = int(a.ov_chunk_degree_of_rows(f).sum())
        f1 = np.unique(np_expand(a.h_offsets, h_dst, f))
        c2 = int(a.ov_chunk_degree_of_rows(f1).sum())
        worst1, worst2 = max(worst1, c1), max(worst2, c2)
        worstu = max(worstu, len(f1))
        wp1 = max(wp1, int((deg_of[f] > ops.INLINE).sum()))
        wp2 = max(wp2, int((deg_of[f1] > ops.INLINE).sum()))
    capo1, capo2 = ops.bucket_fine(worst1), ops.bucket_fine(worst2)
    ucap = ops.bucket_fine(worstu)
    if grouped:
        pcap1, pcap2 = ops.bucket_fine(wp1), min(ops.bucket_fine(wp2), ucap)
    else:  # ungrouped rows: the slot-map must span every row
        pcap1, pcap2 = fcap, ucap
    return Plan(grouped, ops.GROUP_MASK if grouped else SENT, fcap,
                pcap1, capo1, ucap, pcap2, capo2)


def group_order(a: CSRArena, frontiers) -> List[np.ndarray]:
    """Each seed frontier in skey order — overflow-bearing rows first,
    ascending — exactly as the device dedup orders hop-1 output, so hop 1
    shares the short-prefix slot-map."""
    deg_of = (a.h_offsets[1:] - a.h_offsets[:-1]).astype(np.int64)
    out = []
    for f in frontiers:
        key = ops.skey_encode(f, deg_of[f] > ops.INLINE)
        out.append(f[np.argsort(key, kind="stable")])
    return out


def next_rows(inl1: torch.Tensor, ov1: torch.Tensor, plan: Plan) -> torch.Tensor:
    """Hop 1's targets -> hop 2's rows: sort-unique of the skey values
    (grouped order), cut to ucap, decoded; padding becomes -1."""
    q = inl1.shape[0]
    f1 = ops.sort_unique(torch.cat([inl1.reshape(q, -1), ov1.reshape(q, -1)], 1))
    f1 = f1[:, : plan.ucap]
    return torch.where(f1 == SENT, -1, f1 & plan.mask)


def checksum(inl2: torch.Tensor, ov2: torch.Tensor, mask: int) -> torch.Tensor:
    """Per-query sum of every produced (decoded) hop-2 uid, int32."""
    si = torch.where(inl2 == SENT, 0, inl2 & mask).sum((1, 2), dtype=torch.int64)
    so = torch.where(ov2 == SENT, 0, ov2 & mask).sum((1, 2), dtype=torch.int64)
    return wrap_int32(si + so)


def two_hop_batch(metap, ov_chunks, fm: torch.Tensor, plan: Plan):
    """One chunk of queries, fm int32[Q, fcap] (SENT-padded seed uids):
    (checksums int32[Q], edges int32[Q], (inline2, ov2)).  Both hops'
    slot-maps go through the kernel's wrapper; the kernel is exact for
    any row order, so it serves the ungrouped layout too (the TPU kernel
    needs the grouped prefix).

    Spans (recording under a sampled request or the profiler, each timed
    on ``fm``'s device): ``two_hop.batch`` around ``two_hop.hop1``,
    ``two_hop.dedup``, ``two_hop.hop2`` and ``two_hop.checksum``."""
    expander = ops.expand_inline_grouped_kernel
    dev = fm.device
    with obs.child("two_hop.batch", device=dev) as sp:
        if sp.recording:
            sp.set_attr("Q", fm.shape[0])
            sp.set_attr("ucap", plan.ucap)
            sp.set_attr("capo1", plan.capo1)
            sp.set_attr("capo2", plan.capo2)
        with obs.child("two_hop.hop1", device=dev):
            rows0 = ops.frontier_rows(fm)
            inl1, ov1, t1 = expander(metap, ov_chunks, rows0, plan.capo1,
                                     plan.pcap1)
        with obs.child("two_hop.dedup", device=dev):
            rows1 = next_rows(inl1, ov1, plan)
        with obs.child("two_hop.hop2", device=dev):
            inl2, ov2, t2 = expander(metap, ov_chunks, rows1, plan.capo2,
                                     plan.pcap2)
        with obs.child("two_hop.checksum", device=dev):
            chk = checksum(inl2, ov2, plan.mask)
        return chk, t1 + t2, (inl2, ov2)


def layout(a: CSRArena):
    """(metap, ov_chunks, grouped): the grouped inline layout, or the
    plain one where the uid space is too large for the group bit."""
    try:
        metap, ov = a.inline_layout_grouped()
        return metap, ov, True
    except ValueError:
        metap, ov = a.inline_layout()
        return metap, ov, False


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def prepare(a: CSRArena, frontiers, fcap: int, plan: Optional[Plan] = None):
    """(metap, ov_chunks, plan, fmat): the layout, the capacities (planned
    here unless given) and the seed frontiers in group order as
    int32[n, fcap] on the arena's device."""
    metap, ov, grouped = layout(a)
    if plan is None:
        plan = plan_caps(a, frontiers, fcap, grouped)
    gfronts = group_order(a, frontiers) if grouped else frontiers
    fmat = torch.from_numpy(
        np.stack([ops.pad_to(f, fcap) for f in gfronts])
    ).to(a.device)
    return metap, ov, plan, fmat


def run_pass(metap, ov_chunks, fmat: torch.Tensor, plan: Plan,
             chunk_q: int = CHUNK_Q):
    """One pass over every query, ``chunk_q`` per batch: (per-query
    checksums int32, per-query edge counts int32), fetched once."""
    n, dev = fmat.shape[0], fmat.device
    chks = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    for b in range(0, n, chunk_q):
        c, t, _out2 = two_hop_batch(metap, ov_chunks, fmat[b: b + chunk_q], plan)
        chks[b: b + chunk_q] = c
        counts[b: b + chunk_q] = t
    return chks.cpu().numpy(), counts.cpu().numpy()


def run_device_dedup(a: CSRArena, frontiers, fcap: int, chunk_q: int = CHUNK_Q,
                     stats: Optional[dict] = None, plan: Optional[Plan] = None):
    """The whole batched 2-hop over ``frontiers`` on the arena's device,
    ``chunk_q`` queries per batch: one warm pass, then best-of-4 timed
    passes.  Returns (best seconds, edges, per-query checksums int32,
    the last query's hop-2 uid set), as bench.py's arm does.

    ``plan``: capacities planned beforehand over the same frontiers
    (default: planned here).  ``stats``, when given, receives the plan's
    capacities, the per-query edge counts, and each pass's seconds and
    slot-map kernel launches."""
    dev = a.device
    metap, ov, plan, fmat = prepare(a, frontiers, fcap, plan)
    n = fmat.shape[0]

    secs, launches = [], []
    best = float("inf")
    for k in range(5):  # pass 0 warms the allocator and the kernel build
        n0 = _slotmap.KERNEL.launches
        _sync(dev)
        t0 = time.perf_counter()
        chks, counts = run_pass(metap, ov, fmat, plan, chunk_q)
        _sync(dev)
        dt = time.perf_counter() - t0
        secs.append(dt)
        launches.append(_slotmap.KERNEL.launches - n0)
        if k:
            best = min(best, dt)
    edges = int(counts.astype(np.int64).sum())

    # untimed correctness artifact: the last query's full hop-2 set
    _c, _t, (inl2, ov2) = two_hop_batch(metap, ov, fmat[-1:], plan)
    got = ops.sort_unique(torch.cat([inl2.reshape(1, -1), ov2.reshape(1, -1)], 1))
    got = got[0].cpu().numpy()
    last_set = np.unique(got[got != SENT] & plan.mask)
    if stats is not None:
        stats.update(
            plan=asdict(plan), chunk_q=chunk_q, queries=n,
            counts=counts.astype(np.int64), pass_seconds=secs,
            slotmap_launches_per_pass=launches,
        )
    return best, edges, chks, last_set


SUB_BATCH = 50  # queries per batched plan of the host-dedup arm (bench.py)


def run_host_dedup(a: CSRArena, frontiers, timed: int = 4, warm: bool = True,
                   sub_batch: int = SUB_BATCH, stats: Optional[dict] = None):
    """The host-dedup 2-hop over ``frontiers`` (dense arena: rows are
    uids): ``warm`` pass first, then the best of ``timed`` passes.
    Returns (best seconds, edges, per-query checksums int32, the last
    query's hop-2 uid set); ``stats`` receives the per-query edge counts,
    each pass's seconds and both hops' capacity tuples."""
    ce = ops.ClassedExpander(a.offsets, a.dst, a.h_offsets)
    n_cls, dev, h_dst = ce.n_cls, a.device, a.host_dst()
    # capacity planning (untimed): the worst per-class composition over
    # the stream, bucket_fine'd, so one plan per hop serves every
    # sub-batch
    c1w = np.ones(n_cls, np.int64)
    c2w = np.ones(n_cls, np.int64)
    h1w = e1w = h2w = e2w = 0
    uniq1 = []
    for f in frontiers:
        c1, h1, e1 = ce.class_counts(f)
        c1w = np.maximum(c1w, c1)
        h1w, e1w = max(h1w, h1), max(e1w, e1)
        f1 = np.unique(np_expand(a.h_offsets, h_dst, f))
        uniq1.append(f1)
        c2, h2, e2 = ce.class_counts(f1)
        c2w = np.maximum(c2w, c2)
        h2w, e2w = max(h2w, h2), max(e2w, e2)
    caps1 = ce.plan_caps(c1w, h1w, e1w)
    caps2 = ce.plan_caps(c2w, h2w, e2w)
    hop1 = ce.program(caps1, "materialize")
    hop2 = ce.program(caps2, "checksum")

    def stack_partitions(queries, caps):
        """Each query's rows class-sorted into stacked [B, cap_c] mats
        (-1 pad): the host side of one batched hop."""
        mats = [np.full((len(queries), c), -1, np.int32) for c in caps[:n_cls]]
        mats.append(np.full((len(queries), max(caps[n_cls], 1)), -1, np.int32))
        for j, f in enumerate(queries):
            rs, starts, _deg, _pos = ce.class_sort(f)
            for k in range(n_cls + 1):
                lo, hi = int(starts[k]), int(starts[k + 1])
                if hi > lo:
                    mats[k][j, : hi - lo] = rs[lo:hi]
        return tuple(torch.from_numpy(m).to(dev) for m in mats)

    n = len(frontiers)
    seed_batches = [stack_partitions(frontiers[b: b + sub_batch], caps1)
                    for b in range(0, n, sub_batch)]

    def one_pass():
        # every hop-1 sub-batch launched up front: the host's dedup and
        # partitioning below overlap the device working through its queue
        futs = [hop1(mb, ()) for mb in seed_batches]
        chks = np.empty(n, np.int32)
        counts = np.empty(n, np.int64)
        for b, (lanes, t1) in enumerate(futs):
            lo = b * sub_batch
            lanes = lanes.cpu().numpy()  # waits for this sub-batch only
            uniq = []
            for row in lanes:
                u = np.unique(row)
                uniq.append(u[:-1] if len(u) and u[-1] == SENT else u)
            c, t2 = hop2(stack_partitions(uniq, caps2), ())
            chks[lo: lo + len(uniq)] = c.cpu().numpy()
            counts[lo: lo + len(uniq)] = (t1.cpu().numpy().astype(np.int64)
                                         + t2.cpu().numpy())
        return counts, chks

    secs = []
    if warm:
        one_pass()
    for _ in range(timed):
        _sync(dev)
        t0 = time.perf_counter()
        counts, chks = one_pass()
        secs.append(time.perf_counter() - t0)
    # untimed correctness artifact: the last query's full hop-2 set
    pm, _pos = ce.partition(uniq1[-1], caps2)
    lanes, _t = ce.program(caps2, "materialize")(
        tuple(torch.from_numpy(m).to(dev) for m in pm), ())
    last_set = np.unique(lanes.cpu().numpy())
    last_set = last_set[last_set != SENT]
    if stats is not None:
        stats.update(counts=counts, pass_seconds=secs, caps1=list(caps1),
                     caps2=list(caps2), sub_batch=sub_batch, queries=n)
    return min(secs), int(counts.sum()), chks, last_set


def _failures(arm: str, edges: int, chks, last_set, cpu_edges, cpu_chks,
              want_last) -> list:
    out = []
    if not np.array_equal(last_set, want_last):
        out.append(f"{arm}: 2-hop != numpy reference (last query's set)")
    if edges != int(cpu_edges.sum()):
        out.append(f"{arm}: edges {edges} != numpy {int(cpu_edges.sum())}")
    if not np.array_equal(chks, cpu_chks):
        out.append(f"{arm}: per-query checksums != numpy")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
    ap.add_argument("--dedup", choices=("device", "host", "both"),
                    default="device",
                    help="which arms run: the device-dedup pipeline, the "
                         "host-dedup classed pipeline, or both")
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    n_nodes = int(os.environ.get("BENCH_NODES", 2_000_000))
    n_edges = int(os.environ.get("BENCH_EDGES", 21_000_000))
    n_seeds = int(os.environ.get("BENCH_SEEDS", 4096))
    iters = int(os.environ.get("BENCH_ITERS", 1000))

    t0 = time.perf_counter()
    a = build_graph(n_nodes, n_edges, dev)
    build_s = time.perf_counter() - t0
    frontiers = draw_frontiers(n_nodes, n_seeds, iters)
    fcap = ops.bucket(max(len(f) for f in frontiers))

    stats: dict = {}
    results = {}  # arm -> (best seconds, edges, checksums, last set)
    if args.dedup in ("device", "both"):
        results["device"] = run_device_dedup(a, frontiers, fcap, CHUNK_Q, stats)
    if args.dedup in ("host", "both"):
        results["host"] = run_host_dedup(a, frontiers)
    cpu_s, cpu_edges, cpu_chks = numpy_baseline(a, frontiers)

    # correctness cross-check: per-query checksums + the last frontier set
    _, want, _ = np_two_hop(a, a.host_dst(), frontiers[-1])
    failures = []
    for arm, (_s, edges, chks, last_set) in results.items():
        failures += _failures(arm, edges, chks, last_set, cpu_edges,
                              cpu_chks, want)
    if failures:
        print("bench2hop: FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1

    cpu_eps = int(cpu_edges.sum()) / cpu_s
    arms = {arm: {"value": edges / secs, "vs_baseline": edges / secs / cpu_eps,
                  "device_s": secs}
            for arm, (secs, edges, _c, _l) in results.items()}
    first = next(iter(results))
    dev_s = results[first][0]
    print(json.dumps({
        "metric": "edges_traversed_per_sec_2hop",
        "value": arms[first]["value"],
        "unit": "edges/s",
        "vs_baseline": arms[first]["vs_baseline"],
        "hop_dedup": first,
        "arms": arms,
        "slotmap_launches": sum(stats.get("slotmap_launches_per_pass", [])),
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "nodes": n_nodes, "edges_stored": a.n_edges, "queries": iters,
        "seeds": n_seeds, "chunk_q": CHUNK_Q, "caps": stats.get("plan"),
        "device_s": dev_s, "numpy_s": cpu_s, "build_s": build_s,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
