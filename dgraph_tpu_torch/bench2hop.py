"""Batched 2-hop pipeline with on-device dedup (the port of ``bench.py``'s
headline arm, ``_run_device_dedup``).

The graph is a dense CSR arena (row i == uid i) in the skey-grouped
inline-head layout on the device.  Per chunk of queries the pipeline runs
hop 1 (``expand_inline_grouped`` over the seed frontiers), an on-device
sort-unique dedup of hop 1's targets, hop 2 over that frontier, and a
per-query checksum of every hop-2 target; the frontier never leaves the
device between hops.  Each hop's overflow slot-map is the slot-map kernel
(``ops/slotmap.py``, ``csrc/slotmap.cu``); on CPU tensors its wrapper runs
the plain version.  A numpy CSR walk of the same queries is the baseline
and the oracle (``np_two_hop``).

    python -m dgraph_tpu_torch.bench2hop                # on cuda
    python -m dgraph_tpu_torch.bench2hop --device cpu   # plain versions

Environment: BENCH_NODES (2,000,000), BENCH_EDGES (21,000,000),
BENCH_SEEDS (4096 drawn seeds per query), BENCH_ITERS (1000 queries).
Prints one JSON line: metric, value (edges/s), unit, vs_baseline,
hop_dedup, slotmap_launches, platform, device.  Exits non-zero when any query's
edge count or checksum, or the last query's set, differs from numpy's.
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

from dgraph_tpu_torch import ops
from dgraph_tpu_torch.device import resolve
from dgraph_tpu_torch.models.arena import CSRArena, csr_dense_from_edges
import dgraph_tpu_torch.ops.slotmap as _slotmap
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


def _wrap_int32(s: torch.Tensor) -> torch.Tensor:
    """int64 sums -> int32 modulo 2^32, signed (jnp.sum(dtype=int32))."""
    s = s & 0xFFFFFFFF
    return torch.where(s >= (1 << 31), s - (1 << 32), s).to(torch.int32)


def checksum(inl2: torch.Tensor, ov2: torch.Tensor, mask: int) -> torch.Tensor:
    """Per-query sum of every produced (decoded) hop-2 uid, int32."""
    si = torch.where(inl2 == SENT, 0, inl2 & mask).sum((1, 2), dtype=torch.int64)
    so = torch.where(ov2 == SENT, 0, ov2 & mask).sum((1, 2), dtype=torch.int64)
    return _wrap_int32(si + so)


def two_hop_batch(metap, ov_chunks, fm: torch.Tensor, plan: Plan):
    """One chunk of queries, fm int32[Q, fcap] (SENT-padded seed uids):
    (checksums int32[Q], edges int32[Q], (inline2, ov2)).  Both hops'
    slot-maps go through the kernel's wrapper; the kernel is exact for
    any row order, so it serves the ungrouped layout too (the TPU kernel
    needs the grouped prefix)."""
    expander = ops.expand_inline_grouped_kernel
    rows0 = ops.frontier_rows(fm)
    inl1, ov1, t1 = expander(metap, ov_chunks, rows0, plan.capo1, plan.pcap1)
    rows1 = next_rows(inl1, ov1, plan)
    inl2, ov2, t2 = expander(metap, ov_chunks, rows1, plan.capo2, plan.pcap2)
    return checksum(inl2, ov2, plan.mask), t1 + t2, (inl2, ov2)


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the kernels' plain versions)")
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
    dev_s, dev_edges, chks, last_set = run_device_dedup(
        a, frontiers, fcap, CHUNK_Q, stats)
    cpu_s, cpu_edges, cpu_chks = numpy_baseline(a, frontiers)

    # correctness cross-check: per-query checksums + the last frontier set
    _, want, _ = np_two_hop(a, a.host_dst(), frontiers[-1])
    failures = []
    if not np.array_equal(last_set, want):
        failures.append("device 2-hop != numpy reference (last query's set)")
    if dev_edges != int(cpu_edges.sum()):
        failures.append(f"edges {dev_edges} != numpy {int(cpu_edges.sum())}")
    if not np.array_equal(chks, cpu_chks):
        failures.append("per-query device checksums != numpy")
    if failures:
        print("bench2hop: FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1

    dev_eps = dev_edges / dev_s
    cpu_eps = dev_edges / cpu_s
    print(json.dumps({
        "metric": "edges_traversed_per_sec_2hop",
        "value": dev_eps,
        "unit": "edges/s",
        "vs_baseline": dev_eps / cpu_eps,
        "hop_dedup": "device",
        "slotmap_launches": sum(stats["slotmap_launches_per_pass"]),
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "nodes": n_nodes, "edges_stored": a.n_edges, "queries": iters,
        "seeds": n_seeds, "chunk_q": CHUNK_Q, "caps": stats["plan"],
        "device_s": dev_s, "numpy_s": cpu_s, "build_s": build_s,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
