#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``dgraph_tpu_torch``) on one
NVIDIA GPU.  Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each fatal (exit code 1, no result line):

1. build — compile every kernel source under ``dgraph_tpu_torch/csrc``
   with nvcc for sm_90a, one process per source, all started together;
   print the card's name and power limit.
2. graph — generate the bench graph (bench.py's generator: 2,000,000
   nodes, 21,000,000 pareto-skewed edges, seed 7), load it through
   ``PostingStore.bulk_set_uid_edges`` on the uid predicate ``e``, and
   boot ``DgraphServer`` on cuda on an ephemeral port.
3. kernels — hold the gather kernel against its plain PyTorch version on
   the card, exactly (integer outputs: tolerance 0), one launch per call,
   over a grid: the main path's frontiers, random frontiers (B up to
   4096), truncation at cap, and the fused kernel's edges
   (``tests/torch_cases.py``): B 1, B ragged, B 2^20, total == cap, cap
   inside a row, tiles starting inside a long row, a 10^6-edge row, runs
   of rows that own no slot longer than a staging window, an all-skip
   frontier.
4. main path — every kernel's launch count is set to 0, then, over HTTP
   on the per-level route (the server's fused chain and fused @recurse
   pinned off, as in phases 7 and 9: these phases measure what earlier
   runs measured; the host-route engine pins them off too):
   a. a materialised 2-hop from 64 seeds, byte-identical to an engine
      over the same store pinned to the host route;
   b. a var-block 2-hop from 8192 seeds with a root ``count()``,
      repeated: its second hop crosses the default device gate and must
      launch the gather kernel; edges/s and p50/p99 latency printed;
   c. a mutation adding edges from seed nodes, merged into the resident
      CSR on the device (epoch flips, no reseed), then a materialised
      2-hop over a fresh 8192-seed frontier holding those seeds,
      byte-identical to the host route with the new edges present.
   The counts are read right after.
5. names — the schema ``name: string @index(term) .`` and a name of 3
   words per node for uids 1..1,000,000, drawn uniformly from a fixed
   16-word vocabulary (seed 23), written into the served store; the
   server's term index is built.  Each word's posting set holds about
   176,000 uids, so a 3-word ``allofterms`` sums to about 528,000, above
   the default k-way gate (262,144).
6. intersect kernels — the intersect kernel against its plain version on
   the card, exactly: the served matrices of the join path (K 3, L 2^21
   for the ``@filter`` AND), bench_ops.py's draws (K 2/4/8 at L 8192;
   B 1/64/1024 × K 2/4/8 at L 1024), K 1 and K 16, an empty row, an
   all-SENT row 0, identical rows, L not a multiple of 256, and the
   tiling's edges (``tests/torch_cases.py``): every lane surviving (each
   tile's prefix exactly at its end), survivors only in the last tile, a
   dense row whose range under one tile is more than the kernel stages in
   shared memory, survivors spread thin over a 2^21-lane row, B 1024
   and B 70,000 batch rows (above a grid's y axis); then
   the served (a) matrix intersected 200 times, every result compared.
7. join path — every kernel's launch count is set to 0, then, over HTTP
   on the server of phase 2, repeated: (a) an ``@filter(has(e) AND
   uid(g))`` over the 2-hop set of 8192 seeds (one k-way call of K 3,
   L 2^21); (b) an ``allofterms`` over 3 words filtered by ``has(e) AND
   uid(f)`` (two k-way calls).  Each body must equal an engine over the
   same store pinned to the host route, each request of (a) must launch
   the intersect kernel at least once and of (b) twice; p50/p99 and the
   ``kway_ms`` of one ``?debug=true`` request are printed.  The counts
   are read right after.
8. ranks — the schema ``rank: int .`` and an int per node for uids
   1..1,000,000, drawn from [0, 2^16) (seed 43: about 15 uids a value),
   written into the served store; the server's value arena is built.
9. query surface — every kernel's launch count is set to 0, then, over
   HTTP on the server of phase 2, each query repeated and its body held
   byte for byte against an engine over the same store pinned to the
   host route: (a) the order-by: a root ``orderasc: rank`` over the
   10^6 ranked uids, a child ``orderdesc: rank, first: 2`` on the 2-hop
   of 8192 seeds (about 346,000 second-level edges) and an order with
   ``offset`` and ``after``; the first two must sort on the card (the
   engine's ``device_order`` count); (b) ``@recurse(depth: 2)`` from the
   8192 seeds, whose second level crosses the default device gate: it
   must launch the gather kernel and stay under the reference's 10^6
   recursion edges; (c) ``shortest`` from a seed to a node two hops away
   with ``numpaths`` 1 and 3, served as the server stands and again with
   the gate at 1, when every expansion must launch the gather; (d)
   ``@groupby`` by ``rank`` and by the uid edge ``e`` with ``count(uid)``,
   at the root (8192 seeds) and under a child (64 seeds).  One line per
   query: p50/p99, the gather's launches, ``device_order_ms`` and the
   engine's routes.  The counts are read right after.
10. multi-hop kernels — ``ops.multi_hop`` (one gather launch a hop) on
   the card against the same call on the CPU, exactly: from the 8192
   seeds of phase 11's (a) over the served resident CSR and its uid->row
   table, with and without the visited set, and from a drained frontier
   (uids that own no row).
11. chain — every kernel's launch count is set to 0, then, over HTTP at
   the default chain threshold, each query served a few times and held
   byte for byte against the host-route engine, from seeds of their own
   (seed 53): (a) the main path's var-block 2-hop count from 8192 seeds,
   which must take the multi-hop pass (2 levels fused, 2 gather
   launches a request); (b) the materialised 2-hop (a staged full-mode
   chain); (c) the child ``orderdesc: rank, first: 2`` 2-hop (a fused
   order); (d) a 2-hop whose second level carries ``@filter(has(rank)
   AND has(name))`` (a fused keep-set whose AND launches the intersect
   kernel); (e) a var-block ``@recurse(depth: 2)`` count (the fused BFS,
   one gather launch a level; from the largest of 8192, 4096, 2048 and
   1024 seeds whose edge bound the fused BFS admits); (f) a var-block
   3-hop count from 1024 seeds.  (a), (b) and (e) are served again with
   the chain and the fused BFS pinned off.  One line per query: p50/p99
   of each route, ``chain_ms``, ``chain_fused_levels`` and
   ``chain_reject`` of one ``?debug=true`` request, each kernel's
   launches a request.  The counts are read right after.
12. dense — the same generated edges as a dense CSR arena on cuda in the
   skey-grouped inline-head layout; 1000 query frontiers of 4096 drawn
   seeds (bench.py's draw, seed 3) and the pipeline's capacity plan.
13. slotmap kernels — the slot-map kernel against its plain version on
   the card, exactly: the pipeline's real (cs, cd) at both hops of one
   200-query chunk, random grouped batches, totals at block boundaries,
   zero-cd rows between productive ones, truncation at capc, an
   all-zero batch, and the tiling's edges (``tests/torch_cases.py``):
   pcap of three shared-memory tiles plus one row, one row owning more
   slots than capc, Q 1, Q 20,000 at pcap 64, totals and capc at tile
   boundaries.
14. batched 2-hop — every kernel's launch count is set to 0, then the
   device-dedup batched 2-hop (``bench2hop.run_device_dedup``) runs the
   1000 queries in chunks of 200 (a warm pass, then best of 4); every
   query's edge count and checksum and the last query's set must equal
   numpy's (``np_two_hop``), and the slot-map kernel must have launched
   twice per chunk in every pass plus twice for the last set.  The counts
   are read right after.  Edges/s, the numpy baseline and the caps are
   printed.
15. report — the device time of one 200-query chunk by stage (hop 1,
   dedup, hop 2, checksum; CUDA events); one pass of the 1000 queries
   under ``torch.profiler``: the card's busy time (the union of its
   kernel and copy intervals) over the pass's host wall time, and device
   ms by kernel name; one pass with CUDA events around each chunk; each
   kernel's wrapper at its path's shapes (the gather at the large
   2-hop's second hop, at a 10^6-edge row among light rows and at a
   frontier of B 2^20; the slot-map at both hops; the intersect at the
   served matrices and bench_ops.py's K 2/4/8 at L 8192) timed three
   ways: CUDA events around each call, events around 30 back-to-back
   calls, and the device time of every device op in the profiler window
   of a call (split by name); beside them the plain version, the bytes
   bound and, for the intersect, the port's ``intersect_many`` tree; the
   order-by at the query surface's two sorted shapes (the two torch ops
   on the card, the engine's device branch and its numpy branch); a
   summary line (the paths' numbers and the run's seconds, in all and by
   phase); then per kernel its launches (from its own paths' runs, split
   by path), error, time, plain-version time and bound (one ``kernels``
   JSON line), the nvidia-smi line, and last the
   ``{"ok": true, "device": ...}`` line.

Exits non-zero without a CUDA GPU, or when the package is not beside it.

``python3 chip_smoke.py --gather-only`` runs phases 1-3 and the gather's
timing line alone.  It goes through wrapper calls only, so an older tree
with this script and ``tests/torch_cases.py`` copied in runs it too: that
is how two trees' gathers are compared in one call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_NODES, N_EDGES, GRAPH_SEED = 2_000_000, 21_000_000, 7
# 8192 seeds: on this graph a 2-hop from 4096 seeds reaches about 210,000
# second-level edges, below the engine's default device gate (262144);
# 8192 seeds about 410,000, so the served query crosses it (the config
# line prints both counts)
SMALL_SEEDS, LARGE_SEEDS, REPEATS = 64, 8192, 20
# the batched 2-hop: bench.py's defaults (BENCH_SEEDS, BENCH_ITERS) and
# its chunk of queries per batched program
BATCH_SEEDS, BATCH_QUERIES, CHUNK_Q = 4096, 1000, 200
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
# the join path: names on uids 1..N_NAMED, NAME_WORDS words each drawn
# from VOCAB; the allofterms query asks for the first NAME_WORDS words
N_NAMED, NAME_WORDS, NAME_SEED, JOIN_SEED = 1_000_000, 3, 23, 29
VOCAB = ["alpha", "bravo", "charlie", "delta", "echo", "foxtrot", "golf",
         "hotel", "india", "juliett", "kilo", "lima", "mike", "november",
         "oscar", "papa"]

# the query surface: ranks on uids 1..N_RANKED drawn from [0, RANK_RANGE)
# (ties); each served query repeated SURFACE_REPEATS times (the @recurse,
# whose body holds some 470,000 nodes, RECURSE_REPEATS times)
N_RANKED, RANK_RANGE, RANK_SEED, SURFACE_SEED = 1_000_000, 1 << 16, 43, 47
SURFACE_REPEATS, RECURSE_REPEATS = 5, 3
RECURSE_MAX_EDGES = 1_000_000  # the reference's recursion cap (query/recurse.py)

# the chain phase: its own seeds; requests a route of each cheap query
# ((a), (e), (f)) and of each query with a body of megabytes ((b)-(d));
# the fewest requests a p99 is reported over; the threshold that pins
# the chain off
CHAIN_SEED, PINNED_OFF = 53, 1 << 62
CHAIN_REPEATS, CHAIN_REPEATS_BULKY, CHAIN_P99_MIN = 24, 3, 20

# kernels: (name, wrapper module, TPU kernel it replaces, paths that run it)
KERNELS = [
    ("gather_packed", "dgraph_tpu_torch.ops.gather",
     "dgraph_tpu/ops/pallas_gather.py:48", ("main_path", "query_surface", "chain")),
    ("slotmap", "dgraph_tpu_torch.ops.slotmap",
     "dgraph_tpu/ops/pallas_slotmap.py:46", ("batched_2hop",)),
    ("intersect", "dgraph_tpu_torch.ops.kway",
     "dgraph_tpu/ops/pallas_intersect.py:35", ("join_path", "chain")),
]


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(obj) -> None:
    print(obj if isinstance(obj, str) else json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(r.returncode == 0, f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def post(addr: str, text: str, params: str = ""):
    """POST /query; returns (status, body bytes, seconds)."""
    req = urllib.request.Request(
        addr + "/query" + params, data=text.encode(), method="POST"
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=900) as r:
        raw = r.read()
        status = r.status
    return status, raw, time.perf_counter() - t0


def strip_latency(raw: bytes) -> str:
    d = json.loads(raw)
    d.pop("server_latency", None)
    d.pop("extensions", None)
    return json.dumps(d)


def uid_list(uids) -> str:
    return ", ".join("0x%x" % int(u) for u in uids)


def two_hop(seeds) -> str:
    return "{ q(func: uid(%s)) { uid e { uid e { uid } } } }" % uid_list(seeds)


def two_hop_count(seeds) -> str:
    # the engine's root count is the bare count()
    return ("{ var(func: uid(%s)) { e { f as e } } q(func: uid(f)) { count() } }"
            % uid_list(seeds))


def host_engine(store):
    """An engine over the same store pinned to the host route, the fused
    chain and the fused @recurse off: the reference the served bodies
    must equal byte for byte."""
    from dgraph_tpu_torch.query import QueryEngine

    eng = QueryEngine(store, device="cpu")
    eng.expand_device_min = 1 << 62
    eng.arenas.kway_device_min = 1 << 62
    eng.chain_threshold = PINNED_OFF
    eng.expander.fused_hop = False
    return eng


@contextlib.contextmanager
def per_level(engine):
    """The served engine with its fused chain and fused @recurse pinned
    off: every level on the per-level route."""
    thr, hop = engine.chain_threshold, engine.expander.fused_hop
    engine.chain_threshold, engine.expander.fused_hop = PINNED_OFF, False
    try:
        yield
    finally:
        engine.chain_threshold, engine.expander.fused_hop = thr, hop


def cuda_ms(fn, iters: int = 30, warm: int = 3) -> float:
    """Median device time of ``fn`` in ms, by CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in evs]))


def kernel_times(fn, iters: int = 30) -> dict:
    """A wrapper call's time three ways, ms: ``ms``, the median of CUDA
    events around each call (for a call of a few µs mostly the host's
    enqueue while the card waits); ``b2b_ms``, events around ``iters``
    back-to-back calls, over ``iters``; ``device_ms``, the device time per
    call of every device op (kernel, memset, copy) in the profiler window
    of the calls (None if it records none), with its split by name, so
    that a design that does its work in several ops and one that does it
    in one are timed alike."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {"ms": cuda_ms(fn, iters)}
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    out["b2b_ms"] = a.elapsed_time(b) / iters
    by_name: dict = {}
    for _attempt in range(2):  # the profiler has returned no device events at times
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by_name[ev.name] = by_name.get(ev.name, 0.0) + (
                    ev.time_range.end - ev.time_range.start) / 1e3 / iters
        if by_name:
            break
    out["device_ms"] = sum(by_name.values()) if by_name else None
    out["device_ms_by_kernel"] = by_name
    return out


# -- phase 1 ----------------------------------------------------------------


def phase_build() -> dict:
    import torch

    from dgraph_tpu_torch.ops import _build

    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    _build.build(sources)
    secs = time.perf_counter() - t0
    ptxas = {
        n: [ln.strip() for ln in log_.splitlines()
            if "registers" in ln or "spill" in ln]
        for n, log_ in _build.build_logs.items()
    }
    smi = nvidia_smi()
    log({"phase": "build", "sources": sources, "seconds": round(secs, 3),
         "ptxas": ptxas, "device": torch.cuda.get_device_name(0),
         "nvidia_smi": smi})
    return {"nvidia_smi": smi}


# -- phase 2 ----------------------------------------------------------------


def phase_graph(device, n_nodes: int, n_edges: int):
    from dgraph_tpu_torch.bench2hop import gen_edges
    from dgraph_tpu_torch.models import PostingStore
    from dgraph_tpu_torch.serve.server import DgraphServer

    t0 = time.perf_counter()
    src, dst = gen_edges(n_nodes, n_edges)
    store = PostingStore()
    store.apply_schema("e: uid .")
    store.bulk_set_uid_edges("e", src, dst)
    t1 = time.perf_counter()
    srv = DgraphServer(store, device=device)
    srv.start()
    arena = srv.engine.arenas.data("e")
    arena.resident()
    t2 = time.perf_counter()
    # second-level fan-out of a 2-hop against the default device gate
    fanout = {
        k: second_hop_rows(arena, np.unique(np.random.default_rng(
            GRAPH_SEED).integers(1, n_nodes + 1, size=k)))[2]
        for k in (4096, LARGE_SEEDS)
    }
    log({"phase": "config", "nodes": n_nodes, "edges_generated": n_edges,
         "second_hop_edges_by_seeds": fanout,
         "edges_stored": arena.n_edges, "source_rows": arena.n_rows,
         "graph_seed": GRAPH_SEED, "predicate": "e",
         "load_s": round(t1 - t0, 3), "arena_build_s": round(t2 - t1, 3),
         "server": srv.addr, "device": str(srv.engine.device),
         "expand_device_min": srv.engine.expand_device_min})
    return store, srv, (src, dst)


# -- phase 3 ----------------------------------------------------------------


def second_hop_rows(arena, seeds):
    """The main path's second-hop gather input for a 2-hop from
    ``seeds``: (rows int32[B], cap, live edges), as the engine forms it."""
    from dgraph_tpu_torch import ops

    out, _ = arena.expand_host(arena.rows_for_uids_host(seeds))
    f1 = np.unique(out)
    rows = arena.rows_for_uids_host(f1)
    total = int(arena.degree_of_rows(rows).sum())
    return ops.pad_rows(rows, ops.bucket(len(f1))), ops.bucket(total), total


def phase_kernels(arena, rng) -> dict:
    """Gather kernel == plain version on the card, exactly, one launch a
    call, over the grid.  Returns the max |kernel - plain|."""
    import torch

    from dgraph_tpu_torch import ops
    from dgraph_tpu_torch.ops import gather

    torch_cases = load_torch_cases()
    dev = arena.device
    ra = arena.resident()
    off, dst = ra.off, ra.dst
    n_rows = arena.n_rows
    cases = []
    seeds = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
    rows1 = arena.rows_for_uids_host(seeds)
    cases.append(("hop1_large_seeds", ops.pad_rows(rows1, ops.bucket(len(rows1))),
                  ops.bucket(int(arena.degree_of_rows(rows1).sum()))))
    rows2, cap2, _ = second_hop_rows(arena, seeds)
    cases.append(("hop2_large_seeds", rows2, cap2))
    for b in (8, 64, 512, 4096):
        r = rng.integers(-1, n_rows, size=b).astype(np.int32)  # unsorted, dups, skips
        tot = int(arena.degree_of_rows(r).sum())
        cases.append((f"random_B{b}", r, ops.bucket(max(1, tot))))
        cases.append((f"random_B{b}_truncated", r, max(8, ops.bucket(max(1, tot)) // 4)))
    cases = [(n, off, dst, torch.from_numpy(np.ascontiguousarray(r, dtype=np.int32)).to(dev), c)
             for n, r, c in cases]
    for name in torch_cases.GATHER_CASES:
        coff, cdst, rows, cap = torch_cases.gather_case(name)
        cases.append((name, *(torch.from_numpy(x).to(dev) for x in (coff, cdst, rows)), cap))
    results = []
    max_err = 0
    for name, coff, cdst, rt, cap in cases:
        want = gather.gather_packed_plain(coff, cdst, rt, cap)
        torch.cuda.synchronize()
        n0 = gather.KERNEL.launches
        got = gather.gather_packed(coff, cdst, rt, cap)
        torch.cuda.synchronize()
        check(gather.KERNEL.launches == n0 + 1, f"gather on {name}: not one launch")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        results.append((name, int(rt.shape[0]), int(cap), err))
        check(torch.equal(got, want), f"gather kernel != plain version on {name}")
    log({"phase": "kernels", "kernel": "gather_packed", "tolerance": 0,
         "cases": [{"case": n, "B": b, "cap": c, "max_abs_err": e}
                   for n, b, c, e in results]})
    return {"gather_packed": max_err}


# -- phase 4 ----------------------------------------------------------------


def phase_main_path(store, srv, rng, card: str) -> dict:
    """The served main path; returns what the report needs.  ``card`` is
    the nvidia-smi name and power limit, logged beside the timings."""
    from dgraph_tpu_torch.ops import gather

    out = {}
    ref = host_engine(store)

    # a. materialised 2-hop, 64 seeds
    seeds = np.unique(rng.integers(1, N_NODES + 1, size=SMALL_SEEDS))
    q = two_hop(seeds)
    status, raw, secs = post(srv.addr, q)
    check(status == 200, f"materialised 2-hop: HTTP {status}")
    want = json.dumps(ref.run(q))
    check(strip_latency(raw) == want,
          "materialised 2-hop body differs from the host route")
    n_nodes = want.count("_uid_")
    log({"phase": "materialised_2hop", "route": "per_level", "seeds": len(seeds),
         "uids_in_body": n_nodes,
         "body_bytes": len(raw), "ms": round(secs * 1e3, 3),
         "byte_identical_to_host_route": True})

    # b. large var-block 2-hop under the default gate, repeated
    check(srv.engine.expand_device_min == 262144,
          "the server must run the default planner gate")
    seeds = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
    q = two_hop_count(seeds)
    n0 = gather.KERNEL.launches
    lat, edges, hops = [], None, None
    for _ in range(REPEATS):
        status, raw, secs = post(srv.addr, q, "?ledger=true")
        check(status == 200, f"large 2-hop: HTTP {status}")
        lat.append(secs)
        led = json.loads(raw)["extensions"]["ledger"]
        edges, hops = led["edges"], led["hops"]
    per_query = (gather.KERNEL.launches - n0) / REPEATS
    check(per_query >= 1, "the large 2-hop did not launch the gather kernel")
    want = json.dumps(ref.run(q))
    check(strip_latency(raw) == want, "large 2-hop count differs from the host route")
    # one more request for its stage breakdown (latency map + engine stats)
    _status, raw, _secs = post(srv.addr, q, "?debug=true")
    log({"phase": "large_2hop_breakdown",
         "server_latency": json.loads(raw)["server_latency"]})
    p50 = float(np.percentile(lat, 50))
    out["large"] = {
        "seeds": len(seeds), "repeats": REPEATS, "edges_per_query": edges,
        "hops": hops, "p50_ms": p50 * 1e3,
        "p99_ms": float(np.percentile(lat, 99)) * 1e3,
        "edges_per_s_at_p50": edges / p50,
        "launches_per_query": per_query,
        "count": json.loads(want)["q"][0]["count"],
        "card": card,
    }
    log(dict(phase="large_2hop", route="per_level", **out["large"]))
    del ref  # its arenas predate the mutation below

    # c. mutation merged on the device, then a fresh materialised 2-hop
    arena = srv.engine.arenas.data("e")
    ra0, epoch0 = arena.resident(), arena.epoch
    fresh = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
    have = arena.rows_for_uids_host(fresh) >= 0
    movers = fresh[have][:8]
    edges_e = store.peek("e").edges
    new_edges = []
    for s in movers.tolist():
        t = int(rng.integers(1, N_NODES + 1))
        while t in edges_e[s]:
            t = int(rng.integers(1, N_NODES + 1))
        new_edges.append((s, t))
    mu = "mutation { set { %s } }" % " ".join(
        "<0x%x> <e> <0x%x> ." % e for e in new_edges)
    status, raw, _ = post(srv.addr, mu)
    check(status == 200 and json.loads(raw).get("code") == "Success",
          f"mutation failed: {raw[:200]!r}")
    q = two_hop(fresh)
    n0 = gather.KERNEL.launches
    status, raw, secs = post(srv.addr, q, "?ledger=true")
    check(status == 200, f"post-mutation 2-hop: HTTP {status}")
    check(gather.KERNEL.launches > n0, "post-mutation 2-hop did not launch the kernel")
    arena = srv.engine.arenas._data["e"]
    check(arena.epoch == epoch0 + 1, "the mutation did not flip the arena epoch")
    check(arena._resident is ra0 and ra0._prev is not None,
          "the mutation reseeded the resident CSR instead of merging it")
    ref = host_engine(store)
    want = json.dumps(ref.run(q))
    got = strip_latency(raw)
    check(got == want, "post-mutation 2-hop body differs from the host route")
    by_uid = {n["_uid_"]: n for n in json.loads(got)["q"]}
    for s, t in new_edges:
        kids = {k["_uid_"] for k in by_uid["0x%x" % s].get("e", [])}
        check("0x%x" % t in kids, f"new edge 0x{s:x} -> 0x{t:x} missing")
    led = json.loads(raw)["extensions"]["ledger"]
    log({"phase": "mutation", "route": "per_level", "new_edges": len(new_edges),
         "epoch": arena.epoch,
         "reseeded": False, "merged_on_device": True, "seeds": len(fresh),
         "edges": led["edges"], "hops": led["hops"], "body_bytes": len(raw),
         "ms": round(secs * 1e3, 3), "byte_identical_to_host_route": True,
         "new_edges_present": True})
    return out


# -- phases 5-7: the join path ------------------------------------------------


def join_filter_query(s1, s2) -> str:
    """(a): an @filter AND over the 2-hop set of ``s1`` — one k-way call
    of K 3 (the candidates, has(e), uid(g))."""
    return ("{ var(func: uid(%s)) { e { f as e } } "
            "var(func: uid(%s)) { e { g as e } } "
            "q(func: uid(f)) @filter(has(e) AND uid(g)) { uid } }"
            % (uid_list(s1), uid_list(s2)))


def allofterms_query(s1) -> str:
    """(b): a 3-word allofterms (one k-way call over the words' posting
    sets) filtered by has(e) AND uid(f) (a second k-way call)."""
    return ("{ var(func: uid(%s)) { e { f as e } } "
            'q(func: allofterms(name, "%s")) @filter(has(e) AND uid(f)) '
            "{ uid name } }" % (uid_list(s1), " ".join(VOCAB[:NAME_WORDS])))


def phase_names(store, srv, n_named: int):
    """Names of NAME_WORDS words from VOCAB on uids 1..n_named, written
    into the served store, and the server's term index built; returns
    the index."""
    from dgraph_tpu_torch.models.store import Edge
    from dgraph_tpu_torch.models.types import TypeID, TypedValue

    t0 = time.perf_counter()
    rng = np.random.default_rng(NAME_SEED)
    words = np.asarray(VOCAB)[rng.integers(0, len(VOCAB), size=(n_named, NAME_WORDS))]
    store.apply_schema("name: string @index(term) .")
    store.apply_many(
        Edge("name", u, value=TypedValue(TypeID.STRING, " ".join(w)))
        for u, w in enumerate(words.tolist(), 1))
    t1 = time.perf_counter()
    idx = srv.engine.arenas.index("name", "term")
    t2 = time.perf_counter()
    postings = {w: int(idx.csr.degree_of_rows(np.array([idx.row_of(w)]))[0])
                for w in VOCAB[:NAME_WORDS]}
    log({"phase": "names", "named_nodes": n_named, "words_per_name": NAME_WORDS,
         "vocabulary": len(VOCAB), "seed": NAME_SEED, "tokens": len(idx.tokens),
         "query_word_postings": postings, "load_s": round(t1 - t0, 3),
         "index_build_s": round(t2 - t1, 3),
         "kway_device_min": srv.engine.arenas.kway_device_min})
    return idx


def two_hop_set(arena, seeds) -> np.ndarray:
    """The uids a 2-hop from ``seeds`` reaches: what ``e { f as e }``
    binds to ``f``."""
    out, _ = arena.expand_host(arena.rows_for_uids_host(seeds))
    out, _ = arena.expand_host(arena.rows_for_uids_host(np.unique(out)))
    return np.unique(out)


def join_matrices(arena, idx, s1, s2) -> dict:
    """The k-way inputs the join path's queries send, stacked as the
    engine stacks them (the sets in argument order, SENT-padded to
    ``bucket`` of the longest): (a)'s filter, (b)'s root allofterms and
    (b)'s filter."""
    from dgraph_tpu_torch import ops

    n = len(arena.h_src)
    has_e = arena.h_src[(arena.h_offsets[1: n + 1] - arena.h_offsets[:n]) > 0]
    f, g = two_hop_set(arena, s1), two_hop_set(arena, s2)
    words = [np.unique(idx.csr.expand_host(np.array([idx.row_of(w)]))[0])
             for w in VOCAB[:NAME_WORDS]]
    cands = words[0]
    for w in words[1:]:
        cands = np.intersect1d(cands, w)
    out = {}
    for name, sets in (("a_filter", [f, has_e, g]), ("b_root", words),
                       ("b_filter", [cands, has_e, f])):
        L = ops.bucket(max(len(x) for x in sets))
        out[name] = np.stack([ops.pad_to(x, L) for x in sets])
    return out


def load_torch_cases():
    """``tests/torch_cases.py``, the kernels' edge-case inputs, loaded by
    path: an installed package may own the name ``tests``."""
    spec = importlib.util.spec_from_file_location(
        "torch_cases", ROOT / "tests" / "torch_cases.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_ops_sets(rng, k: int, L: int, size: int, lo: int, hi: int) -> np.ndarray:
    """k sorted-unique sets of ``size`` draws from [lo, hi), SENT-padded
    to L: bench_ops.py's k-way draws."""
    from dgraph_tpu_torch import ops

    return np.stack([ops.pad_to(np.unique(rng.integers(lo, hi, size=size)), L)
                     for _ in range(k)])


def phase_intersect_kernels(device, served: dict, rng) -> int:
    """Intersect kernel == plain version on the card, exactly, over the
    grid; returns the max |kernel - plain|."""
    import torch

    from dgraph_tpu_torch import ops
    from dgraph_tpu_torch.ops import kway

    torch_cases = load_torch_cases()
    sent = ops.SENT
    cases = [(f"served_{n}", m[None]) for n, m in served.items()]
    for k in (2, 4, 8):  # bench_ops.py:498-507
        cases.append((f"bench_ops_K{k}_L8192",
                      bench_ops_sets(rng, k, 8192, 8192 * 3 // 4, 0, 8192 * 4)[None]))
    for b in (1, 64, 1024):  # bench_ops.py:189-216
        for k in (2, 4, 8):
            cases.append((f"bench_ops_B{b}_K{k}_L1024", np.stack(
                [bench_ops_sets(rng, k, 1024, 768, 1, 1200) for _ in range(b)])))
    cases.append(("K1", bench_ops_sets(rng, 1, 4096, 3000, 0, 8192)[None]))
    cases.append(("K16", bench_ops_sets(rng, 16, 4096, 4000, 0, 4400)[None]))
    m = bench_ops_sets(rng, 4, 8192, 6144, 0, 16384)
    m[2] = sent
    cases.append(("empty_row", m[None]))
    m = bench_ops_sets(rng, 4, 8192, 6144, 0, 16384)
    m[0] = sent
    cases.append(("all_sent_row0", m[None]))
    m = bench_ops_sets(rng, 1, 8192, 6144, 0, 16384)
    cases.append(("identical_rows", np.repeat(m[None], 8, axis=1)))
    for L in (1000, 4097, 65535):
        cases.append((f"L{L}", np.stack(
            [bench_ops_sets(rng, 3, L, L, 0, L + L // 2) for _ in range(3)])))
    cases += [(n, torch_cases.intersect_case(n)) for n in torch_cases.INTERSECT_CASES]
    results, max_err = [], 0
    for name, mat in cases:
        t = torch.from_numpy(np.ascontiguousarray(mat, dtype=np.int32)).to(device)
        got = kway.intersect_batch(t)
        want = kway.intersect_plain(t)
        _sync(t.device)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        results.append((name, list(mat.shape), int((want != sent).sum()), err))
        check(torch.equal(got, want), f"intersect kernel != plain version on {name}")
    # the ordering case: SENT stores of one tile against survivor stores
    # of a later one, the served (a) matrix over and over
    t = torch.from_numpy(served["a_filter"][None]).to(device)
    want = kway.intersect_plain(t)
    differ = 0
    for _ in range(torch_cases.REPEATS):
        differ += not torch.equal(kway.intersect_batch(t), want)
    _sync(t.device)
    check(differ == 0, f"intersect kernel differed on {differ} of "
                       f"{torch_cases.REPEATS} repeats of the served (a) matrix")
    results.append((f"served_a_filter_x{torch_cases.REPEATS}", list(t.shape),
                    int((want != sent).sum()), 0))
    for name, m in served.items():  # the served inputs against numpy too
        fold = m[0][m[0] != sent]
        for row in m[1:]:
            fold = np.intersect1d(fold, row[row != sent])
        got = kway.intersect_kernel(torch.from_numpy(m).to(device)).cpu().numpy()
        check(np.array_equal(got[got != sent], fold), f"served {name} != numpy fold")
    log({"phase": "intersect_kernels", "kernel": "intersect", "tolerance": 0,
         "cases": [{"case": n, "B_K_L": s_, "survivors": v, "max_abs_err": e}
                   for n, s_, v, e in results]})
    return max_err


def phase_join_path(store, srv, s1, s2, card: str) -> dict:
    """The served join path; the caller zeroes the launch counts just
    before.  ``card`` is the nvidia-smi name and power limit."""
    from dgraph_tpu_torch.ops import kway
    from dgraph_tpu_torch.query import joinplan

    check(srv.engine.arenas.kway_device_min == 262144,
          "the server must run the default k-way gate")
    ref = host_engine(store)
    out = {}
    for name, q, need in (("filter_and", join_filter_query(s1, s2), 1),
                          ("allofterms", allofterms_query(s1), 2)):
        n0 = kway.KERNEL.launches
        lat = []
        for _ in range(REPEATS):
            status, raw, secs = post(srv.addr, q)
            check(status == 200, f"{name}: HTTP {status}")
            lat.append(secs)
        per_query = (kway.KERNEL.launches - n0) / REPEATS
        check(per_query >= need,
              f"{name}: {per_query} intersect launches a request, want >= {need}")
        want = json.dumps(ref.run(q))
        check(strip_latency(raw) == want, f"{name} body differs from the host route")
        check(ref.stats["kway_device"] == 0 and ref.stats["kway_host"] >= need,
              f"{name}: the host route engine did not fold on the host")
        found = json.loads(want).get("q", [])
        check(len(found) > 0, f"{name} matched nothing")
        _status, raw, _secs = post(srv.addr, q, "?debug=true")
        lat_map = json.loads(raw)["server_latency"]
        eng = lat_map.pop("engine")
        check(eng["kway_device"] >= need and eng["kway_host"] == 0,
              f"{name}: k-way routes {eng['kway_device']} device, {eng['kway_host']} host")
        out[name] = {
            "seeds": len(s1), "repeats": REPEATS,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "request_ms": [x * 1e3 for x in lat],
            "launches_per_query": per_query, "uids_in_body": len(found),
            "body_bytes": len(want), "kway_ms": eng["kway_ms"],
            "kway_device": eng["kway_device"], "join_routes": eng["join_routes"],
            "engine": {k: eng[k] for k in ("host_expand_ms", "device_expand_ms",
                                           "resolver_expand_ms", "encode_ms",
                                           "routes", "edges")},
            "server_latency": lat_map, "byte_identical_to_host_route": True,
            "card": card,
        }
        log(dict(phase="join_path", route="per_level", query=name, **out[name]))
    log(dict(phase="join_routes", **joinplan.debug_summary()))
    return out


# -- phases 8-9: the query surface --------------------------------------------


def phase_ranks(store, srv, n_ranked: int) -> None:
    """An int ``rank`` on uids 1..n_ranked, written into the served store,
    and the server's value arena built."""
    from dgraph_tpu_torch.models.store import Edge
    from dgraph_tpu_torch.models.types import TypeID, TypedValue

    t0 = time.perf_counter()
    vals = np.random.default_rng(RANK_SEED).integers(0, RANK_RANGE, size=n_ranked)
    store.apply_schema("rank: int .")
    store.apply_many(Edge("rank", u, value=TypedValue(TypeID.INT, v))
                     for u, v in enumerate(vals.tolist(), 1))
    t1 = time.perf_counter()
    va = srv.engine.arenas.values("rank")
    t2 = time.perf_counter()
    log({"phase": "ranks", "ranked_nodes": n_ranked, "range": RANK_RANGE,
         "distinct_values": int(len(np.unique(vals))), "seed": RANK_SEED,
         "value_arena_slots": int(va.src.shape[0]), "device": str(va.src.device),
         "load_s": round(t1 - t0, 3), "value_arena_s": round(t2 - t1, 3)})


def shortest_ends(arena, seeds):
    """(from, to, paths): the first seed with a node two hops away (not
    one) reached through at least three distinct middles, and that node
    (the most reached, then the smallest): numpaths 3 finds its paths
    without leaving the seed's 2-hop ring."""
    for s in seeds.tolist():
        n1, _ = arena.expand_host(arena.rows_for_uids_host(np.array([s])))
        n2, _ = arena.expand_host(arena.rows_for_uids_host(np.unique(n1)))
        far = n2[~np.isin(n2, n1) & (n2 != s)]
        if not len(far):
            continue
        uniq, cnt = np.unique(far, return_counts=True)
        if cnt.max() >= 3:
            return s, int(uniq[np.argmax(cnt)]), int(cnt.max())
    raise SmokeFailure("no seed has a node two hops away by three paths")


def serve_surface(srv, ref, name: str, q: str, repeats: int, card: str) -> dict:
    """Serve ``q`` ``repeats`` times, hold the last body against the host
    route, then read the engine's stats from one ``?debug=true`` request;
    logs and returns the query's line."""
    from dgraph_tpu_torch.ops import gather

    n0 = gather.KERNEL.launches
    lat = []
    for _ in range(repeats):
        status, raw, secs = post(srv.addr, q)
        check(status == 200, f"{name}: HTTP {status}: {raw[:300]!r}")
        lat.append(secs)
    launches = gather.KERNEL.launches - n0
    want = json.dumps(ref.run(q))
    check(strip_latency(raw) == want, f"{name} body differs from the host route")
    _status, raw, _secs = post(srv.addr, q, "?debug=true")
    eng = json.loads(raw)["server_latency"]["engine"]
    row = {"query": name, "repeats": repeats,
           "p50_ms": float(np.percentile(lat, 50)) * 1e3,
           "p99_ms": float(np.percentile(lat, 99)) * 1e3,
           "request_ms": [x * 1e3 for x in lat], "body_bytes": len(want),
           "objects": {k: len(v) for k, v in json.loads(want).items()},
           "gather_launches": launches, "gather_launches_per_query": launches / repeats,
           "device_order": eng["device_order"], "device_order_ms": eng["device_order_ms"],
           "routes": eng["routes"], "edges": eng["edges"],
           "device_expand_ms": eng["device_expand_ms"],
           "host_expand_ms": eng["host_expand_ms"], "encode_ms": eng["encode_ms"],
           "expand_device_min": srv.engine.expand_device_min,
           "byte_identical_to_host_route": True, "card": card}
    log(dict(phase="query_surface", route="per_level", **row))
    return row


def phase_query_surface(store, srv, n_ranked: int, card: str) -> dict:
    """The served @recurse, shortest, @groupby and order-by; the caller
    zeroes the launch counts just before.  ``card`` is the nvidia-smi
    name and power limit."""
    gate = srv.engine.expand_device_min
    check(gate == 262144, "the server must run the default planner gate")
    ref = host_engine(store)
    arena = srv.engine.arenas.data("e")
    rng = np.random.default_rng(SURFACE_SEED)
    large = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
    small = np.unique(rng.integers(1, N_NODES + 1, size=SMALL_SEEDS))
    rows = {}

    def serve(name, q, repeats=SURFACE_REPEATS):
        rows[name] = serve_surface(srv, ref, name, q, repeats, card)
        return rows[name]

    # (a) order-by over the value arena
    for name, q, on_card in (
        ("order_root", "{ q(func: has(rank), orderasc: rank, first: 100) "
                       "{ uid rank } }", True),
        ("order_child_2hop", "{ q(func: uid(%s)) { e { e (orderdesc: rank, "
                             "first: 2) { uid } } } }" % uid_list(large), True),
        ("order_offset_after", "{ q(func: has(rank), orderdesc: rank, offset: "
                               "1000, first: 50, after: 0x%x) { uid rank } }"
                               % (n_ranked // 2), False),
    ):
        row = serve(name, q)
        check(row["objects"]["q"] > 0, f"{name} answered nothing")
        if on_card:
            check(row["device_order"] >= 1, f"{name} did not sort on the card")
    # (b) @recurse: its second level crosses the device gate
    row = serve("recurse_depth2",
                "{ q(func: uid(%s)) @recurse(depth: 2) { uid rank e } }"
                % uid_list(large), RECURSE_REPEATS)
    check(row["gather_launches"] >= RECURSE_REPEATS,
          "the @recurse did not launch the gather kernel")
    check(row["edges"] < RECURSE_MAX_EDGES,
          f"the @recurse walked {row['edges']} edges, the cap is {RECURSE_MAX_EDGES}")
    # (c) shortest, as the server stands and with every expansion on the card
    src, dst, n_paths = shortest_ends(arena, large)
    for k in (1, 3):
        q = ("{ shortest(from: 0x%x, to: 0x%x, numpaths: %d) { e } }" % (src, dst, k))
        serve(f"shortest_k{k}", q)
        srv.engine.expand_device_min = 1
        try:
            row = serve(f"shortest_k{k}_gate1", q)
        finally:
            srv.engine.expand_device_min = gate
        check(row["gather_launches"] > 0,
              f"shortest k {k} at gate 1 did not launch the gather kernel")
        check(row["objects"]["_path_"] == k, f"shortest k {k}: not {k} paths")
    # (d) @groupby at the root and under a child, by value and by uid edge
    for attr in ("rank", "e"):
        serve(f"groupby_root_{attr}", "{ q(func: uid(%s)) @groupby(%s) "
              "{ count(uid) } }" % (uid_list(large), attr))
        serve(f"groupby_child_{attr}", "{ q(func: uid(%s)) { e @groupby(%s) "
              "{ count(uid) } } }" % (uid_list(small), attr))
    return {"rows": rows, "shortest": {"from": src, "to": dst, "two_hop_paths": n_paths},
            "large_seeds": large}


# -- phases 10-11: the fused chain --------------------------------------------


def chain_seeds():
    """The chain phase's seeds, drawn with a seed of their own: 8192 for
    (a)-(d), 1024 for (f), and for (e) the largest of 8192, 4096, 2048 and
    1024 draws whose 2-level edge bound the fused BFS admits (its bound
    sums the top-m degrees of each level, so 8192 seeds can exceed the
    10^6 recursion cap while their real walk does not)."""
    rng = np.random.default_rng(CHAIN_SEED)
    large = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
    small = np.unique(rng.integers(1, N_NODES + 1, size=1024))
    by_size = {k: np.unique(rng.integers(1, N_NODES + 1, size=k))
               for k in (8192, 4096, 2048, 1024)}
    return large, small, by_size


def recurse_seeds(arena, by_size):
    """(seeds, cap) for (e): see ``chain_seeds``."""
    from dgraph_tpu_torch.query.recurse import fused_cap

    for k, seeds in by_size.items():
        cap = fused_cap(arena, len(seeds), 2)
        if cap is not None:
            return seeds, cap
    raise SmokeFailure("the fused BFS admits none of the (e) seed draws")


def phase_multi_hop_kernels(arena, large, rseeds, rcap) -> int:
    """ops.multi_hop on the card == the same call on the CPU (the
    gather's plain version), exactly, one gather launch a hop: from
    (a)'s seeds at the capacity the chain plans for them, from (e)'s with
    the visited set at the fused BFS's capacity, and from a drained
    frontier (uids above every row) both ways.  Returns the max
    |card - CPU|."""
    import torch

    from dgraph_tpu_torch import ops
    from dgraph_tpu_torch.ops import gather
    from dgraph_tpu_torch.query import chain
    from dgraph_tpu_torch.query.recurse import fused_cap

    ra = arena.resident()
    lut = arena.lut()
    est = int(arena.degree_of_rows(arena.rows_for_uids_host(large)).sum())
    drained = np.arange(N_NODES + 1, N_NODES + 1001, dtype=np.int64)
    cases = [("a_frontier", large, chain.scan_cap(arena, len(large), est, 2), False),
             ("e_frontier_bfs", rseeds, rcap, True),
             ("drained", drained, chain.scan_cap(arena, len(drained), 0, 2), False),
             ("drained_bfs", drained, fused_cap(arena, len(drained), 2), True)]
    cpu = [t.cpu() for t in (ra.off, ra.dst, lut)]
    results, max_err = [], 0
    for name, f0, cap, tv in cases:
        f = torch.from_numpy(ops.pad_to(f0, cap))
        vis = f if tv else torch.full((cap,), ops.SENT, dtype=torch.int32)
        want = ops.multi_hop(cpu[0], cpu[1], f, vis, 2, cap, tv, cpu[2])
        torch.cuda.synchronize()
        n0 = gather.KERNEL.launches
        got = ops.multi_hop(ra.off, ra.dst, f.cuda(), vis.cuda(), 2, cap, tv, lut)
        torch.cuda.synchronize()
        check(gather.KERNEL.launches == n0 + 2, f"multi_hop on {name}: not 2 gather launches")
        err = max(int((g.cpu().to(torch.int64) - w.to(torch.int64)).abs().max())
                  for g, w in zip(got, want))
        max_err = max(max_err, err)
        check(all(torch.equal(g.cpu(), w) for g, w in zip(got, want)),
              f"multi_hop on the card != its CPU run on {name}")
        results.append({"case": name, "frontier": len(f0), "cap": cap,
                        "track_visited": tv, "edges_by_hop": want[1].tolist(),
                        "max_abs_err": err})
    check(results[2]["edges_by_hop"] == [0, 0], "the drained frontier walked edges")
    log({"phase": "multi_hop_kernels", "kernel": "gather_packed (ops.multi_hop)",
         "tolerance": 0, "cases": results})
    return max_err


def latency_summary(lat) -> dict:
    """ms figures of a list of request seconds: every request, min, p50,
    max, and p99 only where there are enough requests
    (CHAIN_P99_MIN) for it to be more than the largest one."""
    ms = [x * 1e3 for x in lat]
    out = {"requests": len(ms), "min_ms": min(ms),
           "p50_ms": float(np.percentile(ms, 50)), "max_ms": max(ms)}
    if len(ms) >= CHAIN_P99_MIN:
        out["p99_ms"] = float(np.percentile(ms, 99))
    return {**out, "request_ms": ms}


def serve_routes(srv, name: str, q: str, want: str, hops: list,
                 repeats: int, both: bool) -> dict:
    """Serve ``q`` ``repeats`` times on the fused route and, with
    ``both``, as many times with the chain pinned off, alternating route
    by route request by request so that a drift of the host's speed
    weighs on both alike; each body is held against ``want``.  Then one
    ``?debug=true`` request a route for the engine's stats.  ``hops[0]``
    counts ``ops.multi_hop`` calls.  Returns {route: figures}."""
    from dgraph_tpu_torch.ops import gather, kway

    routes = ["fused", "per_level"] if both else ["fused"]
    lat = {r: [] for r in routes}
    launches = {r: [0, 0, 0] for r in routes}

    def on(route):
        return per_level(srv.engine) if route == "per_level" else contextlib.nullcontext()

    for _ in range(repeats):
        for r in routes:
            n0 = (gather.KERNEL.launches, kway.KERNEL.launches, hops[0])
            with on(r):
                status, raw, secs = post(srv.addr, q)
            n1 = (gather.KERNEL.launches, kway.KERNEL.launches, hops[0])
            check(status == 200, f"{name} ({r}): HTTP {status}: {raw[:300]!r}")
            check(strip_latency(raw) == want, f"{name} ({r}) body differs from the host route")
            lat[r].append(secs)
            launches[r] = [c + y - x for c, x, y in zip(launches[r], n0, n1)]
    out = {}
    for r in routes:
        with on(r):
            _status, raw, _secs = post(srv.addr, q, "?debug=true")
        eng = json.loads(raw)["server_latency"]["engine"]
        per = [c / repeats for c in launches[r]]
        out[r] = {**latency_summary(lat[r]),
                  "gather_launches_per_query": per[0],
                  "intersect_launches_per_query": per[1],
                  "multi_hop_calls_per_query": per[2],
                  **{k: eng[k] for k in (
                      "chain_ms", "chain_fused_levels", "chain_reject",
                      "fused_gathers", "routes", "edges", "kway_device",
                      "device_expand_ms", "host_expand_ms", "encode_ms")}}
    return out


def phase_chain(store, srv, large, small, rseeds, card: str) -> dict:
    """The served fused chain; the caller zeroes the launch counts just
    before.  ``card`` is the nvidia-smi name and power limit."""
    from dgraph_tpu_torch import ops

    eng = srv.engine
    check(eng.chain_threshold == 262144 and eng.expander.fused_hop,
          "the server must run the default chain threshold with fused hops on")
    ref = host_engine(store)
    # (name, query, fused levels, gathers a request, multi-hop calls a
    # request, served per level as well, requests a route)
    many, few = CHAIN_REPEATS, CHAIN_REPEATS_BULKY
    queries = [
        ("a_varblock_2hop_count", two_hop_count(large), 2, 2, 1, True, many),
        ("b_materialised_2hop", two_hop(large), 2, 2, 0, True, few),
        ("c_child_order_2hop", "{ q(func: uid(%s)) { e { e (orderdesc: rank, "
         "first: 2) { uid } } } }" % uid_list(large), 2, 2, 0, False, few),
        ("d_filtered_2hop", "{ q(func: uid(%s)) { uid e { uid e @filter(has(rank) "
         "AND has(name)) { uid } } } }" % uid_list(large), 2, 2, 0, False, few),
        ("e_recurse_varblock_count", "{ var(func: uid(%s)) @recurse(depth: 2) "
         "{ r as e } q(func: uid(r)) { count() } }" % uid_list(rseeds), 0, 2, 1,
         True, many),
        ("f_varblock_3hop_count", "{ var(func: uid(%s)) { e { e { f as e } } } "
         "q(func: uid(f)) { count() } }" % uid_list(small), 3, 3, 1, False, many),
    ]
    hops = [0]
    multi_hop = ops.multi_hop

    def counting(*a, **k):
        hops[0] += 1
        return multi_hop(*a, **k)

    rows = {}
    ops.multi_hop = counting
    try:
        for name, q, levels, gathers, scans, both, repeats in queries:
            want = json.dumps(ref.run(q))
            body = json.loads(want)
            row = {"query": name, "seeds": q.count("0x"), "body_bytes": len(want),
                   "objects": {k: len(v) for k, v in body.items()}, "card": card}
            row.update(serve_routes(srv, name, q, want, hops, repeats, both))
            f = row["fused"]
            check(f["chain_fused_levels"] == levels,
                  f"{name}: {f['chain_fused_levels']} fused levels, want {levels} "
                  f"(rejects: {f['chain_reject']})")
            check(f["gather_launches_per_query"] == gathers,
                  f"{name}: {f['gather_launches_per_query']} gather launches a "
                  f"request, want {gathers}")
            check(f["fused_gathers"] == gathers and "resident" not in f["routes"],
                  f"{name}: not every gather ran fused ({f['routes']})")
            check(f["multi_hop_calls_per_query"] == scans,
                  f"{name}: {f['multi_hop_calls_per_query']} multi-hop calls a "
                  f"request, want {scans}")
            if name.startswith("d_"):
                check(f["intersect_launches_per_query"] >= 1 and f["kway_device"] >= 1,
                      f"{name}: the fused keep-set did not launch the intersect kernel")
            if both:
                p = row["per_level"]
                check(p["chain_fused_levels"] == 0 and p["fused_gathers"] == 0
                      and p["multi_hop_calls_per_query"] == 0,
                      f"{name}: the pinned-off route still fused")
            first = (body.get("q") or [{}])[0]
            if "count" in first:
                row["count"] = first["count"]
            rows[name] = row
            log(dict(phase="chain", **row))
    finally:
        ops.multi_hop = multi_hop
    return rows


# -- phases 12-14: the batched 2-hop -----------------------------------------


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def phase_dense(device, src, dst, n_nodes: int, n_queries: int = BATCH_QUERIES):
    """The graph phase's edges as a dense arena in the grouped inline
    layout on ``device``, the query frontiers and the pipeline's plan."""
    from dgraph_tpu_torch import bench2hop, ops
    from dgraph_tpu_torch.models.arena import csr_dense_from_edges

    t0 = time.perf_counter()
    a = csr_dense_from_edges(src, dst, n_nodes, device)
    t1 = time.perf_counter()
    metap, ov = a.inline_layout_grouped()
    _sync(a.device)
    t2 = time.perf_counter()
    frontiers = bench2hop.draw_frontiers(n_nodes, BATCH_SEEDS, n_queries)
    fcap = ops.bucket(max(len(f) for f in frontiers))
    plan = bench2hop.plan_caps(a, frontiers, fcap, grouped=True)
    t3 = time.perf_counter()
    sizes = [len(f) for f in frontiers]
    log({"phase": "dense", "rows": a.n_rows, "edges_stored": a.n_edges,
         "metap": list(metap.shape), "ov_chunks": list(ov.shape),
         "device_bytes": a.device_bytes(), "queries": n_queries,
         "seeds_drawn": BATCH_SEEDS, "frontier_min": min(sizes),
         "frontier_max": max(sizes), "plan": dataclasses.asdict(plan),
         "arena_s": round(t1 - t0, 3), "layout_s": round(t2 - t1, 3),
         "plan_s": round(t3 - t2, 3)})
    return a, frontiers, fcap, plan


def chunk_tensor(a, frontiers, plan):
    """The pipeline's first chunk of group-ordered seed frontiers,
    int32[CHUNK_Q, fcap] on the arena's device."""
    import torch

    from dgraph_tpu_torch import bench2hop, ops

    g = bench2hop.group_order(a, frontiers[:CHUNK_Q])
    return torch.from_numpy(np.stack([ops.pad_to(f, plan.fcap) for f in g])).to(a.device)


def slotmap_real_inputs(a, frontiers, plan):
    """(name, cs, cd, capc) at both hops of the pipeline's first chunk;
    hop 1's output is formed by the torch chain, not the kernel."""
    from dgraph_tpu_torch import bench2hop, ops
    from dgraph_tpu_torch.ops.sets import ov_slotmap_inputs

    metap, ov = a.inline_layout_grouped()
    rows0 = ops.frontier_rows(chunk_tensor(a, frontiers, plan))
    cs1, cd1 = ov_slotmap_inputs(metap, rows0, plan.pcap1)
    inl1, ov1, _t = ops.expand_inline_grouped(metap, ov, rows0, plan.capo1, plan.pcap1)
    rows1 = bench2hop.next_rows(inl1, ov1, plan)
    cs2, cd2 = ov_slotmap_inputs(metap, rows1, plan.pcap2)
    return [("hop1_chunk", cs1.contiguous(), cd1.contiguous(), plan.capo1),
            ("hop2_chunk", cs2.contiguous(), cd2.contiguous(), plan.capo2)]


def total_case(rng, total: int, pcap: int = 1024):
    """One query whose chunk counts sum to exactly ``total``."""
    d = rng.integers(1, 5, size=total)
    c = np.cumsum(d)
    k = int(np.searchsorted(c, total))
    d = d[: k + 1]
    d[-1] -= int(c[k]) - total
    cs = np.zeros((1, pcap), np.int32)
    cd = np.zeros((1, pcap), np.int32)
    cs[0, : len(d)] = np.cumsum(rng.integers(0, 2, size=len(d))) + np.cumsum(d) - d
    cd[0, : len(d)] = d
    return cs, cd


def phase_slotmap_kernels(a, frontiers, plan, rng) -> int:
    """Slot-map kernel == plain version on the card, exactly, over the
    grid; returns the max |kernel - plain|."""
    import torch

    from dgraph_tpu_torch.ops import slotmap

    torch_cases = load_torch_cases()
    dev = a.device
    cases = slotmap_real_inputs(a, frontiers, plan)
    _n, cs2, cd2, capc2 = cases[1]
    cases.append(("hop2_chunk_truncated", cs2, cd2, max(8, capc2 // 4)))
    host = []
    for q, pcap, capc in ((CHUNK_Q, 16384, 16384), (CHUNK_Q, 3072, 3328), (7, 1000, 2900)):
        host.append((f"random_grouped_Q{q}_P{pcap}_C{capc}",
                     *torch_cases.grouped(rng, q, pcap), capc))
    for t in (127, 128, 129, 255, 256, 257, 383, 1023, 1024, 1025):
        host.append((f"total_{t}", *total_case(rng, t), 2048))
    cs, cd = torch_cases.grouped(rng, 64, 4096)
    cd[rng.random(cd.shape) < 0.2] = 0  # zero-cd rows between productive ones
    host.append(("zero_cd_between", cs, cd, 8192))
    cs, cd = torch_cases.grouped(rng, 16, 4096, fill=1.0)
    host.append(("random_truncated", cs, cd, 512))
    host.append(("all_zero", np.zeros((CHUNK_Q, 16384), np.int32),
                 np.zeros((CHUNK_Q, 16384), np.int32), 16384))
    host.append(("single_row_prefix", np.array([[5]], np.int32),
                 np.array([[3]], np.int32), 8))
    host += [(n, *torch_cases.slotmap_case(n)) for n in torch_cases.SLOTMAP_CASES]
    for name, cs, cd, capc in host:
        cases.append((name, torch.from_numpy(cs).to(dev),
                      torch.from_numpy(cd).to(dev), capc))
    results, max_err = [], 0
    for name, cs, cd, capc in cases:
        got = slotmap.slotmap(cs, cd, capc)
        want = slotmap.slotmap_plain(cs, cd, capc)
        _sync(dev)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        total = int(cd.to(torch.int64).sum(1).max())
        results.append((name, tuple(cs.shape), int(capc), total, err))
        check(torch.equal(got, want), f"slotmap kernel != plain version on {name}")
    log({"phase": "slotmap_kernels", "kernel": "slotmap", "tolerance": 0,
         "cases": [{"case": n, "Q_pcap": list(s_), "capc": c, "max_total": t,
                    "max_abs_err": e} for n, s_, c, t, e in results]})
    return max_err


def phase_batched_2hop(a, frontiers, fcap, plan, card: str) -> dict:
    """The batched 2-hop over every query, held against numpy query by
    query; the caller zeroes the launch counts just before."""
    from dgraph_tpu_torch import bench2hop
    from dgraph_tpu_torch.ops import slotmap

    stats: dict = {}
    t0 = time.perf_counter()
    dev_s, edges, chks, last_set = bench2hop.run_device_dedup(
        a, frontiers, fcap, CHUNK_Q, stats, plan=plan)
    run_s = time.perf_counter() - t0
    launches = slotmap.KERNEL.launches
    t1 = time.perf_counter()
    cpu_s, cpu_edges, cpu_chks = bench2hop.numpy_baseline(a, frontiers, reps=1)
    numpy_s = time.perf_counter() - t1
    _n, want_last, _c = bench2hop.np_two_hop(a, a.host_dst(), frontiers[-1])
    bad = np.nonzero(stats["counts"] != cpu_edges)[0]
    check(not len(bad), f"edge counts differ from numpy at queries {bad[:10].tolist()}")
    bad = np.nonzero(chks != cpu_chks)[0]
    check(not len(bad), f"checksums differ from numpy at queries {bad[:10].tolist()}")
    check(np.array_equal(last_set, want_last), "last query's set differs from numpy")
    check(edges == int(cpu_edges.sum()), "total edges differ from numpy")
    n_chunks = -(-len(frontiers) // CHUNK_Q)
    per_pass = stats["slotmap_launches_per_pass"]
    check(per_pass == [2 * n_chunks] * len(per_pass),
          f"slot-map launches per pass {per_pass}, want {2 * n_chunks} each")
    check(launches == sum(per_pass) + 2,
          f"slot-map launches {launches}, want {sum(per_pass) + 2}")
    out = {
        "queries": len(frontiers), "seeds_drawn": BATCH_SEEDS,
        "chunk_q": CHUNK_Q, "caps": stats["plan"], "edges": edges,
        "edges_per_query_mean": edges / len(frontiers),
        "best_pass_s": dev_s, "pass_seconds": stats["pass_seconds"],
        "edges_per_s": edges / dev_s, "numpy_best_s": cpu_s,
        "numpy_edges_per_s": edges / cpu_s, "vs_baseline": cpu_s / dev_s,
        "slotmap_launches_per_pass": per_pass, "slotmap_launches": launches,
        "checksums_equal_numpy": True, "last_set_equal_numpy": True,
        "run_s": run_s, "numpy_run_s": numpy_s, "card": card,
    }
    log(dict(phase="batched_2hop", **out))
    return out


def batched_breakdown(a, frontiers, plan) -> dict:
    """Device time of one chunk of the pipeline by stage (CUDA events,
    median of 10 after a warm run): hop 1, dedup, hop 2, checksum."""
    import torch

    from dgraph_tpu_torch import bench2hop, ops

    metap, ov = a.inline_layout_grouped()
    fm = chunk_tensor(a, frontiers, plan)
    ex = ops.expand_inline_grouped_kernel

    def stages():
        evs = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        evs[0].record()
        rows0 = ops.frontier_rows(fm)
        inl1, ov1, t1 = ex(metap, ov, rows0, plan.capo1, plan.pcap1)
        evs[1].record()
        rows1 = bench2hop.next_rows(inl1, ov1, plan)
        evs[2].record()
        inl2, ov2, t2 = ex(metap, ov, rows1, plan.capo2, plan.pcap2)
        evs[3].record()
        bench2hop.checksum(inl2, ov2, plan.mask)
        evs[4].record()
        return evs

    stages()
    runs = [stages() for _ in range(10)]
    torch.cuda.synchronize()
    names = ["hop1_ms", "dedup_ms", "hop2_ms", "checksum_ms"]
    out = {n: float(np.median([r[k].elapsed_time(r[k + 1]) for r in runs]))
           for k, n in enumerate(names)}
    out["chunk_ms"] = float(np.median([r[0].elapsed_time(r[4]) for r in runs]))
    # hop 2's least traffic: rows in, one 8-lane metap row per row, the
    # inline lanes out, each overflow chunk gathered and written once,
    # the slot-map's inputs and map
    q, u, c, p = fm.shape[0], plan.ucap, plan.capo2, plan.pcap2
    out["hop2_bytes"] = 4 * q * (u + 8 * u + ops.INLINE * u + 16 * c + 2 * p + c)
    out["hop2_bound_ms"] = out["hop2_bytes"] / HBM_BYTES_PER_S * 1e3
    return out


def slotmap_timing(a, frontiers, plan) -> dict:
    """The slot-map at both hops' shapes of a chunk (hop 2's is the main
    path's largest): the wrapper's times (``kernel_times``), the plain
    version's, and the bytes bound, keyed by hop."""
    from dgraph_tpu_torch.ops import slotmap

    out = {}
    for name, cs, cd, capc in slotmap_real_inputs(a, frontiers, plan):
        q, pcap = cs.shape
        # the function reads cs and cd once and writes the map once
        nbytes = 4 * q * (2 * pcap + capc)
        times = kernel_times(
            lambda cs=cs, cd=cd, capc=capc: slotmap.slotmap(cs, cd, capc))
        plain_ms = cuda_ms(
            lambda cs=cs, cd=cd, capc=capc: slotmap.slotmap_plain(cs, cd, capc))
        out[name] = {"Q": q, "pcap": pcap, "capc": capc,
                     "max_total": int(cd.sum(1).max()), "bytes": nbytes,
                     **times, "plain_ms": plain_ms,
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
    return out


def _union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def pass_profile(a, frontiers, fcap, plan) -> dict:
    """The card's busy share of one pass of the batched 2-hop: a pass
    under ``torch.profiler`` (device intervals of every kernel, copy and
    fill; their union over the pass's host wall time, and device ms by
    kernel name), then a pass with CUDA events around each chunk (the sum
    of the chunks' device spans over that pass's host wall time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dgraph_tpu_torch import bench2hop

    metap, ov, plan, fmat = bench2hop.prepare(a, frontiers, fcap, plan)
    bench2hop.run_pass(metap, ov, fmat, plan, CHUNK_Q)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bench2hop.run_pass(metap, ov, fmat, plan, CHUNK_Q)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        s, e = ev.time_range.start, ev.time_range.end
        spans.append((s, e))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + (e - s) / 1e3
    out = {"profiled_pass_s": wall_s, "device_events": len(spans)}
    if spans:
        busy_ms = _union_us(spans) / 1e3
        slot_ms = sum(v for k, v in by_name.items() if "slotmap" in k)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        out.update(device_busy_ms=busy_ms,
                   busy_share_of_pass=busy_ms / (wall_s * 1e3),
                   device_window_ms=(max(e for _s, e in spans)
                                     - min(s for s, _e in spans)) / 1e3,
                   slotmap_kernels_ms=slot_ms,
                   slotmap_share_of_busy=slot_ms / busy_ms,
                   top_kernels_ms=[[k, v] for k, v in top])
    else:  # the profiler saw no device activity: leave the share unmeasured
        out.update(device_busy_ms=None, busy_share_of_pass=None)

    n = fmat.shape[0]
    evs = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in range(0, n, CHUNK_Q):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        bench2hop.two_hop_batch(metap, ov, fmat[b: b + CHUNK_Q], plan)
        e1.record()
        evs.append((e0, e1))
    torch.cuda.synchronize()
    ev_wall_s = time.perf_counter() - t0
    chunk_ms = [e0.elapsed_time(e1) for e0, e1 in evs]
    out.update(event_pass_s=ev_wall_s, chunk_event_ms=chunk_ms,
               chunk_share_of_pass=sum(chunk_ms) / (ev_wall_s * 1e3))
    return out


# -- phase 11 ---------------------------------------------------------------


def intersect_timing(device, served, rng) -> dict:
    """The intersect kernel at the served shapes (the matrices of the join
    path: (a)'s filter, the kernels line's shape; (b)'s root and filter)
    and at bench_ops.py's (K 2/4/8, L 8192): the wrapper's times
    (``kernel_times``: the memset of the tile status words and the
    kernel), the plain version's and the port's
    ``intersect_many`` tree's, and the bytes bound."""
    import torch

    from dgraph_tpu_torch import ops
    from dgraph_tpu_torch.ops import kway

    shapes = [(f"served_{n}", m) for n, m in served.items()]
    for k in (2, 4, 8):
        shapes.append((f"bench_ops_K{k}_L8192",
                       bench_ops_sets(rng, k, 8192, 8192 * 3 // 4, 0, 8192 * 4)))
    out = {}
    for name, m in shapes:
        k, L = m.shape
        t2 = torch.from_numpy(m).to(device)
        t3 = t2[None]
        # the function reads each row's valid entries once (the SENT tail
        # need not be read) and writes the L output lanes once
        row_sizes = [int(v) for v in (m != ops.SENT).sum(1)]
        nbytes = 4 * (sum(row_sizes) + L)
        out[name] = {
            "K": k, "L": L, "row_sizes": row_sizes, "bytes": nbytes,
            **kernel_times(lambda t3=t3: kway.intersect_batch(t3)),
            "plain_ms": cuda_ms(lambda t3=t3: kway.intersect_plain(t3)),
            "intersect_many_ms": cuda_ms(lambda t2=t2: ops.intersect_many(t2)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        }
    return out


def order_timing(engine, seeds) -> dict:
    """The order-by at the served shapes — the root's 10^6 ranked uids in
    one segment (ascending), and the 2-hop of ``seeds`` by level-1 node
    (descending) — three ways: ``ops_ms``, CUDA events around the two
    torch ops on tensors already on the card (median of 30);
    ``device_branch_ms``, the engine's device branch on the host clock
    (padding, uploads, the two ops, the fetch of the permutation);
    ``host_branch_ms``, its numpy branch over the rank mirror (the route
    below the gate).  Medians of 5 for the last two."""
    import torch

    from dgraph_tpu_torch import ops

    va = engine.arenas.values("rank")
    arena = engine.arenas.data("e")
    n1, _ = arena.expand_host(arena.rows_for_uids_host(seeds))
    f1 = np.unique(n1)
    out2, seg_ptr = arena.expand_host(arena.rows_for_uids_host(f1))
    shapes = [("root_asc", va.h_src, np.zeros(va.n, np.int64), False),
              ("child_2hop_desc", out2, np.repeat(np.arange(len(f1)), np.diff(seg_ptr)), True)]
    gate = engine.expand_device_min
    out = {}
    for name, uids, owner, desc in shapes:
        n = len(uids)
        cap = ops.bucket(n)
        seg = np.full(cap, -1, np.int32)
        seg[:n] = owner
        u_d = torch.from_numpy(ops.pad_to(uids, cap)).to(va.src.device)
        s_d = torch.from_numpy(seg).to(va.src.device)
        ops_ms = cuda_ms(lambda u_d=u_d, s_d=s_d, desc=desc: ops.segmented_sort_perm(
            s_d, ops.gather_ranks(va.src, va.ranks, u_d), desc))
        branch = {}
        for route, g in (("device_branch_ms", 1), ("host_branch_ms", n + 1)):
            engine.expand_device_min = g
            try:
                secs = []
                for _ in range(5):
                    t0 = time.perf_counter()
                    engine._device_order_perm(uids, owner, "rank", desc)
                    secs.append(time.perf_counter() - t0)
            finally:
                engine.expand_device_min = gate
            branch[route] = float(np.median(secs)) * 1e3
        out[name] = {"n": n, "segments": int(owner[-1]) + 1 if n else 0,
                     "cap": cap, "ops_ms": ops_ms, **branch}
    return out


def gather_timing(arena, rng) -> dict:
    """The gather through wrapper calls only (so that it times an older
    tree's wrapper too), keyed by shape: the main path's largest (the
    large 2-hop's second hop), a 10^6-edge row among light rows, and a
    frontier of B 2^20 arena rows (sorted, distinct).  Per shape the
    wrapper's times (``kernel_times``: device time of every device op of
    a call), the plain version's, and the bytes bound."""
    import torch

    from dgraph_tpu_torch import ops
    from dgraph_tpu_torch.ops import gather

    dev = arena.device
    ra = arena.resident()
    seeds = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
    rows, cap, _ = second_hop_rows(arena, seeds)
    shapes = [("hop2_large_seeds", ra.off, ra.dst, rows, cap)]
    hoff, hdst, hrows, hcap = load_torch_cases().gather_case("heavy_row")
    shapes.append(("heavy_row", torch.from_numpy(hoff).to(dev),
                   torch.from_numpy(hdst).to(dev), hrows, hcap))
    rows = np.sort(rng.choice(arena.n_rows, size=1 << 20, replace=False)).astype(np.int32)
    shapes.append(("b_2_20", ra.off, ra.dst, rows,
                   ops.bucket(int(arena.degree_of_rows(rows).sum()))))
    out = {}
    for name, off, dst, rows, cap in shapes:
        rt = torch.from_numpy(rows).to(dev)
        live = rows[rows >= 0]
        deg = (off[torch.from_numpy(live + 1).to(dev).long()]
               - off[torch.from_numpy(live).to(dev).long()])
        total = int(deg.sum())
        # bytes the function must move: the frontier, two offsets per live
        # row, each placed target once, and the packed output once
        nbytes = 4 * len(rows) + 8 * len(live) + 4 * min(total, cap) + 8 * cap
        out[name] = {
            "B": len(rows), "live_rows": len(live), "total": total, "cap": cap,
            "bytes": nbytes,
            **kernel_times(lambda off=off, dst=dst, rt=rt, cap=cap:
                           gather.gather_packed(off, dst, rt, cap)),
            "plain_ms": cuda_ms(lambda off=off, dst=dst, rt=rt, cap=cap:
                                gather.gather_packed_plain(off, dst, rt, cap)),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        }
    return out


def main(argv) -> int:
    gather_only = "--gather-only" in argv
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU visible; this smoke test needs one",
              file=sys.stderr)
        return 2
    if not (ROOT / "dgraph_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout: dgraph_tpu_torch/ is not "
              "beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    srv = None
    phase = "build"
    phase_s: dict = {}  # seconds each phase took, up to the report's end
    t_phase = [time.perf_counter()]

    def mark(name: str) -> str:
        phase_s[phase] = time.perf_counter() - t_phase[0]
        t_phase[0] = time.perf_counter()
        return name

    try:
        t_start = time.perf_counter()
        info = phase_build()
        phase = mark("graph")
        store, srv, (src, dst) = phase_graph("cuda", N_NODES, N_EDGES)
        arena = srv.engine.arenas.data("e")
        phase = mark("kernels")
        errs = phase_kernels(arena, np.random.default_rng(11))
        if gather_only:
            phase = mark("gather_timing")
            log(dict(phase="gather_timing", card=info["nvidia_smi"],
                     **gather_timing(arena, np.random.default_rng(13))))
            return 0
        wrappers = {n: importlib.import_module(m) for n, m, _r, _p in KERNELS}
        launches = {}

        def zero_counts():
            for w in wrappers.values():
                w.KERNEL.launches = 0

        def read_counts(path):
            counts = {n: w.KERNEL.launches for n, w in wrappers.items()}
            for n, _m, _r, paths in KERNELS:
                if path in paths:
                    check(counts[n] > 0, f"kernel {n} was not launched on {path}")
                    launches.setdefault(n, {})[path] = counts[n]

        phase = mark("main_path")
        zero_counts()
        with per_level(srv.engine):
            main = phase_main_path(store, srv, np.random.default_rng(GRAPH_SEED),
                                   info["nvidia_smi"])
        read_counts("main_path")
        phase = mark("names")
        idx = phase_names(store, srv, N_NAMED)
        jrng = np.random.default_rng(JOIN_SEED)
        s1, s2 = (np.unique(jrng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
                  for _ in range(2))
        phase = mark("intersect_kernels")
        served = join_matrices(srv.engine.arenas.data("e"), idx, s1, s2)
        errs["intersect"] = phase_intersect_kernels(
            srv.engine.device, served, np.random.default_rng(31))
        phase = mark("join_path")
        zero_counts()
        with per_level(srv.engine):
            join = phase_join_path(store, srv, s1, s2, info["nvidia_smi"])
        read_counts("join_path")
        phase = mark("ranks")
        phase_ranks(store, srv, N_RANKED)
        phase = mark("query_surface")
        zero_counts()
        with per_level(srv.engine):
            surface = phase_query_surface(store, srv, N_RANKED, info["nvidia_smi"])
        read_counts("query_surface")
        phase = mark("multi_hop_kernels")
        arena = srv.engine.arenas.data("e")
        large_c, small_c, by_size = chain_seeds()
        rseeds, rcap = recurse_seeds(arena, by_size)
        errs["gather_packed"] = max(errs["gather_packed"], phase_multi_hop_kernels(
            arena, large_c, rseeds, rcap))
        phase = mark("chain")
        zero_counts()
        chain_rows = phase_chain(store, srv, large_c, small_c, rseeds, info["nvidia_smi"])
        read_counts("chain")
        phase = mark("dense")
        dense, frontiers, fcap, plan = phase_dense("cuda", src, dst, N_NODES)
        del src, dst
        phase = mark("slotmap_kernels")
        errs["slotmap"] = phase_slotmap_kernels(dense, frontiers, plan,
                                                np.random.default_rng(17))
        phase = mark("batched_2hop")
        zero_counts()
        batched = phase_batched_2hop(dense, frontiers, fcap, plan, info["nvidia_smi"])
        read_counts("batched_2hop")
        phase = mark("gather_timing")
        t = gather_timing(srv.engine.arenas.data("e"), np.random.default_rng(13))
        log(dict(phase="gather_timing", **t))
        phase = mark("slotmap_timing")
        st = slotmap_timing(dense, frontiers, plan)
        log(dict(phase="slotmap_timing", **st))
        phase = mark("batched_breakdown")
        bd = batched_breakdown(dense, frontiers, plan)
        bd["slotmap_share_of_chunk"] = (st["hop1_chunk"]["ms"]
                                        + st["hop2_chunk"]["ms"]) / bd["chunk_ms"]
        log(dict(phase="batched_breakdown", chunk_q=CHUNK_Q, **bd))
        phase = mark("pass_profile")
        log(dict(phase="pass_profile", chunk_q=CHUNK_Q,
                 **pass_profile(dense, frontiers, fcap, plan)))
        phase = mark("intersect_timing")
        it = intersect_timing(srv.engine.device, served, np.random.default_rng(37))
        log(dict(phase="intersect_timing", **it))
        phase = mark("order_timing")
        log(dict(phase="order_timing", card=info["nvidia_smi"],
                 **order_timing(srv.engine, surface["large_seeds"])))
        # the wrapper's device time for the k-way calls of one request
        kms = {"filter_and": it["served_a_filter"]["ms"],
               "allofterms": it["served_b_root"]["ms"] + it["served_b_filter"]["ms"]}
        log({"phase": "intersect_share", **{
            n: {"kernel_ms": kms[n], "kway_ms": j["kway_ms"], "p50_ms": j["p50_ms"],
                "kernel_share_of_p50": kms[n] / j["p50_ms"],
                "kway_share_of_p50": j["kway_ms"] / j["p50_ms"]}
            for n, j in join.items()}})
        timing = {"gather_packed": t["hop2_large_seeds"], "slotmap": st["hop2_chunk"],
                  "intersect": it["served_a_filter"]}
        kernels = [{
            "name": n,
            "ok": True,
            "route": "cuda",
            "source": f"dgraph_tpu_torch/csrc/{wrappers[n].KERNEL.source}.cu",
            "replaces": r,
            "paths": list(paths),
            "launches": sum(launches[n].values()),
            "launches_by_path": launches[n],
            "max_abs_err": errs[n],
            "ms": timing[n]["ms"],
            "b2b_ms": timing[n]["b2b_ms"],
            "device_ms": timing[n]["device_ms"],
            "plain_ms": timing[n]["plain_ms"],
            "bound_ms": timing[n]["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        } for n, _m, r, paths in KERNELS]
        mark("done")
        log({"seconds": round(time.perf_counter() - t_start, 3), "phase_seconds": phase_s,
             "large_2hop": main["large"],
             "join_path": {n: {k: j[k] for k in ("p50_ms", "p99_ms", "kway_ms",
                                                 "launches_per_query")}
                           for n, j in join.items()},
             "query_surface": {n: {k: r[k] for k in (
                 "p50_ms", "p99_ms", "gather_launches_per_query", "device_order",
                 "device_order_ms")} for n, r in surface["rows"].items()},
             "chain": {n: {route: {k: r[route][k] for k in (
                 "requests", "min_ms", "p50_ms", "p99_ms", "max_ms",
                 "gather_launches_per_query", "intersect_launches_per_query",
                 "chain_fused_levels", "chain_ms") if k in r[route]}
                 for route in ("fused", "per_level") if route in r}
                 for n, r in chain_rows.items()},
             "batched_2hop": {k: batched[k] for k in (
                 "queries", "edges", "edges_per_s", "numpy_edges_per_s",
                 "vs_baseline", "chunk_q", "caps")}})
        log({"kernels": kernels})
        log(info["nvidia_smi"])
        log({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
        return 0
    except Exception:  # noqa: BLE001 — any phase's failure fails the run
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED in phase {phase}", file=sys.stderr)
        return 1
    finally:
        if srv is not None:
            srv.stop()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
