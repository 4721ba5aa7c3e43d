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
3. kernels — hold every kernel against its plain PyTorch version on the
   card, exactly (integer outputs: tolerance 0), over a grid: the main
   path's frontiers, random frontiers (B up to 4096), a 10^6-edge row,
   truncation at cap, an all-skip frontier.
4. main path — every kernel's launch count is set to 0, then, over HTTP:
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
5. report — per kernel its launches, error, time, plain-version time and
   bound (one ``kernels`` JSON line), the nvidia-smi line, and last the
   ``{"ok": true, "device": ...}`` line.

Exits non-zero without a CUDA GPU, or when the package is not beside it.
"""

from __future__ import annotations

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)

# kernels of the main path: (name, wrapper module, TPU kernel it replaces)
KERNELS = [
    ("gather_packed", "dgraph_tpu_torch.ops.gather",
     "dgraph_tpu/ops/pallas_gather.py:48"),
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


def build_graph(n_nodes: int, n_edges: int, seed: int = GRAPH_SEED):
    """bench.py build_graph's edge generator: uniform sources, half the
    targets uniform and half pareto-skewed (celebrity uids)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, n_nodes + 1, size=n_edges)
    pop = (rng.pareto(1.2, size=n_edges).astype(np.float64) + 1.0)
    dst = (np.clip(pop / pop.max(), 1e-9, 1.0) * (n_nodes - 1)).astype(np.int64) + 1
    half = n_edges // 2
    dst[:half] = rng.integers(1, n_nodes + 1, size=half)
    return src, dst


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
    """An engine over the same store pinned to the host route: the
    reference the served bodies must equal byte for byte."""
    from dgraph_tpu_torch.query import QueryEngine

    eng = QueryEngine(store, device="cpu")
    eng.expand_device_min = 1 << 62
    return eng


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
    from dgraph_tpu_torch.models import PostingStore
    from dgraph_tpu_torch.serve.server import DgraphServer

    t0 = time.perf_counter()
    src, dst = build_graph(n_nodes, n_edges)
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
    return store, srv


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
    """Kernel == plain version on the card, exactly, over the grid.
    Returns the max |kernel - plain| and the main-path timing input."""
    import torch

    from dgraph_tpu_torch import ops
    from dgraph_tpu_torch.ops import gather

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
    cases.append(("all_skip", np.full(4096, -1, np.int32), 1024))
    results = []
    max_err = 0
    for name, rows, cap in cases:
        rt = torch.from_numpy(np.ascontiguousarray(rows, dtype=np.int32)).to(dev)
        got = gather.gather_packed(off, dst, rt, cap)
        want = gather.gather_packed_plain(off, dst, rt, cap)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        results.append((name, int(rt.shape[0]), int(cap), err))
        check(torch.equal(got, want), f"gather kernel != plain version on {name}")
    # one 10^6-edge row among light rows (degree skew inside one launch)
    heavy = 1_000_000
    degs = np.array([heavy, 3, 0, 7, 1], dtype=np.int64)
    hoff = torch.from_numpy(np.concatenate([[0], np.cumsum(degs)]).astype(np.int32)).to(dev)
    hdst = torch.from_numpy(
        rng.integers(1, N_NODES + 1, size=int(degs.sum()) + 128).astype(np.int32)
    ).to(dev)
    for name, rows, cap in (
        ("heavy_row", [1, 0, -1, 3, 4, 2, 0, -1], ops.bucket(2 * heavy + 11)),
        ("heavy_row_truncated", [0, 1, 3], 1 << 19),
    ):
        rt = torch.tensor(rows, dtype=torch.int32, device=dev)
        got = gather.gather_packed(hoff, hdst, rt, cap)
        want = gather.gather_packed_plain(hoff, hdst, rt, cap)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        max_err = max(max_err, err)
        results.append((name, len(rows), int(cap), err))
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
    log({"phase": "materialised_2hop", "seeds": len(seeds), "uids_in_body": n_nodes,
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
    log(dict(phase="large_2hop", **out["large"]))
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
    log({"phase": "mutation", "new_edges": len(new_edges), "epoch": arena.epoch,
         "reseeded": False, "merged_on_device": True, "seeds": len(fresh),
         "edges": led["edges"], "hops": led["hops"], "body_bytes": len(raw),
         "ms": round(secs * 1e3, 3), "byte_identical_to_host_route": True,
         "new_edges_present": True})
    return out


# -- phase 5 ----------------------------------------------------------------


def gather_timing(arena, rng) -> dict:
    """The gather at the main path's largest shape (the large 2-hop's
    second hop): wrapper and plain-version device times, and the bound."""
    import torch

    from dgraph_tpu_torch.ops import gather

    ra = arena.resident()
    seeds = np.unique(rng.integers(1, N_NODES + 1, size=LARGE_SEEDS))
    rows, cap, _ = second_hop_rows(arena, seeds)
    rt = torch.from_numpy(rows).to(arena.device)
    valid = rows[rows >= 0]
    total = int(arena.degree_of_rows(valid).sum())
    # bytes the function must move: the frontier, two offsets per live
    # row, each live span of dst once, and the packed output once
    nbytes = 4 * len(rows) + 8 * len(valid) + 4 * total + 8 * cap
    ms = cuda_ms(lambda: gather.gather_packed(ra.off, ra.dst, rt, cap))
    plain_ms = cuda_ms(lambda: gather.gather_packed_plain(ra.off, ra.dst, rt, cap))
    # the CUDA kernel alone, its O(B) torch prolog computed once outside
    _deg, cum, sstart = gather._prolog(ra.off, rt)
    out = torch.empty(2 * cap, dtype=torch.int32, device=arena.device)
    stream = torch.cuda.current_stream(arena.device).cuda_stream
    kernel_ms = cuda_ms(lambda: gather.KERNEL.launch(
        cum.data_ptr(), sstart.data_ptr(), ra.dst.data_ptr(),
        int(rt.shape[0]), int(cap), out.data_ptr(), stream))
    return {"B": len(rows), "live_rows": len(valid), "total": total,
            "cap": cap, "bytes": nbytes, "ms": ms, "kernel_only_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}


def main() -> int:
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
    import importlib

    srv = None
    phase = "build"
    try:
        t_start = time.perf_counter()
        info = phase_build()
        phase = "graph"
        store, srv = phase_graph("cuda", N_NODES, N_EDGES)
        arena = srv.engine.arenas.data("e")
        phase = "kernels"
        errs = phase_kernels(arena, np.random.default_rng(11))
        phase = "main_path"
        wrappers = {n: importlib.import_module(m) for n, m, _ in KERNELS}
        for w in wrappers.values():
            w.KERNEL.launches = 0
        main = phase_main_path(store, srv, np.random.default_rng(GRAPH_SEED),
                               info["nvidia_smi"])
        launches = {n: w.KERNEL.launches for n, w in wrappers.items()}
        for n, c in launches.items():
            check(c > 0, f"kernel {n} was not launched on the main path")
        phase = "report"
        t = gather_timing(srv.engine.arenas.data("e"), np.random.default_rng(13))
        log(dict(phase="gather_timing", **t))
        kernels = [{
            "name": "gather_packed",
            "ok": True,
            "route": "cuda",
            "source": "dgraph_tpu_torch/csrc/gather.cu",
            "replaces": KERNELS[0][2],
            "launches": launches["gather_packed"],
            "max_abs_err": errs["gather_packed"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": "bytes",
            "library_ms": None,
        }]
        log({"seconds": round(time.perf_counter() - t_start, 3),
             "large_2hop": main["large"]})
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
    sys.exit(main())
