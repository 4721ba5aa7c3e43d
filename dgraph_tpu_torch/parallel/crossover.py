"""Crossover model: when does a row-sharded expansion beat one card?
(PyTorch port of ``dgraph_tpu/parallel/crossover.py``, with the H100's
constants in place of the reference's TPU ones.)

The single-card side prices a query's gather indices at the per-index
cost of a random gather, which steps with the physical size of the table
gathered from: inside the H100's 50 MB L2, in HBM just past it, and far
into HBM.  The sharded side adds the exchange: each hop's per-shard
output reaches the receiving device, and every shard's dispatch adds
its launches.

Constants, and where each comes from:

- ``GATHER_NS_*``, ``ON_CARD_COPY_BYTES_PER_S`` and
  ``MESH_SHARD_DISPATCH_S`` are measured on an NVIDIA H100 80GB HBM3
  (power limit 700 W) by :func:`measure`, which ``chip_smoke.py`` runs in
  phase ``mesh`` and prints as its ``mesh_calibration`` line;
- ``L2_BYTES``, ``HBM_TOTAL`` and ``NVLINK_BYTES_PER_S`` are the H100
  SXM data sheet's (50 MB L2, 80 GB HBM3, NVLink 900 GB/s total, so
  450 GB/s each way).  The NVLink rate is an estimate until a four-card
  run measures a cross-card exchange.

On virtual chips of one card (every shard on ``cuda:0``) the exchange's
copies are no-ops; the model prices them at the on-card copy rate, an
upper bound.  The reference has no answer to this question at all — a
predicate lives wholly in one group upstream (SURVEY §5).  Ours: shard
when (a) the arena cannot fit one card's memory budget (forced), or
(b) the saved gather time exceeds the added exchange and dispatch time.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

# --- the card's data sheet (H100 SXM) -----------------------------------
L2_BYTES = 50 << 20          # L2 cache
HBM_TOTAL = 80 << 30         # device memory per card
NVLINK_BYTES_PER_S = 450e9   # NVLink 4, each way: an ESTIMATE until a
                             # four-card run measures the exchange

# --- measured on the card (chip_smoke.py phase mesh, mesh_calibration) ---
# the three table sizes the gather was timed at: inside L2, past it, and
# far into HBM
GATHER_TABLE_BYTES = (16 << 20, 256 << 20, 4 << 30)
# (the mesh_calibration line of `python3 chip_smoke.py --mesh-only` on an
# NVIDIA H100 80GB HBM3 at 700.00 W, torch 2.11.0+cu128; 2^24 random
# indices: 16 MB 0.010046 ns, 256 MB 0.034336 ns, 4 GB 0.037361 ns)
GATHER_NS_L2 = 0.010046      # per index, table <= L2_BYTES
GATHER_NS_HBM = 0.034336     # per index, table <= HBM_NEAR_TIER
GATHER_NS_HBM_FAR = 0.037361  # per index, larger tables
HBM_NEAR_TIER = 1 << 30      # between the second and the third size
# a 1 GiB copy_ on the card: 1.2826e12 bytes copied per second
ON_CARD_COPY_BYTES_PER_S = 1.2826e12
# a one-uid expansion at 4 virtual chips, fetch included: 4.171 ms of
# wall clock, 1.043 ms a shard (the host's launches of 4 shards' ops)
MESH_SHARD_DISPATCH_S = 1.043e-3


def gather_ns(table_bytes: float) -> float:
    """Per-index gather cost for a table of this physical size."""
    if table_bytes <= L2_BYTES:
        return GATHER_NS_L2
    if table_bytes <= HBM_NEAR_TIER:
        return GATHER_NS_HBM
    return GATHER_NS_HBM_FAR


@dataclass
class CrossoverEstimate:
    single_chip_s: float
    sharded_s: float
    forced: bool  # arena exceeds one card's budget: sharding is not a choice

    @property
    def speedup(self) -> float:
        return self.single_chip_s / max(self.sharded_s, 1e-12)

    @property
    def shard_wins(self) -> bool:
        return self.forced or self.sharded_s < self.single_chip_s


def estimate(
    arena_bytes: int,
    frontier_rows: int,
    out_edges: int,
    n_devices: int,
    hbm_bytes: int = HBM_TOTAL,
    hbm_budget_frac: float = 0.8,
    distinct_cards: bool = True,
) -> CrossoverEstimate:
    """Expected per-query expansion cost, one card vs row-sharded.

    arena_bytes: physical size of the gathered tables.
    frontier_rows: gather indices per query for the row lookups.
    out_edges: produced edge slots (one gather each; the exchange's
      payload).
    distinct_cards: the shards on ``n_devices`` cards (the exchange rides
      NVLink) or virtual chips of one card (the on-card copy rate).
    """
    idx = frontier_rows + out_edges
    single = idx * gather_ns(arena_bytes) * 1e-9
    forced = arena_bytes > hbm_budget_frac * hbm_bytes

    shard_bytes = arena_bytes / n_devices
    # each shard looks the FULL frontier up against its slice (the
    # broadcast-frontier design of parallel/mesh.py) but gathers only its
    # rows' edges; distinct cards gather at once, virtual chips of one
    # card in turn
    sh_idx = frontier_rows + out_edges / n_devices
    compute = sh_idx * gather_ns(shard_bytes) * 1e-9
    if not distinct_cards:
        compute *= n_devices
    # the exchange: (n-1)/n of the shards' int32 output reaches the root
    payload = out_edges * 4.0 * (n_devices - 1) / n_devices
    rate = NVLINK_BYTES_PER_S if distinct_cards else ON_CARD_COPY_BYTES_PER_S
    exchange = payload / rate if rate > 0 else 0.0
    dispatch = n_devices * MESH_SHARD_DISPATCH_S
    return CrossoverEstimate(single, compute + exchange + dispatch, forced)


def should_shard(
    arena_bytes: int,
    n_rows: int,
    avg_degree: float,
    n_devices: int,
    typical_frontier: int = 4096,
) -> bool:
    """The ``use_mesh_for`` decision for one arena on a mesh of distinct
    cards: model the TYPICAL query (a frontier of ~4k rows expanding
    once) and shard when the model says sharded wins — or when one
    card cannot hold the arena."""
    f = min(typical_frontier, max(1, n_rows))
    est = estimate(
        arena_bytes,
        frontier_rows=f,
        out_edges=int(f * max(1.0, avg_degree)),
        n_devices=n_devices,
        # one predicate cannot monopolize the card: arenas of every hot
        # predicate, value/index tables and outputs share its memory, so
        # an arena above ~40% of it must shard to stay resident
        hbm_budget_frac=0.4,
    )
    return est.shard_wins


def _events_ms(fn, iters: int) -> float:
    import torch

    fn()
    # a timing harness: the sync is the measurement
    # graftlint: ignore[naked-device-sync]
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        # a timing harness: the sync is the measurement
        # graftlint: ignore[naked-device-sync]
        b.synchronize()
        ts.append(a.elapsed_time(b))
    ts.sort()
    return ts[len(ts) // 2]


def measure(device="cuda", n_index: int = 1 << 24, iters: int = 10,
            width: int = 4) -> dict:
    """Measure this module's card constants on ``device`` (a CUDA card):

    - ``gather_ns``: per-index cost of ``table[idx]`` over an int32 table
      of each of ``GATHER_TABLE_BYTES`` with ``n_index`` uniform random
      indices (median of ``iters`` by CUDA events; the table warm);
    - ``copy_bytes_per_s``: a 1 GiB device-to-device ``copy_`` on the
      card, bytes copied per second;
    - ``shard_dispatch_s``: a one-uid sharded expansion at ``width``
      virtual chips, the fetch included (wall clock, median), divided by
      the width.
    """
    import numpy as np
    import torch

    from dgraph_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_arena_rows,
        sharded_expand_segments,
    )

    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    gather = {}
    for nbytes in GATHER_TABLE_BYTES:
        n = nbytes // 4
        table = torch.empty(n, dtype=torch.int32, device=dev)
        idx = torch.randint(0, n, (n_index,), device=dev, generator=g)
        ms = _events_ms(lambda: table[idx], iters)
        gather[str(nbytes)] = ms * 1e6 / n_index
        del table, idx
    torch.cuda.empty_cache()
    a = torch.empty(1 << 28, dtype=torch.int32, device=dev)
    b = torch.empty_like(a)
    ms = _events_ms(lambda: b.copy_(a), iters)
    copy_rate = a.numel() * 4 / (ms * 1e-3)
    del a, b
    torch.cuda.empty_cache()
    mesh = make_mesh(devices=[dev] * width)
    h_src = np.arange(1, 1025, dtype=np.int64)
    h_off = np.arange(1025, dtype=np.int64) * 4
    h_dst = np.arange(4096, dtype=np.int64) % 1024 + 1
    sa = shard_arena_rows(h_src, h_off, h_dst, width,
                          devices=mesh.model_devices())
    one = np.array([1], dtype=np.int64)
    sharded_expand_segments(mesh, sa, one, 8)
    ts = []
    for _ in range(iters * 3):
        t0 = time.perf_counter()
        sharded_expand_segments(mesh, sa, one, 8)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return {
        "gather_ns": gather,
        "copy_bytes_per_s": copy_rate,
        "shard_dispatch_s": ts[len(ts) // 2] / width,
        "width": width,
        "n_index": n_index,
    }
