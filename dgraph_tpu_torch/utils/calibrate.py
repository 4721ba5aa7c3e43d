"""Micro-calibration: measured per-route rates for the planner (port of
``dgraph_tpu/utils/calibrate.py``).

The planner (query/planner.py) prices every candidate route from a
handful of rates: the fixed cost of one device round trip, the per-edge
gather rate on each side of the host/device boundary and over a mesh
of ``MESH_CALIBRATION_WIDTH`` virtual chips of the device, the host
``np.intersect1d`` fold rate, the intersect kernel's per-element rate
and the per-MAC rate of the tile product.  This module measures them on
the engine's own routes and persists the result, so warm boots skip the
pass.

Three sources, in trust order:

- ``measured`` — ``measure()`` ran on this process's device;
- ``file`` — a previous run's measurement loaded from
  ``DGRAPH_TPU_CALIBRATION_FILE`` (refused when its backend or format
  version differs: a card's rates must never price a CPU boot);
- ``prior`` — the reference's shipped defaults, which are CPU
  bench-host numbers of the reference (its rounds 4-9), not rates of
  any accelerator and not of the card.

The planner refines the edge and element rates online from the hop
timings the engine records, so a cold pass converges toward the
workload's real rates.  The file format (``CALIBRATION_VERSION`` 1) is
the reference's; the backend is the torch device type (``cuda`` or
``cpu``).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import asdict, dataclass, replace
from typing import Optional

CALIBRATION_VERSION = 1

# the mesh rate's virtual width: that many shards, all on the device
MESH_CALIBRATION_WIDTH = 4


@dataclass(frozen=True)
class Calibration:
    """Per-route rates (µs) the cost model prices routes from.

    The priors are the reference's, taken on its 2-core CPU bench host:
    fused device gather ~0.018 µs/edge, numpy ~0.032 µs/edge, dispatch
    ~120 µs; the tile rates are its join tier's constants."""

    dispatch_us: float = 120.0       # fixed cost of one device round trip
    device_edge_us: float = 0.018    # per edge, staged expand_csr route
    resident_edge_us: float = 0.010  # per edge, resident gather kernel
                                     # (no h2d staging rides it)
    mesh_edge_us: float = 0.008      # per edge, the row-sharded mesh
                                     # expansion (mesh/executor.py),
                                     # measured on a virtual-width mesh
                                     # of the device
    host_edge_us: float = 0.032      # per edge, host numpy expansion
    host_touch_us: float = 0.010     # per edge, host conversion/dedup the
                                     # per-level path pays that a fused
                                     # chain keeps on the device
    host_setup_us: float = 4.0       # per-call host-path fixed cost
    chain_plan_us: float = 150.0     # chain capacity planning + packing
    host_intersect_us: float = 0.030   # per element, np.intersect1d fold
    device_intersect_us: float = 0.012  # per element, intersect kernel
    tile_mac_us: float = 1.2e-4      # per T·T MAC lane of a stored tile
    combine_us_per_mac: float = 2e-5   # block-column combine
    tile_build_us_per_lane: float = 1.8e-4  # host densify + upload
    tile_build_amortize: float = 8.0   # expected reuses of fresh tiles

    backend: str = ""                # torch device type of the rates
    source: str = "prior"            # prior | file | measured
    measured_at: float = 0.0         # epoch seconds, stored only

    _RATE_FIELDS = (
        "dispatch_us", "device_edge_us", "resident_edge_us",
        "mesh_edge_us", "host_edge_us", "host_touch_us",
        "host_setup_us", "chain_plan_us", "host_intersect_us",
        "device_intersect_us", "tile_mac_us", "combine_us_per_mac",
        "tile_build_us_per_lane", "tile_build_amortize",
    )

    def rates(self) -> dict:
        d = asdict(self)
        return {k: d[k] for k in self._RATE_FIELDS}


PRIORS = Calibration()


def _median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _timed_us(fn, reps: int, sync) -> float:
    """Median wall µs of ``fn()`` followed by ``sync()``, after one
    untimed warm-up call (a kernel's first call builds it)."""
    fn()
    sync()
    ts = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append((time.perf_counter() - t0) * 1e6)
    return _median(ts)


def measure(edges: int = 1 << 16, reps: int = 5, device=None) -> Calibration:
    """Run the calibration pass on ``device`` (default cuda) through the
    engine's own routes: the resident gather kernel
    (``ops.gather_packed``), the staged ``ops.expand_csr``, the sharded
expansion over a mesh of virtual chips of the device
(``parallel.mesh.sharded_expand_segments``), numpy over a
    host CSR, ``np.intersect1d``, the intersect kernel
    (``ops.kway_intersect_batch``) and the tile product (``ops.spgemm``).

    Every device call is closed by ``torch.cuda.synchronize`` before its
    clock stops, so a rate is the work's, not the enqueue's.  A kernel
    that does not build or launch raises here: a calibration that cannot
    launch the kernels has found a sick card, not a reason to price from
    priors."""
    import numpy as np
    import torch

    from dgraph_tpu_torch import device as devmod
    from dgraph_tpu_torch import ops
    from dgraph_tpu_torch.ops import spgemm

    dev = devmod.resolve(device)
    if dev.type == "cuda":
        def sync():
            torch.cuda.synchronize(dev)
    else:
        def sync():
            pass

    # dispatch: one tiny op and its round trip
    x = torch.zeros(8, dtype=torch.int32, device=dev)
    dispatch_us = max(
        _timed_us(lambda: x.add_(1), max(reps * 4, 16), sync), 1.0
    )

    # synthetic CSR: S rows of uniform degree, the gather's shape without
    # the planning around it
    deg = 32
    S = max(edges // deg, 8)
    E = S * deg
    h_offsets = np.arange(S + 1, dtype=np.int64) * deg
    h_dst = (np.arange(E, dtype=np.int64) % (S * 2)).astype(np.int32)
    rows = np.arange(S, dtype=np.int32)
    cap = ops.bucket(E)
    off_d = torch.from_numpy(h_offsets.astype(np.int32)).to(dev)
    # the resident layout: round_up(E, 128) + 128 lanes, SENT past E
    res_dst = np.full(-(-E // 128) * 128 + 128, ops.SENT, np.int32)
    res_dst[:E] = h_dst
    res_d = torch.from_numpy(res_dst).to(dev)
    dst_d = torch.from_numpy(h_dst).to(dev)
    rows_d = torch.from_numpy(rows).to(dev)

    resident_edge_us = max(
        (_timed_us(lambda: ops.gather_packed(off_d, res_d, rows_d, cap),
                   reps, sync) - dispatch_us) / E,
        1e-5,
    )
    device_edge_us = max(
        (_timed_us(lambda: ops.expand_csr(off_d, dst_d, rows_d, cap),
                   reps, sync) - dispatch_us) / E,
        1e-5,
    )

    # mesh edge rate: the sharded expansion with its reassembly and its
    # fetch (parallel/mesh.py) over MESH_CALIBRATION_WIDTH virtual chips
    # of the device, the route:mesh leaf's whole dispatch
    from dgraph_tpu_torch.parallel.mesh import (
        make_mesh,
        shard_arena_rows,
        sharded_expand_segments,
    )

    mesh = make_mesh(devices=[dev] * MESH_CALIBRATION_WIDTH)
    h_src = np.arange(S, dtype=np.int64)
    sharded = shard_arena_rows(h_src, h_offsets, h_dst, MESH_CALIBRATION_WIDTH,
                               devices=mesh.model_devices())
    mesh_edge_us = max(
        (_timed_us(lambda: sharded_expand_segments(mesh, sharded, h_src, cap),
                   reps, sync) - dispatch_us) / E,
        1e-5,
    )

    # host edge rate: numpy over the host CSR, with the dedup the host
    # per-level path pays
    starts = h_offsets[:-1][rows]

    def host_expand():
        within = np.arange(E) - np.repeat(starts, deg)
        np.unique(h_dst[np.repeat(starts, deg) + within])

    host_edge_us = max(_timed_us(host_expand, reps, lambda: None) / E, 1e-5)
    # host setup: the same pass over a one-row frontier
    one = starts[:1]

    def host_one():
        within = np.arange(deg) - np.repeat(one, deg)
        np.unique(h_dst[np.repeat(one, deg) + within])

    host_setup_us = max(_timed_us(host_one, reps * 4, lambda: None), 1.0)
    # host touch: a device route's conversion of its packed output
    # (int64 widening, segment pointers, dedup) on the host
    packed = np.concatenate([h_dst, np.repeat(rows, deg)])

    def host_touch():
        out = packed[:E].astype(np.int64)
        seg = packed[E:].astype(np.int64)
        np.cumsum(np.bincount(seg, minlength=S))
        np.unique(out)

    host_touch_us = max(_timed_us(host_touch, reps, lambda: None) / E, 1e-5)

    # k-way fold: np.intersect1d of two sorted-unique sets on the host,
    # the intersect kernel on the device, per element of the inputs
    a = np.arange(0, edges * 2, 2, dtype=np.int64)
    b = np.arange(0, edges * 3, 3, dtype=np.int64)
    host_intersect_us = max(
        _timed_us(lambda: np.intersect1d(a, b, assume_unique=True),
                  reps, lambda: None) / (len(a) + len(b)),
        1e-5,
    )
    L = ops.bucket(len(a))
    mat = torch.from_numpy(
        np.stack([ops.pad_to(a, L), ops.pad_to(b, L)])[None]
    ).to(dev)
    device_intersect_us = max(
        (_timed_us(lambda: ops.kway_intersect_batch(mat), reps, sync)
         - dispatch_us) / (len(a) + len(b)),
        1e-5,
    )

    # tile MAC rate: the tile tier's product over K stored T×T tiles
    T, K = 128, 8
    tiles = torch.ones((K, T, T), dtype=torch.float32, device=dev)
    bi = torch.arange(K, dtype=torch.int64, device=dev)
    bj = torch.arange(K, dtype=torch.int64, device=dev)
    xm = torch.ones(K * T, dtype=torch.float32, device=dev)
    tile_mac_us = max(
        (_timed_us(lambda: spgemm.expand_counts(bi, bj, tiles, xm),
                   reps, sync) - dispatch_us) / (K * T * T),
        1e-9,
    )

    return replace(
        PRIORS,
        dispatch_us=dispatch_us,
        device_edge_us=device_edge_us,
        resident_edge_us=resident_edge_us,
        mesh_edge_us=mesh_edge_us,
        host_edge_us=host_edge_us,
        host_touch_us=host_touch_us,
        host_setup_us=host_setup_us,
        host_intersect_us=host_intersect_us,
        device_intersect_us=device_intersect_us,
        tile_mac_us=tile_mac_us,
        backend=dev.type,
        source="measured",
        measured_at=time.time(),
    )


def save(cal: Calibration, path: str) -> None:
    """Persist a calibration durably (atomic tmp + fsync + replace: the
    planner must never price routes from a torn file)."""
    from dgraph_tpu_torch.utils.atomicio import atomic_write_file

    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    body = {
        "version": CALIBRATION_VERSION,
        "backend": cal.backend,
        "measured_at": cal.measured_at,
        "rates": cal.rates(),
    }
    atomic_write_file(path, json.dumps(body, indent=1).encode())


def load(path: str, backend: Optional[str] = None) -> Optional[Calibration]:
    """Load a persisted calibration; None when missing, unparsable, from
    another format version, or taken on another backend."""
    try:
        with open(path, "rb") as f:
            body = json.loads(f.read().decode())
    except (OSError, ValueError):
        return None
    if body.get("version") != CALIBRATION_VERSION:
        return None
    if backend is not None and body.get("backend") != backend:
        return None
    rates = body.get("rates")
    if not isinstance(rates, dict):
        return None
    try:
        known = {k: float(v) for k, v in rates.items()
                 if k in Calibration._RATE_FIELDS}
        return replace(
            PRIORS,
            **known,
            backend=str(body.get("backend", "")),
            source="file",
            measured_at=float(body.get("measured_at", 0.0)),
        )
    except (TypeError, ValueError):
        # a hand-edited or partly corrupt rate degrades to priors
        return None
