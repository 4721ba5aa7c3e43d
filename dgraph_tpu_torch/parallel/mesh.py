"""Row-sharded traversal over a mesh of devices (PyTorch port of
``dgraph_tpu/parallel/mesh.py``).

Each device of a ``("data", "model")`` mesh owns a contiguous uid-range
slice of an arena's rows (the ``model`` axis) and a slice of a query
batch (the ``data`` axis).  Frontier expansion is a local CSR gather per
shard (``ops.rows_of`` + ``ops.expand_csr``) and a combine over the model
axis.  Predicate→shard routing (the reference's group.BelongsTo) stays
fingerprint-mod for multi-arena placement.

The reference is single-controller: one process drives every chip
through ``shard_map`` and XLA collectives.  The port keeps that shape
without ``torch.distributed``: one process walks the shards in turn, and
the collectives are copies of each shard's result to the receiving
device (``.to(dev, non_blocking=True)``, the model axis' first device)
followed by a ``stack`` / ``sum`` / ``minimum`` there —

- ``all_gather`` → :func:`all_gather`, ``psum`` → :func:`psum`,
  ``pmin`` → :func:`pmin`.

A mesh's devices may repeat: a mesh of W *virtual chips* on one card
puts every shard on ``cuda:0``, where each copy is a no-op, and the same
code path runs over ``cuda:0..3`` on four cards.  On the CPU every shard
lives on ``cpu`` (the tests).  Nothing in a dispatch waits on the host:
capacities are fixed, no ``.item()``, no data-dependent shape; only the
caller's one fetch synchronizes.

Every function is a plain function: the reference memoizes its step
factories to bound XLA compiles, and torch compiles nothing here.
``mode="drop"`` scatters of the reference have no torch twin: their
dropped slots go to one spare trailing slot that is sliced off.

Fault attribution: each shard's work runs inside :func:`_on_chip`.  On a
mesh of distinct devices a classified device fault raised there is
re-raised as ``devguard.ChipFaultError`` naming the chip (``chip=i``),
which the elastic fault domain (``mesh/fault.py``) evicts.  On virtual
chips of one card a real CUDA fault is the whole card's: it stays
un-attributed and latches the plane.
"""

from __future__ import annotations

import contextlib
import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from dgraph_tpu_torch import ops
from dgraph_tpu_torch.ops.sets import SENT

AXES = ("data", "model")


def predicate_shard(pred: str, n_shards: int) -> int:
    """Deterministic predicate→shard (fingerprint mod N, conf.go:182)."""
    h = int.from_bytes(hashlib.blake2b(pred.encode(), digest_size=8).digest(), "big")
    return h % n_shards


def _norm(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    return d


class Mesh:
    """A ``[data, model]`` array of ``torch.device`` (devices may
    repeat: virtual chips) with the reference's axis names in ``shape``."""

    axis_names = AXES

    def __init__(self, devices):
        arr = np.asarray(
            [[_norm(d) for d in row] for row in devices], dtype=object
        )
        if arr.ndim != 2 or arr.size == 0:
            raise ValueError("a mesh needs a non-empty [data, model] device array")
        self.devices = arr
        self.shape = {"data": int(arr.shape[0]), "model": int(arr.shape[1])}

    def model_devices(self) -> List[torch.device]:
        """The model axis' devices (the first data row): shard i of a
        row-sharded arena lives on entry i."""
        return list(self.devices[0])

    def data_devices(self) -> List[torch.device]:
        """The data axis' devices (the first model column)."""
        return list(self.devices[:, 0])

    @property
    def root(self) -> torch.device:
        """The receiving device of every combine."""
        return self.devices[0, 0]

    @property
    def distinct(self) -> bool:
        """Whether every model-axis chip is its own device (a fault can
        then be attributed to one chip)."""
        devs = [str(d) for d in self.model_devices()]
        return len(set(devs)) == len(devs)

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.reshape(-1)]})"


def make_mesh(
    n_devices: Optional[int] = None, data: int = 1, devices=None
) -> Mesh:
    """A ``("data", "model")`` mesh: query-batch × uid-range parallelism.

    ``devices`` defaults to ``cuda:0 … cuda:{device_count-1}``; with no
    GPU and no ``devices`` this raises (there is no CPU fallback: pass
    ``devices=["cpu"] * W`` to build a CPU mesh on purpose, or
    ``[cuda:0] * W`` for W virtual chips of one card)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: torch sees no CUDA GPU; pass devices= "
                "(e.g. ['cpu'] * 8) to build a mesh without one"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [_norm(d) for d in devices]
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"make_mesh: {n} devices asked, {len(devs)} given")
    data = max(1, int(data))
    model = n // data
    if model < 1:
        raise ValueError(f"make_mesh: {n} devices cannot make {data} data rows")
    devs = devs[: data * model]
    return Mesh([devs[r * model:(r + 1) * model] for r in range(data)])


# -- the collectives: copies to the receiving device, then one op there ------


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t.to(dev, non_blocking=True)


def all_gather(parts: Sequence[torch.Tensor], dev: torch.device) -> torch.Tensor:
    """Every shard's tensor stacked on ``dev`` ([n_shards, ...])."""
    return torch.stack([_to(p, dev) for p in parts])


def psum(parts: Sequence[torch.Tensor], dev: torch.device) -> torch.Tensor:
    """The shards' tensors summed on ``dev``."""
    acc = _to(parts[0], dev)
    for p in parts[1:]:
        acc = acc + _to(p, dev)
    return acc


def pmin(parts: Sequence[torch.Tensor], dev: torch.device) -> torch.Tensor:
    """The shards' tensors' elementwise minimum on ``dev``."""
    acc = _to(parts[0], dev)
    for p in parts[1:]:
        acc = torch.minimum(acc, _to(p, dev))
    return acc


@contextlib.contextmanager
def _on_chip(mesh: Mesh, i: int, dev: torch.device):
    """Run one shard's work on its device (the guard's worker enters only
    the caller's device: a mesh dispatch touches every shard's) and, on
    a mesh of distinct devices, attribute a classified device fault to
    chip ``i``."""
    ctx = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
    try:
        with ctx:
            yield
    except Exception as e:
        from dgraph_tpu_torch.utils import devguard

        if (
            mesh.distinct
            and devguard.classify(e) not in (None, "hang", "sick")
            and devguard.chip_of(e) is None
        ):
            raise devguard.ChipFaultError(i, e) from e
        raise


# -- row-sharded arenas -------------------------------------------------------


@dataclass
class ShardedArena:
    """An arena row-sharded across the model axis.

    Rows are padded to equal per-shard counts; each shard's offsets are
    rebased to its local dst slice.  ``src`` keeps global uids, so a
    lookup is a local searchsorted after the frontier's broadcast.  Shard
    i's three tensors live on the device it was placed on."""

    src: List[torch.Tensor]      # [n_shards] × int32[Sp] global uids, SENT pad
    offsets: List[torch.Tensor]  # [n_shards] × int32[Sp+1] local offsets
    dst: List[torch.Tensor]      # [n_shards] × int32[Ep] local edges, SENT pad
    n_shards: int

    def device_bytes(self) -> int:
        return sum(
            t.numel() * t.element_size()
            for ts in (self.src, self.offsets, self.dst)
            for t in ts
        )

    def to(self, devices: Sequence) -> "ShardedArena":
        """Shard i on ``devices[i]`` (a no-op for a shard already there)."""
        return ShardedArena(
            src=[_to(t, _norm(d)) for t, d in zip(self.src, devices)],
            offsets=[_to(t, _norm(d)) for t, d in zip(self.offsets, devices)],
            dst=[_to(t, _norm(d)) for t, d in zip(self.dst, devices)],
            n_shards=self.n_shards,
        )


def shard_arena_rows(
    h_src: np.ndarray,
    h_offsets: np.ndarray,
    h_dst: np.ndarray,
    n_shards: int,
    devices: Optional[Sequence] = None,
) -> ShardedArena:
    """Split CSR rows into n contiguous uid-range shards (host-side);
    shard i goes to ``devices[i]`` (default: the CPU)."""
    S = len(h_src)
    per = -(-S // n_shards) if S else 1
    Sp = ops.bucket(max(1, per))
    degs = h_offsets[1:] - h_offsets[:-1] if S else np.empty(0, np.int64)
    Ep = 1
    for i in range(n_shards):
        lo, hi = i * per, min(S, (i + 1) * per)
        e = int(degs[lo:hi].sum()) if hi > lo else 0
        Ep = max(Ep, e)
    Ep = ops.bucket(Ep)
    srcs = np.full((n_shards, Sp), SENT, dtype=np.int32)
    offs = np.zeros((n_shards, Sp + 1), dtype=np.int32)
    dsts = np.full((n_shards, Ep), SENT, dtype=np.int32)
    for i in range(n_shards):
        lo, hi = i * per, min(S, (i + 1) * per)
        if hi <= lo:
            continue
        srcs[i, : hi - lo] = h_src[lo:hi].astype(np.int32)
        local_off = (h_offsets[lo : hi + 1] - h_offsets[lo]).astype(np.int32)
        offs[i, : hi - lo + 1] = local_off
        offs[i, hi - lo + 1 :] = local_off[-1]
        e0, e1 = int(h_offsets[lo]), int(h_offsets[hi])
        dsts[i, : e1 - e0] = h_dst[e0:e1]
    devs = [torch.device("cpu")] * n_shards if devices is None else list(devices)
    return ShardedArena(
        src=[torch.from_numpy(srcs[i]).to(_norm(devs[i])) for i in range(n_shards)],
        offsets=[torch.from_numpy(offs[i]).to(_norm(devs[i])) for i in range(n_shards)],
        dst=[torch.from_numpy(dsts[i]).to(_norm(devs[i])) for i in range(n_shards)],
        n_shards=n_shards,
    )


def local_expand(sharded: ShardedArena, i: int, frontier: torch.Tensor, cap: int):
    """Shard i's expansion of the frontier uids it owns (``rows_of``
    resolves a uid only on its owner): ``ops.expand_csr``'s (out, seg,
    total) on the shard's device."""
    rows = ops.rows_of(sharded.src[i], frontier)
    return ops.expand_csr(sharded.offsets[i], sharded.dst[i], rows, cap)


def seg_expand_packed_step(
    mesh: Mesh, sharded: ShardedArena, frontier: torch.Tensor, cap: int, fcap: int
) -> Tuple[torch.Tensor, int]:
    """The sharded expansion WITH its reassembly on the device.

    Each shard expands its owned rows; the reassembly — per-slot
    destination by scans, one scatter, a ``pmin`` combine across shards,
    ``seg_ptr`` by ``psum`` + prefix sum — never leaves the devices.
    ``frontier`` is int32[fcap] on the root.  Returns (packed int32 on the
    root: ``[out_sorted (n_model·cap) | seg_ptr (fcap+1)]``, n_model·cap).

    Each segment (frontier uid) lives in exactly one shard, and
    ``expand_csr`` emits a shard's slots grouped by ascending segment, so
    every slot's final position is ``seg_ptr[seg] + rank-within-segment``:
    O(cap) scans and one scatter, no global sort."""
    devs = mesh.model_devices()
    n_model = len(devs)
    total_slots = n_model * cap
    root = mesh.root
    local = []
    for i, d in enumerate(devs):
        with _on_chip(mesh, i, d):
            out, seg, _t = local_expand(sharded, i, _to(frontier, d), cap)
            valid = seg >= 0
            # invalid slots count into the spare trailing segment fcap
            segc = torch.where(valid, seg, fcap)
            counts = torch.zeros(fcap + 1, dtype=torch.int32, device=d)
            counts.scatter_add_(0, segc.long(), torch.ones_like(segc))
            local.append((out, segc, valid, counts[:fcap]))
    seg_totals = psum([c for _o, _s, _v, c in local], root)
    seg_ptr = torch.cat([
        torch.zeros(1, dtype=torch.int32, device=root),
        torch.cumsum(seg_totals, 0, dtype=torch.int32),
    ])
    bufs = []
    for i, d in enumerate(devs):
        out, segc, valid, _c = local[i]
        with _on_chip(mesh, i, d):
            sp = _to(seg_ptr, d)
            idx = torch.arange(cap, dtype=torch.int32, device=d)
            first = torch.ones(cap, dtype=torch.bool, device=d)
            first[1:] = segc[1:] != segc[:-1]
            run_start = torch.cummax(torch.where(first, idx, 0), 0).values
            dest = sp[segc.clamp(0, fcap).long()] + (idx - run_start)
            # every shard scatters only its own slots (disjoint dests);
            # dropped slots land on the spare slot total_slots
            where = torch.where(valid, dest, total_slots).clamp(0, total_slots)
            buf = torch.full((total_slots + 1,), SENT, dtype=torch.int32, device=d)
            buf.scatter_(0, where.long(), out)
            bufs.append(buf[:total_slots])
    # unwritten slots hold SENT = int32 max, so pmin combines the shards
    buf = pmin(bufs, root)
    return torch.cat([buf, seg_ptr]), total_slots


def _fcap_bucket(n: int, floor: int = 256) -> int:
    """Coarse frontier-capacity bucketing for the mesh step: 4×-step
    powers (256, 1024, 4096, ...) instead of ops.bucket's 2×-steps (the
    reference's, which bounds its compiled shapes; here it bounds the
    shapes the fault domain's rejoin warms)."""
    b = floor
    while b < n:
        b <<= 2
    return b


def sharded_expand_segments(
    mesh: Mesh, sharded: ShardedArena, frontier: np.ndarray, cap: int
):
    """One engine-level expansion over the mesh: returns (out_flat,
    seg_ptr) identical in content to the single-device expand — each
    frontier uid's targets ascending, grouped in frontier order.  All
    reassembly is device-side; one fetch brings back the packed buffer's
    first ``cap`` slots and ``seg_ptr`` (``cap`` must bound the frontier's
    edges, as the engine plans it: a smaller one raises ValueError).

    Order-agnostic and deterministic per row, so the cohort scheduler's
    merged union frontiers ride this path unchanged.  The ``device.mesh``
    failpoint fires here, inside the mesh guard's closure."""
    from dgraph_tpu_torch.utils.failpoints import fail

    fail.point("device.mesh")
    fcap = _fcap_bucket(len(frontier))
    f = torch.from_numpy(
        ops.pad_to(np.asarray(frontier, dtype=np.int64), fcap)
    ).to(mesh.root)
    packed, total_slots = seg_expand_packed_step(mesh, sharded, f, cap, fcap)
    n = len(frontier)
    keep = min(cap, total_slots)
    # the mesh step's one fetch, as the reference's np.asarray
    # (parallel/mesh.py); the serving plane runs it under the executor's
    # guard
    # graftlint: ignore[naked-device-sync]
    host = torch.cat(
        [packed[:keep], packed[total_slots : total_slots + n + 1]]
    ).cpu().numpy()
    seg_ptr = host[keep:].astype(np.int64)
    total = int(seg_ptr[n])
    if total > keep:
        raise ValueError(
            f"mesh expansion of {total} edges exceeds its cap {cap}: "
            "plan cap from the frontier's degree sum"
        )
    return host[:total].astype(np.int64), seg_ptr


def batched_hop_step(
    mesh: Mesh,
    offsets: torch.Tensor,
    dst: torch.Tensor,
    rows: torch.Tensor,
    cap: int,
    cap_out: int,
    n_hops: int,
):
    """Data-parallel fused hops over a BATCH of frontiers: the [Bp, R]
    batch splits across the ``data`` axis (each data device owns a slice
    of the queries), the dense arena replicates, and every device runs
    ``ops.expand_filter_compact`` per hop for each of its queries — the
    batch-axis counterpart of the row-sharded expansion.  Returns
    (frontiers int32[Bp, cap_out], totals int32[Bp, n_hops]) on the root."""
    devs = mesh.data_devices()
    nd = len(devs)
    per = rows.shape[0] // nd
    fs, ts = [], []
    for k, d in enumerate(devs):
        with _on_chip(mesh, 0, d):
            off_d, dst_d = _to(offsets, d), _to(dst, d)
            for r in _to(rows[k * per:(k + 1) * per], d):
                f = r
                tot = []
                for _ in range(n_hops):
                    f, t = ops.expand_filter_compact(
                        off_d, dst_d, ops.frontier_rows(f), cap, (), cap_out,
                    )
                    tot.append(t)
                fs.append(_to(f, mesh.root))
                ts.append(_to(torch.stack(tot), mesh.root))
    return torch.stack(fs), torch.stack(ts)


def batched_expand_frontiers(
    mesh: Mesh,
    offsets: torch.Tensor,
    dst: torch.Tensor,
    frontiers: np.ndarray,
    cap: int,
    n_hops: int = 1,
):
    """Run ``n_hops`` fused hops for a [B, R] batch of dense-arena
    frontiers, the batch axis sharded across the mesh's ``data`` axis.
    Pads B up to the data-axis size and returns (final frontiers
    int32[B, cap], per-hop edge counts int32[B, n_hops]) as numpy.

    ``cap`` must bound every hop's fan-out for every query: an
    under-planned cap raises here rather than silently truncating."""
    nd = mesh.shape["data"]
    B = len(frontiers)
    Bp = -(-B // nd) * nd
    rows = np.full((Bp, frontiers.shape[1]), SENT, dtype=np.int32)
    rows[:B] = frontiers
    f, totals = batched_hop_step(
        mesh, offsets, dst, torch.from_numpy(rows), cap, cap, n_hops
    )
    # the batched hop's fetch, as the reference's np.asarray
    # (parallel/mesh.py)
    # graftlint: ignore[naked-device-sync]
    totals = totals[:B].cpu().numpy()
    if totals.size and int(totals.max()) > cap:
        raise ValueError(
            f"hop fan-out {int(totals.max())} exceeds cap {cap}: "
            "re-plan cap from the worst-hop degree bound"
        )
    # the batched hop's fetch, as the reference's np.asarray
    # (parallel/mesh.py)
    # graftlint: ignore[naked-device-sync]
    return f[:B].cpu().numpy(), totals


def sharded_two_hop(
    mesh: Mesh, arena: ShardedArena, frontier: np.ndarray, cap1: int, cap2: int
):
    """Two-hop sharded traversal: returns (hop1 uids, hop2 uids) padded,
    on the root device — one hop of the mesh program at each capacity."""
    from dgraph_tpu_torch.mesh.programs import mesh_multi_hop_step

    f = torch.from_numpy(
        ops.pad_to(frontier, ops.bucket(max(1, len(frontier))))
    ).to(mesh.root)
    h1 = mesh_multi_hop_step(mesh, arena, f, cap1, 1)[2]
    h2 = mesh_multi_hop_step(mesh, arena, h1, cap2, 1)[2]
    return h1, h2


# -- the tile join tier: tiles sharded over the model axis --------------------


def shard_tiles(pt, n_shards: int, devices: Optional[Sequence] = None):
    """Split a PredTiles' stored blocks round-robin across ``n_shards``
    model-axis shards (host-side).  Pad slots are zero tiles at block
    (0, 0): they contribute nothing to the sum combine, so uneven splits
    need no masking.  Returns per-shard lists (bi int64[Kp], bj int64[Kp],
    tiles float32[Kp, T, T]), shard i on ``devices[i]`` (default: CPU)."""
    k = max(1, pt.n_tiles)
    # host-side sharding of the tile blocks, as the reference's np.asarray
    # (parallel/mesh.py)
    # graftlint: ignore[naked-device-sync]
    bi = pt.bi[:k].cpu().numpy()
    bj = pt.bj[:k].cpu().numpy()  # graftlint: ignore[naked-device-sync]
    tiles = pt.tiles[:k].cpu().numpy()  # graftlint: ignore[naked-device-sync]
    K = len(bi)
    per = -(-K // n_shards)
    Kp = ops.bucket(max(1, per))
    t = tiles.shape[1]
    devs = [torch.device("cpu")] * n_shards if devices is None else list(devices)
    sbi, sbj, stl = [], [], []
    for i in range(n_shards):
        b_i = np.zeros(Kp, dtype=np.int64)
        b_j = np.zeros(Kp, dtype=np.int64)
        tl = np.zeros((Kp, t, t), dtype=np.float32)
        lo, hi = i * per, min(K, (i + 1) * per)
        if hi > lo:
            b_i[: hi - lo] = bi[lo:hi]
            b_j[: hi - lo] = bj[lo:hi]
            tl[: hi - lo] = tiles[lo:hi]
        d = _norm(devs[i])
        sbi.append(torch.from_numpy(b_i).to(d))
        sbj.append(torch.from_numpy(b_j).to(d))
        stl.append(torch.from_numpy(tl).to(d))
    return sbi, sbj, stl


def tile_expand_step(mesh: Mesh, sbi, sbj, stiles, x: torch.Tensor) -> torch.Tensor:
    """One blocked-boolean SpMV hop over model-sharded tiles: each shard
    computes its tiles' contributions (one ``bmm`` and a one-hot combine,
    scatter-free, the reference's einsum pair) and the shards combine by
    a sum on the root: the next-frontier mask, identical in content to
    ``ops.spgemm.expand_mask`` over the unsharded tiles."""
    devs = mesh.model_devices()
    t = int(stiles[0].shape[1])
    parts = []
    for i, d in enumerate(devs):
        with _on_chip(mesh, i, d):
            xb = _to(x, d).reshape(-1, t)
            contrib = torch.bmm(xb[sbi[i]].unsqueeze(1), stiles[i]).squeeze(1)
            oh = torch.nn.functional.one_hot(sbj[i], xb.shape[0]).to(x.dtype)
            parts.append((oh.t() @ contrib).reshape(-1))
    total = psum(parts, mesh.root)
    return (total > 0).to(x.dtype)
