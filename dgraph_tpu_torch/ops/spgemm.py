"""Tile join tier: blocked boolean tile products over a predicate's
adjacency (the PyTorch port of ``dgraph_tpu/ops/spgemm.py``).

- **`PredTiles`**: a predicate's adjacency as blocked boolean tiles —
  only blocks holding at least one edge are stored, dense
  ``float32[T, T]`` each (T = 128 by default), stacked into one
  ``[Kb, T, T]`` tensor on the arena's device with block coordinates
  ``(bi, bj)``; ``Kb = bucket(K)``, the pad tiles zero at block (0, 0).
  Built lazily from the CSR host mirrors under a byte budget and cached
  on the arena (``models/arena.py`` ``CSRArena.tiles``); the layout and
  ``device_bytes()`` are the reference's, so the arena budget counts
  them alike.
- **`expand_mask`**: frontier mask × adjacency.  The frontier is a
  ``float32[M]`` 0/1 mask over the T-blocked uid space; per stored tile
  the owning block-row of the mask multiplies the tile (one ``bmm``, a
  batched row-times-tile product on the card's matrix units), and the
  contributions combine into block-columns.  Counts > 0 are the next
  frontier: expansion and dedup in one pass, no sort.
- **`run_mask_chain`**: a whole multi-level uid chain over masks that
  stay on the device between levels, each level optionally ANDed with a
  keep mask (a fused ``@filter`` or a cycle-closing set); per-level edge
  totals are a degree-vector dot.
- **`triangle_mask`**: two legs and the closing predicate's reverse
  tiles, ``z = ((x·A)·B) ∧ (x·C_rev)``.
- **`intersect_stack(_batch)`**: the k-way intersection of sorted-unique,
  ``SENT``-padded uid sets — calls of ``ops.kway.intersect_batch`` (the
  intersect kernel on a CUDA tensor), so the k-way intersection keeps
  one implementation.

The combine.  The reference combines the ``[K, T]`` contributions into
block-columns with a one-hot matmul (``[Kb, NB] @ [Kb, T]``: XLA's
scatter serialises on its device).  Here it is one ``index_add_`` of
the contributions into ``[NB, T]`` by ``bj``: the same function
without the ``[Kb, NB]`` operand.  Every tile and mask is 0/1, so each
product and each sum is an integer far below 2^24: float32 holds them
exactly in any order of summation, atomics included, and the masks
equal the reference's bit for bit.

No hand kernel: the reference computes these products outside any
Pallas kernel, so the port leaves them to torch's ``bmm`` and
``index_add_`` on the card.  Device placement follows the tensors: the
tiles live on the arena's device, and every function runs where its
inputs are.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dgraph_tpu_torch.device import resolve
from dgraph_tpu_torch.ops.kway import intersect_batch
from dgraph_tpu_torch.ops.sets import SENT, bucket
from dgraph_tpu_torch.utils import planconfig


def tile_size() -> int:
    """Tile edge length (uids per block side), DGRAPH_TPU_TILE."""
    return planconfig.tile_size()


def tile_budget() -> int:
    """Per-arena tile byte budget (DGRAPH_TPU_TILE_BUDGET, 256 MiB):
    an arena whose stored blocks would exceed it is never densified, and
    the join planner keeps it on the gather tier."""
    return planconfig.tile_budget()


def mask_lanes(universe: int, t: Optional[int] = None) -> int:
    """Mask length covering ``universe`` uids: the block count bucketed
    to a power of two, times T."""
    t = t or tile_size()
    nb = max(1, -(-int(universe) // t))
    return bucket(nb) * t


@dataclass
class PredTiles:
    """One predicate's adjacency as stacked dense boolean tiles."""

    bi: torch.Tensor      # int32[Kb] block-row of each stored tile
    bj: torch.Tensor      # int32[Kb] block-col of each stored tile
    tiles: torch.Tensor   # float32[Kb, T, T]; zero pad tiles beyond n_tiles
    degs: torch.Tensor    # int32[nb*T] out-degree per uid (edge totals)
    t: int                # tile edge length
    nb: int               # block count covering this arena's own uids
    n_tiles: int          # true (non-pad) tile count
    universe: int         # max uid + 1 over this arena's src ∪ dst

    def device_bytes(self) -> int:
        return sum(
            a.numel() * a.element_size()
            for a in (self.bi, self.bj, self.tiles, self.degs)
        )


def _edge_uids(h_src, h_offsets, h_dst) -> Tuple[np.ndarray, np.ndarray]:
    deg = (h_offsets[1:] - h_offsets[:-1]).astype(np.int64)
    u = np.repeat(np.asarray(h_src, dtype=np.int64), deg)
    return u, np.asarray(h_dst, dtype=np.int64)


def count_tile_blocks(
    h_src: np.ndarray, h_offsets: np.ndarray, h_dst: np.ndarray, t: int
) -> Tuple[int, int]:
    """(non-empty block count, universe) of a CSR without building its
    tiles: the planner prices a build (K·T·T·4 bytes) before it commits
    to one."""
    if len(h_dst) == 0:
        return 0, 0
    u, v = _edge_uids(h_src, h_offsets, h_dst)
    universe = int(max(u.max(), v.max())) + 1
    nb = -(-universe // t)
    keys = (u // t) * nb + (v // t)
    return int(len(np.unique(keys))), universe


def est_tile_bytes(n_blocks: int, t: int) -> int:
    """Device bytes a tile set of ``n_blocks`` stored blocks costs."""
    kb = bucket(max(1, n_blocks))
    return kb * t * t * 4 + 2 * kb * 4


def build_tiles(
    h_src: np.ndarray,
    h_offsets: np.ndarray,
    h_dst: np.ndarray,
    t: Optional[int] = None,
    budget_bytes: Optional[int] = None,
    device=None,
) -> Optional[PredTiles]:
    """Densify a CSR's non-empty blocks into a PredTiles on ``device``
    (default cuda), or None when the footprint would exceed the byte
    budget or the CSR has no edge.  The block keys are computed on the
    host; the stack is allocated on the device and its edges set by one
    ``index_put_`` of their flat positions."""
    dev = resolve(device)
    t = t or tile_size()
    budget = tile_budget() if budget_bytes is None else budget_bytes
    if len(h_dst) == 0:
        return None
    n_blocks, universe = count_tile_blocks(h_src, h_offsets, h_dst, t)
    if est_tile_bytes(n_blocks, t) > budget:
        return None
    nb = -(-universe // t)
    u, v = _edge_uids(h_src, h_offsets, h_dst)
    keys = (u // t) * nb + (v // t)
    uniq, tid = np.unique(keys, return_inverse=True)
    K = len(uniq)
    Kb = bucket(max(1, K))
    tiles = torch.zeros((Kb, t, t), dtype=torch.float32, device=dev)
    flat = (tid.reshape(-1).astype(np.int64) * t + u % t) * t + v % t
    tiles.view(-1)[torch.from_numpy(flat).to(dev)] = 1.0
    bi = np.zeros(Kb, dtype=np.int32)
    bj = np.zeros(Kb, dtype=np.int32)
    bi[:K] = (uniq // nb).astype(np.int32)
    bj[:K] = (uniq % nb).astype(np.int32)
    degv = np.zeros(nb * t, dtype=np.int32)
    # universe spans edge ENDPOINTS; degree-0 rows beyond it have no
    # edges to account for
    deg = (h_offsets[1:] - h_offsets[:-1]).astype(np.int64)
    hs = np.asarray(h_src, dtype=np.int64)
    sel = hs < nb * t
    degv[hs[sel]] = deg[sel].astype(np.int32)
    return PredTiles(
        bi=torch.from_numpy(bi).to(dev),
        bj=torch.from_numpy(bj).to(dev),
        tiles=tiles,
        degs=torch.from_numpy(degv).to(dev),
        t=t,
        nb=nb,
        n_tiles=K,
        universe=universe,
    )


def apply_tile_delta(
    pt: PredTiles, adds: np.ndarray, dels: np.ndarray
) -> Optional[PredTiles]:
    """Apply (src, dst) uid-edge deltas to the stored blocks in place:
    one ``index_put_`` on the ``[Kb, T, T]`` stack (1.0 for adds, 0.0
    for dels) and one on the degree vector, instead of dropping the tiles
    and paying a full rebuild at the next join.

    Returns ``pt`` repaired, or None when repair is structurally
    impossible and the caller must rebuild: an edge lands outside the
    block grid (the universe grew) or an ADD lands in a block that was
    never stored (densifying a new block IS the rebuild).  A delete that
    empties a block keeps the zero block; it adds nothing to any product.

    In place is safe where the arena manager calls it: a delta is applied
    only after the mutation that made it, under the server's write lock,
    and before any later reader takes the tiles (the reference replaces
    its immutable arrays instead).  The densified adjacency and the
    degree vector then equal ``build_tiles`` over the post-delta CSR."""
    t, nb = pt.t, pt.nb
    parts = []
    for arr, val in ((adds, 1.0), (dels, 0.0)):
        if len(arr):
            a = np.asarray(arr, dtype=np.int64).reshape(-1, 2)
            parts.append((a[:, 0], a[:, 1], np.full(len(a), val, np.float32)))
    if not parts:
        return pt
    u = np.concatenate([p[0] for p in parts])
    v = np.concatenate([p[1] for p in parts])
    vals = np.concatenate([p[2] for p in parts])
    if int(u.max()) >= nb * t or int(v.max()) >= nb * t or u.min() < 0 or v.min() < 0:
        return None  # universe grew past the block grid
    keys = (u // t) * nb + (v // t)
    # host repair of the tile index: reads the block coordinates the build
    # made synchronously, as the reference's np.asarray
    # graftlint: ignore[naked-device-sync]
    hbi, hbj = torch.stack(
        [pt.bi[: pt.n_tiles], pt.bj[: pt.n_tiles]]
    ).cpu().numpy().astype(np.int64)
    skeys = hbi * nb + hbj  # np.unique build order: ascending
    pos = np.searchsorted(skeys, keys)
    pos = np.clip(pos, 0, max(0, len(skeys) - 1))
    if len(skeys) == 0 or not bool(np.all(skeys[pos] == keys)):
        return None  # some edge's block was never materialized
    dev = pt.tiles.device
    flat = (pos * t + u % t) * t + v % t
    pt.tiles.view(-1)[torch.from_numpy(flat).to(dev)] = (
        torch.from_numpy(vals).to(dev)
    )
    rows = []
    signs = []
    for arr, sign in ((adds, 1), (dels, -1)):
        if len(arr):
            a = np.asarray(arr, dtype=np.int64).reshape(-1, 2)
            rows.append(a[:, 0])
            signs.append(np.full(len(a), sign, np.int32))
    pt.degs.index_put_(
        (torch.from_numpy(np.concatenate(rows)).to(dev),),
        torch.from_numpy(np.concatenate(signs)).to(dev),
        accumulate=True,
    )
    pt.universe = max(pt.universe, int(u.max()) + 1, int(v.max()) + 1)
    return pt


# -- mask algebra -------------------------------------------------------------


def _tile_counts(bi, bj, tiles, x):
    """Blocked boolean SpMV: path counts per target uid, for one mask
    ``x`` [M] or a batch [B, M].  Per stored tile, the mask's block-row
    times the tile (one ``bmm`` over the tiles); the contributions add
    into their block-columns by one ``index_add_``."""
    t = tiles.shape[1]
    xs = x.reshape(-1, x.shape[-1])                 # [B, M]
    b = xs.shape[0]
    xb = xs.reshape(b, -1, t)                       # [B, NB, T]
    rows = xb.index_select(1, bi).transpose(0, 1)   # [Kb, B, T]
    contrib = torch.bmm(rows, tiles)                # [Kb, B, T]
    out = torch.zeros((xb.shape[1], b, t), dtype=x.dtype, device=x.device)
    out.index_add_(0, bj, contrib)
    return out.transpose(0, 1).reshape(x.shape)


def expand_counts(bi, bj, tiles, x):
    """Path counts per uid for a frontier mask (the SpGEMM row)."""
    return _tile_counts(bi, bj, tiles, x)


def _expand(bi, bj, tiles, x):
    return (_tile_counts(bi, bj, tiles, x) > 0).to(x.dtype)


def expand_mask(bi, bj, tiles, x):
    """Next-frontier mask for frontier mask ``x``: expansion and dedup in
    one pass (counts > 0)."""
    return _expand(bi, bj, tiles, x)


def expand_mask_batch(bi, bj, tiles, x):
    """A [B, M] batch of frontier masks expanded together."""
    return _expand(bi, bj, tiles, x)


def uids_to_mask(uids: torch.Tensor, m: int) -> torch.Tensor:
    """Padded uid vector → float32 0/1 mask of length ``m`` on its
    device: padding, negatives and uids ≥ m go to the spare slot ``m``
    of an ``m + 1`` buffer and drop."""
    ok = (uids != SENT) & (uids >= 0) & (uids < m)
    slot = torch.where(ok, uids, torch.full_like(uids, m)).long()
    out = torch.zeros(m + 1, dtype=torch.float32, device=uids.device)
    out[slot] = 1.0
    return out[:m]


def intersect_masks(stack: torch.Tensor) -> torch.Tensor:
    """AND of k stacked masks as one product: a ones-row matmul sums the
    stack; lanes where every mask fired sum to k."""
    k = stack.shape[0]
    ones = torch.ones((1, k), dtype=stack.dtype, device=stack.device)
    return ((ones @ stack)[0] >= k).to(stack.dtype)


def intersect_stack(mat: torch.Tensor) -> torch.Tensor:
    """k-way intersection of the rows of a [K, L] sorted-unique,
    SENT-padded int32 matrix (one intersect call)."""
    return intersect_batch(mat.unsqueeze(0))[0]


def intersect_stack_batch(mat: torch.Tensor) -> torch.Tensor:
    """[B, K, L] → [B, L]: B independent k-way intersections, one call."""
    return intersect_batch(mat)


# -- fused multi-level chain (generic join) -----------------------------------


def run_mask_chain(
    tile_ops: Sequence[tuple],
    keeps: Sequence[Optional[torch.Tensor]],
    degvs: Sequence[torch.Tensor],
    x0: torch.Tensor,
):
    """A whole uid chain over device-resident masks.

    tile_ops: per-level (bi, bj, tiles).
    keeps:    per-level keep masks (float32[M]) or None — a fused
              ``@filter`` keep-set or a cycle-closing set, applied right
              after the level's expansion.
    degvs:    per-level int32 degree vectors (arena-sized; the entering
              mask's prefix dots with it for the level's TRUE edge total).
    x0:       float32[M] root frontier mask.

    Returns (masks float32[L, M], the post-filter frontier of each level;
    totals int32[L]), both on the masks' device."""
    x = x0
    masks = []
    totals = []
    for (bi, bj, tiles), keep, dg in zip(tile_ops, keeps, degvs):
        nd = dg.shape[0]
        totals.append(torch.where(x[:nd] > 0, dg, 0).sum())
        y = _expand(bi, bj, tiles, x)
        if keep is not None:
            y = y * keep
        masks.append(y)
        x = y
    return torch.stack(masks), torch.stack(totals).to(torch.int32)


# -- fused triangle / cycle closing -------------------------------------------


def triangle_mask(bi1, bj1, t1, bi2, bj2, t2, bic, bjc, tc, x):
    """Legs ``y = x·A`` and ``z = y·B`` from root mask ``x``, closing set
    ``w = x·C`` where C is the CLOSING predicate's REVERSE adjacency
    (uids with a closing edge into some root): the mask of leaf uids that
    close a cycle.  ``x`` is one mask [M] or a batch [B, M]."""
    y = _expand(bi1, bj1, t1, x)
    z = _expand(bi2, bj2, t2, y)
    w = _expand(bic, bjc, tc, x)
    return z * w


def triangle_mask_batch(bi1, bj1, t1, bi2, bj2, t2, bic, bjc, tc, x):
    """[B, M] root masks → [B, M] closing masks."""
    return triangle_mask(bi1, bj1, t1, bi2, bj2, t2, bic, bjc, tc, x)


# -- host conversions ---------------------------------------------------------


def mask_to_uids(mask) -> np.ndarray:
    """Host boundary: 0/1 mask (tensor or array) → ascending int64 uids."""
    if isinstance(mask, torch.Tensor):
        # the tile tier's host boundary, as the reference's mask_to_uids
        # np.asarray: the mask is the served result
        # graftlint: ignore[naked-device-sync]
        mask = mask.cpu().numpy()
    return np.flatnonzero(np.asarray(mask) > 0).astype(np.int64)
