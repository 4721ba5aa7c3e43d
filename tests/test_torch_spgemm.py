"""The port's tile join tier (``dgraph_tpu_torch/ops/spgemm.py`` and the
arena's ``tiles`` / ``tile_blocks`` / ``degree_histogram``) against the
reference's ``dgraph_tpu.ops.spgemm``, function by function.

The fixtures are those of ``tests/test_spgemm.py``: T = 8 (so a small
graph spans many blocks) and its ``_rand_csr`` graphs, the same numpy
inputs from a seed handed to both packages.  Every function runs on the
CPU here (torch's ``bmm`` / ``index_add_`` on CPU tensors; the k-way
intersection through the intersect wrapper's plain version); the card
case is in ``tests/test_torch_cuda.py``.

Tolerance: none.  Tiles and masks are 0/1 and every count an integer far
below 2^24, so float32 products are exact in any order: arrays, masks,
totals and uid sets must be equal."""

import numpy as np
import pytest

import jax.numpy as jnp

from dgraph_tpu.models.arena import csr_from_edges as jcsr_from_edges
from dgraph_tpu.ops import spgemm as jsp
from dgraph_tpu_torch.models.arena import csr_from_edges
from dgraph_tpu_torch.ops import spgemm as tsp
from dgraph_tpu_torch.ops.sets import SENT, bucket, pad_to
from dgraph_tpu_torch.utils.metrics import IVM_REPAIRS, JOIN_TILE_BUILDS

import torch
from torch_pins import pinned_planner  # noqa: F401

# every route decision of both planners is pinned (tests/torch_pins.py)
pytestmark = pytest.mark.usefixtures("pinned_planner")

T = 8


@pytest.fixture(autouse=True)
def _small_tiles(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_TILE", str(T))
    yield


def _edges(seed, n=60, e=300):
    """tests/test_spgemm.py's ``_rand_csr`` draws."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, e), rng.integers(0, n, e)


def _pair(seed, n=60, e=300):
    src, dst = _edges(seed, n, e)
    return jcsr_from_edges(src, dst), csr_from_edges(src, dst, "cpu")


def _tiles(a, ja):
    """(port, reference) PredTiles of the same CSR."""
    pt = tsp.build_tiles(a.h_src, a.h_offsets, a.host_dst(), t=T, device="cpu")
    jpt = jsp.build_tiles(ja.h_src, ja.h_offsets, ja.host_dst(), t=T)
    return pt, jpt


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tiles_equal(pt, jpt):
    for f in ("bi", "bj", "tiles", "degs"):
        got, want = _np(getattr(pt, f)), _np(getattr(jpt, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    for f in ("t", "nb", "n_tiles", "universe"):
        assert getattr(pt, f) == getattr(jpt, f), f
    assert pt.device_bytes() == jpt.device_bytes()


def _masks(rng, m, n, b):
    """(port, reference) [b, m] root masks of b random frontiers."""
    x = np.zeros((b, m), np.float32)
    for i in range(b):
        x[i, np.unique(rng.integers(0, n, int(rng.integers(1, 24))))] = 1.0
    return torch.from_numpy(x), jnp.asarray(x)


# ------------------------------------------------------------ tile layout


@pytest.mark.parametrize("seed", range(6))
def test_build_tiles_matches_reference(seed):
    ja, a = _pair(seed, n=40 + 17 * seed, e=200 + 60 * seed)
    assert tsp.count_tile_blocks(a.h_src, a.h_offsets, a.host_dst(), T) == \
        jsp.count_tile_blocks(ja.h_src, ja.h_offsets, ja.host_dst(), T)
    pt, jpt = _tiles(a, ja)
    _assert_tiles_equal(pt, jpt)
    assert pt.tiles.device.type == "cpu"


def test_sizes_and_budget_refusal_match_reference():
    ja, a = _pair(9)
    for k in (0, 1, 7, 8, 9, 1000):
        assert tsp.est_tile_bytes(k, T) == jsp.est_tile_bytes(k, T)
    for uni in (1, 8, 9, 61, 1000):
        assert tsp.mask_lanes(uni, T) == jsp.mask_lanes(uni, T)
    for budget in (1, 1 << 28):
        got = tsp.build_tiles(a.h_src, a.h_offsets, a.host_dst(), t=T,
                              budget_bytes=budget, device="cpu")
        want = jsp.build_tiles(ja.h_src, ja.h_offsets, ja.host_dst(), t=T,
                               budget_bytes=budget)
        assert (got is None) == (want is None)
    empty = np.zeros(1, np.int64)
    assert tsp.build_tiles(np.zeros(0, np.int64), empty, np.zeros(0, np.int32),
                           device="cpu") is None


# ------------------------------------------------------------ mask algebra


@pytest.mark.parametrize("seed", range(4))
def test_expand_counts_and_masks_match_reference(seed):
    ja, a = _pair(seed, n=40 + 17 * seed, e=200 + 60 * seed)
    pt, jpt = _tiles(a, ja)
    m = tsp.mask_lanes(pt.universe, T)
    x, jx = _masks(np.random.default_rng(seed + 100), m, 40 + 17 * seed, 5)
    got = tsp.expand_mask_batch(pt.bi, pt.bj, pt.tiles, x)
    want = jsp.expand_mask_batch(jpt.bi, jpt.bj, jpt.tiles, jx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for i in range(5):
        c = tsp.expand_counts(pt.bi, pt.bj, pt.tiles, x[i])
        jc = jsp.expand_counts(jpt.bi, jpt.bj, jpt.tiles, jx[i])
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        y = tsp.expand_mask(pt.bi, pt.bj, pt.tiles, x[i])
        np.testing.assert_array_equal(y.numpy(), got[i].numpy())
        # and the oracle: unique targets of the frontier
        rows = a.rows_for_uids_host(np.flatnonzero(x[i].numpy()))
        out, _ = a.expand_host(rows)
        np.testing.assert_array_equal(tsp.mask_to_uids(y), np.unique(out))


def test_uids_to_mask_and_mask_to_uids_match_reference():
    m = 64
    weird = np.array([-3, 5, m + 7, SENT, 5, 0, 63, 64], dtype=np.int32)
    for uids in (weird, np.full(16, SENT, np.int32),
                 pad_to(np.arange(0, 64, 3), 32)):
        got = tsp.uids_to_mask(torch.from_numpy(uids), m)
        want = np.asarray(jsp.uids_to_mask(jnp.asarray(uids), m))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(tsp.mask_to_uids(got),
                                      jsp.mask_to_uids(want))
        assert tsp.mask_to_uids(got).dtype == np.int64


def test_intersect_masks_and_stacks_match_reference():
    rng = np.random.default_rng(2)
    stack = (rng.random((4, 64)) < 0.4).astype(np.float32)
    np.testing.assert_array_equal(
        tsp.intersect_masks(torch.from_numpy(stack)).numpy(),
        np.asarray(jsp.intersect_masks(jnp.asarray(stack))))
    for seed in range(4):
        rng = np.random.default_rng(seed)
        b, k = 3, int(rng.integers(2, 9))
        sets = [[np.unique(rng.integers(0, 60, int(rng.integers(1, 50))))
                 for _ in range(k)] for _ in range(b)]
        L = bucket(max(len(s) for row in sets for s in row))
        mat = np.stack([np.stack([pad_to(s, L) for s in row]) for row in sets])
        got = tsp.intersect_stack_batch(torch.from_numpy(mat)).numpy()
        want = np.asarray(jsp.intersect_stack_batch(jnp.asarray(mat)))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tsp.intersect_stack(torch.from_numpy(mat[0])).numpy(),
            np.asarray(jsp.intersect_stack(jnp.asarray(mat[0]))))


@pytest.mark.parametrize("seed", range(3))
def test_run_mask_chain_matches_reference(seed):
    ja, a = _pair(seed + 5)
    pt, jpt = _tiles(a, ja)
    m = tsp.mask_lanes(pt.universe, T)
    rng = np.random.default_rng(seed)
    front = np.zeros(m, np.float32)
    front[np.unique(rng.integers(0, 60, 8))] = 1.0
    keep = np.zeros(m, np.float32)
    keep[np.unique(rng.integers(0, 60, 25))] = 1.0
    ops_t = ((pt.bi, pt.bj, pt.tiles),) * 3
    ops_j = ((jpt.bi, jpt.bj, jpt.tiles),) * 3
    masks, totals = tsp.run_mask_chain(
        ops_t, (None, torch.from_numpy(keep), None), (pt.degs,) * 3,
        torch.from_numpy(front))
    jm, jt = jsp.run_mask_chain(
        ops_j, (None, jnp.asarray(keep), None), (jpt.degs,) * 3,
        jnp.asarray(front))
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jm))
    assert totals.dtype == torch.int32
    np.testing.assert_array_equal(totals.numpy(), np.asarray(jt))


@pytest.mark.parametrize("seed", range(3))
def test_triangle_masks_match_reference(seed):
    rng = np.random.default_rng(seed + 11)
    n = 50 + 10 * seed
    built = []
    for s, d in ((rng.integers(0, n, 260), rng.integers(0, n, 260)),
                 (rng.integers(0, n, 260), rng.integers(0, n, 260)),
                 (rng.integers(0, n, 150), rng.integers(0, n, 150))):
        built.append(_tiles(csr_from_edges(s, d, "cpu"), jcsr_from_edges(s, d)))
    uni = max(p.universe for p, _ in built)
    m = tsp.mask_lanes(uni, T)
    args_t = [x for p, _ in built for x in (p.bi, p.bj, p.tiles)]
    args_j = [x for _, p in built for x in (p.bi, p.bj, p.tiles)]
    x, jx = _masks(rng, m, n, 6)
    got = tsp.triangle_mask_batch(*args_t, x)
    want = jsp.triangle_mask_batch(*args_j, jx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tsp.triangle_mask(*args_t, x[0]).numpy(),
        np.asarray(jsp.triangle_mask(*args_j, jx[0])))


# --------------------------------------------------------------- IVM delta


def _rand_delta(rng, arena, n_uids=48, k_add=6, k_del=6):
    """tests/test_ivm.py's draw: (adds, dels), adds absent, dels present."""
    have = set()
    h_dst = arena.host_dst()
    for i, u in enumerate(arena.h_src):
        for d in h_dst[arena.h_offsets[i]:arena.h_offsets[i + 1]]:
            have.add((int(u), int(d)))
    adds = set()
    while len(adds) < k_add:
        s, d = int(rng.integers(1, n_uids + 8)), int(rng.integers(1, n_uids + 8))
        if s != d and (s, d) not in have:
            adds.add((s, d))
    dels = set(sorted(have)[i] for i in rng.choice(
        len(have), size=min(k_del, len(have)), replace=False))
    to_arr = lambda s: np.array(sorted(s), dtype=np.int64).reshape(-1, 2)  # noqa: E731
    return to_arr(adds), to_arr(dels)


def _dense(pt):
    m = np.zeros((pt.nb * pt.t, pt.nb * pt.t), np.float32)
    tl, bi, bj = _np(pt.tiles), _np(pt.bi), _np(pt.bj)
    for k in range(pt.n_tiles):
        m[bi[k] * pt.t:(bi[k] + 1) * pt.t, bj[k] * pt.t:(bj[k] + 1) * pt.t] += tl[k]
    return m


@pytest.mark.parametrize("seed", range(4))
def test_apply_tile_delta_equals_rebuild_and_reference(seed):
    """In-grid deltas on stored blocks repair in place: the port's
    repaired arrays equal the reference's repair, and the densified
    adjacency and degrees equal a rebuild over the post-delta CSR."""
    rng = np.random.default_rng(100 + seed)
    src = rng.integers(1, 48, 400)
    dst = rng.integers(1, 48, 400)
    keep = src != dst
    a = csr_from_edges(src[keep], dst[keep], "cpu")
    ja = jcsr_from_edges(src[keep], dst[keep])
    pt, jpt = _tiles(a, ja)
    blocks = set(zip(_np(pt.bi)[:pt.n_tiles].tolist(),
                     _np(pt.bj)[:pt.n_tiles].tolist()))
    adds, dels = _rand_delta(rng, a)
    adds = np.array([e for e in adds if (e[0] // T, e[1] // T) in blocks
                     and e[0] < pt.nb * T and e[1] < pt.nb * T],
                    dtype=np.int64).reshape(-1, 2)
    got = tsp.apply_tile_delta(pt, adds, dels)
    want = jsp.apply_tile_delta(jpt, adds, dels)
    assert got is pt and want is not None
    _assert_tiles_equal(got, want)
    a.apply_delta(adds, dels)
    fresh = tsp.build_tiles(a.h_src, a.h_offsets, a.host_dst(), t=T, device="cpu")
    g, w = _dense(got), _dense(fresh)
    n = max(g.shape[0], w.shape[0])
    np.testing.assert_array_equal(np.pad(g, ((0, n - g.shape[0]),) * 2),
                                  np.pad(w, ((0, n - w.shape[0]),) * 2))
    nd = max(got.degs.shape[0], fresh.degs.shape[0])
    np.testing.assert_array_equal(
        np.pad(_np(got.degs), (0, nd - got.degs.shape[0])),
        np.pad(_np(fresh.degs), (0, nd - fresh.degs.shape[0])))


@pytest.mark.parametrize("case", ["new_block", "grown_universe", "empty"])
def test_apply_tile_delta_refusals_match_reference(case):
    rng = np.random.default_rng(7)
    src = np.concatenate([rng.integers(1, 8, 60), rng.integers(40, 47, 60)])
    dst = np.concatenate([rng.integers(1, 8, 60), rng.integers(40, 47, 60)])
    a, ja = csr_from_edges(src, dst, "cpu"), jcsr_from_edges(src, dst)
    pt, jpt = _tiles(a, ja)
    none = np.empty((0, 2), np.int64)
    adds = {"new_block": np.array([[2, 42]]),
            "grown_universe": np.array([[2, 900]]),
            "empty": none}[case]
    got = tsp.apply_tile_delta(pt, adds, none)
    want = jsp.apply_tile_delta(jpt, adds, none)
    assert (got is None) == (want is None) == (case != "empty")


# -------------------------------------------------------------- the arena


def test_arena_tiles_cached_budgeted_and_counted(monkeypatch):
    ja, a = _pair(9)
    assert a.tile_blocks() == ja.tile_blocks()
    monkeypatch.setenv("DGRAPH_TPU_TILE_BUDGET", "1")
    assert a.tiles() is None and a._tiles is None  # refused, not cached
    monkeypatch.setenv("DGRAPH_TPU_TILE_BUDGET", str(1 << 28))
    before = JOIN_TILE_BUILDS.value()
    base = a.device_bytes()
    pt = a.tiles()
    assert pt is not None and a.tiles() is pt
    assert JOIN_TILE_BUILDS.value() == before + 1
    assert a.device_bytes() == base + pt.device_bytes()
    _assert_tiles_equal(pt, ja.tiles())
    # another tile size is another layout
    monkeypatch.setenv("DGRAPH_TPU_TILE", "16")
    assert a.tile_blocks() == ja.tile_blocks()
    assert a.tiles().t == 16


@pytest.mark.parametrize("seed", range(6))
def test_degree_histogram_after_deltas_matches_reference(seed):
    rng = np.random.default_rng(200 + seed)
    src = rng.integers(1, 60, 220)
    dst = rng.integers(1, 60, 220)
    keep = src != dst
    a = csr_from_edges(src[keep], dst[keep], "cpu")
    ja = jcsr_from_edges(src[keep], dst[keep])
    np.testing.assert_array_equal(a.degree_histogram(), ja.degree_histogram())
    for _ in range(2):
        adds, dels = _rand_delta(rng, a, n_uids=60, k_add=8, k_del=8)
        a.apply_delta(adds, dels)
        ja.apply_delta(adds, dels)
        np.testing.assert_array_equal(a._deg_hist, ja._deg_hist)
    # the moved histogram equals a recount
    got = a._deg_hist.copy()
    a._deg_hist = None
    want = a.degree_histogram()
    n = max(len(got), len(want))
    np.testing.assert_array_equal(np.pad(got, (0, n - len(got))),
                                  np.pad(want, (0, n - len(want))))


@pytest.mark.parametrize("mode", ["1", "0"])
def test_arena_delta_repairs_or_drops_tiles(mode, monkeypatch):
    """A delta inside stored blocks repairs the cached tiles in place
    (counted), DGRAPH_TPU_IVM_REPAIR=0 drops them, as the reference
    does; the block count is recounted either way."""
    monkeypatch.setenv("DGRAPH_TPU_IVM_REPAIR", mode)
    ja, a = _pair(3)
    pt, jpt = a.tiles(), ja.tiles()
    a.tile_blocks()
    hbi, hbj = _np(pt.bi), _np(pt.bj)
    u, v = int(hbi[0]) * T, int(hbj[0]) * T
    h_dst = a.host_dst()
    have = {(int(s), int(d)) for i, s in enumerate(a.h_src)
            for d in h_dst[a.h_offsets[i]:a.h_offsets[i + 1]]}
    add = next((u + i, v + j) for i in range(T) for j in range(T)
               if (u + i, v + j) not in have)
    adds = np.array([add], np.int64)
    dels = np.array([sorted(have)[0]], np.int64)
    r0 = IVM_REPAIRS.snapshot().get(("tile", "repaired"), 0)
    a.apply_delta(adds, dels)
    ja.apply_delta(adds, dels)
    assert a._tile_blocks is None
    assert (a._tiles is None) == (ja._tiles is None) == (mode == "0")
    if mode == "1":
        assert a._tiles is pt
        assert IVM_REPAIRS.snapshot()[("tile", "repaired")] == r0 + 1
        _assert_tiles_equal(a._tiles, ja._tiles)
