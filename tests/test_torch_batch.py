"""The port's multi-hop primitives (``dgraph_tpu_torch/ops/batch.py``:
``expand_ascending``, ``multi_hop``) against the reference's
(``dgraph_tpu.ops.batch``), and the arena's uid->row table and planning
bounds (``CSRArena.lut``, ``n_distinct_dst``, ``topm_deg_cumsum``)
against the reference arena's.

Inputs are numpy draws from a seed: a dense arena (row i == uid i) with
one row far heavier than the rest, and a sparse arena (rows only for
uids 1..300, targets up to 600, so half the targets own no row) with a
tail whose second hop drains the frontier.  Hops run with and without
the visited set and with and without the table.  On the CPU the port's
hops run the gather's plain version; ``tests/test_torch_cuda.py`` holds
the card's run against it.  Tolerance: none (int32 outputs, equal)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dgraph_tpu import ops as jops
from dgraph_tpu.models import arena as jarena
from dgraph_tpu_torch import ops as tops
from dgraph_tpu_torch.models import arena as tarena

SENT = tops.SENT


def _edges(seed):
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(1, 301, size=2500), np.full(900, 17),
                          rng.integers(700, 711, size=200)])
    dst = np.concatenate([rng.integers(1, 601, size=2500),
                          rng.integers(1, 601, size=900),
                          rng.integers(900, 951, size=200)])
    return src, dst


@pytest.fixture(scope="module", params=["dense", "sparse"])
def pair(request):
    """(reference arena, port arena, kind) over one edge draw."""
    src, dst = _edges(5)
    if request.param == "dense":
        return (jarena.csr_dense_from_edges(src, dst, 1000),
                tarena.csr_dense_from_edges(src, dst, 1000, "cpu"), "dense")
    return (jarena.csr_from_edges(src, dst),
            tarena.csr_from_edges(src, dst, "cpu"), "sparse")


def _rows(a, kind, f):
    return f if kind == "dense" else a.rows_for_uids_host(f)


@pytest.mark.parametrize("trial", range(6))
def test_expand_ascending_matches_reference(pair, trial):
    ja, ta, kind = pair
    rng = np.random.default_rng(100 + trial)
    f = np.unique(rng.integers(1, 720, size=int(rng.integers(1, 150))))
    if trial == 5:
        f = np.array([500, 650], np.int64)  # no row / degree 0: nothing out
    rows = jops.pad_rows(_rows(ja, kind, f), jops.bucket(len(f)))
    total = int(ja.degree_of_rows(rows).sum())
    for cap in {jops.bucket(max(1, total)), max(8, jops.bucket(max(1, total)) // 4)}:
        jo, jt = jops.expand_ascending(ja.offsets, ja.dst, jnp.asarray(rows), cap)
        to, tt = tops.expand_ascending(ta.offsets, ta.dst, torch.from_numpy(rows), cap)
        assert to.dtype == torch.int32 and tt.dtype == torch.int32
        assert np.array_equal(to.numpy(), np.asarray(jo))
        assert int(tt) == int(jt) == total


@pytest.mark.parametrize("track_visited", [False, True], ids=["plain", "bfs"])
@pytest.mark.parametrize("start", ["random", "heavy", "drains"])
def test_multi_hop_matches_reference(pair, track_visited, start):
    ja, ta, kind = pair
    rng = np.random.default_rng(7)
    f0 = {"random": np.unique(rng.integers(1, 301, size=12)),
          "heavy": np.array([3, 17, 250], np.int64),
          "drains": np.arange(700, 711, dtype=np.int64)}[start]
    n_hops, cap = 4, jops.bucket(ja.n_edges + 1000)
    if kind == "dense":
        jlut = tlut = None
    else:
        jlut, tlut = ja.lut(int(ja.h_src[-1])), ta.lut()
        assert np.array_equal(tlut.numpy(), np.asarray(jlut))
    vis0 = f0 if track_visited else np.empty(0, np.int64)
    jfs, jtot, jvis = jops.multi_hop(
        ja.offsets, ja.dst, jnp.asarray(jops.pad_to(f0, cap)),
        jnp.asarray(jops.pad_to(vis0, cap)), n_hops, cap,
        track_visited=track_visited, lut=jlut)
    tfs, ttot, tvis = tops.multi_hop(
        ta.offsets, ta.dst, torch.from_numpy(tops.pad_to(f0, cap)),
        torch.from_numpy(tops.pad_to(vis0, cap)), n_hops, cap,
        track_visited=track_visited, lut=tlut)
    assert tuple(tfs.shape) == (n_hops, cap) and tuple(ttot.shape) == (n_hops,)
    assert np.array_equal(tfs.numpy(), np.asarray(jfs))
    assert np.array_equal(ttot.numpy(), np.asarray(jtot))
    if track_visited:
        assert np.array_equal(tvis.numpy(), np.asarray(jvis))
    if start == "drains":
        assert (tfs[1:] == SENT).all() and int(ttot[0]) > 0 and int(ttot[1]) == 0


def test_planning_bounds_match_reference(pair):
    """The arena's distinct-target count and top-m degree bound, and the
    table: equal to the reference's at the arena's own last row, and
    mapping uids past its end as the reference's wider table does."""
    from dgraph_tpu.query.chain import _topm_deg_sum as jtopm
    from dgraph_tpu_torch.query.chain import _topm_deg_sum as ttopm

    ja, ta, kind = pair
    assert ta.n_distinct_dst() == ja.n_distinct_dst()
    for m in (0, 1, 5, 300, 10**6):
        assert ttopm(ta, m) == jtopm(ja, m)
    if kind == "sparse":
        from dgraph_tpu_torch.ops.batch import lut_rows

        ja._lut = None
        ta._lut = None
        assert np.array_equal(ta.lut().numpy(),
                              np.asarray(ja.lut(int(ja.h_src[-1]))))
        ja._lut = None
        wide = np.asarray(ja.lut(5000))
        f = np.arange(len(wide), dtype=np.int32)
        assert np.array_equal(lut_rows(ta.lut(), torch.from_numpy(f)).numpy(), wide)
        ja._lut = None  # the fixture is shared: leave no wider table behind


def test_planning_caches_dropped_by_a_delta():
    """A delta that adds a source row renumbers the rows: the table, the
    distinct-target count and the degree bound are rebuilt from the new
    mirrors."""
    src, dst = _edges(9)
    ta = tarena.csr_from_edges(src, dst, "cpu")
    ta.lut()
    nd, cs = ta.n_distinct_dst(), ta.topm_deg_cumsum()
    # 305 has no row yet and sorts before the rows of 700..710
    ta.apply_delta(np.array([[305, 1], [305, 2000]], np.int64),
                   np.empty((0, 2), np.int64))
    assert ta._lut is None and ta._n_distinct_dst is None and ta._topm_deg is None
    fresh = tarena.csr_from_edges(np.append(src, [305, 305]),
                                  np.append(dst, [1, 2000]), "cpu")
    assert np.array_equal(ta.lut().numpy(), fresh.lut().numpy())
    assert ta.n_distinct_dst() == fresh.n_distinct_dst() == nd + 1
    assert np.array_equal(ta.topm_deg_cumsum(), fresh.topm_deg_cumsum())
    assert not np.array_equal(ta.topm_deg_cumsum(), cs)
