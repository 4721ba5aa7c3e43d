"""The port's batched set ops, chunked and inline-seg expansions and
degree-classed hop plans against the JAX package (``dgraph_tpu.ops.sets``
and ``dgraph_tpu.ops.batch``), and the batched 2-hop's host-dedup arm
against numpy.

Inputs are drawn from a seed with numpy and go through both packages;
arenas are built by each package from the same edges.  Tolerance: none
(int32 uids, row ids, chunk ids, counts and checksums, byte-equal)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dgraph_tpu import ops as jops
from dgraph_tpu.models import arena as jarena
from dgraph_tpu.ops import batch as jbatch
from dgraph_tpu_torch import bench2hop
from dgraph_tpu_torch import ops as tops
from dgraph_tpu_torch.models import arena as tarena
from dgraph_tpu_torch.ops import batch as tbatch
from dgraph_tpu_torch.ops import slotmap as tslot
from torch_pins import pinned_planner  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402

pytestmark = pytest.mark.usefixtures("pinned_planner")

SENT = tops.SENT
CPU = torch.device("cpu")
SEEDS = [0, 1, 2]


def same(j, t):
    """Byte-equality of a JAX result and a torch result."""
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert j.dtype == t.dtype, (j.dtype, t.dtype)
    assert j.shape == t.shape, (j.shape, t.shape)
    assert j.tobytes() == t.tobytes()


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def rand_set(rng, L, lo=0, hi=90, max_n=50):
    n = int(rng.integers(0, max_n + 1))
    return jops.pad_to(np.unique(rng.integers(lo, hi, size=n)), L)


def arenas(seed, n=600, n_edges=5000, heavy=3000, dense=True):
    """(JAX arena, port arena) from the same edges; one celebrity source
    (uid 17, ``heavy`` extra edges) past the widest gather class."""
    rng = np.random.default_rng(seed)
    src = rng.integers(1, n + 1, size=n_edges)
    dst = rng.integers(1, n + 1, size=n_edges)
    if heavy:
        src = np.concatenate([src, np.full(heavy, 17)])
        dst = np.concatenate([dst, rng.integers(1, n + 1, size=heavy)])
    if dense:
        return (jarena.csr_dense_from_edges(src, dst, n),
                tarena.csr_dense_from_edges(src, dst, n, CPU))
    return jarena.csr_from_edges(src, dst), tarena.csr_from_edges(src, dst, CPU)


# -- set ops ------------------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_unary_set_ops_match_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(12):
        n = int(rng.integers(0, 60))
        raw = rng.integers(-3, 80, size=n).astype(np.int32)
        x = jops.pad_to(raw, jops.bucket(max(1, n)))
        rng.shuffle(x)
        same(jops.compact(jnp.asarray(x)), tops.compact(T(x)))
        same(jops.sort_desc_free(jnp.asarray(x)), tops.sort_desc_free(T(x)))
        same(jops.unique_rows_sorted(jnp.asarray(x)), tops.unique_rows_sorted(T(x)))
        keep = rng.random(len(x)) < 0.5
        same(jops.mask_to_set(jnp.asarray(x), jnp.asarray(keep)),
             tops.mask_to_set(T(x), T(keep)))
        for universe, cap in ((70, 128), (90, 16), (10, 8)):
            same(jops.unique_dense(jnp.asarray(x), universe, cap),
                 tops.unique_dense(T(x), universe, cap))


@pytest.mark.parametrize("lo,hi,cap", [(3, 9, 8), (0, 0, 8), (5, 40, 16), (7, 7, 1)])
def test_range_rows_matches_reference(lo, hi, cap):
    jr, jn = jops.range_rows(jnp.int32(lo), jnp.int32(hi), cap)
    tr, tn = tops.range_rows(lo, hi, cap)
    same(jr, tr)
    same(jn, tn)


# -- rowwise batch ops ----------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_rowwise_set_ops_match_reference(seed):
    rng = np.random.default_rng(seed)
    B, L = 9, 64
    for _ in range(6):
        A = np.stack([rand_set(rng, L) for _ in range(B)])
        Bm = np.stack([rand_set(rng, L) for _ in range(B)])
        A[0, :] = SENT  # an all-SENT row
        Bm[1, :] = SENT
        ja, jb = jnp.asarray(A), jnp.asarray(Bm)
        same(jops.intersect_batch(ja, jb), tops.intersect_batch(T(A), T(Bm)))
        same(jops.difference_batch(ja, jb), tops.difference_batch(T(A), T(Bm)))
        same(jops.member_mask_batch(ja, jb), tops.member_mask_batch(T(A), T(Bm)))
        x = rng.integers(0, 50, size=(6, 48)).astype(np.int32)
        x[2, :] = SENT
        same(jops.sort_unique_batch(jnp.asarray(x)), tops.sort_unique_batch(T(x)))
    mats = np.stack([np.stack([rand_set(rng, 32, hi=60, max_n=20) for _ in range(3)])
                     for _ in range(5)])
    same(jops.union_many_batch(jnp.asarray(mats)), tops.union_many_batch(T(mats)))


def test_intersect_batch_names_each_twin():
    """``ops.intersect_batch`` is the reference's rowwise pairwise
    intersection; the k-way kernel's wrapper is ``ops.kway_intersect_batch``
    (= ``ops.kway.intersect_batch``), held against ``intersect_reference``."""
    from dgraph_tpu_torch.ops import kway

    assert tops.intersect_batch is tbatch.intersect_batch
    assert tops.kway_intersect_batch is kway.intersect_batch
    rng = np.random.default_rng(5)
    for k in (1, 2, 3, 5):
        mat = np.stack([rand_set(rng, 64, hi=40, max_n=45) for _ in range(k)])
        want = jops.pad_to(np.array(jops.intersect_reference(mat)), 64)
        same(want, tops.kway_intersect_batch(T(mat)[None])[0])


# -- expand_filter_compact ------------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_expand_filter_compact_matches_reference(seed):
    ja, ta = arenas(seed)
    rng = np.random.default_rng(seed + 10)
    for trial in range(6):
        f = np.unique(rng.integers(1, 601, size=int(rng.integers(1, 60))))
        cap = jops.bucket(max(1, int(ja.degree_of_rows(f).sum())))
        rows = jops.pad_rows(f, jops.bucket(len(f)))
        knp = [jops.pad_to(np.unique(rng.integers(1, 601, size=int(rng.integers(0, 400)))),
                           512) for _ in range(trial % 3)]
        cap_out = cap // 2 if trial % 2 else None
        ju, jt = jops.expand_filter_compact(
            ja.offsets, ja.dst, jnp.asarray(rows), cap,
            tuple(jnp.asarray(k) for k in knp), cap_out)
        tu, tt = tops.expand_filter_compact(
            ta.offsets, ta.dst, T(rows), cap, tuple(T(k) for k in knp), cap_out)
        same(ju, tu)
        same(jt, tt)


def test_expand_filter_compact_batch_matches_reference():
    ja, ta = arenas(4)
    rng = np.random.default_rng(9)
    B, L = 6, 64
    fs = [np.unique(rng.integers(1, 601, size=30)) for _ in range(B)]
    rows = np.stack([jops.pad_rows(f, L) for f in fs])
    cap = jops.bucket(max(int(ja.degree_of_rows(f).sum()) for f in fs))
    keep = jops.pad_to(np.unique(rng.integers(1, 601, size=300)), 512)
    ju, jt = jops.expand_filter_compact_batch(
        ja.offsets, ja.dst, jnp.asarray(rows), cap, (jnp.asarray(keep),))
    tu, tt = tops.expand_filter_compact_batch(
        ta.offsets, ta.dst, T(rows), cap, (T(keep),))
    same(ju, tu)
    same(jt, tt)


# -- the chunked layout and expand_chunked ----------------------------------------


@pytest.mark.parametrize("dense", [True, False])
def test_chunked_layout_matches_reference(dense):
    ja, ta = arenas(3, dense=dense)
    for j, t in zip(ja.chunked(), ta.chunked()):
        same(j, t)
    rows = np.array([-1, 0, 17, 5, 10_000 % ja.n_rows], dtype=np.int64)
    assert np.array_equal(ja.chunk_degree_of_rows(rows), ta.chunk_degree_of_rows(rows))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("with_seg", [False, True])
def test_expand_chunked_matches_reference(seed, with_seg):
    ja, ta = arenas(seed)
    jm, jc = ja.chunked()
    tm, tc = ta.chunked()
    rng = np.random.default_rng(seed + 20)
    for trial in range(8):
        f = np.unique(rng.integers(1, 601, size=int(rng.integers(1, 80))))
        rows = jops.pad_rows(f, jops.bucket(len(f) + 3))
        rng.shuffle(rows[len(f):])
        if trial % 2:  # -1 skips among the valid rows, keeping them ascending
            rows = np.insert(f, rng.integers(0, len(f) + 1, size=3), -1).astype(np.int32)
        need = int(ja.chunk_degree_of_rows(f).sum())
        capc = jops.bucket(max(1, need)) if trial % 3 else max(1, need // 2)
        jo, jt, js = jops.expand_chunked(jm, jc, jnp.asarray(rows), capc, with_seg)
        to, tt, ts = tops.expand_chunked(tm, tc, T(rows), capc, with_seg)
        same(jo, to)
        same(jt, tt)
        if with_seg:
            same(js, ts)
        else:
            assert js is None and ts is None


# -- expand_inline_seg ------------------------------------------------------------


def _inline_case(ja, ta, rows, capc):
    jm, jo = ja.inline_layout()
    tm, to = ta.inline_layout()
    got = tops.expand_inline_seg(tm, to, T(rows), capc)
    want = jops.expand_inline_seg(jm, jo, jnp.asarray(rows), capc)
    for j, t in zip(want, got):
        same(j, t)


@pytest.mark.parametrize("seed", SEEDS)
def test_expand_inline_seg_matches_reference(seed):
    ja, ta = arenas(seed)
    rng = np.random.default_rng(seed + 30)
    for trial in range(8):
        f = np.unique(rng.integers(1, 601, size=int(rng.integers(1, 120))))
        if trial == 0:
            f = np.array([17])  # the celebrity row alone
        need = int(ja.ov_chunk_degree_of_rows(f).sum())
        rows = jops.pad_rows(f, jops.bucket(len(f)))
        if trial % 2:  # -1 skips anywhere among the ascending rows
            rows = np.insert(f, rng.integers(0, len(f) + 1, size=4), -1)
            rows = jops.pad_rows(rows, jops.bucket(len(rows)))
        _inline_case(ja, ta, rows, jops.bucket(max(1, need)))


def test_expand_inline_seg_truncates_at_capc():
    ja, ta = arenas(7)
    f = np.arange(1, 601, 3)
    need = int(ja.ov_chunk_degree_of_rows(f).sum())
    assert need > 16
    for capc in (1, 8, need // 2, need - 1):
        _inline_case(ja, ta, jops.pad_rows(f, jops.bucket(len(f))), capc)


def test_expand_inline_seg_over_an_empty_arena():
    e = np.zeros(0, np.int64)
    ja = jarena.csr_dense_from_edges(e, e, 10)
    ta = tarena.csr_dense_from_edges(e, e, 10, CPU)
    _inline_case(ja, ta, jops.pad_rows(np.array([1, 4, 9]), 8), 8)
    _inline_case(ja, ta, np.full(8, -1, np.int32), 8)


def test_expand_inline_seg_slot_map_goes_through_the_kernel_wrapper(monkeypatch):
    """The inline route's slot map is the slot-map kernel's wrapper with
    Q = 1 (on the CPU its plain version)."""
    calls = []
    real = tslot.slotmap

    def counting(cs, cd, capc):
        calls.append(tuple(cs.shape))
        return real(cs, cd, capc)

    monkeypatch.setattr(tslot, "slotmap", counting)
    _ja, ta = arenas(1)
    tm, to = ta.inline_layout()
    tops.expand_inline_seg(tm, to, T(jops.pad_rows(np.arange(1, 40), 64)), 64)
    assert calls == [(1, 64)]


@pytest.mark.parametrize("seed", SEEDS)
def test_grouped_auto_matches_reference(seed, monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_SLOTMAP", "0")
    rng = np.random.default_rng(seed)
    src = rng.integers(1, 500, size=6000)
    dst = rng.integers(1, 500, size=6000)
    ja = jarena.csr_dense_from_edges(src, dst, 500)
    ta = tarena.csr_dense_from_edges(src, dst, 500, CPU)
    jm, jo = ja.inline_layout_grouped()
    tm, to = ta.inline_layout_grouped()
    deg = ja.h_offsets[1:] - ja.h_offsets[:-1]
    f = np.unique(rng.integers(1, 500, size=100))
    key = jops.skey_encode(f, deg[f] > jops.INLINE)
    f = f[np.argsort(key, kind="stable")]
    pcap = jops.bucket(max(1, int((deg[f] > jops.INLINE).sum())))
    capc = jops.bucket(max(1, int(ja.ov_chunk_degree_of_rows(f).sum())))
    rows = jops.pad_rows(f, jops.bucket(len(f)))
    want = jops.expand_inline_grouped_auto(jm, jo, jnp.asarray(rows), capc, pcap)
    got = tops.expand_inline_grouped_auto(tm, to, T(rows), capc, pcap)
    for j, t in zip(want, got):
        same(j, t)


# -- ClassedExpander ----------------------------------------------------------------


@pytest.fixture(scope="module")
def dense_pair():
    return arenas(5)


def test_classed_expander_shape_matches_reference(dense_pair):
    ja, ta = dense_pair
    jce, tce = jops.classed_for_arena(ja), tops.classed_for_arena(ta)
    assert tce.n_cls == jce.n_cls == tbatch.LOG_W_MAX + 1 == jbatch.LOG_W_MAX + 1
    assert tce.widths == jce.widths
    rng = np.random.default_rng(2)
    f = np.unique(rng.integers(1, 601, size=90))
    for jv, tv in zip(jce.class_sort(f), tce.class_sort(f)):
        assert np.array_equal(jv, tv)
    jc, tc = jce.class_counts(f), tce.class_counts(f)
    assert np.array_equal(jc[0], tc[0]) and jc[1:] == tc[1:]
    for fine in (True, False):
        assert jce.plan_caps(*jc, fine=fine) == tce.plan_caps(*tc, fine=fine)


@pytest.mark.parametrize("dense", [True, False])
def test_classed_expand_rows_matches_reference(dense):
    ja, ta = arenas(8, n=900, n_edges=4000, dense=dense)
    jce, tce = jops.classed_for_arena(ja), tops.classed_for_arena(ta)
    rng = np.random.default_rng(4)
    for trial in range(10):
        uids = np.unique(rng.integers(1, 901, size=int(rng.integers(1, 200))))
        if trial == 0:
            uids = np.array([17])  # the heavy row alone
        if trial == 1:
            uids = np.empty(0, dtype=np.int64)
        rows = ja.rows_for_uids_host(uids) if not dense else uids
        jo, jp = jce.expand_rows(rows, ja.degree_of_rows(rows))
        to, tp = tce.expand_rows(rows, ta.degree_of_rows(rows))
        assert jo.dtype == to.dtype and jp.dtype == tp.dtype
        assert np.array_equal(jo, to) and np.array_equal(jp, tp), trial
        want, want_ptr = ja.expand_host(rows)
        assert np.array_equal(to, want) and np.array_equal(tp, want_ptr)


@pytest.mark.parametrize("mode", ["materialize", "checksum", "frontier"])
@pytest.mark.parametrize("batched", [False, True])
def test_classed_programs_match_reference(dense_pair, mode, batched):
    ja, ta = dense_pair
    jce, tce = jops.classed_for_arena(ja), tops.classed_for_arena(ta)
    rng = np.random.default_rng(6)
    fronts = [np.unique(rng.integers(1, 601, size=int(rng.integers(1, 90))))
              for _ in range(4)]
    fronts[1] = np.unique(np.concatenate([fronts[1], [17]]))  # a heavy row
    counts = [jce.class_counts(f) for f in fronts]
    worst = (np.max([c[0] for c in counts], axis=0), max(c[1] for c in counts),
             max(c[2] for c in counts))
    caps = jce.plan_caps(*worst)
    keeps = (jops.pad_to(np.unique(rng.integers(1, 601, size=250)), 256),)
    parts = [jce.partition(f, caps)[0] for f in fronts]
    if batched:
        mats = [np.stack([p[k] for p in parts]) for k in range(len(parts[0]))]
        jm, tm = [mats], [mats]
    else:
        jm, tm = parts, parts
    for kk in ((), keeps):
        for jmats, tmats in zip(jm, tm):
            want = jce.program(caps, mode, batched)(
                tuple(jnp.asarray(m) for m in jmats), tuple(jnp.asarray(k) for k in kk))
            got = tce.program(caps, mode)(
                tuple(T(m) for m in tmats), tuple(T(k) for k in kk))
            for j, t in zip(want, got):
                same(j, t)
    assert tce.lanes_of(caps) == jce.lanes_of(caps)


def test_classed_plan_cache_is_bounded(dense_pair):
    """One plan per bucketed capacity tuple and mode: a steady family of
    frontiers reuses its plans (the reference's bound)."""
    _ja, ta = dense_pair
    ta._classed = None  # a fresh expander, an empty plan cache
    ce = tops.classed_for_arena(ta)
    rng = np.random.default_rng(6)
    cap_keys = set()
    for _ in range(20):
        f = np.unique(rng.integers(1, 601, size=64))
        f1 = np.unique(ta.expand_host(f)[0])
        for frontier in (f, f1):
            caps = ce.plan_caps(*ce.class_counts(frontier), fine=False)
            cap_keys.add(caps)
            mats, _pos = ce.partition(frontier, caps)
            ce.program(caps, "materialize")(tuple(T(m) for m in mats), ())
            ce.expand_rows(frontier, ta.degree_of_rows(frontier))
    assert len(ce._programs) <= len(cap_keys)
    assert len(cap_keys) <= 8, cap_keys


def test_arena_owns_its_classed_expander():
    """residency() counts the cached arenas' classed expanders and their
    plans; a delta drops the expander with the chunked layout."""
    from dgraph_tpu_torch.models.store import PostingStore
    from dgraph_tpu_torch.query import QueryEngine

    st = PostingStore()
    eng = QueryEngine(st, device="cpu")
    eng.run("mutation { schema { e: uid . } }")
    rng = np.random.default_rng(3)
    st.bulk_set_uid_edges("e", rng.integers(1, 200, size=2000),
                          rng.integers(1, 200, size=2000))
    a = eng.arenas.data("e")
    assert eng.arenas.residency()["program_caches"]["classed_expanders"] == 0
    ce = tops.classed_for_arena(a)
    ce.expand_rows(np.arange(1, 50), a.degree_of_rows(np.arange(1, 50)))
    a.chunked()
    pc = eng.arenas.residency()["program_caches"]
    assert pc["classed_expanders"] == 1 and pc["classed_programs"] == len(ce._programs) >= 1
    assert tops.classed_for_arena(a) is ce
    a.apply_delta(np.array([[3, 7]]), np.zeros((0, 2), np.int64))
    assert a._classed is None and a._chunked is None
    assert tops.classed_for_arena(a) is not ce


# -- the batched 2-hop's host-dedup arm -----------------------------------------------


def test_host_dedup_arm_matches_numpy():
    """20,000 nodes: every query's edge count and checksum and the last
    query's set equal numpy's 2-hop."""
    a = bench2hop.build_graph(20_000, 200_000, CPU)
    frontiers = bench2hop.draw_frontiers(20_000, 512, 40)
    stats = {}
    _s, edges, chks, last = bench2hop.run_host_dedup(
        a, frontiers, timed=1, warm=False, sub_batch=16, stats=stats)
    h_dst = a.host_dst()
    want = [bench.np_two_hop(a, h_dst, f) for f in frontiers]
    assert np.array_equal(stats["counts"], [n for n, _u, _c in want])
    assert edges == sum(n for n, _u, _c in want)
    assert np.array_equal(chks, np.array([c for _n, _u, c in want], np.int32))
    assert np.array_equal(last, want[-1][1])


def test_host_dedup_plans_once_with_bucket_fine():
    a = bench2hop.build_graph(5_000, 40_000, CPU)
    frontiers = bench2hop.draw_frontiers(5_000, 128, 12)
    stats = {}
    bench2hop.run_host_dedup(a, frontiers, timed=1, warm=False, stats=stats)
    ce = tops.ClassedExpander(a.offsets, a.dst, a.h_offsets)
    c1 = [ce.class_counts(f) for f in frontiers]
    worst = (np.maximum(np.ones(ce.n_cls, np.int64), np.max([c[0] for c in c1], axis=0)),
             max(c[1] for c in c1), max(c[2] for c in c1))
    assert stats["caps1"] == list(ce.plan_caps(*worst, fine=True))
