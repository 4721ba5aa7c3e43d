"""The yardstick on the CPU: the reference, the generators, the byte
count, the trace arithmetic."""

import itertools

import numpy as np
import pytest
import torch

from benchmark import data, reference, roofline, spec, trace

CPU = torch.device("cpu")
pareto = spec.plugin("generators", "pareto_celebrity")
knows = spec.plugin("generators", "knows_chung_lu")
uniform = spec.plugin("pool_laws", "uniform_draws")


def brute_two_hop(src, dst, frontier):
    """Both hops by dicts of sets: (edges, checksum int32, hop-2 set)."""
    out = {}
    for s, d in zip(src.tolist(), dst.tolist()):
        out.setdefault(s, set()).add(d)
    hop1 = [d for u in frontier.tolist() for d in sorted(out.get(u, ()))]
    hop2 = [d for u in sorted(set(hop1)) for d in sorted(out.get(u, ()))]
    chk = np.array(sum(hop2) & 0xFFFFFFFF, np.uint32).view(np.int32)[()]
    return len(hop1) + len(hop2), chk, sorted(set(hop2))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_matches_a_brute_force_walk(seed):
    rng = np.random.default_rng(seed)
    n = 60
    src = rng.integers(1, n + 1, 900)
    dst = rng.integers(1, n + 1, 900)
    csr = reference.build_csr(src, dst, n)
    pool = [np.unique(rng.integers(1, n + 1, k)) for k in (1, 3, 17, 60)]
    c1, c2, chk = reference.answers(csr, pool)
    for i, f in enumerate(pool):
        n_edges, want_chk, want_set = brute_two_hop(src, dst, f)
        got_n, got_chk, got_set = reference.two_hop_set(csr, f)
        assert c1[i] + c2[i] == n_edges == got_n
        assert chk[i] == want_chk == got_chk
        assert got_set.tolist() == want_set


def test_checksum_wraps_like_int32():
    big = [2**31 - 1, 5, 2**31 + 7]
    assert reference.wrap_int32(sum(big)) == np.array(sum(big) & 0xFFFFFFFF,
                                                      np.uint32).view(np.int32)
    assert reference.wrap_int32(2**31) == -(2**31)
    assert reference.wrap_int32(-1) == -1


def test_edges_are_sets_and_an_empty_frontier_answers_zero():
    src = np.array([1, 1, 1, 2, 3])
    dst = np.array([2, 2, 3, 3, 1])
    csr = reference.build_csr(src, dst, 4)
    assert csr.degree.tolist() == [0, 2, 1, 1, 0]
    assert reference.two_hop(csr, np.array([4])) == (0, 0, 0)
    assert reference.two_hop(csr, np.array([1]))[:2] == (2, 2)


def test_sorted_unique():
    x = np.array([5, 1, 5, 3, 1, 9], np.int64)
    assert reference.sorted_unique(x).tolist() == [1, 3, 5, 9]
    assert reference.sorted_unique(np.empty(0, np.int64)).size == 0


def test_pareto_generator_is_the_frozen_copy_and_deterministic():
    s1, d1 = pareto.gen_edges(5000, 40_000, 7)
    s2, d2 = pareto.gen_edges(5000, 40_000, 7)
    assert np.array_equal(s1, s2) and np.array_equal(d1, d2)
    s3, _ = pareto.gen_edges(5000, 40_000, 8)
    assert not np.array_equal(s1, s3)
    assert s1.min() >= 1 and s1.max() <= 5000 and d1.min() >= 1 and d1.max() <= 5000
    stored = len(reference.build_csr(s1, d1, 5000).dst)
    assert stored == len(np.unique(s1 * 5001 + d1)) < 40_000


def test_knows_generator_exact_undirected_and_deterministic():
    args = (2000, 30_000, 1.14, 500, 1.05)
    s1, d1 = knows.knows_edges(*args, 11, CPU)
    s2, d2 = knows.knows_edges(*args, 11, CPU)
    assert np.array_equal(s1, s2) and np.array_equal(d1, d2)
    assert len(s1) == 2 * 30_000
    assert not np.any(s1 == d1)
    keys = set(zip(s1.tolist(), d1.tolist()))
    assert len(keys) == 2 * 30_000                      # distinct pairs
    assert all((d, s) in keys for s, d in itertools.islice(keys, 5000))  # both ways
    deg = np.bincount(s1, minlength=2001)[1:]
    assert abs(deg.mean() - 30.0) < 1e-9 and deg.max() > 3 * np.median(deg)
    s3, _ = knows.knows_edges(*args, 12, CPU)
    assert not np.array_equal(s1, s3)


def test_uniform_pool_law_is_the_frozen_copy_and_deterministic():
    a = uniform.draw(500, {"pool": 6, "pool_seed": 3, "seeds_per_query": 40})
    b = uniform.draw_frontiers(500, 40, 6, 3)
    assert len(a) == 6 and all(np.array_equal(x, y) for x, y in zip(a, b))
    assert all(np.all(np.diff(f) > 0) and f.min() >= 1 and f.max() <= 500 for f in a)
    c = uniform.draw(500, {"pool": 6, "pool_seed": 4, "seeds_per_query": 40})
    assert not all(np.array_equal(x, y) for x, y in zip(a, c))


def test_inputs_same_structure_for_every_seed():
    cfg = {"generator": "pareto_celebrity", "nodes": 3000,
           "generated_edges": 30_000, "structure_seed": 7}
    tr = {"pool_law": "uniform_draws", "pool": 20, "pool_seed": 3,
          "seeds_per_query": 64}
    a = data.build_inputs(cfg, tr, 2**31 + 5, CPU)
    b = data.build_inputs(cfg, tr, 2**31 + 5, CPU)
    c = data.build_inputs(cfg, tr, 99, CPU)
    assert np.array_equal(a.src, b.src) and all(
        np.array_equal(x, y) for x, y in zip(a.pool, b.pool))
    assert not np.array_equal(a.src, c.src)
    ca, cc = (reference.build_csr(x.src, x.dst, 3000) for x in (a, c))
    assert sorted(ca.degree.tolist()) == sorted(cc.degree.tolist())
    ra, rc = reference.answers(ca, a.pool), reference.answers(cc, c.pool)
    assert sorted((ra[0] + ra[1]).tolist()) == sorted((rc[0] + rc[1]).tolist())
    assert all(np.all(np.diff(f) > 0) for f in a.pool)


def test_slotmap_bytes_at_the_seed3_plan():
    # synth21m's plan over bench.py's seed-3 stream: Q 200, hop 1 pcap
    # 3072 / capc 3328, hop 2 pcap 16,384 / capc 16,384.  By hand: cs and
    # cd int32[Q, pcap] read once, the map int32[Q, capc] written once.
    hop1 = 200 * 3072 * 4 + 200 * 3072 * 4 + 200 * 3328 * 4
    hop2 = 200 * 16384 * 4 * 3
    assert roofline.slotmap_bytes(200, 3072, 3328) == hop1 == 7_577_600
    assert roofline.slotmap_bytes(200, 16384, 16384) == hop2 == 39_321_600


def test_interval_union_and_idle_gaps():
    assert trace.union_us([(0, 10), (5, 20), (30, 40)]) == 30
    assert trace.merged([(5, 20), (0, 10), (30, 40)]) == [(0, 20), (30, 40)]
    t = trace.Trace(
        device=[("k1", 10, 40), ("k2", 35, 60), ("k3", 80, 100)],
        host=[(trace.WINDOW, 0, 120), ("bench.wait", 60, 90),
              ("aten::sort", 0, 12), ("cudaLaunchKernel", 62, 66)],
        window=(0, 120), batches=2)
    for n, s, e in t.device:
        t.by_name[n] = t.by_name.get(n, 0.0) + (e - s) / 1e6
    assert t.busy_s == pytest.approx(70e-6)
    assert t.window_s == pytest.approx(120e-6)
    gaps = dict(trace.idle_gaps(t))
    assert gaps["aten::sort"] == pytest.approx(10e-6)          # 0..10
    assert gaps["bench.wait"] == pytest.approx(20e-6)          # 60..80
    assert gaps["host outside any traced range"] == pytest.approx(20e-6)  # 100..120
    assert trace.top_ops(t)[0] == ["k1", pytest.approx(30e-6)]
