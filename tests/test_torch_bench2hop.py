"""The batched 2-hop slice of the port against the JAX package: the dense
arena carried across (models/carry.py), its inline layouts, the skey
codec, the inline expansions (1-D and batched, against ``jax.vmap``),
the batched dedup, and the whole pipeline (dgraph_tpu_torch/bench2hop.py)
against ``bench.np_two_hop`` per query and against one run of
``bench._run_device_dedup`` with the Pallas slot-map in interpret mode.

Tolerance: none (int32 uids, chunk ids, counts and checksums, equal)."""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
from dgraph_tpu import ops as jops  # noqa: E402
from dgraph_tpu.models import arena as jarena  # noqa: E402
from dgraph_tpu_torch import bench2hop  # noqa: E402
from dgraph_tpu_torch import ops as tops  # noqa: E402
from dgraph_tpu_torch.models import arena as tarena  # noqa: E402
from dgraph_tpu_torch.models import carry  # noqa: E402
from dgraph_tpu_torch.ops import slotmap as tslot  # noqa: E402
from torch_pins import pinned_planner  # noqa: F401

pytestmark = [
    pytest.mark.pallas_interpret,
    pytest.mark.usefixtures("pinned_planner"),
]

CPU = torch.device("cpu")


def _edges(seed, n, n_edges):
    rng = np.random.default_rng(seed)
    return rng, rng.integers(1, n, size=n_edges), rng.integers(1, n, size=n_edges)


def _carried(seed=9, n=800, n_edges=9000):
    """(rng, JAX dense arena, the port's arena carried from its mirrors)."""
    rng, src, dst = _edges(seed, n, n_edges)
    ja = jarena.csr_dense_from_edges(src, dst, n)
    ta = carry.csr_arena_from_host(ja.h_offsets, ja.host_dst(), ja.n_rows,
                                   ja.n_edges, CPU)
    return rng, ja, ta


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same(want, got):
    for w, g in zip(want, got):
        assert _np(w).dtype == _np(g).dtype
        assert _np(w).shape == _np(g).shape
        assert _np(w).tobytes() == _np(g).tobytes()


def _grouped_frontier(rng, ja, n, size, width=None):
    deg = ja.h_offsets[1:] - ja.h_offsets[:-1]
    f = np.unique(rng.integers(1, n, size=size))
    key = np.asarray(jops.skey_encode(f, deg[f] > jops.INLINE))
    f = f[np.argsort(key, kind="stable")]
    pcap = jops.bucket_fine(int((deg[f] > jops.INLINE).sum()) or 1)
    capc = jops.bucket_fine(int(ja.ov_chunk_degree_of_rows(f).sum()) or 1)
    if width is not None:
        f = jops.pad_rows(f, width)
    return f.astype(np.int32), pcap, capc


# -- the dense arena and its layouts ----------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_arena_matches_reference(seed):
    _, src, dst = _edges(seed, 500, 6000)
    ja = jarena.csr_dense_from_edges(src, dst, 500)
    for ta in (tarena.csr_dense_from_edges(src, dst, 500, CPU),
               carry.csr_arena_from_host(ja.h_offsets, ja.host_dst(), ja.n_rows,
                                         ja.n_edges, CPU)):
        assert np.array_equal(ja.h_src, ta.h_src)
        assert np.array_equal(ja.h_offsets, ta.h_offsets)
        assert np.array_equal(ja.host_dst(), ta.host_dst())
        assert (ja.n_rows, ja.n_edges) == (ta.n_rows, ta.n_edges)
        _same((ja.src, ja.offsets, ja.dst), (ta.src, ta.offsets, ta.dst))
        assert ja.device_bytes() == ta.device_bytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inline_layouts_match_reference(seed):
    rng, ja, ta = _carried(seed, n=600, n_edges=8000)
    base = ta.device_bytes()
    _same(ja.inline_layout_grouped(), ta.inline_layout_grouped())
    _same(ja.inline_layout(), ta.inline_layout())
    # both built on both sides: the footprints count them alike
    assert ja.device_bytes() == ta.device_bytes()
    assert ta.device_bytes() == base + sum(
        t.numel() * 4 for t in ta.inline_layout() + ta.inline_layout_grouped())
    rows = rng.integers(-1, ja.n_rows, size=200)
    assert np.array_equal(ja.ov_chunk_degree_of_rows(rows),
                          ta.ov_chunk_degree_of_rows(rows))


def test_layouts_of_an_edgeless_arena():
    ja = jarena.csr_dense_from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64), 10)
    ta = tarena.csr_dense_from_edges(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                     10, CPU)
    _same(ja.inline_layout(), ta.inline_layout())
    _same(ja.inline_layout_grouped(), ta.inline_layout_grouped())


def test_grouped_layout_refuses_uids_past_the_group_bit():
    src = np.array([1, 2], np.int64)
    dst = np.array([3, 1 << 29], np.int64)
    ja = jarena.csr_dense_from_edges(src, dst, 4)
    ta = tarena.csr_dense_from_edges(src, dst, 4, CPU)
    with pytest.raises(ValueError):
        ja.inline_layout_grouped()
    with pytest.raises(ValueError, match="2\\^29"):
        ta.inline_layout_grouped()
    _same(ja.inline_layout(), ta.inline_layout())  # the fallback still builds


def test_delta_drops_the_inline_layouts():
    _, ja, ta = _carried(4, n=100, n_edges=600)
    ta.inline_layout()
    ta.inline_layout_grouped()
    have = set(ta.host_dst()[ta.h_offsets[1]:ta.h_offsets[2]].tolist())
    new = min(set(range(1, 100)) - have)
    ta.apply_delta(np.array([[1, new]], np.int64), np.zeros((0, 2), np.int64))
    assert ta._inline is None and ta._inline_grouped is None
    metap, _ov = ta.inline_layout()
    assert int(metap[1, 1]) == int(ta.h_offsets[2] - ta.h_offsets[1])


# -- the codec and the small primitives -------------------------------------


def test_constants_and_buckets_match_reference():
    assert (tops.INLINE, tops.GROUP_BIT, tops.GROUP_MASK, tops.SENT) == (
        jops.INLINE, jops.GROUP_BIT, jops.GROUP_MASK, jops.SENT)
    for n in list(range(0, 300)) + [3027, 3083, 15802, 16045, 22008, 1 << 20]:
        assert tops.bucket_fine(n) == jops.bucket_fine(n)


def test_skey_codec_matches_reference():
    rng = np.random.default_rng(3)
    uids = rng.integers(0, 1 << 29, size=5000)
    has_ov = rng.random(5000) < 0.3
    enc = tops.skey_encode(uids, has_ov)
    assert enc.dtype == np.int32
    assert enc.tobytes() == np.asarray(jops.skey_encode(uids, has_ov)).tobytes()
    lanes = np.concatenate([enc, [tops.SENT] * 7]).astype(np.int32)
    got = tops.skey_uid(torch.from_numpy(lanes))
    assert got.numpy().tobytes() == np.asarray(jops.skey_uid(jnp.asarray(lanes))).tobytes()
    assert np.array_equal(got.numpy()[:5000], uids)
    f = np.array([5, tops.SENT, 0, 7, tops.SENT], np.int32)
    _same([jops.frontier_rows(jnp.asarray(f))], [tops.frontier_rows(torch.from_numpy(f))])


def test_batched_sort_unique_matches_vmap():
    rng = np.random.default_rng(8)
    x = rng.integers(0, 60, size=(5, 97)).astype(np.int32)
    x[rng.random(x.shape) < 0.2] = tops.SENT
    want = jax.vmap(jops.sort_unique)(jnp.asarray(x))
    _same([want], [tops.sort_unique(torch.from_numpy(x))])
    _same([jops.sort_unique(jnp.asarray(x[2]))], [tops.sort_unique(torch.from_numpy(x[2]))])


# -- the inline expansions --------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grouped_expansion_matches_reference_1d(seed):
    rng, ja, ta = _carried(seed)
    jm, jov = ja.inline_layout_grouped()
    tm, tov = ta.inline_layout_grouped()
    f, pcap, capc = _grouped_frontier(rng, ja, 800, 96)
    want = jops.expand_inline_grouped(jm, jov, jnp.asarray(f), capc, pcap)
    _same(want, tops.expand_inline_grouped(tm, tov, torch.from_numpy(f), capc, pcap))
    # the kernel route: the wrapper on CPU tensors (its plain version)
    # against the Pallas-backed reference in interpret mode
    pal = jops.expand_inline_grouped_pallas(jm, jov, jnp.asarray(f), capc, pcap)
    _same(want, pal)
    _same(pal, tops.expand_inline_grouped_kernel(tm, tov, torch.from_numpy(f),
                                                 capc, pcap))


def test_plain_inline_expansion_matches_reference():
    rng, ja, ta = _carried(11)
    jm, jov = ja.inline_layout()
    tm, tov = ta.inline_layout()
    f = np.unique(rng.integers(1, 800, size=80)).astype(np.int32)
    rows = jops.pad_rows(f, 128)
    capc = jops.bucket_fine(int(ja.ov_chunk_degree_of_rows(f).sum()) or 1)
    for cap in (capc, max(8, capc // 3)):  # the second truncates
        _same(jops.expand_inline(jm, jov, jnp.asarray(rows), cap),
              tops.expand_inline(tm, tov, torch.from_numpy(rows), cap))


@pytest.mark.parametrize("route", ["chain", "kernel"])
def test_batched_expansion_matches_vmap(route):
    """The reference vmaps the expansion over a query batch; the port's
    batch axis must give the same outputs, with either slot-map."""
    expand = {"chain": tops.expand_inline_grouped,
              "kernel": tops.expand_inline_grouped_kernel}[route]
    rng, ja, ta = _carried(13, n=400, n_edges=4000)
    jm, jov = ja.inline_layout_grouped()
    tm, tov = ta.inline_layout_grouped()
    rowsb = np.stack([_grouped_frontier(rng, ja, 400, 48, width=64)[0]
                      for _ in range(4)])
    pcap, capc = 64, 512
    want = jax.vmap(lambda r: jops.expand_inline_grouped_pallas(
        jm, jov, r, capc, pcap))(jnp.asarray(rowsb))
    _same(want, jax.vmap(lambda r: jops.expand_inline_grouped(
        jm, jov, r, capc, pcap))(jnp.asarray(rowsb)))
    got = expand(tm, tov, torch.from_numpy(rowsb), capc, pcap)
    _same(want, got)
    assert got[0].shape == (4, 64, tops.INLINE) and got[1].shape == (4, capc, 8)


# -- the pipeline -----------------------------------------------------------


def _stream(n=300, n_edges=3000, n_seeds=40, iters=7):
    ta = bench2hop.build_graph(n, n_edges, CPU)
    frontiers = bench2hop.draw_frontiers(n, n_seeds, iters)
    return ta, frontiers, tops.bucket(max(len(f) for f in frontiers))


def _numpy_oracle(a, frontiers):
    res = [bench.np_two_hop(a, a.host_dst(), f) for f in frontiers]
    return (np.array([r[0] for r in res], np.int64),
            np.array([r[2] for r in res], np.int32), res[-1][1])


@pytest.mark.parametrize("chunk_q", [2, 3])
def test_pipeline_matches_numpy_per_query(chunk_q):
    ta, frontiers, fcap = _stream()
    stats = {}
    secs, edges, chks, last_set = bench2hop.run_device_dedup(
        ta, frontiers, fcap, chunk_q=chunk_q, stats=stats)
    want_edges, want_chks, want_last = _numpy_oracle(ta, frontiers)
    assert secs > 0
    assert stats["slotmap_launches_per_pass"] == [0] * 5  # CPU: plain version
    assert np.array_equal(stats["counts"], want_edges)  # every query
    assert edges == int(want_edges.sum())
    assert chks.dtype == np.int32 and np.array_equal(chks, want_chks)
    assert np.array_equal(last_set, want_last)
    assert len(stats["pass_seconds"]) == 5 and stats["plan"]["grouped"]
    # the port's copy of the oracle is the reference's, query for query
    for f in frontiers:
        n1, s1, c1 = bench2hop.np_two_hop(ta, ta.host_dst(), f)
        n2, s2, c2 = bench.np_two_hop(ta, ta.host_dst(), f)
        assert (n1, c1) == (n2, c2) and np.array_equal(s1, s2)


def test_pipeline_matches_the_jax_pipeline(monkeypatch):
    """One run of bench.py's device-dedup arm (Pallas slot-map in
    interpret mode: the JAX package's own knob) on the same arena and
    queries."""
    monkeypatch.setenv("DGRAPH_TPU_SLOTMAP", "force")
    n, iters = 300, 6
    _, src, dst = _edges(21, n, 3000)
    ja = jarena.csr_dense_from_edges(src, dst, n)
    ta = carry.csr_arena_from_host(ja.h_offsets, ja.host_dst(), ja.n_rows,
                                   ja.n_edges, CPU)
    frontiers = bench2hop.draw_frontiers(n, 40, iters)
    fcap = tops.bucket(max(len(f) for f in frontiers))
    _s, j_edges, j_chks, j_last = bench._run_device_dedup(ja, frontiers, fcap)
    _s, t_edges, t_chks, t_last = bench2hop.run_device_dedup(ta, frontiers, fcap,
                                                             chunk_q=4)
    assert t_edges == j_edges
    assert np.asarray(j_chks).tobytes() == t_chks.tobytes()
    assert np.array_equal(np.asarray(j_last), t_last)


def test_pipeline_without_the_group_bit(monkeypatch):
    """The plain inline layout's route (slot-map over every row, identity
    decode) — taken where the uid space is past 2^29."""
    ta, frontiers, fcap = _stream(250, 2500, 32, 5)

    def refuse(self):
        raise ValueError("uid space too large")

    monkeypatch.setattr(ta, "inline_layout_grouped", types.MethodType(refuse, ta))
    stats = {}
    _s, edges, chks, last_set = bench2hop.run_device_dedup(ta, frontiers, fcap,
                                                           chunk_q=2, stats=stats)
    want_edges, want_chks, want_last = _numpy_oracle(ta, frontiers)
    assert not stats["plan"]["grouped"]
    assert stats["plan"]["pcap1"] == fcap
    assert edges == int(want_edges.sum()) and np.array_equal(chks, want_chks)
    assert np.array_equal(last_set, want_last)


@pytest.mark.parametrize("grouped", [True, False])
@pytest.mark.parametrize("q", [1, 2, 5])
def test_two_hop_batch_maps_both_hops_through_the_kernel_wrapper(
        monkeypatch, grouped, q):
    """Each hop of a batch calls the slot-map kernel's wrapper once, at
    the plan's capacities (on the CPU the wrapper runs its plain
    version), and the batch's edge counts and checksums equal numpy's."""
    ta, frontiers, fcap = _stream(250, 2500, 32, q)
    if not grouped:
        def refuse(self):
            raise ValueError("uid space too large")

        monkeypatch.setattr(ta, "inline_layout_grouped",
                            types.MethodType(refuse, ta))
    metap, ov, plan, fmat = bench2hop.prepare(ta, frontiers, fcap)
    assert plan.grouped is grouped
    calls = []
    wrapper = tslot.slotmap

    def counting(cs, cd, capc):
        calls.append((tuple(cs.shape), capc))
        return wrapper(cs, cd, capc)

    monkeypatch.setattr(tslot, "slotmap", counting)
    chks, edges, _out2 = bench2hop.two_hop_batch(metap, ov, fmat, plan)
    assert calls == [((q, plan.pcap1), plan.capo1), ((q, plan.pcap2), plan.capo2)]
    want_edges, want_chks, _want_last = _numpy_oracle(ta, frontiers)
    assert np.array_equal(edges.numpy().astype(np.int64), want_edges)
    assert chks.dtype == torch.int32 and np.array_equal(chks.numpy(), want_chks)


def test_checksum_wraps_like_int32_sums():
    big = np.full((1, 3, 8), (1 << 29) - 1, np.int32)
    inl = torch.from_numpy(big[:, :, :6].copy())
    ov = torch.from_numpy(big)
    total = 3 * 6 * ((1 << 29) - 1) + 3 * 8 * ((1 << 29) - 1)
    want = np.int32(np.int64(total) & 0xFFFFFFFF)
    assert int(bench2hop.checksum(inl, ov, tops.SENT)[0]) == int(want)


def test_entry_point_prints_its_json_line():
    env = dict(os.environ, BENCH_NODES="2000", BENCH_EDGES="20000",
               BENCH_SEEDS="64", BENCH_ITERS="9")
    r = subprocess.run(
        [sys.executable, "-m", "dgraph_tpu_torch.bench2hop", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["metric"] == "edges_traversed_per_sec_2hop"
    assert out["unit"] == "edges/s" and out["value"] > 0 and out["vs_baseline"] > 0
    assert out["hop_dedup"] == "device" and out["slotmap_launches"] == 0
    assert out["platform"] == "cpu" and out["device"] == "cpu"


def test_entry_point_defaults_to_the_card():
    """Without --device the entry point asks for cuda, and without a GPU
    it fails instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device exists")
    env = dict(os.environ, BENCH_NODES="100", BENCH_EDGES="500",
               BENCH_SEEDS="8", BENCH_ITERS="2")
    r = subprocess.run([sys.executable, "-m", "dgraph_tpu_torch.bench2hop"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and "cuda" in r.stderr
