"""The port's kernels on the card: each CUDA kernel (gather, slot-map,
intersect) against its plain PyTorch version on CUDA tensors, one launch
per wrapper call, the batched 2-hop pipeline on the card against the
numpy oracle, and the order-by's torch ops and the multi-hop pass
(one gather launch a hop) on the card against the same calls on the
CPU.  Every test is marked ``cuda`` and skips
where no GPU is visible.  The file imports neither JAX nor the JAX
package, so on the card's machine (no JAX there) it runs alone:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerance: none (int32 outputs, equal)."""

import numpy as np
import pytest
import torch

from dgraph_tpu_torch import bench2hop
from dgraph_tpu_torch.models.arena import csr_from_edges
from dgraph_tpu_torch import ops as tops
from dgraph_tpu_torch.ops import gather as tgather
from dgraph_tpu_torch.ops import kway
from dgraph_tpu_torch.ops import order as torder
from dgraph_tpu_torch.ops import slotmap as tslot
import torch_cases  # tests/torch_cases.py (pytest puts tests/ on the path)

pytestmark = pytest.mark.cuda


def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's kernels have no CPU mode")


def _case(name):
    if name in torch_cases.SLOTMAP_CASES:
        return torch_cases.slotmap_case(name)
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "grouped":
        return (*torch_cases.grouped(rng, 200, 4096), 8192)
    if name == "truncated":
        return (*torch_cases.grouped(rng, 9, 4096, fill=1.0), 300)
    if name == "zero_rows_between":
        cs, cd = torch_cases.grouped(rng, 32, 2048)
        cd[rng.random(cd.shape) < 0.25] = 0
        return cs, cd, 4096
    if name == "all_zero":
        z = np.zeros((200, 3072), np.int32)
        return z, z.copy(), 3328
    if name == "one_block_edge":  # totals 1023..1025
        cs, cd = np.zeros((3, 2048), np.int32), np.zeros((3, 2048), np.int32)
        for q, t in enumerate((1023, 1024, 1025)):
            cd[q, :t] = 1
            cs[q, :t] = np.arange(t) * 2
        return cs, cd, 2048
    raise KeyError(name)


@pytest.mark.parametrize("name", torch_cases.GATHER_CASES)
def test_gather_kernel_on_the_tile_edges(name):
    """One wrapper call is one launch of the fused kernel, equal to the
    plain version."""
    _need_gpu()
    off, dst, rows, cap = torch_cases.gather_case(name)
    off, dst, rows = (torch.from_numpy(x) for x in (off, dst, rows))
    want = tgather.gather_packed_plain(off, dst, rows, cap)
    off, dst, rows = off.cuda(), dst.cuda(), rows.cuda()
    torch.cuda.synchronize()
    n0 = tgather.KERNEL.launches
    got = tgather.gather_packed(off, dst, rows, cap)
    torch.cuda.synchronize()
    assert tgather.KERNEL.launches == n0 + 1
    assert got.shape == (2 * cap,) and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("name", ["grouped", "truncated", "zero_rows_between",
                                  "all_zero", "one_block_edge",
                                  *torch_cases.SLOTMAP_CASES])
def test_slotmap_kernel_matches_plain_version(name):
    _need_gpu()
    cs, cd, capc = _case(name)
    want = tslot.slotmap_plain(torch.from_numpy(cs), torch.from_numpy(cd), capc)
    n0 = tslot.KERNEL.launches
    got = tslot.slotmap(torch.from_numpy(cs).cuda(), torch.from_numpy(cd).cuda(), capc)
    torch.cuda.synchronize()
    assert tslot.KERNEL.launches == n0 + 1
    assert torch.equal(got.cpu(), want)


def test_batched_two_hop_on_the_card_matches_numpy():
    _need_gpu()
    a = bench2hop.build_graph(20_000, 200_000, "cuda")
    frontiers = bench2hop.draw_frontiers(20_000, 512, 9)
    fcap = tops.bucket(max(len(f) for f in frontiers))
    stats = {}
    _s, edges, chks, last_set = bench2hop.run_device_dedup(
        a, frontiers, fcap, chunk_q=4, stats=stats)
    _cpu_s, want_edges, want_chks = bench2hop.numpy_baseline(a, frontiers, reps=1)
    assert stats["slotmap_launches_per_pass"] == [6] * 5  # 3 chunks, 2 hops
    assert np.array_equal(stats["counts"], want_edges)
    assert edges == int(want_edges.sum())
    assert np.array_equal(chks, want_chks)
    _n, want_last, _c = bench2hop.np_two_hop(a, a.host_dst(), frontiers[-1])
    assert np.array_equal(last_set, want_last)


def _sets(rng, b, k, L, universe):
    """[b, k, L] sorted-unique rows of 1..L uids, SENT-padded."""
    mat = np.full((b, k, L), tops.SENT, np.int32)
    for i in range(b):
        for j in range(k):
            s = np.unique(rng.integers(0, universe, size=int(rng.integers(1, L + 1))))
            mat[i, j, : len(s)] = s
    return mat


@pytest.mark.parametrize("b,k,L", [(1, 1, 100), (1, 2, 256), (1, 3, 1000),
                                   (7, 4, 257), (64, 8, 1024), (2, 16, 5000)])
def test_intersect_kernel_matches_plain_version(b, k, L):
    _need_gpu()
    rng = np.random.default_rng(b * 1000 + k * 10 + L)
    mat = _sets(rng, b, k, L, L + L // 4)
    mat[0, k - 1, :] = tops.SENT  # an empty member annihilates row 0
    want = kway.intersect_plain(torch.from_numpy(mat))
    n0 = kway.KERNEL.launches
    got = kway.intersect_batch(torch.from_numpy(mat).cuda())
    torch.cuda.synchronize()
    assert kway.KERNEL.launches == n0 + 1
    assert torch.equal(got.cpu(), want)
    assert (want[0] == tops.SENT).all()


@pytest.mark.parametrize("name", torch_cases.INTERSECT_CASES)
def test_intersect_kernel_on_the_tile_edges(name):
    _need_gpu()
    mat = torch_cases.intersect_case(name)
    want = kway.intersect_plain(torch.from_numpy(mat))
    n0 = kway.KERNEL.launches
    got = kway.intersect_batch(torch.from_numpy(mat).cuda())
    torch.cuda.synchronize()
    assert kway.KERNEL.launches == n0 + 1
    assert torch.equal(got.cpu(), want)
    for g, fold in zip(got.cpu().numpy(), torch_cases.intersect_fold(mat)):
        assert np.array_equal(g[: len(fold)], fold) and (g[len(fold):] == tops.SENT).all()


def test_intersect_kernel_repeats_exactly():
    """One matrix with survivors in many tiles, intersected over and over:
    a tile's SENT stores must never land after a later tile's survivor
    stores."""
    _need_gpu()
    mat = torch.from_numpy(torch_cases.intersect_case("thin_L2_21")).cuda()
    want = kway.intersect_plain(mat.cpu()).cuda()
    differ = sum(not torch.equal(kway.intersect_batch(mat), want)
                 for _ in range(torch_cases.REPEATS))
    assert differ == 0


@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
def test_order_ops_on_the_card_match_the_cpu(desc):
    """gather_ranks and segmented_sort_perm at 2^20 slots, most of them
    tied (64 distinct ranks), with missing values and a padded tail: the
    card's stable sort gives the CPU's permutation."""
    _need_gpu()
    rng = np.random.default_rng(41 + desc)
    have = np.unique(rng.integers(1, 1 << 22, size=1 << 20))
    src = np.full(1 << 21, tops.SENT, np.int32)
    src[: len(have)] = have
    ranks = np.full(1 << 21, -1, np.int32)
    ranks[: len(have)] = rng.integers(0, 64, size=len(have))
    n, cap = (1 << 20) - 1000, 1 << 20
    uids = np.full(cap, tops.SENT, np.int32)
    uids[:n] = rng.integers(1, 1 << 22, size=n)  # about 1 in 4 has no value
    seg = np.full(cap, -1, np.int32)
    seg[:n] = np.sort(rng.integers(0, 5000, size=n))
    cpu = [torch.from_numpy(x) for x in (src, ranks, uids, seg)]
    want_r = torder.gather_ranks(*cpu[:3])
    want_p = torder.segmented_sort_perm(cpu[3], want_r, desc)
    src_d, ranks_d, uids_d, seg_d = (t.cuda() for t in cpu)
    got_r = torder.gather_ranks(src_d, ranks_d, uids_d)
    got_p = torder.segmented_sort_perm(seg_d, got_r, desc)
    assert torch.equal(got_r.cpu(), want_r)
    assert torch.equal(got_p.cpu(), want_p)
    assert (want_r == -1).sum() > n // 8


@pytest.mark.parametrize("track_visited", [False, True], ids=["plain", "bfs"])
@pytest.mark.parametrize("start", ["frontier", "drains"])
def test_multi_hop_on_the_card_matches_the_cpu(track_visited, start):
    """ops.multi_hop through the uid->row table, 3 hops: on the card one
    gather launch a hop and the CPU run's frontiers, edge counts and
    visited set; "drains" starts from sources whose targets own no row,
    so the second hop's frontier is empty."""
    _need_gpu()
    src, dst = bench2hop.gen_edges(20_000, 200_000)
    rng = np.random.default_rng(43)
    src = np.concatenate([src, rng.integers(30_000, 30_011, size=300)])
    dst = np.concatenate([dst, rng.integers(40_000, 40_100, size=300)])
    a = csr_from_edges(src, dst, "cpu")
    f0 = (np.unique(rng.integers(1, 20_001, size=512)) if start == "frontier"
          else np.arange(30_000, 30_011))
    n_hops, cap = 3, 1 << 18
    lut = a.lut()
    f = torch.from_numpy(tops.pad_to(f0, cap))
    vis = f if track_visited else torch.full((cap,), tops.SENT, dtype=torch.int32)
    want = tops.multi_hop(a.offsets, a.dst, f, vis, n_hops, cap, track_visited, lut)
    n0 = tgather.KERNEL.launches
    got = tops.multi_hop(a.offsets.cuda(), a.dst.cuda(), f.cuda(), vis.cuda(),
                         n_hops, cap, track_visited, lut.cuda())
    torch.cuda.synchronize()
    assert tgather.KERNEL.launches == n0 + n_hops
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int(want[1][0]) > 0
    if start == "drains":
        assert (want[0][1:] == tops.SENT).all() and int(want[1][1]) == 0
