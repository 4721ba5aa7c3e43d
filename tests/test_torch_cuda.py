"""The port's kernels on the card: each CUDA kernel (gather, slot-map,
intersect) against its plain PyTorch version on CUDA tensors, one launch
per wrapper call, the batched 2-hop pipeline on the card against the
numpy oracle, the order-by's torch ops, the multi-hop pass (one
gather launch a hop) and the tile join tier's mask chain on the card
against the same calls on the CPU, a hop merged across four engine
shells as one gather launch, a durable directory recovered on the
card answering its 2-hop through the gather, and a sampled 2-hop served
on the card whose hop spans carry the device wait, and the planner's
calibration on the card (positive rates; a kernel that fails to launch
makes it raise), and the device guard on the card (a real launch error
and a real OOM classified, the guard's worker on the caller's stream),
and the gRPC and binary-HTTP transports on the card (the count and join
(a) launch the gather and the intersect; a device fault over gRPC is
UNAVAILABLE with nothing launched in its place), and the engine's
inline and classed routes on the card equal to their CPU runs (the
inline route's slot map one launch a hop), and the mesh serving plane on
virtual chips of the card (the sharded expansion equal to the host's, a
multi-hop segment that never synchronizes, a server whose hops all ride
``route: mesh`` without a gather launch), and each kernel's registered
contract (analysis/programs.py: one launch a call on the caller's
stream, no host sync, the plain version's outputs).
Every test is marked ``cuda`` and skips
where no GPU is visible.  The file imports neither JAX nor the JAX
package (its planner pin, tests/torch_pins.py, pins the port's planner
alone where JAX is missing), so on the card's machine it runs alone:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerance: none (int32 outputs, and 0/1 float32 masks whose integer
sums are exact in any order: equal)."""

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
from torch_pins import pinned_planner  # noqa: F401

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.usefixtures("pinned_planner"),
]


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


def test_merged_hop_is_one_gather_launch():
    """4 threads, each an engine shell over one ArenaManager on the card,
    submit the same predicate's hop through one HopMerger: one gather
    launch expands the union, and each member's (out, seg_ptr) equals
    its solo expansion."""
    _need_gpu()
    import threading

    from dgraph_tpu_torch.models import PostingStore
    from dgraph_tpu_torch.query import QueryEngine
    from dgraph_tpu_torch.sched import HopMerger

    src, dst = bench2hop.gen_edges(20_000, 200_000)
    st = PostingStore()
    st.bulk_set_uid_edges("e", src, dst)
    base = QueryEngine(st, device="cuda")
    base.arenas.hop_cache = None
    base.expand_device_min = 1
    arena = base.arenas.data("e")
    rng = np.random.default_rng(61)
    srcs = [np.unique(rng.integers(1, 20_001, size=3000)) for _ in range(4)]
    solo = [base.expander._expand_one(arena, s) for s in srcs]
    merger = HopMerger(expected=4, window_s=30.0)  # fires by quorum
    shells = []
    for _ in srcs:
        sh = QueryEngine(st, arenas=base.arenas)
        sh.expander.hop_merger = merger
        shells.append(sh)
    got = [None] * 4

    def run(i):
        got[i] = shells[i].expander.expand(arena, srcs[i], attr="e")

    torch.cuda.synchronize()
    n0 = tgather.KERNEL.launches
    ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    torch.cuda.synchronize()
    assert tgather.KERNEL.launches == n0 + 1
    for (go, gs), (so, ss) in zip(got, solo):
        assert np.array_equal(go, so) and np.array_equal(gs, ss)


def _community_arena(n_uids, per_row, seed):
    """The tile tier's design point at a small size: each uid's targets
    drawn from the uids of its own and the neighbouring 128-blocks."""
    rng = np.random.default_rng(seed)
    u = np.repeat(np.arange(1, n_uids + 1), per_row)
    b = np.clip(u // 128 + rng.integers(-1, 2, size=len(u)), 0, n_uids // 128)
    v = np.clip(b * 128 + rng.integers(0, 128, size=len(u)), 1, n_uids)
    keep = u != v
    return csr_from_edges(u[keep], v[keep], "cpu")


def test_mask_chain_on_the_card_matches_the_cpu():
    """ops.spgemm on CUDA tensors (the tiles built on the card by one
    index_put_) against the same calls on CPU tensors: build_tiles, a
    3-level run_mask_chain with a keep mask, triangle_mask_batch and an
    in-place apply_tile_delta; masks, totals and tiles equal."""
    _need_gpu()
    from dgraph_tpu_torch.ops import spgemm

    a = _community_arena(8192, 16, 71)
    h = (a.h_src, a.h_offsets, a.host_dst())
    cpu = spgemm.build_tiles(*h, t=128, device="cpu")
    gpu = spgemm.build_tiles(*h, t=128, device="cuda")
    for f in ("bi", "bj", "tiles", "degs"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f))
    m = spgemm.mask_lanes(cpu.universe, 128)
    rng = np.random.default_rng(73)
    seeds = np.unique(rng.integers(1, 8193, size=64)).astype(np.int32)
    keep = np.unique(rng.integers(1, 8193, size=3000)).astype(np.int32)
    outs = []
    for pt, dev in ((cpu, "cpu"), (gpu, "cuda")):
        x0 = spgemm.uids_to_mask(torch.from_numpy(seeds).to(dev), m)
        km = spgemm.uids_to_mask(torch.from_numpy(keep).to(dev), m)
        ops_ = ((pt.bi, pt.bj, pt.tiles),) * 3
        masks, totals = spgemm.run_mask_chain(ops_, (None, km, None),
                                              (pt.degs,) * 3, x0)
        xb = torch.stack([x0, km])
        tri = spgemm.triangle_mask_batch(*ops_[0], *ops_[0], *ops_[0], xb)
        outs.append([masks.cpu(), totals.cpu(), tri.cpu()])
    for g, w in zip(outs[1], outs[0]):
        assert torch.equal(g, w)
    assert int(outs[0][1][0]) > 0
    # a delta inside stored blocks, repaired in place on both devices
    bi, bj = cpu.bi[:cpu.n_tiles].numpy(), cpu.bj[:cpu.n_tiles].numpy()
    adds = np.array([[int(bi[i]) * 128 + 5, int(bj[i]) * 128 + 7]
                     for i in range(0, cpu.n_tiles, 7)], np.int64)
    have = set(zip(np.repeat(a.h_src, np.diff(a.h_offsets)).tolist(),
                   a.host_dst().tolist()))
    adds = adds[[tuple(e) not in have for e in adds.tolist()]]
    dels = np.array(sorted(have)[:9], np.int64)
    assert spgemm.apply_tile_delta(cpu, adds, dels) is cpu
    assert spgemm.apply_tile_delta(gpu, adds, dels) is gpu
    for f in ("tiles", "degs"):
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f))


def test_recovered_store_serves_the_two_hop_through_the_gather(tmp_path):
    """A durable directory (a bulk edge record, then a journaled point
    mutation), recovered on the card with the device gate at 1: the
    2-hop launches the gather kernel and answers with the same bytes as
    the same directory recovered on the CPU."""
    _need_gpu()
    import json

    from dgraph_tpu_torch.models.wal import DurableStore
    from dgraph_tpu_torch.query import QueryEngine

    d = str(tmp_path / "p")
    src, dst = bench2hop.gen_edges(20_000, 200_000)
    st = DurableStore(d, sync_writes=True)
    st.apply_schema("e: uid .")
    st.bulk_set_uid_edges("e", src, dst)
    rng = np.random.default_rng(67)
    mu = " ".join("<0x%x> <e> <0x%x> ." % (int(a), int(b))
                  for a, b in rng.integers(1, 20_001, size=(64, 2)))
    QueryEngine(st, device="cpu").run("mutation { set { %s } }" % mu)
    st.close()
    seeds = np.unique(rng.integers(1, 20_001, size=256))
    q = "{ q(func: uid(%s)) { uid e { uid e { uid } } } }" % ", ".join(
        "0x%x" % int(s) for s in seeds)
    cpu_store = DurableStore(d)
    want = json.dumps(QueryEngine(cpu_store, device="cpu").run(q))
    cpu_store.close()
    gpu_store = DurableStore(d)
    eng = QueryEngine(gpu_store, device="cuda")
    eng.expand_device_min = 1
    eng.arenas.hop_cache = None
    n0 = tgather.KERNEL.launches
    got = json.dumps(eng.run(q))
    torch.cuda.synchronize()
    assert tgather.KERNEL.launches >= n0 + 2  # both levels on the card
    assert got == want
    assert gpu_store.recovery["wal_records"] >= 2
    gpu_store.close()


def _cluster3(tmp_path, device):
    """Three port servers on ``device`` in one cluster (groups 0 and 1 on
    every server, real HTTP between them, one process)."""
    import socket

    from dgraph_tpu_torch.cluster.service import ClusterService
    from dgraph_tpu_torch.serve.server import DgraphServer

    socks = [socket.socket() for _ in range(3)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    peers = {str(i + 1): f"http://127.0.0.1:{p}" for i, p in enumerate(ports)}
    servers = []
    for i, p in enumerate(ports):
        nid = str(i + 1)
        svc = ClusterService(node_id=nid, my_addr=peers[nid], peers=peers,
                             group_ids=[0, 1], directory=str(tmp_path / nid))
        svc.start()
        srv = DgraphServer(svc.store, port=p, cluster=svc, device=device)
        srv.start()
        servers.append(srv)
    return servers


def _post_json(addr, text, timeout=120):
    import json
    import time
    import urllib.error
    import urllib.request

    deadline = time.monotonic() + timeout
    while True:
        req = urllib.request.Request(addr + "/query", data=text.encode())
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                out = json.loads(r.read())
            out.pop("server_latency", None)
            return out
        except (urllib.error.HTTPError, OSError):
            # no leader yet / a proposal timed out: retried to a deadline
            if time.monotonic() > deadline:
                raise
            time.sleep(0.5)


def test_cluster_two_hop_on_the_card_matches_the_cpu_cluster(tmp_path, monkeypatch):
    """A three-server port cluster on the card, loaded through a server
    with one bulk write, answers the 2-hop with the same bytes as the
    same cluster on the CPU, every server launching the gather."""
    _need_gpu()
    import json
    import time

    monkeypatch.setenv("DGRAPH_TPU_PROPOSE_TIMEOUT", "45")
    src, dst = bench2hop.gen_edges(20_000, 200_000)
    rng = np.random.default_rng(83)
    seeds = np.unique(rng.integers(1, 20_001, size=256))
    q = "{ q(func: uid(%s)) { uid e { uid e { uid } } } }" % ", ".join(
        "0x%x" % int(s) for s in seeds)
    bodies = {}
    for device in ("cpu", "cuda"):
        servers = _cluster3(tmp_path / device, device)
        try:
            deadline = time.monotonic() + 60
            while not all(s.cluster.has_leader() for s in servers):
                assert time.monotonic() < deadline, "no leader elected"
                time.sleep(0.05)
            _post_json(servers[1].addr, "mutation { schema { e: uid . } }")
            servers[1].store.bulk_set_uid_edges("e", src, dst)
            deadline = time.monotonic() + 120
            # every replica applied the write (one raft index everywhere)
            while len({s.cluster.groups[1].pred_version("e") for s in servers}
                      - {0}) != 1 or any(
                    s.cluster.groups[1].pred_version("e") == 0 for s in servers):
                assert time.monotonic() < deadline, "a replica never applied"
                time.sleep(0.1)
            got = []
            for srv in servers:
                srv.engine.expand_device_min = 1
                srv.engine.arenas.hop_cache = None
                n0 = tgather.KERNEL.launches
                got.append(json.dumps(_post_json(srv.addr, q)))
                if device == "cuda":
                    torch.cuda.synchronize()
                    assert tgather.KERNEL.launches > n0, srv.cluster.node_id
            assert len(set(got)) == 1
            bodies[device] = got[0]
        finally:
            for s in servers:
                s.stop()
    assert bodies["cuda"] == bodies["cpu"]
    assert '"e"' in bodies["cpu"]


def test_sampled_two_hop_on_the_card_records_device_sync(tmp_path):
    """A sampled 2-hop served on the card (gate at 1, the chain pinned
    off so that each level is a hop of its own, caches detached):
    every hop span on the resident route carries ``device_sync_ms``
    (waited for on a CUDA event) within the hop's duration, the gather
    launches once a resident hop, and the body equals the CPU server's."""
    _need_gpu()
    import json
    import urllib.request

    from dgraph_tpu_torch import obs
    from dgraph_tpu_torch.models import PostingStore
    from dgraph_tpu_torch.serve.server import DgraphServer

    src, dst = bench2hop.gen_edges(20_000, 200_000)
    seeds = np.unique(np.random.default_rng(71).integers(1, 20_001, size=512))
    q = "{ q(func: uid(%s)) { uid e { uid e { uid } } } }" % ", ".join(
        "0x%x" % int(s) for s in seeds)
    tid = "%032x" % 0xC0DA

    def serve(device, traced):
        store = PostingStore()
        store.apply_schema("e: uid .")
        store.bulk_set_uid_edges("e", src, dst)
        srv = DgraphServer(store, device=device)
        srv.engine.expand_device_min = 1
        # the priced chain route would fuse the two levels into one pass
        srv.engine.chain_threshold = 1 << 62
        srv.engine.arenas.hop_cache = None
        srv.scheduler.result_cache = None
        srv.start()
        try:
            hdr = {"Traceparent": "00-%s-%016x-01" % (tid, 0xC0DA)} if traced else {}
            req = urllib.request.Request(srv.addr + "/query", data=q.encode(),
                                         headers=hdr)
            n0 = tgather.KERNEL.launches
            with urllib.request.urlopen(req, timeout=120) as r:
                out = json.loads(r.read())
            out.pop("server_latency")
            return out, tgather.KERNEL.launches - n0
        finally:
            srv.stop()

    try:
        obs.configure(ratio=1e-9)
        got, launches = serve("cuda", True)
    finally:
        rec = obs.get_recorder()
        obs.configure()
    want, _ = serve("cpu", False)
    assert got == want
    hops = [s for s in rec.trace(tid)["spans"] if s["name"] == "hop"]
    resident = [s for s in hops if s["attrs"]["route"] == "resident"]
    assert len(resident) == 2 and launches == 2, hops
    for s in resident:
        assert s["attrs"]["pred"] == "e"
        assert 0.0 < s["attrs"]["device_sync_ms"] <= s["dur_us"] / 1e3


def test_calibration_on_the_card_measures_positive_rates(tmp_path, monkeypatch):
    _need_gpu()
    from dgraph_tpu_torch.query import planner
    from dgraph_tpu_torch.utils import calibrate

    n0, k0 = tgather.KERNEL.launches, kway.KERNEL.launches
    cal = calibrate.measure(edges=1 << 14, reps=3, device="cuda")
    assert cal.source == "measured" and cal.backend == "cuda"
    for k, v in cal.rates().items():
        assert v > 0, k
    # the pass went through the kernels themselves
    assert tgather.KERNEL.launches > n0 and kway.KERNEL.launches > k0
    path = str(tmp_path / "calib.json")
    monkeypatch.setenv("DGRAPH_TPU_CALIBRATION_FILE", path)
    monkeypatch.setenv("DGRAPH_TPU_CALIBRATE", "1")
    from dgraph_tpu_torch.models import PostingStore
    from dgraph_tpu_torch.serve.server import DgraphServer

    srv = DgraphServer(PostingStore(), device="cuda")
    try:
        info = planner.calibration_info()
        assert info["source"] == "measured" and info["backend"] == "cuda"
        assert calibrate.load(path, backend="cuda") is not None
        assert calibrate.load(path, backend="cpu") is None
    finally:
        srv.stop()


@pytest.mark.parametrize("broken", ["gather", "intersect"])
def test_calibration_raises_when_a_kernel_launch_fails(broken, monkeypatch):
    """A calibration that cannot launch a kernel has found a sick card:
    ``measure()`` and a ``DGRAPH_TPU_CALIBRATE=1`` server boot raise, and
    nothing falls back to the priors."""
    _need_gpu()
    from dgraph_tpu_torch.models import PostingStore
    from dgraph_tpu_torch.query import planner
    from dgraph_tpu_torch.serve.server import DgraphServer
    from dgraph_tpu_torch.utils import calibrate

    def fail(*_a, **_k):
        raise RuntimeError(f"injected {broken} launch failure")

    kern = tgather.KERNEL if broken == "gather" else kway.KERNEL
    monkeypatch.setattr(kern, "launch", fail)
    with pytest.raises(RuntimeError, match="injected"):
        calibrate.measure(edges=1 << 12, reps=2, device="cuda")
    monkeypatch.setenv("DGRAPH_TPU_CALIBRATE", "1")
    monkeypatch.setenv("DGRAPH_TPU_CALIBRATION_FILE", "")
    with pytest.raises(RuntimeError, match="injected"):
        DgraphServer(PostingStore(), device="cuda")
    assert planner.calibration_info()["source"] != "measured"


# ---------------------------------------------- the device guard on the card


def test_real_kernel_launch_error_is_classified():
    """A kernel entry point's own error return on the card (here the
    gather refusing a scratch buffer too small, cudaErrorInvalidValue)
    raises ``KernelLaunchError`` with its code, which the device guard
    classifies ``transient``; a good launch right after it succeeds."""
    _need_gpu()
    from dgraph_tpu_torch.ops._build import KernelLaunchError
    from dgraph_tpu_torch.utils import devguard

    dev = torch.device("cuda")
    off = torch.tensor([0, 1, 2], dtype=torch.int32, device=dev)
    dst = torch.tensor([5, 6], dtype=torch.int32, device=dev)
    rows = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    small = torch.empty(4, dtype=torch.int32, device=dev)

    def bad_launch():
        tgather.KERNEL.launch(
            off.data_ptr(), dst.data_ptr(), rows.data_ptr(), 2, 2,
            small.data_ptr(), small.numel(),
            torch.cuda.current_stream(dev).cuda_stream,
        )

    g = devguard.DeviceGuard("t", hang_ms=30_000, cooldown_s=60, sick_after=3)
    with pytest.raises(devguard.DeviceFaultError) as ei:
        g.run("device.hop", bad_launch)
    assert ei.value.kind == "transient"
    assert isinstance(ei.value.__cause__, KernelLaunchError)
    assert ei.value.__cause__.code == 1  # cudaErrorInvalidValue
    assert g.state == "suspect"
    out = g.run("device.hop", lambda: tops.gather_packed(off, dst, rows, 2).cpu())
    assert out[:2].tolist() == [5, 6]
    assert g.state == "healthy"


def test_real_oom_is_classified():
    _need_gpu()
    from dgraph_tpu_torch.utils import devguard

    g = devguard.DeviceGuard("t", hang_ms=30_000, cooldown_s=60, sick_after=3)
    with pytest.raises(devguard.DeviceFaultError) as ei:
        g.run("device.hop", lambda: torch.empty(1 << 46, device="cuda"))
    assert ei.value.kind == "oom"
    assert isinstance(ei.value.__cause__, torch.cuda.OutOfMemoryError)


def test_guard_worker_runs_on_the_callers_stream():
    """torch's current stream is per thread: the guard's worker must run
    the closure on the CALLER's stream, so a gather it launches orders
    after the caller's uploads on that stream."""
    _need_gpu()
    from dgraph_tpu_torch.utils import devguard

    g = devguard.DeviceGuard("t", hang_ms=30_000, cooldown_s=60)
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        got = g.run("op", lambda: torch.cuda.current_stream().cuda_stream)
        off = torch.tensor([0, 2, 3], dtype=torch.int32, device="cuda")
        dst = torch.tensor([7, 8, 9], dtype=torch.int32, device="cuda")
        rows = torch.tensor([0, 1], dtype=torch.int32, device="cuda")
        out = g.run("device.hop", lambda: tops.gather_packed(off, dst, rows, 4))
    assert got == s.cuda_stream
    assert got != torch.cuda.current_stream().cuda_stream
    s.synchronize()
    assert out[:3].cpu().tolist() == [7, 8, 9]


def _transport_server(device, src, dst):
    """A port server on ``device`` over a generated ``e`` graph, both
    gates at 1, the chain pinned off, the caches detached, with its gRPC
    listener."""
    from dgraph_tpu_torch.models import PostingStore
    from dgraph_tpu_torch.serve.grpc_server import GrpcServer
    from dgraph_tpu_torch.serve.server import DgraphServer

    store = PostingStore()
    store.apply_schema("e: uid .")
    store.bulk_set_uid_edges("e", src, dst)
    srv = DgraphServer(store, device=device)
    srv.engine.expand_device_min = 1
    srv.engine.arenas.kway_device_min = 1
    srv.engine.chain_threshold = 1 << 62
    srv.engine.arenas.hop_cache = None
    srv.scheduler.result_cache = None
    srv.start()
    g = GrpcServer(srv, port=0)
    g.start()
    return srv, g


def _transport_queries():
    rng = np.random.default_rng(101)
    s0, s1, s2 = (np.unique(rng.integers(1, 20_001, size=512)) for _ in range(3))
    ul = lambda s: ", ".join("0x%x" % int(u) for u in s)  # noqa: E731
    count = ("{ var(func: uid(%s)) { e { f as e } } q(func: uid(f)) { count() } }"
             % ul(s0))
    join = ("{ var(func: uid(%s)) { e { f as e } } var(func: uid(%s)) { e { g as e } } "
            "q(func: uid(f)) @filter(has(e) AND uid(g)) { uid } }" % (ul(s1), ul(s2)))
    return {"count": count, "join_a": join}


def test_grpc_and_binary_http_launch_the_kernels_on_the_card():
    """The 2-hop count and join (a) over gRPC ``Run`` and over HTTP with
    ``Accept: application/protobuf`` on a card server: every request
    launches the gather (the count) or the intersect (join (a)), and the
    bodies equal a CPU server's over the same transport."""
    _need_gpu()
    grpc = pytest.importorskip("grpc")
    import urllib.request

    from dgraph_tpu_torch.serve import proto
    from dgraph_tpu_torch.serve.grpc_server import encode_request

    src, dst = bench2hop.gen_edges(20_000, 200_000)
    queries = _transport_queries()
    bodies = {}
    for device in ("cpu", "cuda"):
        srv, g = _transport_server(device, src, dst)
        try:
            with grpc.insecure_channel(f"127.0.0.1:{g.port}") as ch:
                run = ch.unary_unary("/protos.Dgraph/Run")
                for name, q in queries.items():
                    for transport in ("grpc", "binary_http"):
                        n0 = (tgather.KERNEL.launches, kway.KERNEL.launches)
                        if transport == "grpc":
                            raw = run(encode_request(q), timeout=120)
                        else:
                            req = urllib.request.Request(
                                srv.addr + "/query", data=q.encode(),
                                headers={"Accept": "application/protobuf"})
                            with urllib.request.urlopen(req, timeout=120) as r:
                                raw = r.read()
                        if device == "cuda":
                            torch.cuda.synchronize()
                            assert tgather.KERNEL.launches > n0[0], (name, transport)
                            if name == "join_a":
                                assert kway.KERNEL.launches > n0[1], transport
                        bodies[(device, name, transport)] = [
                            f for f in proto.iter_fields(raw) if f[0] != 2]
        finally:
            g.stop()
            srv.stop()
    for name in queries:
        for transport in ("grpc", "binary_http"):
            assert bodies[("cuda", name, transport)] == bodies[("cpu", name, transport)]
        assert bodies[("cuda", name, "grpc")] == bodies[("cuda", name, "binary_http")]


def test_device_fault_over_grpc_is_unavailable_on_the_card():
    """A DeviceFaultError injected at ``device.hop`` on a card server
    answers gRPC ``UNAVAILABLE``: no gather launched for it and no host
    route in its place; the next request, the fault spent, launches the
    gather and answers."""
    _need_gpu()
    grpc = pytest.importorskip("grpc")
    from dgraph_tpu_torch.serve.grpc_server import encode_request
    from dgraph_tpu_torch.serve.proto import decode_response
    from dgraph_tpu_torch.utils.failpoints import fail

    src, dst = bench2hop.gen_edges(20_000, 200_000)
    q = _transport_queries()["count"]
    srv, g = _transport_server("cuda", src, dst)
    try:
        with grpc.insecure_channel(f"127.0.0.1:{g.port}") as ch:
            run = ch.unary_unary("/protos.Dgraph/Run")
            want = decode_response(run(encode_request(q), timeout=120))["q"]
            fail.arm("device.hop", "error(n=1)")
            n0 = tgather.KERNEL.launches
            with pytest.raises(grpc.RpcError) as ei:
                run(encode_request(q), timeout=120)
            assert ei.value.code() == grpc.StatusCode.UNAVAILABLE
            assert fail.hits("device.hop") == 1
            torch.cuda.synchronize()
            assert tgather.KERNEL.launches == n0
            got = decode_response(run(encode_request(q), timeout=120))["q"]
            torch.cuda.synchronize()
            assert got == want and tgather.KERNEL.launches > n0
    finally:
        fail.reset()
        g.stop()
        srv.stop()


def _route_engines(route):
    """(card engine, CPU engine) over one generated graph, every hop on
    the device route ``route`` (the served engine's knobs)."""
    from dgraph_tpu_torch.models import PostingStore
    from dgraph_tpu_torch.query import QueryEngine

    src, dst = bench2hop.gen_edges(20_000, 200_000)
    st = PostingStore()
    st.apply_schema("e: uid .")
    st.bulk_set_uid_edges("e", src, dst)
    out = []
    for dev in ("cuda", "cpu"):
        eng = QueryEngine(st, device=dev)
        eng.arenas.hop_cache = None
        eng.expand_device_min = 1
        eng.chain_threshold = 1 << 62
        ex = eng.expander
        ex.resident_mode, ex.fused_hop = "0", {
            "inline": "0", "classed": "force"}[route]
        out.append(eng)
    return out


@pytest.mark.parametrize("route", ["inline", "classed"])
def test_route_on_the_card_matches_its_cpu_run(route):
    """The 2-hop count and the materialised 2-hop on the card's inline
    (classed) route answer as the same route on the CPU; the inline
    route launches the slot-map kernel once a hop, the classed route
    none."""
    _need_gpu()
    card, cpu = _route_engines(route)
    rng = np.random.default_rng(67)
    seeds = ", ".join("0x%x" % u for u in np.unique(rng.integers(1, 20_001, size=2000)))
    for q in ("{ var(func: uid(%s)) { e { f as e } } q(func: uid(f)) { count() } }" % seeds,
              "{ q(func: uid(%s)) { uid e { uid e { uid } } } }" % seeds):
        want = cpu.run(q)
        assert cpu.stats["routes"] == {route: 2}
        n0 = tslot.KERNEL.launches
        got = card.run(q)
        torch.cuda.synchronize()
        assert card.stats["routes"] == {route: 2}
        assert tslot.KERNEL.launches - n0 == (2 if route == "inline" else 0)
        got.pop("server_latency", None)
        want.pop("server_latency", None)
        assert got == want


def test_expand_inline_seg_on_the_card_matches_the_cpu():
    """ops.expand_inline_seg on CUDA tensors (its slot map the kernel, Q
    = 1, one launch) equals the CPU run, -1 skips and truncation
    included."""
    _need_gpu()
    src, dst = bench2hop.gen_edges(5_000, 60_000)
    cpu_a = tops_arena(src, dst, "cpu")
    card_a = tops_arena(src, dst, "cuda")
    rng = np.random.default_rng(71)
    for trial in range(6):
        f = np.unique(rng.integers(1, 5_001, size=int(rng.integers(1, 2000))))
        rows = np.insert(f, rng.integers(0, len(f) + 1, size=trial), -1)
        rows = tops.pad_rows(rows, tops.bucket(len(rows)))
        need = int(cpu_a.ov_chunk_degree_of_rows(f).sum())
        capc = tops.bucket(max(1, need)) if trial % 2 else max(1, need // 2)
        want = tops.expand_inline_seg(*cpu_a.inline_layout(), torch.from_numpy(rows), capc)
        n0 = tslot.KERNEL.launches
        got = tops.expand_inline_seg(*card_a.inline_layout(),
                                     torch.from_numpy(rows).cuda(), capc)
        torch.cuda.synchronize()
        assert tslot.KERNEL.launches == n0 + 1
        for w, g in zip(want, got):
            assert torch.equal(w, g.cpu())


def tops_arena(src, dst, device):
    from dgraph_tpu_torch.models.arena import csr_dense_from_edges

    return csr_dense_from_edges(src, dst, 5_000, device)


# -- the mesh serving plane on virtual chips of the card -----------------------


@pytest.mark.parametrize("width", [1, 3, 4])
def test_mesh_on_virtual_chips_matches_the_host(width):
    """A mesh of ``width`` virtual chips of cuda:0: the sharded one-hop
    expansion (its reassembly on the card) equals the host expansion,
    and a multi-hop segment runs under sync debug mode ``error`` with
    the per-level frontiers of the same program on the CPU."""
    _need_gpu()
    from dgraph_tpu_torch.mesh.programs import mesh_multi_hop_step
    from dgraph_tpu_torch.parallel import make_mesh, shard_arena_rows
    from dgraph_tpu_torch.parallel.mesh import sharded_expand_segments

    rng = np.random.default_rng(41)
    src = rng.integers(1, 20_000, size=200_000)
    dst = rng.integers(1, 20_000, size=200_000)
    a = csr_from_edges(src, dst, device="cpu")
    mesh = make_mesh(devices=["cuda:0"] * width)
    sa = shard_arena_rows(a.h_src, a.h_offsets, a.host_dst(), width,
                          devices=mesh.model_devices())
    assert all(t.is_cuda for t in sa.dst)
    for k in (1, 100, 5000):
        f = np.unique(rng.integers(1, 20_000, size=k))
        cap = tops.bucket(int(a.degree_of_rows(a.rows_for_uids_host(f)).sum()) or 1)
        want, wptr = a.expand_host(a.rows_for_uids_host(f))
        out, ptr = sharded_expand_segments(mesh, sa, f, cap)
        assert np.array_equal(out, want) and np.array_equal(ptr, wptr)
    cap = 1 << 16
    seed = tops.pad_to(np.arange(1, 200), cap)
    f = torch.from_numpy(seed).cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fs, tot, _final = mesh_multi_hop_step(mesh, sa, f, cap, 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cpu_mesh = make_mesh(devices=["cpu"] * width)
    csa = shard_arena_rows(a.h_src, a.h_offsets, a.host_dst(), width)
    wfs, wtot, _ = mesh_multi_hop_step(cpu_mesh, csa, torch.from_numpy(seed), cap, 2)
    assert torch.equal(fs.cpu(), wfs) and torch.equal(tot.cpu(), wtot)


def test_mesh_server_on_virtual_chips_serves_route_mesh(monkeypatch):
    """A server with a mesh of 4 virtual chips of the card answers as a
    host-route engine, every hop on ``route: mesh``, no gather launch."""
    _need_gpu()
    import json
    import urllib.request

    from dgraph_tpu_torch.models import PostingStore
    from dgraph_tpu_torch.parallel import make_mesh
    from dgraph_tpu_torch.query import QueryEngine
    from dgraph_tpu_torch.serve.server import DgraphServer

    monkeypatch.setenv("DGRAPH_TPU_CACHE", "0")
    monkeypatch.setenv("DGRAPH_TPU_MESH_SHARD_ROWS", "1")
    rng = np.random.default_rng(3)
    lines = [f"<0x{i:x}> <link> <0x{d:x}> ." for i in range(1, 121)
             for d in rng.integers(1, 121, size=4)]
    data = "mutation { schema { link: uid . } set { %s } }" % "\n".join(lines)
    q = "{ q(func: uid(0x1, 0x2)) { uid link { uid link { uid } } } }"
    srv = DgraphServer(PostingStore(), device="cuda",
                       mesh=make_mesh(devices=["cuda:0"] * 4))
    srv.engine.expand_device_min = 1
    srv.start()
    try:
        def post(text, params=""):
            req = urllib.request.Request(srv.addr + "/query" + params,
                                         data=text.encode(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                return json.loads(r.read())

        post(data)
        n0 = tgather.KERNEL.launches
        out = post(q, "?debug=true")
        assert out.pop("server_latency")["engine"]["routes"] == {"mesh": 2}
        assert tgather.KERNEL.launches == n0
        host = QueryEngine(PostingStore(), device="cpu")
        host.run(data)
        assert out == json.loads(json.dumps(host.run(q)))
    finally:
        srv.stop()


@pytest.mark.parametrize("kernel", ["gather_fused", "slotmap_tiles", "intersect_tiles"])
def test_kernel_contract_holds_on_the_card(kernel):
    """The contract registry's card half (dgraph_tpu_torch/analysis/
    programs.py): on a side stream under sync-debug mode "error", with
    the default stream kept busy, one launch a call on the caller's
    stream, no host sync, and the plain version's dtype, shape and
    values after the side stream's event."""
    _need_gpu()
    from dgraph_tpu_torch.analysis import programs

    (contract,) = [c for c in programs.CONTRACTS if c.kernel == kernel]
    rows = programs.check_cuda(contract)
    assert len(rows) == 3
    for r in rows:
        assert r["launches"] == 1 and r["syncs"] == 0 and r["stream"] == "caller"
        assert r["max_abs_err"] == 0 and r["default_busy"] is not False
