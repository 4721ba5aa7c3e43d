"""The port's row-sharded mesh (``dgraph_tpu_torch/parallel``,
``dgraph_tpu_torch/mesh/programs.py``) against the reference's
(``dgraph_tpu/parallel/mesh.py`` on the conftest's 8 virtual CPU
devices) and against unsharded expansion.  Integer outputs, tolerance 0.

The port's meshes here are CPU meshes (``make_mesh(devices=["cpu"] *
W)``): the same code path a mesh of virtual chips of one card runs.
Geometries: 1×1, 1×3 (uneven shards; empty shards on a small arena),
1×8 and 2×4.  The reference's mesh compiles one program per shape, so
it is held against the port on a handful of shapes only."""

import numpy as np
import pytest
import torch

import jax

from dgraph_tpu.models.arena import csr_from_edges as jcsr_from_edges
from dgraph_tpu.parallel import mesh as jmesh
from dgraph_tpu_torch import ops
from dgraph_tpu_torch.mesh import programs
from dgraph_tpu_torch.mesh.plan import MeshPlan
from dgraph_tpu_torch.models.arena import csr_from_edges
from dgraph_tpu_torch.ops import spgemm
from dgraph_tpu_torch.parallel import crossover
from dgraph_tpu_torch.parallel import mesh as tmesh
from dgraph_tpu_torch.utils import devguard
from torch_pins import pinned_planner  # noqa: F401

pytestmark = [
    pytest.mark.usefixtures("pinned_planner"),
    pytest.mark.compile_budget(200),
]

GEOMS = [(1, 1), (1, 3), (1, 8), (2, 4)]
SENT = ops.SENT


def _mesh(data, model):
    return tmesh.make_mesh(devices=["cpu"] * (data * model), data=data)


def _graph(seed=7, n_uids=500, n_edges=4000):
    rng = np.random.default_rng(seed)
    src = rng.integers(1, n_uids, size=n_edges)
    dst = rng.integers(1, n_uids, size=n_edges)
    return rng, csr_from_edges(src, dst, device="cpu")


def _host(sa):
    """A ShardedArena's shards stacked on the host (src [n, Sp], offsets
    [n, Sp+1], dst [n, Ep]): the reference's layout."""
    return tuple(
        np.stack([t.cpu().numpy() for t in ts])
        for ts in (sa.src, sa.offsets, sa.dst)
    )


def _cap(a, frontier):
    return ops.bucket(
        int(a.degree_of_rows(a.rows_for_uids_host(frontier)).sum()) or 1
    )


# -- construction -------------------------------------------------------------


def test_make_mesh_raises_without_a_gpu_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError):
        tmesh.make_mesh(4)


@pytest.mark.parametrize("data,model", GEOMS)
def test_make_mesh_shape(data, model):
    m = _mesh(data, model)
    assert m.shape == {"data": data, "model": model}
    assert m.axis_names == ("data", "model")
    assert len(m.model_devices()) == model
    assert len(m.data_devices()) == data
    assert m.distinct == (model == 1)


@pytest.mark.parametrize("pred", ["name", "e", "friend", "~link", "a\x00b"])
@pytest.mark.parametrize("n", [1, 3, 8])
def test_predicate_shard_matches_reference(pred, n):
    assert tmesh.predicate_shard(pred, n) == jmesh.predicate_shard(pred, n)


@pytest.mark.parametrize("n", [0, 1, 3, 255, 256, 257, 1024, 1025, 5000, 70000])
def test_fcap_bucket_matches_reference(n):
    assert tmesh._fcap_bucket(n) == jmesh._fcap_bucket(n)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
@pytest.mark.parametrize("n_edges", [3, 4000])
def test_shard_arena_rows_matches_reference(n_shards, n_edges):
    """Same padded layout as the reference's, shard for shard (3 edges
    over 8 shards leaves empty shards)."""
    rng = np.random.default_rng(n_edges)
    src = rng.integers(1, 500, size=n_edges)
    dst = rng.integers(1, 500, size=n_edges)
    a = csr_from_edges(src, dst, device="cpu")
    ja = jcsr_from_edges(src, dst)
    got = tmesh.shard_arena_rows(a.h_src, a.h_offsets, a.host_dst(), n_shards)
    want = jmesh.shard_arena_rows(ja.h_src, ja.h_offsets, ja.host_dst(), n_shards)
    assert got.n_shards == want.n_shards == n_shards
    for g, w in zip(_host(got), (want.src, want.offsets, want.dst)):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got.device_bytes() == want.device_bytes()


# -- the one-hop expansion with its device-side reassembly --------------------


@pytest.mark.parametrize("data,model", GEOMS)
@pytest.mark.parametrize("k", [1, 5, 40, 400])
def test_packed_reassembly_matches_unsharded(data, model, k):
    """Each frontier uid's targets, grouped in frontier order with their
    seg_ptr, as the unsharded host expansion gives them."""
    rng, a = _graph()
    m = _mesh(data, model)
    sa = tmesh.shard_arena_rows(
        a.h_src, a.h_offsets, a.host_dst(), model, devices=m.model_devices()
    )
    f = np.unique(rng.integers(1, 500, size=k))
    want, wptr = a.expand_host(a.rows_for_uids_host(f))
    out, ptr = tmesh.sharded_expand_segments(m, sa, f, _cap(a, f))
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(ptr, wptr)


def test_packed_reassembly_empty_shards_and_misses():
    """A 3-edge arena over 3 shards (some empty) and a frontier of uids
    that own no row, an empty frontier, and a uid past every row."""
    a = csr_from_edges(np.array([5, 5, 9]), np.array([7, 8, 1]), device="cpu")
    m = _mesh(1, 3)
    sa = tmesh.shard_arena_rows(a.h_src, a.h_offsets, a.host_dst(), 3)
    for f in ([], [1, 2, 3], [5], [4, 5, 9, 10**6]):
        f = np.asarray(f, dtype=np.int64)
        want, wptr = a.expand_host(a.rows_for_uids_host(f))
        out, ptr = tmesh.sharded_expand_segments(m, sa, f, 8)
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(ptr, wptr)


def test_packed_reassembly_matches_reference_mesh():
    """Against ``dgraph_tpu.parallel.sharded_expand_segments`` on the
    reference's 1×8 mesh of virtual CPU devices, two frontier shapes."""
    assert len(jax.devices()) >= 8
    rng, a = _graph(seed=11, n_uids=3000, n_edges=20000)
    ja = jcsr_from_edges(
        np.repeat(a.h_src, np.diff(a.h_offsets)), a.host_dst()
    )
    jm = jmesh.make_mesh(8, data=1)
    jsa = jmesh.shard_arena_rows(ja.h_src, ja.h_offsets, ja.host_dst(), 8)
    m = _mesh(1, 8)
    sa = tmesh.shard_arena_rows(a.h_src, a.h_offsets, a.host_dst(), 8)
    for k in (60, 900):
        f = np.unique(rng.integers(1, 3000, size=k))
        cap = _cap(a, f)
        want, wptr = jmesh.sharded_expand_segments(jm, jsa, f, cap)
        out, ptr = tmesh.sharded_expand_segments(m, sa, f, cap)
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(ptr, wptr)


def test_reassembly_is_device_side(monkeypatch):
    """No host reassembly: np.argsort / np.bincount are never called."""
    rng, a = _graph()
    m = _mesh(1, 8)
    sa = tmesh.shard_arena_rows(a.h_src, a.h_offsets, a.host_dst(), 8)
    f = np.unique(rng.integers(1, 500, size=40))
    want, wptr = a.expand_host(a.rows_for_uids_host(f))

    def banned(*_a, **_k):
        raise AssertionError("host reassembly used")

    monkeypatch.setattr(np, "argsort", banned)
    monkeypatch.setattr(np, "bincount", banned)
    out, ptr = tmesh.sharded_expand_segments(m, sa, f, _cap(a, f))
    monkeypatch.undo()
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(ptr, wptr)


def test_cap_below_the_frontier_edges_raises():
    rng, a = _graph()
    m = _mesh(1, 3)
    sa = tmesh.shard_arena_rows(a.h_src, a.h_offsets, a.host_dst(), 3)
    f = np.unique(rng.integers(1, 500, size=200))
    with pytest.raises(ValueError, match="exceeds its cap"):
        tmesh.sharded_expand_segments(m, sa, f, 8)


@pytest.mark.parametrize("data,model", GEOMS)
def test_sharded_two_hop_matches_reference(data, model):
    """The all_gather + sort_unique hop, twice: equal to the reference's
    on its 1×8 mesh (compiled once per cap pair, shared by the cases)."""
    rng, a = _graph(seed=5)
    f = np.unique(rng.integers(1, 500, size=30))
    m = _mesh(data, model)
    sa = tmesh.shard_arena_rows(
        a.h_src, a.h_offsets, a.host_dst(), model, devices=m.model_devices()
    )
    h1, h2 = tmesh.sharded_two_hop(m, sa, f, 512, 4096)
    jm = jmesh.make_mesh(8, data=1)
    jsa = jmesh.shard_arena_rows(a.h_src, a.h_offsets, a.host_dst(), 8)
    j1, j2 = jmesh.sharded_two_hop(jm, jsa, f, 512, 4096)
    np.testing.assert_array_equal(h1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(h2.numpy(), np.asarray(j2))


# -- the multi-hop program ----------------------------------------------------


@pytest.mark.parametrize("data,model", GEOMS)
@pytest.mark.parametrize("hops", [1, 3])
def test_mesh_multi_hop_matches_ops_multi_hop(data, model, hops):
    """Per-level frontiers and edge counts equal to the port's unsharded
    multi-hop pass (``ops.multi_hop``, its plain gather on the CPU)."""
    _rng, a = _graph(seed=3, n_uids=300, n_edges=1200)
    cap = 2048
    seed = np.array([1, 2, 3, 50], dtype=np.int64)
    m = _mesh(data, model)
    sa = tmesh.shard_arena_rows(
        a.h_src, a.h_offsets, a.host_dst(), model, devices=m.model_devices()
    )
    f = torch.from_numpy(ops.pad_to(seed, cap))
    fs, tot, final = programs.mesh_multi_hop_step(m, sa, f, cap, hops)
    vis = torch.full((cap,), SENT, dtype=torch.int32)
    wfs, wtot, _ = ops.multi_hop(
        a.offsets, a.dst, f.clone(), vis, hops, cap, lut=a.lut()
    )
    np.testing.assert_array_equal(fs.numpy(), wfs.numpy())
    np.testing.assert_array_equal(tot.numpy(), wtot.numpy())
    np.testing.assert_array_equal(final.numpy(), fs[-1].numpy())


def test_mesh_multi_hop_matches_reference_program():
    """Against ``dgraph_tpu.mesh.programs.mesh_multi_hop_step`` on the
    reference's 1×8 mesh: 3 hops, one shape."""
    from dgraph_tpu.mesh import programs as jprograms

    _rng, a = _graph(seed=3, n_uids=300, n_edges=1200)
    cap = 2048
    seed = ops.pad_to(np.array([1, 2, 3, 50]), cap)
    jm = jmesh.make_mesh(8, data=1)
    jsa = jmesh.shard_arena_rows(a.h_src, a.h_offsets, a.host_dst(), 8)
    step = jprograms.mesh_multi_hop_step(jm, cap, 3)
    jfs, jtot, _ = step(jsa.src, jsa.offsets, jsa.dst, jax.numpy.asarray(seed))
    m = _mesh(1, 8)
    sa = tmesh.shard_arena_rows(a.h_src, a.h_offsets, a.host_dst(), 8)
    fs, tot, _ = programs.mesh_multi_hop_step(
        m, sa, torch.from_numpy(seed), cap, 3
    )
    np.testing.assert_array_equal(fs.numpy(), np.asarray(jfs))
    np.testing.assert_array_equal(tot.numpy(), np.asarray(jtot))


@pytest.mark.parametrize("model", [1, 4, 8])
def test_exchange_bytes_matches_reference(model):
    from dgraph_tpu.mesh import programs as jprograms

    jm = jmesh.make_mesh(model, data=1)
    for cap in (8, 1024):
        assert programs.exchange_bytes_per_hop(_mesh(1, model), cap) == \
            jprograms.exchange_bytes_per_hop(jm, cap)


# -- the data axis --------------------------------------------------------------


@pytest.mark.parametrize("data,model", [(1, 1), (2, 4), (8, 1)])
def test_data_axis_batch_matches_reference(data, model):
    """[B, R] frontiers sharded over the data axis: final frontiers and
    per-hop counts equal to the reference's (its 2×4 mesh), B not a
    multiple of the data width."""
    from dgraph_tpu.models.arena import csr_dense_from_edges as jdense

    from dgraph_tpu_torch.models.arena import csr_dense_from_edges

    rng = np.random.default_rng(19)
    n = 256
    src = rng.integers(1, n, size=2000)
    dst = rng.integers(1, n, size=2000)
    a = csr_dense_from_edges(src, dst, n, device="cpu")
    ja = jdense(src, dst, n)
    frontiers = np.full((5, 16), SENT, dtype=np.int32)
    for i in range(5):
        u = np.unique(rng.integers(1, n, size=6))
        frontiers[i, : len(u)] = u
    m = _mesh(data, model)
    got_f, got_t = tmesh.batched_expand_frontiers(
        m, a.offsets, a.dst, frontiers, 1024, n_hops=2
    )
    jm = jmesh.make_mesh(8, data=2)
    want_f, want_t = jmesh.batched_expand_frontiers(
        jm, ja.offsets, ja.dst, frontiers, 1024, n_hops=2
    )
    np.testing.assert_array_equal(got_f, want_f)
    np.testing.assert_array_equal(got_t, want_t)


def test_data_axis_batch_raises_on_under_planned_cap():
    from dgraph_tpu_torch.models.arena import csr_dense_from_edges

    src = np.repeat(np.arange(1, 9), 8)
    dst = np.tile(np.arange(1, 9), 8)
    a = csr_dense_from_edges(src, dst, 16, device="cpu")
    frontiers = ops.pad_to(np.arange(1, 9), 8)[None]
    with pytest.raises(ValueError, match="exceeds cap"):
        tmesh.batched_expand_frontiers(_mesh(1, 1), a.offsets, a.dst, frontiers, 8)


# -- the tile tier --------------------------------------------------------------


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_sharded_tile_mask_matches_unsharded(n_shards):
    """The model-sharded mask expansion equals ``spgemm.expand_mask`` over
    the unsharded tiles, and the reference's sharded mask."""
    rng = np.random.default_rng(23)
    src = rng.integers(0, 200, size=1500)
    dst = rng.integers(0, 200, size=1500)
    a = csr_from_edges(src, dst, device="cpu")
    pt = spgemm.build_tiles(a.h_src, a.h_offsets, a.host_dst(), t=32,
                            device="cpu")
    m = _mesh(1, n_shards)
    sbi, sbj, stl = tmesh.shard_tiles(pt, n_shards, devices=m.model_devices())
    M = pt.nb * pt.t
    x = spgemm.uids_to_mask(
        torch.from_numpy(ops.pad_to(np.array([0, 3, 17, 150]), 8)), M
    )
    got = tmesh.tile_expand_step(m, sbi, sbj, stl, x)
    want = spgemm.expand_mask(pt.bi.long(), pt.bj.long(), pt.tiles, x)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if n_shards == 8:
        from dgraph_tpu.ops import spgemm as jspgemm

        jpt = jspgemm.build_tiles(a.h_src, a.h_offsets, a.host_dst(), t=32)
        jm = jmesh.make_mesh(8, data=1)
        jb = jmesh.shard_tiles(jpt, 8)
        jx = jax.numpy.asarray(x.numpy())
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jmesh.sharded_expand_mask(jm, *jb, jx))
        )


# -- placement, fault attribution, crossover -----------------------------------


@pytest.mark.parametrize("off", [0, 1, 3, 7])
def test_rolled_matches_reference_roll(off):
    from dgraph_tpu.mesh.plan import MeshPlan as JPlan

    _rng, a = _graph()
    sa = tmesh.shard_arena_rows(a.h_src, a.h_offsets, a.host_dst(), 8)
    jsa = jmesh.shard_arena_rows(a.h_src, a.h_offsets, a.host_dst(), 8)
    got = _host(MeshPlan.rolled(sa, off))
    want = JPlan.rolled(jsa, off)
    for g, w in zip(got, (want.src, want.offsets, want.dst)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_mesh_plan_matches_reference(tmp_path):
    """The same placements, rebalance and preview as the reference's
    plan for the same sequence, and a persisted plan reloads."""
    from dgraph_tpu.mesh.plan import MeshPlan as JPlan

    seq = [("e", 900), ("name", 300), ("~e", 800), ("f", 50), ("g", 700)]
    tp, jp = MeshPlan(4, path=str(tmp_path / "p.json")), JPlan(4)
    for pred, nb in seq:
        assert tp.offset_for(pred, nb) == jp.offset_for(pred, nb)
    assert tp.preview(3) == jp.preview(3)
    assert tp.rebalance(n_shards=3) == jp.rebalance(n_shards=3)
    assert tp.version == jp.version
    again = MeshPlan.load(3, path=str(tmp_path / "p.json"))
    assert again.placement == tp.placement and again.version == tp.version
    assert MeshPlan.load(4, path=str(tmp_path / "p.json")).placement == {}


class _DistinctMesh:
    distinct = True


def test_chip_scope_attributes_a_fault_on_distinct_cards():
    with pytest.raises(devguard.ChipFaultError) as ei:
        with tmesh._on_chip(_DistinctMesh(), 2, torch.device("cpu")):
            raise OSError("link down")
    assert devguard.chip_of(ei.value) == 2
    assert devguard.classify(ei.value) == "transient"
    # virtual chips of one card: the fault is the whole card's
    with pytest.raises(OSError):
        with tmesh._on_chip(_mesh(1, 3), 2, torch.device("cpu")):
            raise OSError("link down")
    # a shape bug is never attributed or masked
    with pytest.raises(ValueError):
        with tmesh._on_chip(_DistinctMesh(), 1, torch.device("cpu")):
            raise ValueError("bad shape")


def test_crossover_constants_are_the_cards():
    assert crossover.GATHER_NS_L2 > 0 and crossover.GATHER_NS_HBM > 0
    assert crossover.ON_CARD_COPY_BYTES_PER_S > 0
    assert crossover.HBM_TOTAL == 80 << 30
    assert crossover.L2_BYTES == 50 << 20
