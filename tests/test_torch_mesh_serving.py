"""The mesh serving plane end to end on the port (the counterpart of
``tests/test_mesh_serving.py`` and ``tests/test_mesh_engine.py``): one
``DgraphServer`` drives a mesh of 8 CPU shards, every predicate sharded
(``DGRAPH_TPU_MESH_SHARD_ROWS=1``).

Pinned here, every body compared byte for byte:
- the mesh server answers as the port's unsharded server and the
  reference's unsharded engine, before and after a mutation;
- ``MeshPlan`` placement is invisible in results;
- ``?ledger=true`` charges the mesh width and the exchange payload;
- merged cohort hops ride ``route: mesh`` unchanged;
- a fused mesh chain answers as the per-level one;
- an un-attributed fault re-plans the level on the unsharded routes with
  the ``degraded.device`` disclosure, and the mesh serves again after."""

import json
import threading
import urllib.request

import numpy as np
import pytest

from dgraph_tpu.models import PostingStore as JaxStore
from dgraph_tpu.query import QueryEngine as JaxEngine
from dgraph_tpu_torch import gql
from dgraph_tpu_torch.models import PostingStore
from dgraph_tpu_torch.parallel import make_mesh
from dgraph_tpu_torch.query import QueryEngine
from dgraph_tpu_torch.sched import Cohort, HopMerger, SchedRequest
from dgraph_tpu_torch.serve.server import DgraphServer
from dgraph_tpu_torch.utils import devguard
from dgraph_tpu_torch.utils.failpoints import fail
from tests.torch_parity import REFERENCE_ENV
from torch_pins import pinned_planner  # noqa: F401

pytestmark = pytest.mark.usefixtures("pinned_planner")


def _post(addr, path, body):
    req = urllib.request.Request(addr + path, data=body.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read().decode())


_DATA = None


def _dataset(n=120, seed=3):
    """The reference's mesh-serving graph: ``n`` named nodes, 4 random
    ``link`` edges each."""
    global _DATA
    if _DATA is None:
        rng = np.random.default_rng(seed)
        lines = [f'<0x{i:x}> <name> "node {i}" .' for i in range(1, n + 1)]
        for i in range(1, n + 1):
            for d in rng.integers(1, n + 1, size=4):
                lines.append(f"<0x{i:x}> <link> <0x{d:x}> .")
        _DATA = (
            "mutation { schema { name: string @index(term) . "
            "link: uid @reverse @count . } set { %s } }" % "\n".join(lines)
        )
    return _DATA


QUERIES = [
    "{ q(func: uid(0x1)) { name link { name link { name } } } }",
    "{ q(func: uid(0x2, 0x3, 0x5)) { link @filter(ge(count(link), 1)) { _uid_ } } }",
    "{ q(func: uid(0x4)) { count(link) count(~link) } }",
    "{ q(func: uid(0x1)) @recurse(depth: 3) { name link } }",
    "{ q(func: uid(0x1, 0x9)) { ~link { name } } }",
]
CHAIN = ("{ var(func: uid(0x1, 0x2, 0x3)) { link { link { f as link } } } "
         "q(func: uid(f)) { count() } }")
MUTATION = 'mutation { set { <0x1> <link> <0x70> . <0x70> <name> "NEW" . } }'


def _boot(monkeypatch, width=8, cache="1", data=1, **env):
    """A loaded loopback server on the CPU: a mesh of ``width`` CPU
    shards (``width=0``: unsharded), every predicate sharded."""
    monkeypatch.setenv("DGRAPH_TPU_MESH_SHARD_ROWS", "1")
    monkeypatch.setenv("DGRAPH_TPU_CACHE", cache)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    mesh = make_mesh(devices=["cpu"] * width, data=data) if width else None
    srv = DgraphServer(PostingStore(), device="cpu", mesh=mesh)
    srv.engine.expand_device_min = 1
    srv.start()
    _post(srv.addr, "/query", _dataset())
    return srv


def _ask(srv, q, path="/query"):
    out = _post(srv.addr, path, q)
    out.pop("server_latency", None)
    return out


def _reference(*mutations):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in REFERENCE_ENV.items():
            mp.setenv(k, v)
        eng = JaxEngine(JaxStore())
        for m in (_dataset(),) + mutations:
            eng.run(m)
        return eng


@pytest.mark.parametrize("data", [1, 2])
def test_server_byte_identity_sharded_vs_unsharded(monkeypatch, data):
    plain = _boot(monkeypatch, width=0)
    meshed = _boot(monkeypatch, data=data)
    try:
        ref = _reference()
        for q in QUERIES:
            a, b = _ask(plain, q), _ask(meshed, q)
            assert a == b, f"mesh serving diverged for {q}"
            assert "degraded" not in b
            assert b == ref.run(q)
        assert meshed.engine.arenas._sharded, "sharded route never taken"
        assert plain.engine.arenas.mesh is None
        # identical across a mutation: the sharded view follows the
        # arena's dirty invalidation
        _post(plain.addr, "/query", MUTATION)
        _post(meshed.addr, "/query", MUTATION)
        ref = _reference(MUTATION)
        for q in QUERIES:
            b = _ask(meshed, q)
            assert _ask(plain, q) == b == ref.run(q)
        assert '"NEW"' in json.dumps(_ask(meshed, QUERIES[0]))
    finally:
        plain.stop()
        meshed.stop()


def test_every_hop_rides_route_mesh(monkeypatch):
    srv = _boot(monkeypatch, cache="0")
    try:
        out = _post(srv.addr, "/query?debug=true", QUERIES[0])
        routes = out["server_latency"]["engine"]["routes"]
        assert routes == {"mesh": 2}, routes
        decs = out["server_latency"]["engine"]["planner"]
        assert any(d["kind"] == "expand" and d["route"] == "mesh"
                   and d["width"] == 8 for d in decs), decs
    finally:
        srv.stop()


def test_mesh_plan_placement_is_byte_invisible(monkeypatch):
    srv = _boot(monkeypatch, cache="0")
    try:
        before = {q: _ask(srv, q) for q in QUERIES}
        plan = srv.engine.arenas.mesh_plan
        assert plan is not None and plan.placement
        with plan._lock:
            for i, pred in enumerate(list(plan.placement)):
                plan.placement[pred] = (
                    plan.placement[pred] + 1 + i
                ) % plan.n_shards or 1
            plan.version += 1
        after = {q: _ask(srv, q) for q in QUERIES}
        assert after == before, "placement leaked into results"
        sh = srv.engine.arenas._sharded
        assert sh and all(
            e[2] == plan.placement.get(("~" + k[0]) if k[1] else k[0], 0)
            for k, e in sh.items()
        )
        plan.rebalance()
        assert {q: _ask(srv, q) for q in QUERIES} == before
    finally:
        srv.stop()


def test_mesh_ledger_attributes_chips_and_exchange(monkeypatch):
    srv = _boot(monkeypatch, cache="0")
    try:
        led = _post(srv.addr, "/query?ledger=true", QUERIES[0])["extensions"]["ledger"]
        assert led["mesh_chips"] == 8, led
        assert led["exchange_bytes"] > 0, led
        assert led["mesh_ms"] > 0, led
        assert led["hops"] == {"mesh": 2}, led
        plain = _boot(monkeypatch, width=0, cache="0")
        try:
            led = _post(plain.addr, "/query?ledger=true",
                        QUERIES[0])["extensions"]["ledger"]
            assert "mesh_chips" not in led and "exchange_bytes" not in led
        finally:
            plain.stop()
    finally:
        srv.stop()


def test_merged_cohort_hops_ride_mesh(monkeypatch):
    """Three cohort members' hops on ``link`` merge into one union
    expansion over the mesh; each member gets its exact segments."""
    srv = _boot(monkeypatch, cache="0")
    plain = _boot(monkeypatch, width=0, cache="0")
    try:
        texts = ["{ q(func: uid(0x%x)) { link { name } } }" % u for u in (1, 2, 3)]
        reqs = [SchedRequest(gql.parse(t)) for t in texts]
        c = Cohort(("mesh",))
        c.reqs = reqs
        calls = []
        ex = srv.engine.arenas.mesh_executor()
        orig = ex.expand

        def counting(*a, **k):
            calls.append(len(a[2]))
            return orig(*a, **k)

        monkeypatch.setattr(ex, "expand", counting)
        srv.scheduler._flush(c, "full")
        outs = [r.wait()[0] for r in reqs]
        for t, o in zip(texts, outs):
            want = _ask(plain, t)
            assert json.loads(json.dumps(o)) == want
        assert calls and len(calls) < 3, calls  # the union rode the mesh once
    finally:
        srv.stop()
        plain.stop()


def test_merged_engine_hops_one_mesh_dispatch(monkeypatch):
    """Engine shells over one ArenaManager merge the same hop through a
    HopMerger: one mesh expansion of the union, each member's (out,
    seg_ptr) equal to its solo expansion."""
    monkeypatch.setenv("DGRAPH_TPU_CACHE", "0")
    base = QueryEngine(PostingStore(), device="cpu",
                       mesh=make_mesh(devices=["cpu"] * 4), shard_threshold=1)
    base.run(_dataset())
    base.expand_device_min = 1
    arena = base.arenas.data("link")
    rng = np.random.default_rng(5)
    srcs = [np.unique(rng.integers(1, 121, 12)) for _ in range(3)]
    solo = [base.expander._expand_one(arena, s, None, "link") for s in srcs]
    merger = HopMerger(expected=3, window_s=30.0)
    shells = []
    for _ in srcs:
        sh = QueryEngine(base.store, arenas=base.arenas)
        sh.expander.hop_merger = merger
        shells.append(sh)
    got = [None] * 3

    def run(i):
        got[i] = shells[i].expander.expand(arena, srcs[i], attr="link")

    ts = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    for (go, gs), (so, ss) in zip(got, solo):
        assert np.array_equal(go, so) and np.array_equal(gs, ss)
    routes = [sh.stats["routes"] for sh in shells]
    assert sum(r.get("merged", 0) for r in routes) == 2, routes
    assert sum(r.get("mesh", 0) for r in routes) == 1, routes


def test_fused_mesh_chain_equals_per_level(monkeypatch):
    srv = _boot(monkeypatch, cache="0")
    try:
        srv.engine.chain_threshold = 0
        fused = _post(srv.addr, "/query?debug=true", CHAIN)
        eng = fused.pop("server_latency")["engine"]
        assert eng["chain_fused_levels"] == 3, eng.get("chain_reject")
        srv.engine.chain_threshold = 1 << 62
        per = _post(srv.addr, "/query?debug=true", CHAIN)
        eng = per.pop("server_latency")["engine"]
        assert eng["chain_fused_levels"] == 0
        assert eng["routes"].get("mesh", 0) >= 3, eng["routes"]
        assert fused == per
        assert fused == _reference().run(CHAIN)
    finally:
        srv.stop()


def test_engine_correct_after_mutation():
    """Mutate, then query over the mesh: the sharded view follows the
    arena's dirty invalidation, never serves stale shards."""
    eng = QueryEngine(PostingStore(), device="cpu",
                      mesh=make_mesh(devices=["cpu"] * 8, data=2),
                      shard_threshold=1)
    eng.run(_dataset())
    eng.expand_device_min = 1
    q = QUERIES[0]
    before = eng.run(q)
    mut = 'mutation { set { <0x1> <link> <0x3e8> . <0x3e8> <name> "NEW" . } }'
    eng.run(mut)
    after = eng.run(q)
    assert after != before
    assert after == _reference(mut).run(q)


def test_chip_loss_unattributed_degrades_to_unsharded_then_recovers(monkeypatch):
    """An un-attributed fault inside a mesh dispatch re-plans that level
    on the unsharded routes: the body is the same, ``degraded.device``
    says so, the fault latched the mesh plane's guard only, and the spent
    failpoint leaves the next request on the mesh, undisclosed."""
    monkeypatch.setenv("DGRAPH_TPU_DEVICE_COOLDOWN_S", "0.1")
    devguard.reset_for_tests()
    srv = _boot(monkeypatch, cache="0")
    try:
        q = QUERIES[0]
        baseline = _ask(srv, q)
        fail.seed(0)
        fail.arm("device.mesh", "error(n=1)")
        out = _ask(srv, q)
        deg = out.pop("degraded")
        assert out == baseline
        assert deg["device"]["failovers"] >= 1, deg
        assert "mesh" not in deg
        assert devguard.get("mesh").faults.get("transient", 0) >= 1
        assert devguard.get("device").faults == {}
        assert devguard.get("mesh").status()["failovers"] >= 1
        out2 = _ask(srv, q)
        assert out2 == baseline and "degraded" not in out2
    finally:
        fail.reset()
        devguard.reset_for_tests()
        srv.stop()


def test_fused_mesh_chain_unattributed_fault_is_disclosed(monkeypatch):
    """An un-attributed fault in the fused mesh chain declines the fused
    program, counted and disclosed (``degraded.device``); its levels then
    re-plan per level, never on the host, and the body is the
    reference's."""
    monkeypatch.setenv("DGRAPH_TPU_DEVICE_COOLDOWN_S", "60")
    devguard.reset_for_tests()
    srv = _boot(monkeypatch, cache="0")
    try:
        srv.engine.chain_threshold = 0
        fail.seed(0)
        fail.arm("device.mesh", "error(n=1)")
        out = _post(srv.addr, "/query?debug=true", CHAIN)
        eng = out.pop("server_latency")["engine"]
        deg = out.pop("degraded")
        assert fail.hits("device.mesh") >= 1
        assert deg["device"]["failovers"] >= 1, deg
        # the faulted program declined; the first level re-ran alone and
        # the rest fused again on the healthy plane
        assert eng["chain_fused_levels"] < 3
        assert eng["routes"].get("mesh", 0) >= 1, eng["routes"]
        assert "host" not in eng["routes"], eng["routes"]
        assert out == _reference().run(CHAIN)
        assert devguard.get("mesh").status()["failovers"] >= 1
    finally:
        fail.reset()
        devguard.reset_for_tests()
        srv.stop()


def test_health_detail_has_mesh_section(monkeypatch):
    srv = _boot(monkeypatch)
    try:
        h = json.loads(urllib.request.urlopen(
            srv.addr + "/health?detail=1", timeout=30).read())
        m = h["mesh"]
        assert m["chips_total"] == 8 and m["chips_healthy"] == 8
        assert m["elastic"] is True
        assert set(m["chips"]) == {str(i) for i in range(8)}
    finally:
        srv.stop()


def test_auto_mesh_tri_state(monkeypatch):
    """``DGRAPH_TPU_MESH`` over the visible cards: off never, auto only
    with two cards or more, force always — for a server on a card only;
    and without a GPU force raises (no CPU fallback)."""
    import torch

    from dgraph_tpu_torch.serve.server import _auto_mesh

    monkeypatch.setenv("DGRAPH_TPU_MESH", "0")
    assert _auto_mesh() is None
    monkeypatch.setenv("DGRAPH_TPU_MESH", "auto")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert _auto_mesh() is None
    # a server on the CPU never gets a mesh of the cards
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert _auto_mesh("cpu") is None
    monkeypatch.setenv("DGRAPH_TPU_MESH", "force")
    assert _auto_mesh("cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        _auto_mesh()


def test_use_mesh_for_policies(monkeypatch):
    """Virtual chips shard at the threshold; a mesh of distinct cards
    also asks the crossover model, which keeps a small arena on one
    card."""
    import torch

    from dgraph_tpu_torch.models.arena import ArenaManager

    eng = QueryEngine(PostingStore(), device="cpu",
                      mesh=make_mesh(devices=["cpu"] * 8), shard_threshold=1)
    eng.run(_dataset())
    a = eng.arenas.data("link")
    assert eng.arenas.use_mesh_for(a)
    cards = make_mesh(devices=[torch.device("cpu", i) for i in range(8)])
    am = ArenaManager(eng.store, device="cpu", mesh=cards, shard_threshold=1)
    assert am.mesh.distinct and not am.use_mesh_for(a)
    eng.arenas.shard_threshold = a.n_rows + 1
    assert not eng.arenas.use_mesh_for(a)


def test_residency_counts_sharded_bytes(monkeypatch):
    srv = _boot(monkeypatch, cache="0")
    try:
        _ask(srv, QUERIES[0])
        r = srv.engine.arenas.residency()
        sb = sum(e[1].device_bytes()
                 for e in srv.engine.arenas._sharded.values())
        assert r["sharded_bytes"] == sb > 0
        assert r["resident_bytes"] >= sb
    finally:
        srv.stop()
