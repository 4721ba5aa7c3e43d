"""The port's tile join route (``dgraph_tpu_torch/query/joinplan.py``
``try_mxu_route``, reached from ``query/chain.py``) and its IVM repairs
against the reference's, engine by engine.

The reference runs with ``DGRAPH_TPU_PLANNER=0`` (the port has no
calibrated planner: its cost compare is the reference's planner-off
branch) plus ``REFERENCE_ENV``; both engines fuse every chain
(``chain_threshold`` 0) at T = 8, so the small graphs of
``tests/test_spgemm.py`` span many blocks.  Covered:

- ``TRI_Q``, ``KWAY_Q`` and light chains (a 2-hop count, a 3-hop, a
  keep-set AND, a 3-hop in segments) under ``DGRAPH_TPU_MXU_JOIN`` 0 / 1 /
  force: bodies byte-identical, ``join_routes`` decisions equal;
- the budget, mask-lanes and one-hot refusals, recorded alike;
- the hop-cache repair: the same mutations applied to both stores leave
  the same entries, the same hit / miss / stale counts and the same
  repair counts as the reference's ``HopCache``;
- ``/debug/store``'s ``join`` section through the port's server.

Tolerance: none (response bytes, decision dicts, entry arrays equal)."""

import json
import urllib.request

import numpy as np
import pytest

from dgraph_tpu.models.store import Edge as JEdge
from dgraph_tpu.models.store import PostingStore as JaxStore
from dgraph_tpu.models.types import TypedValue as JTypedValue
from dgraph_tpu.query import QueryEngine as JaxEngine
from dgraph_tpu.query import joinplan as jjoin
from dgraph_tpu.utils.metrics import IVM_REPAIRS as J_IVM_REPAIRS
from dgraph_tpu.utils.metrics import QCACHE_HOP_EVENTS as J_HOP_EVENTS
from dgraph_tpu_torch import ivm as tivm
from dgraph_tpu_torch.models.store import Edge, PostingStore
from dgraph_tpu_torch.models.types import TypeID, TypedValue
from dgraph_tpu_torch.query import QueryEngine
from dgraph_tpu_torch.query import joinplan as tjoin
from dgraph_tpu_torch.serve.server import DgraphServer
from dgraph_tpu_torch.utils import metrics as tmetrics

from tests.test_spgemm import KWAY_Q, SCHEMA, TRI_Q, _seed_store
from tests.torch_parity import REFERENCE_ENV, body, port_store_of
from torch_pins import pinned_planner  # noqa: F401

# every route decision of both planners is pinned (tests/torch_pins.py)
pytestmark = pytest.mark.usefixtures("pinned_planner")

T = 8

QUERIES = {
    "triangle": TRI_Q,
    "kway": KWAY_Q,
    "chain2_count": (
        '{ var(func: anyofterms(name, "ann bob")) { e1 { f as e2 } } '
        'q(func: uid(f)) { count(uid) } }'),
    "chain3": (
        '{ var(func: has(e1)) { e1 { e2 { f as e1 } } } '
        'q(func: uid(f)) { name } }'),
    "keep_and": (
        '{ var(func: anyofterms(name, "ann bob cat")) '
        '{ e1 { t as e2 @filter(has(e3) AND has(e4)) } } '
        'q(func: uid(t)) { name } }'),
    "chain3_both_vars": (
        '{ var(func: anyofterms(name, "dan eve")) '
        '{ a as e1 { e3 { b as ~e2 } } } '
        'q(func: uid(a, b)) { name } }'),
}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k, v in REFERENCE_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DGRAPH_TPU_PLANNER", "0")
    monkeypatch.setenv("DGRAPH_TPU_TILE", str(T))


@pytest.fixture(scope="module")
def reference_store():
    return _seed_store()


def _pair(st):
    jeng = JaxEngine(st)
    jeng.chain_threshold = 0
    teng = QueryEngine(port_store_of(st), device="cpu")
    teng.chain_threshold = 0
    return jeng, teng


def _routes(eng):
    return eng.stats.get("join_routes", [])


@pytest.mark.parametrize("mode", ["0", "1", "force"])
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_routes_and_bodies_match_the_reference(query, mode, reference_store,
                                               monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_MXU_JOIN", mode)
    jeng, teng = _pair(reference_store)
    text = QUERIES[query]
    want = body(jeng.run(text))
    assert body(teng.run(text)) == want
    assert json.loads(want)["q"], "the case must match something"
    assert _routes(teng) == _routes(jeng)
    mxu = [d for d in _routes(teng) if d["route"] == "mxu"]
    if mode == "0":
        assert not _routes(teng)
    if mode == "force" and query != "kway":
        assert mxu, teng.stats["chain_reject"]
    if mxu:
        assert teng.stats["mxu_join_ms"] > 0 and jeng.stats["mxu_join_ms"] > 0
        assert teng.stats["tile_build_ms"] > 0
    if query == "triangle" and mxu:
        assert mxu[0]["shape"] == "triangle"


def test_segmented_mask_chain_matches_the_reference(reference_store,
                                                    monkeypatch):
    """A seam every level (DGRAPH_TPU_SEGMENT=force, k 1): the segmented
    chain answers as the whole one does, in both packages."""
    monkeypatch.setenv("DGRAPH_TPU_MXU_JOIN", "force")
    monkeypatch.setenv("DGRAPH_TPU_SEGMENT", "force")
    monkeypatch.setenv("DGRAPH_TPU_SEGMENT_K", "1")
    for q in ("chain3", "chain3_both_vars", "triangle"):
        jeng, teng = _pair(reference_store)
        seg0 = tmetrics.SEGMENT_DISPATCHES.snapshot().get("mask_chain", 0)
        assert body(teng.run(QUERIES[q])) == body(jeng.run(QUERIES[q]))
        assert _routes(teng) == _routes(jeng)
        assert tmetrics.SEGMENT_DISPATCHES.snapshot()["mask_chain"] == seg0 + 1


def test_drained_frontier_exits_early(monkeypatch):
    """A frontier drained after the first level stops the segmented
    chain: the remaining levels are empty, as the reference makes them."""
    monkeypatch.setenv("DGRAPH_TPU_MXU_JOIN", "force")
    monkeypatch.setenv("DGRAPH_TPU_SEGMENT", "force")
    monkeypatch.setenv("DGRAPH_TPU_SEGMENT_K", "1")
    st = _seed_store()
    # e4's targets all lie in uids 1..60; a leaf uid 70 owns no e2 row
    st.apply(JEdge(pred="e4", src=70, dst=71))
    q = ('{ var(func: uid(0x46)) { e4 { e2 { f as e1 } } } '
         'q(func: uid(f)) { count(uid) } }')
    jeng, teng = _pair(st)
    y0 = tmetrics.SEGMENT_YIELDS.snapshot().get("early_exit", 0)
    assert body(teng.run(q)) == body(jeng.run(q))
    assert _routes(teng) == _routes(jeng) and _routes(teng)[0]["route"] == "mxu"
    assert tmetrics.SEGMENT_YIELDS.snapshot()["early_exit"] == y0 + 1


def _arena_blocks(teng, preds):
    return [teng.arenas.data(p).tile_blocks()[0] for p in preds]


@pytest.mark.parametrize("refusal", ["budget", "mask", "one_hot"])
def test_refusals_are_recorded_alike(refusal, reference_store, monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_MXU_JOIN", "force")
    if refusal == "budget":
        monkeypatch.setenv("DGRAPH_TPU_TILE_BUDGET", "1")
        reason = "tile budget exceeded"
    elif refusal == "mask":
        monkeypatch.setenv("DGRAPH_TPU_MXU_MASK_MAX", str(T))
        reason = "lanes over DGRAPH_TPU_MXU_MASK_MAX"
    else:
        # T 2: 31 blocks a side, so the [Kb, NB] one-hot operand outgrows
        # a budget that still holds every tile set of the chain
        from dgraph_tpu_torch.ops import spgemm

        monkeypatch.setenv("DGRAPH_TPU_TILE", "2")
        _j, probe = _pair(reference_store)
        ks = _arena_blocks(probe, ("e1", "e2"))
        budget = max(spgemm.est_tile_bytes(k, 2) for k in ks)
        m = spgemm.mask_lanes(61, 2)
        assert max(spgemm.bucket(k) * (m // 2) * 4 for k in ks) > budget
        monkeypatch.setenv("DGRAPH_TPU_TILE_BUDGET", str(budget))
        reason = "one-hot combine operand over tile budget"
    jeng, teng = _pair(reference_store)
    assert body(teng.run(TRI_Q)) == body(jeng.run(TRI_Q))
    routes = _routes(teng)
    assert routes == _routes(jeng)
    assert routes[0]["route"] == "pairwise" and reason in routes[0]["reason"]
    assert teng.stats["mxu_join_ms"] == 0.0


def test_tiles_are_built_once_per_arena(reference_store, monkeypatch):
    """The second chain over the same arenas reuses their tiles (and the
    cost model stops charging a build, as in the reference)."""
    monkeypatch.setenv("DGRAPH_TPU_MXU_JOIN", "force")
    jeng, teng = _pair(reference_store)
    b0 = tmetrics.JOIN_TILE_BUILDS.value()
    for q in ("chain2_count", "chain2_count", "triangle"):
        assert body(teng.run(QUERIES[q])) == body(jeng.run(QUERIES[q]))
        assert _routes(teng) == _routes(jeng)
    # e1 and e2, built once each; the triangle's ~e3 leg runs per level
    assert tmetrics.JOIN_TILE_BUILDS.value() == b0 + 2


# ------------------------------------------------------- hop-cache repair


Q_E1 = "{ q(func: uid(0x1, 0x2, 0x3)) { name e1 { name } } }"
Q_REV_E3 = "{ q(func: uid(0x3, 0x5, 0x9)) { ~e3 { name } } }"


def _entries(eng):
    """The hop cache's entries without the arena's id(): (attr, reverse,
    epoch, digest, version, out, seg_ptr, frontier)."""
    hc = eng.arenas.hop_cache
    with hc._c._lock:
        items = list(hc._c._m.items())
    return sorted(
        (k[1], k[2], k[3], k[4], e.version,
         e.value[0].tobytes(), e.value[1].tobytes(), e.value[2].tobytes())
        for k, e in items)


def _events(hop_events, ivm_repairs):
    ev = hop_events.snapshot()
    rep = ivm_repairs.snapshot()
    return ([ev.get(k, 0) for k in ("hit", "miss", "stale")]
            + [rep.get(("hop", k), 0) for k in ("repaired", "rebuild")])


# (step, edges written to both stores, IVM_REPAIR_MAX_DELTA, the query
# read after it).  One predicate's entries at a time: a put at another
# version reclaims them in the reference (its put-time sweep), while the
# port keeps them, live (cache/core.py; ROADMAP Queue 3 #1)
STEPS = [
    ("fill_e1", [], None, Q_E1),
    ("add_e1", [dict(pred="e1", src=1, dst=5)], None, Q_E1),
    ("facet_touch", [dict(pred="e1", src=1, dst=5, facets=("since", 7))],
     None, Q_E1),
    ("other_pred", [dict(pred="e4", src=2, dst=3)], None, Q_E1),
    ("over_cap", [dict(pred="e1", src=2, dst=d) for d in (7, 8, 11)], "2",
     Q_E1),
    ("fill_rev_e3", [], None, Q_REV_E3),
    ("del_e3_rev", [dict(pred="e3", src=1, dst=3, op="del")], None, Q_REV_E3),
    ("add_e3_rev", [dict(pred="e3", src=44, dst=9)], None, Q_REV_E3),
]


def _edge(cls, tv_cls, d):
    d = dict(d)
    if "facets" in d:
        k, v = d["facets"]
        d["facets"] = {k: tv_cls(TypeID.INT, v)}
    return cls(**d)


def _seeded(st, edge_cls, tv_cls, seed=3, n=60):
    """``_seed_store``'s graph written through ``st.apply`` in its order,
    so both packages' stores reach the same versions."""
    rng = np.random.default_rng(seed)
    st.apply_schema(SCHEMA)
    names = ["ann", "bob", "cat", "dan", "eve", "fay"]
    for u in range(1, n + 1):
        st.apply(edge_cls(pred="name", src=u, value=tv_cls(
            TypeID.STRING, f"{names[u % 6]} P{u}")))
        for pred, fan in (("e1", 5), ("e2", 5), ("e3", 3), ("e4", 3)):
            for v in rng.integers(1, n + 1, size=rng.integers(0, fan + 1)):
                st.apply(edge_cls(pred=pred, src=u, dst=int(v)))
    # the deletion step needs the edge 1 -e3-> 3
    st.apply(edge_cls(pred="e3", src=1, dst=3))
    return st


def test_hop_cache_repair_matches_the_reference(monkeypatch):
    monkeypatch.delenv("DGRAPH_TPU_CACHE")
    jst = _seeded(JaxStore(), JEdge, JTypedValue)
    tst = _seeded(PostingStore(), Edge, TypedValue)
    assert tst.version == jst.version
    assert tst.pred_versions == jst.pred_versions
    jeng, teng = JaxEngine(jst), QueryEngine(tst, device="cpu")
    assert jeng.arenas.hop_cache is not None and teng.arenas.hop_cache is not None
    # both directions' arenas of e3 are cached, so its deltas patch them
    # (a delta whose data arena is not cached rebuilds instead)
    for eng in (jeng, teng):
        eng.arenas.data("e3")
        eng.arenas.reverse("e3")
    seen = []
    for name, edges, cap, q in STEPS:
        if cap is not None:
            monkeypatch.setenv("DGRAPH_TPU_IVM_REPAIR_MAX_DELTA", cap)
        for d in edges:
            jst.apply(_edge(JEdge, JTypedValue, d))
            tst.apply(_edge(Edge, TypedValue, d))
        j0 = _events(J_HOP_EVENTS, J_IVM_REPAIRS)
        t0 = _events(tmetrics.QCACHE_HOP_EVENTS, tmetrics.IVM_REPAIRS)
        assert body(teng.run(q)) == body(jeng.run(q)), name
        j1 = _events(J_HOP_EVENTS, J_IVM_REPAIRS)
        t1 = _events(tmetrics.QCACHE_HOP_EVENTS, tmetrics.IVM_REPAIRS)
        got = [b - a for a, b in zip(t0, t1)]
        assert got == [b - a for a, b in zip(j0, j1)], name
        # the reference's entries, and besides them only the port's live
        # entries that the reference's sweep reclaimed: each at its
        # predicate's current version
        tent, jent = set(_entries(teng)), set(_entries(jeng))
        assert jent <= tent, name
        for ent in tent - jent:
            assert ent[4] == tivm.hop_version(tst, ent[0]), (name, ent[:5])
        monkeypatch.delenv("DGRAPH_TPU_IVM_REPAIR_MAX_DELTA", raising=False)
        seen.append((name, got))
    # (hit, miss, stale, repaired, rebuild) per step: the repairs ran, and
    # each repaired or re-keyed entry was read back as a hit
    by = dict(seen)
    for name in ("add_e1", "facet_touch", "other_pred", "del_e3_rev",
                 "add_e3_rev"):
        assert by[name][0] == 1 and by[name][1] == 0, (name, by[name])
    for name in ("add_e1", "del_e3_rev", "add_e3_rev"):
        assert by[name][3] == 1, (name, by[name])
    assert by["over_cap"][:2] == [0, 1] and by["over_cap"][3] == 0


# ---------------------------------------------------------- /debug/store


def test_debug_store_join_section_through_the_server(reference_store,
                                                     monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_MXU_JOIN", "force")
    monkeypatch.setenv("DGRAPH_TPU_KWAY_DEVICE_MIN", "1")
    jjoin._reset_for_tests()
    jeng = JaxEngine(reference_store)
    jeng.chain_threshold = 0
    for q in (TRI_Q, KWAY_Q):
        jeng.run(q)
    want = jjoin.debug_summary()
    tjoin._reset_for_tests()
    srv = DgraphServer(port_store_of(reference_store), device="cpu")
    srv.engine.chain_threshold = 0
    srv.start()
    try:
        for q in (TRI_Q, KWAY_Q):
            req = urllib.request.Request(srv.addr + "/query", data=q.encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.status == 200
        with urllib.request.urlopen(srv.addr + "/debug/store", timeout=60) as r:
            dbg = json.loads(r.read())
    finally:
        srv.stop()
    assert dbg["join"] == want
    assert dbg["join"]["counts"]["mxu"] >= 1
    assert dbg["join"]["counts"]["kway_device"] >= 1
    assert set(dbg) >= {"predicates", "qcache", "ivm", "qos", "join"}
    assert dbg["predicates"]["e1"]["edges"] == sum(
        len(s) for s in reference_store.peek("e1").edges.values())
