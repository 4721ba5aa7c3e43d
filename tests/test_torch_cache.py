"""The port's two query cache tiers (``dgraph_tpu_torch/cache/``) and
predicate versions (``dgraph_tpu_torch/ivm/versions.py``) against the
reference's: ``VersionedLFUCache`` admission and eviction equal to
``dgraph_tpu.cache``'s on seeded op sequences, the digests, ``cacheable``,
``store.pred_versions`` / ``pred_floor`` and the derived hop / result
versions equal after the same mutations; then the port's own contracts —
a hop-cache hit launches nothing, a write to another predicate keeps the
hit while a write to the same one is repaired in place (or misses with
the repair off), an arena eviction drops the arena's entries, and the result cache answers repeats and
never serves a response older than a write to what it read.

Tolerance 0 throughout (equal values, equal bytes)."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from dgraph_tpu import gql as jgql
from dgraph_tpu import ivm as jivm
from dgraph_tpu.cache import VersionedLFUCache as JaxLFU
from dgraph_tpu.cache import cacheable as jax_cacheable
from dgraph_tpu.cache import frontier_digest as jax_frontier_digest
from dgraph_tpu.cache import request_digest as jax_request_digest
from dgraph_tpu.models import PostingStore as JaxStore
from dgraph_tpu_torch import gql, ivm
from dgraph_tpu_torch import ops as tops
from dgraph_tpu_torch.bench2hop import gen_edges
from dgraph_tpu_torch.cache import (
    VersionedLFUCache,
    cacheable,
    frontier_digest,
    request_digest,
)
from dgraph_tpu_torch.models import PostingStore
from dgraph_tpu_torch.models.store import Edge
from dgraph_tpu_torch.query import QueryEngine
from dgraph_tpu_torch.serve.server import DgraphServer
from dgraph_tpu_torch.utils.metrics import QCACHE_RESULT_EVENTS

from tests.test_torch_sched import _jax_edge, _mutate
from torch_pins import pinned_planner  # noqa: F401

# every route decision of both planners is pinned (tests/torch_pins.py)
pytestmark = pytest.mark.usefixtures("pinned_planner")

N_NODES, N_EDGES = 300, 1500


# ------------------------------------------------------------ core policy


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lfu_matches_reference_on_a_seeded_op_sequence(seed):
    """Puts (some over the per-entry cap), gets at live and other
    versions, live probes, drops and clears on a small budget, so
    admission, refusal, stale reclaim, aging and eviction all run: both
    caches answer every op alike and hold the same bytes after it.

    Every put is at one version: the reference's put-time generation
    sweep reclaims entries of other versions, which the port does not do
    (``test_sweep_keeps_an_entry_of_another_footprint``), so the two
    agree on sequences where a put never meets an entry of another
    version."""
    rng = np.random.default_rng(seed)
    kw = dict(budget_bytes=4000, age_interval=16)
    mine, ref = VersionedLFUCache(**kw), JaxLFU(sweep_limit=4, **kw)
    for step in range(1500):
        op = rng.random()
        key = "k%d" % rng.integers(0, 40)
        ver = int(rng.integers(0, 3))
        if op < 0.45:
            nb = int(rng.choice([50, 120, 300, 700]))
            assert mine.put(key, 1, step, nb) == ref.put(key, 1, step, nb)
        elif op < 0.9:
            g, w = mine.get(key, ver), ref.get(key, ver)
            assert (g is None) == (w is None), step
            if g is not None:
                assert g[0] == w[0], step
        elif op < 0.97:
            assert mine.contains(key, ver) == ref.contains(key, ver)
        elif op < 0.995:
            cut = int(rng.integers(0, 40))
            assert (mine.drop_where(lambda k: int(k[1:]) < cut)
                    == ref.drop_where(lambda k: int(k[1:]) < cut))
        else:
            mine.clear()
            ref.clear()
        assert len(mine) == len(ref), step
        assert mine.occupancy_bytes == ref.occupancy_bytes, step


def test_sweep_keeps_an_entry_of_another_footprint():
    """An entry is keyed on its own footprint's version (ivm/versions.py):
    ``a`` read only ``e`` (version 1), ``b`` read ``e`` and ``name``
    (written last, version 2).  Nothing ``a`` read changed, so ``a`` is
    live; the reference's put-time sweep reclaims it all the same, and
    the port keeps it."""
    from dgraph_tpu_torch.models.types import TypeID, TypedValue

    st = PostingStore()
    st.apply(Edge(pred="e", src=1, dst=2))
    st.apply(Edge(pred="name", src=1, value=TypedValue(TypeID.STRING, "x")))
    va = ivm.version_for(st, ["e"])
    vb = ivm.version_for(st, ["e", "name"])
    assert va < vb == st.version
    mine, ref = VersionedLFUCache(4000), JaxLFU(4000)
    for c in (mine, ref):
        assert c.put("a", va, "A", 100)
        assert c.put("b", vb, "B", 100)
    assert ref.get("a", va) is None  # the reference swept a live entry
    assert len(ref) == 1
    hit = mine.get("a", va)
    assert hit is not None and hit[0] == "A"
    assert mine.get("b", vb)[0] == "B" and len(mine) == 2


def test_digests_match_reference():
    rng = np.random.default_rng(4)
    for n in (0, 1, 17, 4096):
        src = rng.integers(0, 1 << 40, n)
        assert frontier_digest(src) == jax_frontier_digest(src)
        assert frontier_digest(src[::-1]) == jax_frontier_digest(src[::-1])
    for key in [("{ q(func: uid(0x1)) { uid } }", "", False),
                ("{ q(func: uid($a)) { uid } }", '{"$a": "0x2"}', True)]:
        assert request_digest(key) == jax_request_digest(key)


CACHEABLE = [
    "{ q(func: uid(0x1)) { uid e { uid } } }",
    "{ q(func: uid(0x1)) { d as dob x: math(since(d)) } }",
    "{ q(func: uid(0x1)) { e { d as dob x: math(1 + since(d)) } } }",
    "mutation { set { <0x1> <e> <0x2> . } }",
]


@pytest.mark.parametrize("i", range(len(CACHEABLE)))
def test_cacheable_matches_reference(i):
    text = CACHEABLE[i]
    assert cacheable(gql.parse(text)) == jax_cacheable(jgql.parse(text))


# ------------------------------------------------------ predicate versions


def _schema_last(st, edge_cls):
    rng = np.random.default_rng(9)
    st.bulk_set_uid_edges("g", rng.integers(1, 30, 20), rng.integers(1, 30, 20))
    st.apply(edge_cls(pred="e", src=1, dst=2))
    st.apply(edge_cls(pred="g", src=1, dst=2, op="del"))
    st.apply_schema("g: uid @reverse .")
    st.apply(edge_cls(pred="h", src=5, dst=6))
    return st


@pytest.mark.parametrize("seq", [_mutate, _schema_last])
def test_pred_versions_match_reference(seq):
    jst = seq(JaxStore(), _jax_edge)
    tst = seq(PostingStore(), Edge)
    assert tst.version == jst.version
    assert tst.pred_versions == jst.pred_versions
    assert tst.pred_floor == jst.pred_floor


VERSIONED = [
    "{ q(func: uid(0x1)) { uid e { uid } } }",
    "{ q(func: uid(0x1)) { f { name } } }",
    "{ q(func: uid(0x1)) { expand(_all_) } }",
    "schema(pred: [name]) { type }",
]


@pytest.mark.parametrize("i", range(len(VERSIONED)))
def test_scoped_versions_match_reference(i):
    jst = _mutate(JaxStore(), _jax_edge)
    tst = _mutate(PostingStore(), Edge)
    text = VERSIONED[i]
    assert (ivm.result_version(tst, gql.parse(text))
            == jivm.result_version(jst, jgql.parse(text)))
    for pred in ("e", "f", "name", "zzz"):
        assert ivm.hop_version(tst, pred) == jivm.hop_version(jst, pred)


# ------------------------------------------------------------- hop cache


@pytest.fixture()
def hop_engine(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_RESIDENT", "force")
    src, dst = gen_edges(N_NODES, N_EDGES)
    st = PostingStore()
    st.bulk_set_uid_edges("e", src, dst)
    st.bulk_set_uid_edges("f", dst, src)
    eng = QueryEngine(st, device="cpu")
    eng.expand_device_min = 1
    calls = []
    gather = tops.gather_packed

    def counting(*a, **k):
        calls.append(1)
        return gather(*a, **k)

    monkeypatch.setattr(tops, "gather_packed", counting)
    seeds = ", ".join("0x%x" % u for u in np.unique(src)[:20])
    return eng, calls, "{ q(func: uid(%s)) { uid e { uid } } }" % seeds


def test_hop_cache_hit_launches_nothing(hop_engine):
    eng, calls, q = hop_engine
    first = json.dumps(eng.run(q))
    assert len(calls) == 1 and eng.stats["routes"] == {"resident": 1}
    second = json.dumps(eng.run(q))
    assert second == first
    assert len(calls) == 1 and eng.stats["routes"] == {"cache": 1}


def test_hop_cache_other_predicate_write_keeps_the_hit(hop_engine):
    eng, calls, q = hop_engine
    first = json.dumps(eng.run(q))
    eng.run("mutation { set { <0x1> <f> <0x2> . } }")
    assert json.dumps(eng.run(q)) == first
    assert len(calls) == 1 and eng.stats["routes"] == {"cache": 1}


def test_hop_cache_same_predicate_write_misses(hop_engine, monkeypatch):
    # DGRAPH_TPU_IVM_REPAIR=0 pins the drop contract; the in-place repair
    # is test_hop_cache_same_predicate_write_repairs below
    monkeypatch.setenv("DGRAPH_TPU_IVM_REPAIR", "0")
    eng, calls, q = hop_engine
    eng.run(q)
    seed = int(q.split("uid(")[1].split(",")[0], 16)
    eng.run("mutation { set { <0x%x> <e> <0x%x> . } }" % (seed, N_NODES + 5))
    out = eng.run(q)
    assert len(calls) == 2 and eng.stats["routes"] == {"resident": 1}
    kids = {k.get("uid", k.get("_uid_")) for k in out["q"][0]["e"]}
    assert "0x%x" % (N_NODES + 5) in kids
    # the delta patched the arena in place: its older-epoch entry is gone
    hc = eng.arenas.hop_cache
    assert len(hc) == 1


def test_hop_cache_same_predicate_write_repairs(hop_engine):
    """A small delta to the entry's own predicate repairs it in place:
    the next read is a hit, launches nothing, and equals an engine built
    after the write."""
    eng, calls, q = hop_engine
    eng.run(q)
    seed = int(q.split("uid(")[1].split(",")[0], 16)
    eng.run("mutation { set { <0x%x> <e> <0x%x> . } }" % (seed, N_NODES + 5))
    out = eng.run(q)
    assert len(calls) == 1 and eng.stats["routes"] == {"cache": 1}
    assert len(eng.arenas.hop_cache) == 1
    fresh = QueryEngine(eng.store, device="cpu")
    assert json.dumps(out) == json.dumps(fresh.run(q))
    kids = {k.get("uid", k.get("_uid_")) for k in out["q"][0]["e"]}
    assert "0x%x" % (N_NODES + 5) in kids


def test_hop_cache_dropped_on_arena_eviction(hop_engine):
    eng, _calls, q = hop_engine
    eng.run(q)
    hc = eng.arenas.hop_cache
    assert len(hc) == 1
    eng.arenas.budget_bytes = 1  # every other cached arena must go
    eng.arenas.data("f")
    assert len(hc) == 0


def test_cache_gate_off_has_no_tiers(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_CACHE", "0")
    srv = DgraphServer(PostingStore(), device="cpu")
    assert srv.engine.arenas.hop_cache is None
    assert srv.scheduler.result_cache is None
    srv.scheduler.stop()


# ---------------------------------------------------------- result cache


def _post(addr, text):
    req = urllib.request.Request(addr + "/query", data=text.encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture()
def srv():
    server = DgraphServer(PostingStore(), device="cpu")
    server.start()
    code, _ = _post(server.addr, 'mutation { schema { name: string . } set { '
                    '<0x1> <name> "Ann" . <0x1> <friend> <0x2> . '
                    '<0x2> <name> "Ben" . } }')
    assert code == 200
    yield server
    server.stop()


def _hits():
    return QCACHE_RESULT_EVENTS.snapshot().get("hit", 0)


def test_result_cache_answers_repeats(srv, monkeypatch):
    runs = []
    orig = QueryEngine.run_parsed

    def counting(self, parsed):
        runs.append(1)
        return orig(self, parsed)

    monkeypatch.setattr(QueryEngine, "run_parsed", counting)
    q = "{ q(func: uid(0x1)) { name friend { name } } }"
    before = _hits()
    outs = [_post(srv.addr, q)[1] for _ in range(3)]
    assert len(runs) == 1 and _hits() == before + 2
    for o in outs:
        o.pop("server_latency")
    assert outs[0] == outs[1] == outs[2]
    assert outs[0]["q"][0]["friend"][0]["name"] == "Ben"


def test_result_cache_is_fresh_after_a_write_it_reads(srv):
    q = "{ q(func: uid(0x1)) { name friend { name } } }"
    _post(srv.addr, q)
    # a write to a predicate the query never reads keeps the entry a hit
    before = _hits()
    _post(srv.addr, 'mutation { set { <0x9> <other> "x" . } }')
    _post(srv.addr, q)
    assert _hits() == before + 1
    # a write to one it reads is seen by the next read
    code, _ = _post(srv.addr, 'mutation { set { <0x1> <friend> <0x3> . '
                              '<0x3> <name> "Cara" . } }')
    assert code == 200
    _code, out = _post(srv.addr, q)
    assert _hits() == before + 1
    assert sorted(f["name"] for f in out["q"][0]["friend"]) == ["Ben", "Cara"]
