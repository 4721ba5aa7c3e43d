"""The port's cohort scheduler (``dgraph_tpu_torch/sched/``) against the
reference's: the hop merger's union dealing and the admission signature
equal to ``dgraph_tpu.sched``'s on the same inputs, the merger's leave
and error paths, the three flush triggers, admission control (overload
429 with ``Retry-After``, deadline 504, a zero budget), singleflight,
``stop()``, thread-safe launch counting, and end to end: concurrent
clients through the port's scheduled server get bodies byte-identical to
the reference's serial server (``DGRAPH_TPU_SCHED=0``), as does the port
with its scheduler off.

Inputs are seeded (numpy); tolerance 0 throughout (equal arrays, equal
tuples, equal bytes).  Every thread join, socket read and event wait
carries its own timeout; merges fire by quorum, never by sleeping."""

import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from dgraph_tpu import gql as jgql
from dgraph_tpu.models import PostingStore as JaxStore
from dgraph_tpu.sched.cohort import _deal_union as jax_deal_union
from dgraph_tpu.sched.cohort import hop_signature as jax_hop_signature
from dgraph_tpu.serve.server import DgraphServer as JaxServer
from dgraph_tpu_torch import gql
from dgraph_tpu_torch import ops as tops
from dgraph_tpu_torch.bench2hop import gen_edges
from dgraph_tpu_torch.models import PostingStore
from dgraph_tpu_torch.models.store import Edge
from dgraph_tpu_torch.ops._build import CudaKernel
from dgraph_tpu_torch.query import QueryEngine
from dgraph_tpu_torch.sched import (
    Cohort,
    CohortScheduler,
    HopMerger,
    SchedDeadlineError,
    SchedOverloadError,
    SchedRequest,
    hop_signature,
)
from dgraph_tpu_torch.sched.cohort import _deal_union
from dgraph_tpu_torch.serve.server import DgraphServer
from dgraph_tpu_torch.utils.metrics import (
    SCHED_COALESCED,
    SCHED_FLUSHES,
    SCHED_MERGED_HOPS,
)

from tests.torch_parity import REFERENCE_ENV
from torch_pins import pinned_planner  # noqa: F401

# every route decision of both planners is pinned (tests/torch_pins.py)
pytestmark = pytest.mark.usefixtures("pinned_planner")

N_NODES, N_EDGES = 300, 1500
JOIN = 10.0  # seconds any thread join / request may take


def _post(addr, text, headers=None):
    req = urllib.request.Request(
        addr + "/query", data=text.encode(), method="POST", headers=headers or {}
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _strip(raw: bytes) -> str:
    d = json.loads(raw)
    d.pop("server_latency", None)
    return json.dumps(d)


# ---------------------------------------------------------------- dealing


def _toy_expand(adj):
    """expand_fn over a dict adjacency: deterministic per row, like the
    engine's CSR expansion."""

    def expand(src):
        outs = [np.asarray(adj.get(int(u), []), dtype=np.int64) for u in src]
        seg = np.zeros(len(src) + 1, dtype=np.int64)
        np.cumsum([len(o) for o in outs], out=seg[1:])
        flat = np.concatenate(outs) if outs else np.empty(0, dtype=np.int64)
        return flat, seg

    return expand


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_deal_union_matches_reference_and_solo(seed):
    """Seeded frontiers (sorted, distinct, overlapping, one empty): the
    port's dealt segments equal the reference's and each member's solo
    expansion."""
    rng = np.random.default_rng(seed)
    adj = {u: sorted(set(rng.integers(0, 500, rng.integers(0, 9)).tolist()))
           for u in range(200)}
    expand = _toy_expand(adj)
    entries = [np.unique(rng.integers(0, 220, rng.integers(0, 60)))
               for _ in range(int(rng.integers(2, 6)))]
    entries.append(np.empty(0, dtype=np.int64))
    got = _deal_union(entries, expand)
    want = jax_deal_union(entries, expand)
    for src, (go, gs), (wo, ws) in zip(entries, got, want):
        so, ss = expand(src)
        assert np.array_equal(go, wo) and np.array_equal(gs, ws)
        assert np.array_equal(go, so) and np.array_equal(gs, ss)


@pytest.fixture(scope="module")
def graph_store():
    src, dst = gen_edges(N_NODES, N_EDGES)
    st = PostingStore()
    st.bulk_set_uid_edges("e", src, dst)
    return st


def test_deal_union_over_the_gather(graph_store, monkeypatch):
    """Union frontiers expanded by the port's resident route (the
    gather's plain version on the CPU): every member's slice equals its
    solo expansion, and the union is one gather call."""
    monkeypatch.setenv("DGRAPH_TPU_RESIDENT", "force")
    eng = QueryEngine(graph_store, device="cpu")
    eng.expand_device_min = 1
    arena = eng.arenas.data("e")
    rng = np.random.default_rng(11)
    entries = [np.unique(rng.integers(1, N_NODES + 1, 40)) for _ in range(5)]
    calls = []
    gather = tops.gather_packed

    def counting(*a, **k):
        calls.append(1)
        return gather(*a, **k)

    monkeypatch.setattr(tops, "gather_packed", counting)
    dealt = _deal_union(entries, lambda u: eng.expander._expand_one(arena, u))
    assert len(calls) == 1
    for src, (out, seg) in zip(entries, dealt):
        so, ss = eng.expander._expand_one(arena, src)
        assert np.array_equal(out, so) and np.array_equal(seg, ss)


# -------------------------------------------------------------- signature

SIG_QUERIES = [
    "{ q(func: uid(0x1, 0x2)) { uid e { uid } } }",
    "{ q(func: uid(0x1)) @recurse(depth: 2) { uid e } }",
    '{ q(func: eq(name, "a")) { name e { rank } } }',
    "{ var(func: uid(0x3)) { e { f as e } } q(func: uid(f)) { count(uid) } }",
    "{ q(func: has(rank), orderasc: rank, first: 3) { uid } }",
    "schema(pred: [name]) { type }",
]


def _mutate(st, edge_cls):
    """The same seeded mutations through the store API of either package:
    point edges, a bulk batch under and one over the journal cap, a
    value, a delete and a schema change."""
    rng = np.random.default_rng(7)
    st.apply_schema("name: string @index(exact) .\nrank: int .")
    for s, d in rng.integers(1, 50, (6, 2)).tolist():
        st.apply(edge_cls(pred="e", src=s, dst=d))
    st.bulk_set_uid_edges("e", rng.integers(1, 50, 40), rng.integers(1, 50, 40))
    st.bulk_set_uid_edges("f", rng.integers(1, 50, 400), rng.integers(1, 50, 400))
    st.apply(edge_cls(pred="e", src=3, dst=4, op="del"))
    return st


def _jax_edge(**kw):
    from dgraph_tpu.models.store import Edge as JEdge

    return JEdge(**kw)


@pytest.mark.parametrize("i", range(len(SIG_QUERIES)))
def test_hop_signature_matches_reference(i):
    jst = _mutate(JaxStore(), _jax_edge)
    tst = _mutate(PostingStore(), Edge)
    assert tst.version == jst.version
    text = SIG_QUERIES[i]
    got = hop_signature(gql.parse(text), tst.version)
    want = jax_hop_signature(jgql.parse(text), jst.version)
    assert got == want


# ------------------------------------------------------------ hop merger


def test_hop_merger_one_union_for_every_member():
    adj = {1: [10, 11], 2: [], 3: [12], 5: [10, 13, 14]}
    expand = _toy_expand(adj)
    calls = []

    def counted(src):
        calls.append(np.asarray(src))
        return expand(src)

    merger = HopMerger(expected=3, window_s=JOIN)  # fires by quorum
    srcs = [np.array([1, 2]), np.array([3, 5]), np.array([1, 5])]
    results = [None] * 3
    before = SCHED_MERGED_HOPS.value()

    def run(i):
        results[i] = merger.submit(("p", False, 0), srcs[i], counted)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=JOIN)
    assert len(calls) == 1 and list(calls[0]) == [1, 2, 3, 5]
    assert merger.merged_dispatches == 2
    assert SCHED_MERGED_HOPS.value() == before + 2
    for src, (flat, seg) in zip(srcs, results):
        wf, ws = expand(src)
        assert np.array_equal(flat, wf) and np.array_equal(seg, ws)


def test_hop_merger_leave_unblocks_stragglers():
    merger = HopMerger(expected=2, window_s=60.0)  # too long to wait out
    merger.leave()  # the peer finished before submitting anything
    t0 = time.monotonic()
    flat, seg = merger.submit(("p", False, 0), np.array([1]), _toy_expand({1: [2]}))
    assert time.monotonic() - t0 < JOIN  # quorum of 1: no window wait
    assert list(flat) == [2] and list(seg) == [0, 1]


def test_hop_merger_error_reaches_every_member():
    merger = HopMerger(expected=3, window_s=JOIN)
    errs = []

    def boom(src):
        raise ValueError("nope")

    def run(i):
        try:
            merger.submit(("p", False, 0), np.array([i]), boom)
        except ValueError as e:
            errs.append(str(e))

    ts = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=JOIN)
    assert errs == ["nope"] * 3


def test_merged_engine_hops_one_gather(graph_store, monkeypatch):
    """Four engine shells over one ArenaManager submit the same
    predicate's hop through one HopMerger: ONE gather call expands the
    union, and each member's (out, seg_ptr) equals its solo expansion."""
    monkeypatch.setenv("DGRAPH_TPU_RESIDENT", "force")
    monkeypatch.setenv("DGRAPH_TPU_CACHE", "0")
    base = QueryEngine(graph_store, device="cpu")
    base.expand_device_min = 1
    arena = base.arenas.data("e")
    rng = np.random.default_rng(13)
    srcs = [np.unique(rng.integers(1, N_NODES + 1, 30)) for _ in range(4)]
    solo = [base.expander._expand_one(arena, s) for s in srcs]
    merger = HopMerger(expected=4, window_s=JOIN)
    shells = []
    for _ in srcs:
        sh = QueryEngine(graph_store, arenas=base.arenas)
        sh.expander.hop_merger = merger
        shells.append(sh)
    calls = []
    gather = tops.gather_packed

    def counting(*a, **k):
        calls.append(1)
        return gather(*a, **k)

    monkeypatch.setattr(tops, "gather_packed", counting)
    got = [None] * 4

    def run(i):
        got[i] = shells[i].expander.expand(arena, srcs[i], attr="e")

    ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=JOIN)
    assert len(calls) == 1
    for (go, gs), (so, ss) in zip(got, solo):
        assert np.array_equal(go, so) and np.array_equal(gs, ss)
    assert sum(sh.stats["routes"].get("merged", 0) for sh in shells) == 3


# ---------------------------------------------------------- served store

SEED = """
mutation { schema {
  name: string @index(exact) .
  age: int @index(int) .
  friend: uid @reverse @count .
} set {
  <0x1> <name> "Ann" .   <0x1> <age> "31" .
  <0x2> <name> "Ben" .   <0x2> <age> "29" .
  <0x3> <name> "Cara" .  <0x3> <age> "40" .
  <0x1> <friend> <0x2> . <0x1> <friend> <0x3> .
  <0x2> <friend> <0x3> . <0x3> <friend> <0x1> .
} }
"""

WORKLOAD = [
    '{ q(func: uid(0x1)) { name friend { name age } } }',
    '{ q(func: uid(0x2)) { name friend { name age } } }',
    '{ q(func: eq(name, "Ann")) { name friend { name } } }',
    '{ q(func: uid(0x3)) { c: count(friend) } }',
    '{ q(func: ge(age, 30), orderasc: age) { name age } }',
    '{ q(func: uid(0x1)) { friend @filter(ge(age, 30)) { name } } }',
]


@pytest.fixture()
def srv():
    server = DgraphServer(PostingStore(), device="cpu")
    server.start()
    assert _post(server.addr, SEED)[0] == 200
    yield server
    server.stop()


def _parse(text):
    return gql.parse(text)


def _flushes(reason):
    return SCHED_FLUSHES.snapshot().get(reason, 0)


def test_flush_trigger_full(srv):
    sched = CohortScheduler(srv, max_batch=3, flush_ms=60_000, queue_cap=64)
    sched.idle_beat_s = 60.0  # only a FULL cohort can flush
    try:
        before = _flushes("full")
        outs = [None] * 3

        def go(i):
            outs[i], _ = sched.run(_parse(WORKLOAD[0]))

        ts = [threading.Thread(target=go, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=JOIN)
        assert all(o is not None and o["q"][0]["name"] == "Ann" for o in outs)
        assert _flushes("full") == before + 1
    finally:
        sched.stop()


def test_flush_trigger_deadline(srv):
    sched = CohortScheduler(srv, max_batch=64, flush_ms=30.0, queue_cap=64)
    sched.idle_beat_s = 60.0  # only the 30 ms deadline can fire
    try:
        before = _flushes("deadline")
        t0 = time.monotonic()
        out, _ = sched.run(_parse(WORKLOAD[0]))
        assert out["q"][0]["name"] == "Ann"
        assert time.monotonic() - t0 >= 0.02  # sat out the flush deadline
        assert _flushes("deadline") == before + 1
    finally:
        sched.stop()


def test_flush_trigger_idle(srv):
    sched = CohortScheduler(srv, max_batch=64, flush_ms=60_000, queue_cap=64)
    sched.idle_beat_s = 0.005  # the flush deadline / 8 would be 7.5 s
    try:
        before = _flushes("idle")
        t0 = time.monotonic()
        out, _ = sched.run(_parse(WORKLOAD[0]))
        assert out["q"][0]["name"] == "Ann"
        # the deadline is a minute out: only the idle beat explains this
        assert time.monotonic() - t0 < JOIN
        assert _flushes("idle") == before + 1
    finally:
        sched.stop()


def _wait_for(cond, what):
    t_end = time.monotonic() + JOIN
    while not cond():
        assert time.monotonic() < t_end, what
        time.sleep(0.005)


def test_overload_sheds_429_with_retry_after(srv):
    """With the engine wedged by a writer, the one admission slot fills
    and the next request sheds 429 with Retry-After; the queued one
    drains once the writer leaves."""
    old = srv.scheduler
    srv.scheduler = CohortScheduler(srv, queue_cap=1)
    try:
        srv._engine_lock.acquire_write()
        res = {}
        try:
            t = threading.Thread(
                target=lambda: res.update(first=_post(srv.addr, WORKLOAD[0]))
            )
            t.start()
            _wait_for(lambda: srv.scheduler._depth >= 1, "first never admitted")
            code, raw, hdr = _post(srv.addr, WORKLOAD[1])
        finally:
            srv._engine_lock.release_write()
        t.join(timeout=JOIN)
        assert code == 429 and int(hdr["Retry-After"]) >= 1
        assert json.loads(raw)["code"] == "ErrorServiceUnavailable"
        assert res["first"][0] == 200
    finally:
        srv.scheduler.stop()
        srv.scheduler = old


def test_deadline_while_queued_is_504(srv):
    """A budget that lapses behind a long write answers 504 instead of
    executing late."""
    srv._engine_lock.acquire_write()
    res = {}
    try:
        t = threading.Thread(target=lambda: res.update(r=_post(
            srv.addr, WORKLOAD[0], {"X-Dgraph-Timeout": "0.05"})))
        t.start()
        _wait_for(lambda: srv.scheduler._depth >= 1, "never admitted")
        time.sleep(0.1)  # past the 50 ms budget while the writer holds
    finally:
        srv._engine_lock.release_write()
    t.join(timeout=JOIN)
    code, raw, _hdr = res["r"]
    assert code == 504
    assert json.loads(raw)["code"] == "ErrorDeadlineExceeded"


def test_zero_budget_sheds_immediately(srv):
    with pytest.raises(SchedDeadlineError):
        srv.scheduler.run(_parse(WORKLOAD[0]), timeout_s=0.0)
    code, _raw, _hdr = _post(srv.addr, WORKLOAD[0], {"X-Dgraph-Timeout": "0"})
    assert code == 504


def test_singleflight_runs_identical_requests_once(srv, monkeypatch):
    runs = []
    orig = QueryEngine.run_parsed

    def counting(self, parsed):
        runs.append(1)
        return orig(self, parsed)

    monkeypatch.setattr(QueryEngine, "run_parsed", counting)
    text = WORKLOAD[0]
    reqs = [SchedRequest(_parse(text), key=(text, "", False)) for _ in range(4)]
    c = Cohort(("sf",))
    c.reqs = reqs
    before = SCHED_COALESCED.value()
    srv.scheduler._flush(c, "full")
    outs = [r.wait()[0] for r in reqs]
    assert len(runs) == 1
    assert SCHED_COALESCED.value() == before + 3
    assert all(o is outs[0] for o in outs)


def test_stop_fails_queued_requests(srv):
    sched = CohortScheduler(srv, max_batch=64, flush_ms=60_000, queue_cap=64)
    sched.idle_beat_s = 60.0  # nothing flushes on its own
    errs = []

    def go():
        try:
            sched.run(_parse(WORKLOAD[0]))
        except SchedOverloadError as e:
            errs.append(e)

    t = threading.Thread(target=go)
    t.start()
    _wait_for(lambda: sched._depth >= 1, "never admitted")
    sched.stop()
    t.join(timeout=JOIN)
    assert len(errs) == 1 and "shutting down" in str(errs[0])


def test_metrics_endpoint_exposes_the_scheduler(srv):
    for q in WORKLOAD[:3]:
        assert _post(srv.addr, q)[0] == 200
    with urllib.request.urlopen(srv.addr + "/metrics", timeout=JOIN) as r:
        text = r.read().decode()
    for series in ("dgraph_sched_cohort_occupancy_bucket",
                   "dgraph_sched_flushes_total{reason=",
                   "dgraph_sched_queue_wait_seconds_bucket",
                   "dgraph_num_queries_total"):
        assert series in text, series


# -------------------------------------------------------- launch counting


def test_launch_count_is_exact_under_threads():
    """8 threads of launches through one kernel binding (its entry point
    replaced by a stub that reports success): the count is exact."""
    k = CudaKernel("stub", "stub", [])
    k._fn = lambda *a: 0
    per = 2000

    def run():
        for _ in range(per):
            k.launch()

    ts = [threading.Thread(target=run) for _ in range(8)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as it can
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=JOIN)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in ts)
    assert k.launches == 8 * per


# -------------------------------------------------------------- end to end


def _graph_rdf():
    src, dst = gen_edges(N_NODES, N_EDGES)
    rng = np.random.default_rng(17)
    lines = ["<0x%x> <e> <0x%x> ." % (s, d) for s, d in zip(src, dst)]
    lines += ['<0x%x> <rank> "%d" .' % (u, rng.integers(0, 40))
              for u in range(1, N_NODES + 1)]
    return ("mutation { schema { e: uid @reverse . rank: int @index(int) . } "
            "set { %s } }" % "\n".join(lines))


def _e2e_queries():
    src, _dst = gen_edges(N_NODES, N_EDGES)
    have = np.unique(src)
    rng = np.random.default_rng(19)

    def seeds(k):
        return ", ".join("0x%x" % u for u in rng.choice(have, k, replace=False))

    qs = []
    for _ in range(3):
        qs += [
            "{ q(func: uid(%s)) { uid e { uid e { uid } } } }" % seeds(12),
            "{ q(func: uid(%s)) @recurse(depth: 2) { uid e } }" % seeds(8),
            "{ var(func: uid(%s)) { e { f as e } } q(func: uid(f)) { count(uid) } }"
            % seeds(20),
            "{ shortest(from: %s, to: %s) { e } }" % (seeds(1), seeds(1)),
            "{ q(func: uid(%s)) @filter(has(e) AND ge(rank, 10)) { uid rank } }"
            % seeds(30),
            "{ q(func: uid(%s)) { e (orderdesc: rank, first: 2) { uid rank } } }"
            % seeds(10),
        ]
    return qs


def _client_texts(qs, n_clients, per_client):
    """Per client: fresh texts, then repeats of its own earlier ones."""
    out = []
    for c in range(n_clients):
        mine = [qs[(c * 3 + j) % len(qs)] for j in range(per_client - 2)]
        out.append(mine + mine[:2])
    return out


@pytest.mark.compile_budget(400)
def test_concurrent_scheduled_bodies_match_reference_serial(monkeypatch):
    qs = _e2e_queries()
    seed = _graph_rdf()
    for k, v in REFERENCE_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("DGRAPH_TPU_RESIDENT")
    ref = JaxServer(JaxStore())
    assert ref.scheduler is None
    ref.start()
    try:
        assert _post(ref.addr, seed)[0] == 200
        want = {q: _strip(_post(ref.addr, q)[1]) for q in qs}
    finally:
        ref.stop()
    for k in REFERENCE_ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("DGRAPH_TPU_RESIDENT", "force")

    port = DgraphServer(PostingStore(), device="cpu")
    assert port.scheduler is not None and port.scheduler.result_cache is not None
    port.engine.expand_device_min = 1  # every hop may merge and gathers
    port.start()
    results, errs = [], []
    try:
        assert _post(port.addr, seed)[0] == 200

        def client(texts):
            for q in texts:
                code, raw, _hdr = _post(port.addr, q)
                if code != 200:
                    errs.append((code, raw))
                    return
                results.append((q, _strip(raw)))

        ts = [threading.Thread(target=client, args=(t,))
              for t in _client_texts(qs, 8, 8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        port.stop()
    assert not errs, errs[:2]
    assert len(results) == 64
    for q, got in results:
        assert got == want[q], q

    # the port with its scheduler off: the serial path, the same bytes
    monkeypatch.setenv("DGRAPH_TPU_SCHED", "0")
    serial = DgraphServer(PostingStore(), device="cpu")
    assert serial.scheduler is None
    serial.engine.expand_device_min = 1
    serial.start()
    try:
        assert _post(serial.addr, seed)[0] == 200
        for q in qs:
            code, raw, _hdr = _post(serial.addr, q)
            assert code == 200 and _strip(raw) == want[q], q
    finally:
        serial.stop()
