"""The port's multi-tenant QoS (``dgraph_tpu_torch/sched/qos.py``) and
cooperative cancellation against the reference's: ``parse_timeout``,
``resolve_tenant``, the tenant table and the deficit-round-robin pick
equal to ``dgraph_tpu.sched.qos``'s on the same (seeded) inputs; the
cancel token's semantics; a tenant quota shed answering 429 with
``Retry-After``; and a cancelled token stopping ``@recurse``,
``shortest`` and a fused chain at their next checkpoint or segment seam,
and a mid-execution deadline answering 504.

Tolerance 0 throughout (equal values, equal orders)."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from dgraph_tpu.sched import qos as jqos
from dgraph_tpu_torch import ops as tops
from dgraph_tpu_torch.bench2hop import gen_edges
from dgraph_tpu_torch.models import PostingStore
from dgraph_tpu_torch.query import QueryEngine
from dgraph_tpu_torch.sched import qos
from dgraph_tpu_torch.serve.server import DgraphServer
from dgraph_tpu_torch.utils.failpoints import fail
from dgraph_tpu_torch.utils.metrics import QUERY_CANCELLED, SEGMENT_YIELDS

JOIN = 10.0
N_NODES, N_EDGES = 300, 1500

TIMEOUTS = [None, "", "abc", "nan", "inf", "-inf", "-1", "0", "0.5", "1e-3",
            " 2 ", "1ms"]


@pytest.mark.parametrize("raw", TIMEOUTS)
def test_parse_timeout_matches_reference(raw):
    assert qos.parse_timeout(raw) == jqos.parse_timeout(raw)


@pytest.mark.parametrize("raw", [None, "", "  ", " acme ", "x" * 100])
def test_resolve_tenant_matches_reference(raw):
    assert qos.resolve_tenant(raw) == jqos.resolve_tenant(raw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drr_order_matches_reference(seed):
    """A seeded arrival sequence of candidate sets and weights: the
    port's pick order equals the reference's, pick for pick."""
    rng = np.random.default_rng(seed)
    names = ["t%d" % i for i in range(6)]
    weights = {n: float(rng.choice([0.5, 1, 2, 4, 8])) for n in names}
    mine, ref = qos.DrrPicker(), jqos.DrrPicker()
    got, want = [], []
    for _ in range(300):
        cand = [n for n in names if rng.random() < 0.6] or [names[0]]
        w = {n: weights[n] for n in cand}
        got.append(mine.pick(w))
        want.append(ref.pick(dict(w)))
    assert got == want


def test_tenant_table_matches_reference(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_QOS_TENANTS", json.dumps({
        "gold": {"weight": 8, "priority": "high"},
        "scraper": {"weight": 1, "max_queued": 1, "max_inflight": 1},
    }))
    monkeypatch.setenv("DGRAPH_TPU_QOS_DEFAULT_QUEUED", "5")
    mine, ref = qos.QosConfig.from_env(), jqos.QosConfig.from_env()
    for t in ("gold", "scraper", "walk-in"):
        assert mine.tenant(t).to_dict() == ref.tenant(t).to_dict()
    assert mine.snapshot() == ref.snapshot()
    # a malformed table degrades to the defaults, as the reference's does
    monkeypatch.setenv("DGRAPH_TPU_QOS_TENANTS", "[1, 2]")
    mine, ref = qos.QosConfig.from_env(), jqos.QosConfig.from_env()
    assert mine.snapshot() == ref.snapshot() == {}
    assert mine.tenant("gold").to_dict() == ref.tenant("gold").to_dict()


def test_cancel_token_semantics():
    tok = qos.CancelToken(tenant="acme")
    tok.check()  # live: no raise
    assert tok.cancel("disconnect") and not tok.cancel("deadline")
    with pytest.raises(qos.QueryCancelledError) as ei:
        tok.check()
    assert ei.value.reason == "disconnect" and ei.value.tenant == "acme"
    lapsed = qos.CancelToken(timeout_s=0.0)
    with pytest.raises(qos.QueryCancelledError, match="deadline"):
        lapsed.check()
    gone = qos.CancelToken()
    gone.attach_probe(lambda: True, interval_s=0.0)
    with pytest.raises(qos.QueryCancelledError, match="disconnect"):
        gone.check()


# ------------------------------------------------------------ HTTP sheds


def _post(addr, text, headers=None):
    req = urllib.request.Request(
        addr + "/query", data=text.encode(), method="POST", headers=headers or {}
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _wait_for(cond, what):
    t_end = time.monotonic() + JOIN
    while not cond():
        assert time.monotonic() < t_end, what
        time.sleep(0.005)


SEED = ('mutation { schema { name: string . friend: uid . } set { '
        '<0x1> <name> "Ann" . <0x2> <name> "Ben" . <0x1> <friend> <0x2> . } }')


def test_tenant_quota_sheds_429_with_retry_after(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_QOS_TENANTS", json.dumps(
        {"scraper": {"max_queued": 1}}))
    srv = DgraphServer(PostingStore(), device="cpu")
    srv.start()
    try:
        assert _post(srv.addr, SEED)[0] == 200
        q = "{ q(func: uid(0x1)) { name friend { name } } }"
        hdr = {"X-Dgraph-Tenant": "scraper"}
        srv._engine_lock.acquire_write()  # wedge: the first stays queued
        res = {}
        try:
            t = threading.Thread(target=lambda: res.update(r=_post(srv.addr, q, hdr)))
            t.start()
            _wait_for(lambda: srv.scheduler._depth >= 1, "never admitted")
            code, raw, headers = _post(srv.addr, q + " ", hdr)
            # another tenant still admits during the scraper's backlog
            other = {}
            t2 = threading.Thread(target=lambda: other.update(r=_post(srv.addr, q)))
            t2.start()
            _wait_for(lambda: srv.scheduler._depth >= 2, "gold never admitted")
        finally:
            srv._engine_lock.release_write()
        t.join(timeout=JOIN)
        t2.join(timeout=JOIN)
        assert code == 429 and int(headers["Retry-After"]) >= 1
        body = json.loads(raw)
        assert body["tenant"] == "scraper"
        assert body["code"] == "ErrorServiceUnavailable"
        assert res["r"][0] == 200 and other["r"][0] == 200
    finally:
        srv.stop()


# ---------------------------------------------------- cooperative cancel


@pytest.fixture(scope="module")
def graph_store():
    src, dst = gen_edges(N_NODES, N_EDGES)
    st = PostingStore()
    st.apply_schema("e: uid @reverse .")
    st.bulk_set_uid_edges("e", src, dst)
    return st


def _seeds(k):
    src, _dst = gen_edges(N_NODES, N_EDGES)
    have = np.unique(src)
    return np.random.default_rng(3).choice(have, k, replace=False)


def _engine(store):
    eng = QueryEngine(store, device="cpu")
    eng.expand_device_min = 1
    eng.arenas.hop_cache = None
    return eng


def _cancel_after(eng, n, monkeypatch):
    """A token flipped right after the engine's ``n``-th expansion;
    returns the list the expansions are counted in."""
    tok = qos.CancelToken()
    eng.cancel = tok
    calls = []
    orig = eng.expander._expand_cached

    def counted(*a, **k):
        out = orig(*a, **k)
        calls.append(1)
        if len(calls) == n:
            tok.cancel("disconnect")
        return out

    monkeypatch.setattr(eng.expander, "_expand_cached", counted)
    return calls


def test_cancel_stops_recurse_at_next_checkpoint(graph_store, monkeypatch):
    eng = _engine(graph_store)
    calls = _cancel_after(eng, 1, monkeypatch)
    q = "{ q(func: uid(%s)) @recurse(depth: 4) { uid e } }" % ", ".join(
        "0x%x" % u for u in _seeds(8))
    with pytest.raises(qos.QueryCancelledError, match="disconnect"):
        eng.run(q)
    assert len(calls) == 1


def test_cancel_stops_shortest_at_next_checkpoint(graph_store, monkeypatch):
    eng = _engine(graph_store)
    calls = _cancel_after(eng, 2, monkeypatch)
    a, b = _seeds(2)
    with pytest.raises(qos.QueryCancelledError):
        eng.run("{ shortest(from: 0x%x, to: 0x%x, numpaths: 3) { e } }" % (a, b))
    assert len(calls) == 2


def test_cancel_stops_a_fused_chain_at_its_seam(graph_store, monkeypatch):
    """A var-block 4-hop chain fused at threshold 0, a seam every hop
    (DGRAPH_TPU_SEGMENT=force, k 1): a token flipped during the first
    hop's gather stops the chain at the next seam.  The tile join tier
    is pinned off: the gather chain's seams are the route under test."""
    monkeypatch.setenv("DGRAPH_TPU_MXU_JOIN", "0")
    monkeypatch.setenv("DGRAPH_TPU_SEGMENT", "force")
    monkeypatch.setenv("DGRAPH_TPU_SEGMENT_K", "1")
    monkeypatch.setenv("DGRAPH_TPU_RESIDENT", "force")
    eng = _engine(graph_store)
    eng.chain_threshold = 0
    tok = qos.CancelToken()
    eng.cancel = tok
    calls = []
    gather = tops.gather_packed

    def gather_then_cancel(*a, **k):
        calls.append(1)
        tok.cancel("disconnect")
        return gather(*a, **k)

    monkeypatch.setattr(tops, "gather_packed", gather_then_cancel)
    seeds = ", ".join("0x%x" % u for u in _seeds(16))
    before = SEGMENT_YIELDS.snapshot().get("cancel", 0)
    with pytest.raises(qos.QueryCancelledError):
        eng.run("{ var(func: uid(%s)) { e { e { e { f as e } } } } "
                "q(func: uid(f)) { count(uid) } }" % seeds)
    assert len(calls) == 1
    assert SEGMENT_YIELDS.snapshot().get("cancel", 0) == before + 1


def test_deadline_mid_execution_is_504(graph_store, monkeypatch):
    """Each hop stretched by 100 ms (the ``engine.hop`` failpoint): a
    250 ms budget lapses between the walk's four hops, and the request
    answers 504 with a ``deadline`` cancellation counted."""
    srv = DgraphServer(graph_store, device="cpu")
    srv.start()
    fail.arm("engine.hop", "delay(ms=100)")
    try:
        before = QUERY_CANCELLED.total(reason="deadline")
        q = "{ q(func: uid(%s)) @recurse(depth: 4) { uid e } }" % ", ".join(
            "0x%x" % u for u in _seeds(4))
        code, raw, _hdr = _post(srv.addr, q, {"X-Dgraph-Timeout": "0.25"})
        assert code == 504
        assert json.loads(raw)["code"] == "ErrorDeadlineExceeded"
        assert QUERY_CANCELLED.total(reason="deadline") == before + 1
        assert fail.hits("engine.hop") >= 2
    finally:
        fail.reset()
        srv.stop()
