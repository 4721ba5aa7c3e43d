"""The port's multi-tenant QoS (``dgraph_tpu_torch/sched/qos.py``) and
cooperative cancellation against the reference's: ``parse_timeout``,
``resolve_tenant``, the tenant table and the deficit-round-robin pick
equal to ``dgraph_tpu.sched.qos``'s on the same (seeded) inputs; the
cancel token's semantics; a tenant quota shed answering 429 with
``Retry-After``; and a cancelled token stopping ``@recurse``,
``shortest`` and a fused chain at their next checkpoint or segment seam,
and a mid-execution deadline answering 504; the ``CancelRegistry`` cases
of tests/test_qos.py and ``/admin/cancel`` on a port server (a sampled,
scheduled read held at a hop by a failpoint delay answers 499).

Tolerance 0 throughout (equal values, equal orders).  The autouse
fixture restores the flight recorder and gives every test a fresh
``qos.REGISTRY``."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from dgraph_tpu.sched import qos as jqos
from dgraph_tpu_torch import obs
from dgraph_tpu_torch import ops as tops
from dgraph_tpu_torch.bench2hop import gen_edges
from dgraph_tpu_torch.models import PostingStore
from dgraph_tpu_torch.query import QueryEngine
from dgraph_tpu_torch.sched import qos
from dgraph_tpu_torch.serve.server import DgraphServer
from dgraph_tpu_torch.utils.failpoints import fail
from dgraph_tpu_torch.utils.metrics import QUERY_CANCELLED, SEGMENT_YIELDS
from torch_pins import pinned_planner  # noqa: F401

# every route decision of both planners is pinned (tests/torch_pins.py)
pytestmark = pytest.mark.usefixtures("pinned_planner")

JOIN = 10.0
N_NODES, N_EDGES = 300, 1500



@pytest.fixture(autouse=True)
def _recorder_and_registry_reset(monkeypatch):
    monkeypatch.setattr(qos, "REGISTRY", qos.CancelRegistry())
    yield
    obs.configure()


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


# ------------------------------------- checkpoints placed as the reference's

# several value children under one block, and a term index probed per
# token: the engine checkpoints before each child, the resolver before
# each token's expansion (the reference's QueryEngine._exec_children and
# FuncResolver.checkpoint)
CHECK_SCHEMA = ("name: string @index(term) . age: int . city: string . "
                "nick: string . bio: string .")
CHECK_WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta"]
CHECK_QUERIES = {
    "value_children": "{ q(func: uid(0x1, 0x2, 0x3)) { name age city nick bio } }",
    "allofterms": '{ q(func: allofterms(name, "%s")) { uid } }' % " ".join(CHECK_WORDS),
}


def _check_rdf():
    lines = []
    for u in range(1, 6):
        words = " ".join(CHECK_WORDS[: 3 + u])
        lines += [f'<0x{u:x}> <name> "{words}" .', f'<0x{u:x}> <age> "{20 + u}" .',
                  f'<0x{u:x}> <city> "c{u}" .', f'<0x{u:x}> <nick> "n{u}" .',
                  f'<0x{u:x}> <bio> "b{u}" .']
    return "\n".join(lines)


@pytest.fixture(scope="module")
def check_engines():
    """(reference engine, port engine) over one store."""
    from dgraph_tpu.models import PostingStore as JStore
    from dgraph_tpu.query import QueryEngine as JEngine
    from torch_parity import port_store_of

    jeng = JEngine(JStore())
    jeng.run("mutation { schema { %s } set { %s } }" % (CHECK_SCHEMA, _check_rdf()))
    return jeng, QueryEngine(port_store_of(jeng.store), device="cpu")


def _lapsing(mod, at):
    """A CancelToken of ``mod`` (either package's sched.qos) whose
    deadline lapses at its ``at``-th probe; it counts its probes."""
    class Lapsing(mod.CancelToken):
        __slots__ = ("probes", "at")

        def check(self):
            self.probes += 1
            if self.probes >= self.at:
                self.cancel("deadline")
            return super().check()

    tok = Lapsing()
    tok.probes, tok.at = 0, at
    return tok


def _run_counted(eng, mod, resolver_cls, q, at, monkeypatch):
    """Run ``q`` with a token lapsing at probe ``at``: (raised reason or
    None, probes made, children executed, token expansions made)."""
    tok = _lapsing(mod, at)
    eng.cancel = tok
    seen = {"child": 0, "rows": 0}
    child, rows = eng._exec_child, resolver_cls._expand_rows

    def counted_child(*a, **k):
        seen["child"] += 1
        return child(*a, **k)

    def counted_rows(self, *a, **k):
        seen["rows"] += 1
        return rows(self, *a, **k)

    with monkeypatch.context() as mp:
        mp.setattr(eng, "_exec_child", counted_child)
        mp.setattr(resolver_cls, "_expand_rows", counted_rows)
        try:
            eng.run(q)
            reason = None
        except mod.QueryCancelledError as e:
            reason = e.reason
        finally:
            eng.cancel = None
    return reason, tok.probes, seen["child"], seen["rows"]


def _both(check_engines, q, at, monkeypatch):
    from dgraph_tpu.query.functions import FuncResolver as JResolver
    from dgraph_tpu_torch.query.functions import FuncResolver

    jeng, teng = check_engines
    return (_run_counted(jeng, jqos, JResolver, q, at, monkeypatch),
            _run_counted(teng, qos, FuncResolver, q, at, monkeypatch))


@pytest.mark.parametrize("name", sorted(CHECK_QUERIES))
def test_checkpoints_probe_as_the_reference(check_engines, name, monkeypatch):
    """With no lapse, the port probes its token as often as the
    reference, and at least once per child or token."""
    want, got = _both(check_engines, CHECK_QUERIES[name], 10 ** 9, monkeypatch)
    assert got == want and got[0] is None
    per = 5 if name == "value_children" else len(CHECK_WORDS)
    assert got[1] >= per


@pytest.mark.parametrize("at", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("name", sorted(CHECK_QUERIES))
def test_deadline_lapse_stops_where_the_reference_stops(check_engines, name, at,
                                                          monkeypatch):
    """A deadline lapsing at the ``at``-th probe stops both packages at the
    same checkpoint: the same children ran and the same tokens expanded."""
    want, got = _both(check_engines, CHECK_QUERIES[name], at, monkeypatch)
    assert got == want
    assert got[0] == "deadline" and got[1] == at


# ------------------------------------------------------- cancel registry


def test_cancel_registry_reregistered_trace_id_survives_eviction():
    """A client retrying with the SAME trace id re-registers it; stale
    eviction-queue entries must not evict the live token, even at the
    capacity bound."""
    assert qos.CancelRegistry._MAX == jqos.CancelRegistry._MAX
    reg = qos.CancelRegistry()
    stale, live = qos.CancelToken(), qos.CancelToken()
    reg.register("tid", stale)
    reg.unregister("tid")
    reg.register("tid", live)
    for i in range(qos.CancelRegistry._MAX - 1):
        reg.register(f"other-{i}", qos.CancelToken())
    assert reg.cancel("tid")
    assert live.cancelled and not stale.cancelled


def test_cancel_registry_unregister_is_identity_checked():
    """Two sampled queries may share one trace id — the first to finish
    must not unregister the other's live token."""
    reg = qos.CancelRegistry()
    a, b = qos.CancelToken(), qos.CancelToken()
    reg.register("shared", a)
    reg.register("shared", b)   # b overwrites: latest registration wins
    reg.unregister("shared", a)  # a finishes: must NOT evict b
    assert reg.cancel("shared")
    assert b.cancelled and not a.cancelled
    reg.unregister("shared", b)
    assert not reg.cancel("shared")


@pytest.mark.parametrize("seed", [3, 4])
def test_cancel_registry_matches_reference(seed):
    """A seeded sequence of register / unregister / cancel on both
    packages' registries (a small bound, so eviction runs): the same
    cancel verdicts and the same tokens flipped."""
    rng = np.random.default_rng(seed)
    mine, ref = qos.CancelRegistry(), jqos.CancelRegistry()
    mine._MAX = ref._MAX = 8
    toks_m, toks_r = [], []
    got, want = [], []
    for _ in range(400):
        op, tid = int(rng.integers(0, 3)), f"t{int(rng.integers(0, 12))}"
        if op == 0:
            toks_m.append((tid, qos.CancelToken()))
            toks_r.append((tid, jqos.CancelToken()))
            mine.register(tid, toks_m[-1][1])
            ref.register(tid, toks_r[-1][1])
        elif op == 1 and toks_m:
            i = int(rng.integers(0, len(toks_m)))
            mine.unregister(toks_m[i][0], toks_m[i][1])
            ref.unregister(toks_r[i][0], toks_r[i][1])
        else:
            got.append(mine.cancel(tid))
            want.append(ref.cancel(tid))
    assert got == want
    assert [t.cancelled for _, t in toks_m] == [t.cancelled for _, t in toks_r]


def _get_status(addr, path, method="GET"):
    req = urllib.request.Request(addr + path, method=method,
                                 data=b"" if method == "POST" else None)
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture()
def served():
    srv = DgraphServer(PostingStore(), device="cpu")
    srv.start()
    _post(srv.addr, SEED)
    yield srv
    srv.stop()


def test_admin_cancel_needs_a_trace_id(served):
    assert _get_status(served.addr, "/admin/cancel")[0] == 400
    assert _get_status(served.addr, "/admin/cancel", "POST")[0] == 400


def test_admin_cancel_404s_for_inline_mutation_path(served):
    """The inline (mutation) path has no cancellation checkpoints, so its
    trace id is never registered: /admin/cancel answers 404."""
    obs.configure(ratio=1e-9)
    tp = "00-%032x-%016x-01" % (0x71, 0x71)
    code, _raw, _h = _post(served.addr, 'mutation { set { <0x9> <name> "Zed" . } }',
                           {"Traceparent": tp})
    assert code == 200
    assert _get_status(served.addr, "/admin/cancel?trace_id=%032x" % 0x71)[0] == 404


def test_cancel_after_final_hop_is_a_noop(served):
    obs.configure(ratio=1e-9)
    tp = "00-%032x-%016x-01" % (0x51, 0x51)
    code, raw, _h = _post(served.addr, "{ q(func: uid(0x1)) { name friend { name } } }",
                          {"Traceparent": tp})
    assert code == 200 and json.loads(raw)["q"][0]["name"] == "Ann"
    assert _get_status(served.addr, "/admin/cancel?trace_id=%032x" % 0x51)[0] == 404


CHAIN_SEED = """
mutation { schema { friend: uid . name: string . } set {
  <0x1> <friend> <0x2> . <0x2> <friend> <0x3> .
  <0x3> <friend> <0x4> . <0x4> <friend> <0x5> .
  <0x5> <name> "end" .
} }
"""
CHAIN_Q = "{ q(func: uid(0x1)) { friend { friend { friend { friend { name } } } } } }"


@pytest.mark.parametrize("method", ["GET", "POST"])
def test_admin_cancel_mid_flight_stops_hop_dispatch(method):
    """A sampled, scheduled read held at each hop by a 300 ms failpoint
    delay, carrying its own Traceparent: /admin/cancel answers 200, the
    read answers 499 before its fourth hop, the admin cancellation is
    counted for its tenant, its trace closes with outcome=cancelled, and
    a second cancel answers 404."""
    obs.configure(ratio=1e-9)
    server = DgraphServer(PostingStore(), device="cpu")
    server.start()
    try:
        _post(server.addr, CHAIN_SEED)
        before = QUERY_CANCELLED.total(reason="admin", tenant="batcher")
        h0 = fail.hits("engine.hop")
        n = 0x61 if method == "GET" else 0x62
        tid = "%032x" % n
        res = {}

        def run():
            res["got"] = _post(server.addr, CHAIN_Q, {
                "Traceparent": "00-%s-%016x-01" % (tid, n),
                "X-Dgraph-Tenant": "batcher",
            })

        fail.arm("engine.hop", "delay(ms=300)")
        try:
            t = threading.Thread(target=run)
            t.start()
            t_end = time.monotonic() + JOIN
            code = 404
            while code == 404 and time.monotonic() < t_end:
                code = _get_status(server.addr, "/admin/cancel?trace_id=" + tid,
                                   method)[0]
                time.sleep(0.02)
            assert code == 200
            t.join(timeout=60)
        finally:
            fail.disarm("engine.hop")
        code, raw, _h = res["got"]
        assert code == 499, raw
        assert json.loads(raw)["code"] == "ErrorQueryCancelled"
        assert fail.hits("engine.hop") - h0 < 4
        assert QUERY_CANCELLED.total(reason="admin", tenant="batcher") == before + 1
        assert _get_status(server.addr, "/admin/cancel?trace_id=" + tid,
                           method)[0] == 404
        trace = obs.get_recorder().trace(tid)
        roots = [s for s in trace["spans"] if s["name"] == "query"]
        assert roots[0]["attrs"]["outcome"] == "cancelled"
        assert roots[0]["attrs"]["tenant"] == "batcher"
    finally:
        server.stop()


# ------------------------------------------- gRPC deadlines and TLS probes


class _Ctx:
    """A gRPC servicer context's deadline half."""

    def __init__(self, v):
        self.v = v

    def time_remaining(self):
        if isinstance(self.v, Exception):
            raise self.v
        return self.v


@pytest.mark.parametrize("remaining,want", [
    (None, None), (2e8, None),          # grpcio's no-deadline sentinel
    (RuntimeError(), None),             # a transport without deadlines
    (1.25, 1.25), (-0.5, 0.0), (0.0, 0.0),  # lapsed in transit: shed at once
])
def test_grpc_timeout_contract(remaining, want):
    assert qos.grpc_timeout(_Ctx(remaining)) == want
    assert jqos.grpc_timeout(_Ctx(remaining)) == want


def test_grpc_deadline_becomes_the_request_budget():
    """A gRPC deadline reaches the scheduler as the request's budget, as
    ``X-Dgraph-Timeout`` does: a Run whose deadline has lapsed by the
    time it is admitted sheds with DEADLINE_EXCEEDED."""
    grpc = pytest.importorskip("grpc")
    from dgraph_tpu_torch.serve import grpc_server as tg

    server = DgraphServer(PostingStore(), device="cpu")
    server.start()
    g = tg.GrpcServer(server, port=0)
    g.start()
    seen = []
    real = server.run_query

    def spy(text, *a, **kw):
        seen.append(kw.get("timeout_s"))
        return real(text, *a, **kw)

    server.run_query = spy
    try:
        with grpc.insecure_channel(f"127.0.0.1:{g.port}") as ch:
            run = ch.unary_unary("/protos.Dgraph/Run")
            run(tg.encode_request("{ q(func: uid(0x1)) { uid } }"), timeout=30)
            assert seen[-1] is not None and 0 < seen[-1] <= 30
            fail.arm("sched.flush", "delay(ms=400,n=1)")
            with pytest.raises(grpc.RpcError) as ei:
                run(tg.encode_request("{ q(func: uid(0x2)) { uid } }"), timeout=0.2)
            assert ei.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
    finally:
        fail.reset()
        g.stop()
        server.stop()


def _tls_pair(tmp_path):
    """An ssl-wrapped socketpair (server side, client side); skips when
    openssl cannot mint the self-signed cert."""
    import socket as _socket
    import ssl

    from torch_tls import make_cert

    cert, key = make_cert(tmp_path)
    s1, s2 = _socket.socketpair()
    sctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    sctx.load_cert_chain(cert, key)
    cctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    cctx.check_hostname = False
    cctx.verify_mode = ssl.CERT_NONE
    out = {}

    def _server():
        out["server"] = sctx.wrap_socket(s1, server_side=True)

    t = threading.Thread(target=_server, daemon=True)
    t.start()
    client = cctx.wrap_socket(s2, server_hostname="localhost")
    t.join(timeout=10)
    assert "server" in out, "TLS handshake did not complete"
    return out["server"], client


def _wait_true(probe, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if probe():
            return True
        time.sleep(0.02)
    return False


def test_disconnect_probe_tls(tmp_path):
    """The TLS flavour peeks the RAW fd and honours the SSL layer's
    buffered-pending, so a vanished HTTPS client cancels cooperatively
    too, and a peeked TLS record is never consumed; the reference's
    probe gives the same verdict at every step."""
    server, client = _tls_pair(tmp_path)
    try:
        probes = (qos.socket_disconnect_probe(server),
                  jqos.socket_disconnect_probe(server))

        def verdicts():
            return [p() for p in probes]

        assert verdicts() == [False, False]           # idle, connected
        client.sendall(b"app-bytes")                  # an undrained record
        assert verdicts() == [False, False]           # readable != gone
        assert server.recv(9) == b"app-bytes"         # record fully intact
        client.sendall(b"xy")
        assert server.recv(1) == b"x"                 # leaves 'y' pending
        assert server.pending() >= 1
        assert verdicts() == [False, False]           # pending bytes: alive
        assert server.recv(1) == b"y"
        client.close()
        assert _wait_true(probes[0])                  # raw FIN: gone
        assert probes[1]()
    finally:
        server.close()


def test_disconnect_probe_plain_tcp_matches_reference():
    import socket as _socket

    a, b = _socket.socketpair()
    try:
        probes = (qos.socket_disconnect_probe(a), jqos.socket_disconnect_probe(a))
        assert [p() for p in probes] == [False, False]
        b.sendall(b"pipelined")
        assert [p() for p in probes] == [False, False]
        assert a.recv(9) == b"pipelined"
        b.close()
        assert _wait_true(probes[0]) and probes[1]()
    finally:
        a.close()
