"""The port's delta stream and live-query subscriptions
(``dgraph_tpu_torch/ivm/deltas.py``, ``ivm/subs.py``, the store's
``delta_stream``, ``POST /subscribe``) against the reference's.

- Delta stream: the same op sequence through both packages' stores gives
  identical event lists (kind, pred, src, dst, sign, version), and
  identical overflow behaviour at a small cap.  A durable store's live
  mutations and schema changes publish; its recovery replay does not.
- Subscriptions (the reference's cases of ``tests/test_ivm.py``, on the
  port's server; the gRPC ``Subscribe`` stream beside the reference's,
  with equal pushed Responses and status codes): a push on an affecting
  write only,
  SSE inline and by attach, an unchanged result skips, quotas and caps,
  a debounce coalesces a burst, an unknowable footprint idles, a
  scheduler shed defers, a device fault defers, server stop cancels, and
  the ``/debug/store`` ``ivm`` section and series.
- Cross-package: the same registrations and writes on a reference server
  and a port server give the same sequence of events, with equal bodies.

Waits go through ``next_event(timeout=10)``; silence is checked with
short timeouts, never asserted tighter than whole seconds.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from dgraph_tpu.ivm.deltas import DeltaStream as JaxDeltaStream
from dgraph_tpu.models import PostingStore as JaxStore
from dgraph_tpu.models.store import Edge as JaxEdge
from dgraph_tpu.models.types import TypedValue as JaxTypedValue
from dgraph_tpu.models.types import TypeID as JaxTypeID
from dgraph_tpu.serve.server import DgraphServer as JaxServer
from dgraph_tpu_torch import ivm, obs
from dgraph_tpu_torch.ivm.deltas import DeltaStream
from dgraph_tpu_torch.models import PostingStore
from dgraph_tpu_torch.models.store import Edge
from dgraph_tpu_torch.models.types import TypedValue, TypeID
from dgraph_tpu_torch.serve.server import DgraphServer
from dgraph_tpu_torch.utils import devguard
from dgraph_tpu_torch.utils.failpoints import fail
from dgraph_tpu_torch.utils.metrics import SUBS_EVENTS

from torch_pins import pinned_planner  # noqa: F401

# every route decision of both planners is pinned, and both packages'
# guards and failpoints start fresh (tests/torch_pins.py)
pytestmark = pytest.mark.usefixtures("pinned_planner")


def _post(addr, body, path="/query", headers=None, timeout=30):
    req = urllib.request.Request(
        addr + path, data=body.encode(), headers=headers or {}
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode())


def _seed_ref_store():
    """The reference tests' seed graph (tests/test_ivm.py)."""
    st = JaxStore()
    st.apply_schema("friend: [uid] @reverse .\nname: string @index(exact) .")
    for i, nm in enumerate(["Ann", "Bob", "Cat", "Dan", "Eve"], start=1):
        st.set_value("name", i, JaxTypedValue(JaxTypeID.STRING, nm))
    for s, d in [(1, 2), (1, 3), (2, 3), (3, 4), (4, 5), (2, 5)]:
        st.set_edge("friend", s, d)
    return st


def _seed_store():
    """The same graph through the port's store, op for op, so versions
    and per-predicate versions equal the reference's."""
    st = PostingStore()
    st.apply_schema("friend: [uid] @reverse .\nname: string @index(exact) .")
    for i, nm in enumerate(["Ann", "Bob", "Cat", "Dan", "Eve"], start=1):
        st.apply(Edge(pred="name", src=i, value=TypedValue(TypeID.STRING, nm)))
    for s, d in [(1, 2), (1, 3), (2, 3), (3, 4), (4, 5), (2, 5)]:
        st.apply(Edge(pred="friend", src=s, dst=d))
    return st


def _server(**kw):
    srv = DgraphServer(_seed_store(), device="cpu", **kw)
    srv.start()
    return srv


# ------------------------------------------------------------ delta stream


def _ops(st, edge_cls, tv_cls, tid):
    """One op sequence over either package's PostingStore."""
    st.apply_schema("e: [uid] .\nname: string .")
    st.apply(edge_cls(pred="e", src=1, dst=2))
    st.apply(edge_cls(pred="e", src=1, dst=3))
    st.apply(edge_cls(pred="e", src=1, dst=2))  # re-set: a touch
    st.apply(edge_cls(pred="e", src=1, dst=3, op="del"))
    st.apply(edge_cls(pred="e", src=9, dst=9, op="del"))  # no-op delete
    st.apply(edge_cls(pred="name", src=1, value=tv_cls(tid.STRING, "a")))
    st.bulk_set_uid_edges("e", np.array([4, 5]), np.array([6, 7]))
    n = st.BULK_JOURNAL_MAX + 1
    st.bulk_set_uid_edges("f", np.arange(n), np.arange(n) + 1)
    st.bulk_set_values("name", [(2, "", tv_cls(tid.STRING, "b"))])
    st.delete_predicate("f")
    st.apply_schema("g: int .")


def test_delta_stream_events_match_reference():
    ref = JaxStore()
    ref.delta_stream = JaxDeltaStream()
    port = PostingStore()
    ivm.attach_stream(port)
    _ops(ref, JaxEdge, JaxTypedValue, JaxTypeID)
    _ops(port, Edge, TypedValue, TypeID)
    want, cur, lost = ref.delta_stream.read_since(0)
    got, cur2, lost2 = port.delta_stream.read_since(0)
    assert got == want
    assert (cur2, lost2) == (cur, lost)
    kinds = [e[3] for e in got]
    assert {"edge", "pred", "epoch"} <= set(kinds)
    assert port.delta_stream.snapshot() == ref.delta_stream.snapshot()


def test_unattached_store_publishes_nothing():
    st = PostingStore()
    st.apply(Edge(pred="e", src=1, dst=2))
    assert st.delta_stream is None
    ds = ivm.attach_stream(st)
    assert ivm.attach_stream(st) is ds  # idempotent
    assert ds.read_since(0) == ([], 0, False)


@pytest.mark.parametrize("cap, n", [(16, 40), (16, 16), (32, 5)])
def test_delta_stream_overflow_matches_reference(cap, n):
    streams = [JaxDeltaStream(cap=cap), DeltaStream(cap=cap)]
    reads = []
    for ds in streams:
        for i in range(n):
            ds.publish_edge("e", i, i + 1, 1 if i % 2 else -1, i + 1)
        mid = ds.read_since(3)
        ds.publish_epoch(n + 1)
        reads.append((mid, ds.read_since(0), ds.read_since(ds.seq),
                      ds.snapshot(), ds.dropped))
    assert reads[1] == reads[0]


def test_wait_for_wakes_on_publish():
    ds = DeltaStream(cap=16)
    assert not ds.wait_for(0, timeout=0.05)
    t = threading.Timer(0.1, lambda: ds.publish_pred("p", 1))
    t.start()
    assert ds.wait_for(0, timeout=10)
    t.join()


def test_durable_store_streams_live_writes_not_recovery(tmp_path):
    from dgraph_tpu_torch.models.wal import DurableStore

    d = str(tmp_path / "p")
    st = DurableStore(d)
    ivm.attach_stream(st)
    st.apply_schema("e: [uid] .")
    st.apply(Edge(pred="e", src=1, dst=2))
    st.bulk_set_uid_edges("e", np.array([3]), np.array([4]))
    st.delete_predicate("x")
    evs, _c, _l = st.delta_stream.read_since(0)
    assert [(e[2], e[3]) for e in evs] == [
        ("", "epoch"), ("e", "edge"), ("e", "pred"), ("x", "pred"),
    ]
    st.close()
    st2 = DurableStore(d)  # recovery replays every record
    assert st2.delta_stream is None
    srv = DgraphServer(st2, device="cpu")  # attaches after recovery
    srv.start()
    try:
        assert st2.delta_stream is not None
        assert st2.delta_stream.read_since(0) == ([], 0, False)
        st2.apply(Edge(pred="e", src=5, dst=6))
        assert st2.delta_stream.seq == 1
    finally:
        srv.stop()  # closes the store


def test_cluster_store_streams_nothing():
    from dgraph_tpu_torch.cluster.service import ClusterStore

    assert ClusterStore.supports_ivm_stream is False


# ----------------------------------------------------------- subscriptions


@pytest.fixture
def sub_srv(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_CACHE", "1")
    monkeypatch.setenv("DGRAPH_TPU_IVM", "1")
    monkeypatch.setenv("DGRAPH_TPU_SUBS_DEBOUNCE_MS", "5")
    rec = obs.configure(ratio=1.0, seed=13)
    srv = _server()
    yield srv, rec
    srv.stop()
    obs.configure(ratio=0.0)


def test_subscribe_push_on_affecting_write_only(sub_srv):
    srv, rec = sub_srv
    reg = _post(srv.addr, "{ s(func: uid(0x1)) { name friend { name } } }",
                "/subscribe")
    assert sorted(reg["preds"]) == ["friend", "name"]
    sub = srv.subs.get(reg["sub_id"])
    snap = sub.next_event(timeout=10)
    assert snap["kind"] == "snapshot" and snap["seq"] == 1
    assert snap["data"]["s"][0]["name"] == "Ann"
    _post(srv.addr, 'mutation { set { <0x9> <hobby> "chess" . } }')
    assert sub.next_event(timeout=0.6) is None  # unrelated: silence
    _post(srv.addr, "mutation { set { <0x1> <friend> <0x5> . } }")
    ev = sub.next_event(timeout=10)
    assert ev is not None and ev["kind"] == "update", ev
    assert any(f.get("name") == "Eve" for f in ev["data"]["s"][0]["friend"])
    assert ev["preds"] and "friend" in ev["preds"]
    assert ev["trace_id"]
    tr = rec.trace(ev["trace_id"])
    assert tr is not None
    assert any(s["name"] == "subs.eval" for s in tr["spans"])
    out = _post(srv.addr, "", "/subscribe/cancel?id=" + reg["sub_id"])
    assert out["code"] == "Success"
    assert sub.next_event(timeout=5)["kind"] == "cancelled"
    assert srv.subs.get(reg["sub_id"]) is None
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(srv.addr, "", "/subscribe/cancel?id=" + reg["sub_id"])
    assert ei.value.code == 404


def _sse_frames(url, body, frames, done, data=True):
    req = urllib.request.Request(url, data=body if data else None)
    with urllib.request.urlopen(req, timeout=30) as resp:
        assert resp.headers["Content-Type"] == "text/event-stream"
        buf = b""
        for line in resp:
            if line.strip() == b"" and buf:
                for ln in buf.split(b"\n"):
                    if ln.startswith(b"data: "):
                        frames.append(json.loads(ln[6:]))
                buf = b""
                if frames and frames[-1].get("kind") == "cancelled":
                    done.set()
                    return
            elif not line.startswith(b":"):
                buf += line.strip() + b"\n"


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.02)
    return False


def test_subscribe_sse_stream_inline(sub_srv):
    srv, _rec = sub_srv
    frames, done = [], threading.Event()
    t = threading.Thread(target=_sse_frames, daemon=True, args=(
        srv.addr + "/subscribe?stream=1",
        b"{ s(func: uid(0x2)) { c: count(friend) } }", frames, done,
    ))
    t.start()
    assert _wait(lambda: frames)
    assert frames[0]["kind"] == "snapshot"
    assert frames[0]["data"]["s"][0]["c"] == 2
    _post(srv.addr, "mutation { set { <0x2> <friend> <0x4> . } }")
    assert _wait(lambda: len(frames) >= 2)
    assert frames[1]["kind"] == "update"
    assert frames[1]["data"]["s"][0]["c"] == 3
    _post(srv.addr, "", "/subscribe/cancel?id=" + frames[0]["sub_id"])
    assert done.wait(timeout=10)
    t.join(timeout=10)
    assert not t.is_alive()


def test_subscribe_attach_by_id(sub_srv):
    srv, _rec = sub_srv
    reg = _post(srv.addr, "{ s(func: uid(0x3)) { friend { uid } } }",
                "/subscribe")
    frames, done = [], threading.Event()
    t = threading.Thread(target=_sse_frames, daemon=True, args=(
        srv.addr + "/subscribe?id=" + reg["sub_id"], None, frames, done,
        False,
    ))
    t.start()
    assert _wait(lambda: frames)
    assert frames[0]["kind"] == "snapshot"
    _post(srv.addr, "mutation { set { <0x3> <friend> <0x1> . } }")
    assert _wait(lambda: len(frames) >= 2)
    assert frames[1]["kind"] == "update"
    srv.subs.cancel(reg["sub_id"])
    assert done.wait(timeout=10)
    t.join(timeout=10)
    assert not t.is_alive()
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(srv.addr + "/subscribe?id=nope", timeout=10)
    assert ei.value.code == 404


def test_subscribe_unchanged_result_skips(sub_srv):
    srv, _rec = sub_srv
    reg = _post(srv.addr, "{ s(func: uid(0x1)) { name } }", "/subscribe")
    sub = srv.subs.get(reg["sub_id"])
    assert sub.next_event(timeout=10)["kind"] == "snapshot"
    s0 = SUBS_EVENTS.snapshot()
    # a footprint predicate on ANOTHER node: re-evaluated, unchanged
    _post(srv.addr, 'mutation { set { <0x5> <name> "Eve2" . } }')
    assert sub.next_event(timeout=1.0) is None
    assert _wait(lambda: SUBS_EVENTS.snapshot().get("skip", 0)
                 > s0.get("skip", 0))
    # re-setting an existing edge in the footprint: also a skip
    sub2 = srv.subs.register("{ s(func: uid(0x1)) { friend { uid } } }")
    assert sub2.next_event(timeout=10)["kind"] == "snapshot"
    s1 = SUBS_EVENTS.snapshot().get("skip", 0)
    _post(srv.addr, "mutation { set { <0x1> <friend> <0x2> . } }")
    assert sub2.next_event(timeout=1.0) is None
    assert _wait(lambda: SUBS_EVENTS.snapshot().get("skip", 0) > s1)
    srv.subs.cancel(reg["sub_id"])
    srv.subs.cancel(sub2.id)


def test_subscribe_quota_and_caps(sub_srv):
    srv, _rec = sub_srv
    srv.subs.per_tenant_default = 1
    body = "{ s(func: uid(0x1)) { name } }"

    def register(tenant):
        return _post(srv.addr, body, "/subscribe",
                     headers={"X-Dgraph-Tenant": tenant})

    ok = register("alpha")
    with pytest.raises(urllib.error.HTTPError) as ei:
        register("alpha")
    assert ei.value.code == 429
    assert int(ei.value.headers["Retry-After"]) >= 1
    ok2 = register("beta")  # the quota is tenant-scoped
    srv.subs.max_total = 2
    with pytest.raises(urllib.error.HTTPError) as ei:
        register("gamma")  # the global cap
    assert ei.value.code == 429
    for bad in ('mutation { set { <0x1> <name> "x" . } }', "{ s(func: "):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.addr, bad, "/subscribe")
        assert ei.value.code == 400
    srv.subs.cancel(ok["sub_id"])
    srv.subs.cancel(ok2["sub_id"])


def test_subscribe_debounce_coalesces_burst(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_SUBS_DEBOUNCE_MS", "400")
    monkeypatch.setenv("DGRAPH_TPU_CACHE", "1")
    srv = _server()
    try:
        sub = srv.subs.register("{ s(func: uid(0x1)) { friend { uid } } }")
        assert sub.next_event(timeout=10)["kind"] == "snapshot"
        for d in (5, 6, 7, 8):
            _post(srv.addr, "mutation { set { <0x1> <friend> <0x%x> . } }" % d)
        ev = sub.next_event(timeout=10)
        assert ev is not None and ev["kind"] == "update"
        assert len(ev["data"]["s"][0]["friend"]) == 6  # the final state
        assert sub.next_event(timeout=0.7) is None
    finally:
        srv.stop()


def test_unknowable_footprint_sub_idles_quietly(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_CACHE", "1")
    srv = _server()
    try:
        sub = srv.subs.register("{ s(func: uid(0x1)) { expand(_all_) } }")
        assert sub.footprint is None
        assert sub.next_event(timeout=10)["kind"] == "snapshot"
        evals0 = sub.evals
        time.sleep(2.3)  # two idle ticks, zero mutations
        assert sub.evals == evals0, "idle ticks re-evaluated the sub"
        _post(srv.addr, 'mutation { set { <0x7> <whatever> "x" . } }')
        assert _wait(lambda: sub.evals > evals0, timeout=5)
    finally:
        srv.stop()


def test_scheduler_shed_defers_instead_of_cancelling(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_CACHE", "1")
    srv = _server()
    try:
        sub = srv.subs.register("{ s(func: uid(0x1)) { friend { uid } } }")
        assert sub.next_event(timeout=10)["kind"] == "snapshot"
        s0 = SUBS_EVENTS.snapshot().get("deferred", 0)
        srv.scheduler.queue_cap = 0  # every eval sheds
        _post(srv.addr, "mutation { set { <0x1> <friend> <0x5> . } }")
        assert _wait(lambda: SUBS_EVENTS.snapshot().get("deferred", 0) > s0,
                     timeout=5)
        assert not sub.token.cancelled
        assert srv.subs.get(sub.id) is not None
        assert sub.pending, "triggers must be restored for the retry"
        srv.scheduler.queue_cap = 256
        ev = sub.next_event(timeout=10)
        assert ev is not None and ev["kind"] == "update", ev
    finally:
        srv.stop()


def test_device_fault_defers_instead_of_cancelling(monkeypatch):
    """A sick card answers a client 503; a subscription's re-evaluation
    hitting it is deferred, and pushes once the probe re-admits."""
    monkeypatch.setenv("DGRAPH_TPU_CACHE", "0")
    monkeypatch.setenv("DGRAPH_TPU_DEVICE_COOLDOWN_S", "1")
    srv = _server()
    srv.engine.expand_device_min = 1
    try:
        sub = srv.subs.register("{ s(func: uid(0x1)) { friend { uid } } }")
        assert sub.next_event(timeout=10)["kind"] == "snapshot"
        s0 = SUBS_EVENTS.snapshot().get("deferred", 0)
        fail.arm("device.hop", "error(n=3)")  # three faults: sick
        _post(srv.addr, "mutation { set { <0x1> <friend> <0x5> . } }")
        assert _wait(lambda: SUBS_EVENTS.snapshot().get("deferred", 0) > s0,
                     timeout=10)
        assert not sub.token.cancelled
        ev = sub.next_event(timeout=15)
        assert ev is not None and ev["kind"] == "update", ev
        assert len(ev["data"]["s"][0]["friend"]) == 3
        assert devguard.get().faults.get("transient", 0) >= 1
    finally:
        srv.stop()


def test_server_stop_cancels_subscriptions(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_CACHE", "1")
    srv = _server()
    sub = srv.subs.register("{ s(func: uid(0x1)) { name } }")
    assert sub.next_event(timeout=10)["kind"] == "snapshot"
    srv.stop()
    assert sub.token.cancelled
    assert sub.next_event(timeout=5)["kind"] == "cancelled"
    assert not any(t.name == "dgraph-subs" and t.is_alive()
                   for t in threading.enumerate()
                   if t is srv.subs._thread)


def test_debug_store_ivm_section_and_series(sub_srv):
    srv, _rec = sub_srv
    reg = _post(srv.addr, "{ s(func: uid(0x1)) { name } }", "/subscribe")
    with urllib.request.urlopen(srv.addr + "/debug/store", timeout=10) as r:
        st = json.loads(r.read().decode())
    assert st["ivm"]["tracked_preds"] >= 2
    assert st["ivm"]["stream"]["seq"] >= 0
    assert st["ivm"]["subs"]["active"] == 1
    assert st["ivm"]["subs"]["subs"][0]["id"] == reg["sub_id"]
    with urllib.request.urlopen(
        srv.addr + "/debug/prometheus_metrics", timeout=10
    ) as r:
        text = r.read().decode()
    for name in ("dgraph_subscription_active",
                 "dgraph_subscription_evals_total",
                 "dgraph_ivm_deltas_total"):
        assert name in text
    srv.subs.cancel(reg["sub_id"])


def test_subs_gate_off_serves_404(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_SUBS", "0")
    srv = _server()
    try:
        assert srv.subs is None
        assert srv.store.delta_stream is not None  # the stream stays
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.addr, "{ s(func: uid(0x1)) { name } }", "/subscribe")
        assert ei.value.code == 404
        with urllib.request.urlopen(srv.addr + "/debug/store", timeout=10) as r:
            assert json.loads(r.read().decode())["ivm"]["subs"] is None
    finally:
        srv.stop()


# ---------------------------------------------------- against the reference


_CROSS_SUBS = [
    "{ s(func: uid(0x1)) { name friend { name } } }",
    "{ s(func: uid(0x2)) { c: count(friend) } }",
    '{ s(func: eq(name, "Cat")) { uid name } }',
]
_CROSS_WRITES = [
    "mutation { set { <0x1> <friend> <0x4> . } }",
    'mutation { set { <0x9> <hobby> "chess" . } }',
    'mutation { set { <0x3> <name> "Cathy" . } }',
    "mutation { set { <0x1> <friend> <0x4> . } }",
    "mutation { delete { <0x2> <friend> <0x3> . } }",
]


def _drain(sub, settle=0.6):
    out = []
    while True:
        ev = sub.next_event(timeout=settle)
        if ev is None:
            return out
        out.append(ev)


def _canon(ev):
    keep = {k: ev[k] for k in ("kind", "seq", "preds", "version")}
    data = dict(ev.get("data") or {})
    data.pop("server_latency", None)
    keep["data"] = data
    return keep


def test_events_match_reference(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_SUBS_DEBOUNCE_MS", "5")
    ref = JaxServer(_seed_ref_store())
    port = DgraphServer(_seed_store(), device="cpu")
    ref.start()
    port.start()
    try:
        seqs = {}
        for name, srv in (("reference", ref), ("port", port)):
            subs = [srv.subs.register(q) for q in _CROSS_SUBS]
            events = [[_canon(e) for e in _drain(s)] for s in subs]
            for w in _CROSS_WRITES:
                _post(srv.addr, w)
                for s, evs in zip(subs, events):
                    evs += [_canon(e) for e in _drain(s)]
            for s in subs:
                srv.subs.cancel(s.id)
            seqs[name] = events
        assert json.dumps(seqs["port"], sort_keys=True) == json.dumps(
            seqs["reference"], sort_keys=True
        )
        kinds = [e["kind"] for evs in seqs["port"] for e in evs]
        assert kinds.count("snapshot") == 3 and "update" in kinds
    finally:
        ref.stop()
        port.stop()


# ------------------------------------------------ the gRPC Subscribe stream


class _Stream:
    """One ``/protos.Dgraph/Subscribe`` call consumed on a thread: each
    pushed Response decoded into ``got``."""

    def __init__(self, grpc, port, text, proto, request):
        self.grpc = grpc
        self.ch = grpc.insecure_channel(f"127.0.0.1:{port}")
        self.call = self.ch.unary_stream("/protos.Dgraph/Subscribe")(
            request(text), timeout=60)
        self.got = []
        self.error = None

        def consume():
            try:
                for m in self.call:
                    self.got.append(proto.decode_response(m))
            except grpc.RpcError as e:
                self.error = e

        self.thread = threading.Thread(target=consume, daemon=True)
        self.thread.start()

    def wait(self, n, timeout=10.0):
        return _wait(lambda: len(self.got) >= n, timeout)

    def close(self):
        self.call.cancel()
        self.thread.join(timeout=10)
        self.ch.close()


def _grpc_stream(srv, text, pkg="port"):
    grpc = pytest.importorskip("grpc")
    if pkg == "port":
        from dgraph_tpu_torch.serve import grpc_server as g
        from dgraph_tpu_torch.serve import proto
    else:
        from dgraph_tpu.serve import grpc_server as g
        from dgraph_tpu.serve import proto
    gs = g.GrpcServer(srv, port=0)
    gs.start()
    return gs, _Stream(grpc, gs.port, text, proto, g.encode_request)


def test_subscribe_grpc_server_stream(sub_srv):
    """The unary-stream twin of POST /subscribe: a snapshot Response with
    the ``_subscription_`` block, an update after an affecting write, and
    the registry drops the subscription when the client goes away."""
    srv, _rec = sub_srv
    gs, st = _grpc_stream(srv, "{ s(func: uid(0x1)) { c: count(friend) } }")
    try:
        assert st.wait(1), "no snapshot frame"
        assert st.got[0]["s"][0]["c"] == 2
        meta = st.got[0]["_subscription_"][0]
        assert meta["kind"] == "snapshot" and meta["sub_id"]
        assert srv.subs.get(meta["sub_id"]) is not None
        _post(srv.addr, "mutation { set { <0x1> <friend> <0x4> . } }")
        assert st.wait(2)
        assert st.got[1]["s"][0]["c"] == 3
        assert st.got[1]["_subscription_"][0]["kind"] == "update"
        assert st.got[1]["_subscription_"][0]["preds"] == "friend"
        st.close()
        assert _wait(lambda: srv.subs.get(meta["sub_id"]) is None), (
            "the subscription outlived its client")
    finally:
        gs.stop()


def test_subscribe_grpc_stream_matches_reference(monkeypatch):
    """The same registrations and writes through a reference server's
    Subscribe stream and a port server's give the same sequence of
    pushed Responses (the per-process sub and trace ids aside)."""
    monkeypatch.setenv("DGRAPH_TPU_SUBS_DEBOUNCE_MS", "5")
    ref = JaxServer(_seed_ref_store())
    port = DgraphServer(_seed_store(), device="cpu")
    ref.start()
    port.start()
    seqs = {}
    try:
        for name, srv in (("reference", ref), ("port", port)):
            opened = [_grpc_stream(srv, q, name) for q in _CROSS_SUBS]
            try:
                for _gs, st in opened:
                    assert st.wait(1)
                for w in _CROSS_WRITES:
                    _post(srv.addr, w)
                    time.sleep(0.6)
                seqs[name] = []
                for _gs, st in opened:
                    frames = []
                    for m in st.got:
                        m = dict(m)
                        meta = dict(m.pop("_subscription_")[0])
                        for k in ("sub_id", "trace_id"):
                            meta.pop(k, None)
                        frames.append([meta, m])
                    seqs[name].append(frames)
            finally:
                for gs, st in opened:
                    st.close()
                    gs.stop()
        assert json.dumps(seqs["port"], sort_keys=True) == json.dumps(
            seqs["reference"], sort_keys=True)
        kinds = [f[0]["kind"] for frames in seqs["port"] for f in frames]
        assert kinds.count("snapshot") == 3 and "update" in kinds
    finally:
        ref.stop()
        port.stop()


def test_subscribe_grpc_device_fault_defers(monkeypatch):
    """A re-evaluation that meets a sick card is deferred, not ended: the
    gRPC stream stays open and pushes once the probe re-admits — never a
    host evaluation in between (the port's divergence, ROADMAP.md)."""
    monkeypatch.setenv("DGRAPH_TPU_CACHE", "0")
    monkeypatch.setenv("DGRAPH_TPU_DEVICE_COOLDOWN_S", "1")
    srv = _server()
    srv.engine.expand_device_min = 1
    gs, st = _grpc_stream(srv, "{ s(func: uid(0x1)) { friend { uid } } }")
    try:
        assert st.wait(1)
        s0 = SUBS_EVENTS.snapshot().get("deferred", 0)
        fail.arm("device.hop", "error(n=3)")  # three faults: sick
        _post(srv.addr, "mutation { set { <0x1> <friend> <0x5> . } }")
        assert _wait(lambda: SUBS_EVENTS.snapshot().get("deferred", 0) > s0)
        assert len(st.got) == 1 and st.error is None
        assert st.wait(2, timeout=15)
        assert st.got[1]["_subscription_"][0]["kind"] == "update"
        assert len(st.got[1]["s"][0]["friend"]) == 3
        assert devguard.get().faults.get("transient", 0) >= 1
    finally:
        st.close()
        gs.stop()
        srv.stop()


@pytest.mark.parametrize("text,env", [
    ("mutation { set { <0x1> <name> \"x\" . } }", {}),   # read-only: refused
    ("{ s(func: uid(0x1)) { name }", {}),                 # parse error
    ("{ s(func: uid(0x1)) { name } }", {"DGRAPH_TPU_SUBS": "0"}),  # disabled
])
def test_subscribe_grpc_status_codes_match_reference(monkeypatch, text, env):
    grpc = pytest.importorskip("grpc")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    codes = []
    for pkg, srv in (("reference", JaxServer(_seed_ref_store())),
                     ("port", DgraphServer(_seed_store(), device="cpu"))):
        srv.start()
        gs, st = _grpc_stream(srv, text, pkg)
        try:
            st.thread.join(timeout=20)
            assert not st.thread.is_alive() and st.error is not None
            codes.append(st.error.code())
        finally:
            st.close()
            gs.stop()
            srv.stop()
    assert codes[0] == codes[1] != grpc.StatusCode.OK
