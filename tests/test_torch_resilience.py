"""The resilience layer of the port (``dgraph_tpu_torch.cluster.
peerclient``, ``utils/failpoints.py``, the degraded reads of
``cluster/service.ClusterStore``) — the cases of tests/test_resilience.py
run on the port's modules and servers (``device="cpu"``).

Unit half: the failpoint registry and PeerClient's retry budget,
circuit breaker and health ordering with fake attempt functions, and
the gRPC leg (``grpc_unary``) held to the reference's on the same fake
channels.  Cluster half (``chaos``-marked, seeded and bounded,
tier 1): a real 2-server placement cluster of port servers with faults
injected at the named sites — bounded latency under a stalling or dead
owner, degraded-but-correct stale reads that converge after heal, 503 +
Retry-After with nothing cached, forwarding through a timeout storm.

Last, the arena refresh on a ``ClusterStore``, which has no delta
journal: a replica apply marks the predicate dirty, and the next read
rebuilds the arena from a fresh snapshot copy.
"""

import io
import json
import random
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from dgraph_tpu_torch.cluster.peerclient import (
    CLOSED,
    OPEN,
    BreakerOpenError,
    PeerClient,
    PeerUnavailableError,
)
from dgraph_tpu_torch.utils.failpoints import FailpointError, Failpoints, fail
from torch_pins import pinned_planner  # noqa: F401

# every route decision of both planners is pinned (tests/torch_pins.py)
pytestmark = pytest.mark.usefixtures("pinned_planner")


@pytest.fixture(autouse=True)
def _clean_failpoints():
    fail.reset()
    yield
    fail.reset()


def _wait(cond, timeout=30.0, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return False


# ---------------------------------------------------------------- failpoints


def test_failpoint_spec_parsing_and_counting():
    fp = Failpoints(seed=3)
    fp.configure("a=error(p=1,n=2);b=delay(ms=1)")
    with pytest.raises(FailpointError):
        fp.point("a")
    with pytest.raises(FailpointError):
        fp.point("a")
    fp.point("a")  # n exhausted: no-op
    assert fp.hits("a") == 2
    t0 = time.monotonic()
    fp.point("b")
    assert time.monotonic() - t0 >= 0.001
    assert fp.hits("b") == 1
    with pytest.raises(ValueError):
        fp.configure("a=explode()")
    with pytest.raises(ValueError):
        fp.configure("justasite")
    with pytest.raises(ValueError):
        fp.configure("a=error(frequency=2)")


def test_failpoint_disarmed_is_noop():
    fp = Failpoints()
    fp.point("never.armed")  # must not raise
    fp.arm("x", "error")
    fp.disarm("x")
    fp.point("x")
    assert fp.hits("x") == 0


def test_failpoint_probability_is_seed_deterministic():
    def run(seed):
        fp = Failpoints(seed=seed)
        fp.arm("x", "error(p=0.5)")
        out = []
        for _ in range(32):
            try:
                fp.point("x")
                out.append(0)
            except FailpointError:
                out.append(1)
        return out

    a, b, c = run(42), run(42), run(7)
    assert a == b
    assert 0 < sum(a) < 32
    assert a != c  # different seed, different fault schedule


# ----------------------------------------------------------------- peerclient


def _client(**kw):
    kw.setdefault("attempts", 3)
    kw.setdefault("backoff_base", 0.001)
    kw.setdefault("breaker_threshold", 3)
    kw.setdefault("breaker_cooldown", 0.2)
    kw.setdefault("rng", random.Random(1))
    return PeerClient(**kw)


def test_retry_recovers_from_transient_failures():
    pc = _client()
    calls = []

    def flaky(t):
        calls.append(t)
        if len(calls) < 3:
            raise OSError("transient")
        return "ok"

    assert pc.call("p", "op", flaky, budget=2.0) == "ok"
    assert len(calls) == 3
    assert pc.state_of("p") == CLOSED  # success reset the failure streak


def test_budget_bounds_total_call_time():
    pc = _client(attempts=50, breaker_threshold=1000)

    def dead(t):
        raise OSError("down")

    t0 = time.monotonic()
    with pytest.raises(PeerUnavailableError):
        pc.call("p", "op", dead, budget=0.25)
    # attempts + backoffs all fit inside the budget (generous 4x slack
    # for a noisy host)
    assert time.monotonic() - t0 < 1.0


def test_per_attempt_timeout_derives_from_remaining_budget():
    pc = _client(attempts=4, breaker_threshold=1000)
    seen = []

    def capture(t):
        seen.append(t)
        raise OSError("x")

    with pytest.raises(PeerUnavailableError):
        pc.call("p", "op", capture, budget=1.0)
    assert len(seen) == 4
    # first slice ~budget/attempts, and no attempt gets more than the
    # budget that remained when it started
    assert seen[0] <= 1.0 / 4 + 0.05
    assert all(t <= 1.0 for t in seen)


def test_slice_budget_off_first_attempt_owns_full_window():
    """slice_budget=False (forward / join / raft.send): the FIRST attempt
    gets the whole budget — a blocking-but-succeeding call (a forwarded
    proposal committing) must never be cut off at budget/attempts and
    re-sent as a duplicate.  Retries still happen, but only on failures
    fast enough to leave budget on the table."""
    pc = _client(attempts=2, breaker_threshold=1000)
    seen = []

    def fast_fail(t):
        seen.append(t)
        raise OSError("connect refused")  # instant: consumes no budget

    with pytest.raises(PeerUnavailableError):
        pc.call("p", "op", fast_fail, budget=1.0, slice_budget=False)
    assert len(seen) == 2  # fast failures still buy the retry
    assert seen[0] >= 1.0 - 0.05  # no halving: attempt 1 owns the window
    assert seen[1] >= 0.9  # ...and the fast failure left it nearly intact


def test_slice_budget_off_timeout_consumes_window_no_retry():
    """With slice_budget=False a first attempt that burns the whole
    budget (a real timeout) must NOT be retried — re-sending after the
    peer already held the request the full window is exactly the
    duplicate-proposal amplification the mode exists to prevent."""
    pc = _client(attempts=2, breaker_threshold=1000)
    seen = []

    def slow_timeout(t):
        seen.append(t)
        time.sleep(min(t, 0.15))  # consume the window like a socket timeout
        raise OSError("timed out")

    with pytest.raises(PeerUnavailableError):
        pc.call("p", "op", slow_timeout, budget=0.1, slice_budget=False)
    assert len(seen) == 1


def test_tiny_budget_never_slices_attempt_below_floor():
    """A nearly-exhausted budget must not manufacture breaker failures
    by issuing attempts whose timeout cannot complete a round trip: the
    per-attempt slice is floored at _MIN_ATTEMPT_TIMEOUT (bounded
    deadline overshoot) instead of clamped down to the dregs."""
    from dgraph_tpu_torch.cluster.peerclient import _MIN_ATTEMPT_TIMEOUT

    pc = _client()
    seen = []

    def capture(t):
        seen.append(t)
        raise OSError("down")

    with pytest.raises(PeerUnavailableError):
        pc.call("p", "op", capture, budget=_MIN_ATTEMPT_TIMEOUT / 2)
    assert seen  # the tiny budget still bought a real attempt
    assert all(t >= _MIN_ATTEMPT_TIMEOUT for t in seen)


def test_breaker_opens_then_sheds_without_touching_network():
    pc = _client(breaker_cooldown=60)
    hits = []

    def dead(t):
        hits.append(1)
        raise OSError("down")

    with pytest.raises(PeerUnavailableError):
        pc.call("p", "op", dead, budget=1.0)  # 3 attempts = threshold
    assert pc.state_of("p") == OPEN
    n = len(hits)
    t0 = time.monotonic()
    with pytest.raises(BreakerOpenError) as ei:
        pc.call("p", "op", dead, budget=10.0)
    assert time.monotonic() - t0 < 0.05  # shed, not retried
    assert len(hits) == n  # the attempt fn never ran
    assert ei.value.retry_after > 0


def test_breaker_half_open_probe_recovery():
    pc = _client(breaker_cooldown=0.15)

    def dead(t):
        raise OSError("down")

    with pytest.raises(PeerUnavailableError):
        pc.call("p", "op", dead, budget=1.0)
    assert pc.state_of("p") == OPEN
    # a FAILED half-open probe re-opens for another cooldown
    time.sleep(0.2)
    with pytest.raises(PeerUnavailableError):
        pc.call("p", "op", dead, budget=0.1, attempts=1)
    assert pc.state_of("p") == OPEN
    # a SUCCESSFUL probe closes the circuit
    time.sleep(0.2)
    assert pc.call("p", "op", lambda t: "back") == "back"
    assert pc.state_of("p") == CLOSED


def test_half_open_admits_exactly_one_probe():
    pc = _client(breaker_cooldown=0.1)
    with pytest.raises(PeerUnavailableError):
        pc.call("p", "op", lambda t: (_ for _ in ()).throw(OSError()), budget=1.0)
    assert pc.state_of("p") == OPEN
    time.sleep(0.15)
    probe_entered = threading.Event()
    release = threading.Event()
    result = {}

    def slow_probe(t):
        probe_entered.set()
        release.wait(2.0)
        return "ok"

    th = threading.Thread(
        target=lambda: result.update(r=pc.call("p", "op", slow_probe)),
        daemon=True,
    )
    th.start()
    assert probe_entered.wait(2.0)
    # while the single probe is in flight, everyone else sheds
    with pytest.raises(BreakerOpenError):
        pc.call("p", "op", lambda t: "nope")
    release.set()
    th.join(2.0)
    assert result.get("r") == "ok"
    assert pc.state_of("p") == CLOSED


def test_unexpected_exception_never_wedges_half_open_probe():
    """A probe raising something neither transient nor HTTPError (a sick
    peer emitting garbage: BadStatusLine, truncated frame, …) must count
    as a failed probe and release the single-probe slot — an un-recorded
    escape used to leave probe_inflight set forever, shedding every
    future call for that (peer, op) even after the peer healed."""
    import http.client

    pc = _client(breaker_cooldown=0.1)
    with pytest.raises(PeerUnavailableError):
        pc.call("p", "op", lambda t: (_ for _ in ()).throw(OSError()), budget=1.0)
    assert pc.state_of("p") == OPEN
    time.sleep(0.15)

    def garbage(t):
        raise http.client.BadStatusLine("not http")

    with pytest.raises(http.client.BadStatusLine):
        pc.call("p", "op", garbage)
    assert pc.state_of("p") == OPEN  # failed probe re-opened the circuit
    # the probe slot was released: after the cooldown a NEW probe is
    # admitted and a healthy peer closes the circuit again
    time.sleep(0.15)
    assert pc.call("p", "op", lambda t: "back") == "back"
    assert pc.state_of("p") == CLOSED


def test_stale_probe_release_cannot_free_new_probe_slot():
    """The half-open probe slot is released by TOKEN: a slow probe from
    an earlier half-open epoch whose cleanup fires after the slot was
    re-granted must not free the NEW probe's slot (which would admit two
    concurrent probes into one epoch)."""
    pc = _client(breaker_cooldown=0.05, breaker_threshold=1)
    with pytest.raises(PeerUnavailableError):
        pc.call("p", "op", lambda t: (_ for _ in ()).throw(OSError()),
                budget=1.0, attempts=1)
    assert pc.state_of("p") == OPEN
    time.sleep(0.07)
    ok1, _, tok1 = pc._admit("p", "op")  # probe epoch 1
    assert ok1 and tok1 is not None
    pc._record("p", "op", False)         # probe 1's attempt failed → OPEN
    time.sleep(0.07)
    ok2, _, tok2 = pc._admit("p", "op")  # probe epoch 2
    assert ok2 and tok2 is not None and tok2 != tok1
    pc._release_probe("p", "op", tok1)   # epoch-1 cleanup fires late
    ok3, _, tok3 = pc._admit("p", "op")
    assert not ok3 and tok3 is None      # still exactly one probe in flight
    pc._record("p", "op", True)          # probe 2 succeeds
    pc._release_probe("p", "op", tok2)
    assert pc.state_of("p") == CLOSED


def test_http_error_means_peer_alive():
    pc = _client(breaker_threshold=1)

    def hint(t):
        raise urllib.error.HTTPError(
            "http://x", 409, "conflict", None, io.BytesIO(b"2")
        )

    with pytest.raises(urllib.error.HTTPError):
        pc.call("p", "op", hint, budget=1.0)
    # an HTTP response is the peer TALKING: breaker stays closed even
    # with threshold 1
    assert pc.state_of("p") == CLOSED


def test_alive_status_is_breaker_success_not_retried():
    """The ``alive`` classifier (the gRPC leg uses it): a transient-typed
    error it judges alive is the peer ANSWERING — un-retried, a breaker
    success; a dead one is retried until the breaker opens."""

    class _Err(Exception):
        def __init__(self, code):
            self.code = code

    def alive(e):
        return e.code not in ("UNAVAILABLE", "DEADLINE_EXCEEDED", "CANCELLED")

    pc = _client(breaker_threshold=2)
    calls = []

    def rejected(t):
        calls.append(t)
        raise _Err("UNAUTHENTICATED")

    with pytest.raises(_Err):
        pc.call("p", "raft.send", rejected, budget=1.0,
                transient=(_Err, OSError), alive=alive)
    assert len(calls) == 1  # the peer answered: no retry
    assert pc.state_of("p") == CLOSED

    calls2 = []

    def unavailable(t):
        calls2.append(t)
        raise _Err("UNAVAILABLE")

    with pytest.raises(PeerUnavailableError):
        pc.call("p2", "raft.send", unavailable, budget=1.0,
                transient=(_Err, OSError), alive=alive)
    assert len(calls2) == 2  # retried until the threshold opened the breaker
    assert pc.state_of("p2") == OPEN



@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_grpc_alive_status_is_breaker_success_not_retried(pkg):
    """gRPC's one RpcError covers both planes; only UNAVAILABLE /
    DEADLINE_EXCEEDED / CANCELLED mean the peer is unreachable.  An
    application-level rejection (UNAUTHENTICATED, INVALID_ARGUMENT, …)
    is the peer ANSWERING: un-retried, a breaker success.  The port's
    PeerClient and the reference's count the same calls and land in the
    same breaker states on the same fake channels."""
    grpc = pytest.importorskip("grpc")
    if pkg == "port":
        make = _client
    else:
        from dgraph_tpu.cluster import peerclient as jpc

        def make(**kw):
            kw.update(attempts=3, backoff_base=0.001, breaker_cooldown=0.2,
                      rng=random.Random(1))
            return jpc.PeerClient(**kw)

    class _Err(grpc.RpcError):
        def __init__(self, code):
            self._code = code

        def code(self):
            return self._code

    class _Chan:
        def __init__(self, exc):
            self.calls = 0
            self._exc = exc

        def unary_unary(self, method):
            def rpc(payload, timeout=None, metadata=None):
                self.calls += 1
                raise self._exc

            return rpc

    pc = make(breaker_threshold=2)
    ch = _Chan(_Err(grpc.StatusCode.UNAUTHENTICATED))
    with pytest.raises(grpc.RpcError):
        pc.grpc_unary("p", "raft.send", ch, "/m", b"", budget=1.0)
    assert ch.calls == 1  # the peer answered: no retry
    assert pc.state_of("p") == CLOSED

    ch2 = _Chan(_Err(grpc.StatusCode.UNAVAILABLE))
    with pytest.raises(Exception) as ei:
        pc.grpc_unary("p2", "raft.send", ch2, "/m", b"", budget=1.0)
    assert type(ei.value).__name__ == "PeerUnavailableError"
    assert ch2.calls == 2  # retried until the threshold opened the breaker
    assert pc.state_of("p2") == OPEN

def test_order_by_health_sorts_failing_peer_last():
    pc = _client(breaker_cooldown=60)
    pc.call("good", "op", lambda t: "ok")
    with pytest.raises(PeerUnavailableError):
        pc.call("bad", "op", lambda t: (_ for _ in ()).throw(OSError()), budget=0.5)
    members = [("bad", "http://b"), ("good", "http://g"), ("new", "http://n")]
    ordered = [nid for nid, _ in pc.order_by_health(members)]
    assert ordered.index("bad") == len(ordered) - 1
    assert ordered.index("good") < ordered.index("bad")


def test_resilience_off_is_single_shot(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_RESILIENCE", "0")
    pc = _client()
    calls = []

    def dead(t):
        calls.append(t)
        raise OSError("down")

    # the ORIGINAL error surfaces (no PeerUnavailableError wrapping), one
    # attempt only, no breaker state
    with pytest.raises(OSError) as ei:
        pc.call("p", "op", dead, budget=5.0, off_timeout=7.0)
    assert not isinstance(ei.value, PeerUnavailableError)
    assert calls == [7.0]
    assert pc.state_of("p") == CLOSED


def test_degraded_annotation_expires_when_stale_serving_stops():
    """One stale-served read of a pred that is then never queried again
    must not brand the node degraded forever after the owner heals: the
    annotation expires once no stale read has been SERVED recently.
    (Entries for preds still being read stale are refreshed on every
    serve, so an ongoing outage keeps its annotation.)"""
    from dgraph_tpu_torch.cluster.service import ClusterStore

    st = ClusterStore.__new__(ClusterStore)  # degraded_info needs only these:
    st._remote_lock = threading.Lock()
    st.remote_ttl = 0.1
    now = time.monotonic()
    st._degraded = {"city": [2, now - 100.0, now]}  # stale serve just now
    info = st.degraded_info()
    assert info["stale_groups"] == [2]
    assert info["age"] >= 100.0
    st._degraded = {"city": [2, now - 100.0, now - 60.0]}  # serves stopped
    assert st.degraded_info() is None
    assert st._degraded == {}  # pruned, /health stops reporting it too


def test_degraded_info_scoped_to_query_preds():
    """The annotation names only the stale groups a query can READ: a
    purely-local query gets no degraded disclosure even while another
    group's preds serve stale (preds=None stays the node-wide /health
    view)."""
    from dgraph_tpu_torch.cluster.service import ClusterStore

    st = ClusterStore.__new__(ClusterStore)
    st._remote_lock = threading.Lock()
    st.remote_ttl = 0.1
    now = time.monotonic()
    st._degraded = {"city": [2, now - 30.0, now], "visits": [3, now - 9.0, now]}
    assert st.degraded_info()["stale_groups"] == [2, 3]  # node-wide
    assert st.degraded_info(preds={"name", "knows"}) is None  # local-only
    scoped = st.degraded_info(preds={"name", "city"})
    assert scoped["stale_groups"] == [2]
    assert scoped["age"] >= 30.0  # age of the SCOPED subset, not the max


def test_degraded_info_pred_thunk_is_lazy():
    """The engine hands ``preds`` as a thunk; the healthy path (nothing
    degraded — the overwhelmingly common case) must answer None without
    ever paying the query-AST walk behind it."""
    from dgraph_tpu_torch.cluster.service import ClusterStore

    st = ClusterStore.__new__(ClusterStore)
    st._remote_lock = threading.Lock()
    st.remote_ttl = 0.1
    st._degraded = {}
    ran = []
    assert st.degraded_info(preds=lambda: ran.append(1) or set()) is None
    assert not ran  # thunk never evaluated while healthy
    now = time.monotonic()
    st._degraded = {"city": [2, now - 3.0, now]}
    assert st.degraded_info(preds=lambda: {"city"})["stale_groups"] == [2]
    assert st.degraded_info(preds=lambda: {"name"}) is None


def _peek_store(fetch, cached=True):
    """Minimal ClusterStore for driving _remote_peek's failure paths:
    ``fetch`` raises in place of fetch_pred_snapshot."""
    from dgraph_tpu_torch.cluster.service import ClusterStore

    st = ClusterStore.__new__(ClusterStore)
    st._remote_lock = threading.Lock()
    st._fetch_locks = {}
    st._degraded = {}
    st.remote_ttl = 0.0  # force the freshness probe every peek
    now = time.monotonic()
    st._remote = {"city": [3, "CACHED", now - 10.0, now - 10.0]} if cached else {}

    class _PC:
        breaker_cooldown = 2.0

    class _Svc:
        peerclient = _PC()

        def fetch_pred_snapshot(self, pred, gid, since):
            return fetch()

    st._svc = _Svc()
    return st


def test_truncated_snapshot_read_degrades_not_errors():
    """An owner killed MID-RESPONSE raises http.client.IncompleteRead
    from resp.read() — an HTTPException, NOT an OSError — which must
    degrade to the cached copy exactly like an unreachable owner, not
    escape as a raw error past a perfectly good snapshot."""
    import http.client

    def truncated():
        raise http.client.IncompleteRead(b"", 100)

    st = _peek_store(truncated)
    assert st._remote_peek("city", 2) == "CACHED"
    assert st._degraded["city"][0] == 2  # recorded → annotation carries it
    # with nothing cached it is the 503-mapped StaleUnavailableError
    from dgraph_tpu_torch.cluster.peerclient import StaleUnavailableError

    with pytest.raises(StaleUnavailableError):
        _peek_store(truncated, cached=False)._remote_peek("city", 2)


def test_legacy_mode_raises_on_corrupt_frame_serves_stale_on_oserror(monkeypatch):
    """DGRAPH_TPU_RESILIENCE=0 is byte-identical to pre-PR: only the
    TRANSPORT class (OSError) fell back to the cached copy; a corrupt or
    truncated frame propagated.  Serving stale there would mask
    corruption with the annotation AND the counter both gated off."""
    import http.client

    monkeypatch.setenv("DGRAPH_TPU_RESILIENCE", "0")

    def corrupt():
        raise ValueError("bad frame")

    with pytest.raises(ValueError):
        _peek_store(corrupt)._remote_peek("city", 2)

    def truncated():
        raise http.client.IncompleteRead(b"", 100)

    with pytest.raises(http.client.IncompleteRead):
        _peek_store(truncated)._remote_peek("city", 2)

    def down():
        raise OSError("unreachable")

    st = _peek_store(down)
    assert st._remote_peek("city", 2) == "CACHED"  # pre-PR stale fallback
    assert st._degraded == {}  # but no PR-5 annotation state in legacy mode


def test_referenced_preds_collection():
    """The static pred collector behind degraded-annotation scoping:
    liberal collection (attr, func, filters, order, ~reverse) and a None
    bail on the schema-driven constructs it cannot see through."""
    from dgraph_tpu_torch import gql
    from dgraph_tpu_torch.gql.ast import referenced_preds

    p = gql.parse(
        """{ q(func: eq(name, "ann"), orderasc: age) @filter(has(city)) {
               name  friend: ~knows { city } } }"""
    )
    got = referenced_preds(p.queries)
    assert {"name", "age", "city", "knows"} <= got
    # expand() reads schema-driven predicate lists: not statically knowable
    p = gql.parse('{ q(func: uid(0x1)) { expand(_all_) } }')
    assert referenced_preds(p.queries) is None
    # var blocks count too (same parsed request)
    p = gql.parse(
        """{ v as var(func: eq(name, "ann")) { lives_in { city } }
             q(func: uid(v)) { name } }"""
    )
    assert {"name", "lives_in", "city"} <= referenced_preds(p.queries)


def test_failpoint_inside_peerclient_feeds_breaker():
    pc = _client(breaker_cooldown=60)
    fail.seed(0)
    fail.arm("peerclient.myop", "error")
    with pytest.raises(PeerUnavailableError):
        pc.call("p", "myop", lambda t: "never", budget=0.5)
    assert pc.state_of("p") == OPEN
    assert fail.hits("peerclient.myop") == 3


# ------------------------------------------------------------- cluster chaos


def _post(addr, path, body, timeout=15):
    req = urllib.request.Request(addr + path, data=body.encode())
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _free_ports(n):
    ports = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    return ports


@pytest.fixture()
def placed(tmp_path):
    """Two servers, disjoint data groups (the test_placement topology):
    server 1 places group 1 (name, knows), server 2 places group 2
    (city, lives_in, visits) — so server 1's reads of group-2
    predicates are REMOTE and can be partitioned with failpoints."""
    from dgraph_tpu_torch.cluster.groups import GroupConfig
    from dgraph_tpu_torch.cluster.service import ClusterService, parse_peer_groups
    from dgraph_tpu_torch.serve.server import DgraphServer

    conf = GroupConfig.parse(
        """
        1: name, knows
        2: city, lives_in, visits
        default: fp % 2 + 1
        """
    )
    ports = _free_ports(2)
    peers = {str(i + 1): f"http://127.0.0.1:{ports[i]}" for i in range(2)}
    pg = parse_peer_groups("1=0,1;2=0,2")
    servers = []
    for i, own in ((0, [0, 1]), (1, [0, 2])):
        nid = str(i + 1)
        svc = ClusterService(
            node_id=nid,
            my_addr=peers[nid],
            peers=peers,
            group_ids=own,
            directory=str(tmp_path / f"n{nid}"),
            group_config=conf,
            peer_groups=pg,
            tick_ms=10,
        )
        srv = DgraphServer(svc.store, port=ports[i], cluster=svc, device="cpu")
        svc.start()
        srv.start()
        servers.append(srv)
    for srv in servers:
        srv.store.remote_ttl = 0.05
    assert _wait(lambda: all(s.cluster.has_leader() for s in servers))
    yield servers
    for s in servers:
        try:
            s.stop()
        except Exception:
            pass


def _load(servers):
    _post(servers[0].addr, "/query", """
    mutation {
      schema { name: string @index(exact) . city: string @index(exact) .
               knows: uid . lives_in: uid . visits: uid . }
    }""")
    _post(servers[0].addr, "/query", """
    mutation { set {
      <0x1> <name> "ann" .
      <0x2> <name> "bob" .
      <0x1> <knows> <0x2> .
      <0x10> <city> "oslo" .
      <0x1> <lives_in> <0x10> .
    } }""")


_Q = '{ q(func: eq(name, "ann")) { name lives_in { city } } }'
_WANT = {"q": [{"name": "ann", "lives_in": [{"city": "oslo"}]}]}


def _ask(srv, q=_Q):
    got = _post(srv.addr, "/query", q)
    got.pop("server_latency", None)
    return got


@pytest.mark.chaos
def test_partitioned_owner_degrades_then_converges(placed):
    """(a)+(b): stall-then-fail faults on the snapshot fetch open the
    breaker, stale reads stay CORRECT, ANNOTATED, and FAST; healing the
    partition converges back to fresh reads with no annotation."""
    reader, owner = placed
    _load(placed)
    assert _wait(lambda: _ask(reader) == _WANT), _ask(reader)

    pc = reader.cluster.peerclient
    pc.breaker_threshold = 3
    pc.breaker_cooldown = 0.5
    reader.store.remote_ttl = 0.0  # every query must probe freshness
    fail.seed(0)
    # the EXPENSIVE failure mode: each fetch attempt stalls 40ms before
    # failing (a connect timeout in miniature, not a fast refusal)
    fail.arm("peerclient.snapshot", "error(ms=40)")

    # mutate on the owner DURING the partition: the reader must keep
    # serving the pre-partition value (stale-but-correct), not an error
    _post(owner.addr, "/query",
          'mutation { set { <0x11> <city> "rome" . <0x1> <lives_in> <0x11> . } }')

    got = _post(reader.addr, "/query", _Q)
    assert [e["city"] for e in got["q"][0]["lives_in"]] == ["oslo"]
    assert got["degraded"]["stale_groups"] == [2]
    assert got["degraded"]["age"] >= 0

    # the annotation is scoped to what a query READS: a purely group-1
    # (local) query served fully fresh must not be branded degraded by
    # the group-2 outage
    local = _post(reader.addr, "/query", '{ l(func: eq(name, "ann")) { name } }')
    assert local["l"] == [{"name": "ann"}]
    assert "degraded" not in local

    # breaker is open by now (threshold 3 consecutive failures); the
    # next queries shed the stall entirely: bounded latency
    assert _wait(lambda: pc.state_of("2") == OPEN, timeout=5), pc.snapshot()
    worst = 0.0
    for _ in range(10):
        t0 = time.monotonic()
        got = _post(reader.addr, "/query", _Q)
        worst = max(worst, time.monotonic() - t0)
        assert got["degraded"]["stale_groups"] == [2]
    # 10 stale queries ride the cache; without the breaker each would
    # pay >=3x40ms of injected stall — generous bound for noisy hosts
    assert worst < 1.0, f"p-max query latency {worst:.3f}s under open breaker"

    # heal: disarm the failpoint; after the cooldown the half-open probe
    # refetches, the annotation disappears and the owner's mid-partition
    # write becomes visible
    fail.disarm("peerclient.snapshot")

    def converged():
        got = _post(reader.addr, "/query", _Q)
        cities = sorted(
            c["city"] for e in got.get("q", []) for c in e.get("lives_in", [])
        )
        return cities == ["oslo", "rome"] and "degraded" not in got

    assert _wait(converged, timeout=15), _post(reader.addr, "/query", _Q)
    assert pc.state_of("2") == CLOSED


@pytest.mark.chaos
def test_no_cached_copy_is_503_with_retry_after(placed):
    """(b) second half: only a reader with NO cached snapshot still
    errors — and as a retriable 503 + Retry-After, not a raw 400/500."""
    reader, _owner = placed
    _load(placed)
    assert _wait(lambda: _ask(reader) == _WANT)
    fail.seed(0)
    fail.arm("peerclient.snapshot", "error")
    reader.store.remote_ttl = 0.0
    # `visits` was never read through this server: nothing to degrade to
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(reader.addr, "/query", "{ q(func: uid(0x1)) { visits { city } } }")
    assert ei.value.code == 503
    assert int(ei.value.headers["Retry-After"]) >= 1
    body = json.loads(ei.value.read())
    assert body["code"] == "ErrorServiceUnavailable"


@pytest.mark.chaos
def test_dead_peer_latency_bounded_and_annotated(placed):
    """(a) with a REAL dead peer: kill the owner server mid-suite; the
    reader keeps answering from cache, annotated, with bounded latency."""
    reader, owner = placed
    _load(placed)
    assert _wait(lambda: _ask(reader) == _WANT)
    reader.store.remote_ttl = 0.0
    pc = reader.cluster.peerclient
    pc.breaker_threshold = 3
    pc.breaker_cooldown = 30.0
    owner.stop()
    worst = 0.0
    for _ in range(12):
        t0 = time.monotonic()
        got = _post(reader.addr, "/query", _Q)
        worst = max(worst, time.monotonic() - t0)
        assert [e["city"] for e in got["q"][0]["lives_in"]] == ["oslo"]
        assert got["degraded"]["stale_groups"] == [2]
    assert worst < 2.0, f"worst query latency {worst:.3f}s with dead owner"
    assert pc.state_of("2") == OPEN


@pytest.mark.chaos
def test_forward_storm_proposals_survive(tmp_path, monkeypatch):
    """(c) a seeded timeout storm on proposal forwarding (on top of the
    natural 409 leader-hint chase): writes through every server still
    commit and replicate."""
    from dgraph_tpu_torch.cluster.service import ClusterService
    from dgraph_tpu_torch.serve.server import DgraphServer

    # same patience raise as tests/test_cluster_http._patient_proposals:
    # under suite load a commit+apply round trip can exceed the 10s
    # default, and a timed-out proposal invites a duplicate re-post that
    # queues behind the original — the storm must only fight INJECTED
    # faults, not a self-inflicted duplicate pile-up
    monkeypatch.setenv("DGRAPH_TPU_PROPOSE_TIMEOUT", "45")

    ports = _free_ports(3)
    peers = {str(i + 1): f"http://127.0.0.1:{ports[i]}" for i in range(3)}
    servers = []
    for i in range(3):
        nid = str(i + 1)
        svc = ClusterService(
            node_id=nid, my_addr=peers[nid], peers=peers,
            group_ids=[0, 1], directory=str(tmp_path / f"n{nid}"),
        )
        svc.start()
        srv = DgraphServer(svc.store, port=ports[i], cluster=svc, device="cpu")
        srv.start()
        servers.append(srv)
    try:
        assert _wait(lambda: all(s.cluster.has_leader() for s in servers))
        for s in servers:
            # breaker recovery faster than the client retry cadence below,
            # so a streak of injected failures that trips a forward
            # breaker heals within the test instead of wedging a writer
            s.cluster.peerclient.breaker_cooldown = 0.3
        fail.seed(1234)
        # bounded storm (n=30): the cluster must neither lose writes nor
        # wedge — every write commits, if need be after the storm drains
        fail.arm("peerclient.forward", "error(p=0.4,n=30)")
        for i in range(6):
            body = 'mutation { set { <0x%x> <tag> "w%d" . } }' % (0x50 + i, i)
            srv = servers[i % 3]
            # per-attempt socket timeout OUTLIVES the 45s proposal
            # window: every attempt ends with the server's own verdict
            # (an injected-fault 400 comes back in ms, a genuinely slow
            # commit is WAITED OUT) — hanging up on an in-flight
            # proposal just queues a duplicate behind it
            deadline = time.monotonic() + 120
            ok = False
            while time.monotonic() < deadline:
                try:
                    out = _post(srv.addr, "/query", body, timeout=60)
                    ok = out.get("code") == "Success"
                    if ok:
                        break
                except (urllib.error.HTTPError, OSError):
                    time.sleep(0.5)
            assert ok, f"write {i} never committed through the storm"
        fail.disarm("peerclient.forward")

        def all_tags():
            try:
                got = _post(
                    servers[0].addr, "/query", "{ q(func: has(tag)) { tag } }"
                )
            except (urllib.error.HTTPError, OSError):
                return False  # transient: the _wait deadline owns failure
            return len(got.get("q", [])) == 6

        assert _wait(all_tags, timeout=40)
        assert fail.hits("peerclient.forward") > 0, "storm never fired"
    finally:
        for s in servers:
            try:
                s.stop()
            except Exception:
                pass


@pytest.mark.chaos
def test_sched_flush_fault_fails_request_not_worker():
    """An injected scheduler-flush fault fails THAT request cleanly and
    the flush workers keep serving the next one."""
    from dgraph_tpu_torch.models import PostingStore
    from dgraph_tpu_torch.serve.server import DgraphServer

    srv = DgraphServer(PostingStore(), device="cpu")
    srv.start()
    try:
        _post(srv.addr, "/query",
              'mutation { set { <0x1> <name> "x" . } }')
        if srv.scheduler is None:
            pytest.skip("scheduler disabled in this environment")
        fail.seed(0)
        fail.arm("sched.flush", "error(n=1)")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.addr, "/query", "{ q(func: uid(0x1)) { name } }")
        # failed, reported, not hung: the port answers a server-side fault
        # 500 ErrorInternal (the reference 400s every engine exception)
        assert ei.value.code == 500
        out = _post(srv.addr, "/query", "{ q(func: uid(0x1)) { name } }")
        assert out["q"] == [{"name": "x"}]
    finally:
        srv.stop()


@pytest.mark.chaos
def test_health_detail_reports_breakers_and_degradation(placed):
    reader, owner = placed
    _load(placed)
    assert _wait(lambda: _ask(reader) == _WANT)
    with urllib.request.urlopen(reader.addr + "/health?detail=1", timeout=10) as r:
        detail = json.loads(r.read())
    assert detail["ok"] is True
    assert detail["node"] == "1"
    assert "0" in detail["raft"] and "leader" in detail["raft"]["0"]
    assert detail["degraded"] is None
    # now partition the owner and serve one stale read
    fail.seed(0)
    fail.arm("peerclient.snapshot", "error")
    reader.store.remote_ttl = 0.0
    got = _post(reader.addr, "/query", _Q)
    assert got["degraded"]["stale_groups"] == [2]
    with urllib.request.urlopen(reader.addr + "/health?detail=1", timeout=10) as r:
        detail = json.loads(r.read())
    assert detail["degraded"]["stale_groups"] == [2]
    assert detail["peers"]["2"]["snapshot"]["breaker"] in ("closed", "open")
    assert detail["peers"]["2"]["snapshot"]["consecutive_failures"] >= 1


def test_arena_refresh_on_cluster_store(tmp_path):
    """A ClusterStore has no delta journal (``delta`` / ``delta_base``):
    the arena manager's refresh after a replica apply must rebuild from a
    fresh snapshot copy, not raise AttributeError."""
    from dgraph_tpu_torch.cluster.service import ClusterService
    from dgraph_tpu_torch.models.store import Edge
    from dgraph_tpu_torch.query import QueryEngine

    port = _free_ports(1)[0]
    addr = f"http://127.0.0.1:{port}"
    svc = ClusterService(node_id="1", my_addr=addr, peers={"1": addr},
                         group_ids=[0, 1], directory=str(tmp_path / "n1"))
    svc.start()
    try:
        assert _wait(svc.has_leader)
        store = svc.store
        assert not hasattr(store, "delta") and not hasattr(store, "delta_base")
        store.apply_many([Edge("e", 1, dst=2), Edge("e", 1, dst=3), Edge("e", 2, dst=4)])
        eng = QueryEngine(store, device="cpu")
        eng.expand_device_min = 1  # every level through the gather wrapper
        q = "{ q(func: uid(0x1)) { uid e { uid e { uid } } } }"
        first = eng.run(q)
        assert [n["_uid_"] for n in first["q"][0]["e"]] == ["0x2", "0x3"]
        arena = eng.arenas.data("e")
        store.apply_many([Edge("e", 3, dst=5), Edge("e", 1, dst=2, op="del")])
        assert "e" in store.dirty  # the replica apply marked it
        got = eng.run(q)  # refresh: rebuild, no journal to patch from
        kids = got["q"][0]["e"]
        assert [n["_uid_"] for n in kids] == ["0x3"]
        assert kids[0]["e"] == [{"_uid_": "0x5"}]
        assert eng.arenas.data("e") is not arena
        assert "e" not in store.dirty
    finally:
        svc.stop()
