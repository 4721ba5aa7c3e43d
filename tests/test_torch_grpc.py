"""The port's gRPC surface (``dgraph_tpu_torch/serve/grpc_server.py``,
``client.GrpcTransport``, ``cluster/transport.GrpcRaftTransport``)
against the reference's, on the CPU.

The 27 cases of tests/test_grpc.py, each held to the reference: a port
server (``device="cpu"``) and a reference server take the same seed
mutation, each behind its own package's ``GrpcServer``; the same
hand-assembled request bytes go to both channels, and the cases assert
equal decoded ``Response`` trees (the latency field aside), equal status
codes and equal ``decode_request`` results.  Raft frames cross packages
too: the port's transport delivers to a reference Worker plane and back.

One status differs by design (``ROADMAP.md``, divergences): a device
fault answers ``UNAVAILABLE`` on the port, where the reference serves
the read from the host.

Every RPC carries a ``timeout=``, every server is stopped and every
channel closed in a ``finally``, so a hang fails in seconds.
"""

import socket
import struct
import time

import pytest

grpc = pytest.importorskip("grpc")

from dgraph_tpu.client import GrpcTransport as JaxGrpcTransport  # noqa: E402
from dgraph_tpu.models import PostingStore as JaxStore  # noqa: E402
from dgraph_tpu.serve import grpc_server as jg  # noqa: E402
from dgraph_tpu.serve.server import DgraphServer as JaxServer  # noqa: E402
from dgraph_tpu_torch.client import (  # noqa: E402
    BatchMutationOptions,
    ClientEdge,
    DgraphClient,
    GrpcTransport,
    HttpTransport,
)
from dgraph_tpu_torch.models import PostingStore  # noqa: E402
from dgraph_tpu_torch.serve import grpc_server as tg  # noqa: E402
from dgraph_tpu_torch.serve.proto import (  # noqa: E402
    _key,
    _len_field,
    _str_field,
    _varint_field,
    decode_response,
)
from dgraph_tpu_torch.serve.server import DgraphServer  # noqa: E402

from torch_pins import pinned_planner  # noqa: E402,F401
from torch_tls import make_cert  # noqa: E402

pytestmark = [
    pytest.mark.compile_budget(400),
    pytest.mark.usefixtures("pinned_planner"),
]

T = 30  # every RPC's deadline, seconds

SEED = (
    "mutation { schema { name: string @index(term, exact) . "
    "follows: uid @reverse @count . } "
    'set { <0x1> <name> "Ada" . <0x2> <name> "Grace" . '
    "<0x1> <follows> <0x2> (since=2020) . } }"
)


class _Pair:
    """A port server and a reference server over the same data, each
    behind its own package's GrpcServer, with one channel each."""

    def __init__(self):
        self.port = DgraphServer(PostingStore(), device="cpu")
        self.ref = JaxServer(JaxStore())
        self.gport = tg.GrpcServer(self.port, port=0)
        self.gref = jg.GrpcServer(self.ref, port=0)
        self.chans = []
        for s in (self.port, self.ref, self.gport, self.gref):
            s.start()
        self.cport = self._chan(self.gport.port)
        self.cref = self._chan(self.gref.port)

    def _chan(self, port):
        ch = grpc.insecure_channel(f"127.0.0.1:{port}")
        self.chans.append(ch)
        return ch

    def both_query(self, text):
        """``run_query`` on both servers (the in-process surface)."""
        return self.port.run_query(text), self.ref.run_query(text)

    def close(self):
        for ch in self.chans:
            ch.close()
        for s in (self.gport, self.gref, self.port, self.ref):
            s.stop()


@pytest.fixture(scope="module")
def pair():
    p = _Pair()
    try:
        for s in (p.port, p.ref):
            s.run_query(SEED)
        yield p
    finally:
        p.close()


def _strip(out: dict) -> dict:
    out = dict(out)
    out.pop("server_latency", None)
    return out


def _run(ch, req: bytes, method="/protos.Dgraph/Run", **kw) -> dict:
    return decode_response(ch.unary_unary(method)(req, timeout=T, **kw))


def _both(pair, req: bytes) -> dict:
    """The same request bytes through both servers' Run: the decoded
    Responses are equal (the latency field aside); returns the port's."""
    got, want = _run(pair.cport, req), _run(pair.cref, req)
    assert _strip(got) == _strip(want)
    return _strip(got)


def _code(ch, req: bytes, method="/protos.Dgraph/Run"):
    try:
        ch.unary_unary(method)(req, timeout=T)
    except grpc.RpcError as e:
        return e.code()
    return grpc.StatusCode.OK


# --------------------------------------------------------------- protos.Dgraph


def test_run_query_raw_bytes(pair):
    # Request{query=1} assembled by hand: a stock client's bytes
    req = _str_field(1, "{ q(func: uid(0x1)) { name follows { name } } }")
    out = _both(pair, req)
    assert out["q"] == [{"name": "Ada", "follows": [{"name": "Grace"}]}]


def test_run_with_vars_map(pair):
    # vars map<string,string> entries: field 4 {1: key, 2: value}
    req = _str_field(
        1, "query test($a: string) { q(func: eq(name, $a)) { _uid_ } }"
    ) + _len_field(4, _str_field(1, "$a") + _str_field(2, "Grace"))
    assert _both(pair, req)["q"] == [{"_uid_": "0x2"}]


def test_run_proto_nquad_mutation(pair):
    """Mutation NQuads as proto messages (graphresponse.proto:40): subject=1,
    predicate=2, object_value=4 {str_val=5}, lang=7, facets=8."""
    nq_name = (_str_field(1, "0x3") + _str_field(2, "name")
               + _len_field(4, _str_field(5, "Alan")))
    nq_edge = (_str_field(1, "0x1") + _str_field(2, "follows") + _str_field(3, "0x3")
               + _len_field(8, _str_field(1, "since") + _str_field(5, "2021")))
    _both(pair, _len_field(2, _len_field(1, nq_name) + _len_field(1, nq_edge)))
    got, want = pair.both_query(
        "{ q(func: uid(0x1)) { follows (orderasc: name) @facets(since) { name } } }"
    )
    assert _strip(got) == _strip(want)
    assert got["q"] == [{"follows": [
        {"name": "Alan", "@facets": {"_": {"since": 2021}}},
        {"name": "Grace", "@facets": {"_": {"since": 2020}}},
    ]}]


def test_run_typed_value_and_schema_update(pair):
    """SchemaUpdate (value_type enum == TypeID) + int_val typed literal."""
    su = (_str_field(1, "age") + _varint_field(2, 2) + _varint_field(3, 1)
          + _str_field(4, "int"))
    nq = (_str_field(1, "0x2") + _str_field(2, "age")
          + _len_field(4, _varint_field(3, 36)))  # Value{int_val=36}
    _both(pair, _len_field(2, _len_field(3, su) + _len_field(1, nq)))
    got, want = pair.both_query("{ q(func: ge(age, 30)) { name age } }")
    assert _strip(got) == _strip(want)
    assert got["q"] == [{"name": "Grace", "age": 36}]


def test_run_value_oneof_forms(pair):
    """NQuad object_value oneof coverage: uid_val makes an EDGE,
    double_val/bool_val convert under the schema, lang tags apply."""
    for s in (pair.port, pair.ref):
        s.run_query("mutation { schema { ratio: float . flag: bool . } }")
    dv = _key(6, 1) + struct.pack("<d", 2.75)  # Value{double_val=2.75}
    nqs = [
        _str_field(1, "0x61") + _str_field(2, "ratio") + _len_field(4, dv),
        _str_field(1, "0x61") + _str_field(2, "flag") + _len_field(4, _varint_field(4, 1)),
        _str_field(1, "0x61") + _str_field(2, "follows") + _len_field(4, _varint_field(11, 0x62)),
        (_str_field(1, "0x61") + _str_field(2, "name")
         + _len_field(4, _str_field(5, "Szia")) + _str_field(7, "hu")),
    ]
    _both(pair, _len_field(2, b"".join(_len_field(1, nq) for nq in nqs)))
    got, want = pair.both_query(
        "{ q(func: uid(0x61)) { ratio flag name@hu follows { _uid_ } } }"
    )
    assert _strip(got) == _strip(want)
    assert got["q"] == [{"ratio": 2.75, "flag": True, "name@hu": "Szia",
                         "follows": [{"_uid_": "0x62"}]}]


def test_run_del_nquad(pair):
    for s in (pair.port, pair.ref):
        s.run_query('mutation { set { <0x9> <name> "Tmp" . } }')
    nq = _str_field(1, "0x9") + _str_field(2, "name") + _len_field(4, _str_field(5, "Tmp"))
    _both(pair, _len_field(2, _len_field(2, nq)))  # Mutation{del=2}
    got, want = pair.both_query('{ q(func: eq(name, "Tmp")) { _uid_ } }')
    assert _strip(got) == _strip(want)
    assert got["q"] == []


def test_run_mutation_and_query_in_one_request(pair):
    """A Request with both a mutation and a query runs the mutation
    first, then the query on the mutated state (query/query.go:2371)."""
    nq = (_str_field(1, "0x71") + _str_field(2, "name")
          + _len_field(4, _str_field(5, "Combined")))
    req = (_str_field(1, '{ q(func: eq(name, "Combined")) { _uid_ } }')
           + _len_field(2, _len_field(1, nq)))
    assert _both(pair, req)["q"] == [{"_uid_": "0x71"}]


def test_schema_request(pair):
    # Request{schema=3 SchemaRequest{predicates=["name"]}}
    out = _both(pair, _len_field(3, _str_field(2, "name")))
    assert any(s.get("predicate") == "name" for s in out.get("schema", []))


def test_check_version(pair):
    tags = [tg.decode_version(ch.unary_unary("/protos.Dgraph/CheckVersion")(b"", timeout=T))
            for ch in (pair.cport, pair.cref)]
    assert tags[0] == tags[1] and tags[0].startswith("0.7")


def test_assign_uids(pair):
    got = [tg.decode_assigned_ids(
        ch.unary_unary("/protos.Dgraph/AssignUids")(tg.encode_num(5), timeout=T))
        for ch in (pair.cport, pair.cref)]
    for start, end in got:
        assert end - start == 4 and start > 0


def test_bad_query_is_invalid_argument(pair):
    req = _str_field(1, "{ q(func: nosuchfunc(x)) { name } }")
    assert _code(pair.cport, req) == _code(pair.cref, req) == grpc.StatusCode.INVALID_ARGUMENT


def test_grpc_transport_matches_http(pair):
    """GrpcTransport returns the same result dict as the HTTP JSON surface
    (and as the reference's GrpcTransport) for the same query."""
    t = GrpcTransport(f"127.0.0.1:{pair.gport.port}", timeout=T)
    jt = JaxGrpcTransport(f"127.0.0.1:{pair.gref.port}")
    try:
        q = "{ q(func: uid(0x1)) { name } }"
        got = t.run(q)
        assert got["q"] == HttpTransport(pair.port.addr).run(q)["q"] == jt.run(q)["q"]
        assert t.check_version() == jt.check_version()
        s, e = t.assign_uids(3)
        assert e - s == 2
    finally:
        t.close()
        jt.close()


def test_grpc_client_batching(pair):
    """DgraphClient over GrpcTransport: batched mutations flush through
    Run (client/mutations.go BatchSet analog); the reference's client
    over its transport lands the same data."""
    from dgraph_tpu.client import BatchMutationOptions as JOpts
    from dgraph_tpu.client import ClientEdge as JEdge
    from dgraph_tpu.client import DgraphClient as JClient

    t = GrpcTransport(f"127.0.0.1:{pair.gport.port}", timeout=T)
    jt = JaxGrpcTransport(f"127.0.0.1:{pair.gref.port}")
    try:
        c = DgraphClient(t, BatchMutationOptions(size=10, pending=2))
        jc = JClient(jt, JOpts(size=10, pending=2))
        for i in range(30, 40):
            c.batch_set(ClientEdge.value(f"0x{i:x}", "name", f"bulk {i}"))
            jc.batch_set(JEdge.value(f"0x{i:x}", "name", f"bulk {i}"))
        c.close()
        jc.close()
        q = '{ q(func: eq(name, "bulk 35")) { _uid_ } }'
        assert t.run(q)["q"] == jt.run(q)["q"] == [{"_uid_": "0x23"}]
    finally:
        t.close()
        jt.close()


@pytest.mark.parametrize("bad", [
    "{ q(func: uid(0x1)) { name }",           # unbalanced braces
    'mutation { set { <0x1> name "A" . } }',  # bad RDF predicate term
])
def test_parse_error_maps_to_invalid_argument(pair, bad):
    """gql/rdf ParseError subclass ValueError: INVALID_ARGUMENT on both,
    not INTERNAL."""
    req = _str_field(1, bad)
    assert _code(pair.cport, req) == _code(pair.cref, req) == grpc.StatusCode.INVALID_ARGUMENT


@pytest.mark.parametrize("method,req", [
    ("/protos.Dgraph/Run", b""),                       # empty request
    ("/protos.Dgraph/Run", b"\x0f"),                   # not a message
    ("/protos.Dgraph/AssignUids", b""),                # Num.val 0
    ("/protos.Worker/RaftMessage", b""),               # not clustered
    ("/protos.Dgraph/NoSuchMethod", b""),              # unknown method
])
def test_status_codes_match_reference(pair, method, req):
    assert _code(pair.cport, req, method) == _code(pair.cref, req, method)


# ---------------------------------------------------------- the request codec

REQUESTS = {
    "query": tg.encode_request("{ q(func: uid(0x1)) { name } }"),
    "vars": tg.encode_request("query t($a: int) { q(func: uid($a)) { name } }",
                              {"$a": "1"}),
    "rdf_text": tg.encode_request("{ q(func: uid(0x1)) { name } }",
                                  set_nquads='<0x1> <name> "x" .',
                                  del_nquads="<0x1> <e> <0x2> ."),
    "nquads": _len_field(2, b"".join(_len_field(1, nq) for nq in [
        _str_field(1, "_:a") + _str_field(2, "name") + _len_field(4, _str_field(1, 'say "hi"\n')),
        _str_field(1, "0x1") + _str_field(2, "when") + _len_field(4, _str_field(9, "2020-01-02T03:04:05Z")),
        _str_field(1, "0x1") + _str_field(2, "day") + _len_field(4, _str_field(8, "2020-01-02")),
        _str_field(1, "0x1") + _str_field(2, "pw") + _len_field(4, _str_field(10, "secret")),
        _str_field(1, "0x1") + _str_field(2, "loc") + _len_field(
            4, _str_field(7, '{"type":"Point","coordinates":[1,2]}')),
        _str_field(1, "0x1") + _str_field(2, "raw") + _len_field(4, _len_field(2, b"\xff\x00")),
        _str_field(1, "0x1") + _str_field(2, "neg") + _len_field(4, _varint_field(3, -5)),
        _str_field(1, "0x1") + _str_field(2, "*") + _str_field(3, "0x2"),
        _str_field(1, "0x1") + _str_field(2, "f") + _str_field(3, "0x2") + b"".join(
            _len_field(8, fc) for fc in [
                _str_field(1, "w") + _len_field(2, struct.pack("<q", 7)) + _varint_field(3, 1),
                _str_field(1, "d") + _len_field(2, struct.pack("<d", 0.5)) + _varint_field(3, 2),
                _str_field(1, "b") + _len_field(2, b"\x01") + _varint_field(3, 3),
                _str_field(1, "s") + _len_field(2, b"txt"),
                _str_field(1, "bare"),
            ]),
    ])),
    "schema_updates": _len_field(2, b"".join(_len_field(3, su) for su in [
        _str_field(1, "age") + _varint_field(2, 2) + _varint_field(3, 1) + _str_field(4, "int"),
        _str_field(1, "friend") + _varint_field(2, 7) + _varint_field(3, 2) + _varint_field(5, 1),
        _str_field(1, "odd") + _varint_field(2, 99),
        _str_field(1, "n") + _varint_field(2, 9) + _varint_field(3, 1),
    ])),
    "schema_request": _len_field(3, _str_field(2, "name") + _str_field(2, "age")
                                 + _str_field(3, "type") + _str_field(3, "index")),
    "empty": b"",
}


@pytest.mark.parametrize("name", sorted(REQUESTS))
def test_decode_request_matches_reference(name):
    b = REQUESTS[name]
    assert tg.decode_request(b) == jg.decode_request(b)


@pytest.mark.parametrize("args", [
    ("",), ("{ q() }",), ("{ q() }", {"$a": "b", "$c": ""}),
    ("{ q() }", None, "<0x1> <n> \"v\" ."), ("", None, "", "<0x1> <e> <0x2> ."),
])
def test_encode_request_and_small_messages_match_reference(args):
    assert tg.encode_request(*args) == jg.encode_request(*args)
    assert tg.encode_version() == jg.encode_version()
    assert tg.encode_assigned_ids(3, 9) == jg.encode_assigned_ids(3, 9)
    assert tg.decode_assigned_ids(jg.encode_assigned_ids(3, 9)) == (3, 9)
    assert tg.encode_num(12) == jg.encode_num(12)
    assert tg.decode_num(jg.encode_num(12)) == 12
    assert tg.encode_payload(b"x\x00") == jg.encode_payload(b"x\x00")
    framed = tg.frame_raft(300, b"frame")
    assert framed == jg.frame_raft(300, b"frame")
    assert tg.unframe_raft(framed) == jg.unframe_raft(framed) == (300, b"frame")


# --------------------------------------------------------------- protos.Worker


class _FakeCluster:
    """Captures deliver() calls; carries the PeerAuth-shaped secret."""

    class _Auth:
        def __init__(self, secret):
            self.secret = secret

    def __init__(self, secret=""):
        self.auth = self._Auth(secret)
        self.delivered = []
        self.node_id = "9"

    def deliver(self, group, frame):
        self.delivered.append((group, frame))

    def stop(self):
        pass


def _worker(pkg, secret="s3cret", **kw):
    """An unstarted HTTP server of ``pkg`` with a fake cluster, behind its
    own package's GrpcServer (started)."""
    if pkg == "port":
        srv, g = DgraphServer(PostingStore(), device="cpu", **kw), tg
    else:
        srv, g = JaxServer(JaxStore(), **kw), jg
    srv.cluster = _FakeCluster(secret=secret)
    gsrv = g.GrpcServer(srv, port=0)
    gsrv.start()
    return srv, gsrv


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.02)
    return True


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_worker_echo_and_raft_message(pkg):
    """The Worker plane (payload.proto:28): Echo round-trips, RaftMessage
    delivers (group, frame) to the cluster under the metadata secret; a
    wrong or missing secret is PERMISSION_DENIED on both packages."""
    srv, gsrv = _worker(pkg)
    try:
        with grpc.insecure_channel(f"127.0.0.1:{gsrv.port}") as ch:
            echo = ch.unary_unary("/protos.Worker/Echo")
            assert tg.decode_payload(echo(tg.encode_payload(b"ping"), timeout=T)) == b"ping"
            raft = ch.unary_unary("/protos.Worker/RaftMessage")
            frame = b"\x01binary-raft-frame"
            raft(tg.encode_payload(tg.frame_raft(3, frame)),
                 metadata=[(tg._SECRET_MD, "s3cret")], timeout=T)
            assert srv.cluster.delivered == [(3, frame)]
            with pytest.raises(grpc.RpcError) as ei:
                raft(tg.encode_payload(tg.frame_raft(3, frame)), timeout=T)
            assert ei.value.code() == grpc.StatusCode.PERMISSION_DENIED
            assert len(srv.cluster.delivered) == 1
    finally:
        gsrv.stop()


@pytest.mark.parametrize("sender,receiver", [
    ("port", "port"), ("port", "reference"), ("reference", "port"),
])
def test_grpc_raft_transport_end_to_end(sender, receiver):
    """GrpcRaftTransport ships a real encoded raft message through the
    Worker RPC; the far side decodes it identically — across packages
    too (the frames and the framing are the reference's)."""
    from dgraph_tpu.cluster import raft as jraft
    from dgraph_tpu.cluster import transport as jtransport
    from dgraph_tpu_torch.cluster import raft as traft
    from dgraph_tpu_torch.cluster import transport as ttransport

    tr, raft = (ttransport, traft) if sender == "port" else (jtransport, jraft)
    srv, gsrv = _worker(receiver)
    t = tr.GrpcRaftTransport({"2": f"127.0.0.1:{gsrv.port}"}, secret="s3cret",
                             port_offset=0)
    try:
        t.send("2", 0, raft.VoteReq(term=7, candidate="1", last_log_index=3,
                                    last_log_term=2))
        assert _wait(lambda: srv.cluster.delivered), "raft frame never arrived over gRPC"
        gid, frame = srv.cluster.delivered[0]
        assert gid == 0
        got = ttransport.decode_msg(frame)
        assert isinstance(got, traft.VoteReq) and got.term == 7
        assert jtransport.decode_msg(frame).term == 7
    finally:
        t.stop()
        gsrv.stop()


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_cluster_raft_over_grpc(tmp_path, monkeypatch):
    """Two port servers whose whole raft plane rides the gRPC Worker RPC
    (raft_transport='grpc'): election succeeds and a mutation written to
    one server replicates to the other (draft.go:1017's topology)."""
    from dgraph_tpu_torch.cluster.service import ClusterService

    monkeypatch.setenv("DGRAPH_TPU_PROPOSE_TIMEOUT", "45")
    ports = _free_ports(2)
    peers = {str(i + 1): f"http://127.0.0.1:{ports[i]}" for i in range(2)}
    servers, gsrvs = [], []
    try:
        for i in range(2):
            nid = str(i + 1)
            svc = ClusterService(
                node_id=nid, my_addr=peers[nid], peers=peers, group_ids=[0, 1],
                directory=str(tmp_path / f"n{nid}"), raft_transport="grpc",
                grpc_port_offset=1000, secret="rg-secret",
            )
            svc.start()
            srv = DgraphServer(svc.store, port=ports[i], device="cpu", cluster=svc)
            srv.start()
            servers.append(srv)
            g = tg.GrpcServer(srv, port=ports[i] + 1000)
            g.start()
            gsrvs.append(g)
        assert _wait(lambda: all(s.cluster.has_leader() for s in servers), 30), (
            "no leader over the gRPC raft plane")
        want = [{"name": "Replicated"}]

        def write():
            try:
                servers[0].run_query(
                    "mutation { schema { name: string @index(exact) . } "
                    'set { <0x1> <name> "Replicated" . } }')
                return True
            except (OSError, RuntimeError, ValueError):
                return False  # a leader change mid-proposal: retry

        assert _wait(write, 60)
        assert _wait(lambda: servers[1].run_query(
            '{ q(func: eq(name, "Replicated")) { name } }').get("q") == want, 30)
    finally:
        for g in gsrvs:
            g.stop()
        for s in servers:
            s.stop()


def test_grpc_raft_transport_guards():
    """Address hygiene, on both packages alike: targets derive from url
    and bare forms, unmappable addresses raise, and https peers demand a
    pinned CA."""
    from dgraph_tpu.cluster import transport as jtr
    from dgraph_tpu_torch.cluster import transport as ttr

    for tr in (ttr, jtr):
        assert tr.grpc_target_of("http://10.0.0.5:7080", 1000) == "10.0.0.5:8080"
        assert tr.grpc_target_of("10.0.0.5:7080", 1000) == "10.0.0.5:8080"
        assert tr.grpc_target_of("https://h:1", 7) == "h:8"
        with pytest.raises(ValueError):
            tr.grpc_target_of("http://hostonly", 1000)  # no port: unmappable
        with pytest.raises(ValueError, match="pinned CA"):
            tr.GrpcRaftTransport({"2": "https://h:7080"})
        t = tr.GrpcRaftTransport({"2": "https://h:7080"},
                                 auth=tr.PeerAuth(cafile="/nonexistent/ca.pem"))
        with pytest.raises(ValueError, match="pinned CA"):
            tr.GrpcRaftTransport({}).update_peer("3", "https://h2:7080")
        t.update_peer("3", "http://h2:7080")
        assert t.addr_of["3"] == "http://h2:7080"
        t.stop()


def test_cli_grpc_raft_requires_listener(tmp_path, capsys):
    """--raft_transport grpc with the gRPC listener off (or no explicit
    --port) fails fast with exit 2 on both packages' CLIs."""
    from dgraph_tpu.cli.server import main as jmain
    from dgraph_tpu_torch.cli.server import main

    for argv in (["--port", "0"], ["--port", "18123", "--grpc_port", "-1"]):
        for m in (main, jmain):
            rc = m(["--p", str(tmp_path / "p"), *argv, "--raft_transport", "grpc"])
            assert rc == 2
            assert "grpc" in capsys.readouterr().err


def test_grpc_update_peer_evicts_stale_channel(pair):
    """Re-addressing a member closes the superseded channel (no HTTP/2
    connection leaked per membership churn)."""
    from dgraph_tpu_torch.cluster.transport import GrpcRaftTransport

    t = GrpcRaftTransport({"2": f"127.0.0.1:{pair.gport.port}"}, port_offset=0)
    try:
        t._channel_for(t.addr_of["2"])
        assert len(t._chans) == 1
        t.update_peer("2", "127.0.0.1:1")
        assert len(t._chans) == 0
    finally:
        t.stop()


@pytest.mark.parametrize("sender", ["port", "reference"])
def test_grpc_tls_listener_serves_secure_channel(tmp_path, sender):
    """A port server with tls_cert serves gRPC over TLS too: a CA-pinned
    secure channel round-trips, a raft frame from either package's
    transport crosses the pinned-CA path, and a plaintext channel into
    the TLS listener fails."""
    from dgraph_tpu.cluster import raft as jraft
    from dgraph_tpu.cluster import transport as jtr
    from dgraph_tpu_torch.cluster import raft as traft
    from dgraph_tpu_torch.cluster import transport as ttr

    cert, key = make_cert(tmp_path)
    srv, g = _worker("port", secret="", tls_cert=cert, tls_key=key)
    try:
        with open(cert, "rb") as f:
            creds = grpc.ssl_channel_credentials(f.read())
        with grpc.secure_channel(f"localhost:{g.port}", creds) as ch:
            echo = ch.unary_unary("/protos.Worker/Echo")
            assert tg.decode_payload(echo(tg.encode_payload(b"tls"), timeout=T)) == b"tls"
        with grpc.insecure_channel(f"127.0.0.1:{g.port}") as ch:
            with pytest.raises(grpc.RpcError) as ei:
                ch.unary_unary("/protos.Worker/Echo")(b"", timeout=5)
            assert ei.value.code() == grpc.StatusCode.UNAVAILABLE
        tr, raft = (ttr, traft) if sender == "port" else (jtr, jraft)
        t = tr.GrpcRaftTransport({"9": f"https://localhost:{g.port}"}, port_offset=0,
                                 auth=tr.PeerAuth(cafile=cert))
        try:
            t.send("9", 1, raft.VoteReq(term=3, candidate="x", last_log_index=1,
                                        last_log_term=1))
            assert _wait(lambda: srv.cluster.delivered), "no frame over the TLS raft channel"
            gid, frame = srv.cluster.delivered[0]
            assert gid == 1 and ttr.decode_msg(frame).term == 3
        finally:
            t.stop()
    finally:
        g.stop()


def test_loader_over_grpc(pair, tmp_path):
    """The bulk loader connects over gRPC (--grpc): schema + quads land on
    the port as the reference's loader lands them on the reference, and
    checkpoint resume loads nothing twice."""
    from dgraph_tpu.cli.loader import main as jloader
    from dgraph_tpu_torch.cli.loader import main as loader

    rdf = tmp_path / "fix.rdf"
    rdf.write_text('<0x51> <name> "Loaded One" .\n<0x52> <name> "Loaded Two" .\n'
                   "<0x51> <follows> <0x52> .\n")
    for fn, g, ck in ((loader, pair.gport, "ck"), (jloader, pair.gref, "jck")):
        args = ["--rdf", str(rdf), "-d", f"127.0.0.1:{g.port}", "--grpc",
                "--cd", str(tmp_path / ck)]
        assert fn(args) == 0
        assert fn(args) == 0  # resume: idempotent
    got, want = pair.both_query('{ q(func: eq(name, "Loaded One")) { follows { name } } }')
    assert _strip(got) == _strip(want)
    assert got["q"] == [{"follows": [{"name": "Loaded Two"}]}]


def test_channel_pool_refcount_and_probe(pair):
    pool = tg.ChannelPool()
    target = f"127.0.0.1:{pair.gport.port}"
    a = pool.get(target)
    b = pool.get(target)
    assert a is b  # shared by refcount
    assert pool.probe(target)
    assert pool.probe(f"127.0.0.1:{pair.gref.port}")  # the reference answers too
    pool.release(target)
    assert (target, "") in pool._chans  # still referenced once
    pool.release(target)
    assert (target, "") not in pool._chans  # last release closes
    assert not pool.probe("127.0.0.1:1", timeout=2.0)  # dead target


def test_channel_pool_tls_entries_never_alias_plaintext(tmp_path):
    """A cafile'd (TLS) channel and a plaintext channel to the same
    host:port are distinct pool entries with independent refcounts."""
    cert, _key = make_cert(tmp_path)
    pool = tg.ChannelPool()
    plain = pool.get("127.0.0.1:1")
    tls = pool.get("127.0.0.1:1", cafile=cert)
    assert plain is not tls
    assert ("127.0.0.1:1", "") in pool._chans
    assert ("127.0.0.1:1", cert) in pool._chans
    pool.release("127.0.0.1:1")
    assert ("127.0.0.1:1", "") not in pool._chans
    assert ("127.0.0.1:1", cert) in pool._chans  # untouched
    pool.release("127.0.0.1:1", cafile=cert)
    assert not pool._chans


@pytest.mark.parametrize("cls", [GrpcTransport, JaxGrpcTransport],
                         ids=["port", "reference"])
def test_grpc_transport_https_requires_cafile(cls):
    """An https-derived target without a pinned CA fails at construction
    (dialing plaintext into a --tls_cert server fails every RPC)."""
    with pytest.raises(ValueError, match="cafile"):
        cls("https://127.0.0.1:8080")


def test_grpc_transport_maps_http_scheme_target(pair):
    """http://host:port transports map to the +1000 gRPC convention."""
    t = GrpcTransport(f"http://127.0.0.1:{pair.gport.port - 1000}", timeout=T)
    try:
        assert t.target == f"127.0.0.1:{pair.gport.port}"
        assert t.check_version().startswith("0.7")
    finally:
        t.close()


# ----------------------------------------------------------- faults as codes


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_storage_readonly_maps_to_unavailable(tmp_path, monkeypatch, pkg):
    """Disk-fault read-only mode on the gRPC surface: a mutation gets
    UNAVAILABLE (the HTTP 503 twin) while reads keep answering, uid
    leasing is shed at admission, and leases flow again once the probe
    re-arms — the same codes on both packages."""
    if pkg == "port":
        from dgraph_tpu_torch.models.wal import DurableStore
        from dgraph_tpu_torch.utils.failpoints import fail

        store = DurableStore(str(tmp_path / "p"))
        srv, g = DgraphServer(store, device="cpu"), tg
    else:
        from dgraph_tpu.models.wal import DurableStore
        from dgraph_tpu.utils.failpoints import fail

        store = DurableStore(str(tmp_path / "p"))
        srv, g = JaxServer(store), jg
    monkeypatch.setenv("DGRAPH_TPU_STORAGE_PROBE_S", "30")
    srv.start()
    gsrv = g.GrpcServer(srv, port=0)
    gsrv.start()
    try:
        with grpc.insecure_channel(f"127.0.0.1:{gsrv.port}") as ch:
            _run(ch, _str_field(1, 'mutation { schema { name: string . } '
                                   'set { <0x1> <name> "A" . } }'))
            fail.arm("wal.append", "error(n=100)")
            assert _code(ch, _str_field(1, 'mutation { set { <0x2> <name> "B" . } }')) \
                == grpc.StatusCode.UNAVAILABLE
            assert _run(ch, _str_field(1, "{ q(func: uid(0x1)) { name } }"))["q"] == [
                {"name": "A"}]
            assert _code(ch, tg.encode_num(4), "/protos.Dgraph/AssignUids") \
                == grpc.StatusCode.UNAVAILABLE
            fail.disarm("wal.append")
            assert store.health.probe_now()
            got = tg.decode_assigned_ids(
                ch.unary_unary("/protos.Dgraph/AssignUids")(tg.encode_num(4), timeout=T))
            assert got[1] - got[0] == 3
    finally:
        fail.reset()
        gsrv.stop()
        srv.stop()


def test_device_fault_is_unavailable_not_served_from_the_host(monkeypatch):
    """The port-only divergence: a device fault at ``device.hop`` aborts
    Run with UNAVAILABLE (the HTTP surface's 503) and nothing answers in
    its place; the reference, under the same failpoint, fails over to
    the host and answers the body.  The next request, fault gone,
    answers the same body on both."""
    from dgraph_tpu.utils.failpoints import fail as jfail
    from dgraph_tpu_torch.utils.failpoints import fail as tfail

    monkeypatch.setenv("DGRAPH_TPU_RESIDENT", "force")
    monkeypatch.setenv("DGRAPH_TPU_CACHE", "0")
    p = _Pair()
    try:
        for s in (p.port, p.ref):
            s.run_query(SEED)
            s.engine.expand_device_min = 1
        req = _str_field(1, "{ q(func: uid(0x1, 0x2)) { name follows { name } } }")
        base = _both(p, req)
        tfail.arm("device.hop", "error(n=1)")
        jfail.arm("device.hop", "error(n=1)")
        with pytest.raises(grpc.RpcError) as ei:
            _run(p.cport, req)
        assert ei.value.code() == grpc.StatusCode.UNAVAILABLE
        assert tfail.hits("device.hop") == 1
        assert _strip(_run(p.cref, req)) == base  # the reference's host failover
        assert jfail.hits("device.hop") == 1
        assert _both(p, req) == base
    finally:
        tfail.reset()
        jfail.reset()
        p.close()


def test_metrics_count_runs_and_raft_frames(pair):
    from dgraph_tpu_torch.utils.metrics import NUM_GRPC_RAFT, NUM_GRPC_RUNS, metrics

    r0, f0 = NUM_GRPC_RUNS.value(), NUM_GRPC_RAFT.value()
    _run(pair.cport, _str_field(1, "{ q(func: uid(0x1)) { name } }"))
    assert NUM_GRPC_RUNS.value() == r0 + 1
    srv, gsrv = _worker("port", secret="")
    try:
        with grpc.insecure_channel(f"127.0.0.1:{gsrv.port}") as ch:
            ch.unary_unary("/protos.Worker/RaftMessage")(
                tg.encode_payload(tg.frame_raft(1, b"f")), timeout=T)
    finally:
        gsrv.stop()
    assert NUM_GRPC_RAFT.value() == f0 + 1
    text = metrics.prometheus_text()
    assert "dgraph_grpc_runs_total" in text and "dgraph_grpc_raft_frames_total" in text


def test_package_imports_without_grpcio():
    """grpc is imported lazily: the gRPC modules, the client, the
    transports and the CLI import where grpcio is absent."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        f"sys.path.insert(0, {str(root)!r})\n"
        "sys.modules['grpc'] = None\n"
        "import dgraph_tpu_torch.serve.grpc_server, dgraph_tpu_torch.client\n"
        "import dgraph_tpu_torch.cluster.service, dgraph_tpu_torch.cli.server\n"
        "import dgraph_tpu_torch.cli.loader\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stdout + r.stderr


def test_large_raft_frame_crosses_the_worker_plane():
    """The port-only message limit: a 6 MB raft frame (a bulk load's
    entry of some 390,000 edges) crosses the port's Worker plane, where
    the reference's listener, at grpcio's 4 MB default, answers
    RESOURCE_EXHAUSTED; a Run response above 4 MB reaches a port
    client."""
    frame = b"\x07" * (6 << 20)
    payload = tg.encode_payload(tg.frame_raft(1, frame))
    codes = {}
    for pkg in ("port", "reference"):
        srv, gsrv = _worker(pkg, secret="")
        try:
            with grpc.insecure_channel(f"127.0.0.1:{gsrv.port}",
                                       options=tg.MESSAGE_OPTIONS) as ch:
                codes[pkg] = _code(ch, payload, "/protos.Worker/RaftMessage")
            if pkg == "port":
                assert srv.cluster.delivered == [(1, frame)]
        finally:
            gsrv.stop()
    assert codes == {"port": grpc.StatusCode.OK,
                     "reference": grpc.StatusCode.RESOURCE_EXHAUSTED}
    srv = DgraphServer(PostingStore(), device="cpu")
    srv.start()
    g = tg.GrpcServer(srv, port=0)
    g.start()
    t = GrpcTransport(f"127.0.0.1:{g.port}", timeout=120)
    try:
        big = "x" * (5 << 20)
        srv.run_query('mutation { set { <0x1> <blob> "%s" . } }' % big)
        assert t.run("{ q(func: uid(0x1)) { blob } }")["q"] == [{"blob": big}]
    finally:
        t.close()
        g.stop()
        srv.stop()
