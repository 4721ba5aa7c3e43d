"""The port's HTTP surface against the reference's: the same mutations
and queries POSTed to both servers give byte-identical bodies (timing
map stripped), and the port's default device refuses to start on a host
without a GPU.

Both servers run with the resident route forced and every expansion on
the device route (``DGRAPH_TPU_EXPAND_DEVICE_MIN=1``); the reference
additionally runs without its scheduler, caches and QoS, which the port
does not have yet."""

import json
import urllib.error
import urllib.request

import pytest
import torch

from dgraph_tpu.models import PostingStore as JaxStore
from dgraph_tpu.serve.server import DgraphServer as JaxServer
from dgraph_tpu_torch.models import PostingStore
from dgraph_tpu_torch.serve.server import DgraphServer

from tests import test_goldens
from tests.torch_parity import REFERENCE_ENV
from torch_pins import pinned_planner  # noqa: F401

pytestmark = [
    pytest.mark.compile_budget(400),
    pytest.mark.pallas_interpret,
    pytest.mark.usefixtures("pinned_planner"),
]

REQUESTS = [
    "mutation { schema { %s } set { %s } }" % (test_goldens.SCHEMA, test_goldens.RDF),
    "{ me(func: uid(0x1, 0x2, 0x3, 0x4)) { uid name friend { uid name friend { uid name } } } }",
    '{ me(func: anyofterms(name, "Ann Ben")) { name@ru age cares_for @facets { name } } }',
    "{ me(func: has(age), orderdesc: age, first: 5) { name age count(friend) } }",
    "{ var(func: uid(0x1)) { friend { f as friend } } me(func: uid(f)) { uid name } }",
    '{ me(func: uid(0x1)) { name pwd: checkpwd(pwd, "x") ~friend { name } } }',
    "mutation { set { <0x2> <friend> <0x4> . <0x4> <friend> <0x3> . } delete { <0x1> <friend> <0x3> . } }",
    "{ me(func: uid(0x1, 0x2, 0x3, 0x4)) { uid friend { uid friend { uid } } } }",
    "{ me(func: uid(0x1)) { name",  # parse error: both answer 400
]


def _post(addr, text):
    req = urllib.request.Request(addr + "/query", data=text.encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _strip(raw: bytes) -> bytes:
    d = json.loads(raw)
    d.pop("server_latency", None)
    return json.dumps(d).encode()


def _drive(srv):
    srv.start()
    try:
        return [_post(srv.addr, t) for t in REQUESTS]
    finally:
        srv.stop()


def test_http_bodies_byte_identical(monkeypatch):
    for k, v in REFERENCE_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DGRAPH_TPU_EXPAND_DEVICE_MIN", "1")
    want = _drive(JaxServer(JaxStore()))
    port = DgraphServer(PostingStore(), device="cpu")
    got = _drive(port)
    for text, (wc, wb), (gc, gb) in zip(REQUESTS, want, got):
        assert gc == wc, (text, gb)
        assert _strip(gb) == _strip(wb), text
    assert json.loads(got[1][1])["me"], "the 2-hop query found nothing"
    routes = port.engine.stats["routes"]
    assert routes.get("resident", 0) >= 2, routes


def test_health_and_shutdown():
    srv = DgraphServer(PostingStore(), device="cpu")
    srv.start()
    with urllib.request.urlopen(srv.addr + "/health", timeout=30) as r:
        assert r.status == 200 and r.read() == b"OK"
    with urllib.request.urlopen(srv.addr + "/admin/shutdown", timeout=30) as r:
        assert json.loads(r.read())["code"] == "Success"
    srv.wait()
    assert not srv.healthy()


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    from dgraph_tpu_torch.cli import server as cli
    from dgraph_tpu_torch.query import QueryEngine

    with pytest.raises(RuntimeError, match="cuda"):
        DgraphServer(PostingStore())
    with pytest.raises(RuntimeError, match="cuda"):
        QueryEngine(PostingStore())
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--port", "0"])


def _https_post(addr, text, ctx):
    req = urllib.request.Request(addr + "/query", data=text.encode(), method="POST")
    with urllib.request.urlopen(req, context=ctx, timeout=60) as r:
        return r.status, r.read()


def test_tls_serving(tmp_path):
    """HTTPS termination (upstream x/tls_helper.go): a port server given
    ``tls_cert``/``tls_key`` serves ``https://``, TLS 1.2 and up, and
    answers the requests of the byte-identity case with the reference
    TLS server's bodies; a TLS 1.1 client is refused."""
    import ssl

    from torch_tls import make_cert

    cert, key = make_cert(tmp_path)
    ctx = ssl.create_default_context(cafile=cert)
    port = DgraphServer(PostingStore(), device="cpu", tls_cert=cert, tls_key=key)
    ref = JaxServer(JaxStore(), tls_cert=cert, tls_key=key)
    for s in (port, ref):
        s.start()
    try:
        assert port.addr.startswith("https://") and ref.addr.startswith("https://")
        for text in REQUESTS[:-1]:
            gc, gb = _https_post(port.addr, text, ctx)
            wc, wb = _https_post(ref.addr, text, ctx)
            assert gc == wc == 200
            assert _strip(gb) == _strip(wb), text
        old = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        old.load_verify_locations(cert)
        try:
            old.minimum_version = old.maximum_version = ssl.TLSVersion.TLSv1_1
        except (ValueError, ssl.SSLError):
            return  # this OpenSSL cannot even offer TLS 1.1
        with pytest.raises((ssl.SSLError, OSError)):
            _https_post(port.addr, REQUESTS[1], old)
    finally:
        for s in (port, ref):
            s.stop()


def test_tls_handshake_is_deferred_off_the_accept_loop(tmp_path):
    """A client that connects and never starts its TLS handshake holds
    only its own connection's thread: another client is served at once."""
    import socket
    import ssl
    import time

    from torch_tls import make_cert

    cert, key = make_cert(tmp_path)
    srv = DgraphServer(PostingStore(), device="cpu", tls_cert=cert, tls_key=key)
    srv.start()
    stalled = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
    try:
        t0 = time.monotonic()
        ctx = ssl.create_default_context(cafile=cert)
        with urllib.request.urlopen(srv.addr + "/health", context=ctx, timeout=10) as r:
            assert r.read() == b"OK"
        assert time.monotonic() - t0 < 5
    finally:
        stalled.close()
        srv.stop()


def test_protobuf_response_equals_reference_encoder():
    """A port server's protobuf body is the reference's ``encode_response``
    of the port's own JSON tree, byte for byte (the latency field aside),
    for every read of the byte-identity case."""
    from dgraph_tpu.serve import proto as jproto
    from dgraph_tpu_torch.serve import proto

    srv = DgraphServer(PostingStore(), device="cpu")
    srv.start()
    try:
        _post(srv.addr, REQUESTS[0])
        for text in REQUESTS[1:6] + REQUESTS[7:8]:
            req = urllib.request.Request(
                srv.addr + "/query", data=text.encode(), method="POST",
                headers={"Accept": "application/protobuf"})
            with urllib.request.urlopen(req, timeout=60) as r:
                assert r.headers["Content-Type"] == "application/protobuf"
                raw = r.read()
            tree = json.loads(_strip(_post(srv.addr, text)[1]))
            want = [f for f in jproto.iter_fields(jproto.encode_response(tree))]
            assert [f for f in proto.iter_fields(raw) if f[0] != 2] == want, text
    finally:
        srv.stop()
