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

pytestmark = [pytest.mark.compile_budget(400), pytest.mark.pallas_interpret]

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
