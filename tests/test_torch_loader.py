"""The port's client SDK, bulk loader, RDF export and durable CLI server.

The cases of tests/test_client.py, run on the port
(``dgraph_tpu_torch.client``, ``cli/loader.py``) over a ``device="cpu"``
server; the binary-protobuf transport is held to the reference's, and
the loader's ``--grpc`` loads over the port's gRPC listener.  Then against the reference, tolerance 0:
``iter_rdf_lines`` and ``export`` give the same lines and files in both
packages.  Then the binaries end to end, as subprocesses on the CPU:
the loader fills a ``--sync`` server, a SIGKILL loses no acknowledged
write, and a disk fault at boot makes the server shed mutations with
503 + Retry-After while reads keep answering, until the re-arm probe
clears it.
"""

import dataclasses
import gzip
import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from pathlib import Path
from typing import List

import pytest

from dgraph_tpu.models import PostingStore as JaxStore
from dgraph_tpu.query import QueryEngine as JaxEngine
from dgraph_tpu.serve import export as jexport
from dgraph_tpu_torch.cli import loader as loader_cli
from dgraph_tpu_torch.cli.loader import load_file
from dgraph_tpu_torch.client import (
    BatchMutationOptions,
    ClientEdge,
    DgraphClient,
    EmbeddedTransport,
    HttpTransport,
    SyncMarks,
    unmarshal,
)
from dgraph_tpu_torch.models import PostingStore
from dgraph_tpu_torch.query import QueryEngine
from dgraph_tpu_torch.serve import export as texport
from dgraph_tpu_torch.serve.server import DgraphServer

from tests import test_film, test_goldens
from tests.test_torch_native import CORPUS
from torch_pins import pinned_planner  # noqa: F401

# every route decision of both planners is pinned (tests/torch_pins.py)
pytestmark = pytest.mark.usefixtures("pinned_planner")

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def srv():
    server = DgraphServer(PostingStore(), device="cpu")
    server.start()
    yield server
    server.stop()


# -- the reference's cases (tests/test_client.py) on the port -----------------


def test_batching_client_embedded(srv):
    c = DgraphClient(EmbeddedTransport(srv), BatchMutationOptions(size=10, pending=3))
    c.add_schema("name: string @index(term) .")
    for i in range(95):
        c.batch_set(ClientEdge.value(f"0x{i + 1:x}", "name", f"person {i}"))
        c.batch_set(ClientEdge.value(f"0x{i + 1:x}", "rank", i))
    c.batch_set(ClientEdge.connect("0x1", "knows", "0x2"))
    c.flush()
    out = c.query('{ q(func: uid(0x5)) { name rank } }')
    assert out["q"] == [{"name": "person 4", "rank": 4}]
    assert c.mutation_count() >= 95 * 2 // 10  # batched, not per-quad
    c.close()


def test_batching_client_http(srv):
    c = DgraphClient(HttpTransport(srv.addr), BatchMutationOptions(size=5, pending=2))
    for i in range(12):
        c.batch_set(ClientEdge.value(f"_:n{i}", "score", float(i) / 2))
    c.flush()
    out = c.query("{ q(func: has(score)) { score } }")
    assert len(out["q"]) == 12
    c.close()


def test_batch_delete(srv):
    c = DgraphClient(EmbeddedTransport(srv), BatchMutationOptions(size=4, pending=2))
    c.batch_set(ClientEdge.value("0x1", "name", "temp"))
    c.flush()
    c.batch_delete(ClientEdge.value("0x1", "name", "temp"))
    c.flush()
    out = c.query("{ q(func: has(name)) { name } }")
    assert out.get("q", []) == []
    c.close()


def test_unmarshal_nested():
    @dataclass
    class Friend:
        name: str = ""
        age: int = 0

    @dataclass
    class Person:
        name: str = ""
        age: int = 0
        alive: bool = False
        friend: List[Friend] = field(default_factory=list)

    node = {
        "name": "Noor Haddad",
        "age": 44,
        "alive": "true",
        "friend": [{"name": "Silas", "age": 51}, {"name": "Imre"}],
    }
    p = unmarshal(node, Person)
    assert p.name == "Noor Haddad" and p.age == 44 and p.alive is True
    assert [f.name for f in p.friend] == ["Silas", "Imre"]
    assert p.friend[0].age == 51


def test_unmarshal_field_override():
    @dataclass
    class Row:
        display: str = dataclasses.field(default="", metadata={"dgraph": "name"})

    assert unmarshal({"name": "x"}, Row).display == "x"


def _write_rdf_gz(path, n):
    with gzip.open(path, "wt") as f:
        for i in range(n):
            f.write(f'_:p{i} <name> "bulk {i}" .\n')


def test_loader_gzip_and_checkpoint(srv, tmp_path):
    rdf = tmp_path / "data.rdf.gz"
    _write_rdf_gz(rdf, 57)
    marks = SyncMarks(str(tmp_path / "cd"))
    c = DgraphClient(HttpTransport(srv.addr), BatchMutationOptions(size=10, pending=2))
    n = load_file(c, str(rdf), marks, batch=10)
    c.close()
    assert n == 57
    out = DgraphClient(EmbeddedTransport(srv)).query("{ q(func: has(name)) { name } }")
    assert len(out["q"]) == 57
    # resume: a fresh SyncMarks over the same dir skips everything
    marks2 = SyncMarks(str(tmp_path / "cd"))
    c2 = DgraphClient(HttpTransport(srv.addr), BatchMutationOptions(size=10, pending=2))
    n2 = load_file(c2, str(rdf), marks2, batch=10)
    c2.close()
    assert n2 == 0


def test_checkpoint_partial_resume(tmp_path):
    marks = SyncMarks(str(tmp_path))
    marks.begin("f.rdf", 100)
    marks.done("f.rdf", 100)
    marks.begin("f.rdf", 250)  # in flight, never done
    # new process: only the contiguous prefix survives
    marks2 = SyncMarks(str(tmp_path))
    assert marks2.done_until("f.rdf") == 100


def test_set_then_delete_ordering(srv):
    """A delete enqueued after a set of the same quad must win even with
    multiple pending workers (cross-op barrier)."""
    c = DgraphClient(EmbeddedTransport(srv), BatchMutationOptions(size=4, pending=3))
    e = ClientEdge.value("0x200", "tag", "x")
    for _ in range(8):
        c.batch_set(e)
        c.batch_delete(e)
    c.flush()
    out = c.query("{ q(func: uid(0x200)) { tag } }")
    assert out.get("q", []) == []
    # and delete-then-set leaves it present
    c.batch_delete(e)
    c.batch_set(e)
    c.flush()
    out = c.query("{ q(func: uid(0x200)) { tag } }")
    assert out["q"] == [{"tag": "x"}]
    c.close()


def test_server_stop_idempotent(srv):
    srv.stop()
    srv.stop()  # second call must be a no-op, not a double-close


# -- export against the reference ------------------------------------------------

FIXTURES = {
    "goldens": "mutation { schema { %s } set { %s } }" % (test_goldens.SCHEMA, test_goldens.RDF),
    "film": "mutation { schema { %s } set { %s } }" % (test_film.SCHEMA, test_film.RDF),
    "native_corpus": "mutation { schema { name: string @index(term) . } set { %s } }" % CORPUS,
}


def _reference_scanner_ready() -> None:
    """Load the reference's native scanner before its bulk path runs.
    Both packages take their scanner when it is built and their Python
    parser otherwise, and the two routes number blank nodes in different
    orders.  The reference builds its scanner without a lock, so in a
    fresh checkout a worker whose first build races another worker's
    caches "no scanner" for its whole process, and its stores then
    differ from the port's (which builds under a file lock).  Build it
    again until it loads, so both packages take the native route."""
    if os.environ.get("DGRAPH_TPU_NO_NATIVE"):
        return
    from dgraph_tpu import native as jnative

    for _ in range(5):
        if jnative._lib is not None:
            return
        jnative._tried = False
        if jnative.scanner() is not None:
            return
        time.sleep(0.5)
    raise RuntimeError("the reference's native scanner did not build")


def _stores(name):
    _reference_scanner_ready()
    jeng = JaxEngine(JaxStore())
    teng = QueryEngine(PostingStore(), device="cpu")
    for eng in (jeng, teng):
        eng.run(FIXTURES[name])
    return jeng.store, teng.store


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_iter_rdf_lines_match_reference(name):
    jst, tst = _stores(name)
    want = list(jexport.iter_rdf_lines(jst))
    assert len(want) > 10
    assert list(texport.iter_rdf_lines(tst)) == want


def test_export_files_match_reference(tmp_path):
    jst, tst = _stores("goldens")
    want = jexport.export(jst, str(tmp_path / "jax"))
    got = texport.export(tst, str(tmp_path / "torch"))
    assert got["nquads"] == want["nquads"] > 0
    for k in ("rdf", "schema"):  # names carry the minute: not compared
        with gzip.open(got[k], "rb") as g, gzip.open(want[k], "rb") as w:
            assert g.read() == w.read()


# -- the binaries, end to end ----------------------------------------------------


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _boot(p_dir, *flags, env=None):
    """Start the CLI server on the CPU; returns (process, address, the
    lines it printed before serving)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "dgraph_tpu_torch.cli.server", "--p", str(p_dir),
         "--port", "0", "--device", "cpu", *flags],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=env or _env(),
    )
    lines = []
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line.strip())
        if line.startswith("serving on "):
            return proc, line.split()[2], lines
    proc.kill()
    proc.wait(timeout=30)
    raise AssertionError(f"server did not start: {lines}")


def _post(addr, text):
    req = urllib.request.Request(addr + "/query", data=text.encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(addr, path):
    with urllib.request.urlopen(addr + path, timeout=60) as r:
        return r.read().decode()


def _strip(out):
    out.pop("server_latency", None)
    return out


Q = ('{ q(func: uid(0x1, 0x2, 0x3)) { uid f { uid f { uid } } } '
     'n(func: allofterms(name, "w1 bravo")) { count() } }')


def test_loader_then_sigkill_loses_no_acknowledged_write(tmp_path):
    rdf = tmp_path / "d.rdf.gz"
    with gzip.open(rdf, "wt") as f:
        for i in range(1, 601):
            f.write(f"<0x{i:x}> <f> <0x{(i * 7) % 600 + 1:x}> .\n")
            f.write(f'<0x{i:x}> <name> "alpha w{i % 5} bravo" .\n')
    schema = tmp_path / "schema.txt"
    schema.write_text("name: string @index(term) .\nf: uid .\n")
    proc, addr, lines = _boot(tmp_path / "p", "--sync", "--snapshot_wal_records", "4")
    try:
        assert lines[0].startswith("recovered ") and "records=0" in lines[0]
        r = subprocess.run(
            [sys.executable, "-m", "dgraph_tpu_torch.cli.loader", "-r", str(rdf),
             "-s", str(schema), "-d", addr, "--batch", "100", "-c", "3",
             "--cd", str(tmp_path / "cd")],
            capture_output=True, text=True, timeout=300, env=_env(),
        )
        assert r.returncode == 0, r.stderr
        assert "loaded 1200 quads" in r.stdout
        status, ack, _ = _post(addr, 'mutation { set { <0x1> <f> <0x300> . } }')
        assert status == 200 and ack["code"] == "Success"
        status, want, _ = _post(addr, Q)
        assert status == 200 and want["n"] == [{"count": 120}]
        assert "0x300" in json.dumps(want)
        metrics = _get(addr, "/metrics")
        assert [ln for ln in metrics.splitlines()
                if ln.startswith("dgraph_bulk_set_quads_total{")] == [
            'dgraph_bulk_set_quads_total{route="native"} 1201']
        deadline = time.monotonic() + 30
        while "dgraph_snapshots_total 0" in metrics and time.monotonic() < deadline:
            time.sleep(0.2)
            metrics = _get(addr, "/metrics")
        assert "dgraph_snapshots_total 0" not in metrics
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    proc, addr, lines = _boot(tmp_path / "p")
    try:
        assert lines[0].startswith("recovered ") and "records=0" not in lines[0]
        status, got, _ = _post(addr, Q)
        assert status == 200 and _strip(got) == _strip(want)
        detail = json.loads(_get(addr, "/health?detail=1"))
        assert detail["storage"]["last_recovery"]["snapshot_records"] > 0
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0


def test_readonly_server_sheds_writes_and_serves_reads(tmp_path):
    d = tmp_path / "p"
    proc, addr, _ = _boot(d)
    try:
        assert _post(addr, 'mutation { set { <0x1> <name> "a" . } }')[0] == 200
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    env = _env(DGRAPH_TPU_FAILPOINTS="wal.append=error(n=1)",
               DGRAPH_TPU_STORAGE_PROBE_S="0.5")
    proc, addr, _ = _boot(d, env=env)
    try:
        status, out, headers = _post(addr, 'mutation { set { <0x2> <name> "b" . } }')
        assert status == 503 and out["code"] == "ErrorServiceUnavailable"
        assert int(headers["Retry-After"]) >= 1
        status, out, _ = _post(addr, "{ q(func: has(name)) { uid name } }")
        assert status == 200 and out["q"] == [{"_uid_": "0x1", "name": "a"}]
        deadline = time.monotonic() + 30
        while json.loads(_get(addr, "/health?detail=1"))["storage"]["readonly"]:
            assert time.monotonic() < deadline, "the re-arm probe never cleared"
            time.sleep(0.1)
        assert _post(addr, 'mutation { set { <0x3> <name> "c" . } }')[0] == 200
        status, out, _ = _post(addr, "{ q(func: has(name)) { uid name } }")
        assert [n["name"] for n in out["q"]] == ["a", "c"]
    finally:
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0


def test_loader_grpc_flag_is_refused(srv, tmp_path):
    """(Named when the port refused ``--grpc``; it asserts the opposite
    now.)  ``--grpc`` is not refused: as in the reference, the loader
    loads over ``protos.Dgraph/Run`` — to a bare host:port target and to
    an ``http://`` address mapped to its port + 1000 — and an
    ``https://`` address without ``--ca`` fails at construction."""
    pytest.importorskip("grpc")
    from dgraph_tpu_torch.serve.grpc_server import GrpcServer

    rdf = tmp_path / "g.rdf"
    rdf.write_text('<0x51> <name> "over grpc" .\n<0x51> <knows> <0x52> .\n'
                   '<0x52> <name> "second" .\n')
    g = GrpcServer(srv, port=0)
    g.start()
    try:
        for target in (f"127.0.0.1:{g.port}", f"http://127.0.0.1:{g.port - 1000}"):
            assert loader_cli.main(["-r", str(rdf), "-d", target, "--grpc"]) == 0
        out = HttpTransport(srv.addr).run('{ q(func: uid(0x51)) { name knows { name } } }')
        assert out["q"] == [{"name": "over grpc", "knows": [{"name": "second"}]}]
        with pytest.raises(ValueError, match="cafile"):
            loader_cli.main(["-r", str(rdf), "-d", "https://127.0.0.1:1", "--grpc"])
    finally:
        g.stop()


def test_http_transport_binary_protobuf(srv):
    """``binary=True`` speaks the protobuf wire surface end to end and
    gives the JSON path's result dict — empty blocks included — and the
    reference's binary transport against a reference server over the
    same mutation gives the same dicts."""
    from dgraph_tpu.client.client import HttpTransport as JaxHttpTransport
    from dgraph_tpu.serve.server import DgraphServer as JaxServer

    ref = JaxServer(JaxStore())
    ref.start()
    try:
        mu = ('mutation { set { <0x61> <name> "Alice" . <0x61> <follows> <0x62> . '
              '<0x62> <name> "Bob" . } }')
        for addr in (srv.addr, ref.addr):
            HttpTransport(addr).run(mu)
        for q in ("{ q(func: uid(0x61)) { name follows { name } } }",
                  "{ q(func: uid(0x5f)) { name } }"):
            jout = HttpTransport(srv.addr).run(q)
            bout = HttpTransport(srv.addr, binary=True).run(q)
            rout = JaxHttpTransport(ref.addr, binary=True).run(q)
            assert bout["q"] == jout["q"] == rout["q"]
        assert HttpTransport(srv.addr, binary=True).run(
            "{ q(func: uid(0x5f)) { name } }")["q"] == []
    finally:
        ref.stop()


def test_unmarshal_from_protobuf_nodes(srv):
    """The Node trees of a protobuf Response unmarshal into the same
    dataclasses as the JSON tree."""
    from dgraph_tpu_torch.client import unmarshal_list

    @dataclass
    class Friend:
        name: str = ""

    @dataclass
    class Person:
        name: str = ""
        follows: List[Friend] = field(default_factory=list)

    HttpTransport(srv.addr).run(
        'mutation { set { <0x1> <name> "A" . <0x1> <follows> <0x2> . '
        '<0x1> <follows> <0x3> . <0x2> <name> "B" . <0x3> <name> "C" . } }')
    q = "{ q(func: uid(0x1)) { name follows { name } } }"
    js = unmarshal_list(HttpTransport(srv.addr).run(q)["q"], Person)
    pb = unmarshal_list(HttpTransport(srv.addr, binary=True).run(q)["q"], Person)
    assert pb == js == [Person("A", [Friend("B"), Friend("C")])]
