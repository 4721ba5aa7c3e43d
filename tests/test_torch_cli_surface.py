"""The rest of the port's server and CLI surface against the reference's:
the console page at ``/``, ``/share``, the YAML options and the flags'
precedence, the ``--dumpsg`` execution-shape dumps, the posting
iterator, the group-commit and snapshotter off switches, and a CLI boot
with ``--config``, ``--dumpsg``, ``--cpu`` and ``--mem``.

The cases follow the reference's own tests (tests/test_server.py's
share, dashboard, YAML and dumpsg cases; tests/test_utils.py's YAML
merge and flag precedence) on the same inputs, and each output is
compared with the reference's: the page's bytes, the share ids, the
merged ``Options``, the dumps (``dump_dict``) and the iterator's lines.
Tolerance: none."""

import json
import os
import subprocess
import sys
import time
import urllib.error
import urllib.request
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest

from dgraph_tpu.cli import posting_iterator as jiter
from dgraph_tpu.cli.server import build_options as jbuild_options
from dgraph_tpu.models import PostingStore as JaxStore
from dgraph_tpu.models.wal import DurableStore as JaxDurable
from dgraph_tpu.serve.dashboard import DASHBOARD_HTML as JAX_DASHBOARD
from dgraph_tpu.serve.server import DgraphServer as JaxServer
from dgraph_tpu.utils.config import Options as JaxOptions
from dgraph_tpu_torch.cli import posting_iterator as titer
from dgraph_tpu_torch.cli.server import build_options
from dgraph_tpu_torch.models import PostingStore
from dgraph_tpu_torch.models.wal import DurableStore
from dgraph_tpu_torch.query import QueryEngine
from dgraph_tpu_torch.serve.dashboard import DASHBOARD_HTML
from dgraph_tpu_torch.serve.server import DgraphServer
from dgraph_tpu_torch.utils.config import Options

from tests.torch_parity import REFERENCE_ENV
from torch_pins import pinned_planner  # noqa: F401

pytestmark = pytest.mark.usefixtures("pinned_planner")

ROOT = Path(__file__).resolve().parents[1]
NAMES = 'mutation { set { <0x1> <name> "Alice" . <0x2> <name> "Bob" . } }'


def _req(addr, path, body=None, raw=False):
    req = urllib.request.Request(
        addr + path, data=None if body is None else body.encode(),
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            data = r.read()
            return r.status, data if raw else json.loads(data)
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture
def servers(monkeypatch):
    """A port server and a reference server, each over an empty store."""
    for k, v in REFERENCE_ENV.items():
        monkeypatch.setenv(k, v)
    out = []
    for srv in (DgraphServer(PostingStore(), device="cpu"), JaxServer(JaxStore())):
        srv.start()
        out.append(srv)
    yield out
    for srv in out:
        srv.stop()


# -- the console and /share --------------------------------------------------------


def test_dashboard_is_the_reference_page(servers):
    assert DASHBOARD_HTML == JAX_DASHBOARD
    port, ref = servers
    got = _req(port.addr, "/", raw=True)
    assert got == _req(ref.addr, "/", raw=True)
    assert got[0] == 200 and "dgraph-tpu console" in got[1].decode()


def test_dashboard_fetches_only_served_endpoints(servers):
    """Every endpoint the page fetches answers on the port's server."""
    import re

    port, _ref = servers
    paths = set(re.findall(r"fetch\('(/[a-z_/]*)'", DASHBOARD_HTML))
    assert paths == {"/health", "/query", "/debug/store", "/share"}, paths
    for p in paths:
        code, _ = _req(port.addr, p, body="{ q(func: uid(0x1)) { uid } }"
                       if p in ("/query", "/share") else None, raw=True)
        assert code == 200, p


@pytest.mark.parametrize("q", ["{ q(func: has(name)) { name } }", "", "ü { x }"])
def test_share_roundtrip_matches_reference(servers, q):
    port, ref = servers
    code, out = _req(port.addr, "/share", q)
    assert code == 200
    assert (code, out) == _req(ref.addr, "/share", q)
    sid = out["uids"]["share"]
    assert _req(port.addr, f"/share/{sid}") == (200, {"share": q})
    assert _req(port.addr, "/share/0000")[0] == 404


def test_share_keeps_the_last_1024(servers):
    port, _ref = servers
    ids = [port.share(f"q{i}") for i in range(1030)]
    assert len(port._shares) == 1024
    assert ids[0] not in port._shares and ids[-1] in port._shares
    port.share("q10")  # a repeat moves to the young end
    port.share("new")
    assert ids[10] in port._shares and ids[6] not in port._shares
    assert ids[7] in port._shares


# -- options: YAML and flags ----------------------------------------------------------


def _opts(o):
    d = asdict(o)
    d.pop("device", None)        # the port's own field
    d.pop("compile_cache", None)  # the reference's XLA cache (no counterpart)
    return d


def test_options_yaml_merge_matches_reference(tmp_path):
    cfg = tmp_path / "conf.yaml"
    cfg.write_text("port: 9999\nsync_writes: true\n# comment\npostings_dir: /data/p\n"
                   "memory-mb: 512\ntrace_ratio: '0.25'\nunknown_key: 3\n"
                   "dumpsg: \"/tmp/sg\"  # trailing comment\n")
    got = Options().merged_with_yaml(str(cfg))
    assert _opts(got) == _opts(JaxOptions().merged_with_yaml(str(cfg)))
    assert got.port == 9999 and got.sync_writes is True
    assert got.postings_dir == "/data/p" and got.memory_mb == 512
    assert got.trace_ratio == 0.25 and got.dumpsg == "/tmp/sg"


@pytest.mark.parametrize("argv", [
    ["--port", "9000"],
    [],
    ["--port", "7002", "--export", "/flag/e", "--sync", "--workers", "2"],
    ["--memory_mb", "64", "--dumpsg", "sg", "--cpu", "c.pstats", "--mem", "m.txt",
     "--w", "wd", "--num_pending", "5", "--max_edges", "9"],
])
def test_flags_beat_yaml_like_the_reference(tmp_path, argv):
    cfg = tmp_path / "conf.yaml"
    cfg.write_text("port: 8080\nexport_path: /from/yaml\nsync_writes: true\n"
                   "workers: 9\nmemory_mb: 128\n")
    got = build_options(["--config", str(cfg)] + argv)
    assert _opts(got) == _opts(jbuild_options(["--config", str(cfg)] + argv))
    if "--port" in argv:
        assert got.port == int(argv[argv.index("--port") + 1])
    else:
        assert got.port == 8080 and got.export_path == "/from/yaml"
    assert got.sync_writes is True


def test_arena_budget_mb_is_an_alias_of_memory_mb():
    assert build_options(["--arena_budget_mb", "7"]).memory_mb == 7
    assert build_options(["--memory_mb", "7"]).memory_mb == 7
    assert build_options(["--device", "cpu"]).device == "cpu"


# -- --dumpsg ---------------------------------------------------------------------------


DUMP_QUERIES = [
    "{ q(func: uid(0x1)) { name follows { _uid_ } } }",
    "{ q(func: has(name), orderasc: name, first: 1) { name ~follows { uid } } }",
    "{ f as var(func: uid(0x1)) { follows } q(func: uid(f)) @filter(has(name)) { name } }",
]


def _dumps(path):
    return [json.loads((path / f).read_text()) for f in sorted(os.listdir(path))]


@pytest.mark.parametrize("sched", ["1", "0"])
def test_dumpsg_matches_reference(tmp_path, monkeypatch, sched):
    """Each query request writes one dump, equal to the reference's
    ``dump_dict`` dump of the same request, on the scheduled path and on
    the serial path; a mutation-only request writes none."""
    for k, v in REFERENCE_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DGRAPH_TPU_SCHED", sched)
    out = {}
    for name, srv in (
        ("port", DgraphServer(PostingStore(), device="cpu",
                              dumpsg_path=str(tmp_path / "port"))),
        ("ref", JaxServer(JaxStore(), dumpsg_path=str(tmp_path / "ref"))),
    ):
        srv.start()
        try:
            _req(srv.addr, "/query", 'mutation { set { <0x1> <name> "A" . '
                 '<0x1> <follows> <0x2> . <0x2> <name> "B" . <0x2> <follows> <0x3> . } }')
            for q in DUMP_QUERIES:
                assert _req(srv.addr, "/query", q)[0] == 200
            n = len(os.listdir(tmp_path / name))
            _req(srv.addr, "/query", 'mutation { set { <0x4> <name> "C" . } }')
            assert len(os.listdir(tmp_path / name)) == n == len(DUMP_QUERIES)
        finally:
            srv.stop()
        out[name] = _dumps(tmp_path / name)
    assert out["port"] == out["ref"]
    root = out["port"][0][0]
    assert root["n_dest"] == 1
    assert {c["attr"] for c in root["children"]} == {"name", "follows"}


# -- the posting iterator ----------------------------------------------------------------


def _write_store(path):
    st = DurableStore(str(path))
    eng = QueryEngine(st, device="cpu")
    eng.run("mutation { schema { name: string @index(term) . age: int . "
            "follows: uid @reverse . } }")
    rng = np.random.default_rng(3)
    lines = []
    for u in range(1, 40):
        lines.append('<0x%x> <name> "n%d" .' % (u, u))
        if u % 3:
            lines.append('<0x%x> <age> "%d" .' % (u, rng.integers(1, 90)))
        for v in rng.integers(1, 40, size=2):
            lines.append("<0x%x> <follows> <0x%x> (w=%d) ." % (u, v, v % 5))
    eng.run("mutation { set { %s } }" % "\n".join(lines))
    eng.run("mutation { delete { <0x1> <follows> * . } }")
    st.close()


@pytest.mark.parametrize("pred", ["", "follows", "age", "nothing"])
def test_posting_iterator_matches_reference(tmp_path, capsys, pred):
    _write_store(tmp_path / "p")
    argv = ["--p", str(tmp_path / "p")] + (["--pred", pred] if pred else [])
    assert titer.main(argv) == 0
    got = capsys.readouterr().out
    assert jiter.main(argv) == 0
    assert got == capsys.readouterr().out
    lines = got.splitlines()
    assert bool(lines) == (pred != "nothing")
    assert not pred or all(f"<{pred}>" in ln for ln in lines)


def test_posting_iterator_prints_the_export(tmp_path):
    """Run as a module, it prints exactly the lines of /admin/export."""
    import gzip

    _write_store(tmp_path / "p")
    r = subprocess.run([sys.executable, "-m", "dgraph_tpu_torch.cli.posting_iterator",
                        "--p", str(tmp_path / "p")], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    srv = DgraphServer(DurableStore(str(tmp_path / "p")), device="cpu",
                       export_path=str(tmp_path / "export"))
    srv.start()
    try:
        code, out = _req(srv.addr, "/admin/export")
    finally:
        srv.stop()
    assert code == 200
    with gzip.open(out["rdf"], "rt") as f:
        assert r.stdout.splitlines() == f.read().splitlines()


# -- the storage switches and the profiler ---------------------------------------------


@pytest.mark.parametrize("gc", ["1", "0"])
@pytest.mark.parametrize("snap", ["1", "0"])
def test_group_commit_and_snapshotter_switches(tmp_path, monkeypatch, gc, snap):
    monkeypatch.setenv("DGRAPH_TPU_GROUP_COMMIT", gc)
    monkeypatch.setenv("DGRAPH_TPU_SNAPSHOTTER", snap)
    port = DgraphServer(DurableStore(str(tmp_path / "t"), sync_writes=True), device="cpu")
    ref = JaxServer(JaxDurable(str(tmp_path / "j"), sync_writes=True))
    for srv in (port, ref):
        srv.start()
    try:
        for srv in (port, ref):
            assert srv.store._group_commit == (gc == "1")
            assert (srv.snapshotter is None) == (snap == "0")
            assert _req(srv.addr, "/query", NAMES)[0] == 200
        assert (_req(port.addr, "/admin/snapshot")[0] == 404) == (snap == "0")
        assert _req(port.addr, "/query", "{ q(func: has(name)) { name } }")[1]["q"]
    finally:
        for srv in (port, ref):
            srv.stop()


def test_profiler_runs_the_serial_path():
    import cProfile

    prof = cProfile.Profile()
    srv = DgraphServer(PostingStore(), device="cpu", profiler=prof)
    assert srv.scheduler is None
    srv.start()
    try:
        _req(srv.addr, "/query", NAMES)
        assert _req(srv.addr, "/query", "{ q(func: has(name)) { name } }")[1]["q"]
    finally:
        srv.stop()
    assert prof.getstats(), "the profiler saw no query execution"


# -- the CLI boot ------------------------------------------------------------------------


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_boots_from_config_with_dumps_and_profiles(tmp_path):
    port = _free_port()
    cfg = tmp_path / "conf.yaml"
    cfg.write_text(f"port: {port}\ngrpc_port: -1\ndevice: cpu\n"
                   f"postings_dir: {tmp_path / 'p'}\n")
    sg, cpu, mem = tmp_path / "sg", tmp_path / "cpu.pstats", tmp_path / "mem.txt"
    proc = subprocess.Popen(
        [sys.executable, "-m", "dgraph_tpu_torch.cli.server", "--config", str(cfg),
         "--dumpsg", str(sg), "--cpu", str(cpu), "--mem", str(mem)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        addr = None
        deadline = time.time() + 120
        while addr is None and time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            if line.startswith("serving on "):
                addr = line.split()[2]
        assert addr == f"http://127.0.0.1:{port}", addr
        code, page = _req(addr, "/", raw=True)
        assert code == 200 and page.decode() == DASHBOARD_HTML
        sid = _req(addr, "/share", "{ q(func: has(name)) { name } }")[1]["uids"]["share"]
        assert _req(addr, f"/share/{sid}")[1]["share"] == "{ q(func: has(name)) { name } }"
        assert _req(addr, "/query", NAMES)[0] == 200
        assert _req(addr, "/query", "{ q(func: has(name)) { name } }")[1]["q"]
        dumps = _dumps(sg)
        assert len(dumps) == 1 and dumps[0][0]["n_dest"] == 2
        _req(addr, "/admin/shutdown")
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out
    assert "cpu profile written" in out and "memory profile written" in out
    import pstats

    assert pstats.Stats(str(cpu)).total_calls > 0
    assert mem.read_text().count("\n") >= 1
