"""The port's flight recorder (``dgraph_tpu_torch/obs/``) against the
reference's (``dgraph_tpu/obs/``), on the CPU.

- tests/test_obs.py's cases on port servers (``device="cpu"``), except
  the gRPC one (the port serves no gRPC): span trees, W3C traceparent
  propagation, the zero-allocation guard, slow-query tail sampling,
  exemplar linkage, the /debug/traces + /metrics surface and a 2-group
  cluster trace.
- Cross-package equality (tolerance 0): traceparent parse/format on a
  fixed list of good and malformed headers, a pinned-seed Sampler's
  decisions and ids, ``chrome_trace`` of one trace dict, OpenMetrics
  exemplar lines for the same observations, the span tree (names and
  nesting) of the same query on a port and a reference server, and one
  trace id kept across a forwarded mutation in a mixed cluster of two
  port servers and one reference server.

Each package has its own process-wide recorder; the autouse fixture
restores both after every test, and env knobs go through monkeypatch.
"""

import importlib
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

from dgraph_tpu import obs as jobs
from dgraph_tpu.models import PostingStore as JPostingStore
from dgraph_tpu.serve.server import DgraphServer as JDgraphServer
from dgraph_tpu_torch import obs
from dgraph_tpu_torch.models import PostingStore
from dgraph_tpu_torch.serve.server import DgraphServer
from dgraph_tpu_torch.utils.metrics import SLOW_QUERIES, SPANS_RECORDED
from dgraph_tpu_torch.utils.trace import Tracer
from torch_pins import pinned_planner  # noqa: F401

# every route decision of both planners is pinned (tests/torch_pins.py)
pytestmark = pytest.mark.usefixtures("pinned_planner")

# the modules (``dgraph_tpu.utils`` re-exports the registry object under
# the module's name)
jmetrics = importlib.import_module("dgraph_tpu.utils.metrics")
tmetrics = importlib.import_module("dgraph_tpu_torch.utils.metrics")


@pytest.fixture(autouse=True)
def _recorder_reset():
    """Every test configures the recorders explicitly; both packages'
    process recorders go back to env-default behavior (ratio 0) after."""
    yield
    obs.configure()
    jobs.configure()


def _post(addr, path, body, headers=None):
    req = urllib.request.Request(addr + path, data=body.encode(), method="POST")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read().decode())


def _get(addr, path, headers=None, raw=False):
    req = urllib.request.Request(addr + path)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    with urllib.request.urlopen(req, timeout=30) as r:
        data = r.read()
        ctype = r.headers.get("Content-Type", "")
    return (data, ctype) if raw else json.loads(data.decode())


def _tp(n: int, sampled: bool = True) -> str:
    """A deterministic traceparent for test n."""
    return f"00-{n:032x}-{n:016x}-{'01' if sampled else '00'}"


def _tid(n: int) -> str:
    return f"{n:032x}"


def _trace(addr, tid, want=("sched.flush",)):
    """/debug/traces/<tid> once every span named in ``want`` landed: the
    cohort's flush span is finished by the flush worker after it deals
    the results, so it may land after the response."""
    deadline = time.monotonic() + 10.0
    while True:
        t = _get(addr, f"/debug/traces/{tid}")
        names = {s["name"] for s in t["spans"]}
        if all(w in names for w in want) or time.monotonic() > deadline:
            return t
        time.sleep(0.01)


SEED = """
mutation {
  schema { name: string @index(term) . follows: uid . }
  set {
    <0x1> <name> "Alice" .
    <0x2> <name> "Bob" .
    <0x3> <name> "Carol" .
    <0x1> <follows> <0x2> .
    <0x2> <follows> <0x3> .
  }
}
"""


@pytest.fixture(scope="module")
def srv():
    server = DgraphServer(PostingStore(), device="cpu")
    server.start()
    _post(server.addr, "/query", SEED)
    yield server
    server.stop()


def _assert_monotone_nesting(spans):
    """Every child interval nests inside its parent's [t0, t1]."""
    by_id = {s["span_id"]: s for s in spans}
    checked = 0
    for s in spans:
        p = by_id.get(s["parent_id"])
        if p is None:
            continue
        assert s["t0_ns"] >= p["t0_ns"], (s["name"], p["name"])
        assert s["t1_ns"] <= p["t1_ns"], (s["name"], p["name"])
        checked += 1
    return checked


# ------------------------------------------------------------- traceparent

TRACEPARENTS = [
    _tp(0xABC),
    _tp(5, sampled=False),
    "00-" + "a" * 32 + "-" + "b" * 16 + "-03",
    "01-" + "1" * 32 + "-" + "2" * 16 + "-01-extra",
    "  " + _tp(77) + "  ",
    None,
    "",
    "garbage",
    "00-abc-def-01",
    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",
    "00-" + "1" * 32 + "-" + "0" * 16 + "-01",
    "ff-" + "1" * 32 + "-" + "2" * 16 + "-01",
    "FF-" + "1" * 32 + "-" + "2" * 16 + "-01",
    "00-" + "G" * 32 + "-" + "2" * 16 + "-01",
    "00-" + "A" * 32 + "-" + "2" * 16 + "-01",
    "00-" + "1" * 32 + "-" + "2" * 16 + "-zz",
    "00-" + "1" * 32 + "-" + "2" * 16,
    12345,
]


@pytest.mark.parametrize("header", TRACEPARENTS)
def test_traceparent_parse_matches_reference(header):
    got, want = obs.parse_traceparent(header), jobs.parse_traceparent(header)
    if want is None:
        assert got is None
        return
    assert (got.trace_id, got.span_id, got.sampled) == (
        want.trace_id, want.span_id, want.sampled
    )


def test_traceparent_format_matches_reference():
    obs.configure(ratio=1.0, seed=5)
    jobs.configure(ratio=1.0, seed=5)
    ctx = obs.parse_traceparent(_tp(0x1234))
    a = obs.start_request("query", ctx)
    b = jobs.start_request("query", jobs.parse_traceparent(_tp(0x1234)))
    assert obs.format_traceparent(a) == jobs.format_traceparent(b)
    assert obs.format_traceparent(a.child("x")) == jobs.format_traceparent(
        b.child("x")
    )


def test_traceparent_parse_and_format_roundtrip():
    ctx = obs.parse_traceparent(_tp(0xABC))
    assert ctx is not None
    assert ctx.trace_id == _tid(0xABC)
    assert ctx.span_id == f"{0xABC:016x}"
    assert ctx.sampled is True
    assert obs.parse_traceparent(_tp(5, sampled=False)).sampled is False


def test_malformed_traceparent_never_500s(srv):
    obs.configure(ratio=0.0)
    out = _post(
        srv.addr, "/query", "{ q(func: uid(0x1)) { name } }",
        headers={"Traceparent": "not-a-trace-at-all"},
    )
    assert out["q"] == [{"name": "Alice"}]


# ----------------------------------------------------------------- sampler


@pytest.mark.parametrize("ratio,seed", [(0.5, 42), (0.1, 7), (0.9, 2024)])
def test_sampler_matches_reference_under_pinned_seed(ratio, seed):
    a, b = obs.Sampler(ratio=ratio, seed=seed), jobs.Sampler(ratio=ratio, seed=seed)
    assert [a.decide() for _ in range(300)] == [b.decide() for _ in range(300)]
    assert [a.new_id(128) for _ in range(5)] == [b.new_id(128) for _ in range(5)]
    assert a.new_id(64) == b.new_id(64)


def test_sampler_deterministic_under_pinned_seed():
    a = obs.Sampler(ratio=0.5, seed=42)
    b = obs.Sampler(ratio=0.5, seed=42)
    assert [a.decide() for _ in range(200)] == [b.decide() for _ in range(200)]
    a2 = obs.Sampler(ratio=0.5, seed=42)
    b2 = obs.Sampler(ratio=0.5, seed=42)
    assert a2.new_id(128) == b2.new_id(128)


def test_legacy_tracer_sampler_owns_seeded_rng():
    a = Tracer(ratio=0.5, seed=7)
    b = Tracer(ratio=0.5, seed=7)
    seq_a = [a.begin().active for _ in range(100)]
    seq_b = [b.begin().active for _ in range(100)]
    assert seq_a == seq_b
    assert any(seq_a) and not all(seq_a)
    # pinning the tracer's seed must not touch the global RNG stream
    import random

    random.seed(123)
    before = random.random()
    random.seed(123)
    Tracer(ratio=0.5, seed=7).begin()
    assert random.random() == before


# ---------------------------------------------------------- span mechanics


def test_span_tree_publishes_to_ring_with_consistent_nesting():
    rec = obs.configure(ratio=1.0, seed=3)
    root = obs.start_request("query")
    assert root is not None
    with root:
        with root.child("a") as a:
            with a.child("b"):
                time.sleep(0.001)
    t = rec.trace(root.trace_id)
    assert t is not None
    by_name = {s["name"]: s for s in t["spans"]}
    assert set(by_name) == {"query", "a", "b"}
    assert by_name["a"]["parent_id"] == by_name["query"]["span_id"]
    assert by_name["b"]["parent_id"] == by_name["a"]["span_id"]
    _assert_monotone_nesting(t["spans"])


def test_kill_switch_disables_roots_entirely():
    obs.configure(ratio=1.0, enabled=False)
    assert obs.start_request("query") is None
    ctx = obs.parse_traceparent(_tp(9))
    assert obs.start_request("query", ctx) is None
    assert obs.server_span("peer.x", ctx) is obs.NOOP


def test_env_knobs_configure_the_recorder(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_TRACE_RATIO", "1.0")
    monkeypatch.setenv("DGRAPH_TPU_TRACE_SEED", "9")
    monkeypatch.setenv("DGRAPH_TPU_SLOW_MS", "12.5")
    monkeypatch.setenv("DGRAPH_TPU_TRACE_KEEP", "3")
    rec = obs.configure()
    assert rec.sampler.ratio == 1.0 and rec.slow_ms == 12.5
    for _ in range(5):
        with obs.start_request("query"):
            pass
    assert len(rec.traces()) == 3
    monkeypatch.setenv("DGRAPH_TPU_TRACE", "0")
    assert obs.configure().start_request("query") is None


def test_block_ready_ms_on_cpu_tensors_is_zero():
    import torch

    assert obs.block_ready_ms(torch.arange(4)) == 0.0
    assert obs.block_ready_ms((torch.arange(4), torch.zeros(2))) == 0.0
    assert obs.block_ready_ms(np.arange(3)) == 0.0


def test_stage_timer_accumulates():
    st = {}
    with obs.stage(st, "x_ms"):
        pass
    with obs.stage(st, "x_ms"):
        time.sleep(0.001)
    assert st["x_ms"] >= 1.0


# ----------------------------------------------- single-node serving trace


def test_single_node_trace_covers_scheduler_cache_engine(srv):
    # propagation-driven: the upstream sampled flag is honored only while
    # the local sampler is ARMED (ratio > 0)
    obs.configure(ratio=1e-9)
    out = _post(
        srv.addr, "/query",
        "{ t1(func: uid(0x1)) { name follows { name } } }",
        headers={"Traceparent": _tp(1001)},
    )
    assert out["t1"][0]["follows"] == [{"name": "Bob"}]
    t = _trace(srv.addr, _tid(1001))
    names = [s["name"] for s in t["spans"]]
    for want in (
        "query", "parsing", "processing", "cache.result", "sched.queue",
        "sched.flush", "engine", "hop", "cache.hop",
    ):
        assert want in names, f"missing span {want!r} in {names}"
    by_name = {s["name"]: s for s in t["spans"]}
    # root continues the CALLER's trace: parent is the header's span id
    assert by_name["query"]["parent_id"] == f"{1001:016x}"
    hop = by_name["hop"]
    assert hop["attrs"]["pred"] == "follows"
    assert hop["attrs"]["edges"] == 1
    assert hop["attrs"]["route"] in ("host", "resident", "csr", "cache", "merged")
    # the engine span links to the shared cohort-flush span
    eng = by_name["engine"]
    flush = by_name["sched.flush"]
    assert {"trace_id": flush["trace_id"], "span_id": flush["span_id"]} in (
        eng["links"]
    )
    assert by_name["sched.queue"]["attrs"]["outcome"] == "run"
    assert _assert_monotone_nesting(t["spans"]) >= 5


def test_device_route_hop_span_carries_device_sync(srv):
    """The resident route on CPU tensors (its plain version): the hop
    span names the route and carries ``device_sync_ms`` (0 on the CPU,
    where the result is ready at once), within the hop's duration."""
    obs.configure(ratio=1e-9)
    arenas = srv.engine.arenas
    old_min, old_mode = arenas.expand_device_min, srv.engine.expander.resident_mode
    arenas.expand_device_min = 1
    srv.engine.expander.resident_mode = "force"
    try:
        _post(srv.addr, "/query", "{ d1(func: uid(0x1, 0x2)) { follows { uid } } }",
              headers={"Traceparent": _tp(1010)})
    finally:
        arenas.expand_device_min = old_min
        srv.engine.expander.resident_mode = old_mode
    t = _get(srv.addr, f"/debug/traces/{_tid(1010)}")
    hops = [s for s in t["spans"] if s["name"] == "hop"]
    assert hops and hops[0]["attrs"]["route"] == "resident", hops
    assert 0.0 <= hops[0]["attrs"]["device_sync_ms"] <= hops[0]["dur_us"] / 1e3


def test_repeat_query_trace_shows_result_cache_hit(srv):
    obs.configure(ratio=1e-9)
    q = "{ t2(func: uid(0x2)) { name } }"
    _post(srv.addr, "/query", q, headers={"Traceparent": _tp(1002)})
    _post(srv.addr, "/query", q, headers={"Traceparent": _tp(1003)})
    t2 = _get(srv.addr, f"/debug/traces/{_tid(1003)}")
    by_name = {s["name"]: s for s in t2["spans"]}
    assert by_name["cache.result"]["attrs"]["outcome"] == "hit"
    assert by_name["cache.result"]["attrs"]["bytes"] > 0
    # a tier-2 hit returns before admission: no engine work in the trace
    assert "engine" not in by_name and "hop" not in by_name


def test_hop_cache_hit_routes_hop_span(srv):
    obs.configure(ratio=1e-9)
    # different query texts (distinct tier-2 keys) sharing one hop
    _post(srv.addr, "/query", "{ a3(func: uid(0x2)) { follows { name } } }",
          headers={"Traceparent": _tp(1004)})
    _post(srv.addr, "/query", "{ b3(func: uid(0x2)) { follows { name } } }",
          headers={"Traceparent": _tp(1005)})
    t = _get(srv.addr, f"/debug/traces/{_tid(1005)}")
    hops = [s for s in t["spans"] if s["name"] == "hop"]
    assert hops and hops[0]["attrs"]["route"] == "cache"
    probes = [s for s in t["spans"] if s["name"] == "cache.hop"]
    assert probes[0]["attrs"]["outcome"] == "hit"
    assert probes[0]["attrs"]["bytes"] > 0


def test_debug_traces_listing_and_chrome_export(srv):
    obs.configure(ratio=1e-9)
    _post(srv.addr, "/query", "{ t4(func: uid(0x1)) { name } }",
          headers={"Traceparent": _tp(1006)})
    _trace(srv.addr, _tid(1006))  # settled: the listing counts every span
    listing = _get(srv.addr, "/debug/traces")
    assert any(e["trace_id"] == _tid(1006) for e in listing)
    entry = [e for e in listing if e["trace_id"] == _tid(1006)][0]
    assert entry["spans"] >= 3 and entry["duration_ms"] >= 0
    chrome = _get(srv.addr, f"/debug/traces/{_tid(1006)}?format=chrome")
    xs = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
    assert xs and all("ts" in e and "dur" in e for e in xs)
    assert any(e["name"] == "query" for e in xs)
    assert len(xs) == entry["spans"]  # one event a span
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv.addr, "/debug/traces/" + "f" * 32)
    assert e.value.code == 404


def test_trace_surfaces_403_unless_exposed():
    server = DgraphServer(PostingStore(), device="cpu", expose_trace=False)
    server.start()
    try:
        for path in ("/debug/traces", "/debug/traces/" + "a" * 32,
                     "/debug/slow_queries", "/debug/requests"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(server.addr, path)
            assert e.value.code == 403, path
    finally:
        server.stop()


def test_debug_requests_ring_samples_at_the_tracer_ratio():
    server = DgraphServer(PostingStore(), device="cpu", trace_ratio=1.0)
    server.start()
    try:
        _post(server.addr, "/query", SEED)
        _post(server.addr, "/query", "{ r(func: uid(0x1)) { name } }")
        ring = _get(server.addr, "/debug/requests")
        assert [e["family"] for e in ring] == ["query", "query"]
        assert [e["msg"] for e in ring[-1]["events"]] == [
            "parsed: 1 queries, mutation=False", "processed",
        ]
    finally:
        server.stop()


# ----------------------------------------------------------- overhead guard


def test_unsampled_path_allocates_zero_spans(srv):
    obs.configure(ratio=0.0)
    q = "{ t5(func: uid(0x1)) { name follows { name } } }"
    _post(srv.addr, "/query", q)  # warm caches outside the window
    before = SPANS_RECORDED.value()
    for _ in range(5):
        out_on = _post(srv.addr, "/query", q)
    assert SPANS_RECORDED.value() == before, (
        "unsampled request allocated span objects"
    )
    # kill switch: same response, still zero spans
    obs.configure(enabled=False)
    out_off = _post(srv.addr, "/query", q)
    assert SPANS_RECORDED.value() == before
    out_on.pop("server_latency")
    out_off.pop("server_latency")
    assert out_on == out_off


def test_sampled_header_cannot_force_tracing_at_ratio_zero(srv):
    obs.configure(ratio=0.0)
    before = SPANS_RECORDED.value()
    _post(srv.addr, "/query", "{ z(func: uid(0x1)) { name } }",
          headers={"Traceparent": _tp(1099)})
    assert SPANS_RECORDED.value() == before
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(srv.addr, f"/debug/traces/{_tid(1099)}")
    assert e.value.code == 404


def test_sampled_bodies_equal_unsampled_bodies(srv):
    """Tracing changes no answer: each body at ratio 1 equals the same
    request's body at ratio 0 (``server_latency`` aside)."""
    qs = [
        "{ s1(func: uid(0x1)) { name follows { name follows { name } } } }",
        "{ s2(func: has(follows)) { count(follows) } }",
        "{ s3(func: anyofterms(name, \"alice carol\")) { uid name } }",
    ]
    srv.scheduler.result_cache, rc = None, srv.scheduler.result_cache
    try:
        bodies = {}
        for ratio in (0.0, 1.0):
            obs.configure(ratio=ratio, seed=1)
            for q in qs:
                out = _post(srv.addr, "/query", q)
                out.pop("server_latency")
                bodies.setdefault(q, []).append(out)
        for q, (off, on) in bodies.items():
            assert off == on, q
    finally:
        srv.scheduler.result_cache = rc


# ------------------------------------------------------ slow-query sampling


def test_slow_query_tail_sampled_at_ratio_zero(srv):
    from dgraph_tpu_torch.utils.failpoints import fail

    rec = obs.configure(ratio=0.0, slow_ms=5.0)
    n0 = SLOW_QUERIES.value()
    fail.seed(0)
    fail.arm("sched.flush", "delay(ms=40,n=1)")
    try:
        out = _post(srv.addr, "/query", "{ t6(func: uid(0x3)) { name } }")
    finally:
        fail.disarm("sched.flush")
    assert out["t6"] == [{"name": "Carol"}]
    assert SLOW_QUERIES.value() == n0 + 1
    slow = rec.slow_queries()
    assert slow and slow[-1]["duration_ms"] >= 5.0
    assert "t6(func" in slow[-1]["query"]
    tid = slow[-1]["trace_id"]
    assert tid is not None
    t = _get(srv.addr, f"/debug/traces/{tid}")
    assert t["spans"][0]["attrs"].get("tail_sampled") is True
    served = _get(srv.addr, "/debug/slow_queries")
    assert any(e["trace_id"] == tid for e in served)


def test_slow_query_of_a_sampled_request_links_its_trace(srv):
    """A sampled request over the threshold is logged under its own trace
    id (no synthetic trace): a threshold of 0.001 ms every request
    crosses, so nothing races a clock."""
    rec = obs.configure(ratio=1e-9, slow_ms=0.001)
    _post(srv.addr, "/query", "{ t6b(func: uid(0x2)) { name } }",
          headers={"Traceparent": _tp(1011)})
    slow = [e for e in rec.slow_queries() if e["trace_id"] == _tid(1011)]
    assert len(slow) == 1
    t = _get(srv.addr, f"/debug/traces/{_tid(1011)}")
    assert {s["name"] for s in t["spans"]} >= {"query", "processing"}


# ---------------------------------------------------------------- exemplars


def test_latency_exemplars_resolve_to_ring(srv):
    obs.configure(ratio=1e-9)
    _post(srv.addr, "/query", "{ t7(func: uid(0x1)) { name } }",
          headers={"Traceparent": _tp(1007)})
    body, ctype = _get(
        srv.addr, "/metrics",
        headers={"Accept": "application/openmetrics-text"}, raw=True,
    )
    assert ctype.startswith("application/openmetrics-text")
    text = body.decode()
    assert text.rstrip().endswith("# EOF")
    ex_lines = [
        l for l in text.splitlines()
        if l.startswith("dgraph_query_latency_seconds_bucket")
        and "# {trace_id=" in l
    ]
    assert ex_lines, "no exemplars on dgraph_query_latency_seconds"
    assert any(f'trace_id="{_tid(1007)}"' in l for l in ex_lines)
    t = _get(srv.addr, f"/debug/traces/{_tid(1007)}")
    assert t["trace_id"] == _tid(1007)


def test_metrics_alias_and_content_types(srv):
    body, ctype = _get(srv.addr, "/metrics", raw=True)
    assert ctype == "text/plain; version=0.0.4; charset=utf-8"
    assert b"dgraph_num_queries_total" in body
    assert b"# {trace_id=" not in body
    legacy, _ = _get(srv.addr, "/debug/prometheus_metrics", raw=True)
    assert b"dgraph_num_queries_total" in legacy


OBSERVATIONS = [
    (0.0003, "a" * 32), (0.004, None), (0.0049, "b" * 32), (0.07, "c" * 32),
    (0.07, None), (3.0, "d" * 32), (42.0, "e" * 32), (0.0005, "f" * 32),
]


def test_openmetrics_exemplars_match_reference(monkeypatch):
    """The same observations on a fresh registry of each package give the
    same OpenMetrics text, exemplar lines included (the wall clock the
    exemplars stamp is pinned)."""
    import time as _t

    monkeypatch.setattr(_t, "time", lambda: 1_700_000_000.25)
    texts = []
    for mod in (tmetrics, jmetrics):
        reg = mod.MetricsRegistry()
        h = reg.histogram("dgraph_query_latency_seconds", tmetrics._LATENCY_BUCKETS)
        g = reg.histogram("dgraph_other_seconds", (0.1, 1.0))
        for v, tid in OBSERVATIONS:
            h.observe(v, trace_id=tid)
            g.observe(v / 10, trace_id=tid)
        texts.append(reg.openmetrics_text())
    assert texts[0] == texts[1]
    assert texts[0].count("# {trace_id=") == 8


# ------------------------------------------------------- WAL barrier spans


def test_wal_group_commit_barrier_span(tmp_path):
    from dgraph_tpu_torch.models.wal import Wal

    rec = obs.configure(ratio=1.0, seed=11)
    wal = Wal(str(tmp_path / "w.wal"), sync=True)
    wal.group_commit = True
    root = obs.start_request("mutation")
    with root:
        wal.append(b"hello")
        wal.flush()
        wal.sync_upto()
    wal.close()
    t = rec.trace(root.trace_id)
    spans = {s["name"]: s for s in t["spans"]}
    assert "wal.group_commit" in spans
    assert spans["wal.group_commit"]["attrs"]["fsync"] is True
    assert spans["wal.group_commit"]["attrs"]["seq"] == 1


# --------------------------------------------- the reference's trace, alike


def _shape(spans):
    """A span tree's names and nesting: the multiset of (name, parent's
    name) pairs (the header's remote parent reads as None)."""
    by_id = {s["span_id"]: s["name"] for s in spans}
    return Counter((s["name"], by_id.get(s["parent_id"])) for s in spans)


def _settled(get_trace):
    """The trace once its cohort flush span landed (see ``_trace``)."""
    deadline = time.monotonic() + 10.0
    t = get_trace()
    while time.monotonic() < deadline:
        if t is not None and any(s["name"] == "sched.flush" for s in t["spans"]):
            return t
        time.sleep(0.01)
        t = get_trace()
    return t


@pytest.mark.parametrize("q", [
    "{ q(func: uid(0x1)) { name follows { name } } }",
    "{ q(func: uid(0x1)) { follows { follows { name } } } }",
    "{ q(func: anyofterms(name, \"alice bob\")) { uid name } }",
])
def test_span_tree_matches_reference(q):
    """The same query on a port server and a reference server: the same
    span names with the same nesting (cold caches on both)."""
    port = DgraphServer(PostingStore(), device="cpu")
    ref = JDgraphServer(JPostingStore())
    port.start()
    ref.start()
    try:
        _post(port.addr, "/query", SEED)
        _post(ref.addr, "/query", SEED)
        obs.configure(ratio=1e-9)
        jobs.configure(ratio=1e-9)
        n = 3000 + len(q)
        out_p = _post(port.addr, "/query", q, headers={"Traceparent": _tp(n)})
        out_r = _post(ref.addr, "/query", q, headers={"Traceparent": _tp(n)})
        out_p.pop("server_latency")
        out_r.pop("server_latency")
        assert out_p == out_r
        tr = _settled(lambda: jobs.get_recorder().trace(_tid(n)))
        tp = _settled(lambda: obs.get_recorder().trace(_tid(n)))
        assert _shape(tp["spans"]) == _shape(tr["spans"])
    finally:
        port.stop()
        ref.stop()


def test_chrome_trace_matches_reference():
    rec = obs.configure(ratio=1.0, seed=21)
    root = obs.start_request("query")
    with root:
        with root.child("engine") as e:
            e.set_attr("edges", 3)
            with e.child("hop") as h:
                h.set_attr("pred", "follows")
                h.link(root)
        open_span = root.child("stuck")  # still running at export
    t = rec.trace(root.trace_id)
    t["spans"].append(open_span.to_dict())
    assert json.dumps(obs.chrome_trace(t)) == json.dumps(jobs.chrome_trace(t))
    assert obs.chrome_trace({"spans": []}) == jobs.chrome_trace({"spans": []})


# ----------------------------------------------- 2-group cluster, e2e trace


def _free_ports(n):
    socks, ports = [], []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        socks.append(s)
    for s in socks:
        s.close()
    return ports


def _wait(cond, timeout=30.0, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return False


def _post_retry(addr, path, body, headers=None, timeout=60.0):
    """Retry transient settling errors (leader election, forwarded
    proposals racing apply)."""
    deadline = time.monotonic() + timeout
    last = None
    while time.monotonic() < deadline:
        try:
            return _post(addr, path, body, headers=headers)
        except (urllib.error.HTTPError, OSError) as e:
            last = e
            time.sleep(0.2)
    raise AssertionError(f"cluster request never settled: {last}")


@pytest.fixture(scope="module")
def cluster2(tmp_path_factory):
    """Two port nodes, two DATA groups, disjoint placement: node 1 serves
    group 1 (``follows``), node 2 group 2 (``name``) — a 2-hop on node 1
    MUST read cross-group, a ``name`` mutation posted to node 1 MUST
    forward."""
    from dgraph_tpu_torch.cluster.groups import GroupConfig
    from dgraph_tpu_torch.cluster.service import ClusterService

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("DGRAPH_TPU_PROPOSE_TIMEOUT", "45")
        tmp = tmp_path_factory.mktemp("obs-cluster")
        ports = _free_ports(2)
        peers = {"1": f"http://127.0.0.1:{ports[0]}",
                 "2": f"http://127.0.0.1:{ports[1]}"}
        conf = GroupConfig.parse("1: follows\n2: name\ndefault: fp % 2 + 1")
        groups_of = {"1": [0, 1], "2": [0, 2]}
        servers = []
        for nid in ("1", "2"):
            svc = ClusterService(
                node_id=nid, my_addr=peers[nid], peers=peers,
                group_ids=groups_of[nid], directory=str(tmp / f"n{nid}"),
                group_config=conf, peer_groups=groups_of,
            )
            svc.start()
            server = DgraphServer(svc.store, port=ports[int(nid) - 1],
                                  cluster=svc, device="cpu")
            server.start()
            servers.append(server)
        assert _wait(lambda: all(s.cluster.has_leader() for s in servers))
        _post_retry(servers[0].addr, "/query", """
        mutation { set {
          <0x1> <name> "Alice" .
          <0x2> <name> "Bob" .
          <0x3> <name> "Carol" .
          <0x1> <follows> <0x2> .
          <0x2> <follows> <0x3> .
        } }
        """)

        def visible():
            try:
                out = _post(
                    servers[0].addr, "/query",
                    "{ warm(func: uid(0x1)) { follows { follows { name } } } }",
                )
                w = out.get("warm", [{}])
                return bool(w and w[0].get("follows", [{}])[0].get("follows"))
            except (urllib.error.HTTPError, OSError, IndexError, KeyError):
                return False

        assert _wait(visible), "seed data never became readable on node 1"
        yield servers
        for s in servers:
            s.stop()


def test_cluster_two_hop_trace_covers_all_layers(cluster2):
    """ONE trace at /debug/traces/<id> covering server → scheduler →
    cache probe → per-hop execution → peer RPC attempts toward the
    remote node, the remote node's leg included, with consistent parent
    links and monotone nesting.  Spans land asynchronously (flush workers
    and peer-RPC legs may finish after the response), so the structural
    preconditions are polled first."""
    n1, _n2 = cluster2
    obs.configure(ratio=1e-9)
    n1.cluster.store._remote.clear()
    out = _post(
        n1.addr, "/query",
        "{ q(func: uid(0x1)) { follows { follows { name } } } }",
        headers={"Traceparent": _tp(2001)},
    )
    assert out["q"][0]["follows"][0]["follows"] == [{"name": "Carol"}]

    WANT = ("query", "processing", "sched.queue", "sched.flush",
            "engine", "hop", "cache.hop")

    def settled():
        spans = _get(n1.addr, f"/debug/traces/{_tid(2001)}")["spans"]
        names = {s["name"] for s in spans}
        if any(w not in names for w in WANT):
            return None
        if not any(s["name"].startswith("rpc.") for s in spans):
            return None
        if not any(s["name"] == "peer.pred-snapshot" for s in spans):
            return None
        if any(s["dur_us"] is None for s in spans if s["name"] in WANT):
            return None
        return spans

    spans = None
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        spans = settled()
        if spans is not None:
            break
        time.sleep(0.1)
    assert spans is not None, "trace never settled with all layers present"
    by_name = {s["name"]: s for s in spans}
    flush = by_name["sched.flush"]
    assert {"trace_id": flush["trace_id"], "span_id": flush["span_id"]} in (
        by_name["engine"]["links"]
    )
    hops = [s for s in spans if s["name"] == "hop"]
    assert len(hops) >= 2
    assert all(s["attrs"]["pred"] == "follows" for s in hops)
    assert sum(s["attrs"]["edges"] for s in hops) == 2
    assert all("route" in s["attrs"] for s in hops)
    rpcs = [s for s in spans if s["name"].startswith("rpc.")]
    assert any(s["attrs"].get("outcome") == "ok" for s in rpcs)
    assert all("attempt" in s["attrs"] for s in rpcs
               if s["attrs"].get("outcome") != "breaker_open")
    remote = [s for s in spans if s["name"] == "peer.pred-snapshot"]
    assert remote and remote[0]["attrs"]["node"] == "2"
    assert remote[0]["attrs"]["pred"] == "name"
    ids = {s["span_id"] for s in spans}
    for r in (s for s in spans if s["parent_id"] not in ids):
        assert r["parent_id"] is None or len(r["parent_id"]) == 16
    # remote server spans and the cohort-shared flush span are
    # asynchronous to the request by design: excluded from nesting
    sync_spans = [
        s for s in spans
        if not s["name"].startswith("peer.") and s["name"] != "sched.flush"
    ]
    assert _assert_monotone_nesting(sync_spans) >= 6


def test_cluster_forwarded_mutation_spans_on_both_nodes(cluster2):
    n1, _n2 = cluster2
    obs.configure(ratio=1e-9)
    out = _post_retry(
        n1.addr, "/query",
        'mutation { set { <0x4> <name> "Dave" . } }',
        headers={"Traceparent": _tp(2002)},
    )
    assert out.get("code") == "Success"

    def both():
        t = _get(n1.addr, f"/debug/traces/{_tid(2002)}")
        names = {s["name"] for s in t["spans"]}
        return t if {"query", "rpc.forward", "peer.raft-propose"} <= names else None

    assert _wait(lambda: both() is not None, timeout=10.0)
    t = both()
    by_name = {}
    for s in t["spans"]:
        by_name.setdefault(s["name"], []).append(s)
    assert by_name["query"][0]["attrs"]["node"] == "1"
    assert any(s["attrs"]["node"] == "2" for s in by_name["peer.raft-propose"])
    assert all(s["trace_id"] == _tid(2002) for s in t["spans"])


def test_cluster_cross_group_read_spans_on_both_nodes(cluster2):
    n1, _n2 = cluster2
    obs.configure(ratio=1e-9)
    n1.cluster.store._remote.clear()
    _post(n1.addr, "/query", "{ r(func: uid(0x2)) { name } }",
          headers={"Traceparent": _tp(2003)})

    def nodes_seen():
        t = _get(n1.addr, f"/debug/traces/{_tid(2003)}")
        return {s["attrs"]["node"] for s in t["spans"] if "node" in s["attrs"]}

    assert _wait(lambda: {"1", "2"} <= nodes_seen(), timeout=10.0), nodes_seen()


def test_cluster_malformed_traceparent_ignored(cluster2):
    n1, _n2 = cluster2
    obs.configure(ratio=0.0)
    out = _post(
        n1.addr, "/query", "{ m(func: uid(0x1)) { follows { name } } }",
        headers={"Traceparent": "00-zzzz-yyyy-01"},
    )
    assert "m" in out


def test_mixed_cluster_forwarded_mutation_keeps_one_trace_id(tmp_path, monkeypatch):
    """Two port servers and one reference server in one Raft group: a
    mutation posted to a server of the other package than the group's
    leader is forwarded, and the leader's package records the
    ``peer.raft-propose`` leg under the poster's trace id."""
    from tests.test_torch_cluster_http import _boot, _stop

    monkeypatch.setenv("DGRAPH_TPU_PROPOSE_TIMEOUT", "45")
    servers = _boot("mixed", tmp_path, kinds=["port", "port", "ref"])
    try:
        obs.configure(ratio=1e-9)
        jobs.configure(ratio=1e-9)
        out = _post_retry(servers[0].addr, "/query",
                          "mutation { schema { tag: string . } }")
        assert out.get("code") == "Success"
        gid = servers[0].cluster.conf.belongs_to("tag")

        def leader():
            return next((s for s in servers
                         if s.cluster.groups[gid].node.is_leader), None)

        assert _wait(lambda: leader() is not None)
        lead = leader()
        lead_is_port = isinstance(lead, DgraphServer)
        poster = next(s for s in servers
                      if isinstance(s, DgraphServer) != lead_is_port)
        out = _post_retry(poster.addr, "/query",
                          'mutation { set { <0x9> <tag> "t" . } }',
                          headers={"Traceparent": _tp(4001)})
        assert out.get("code") == "Success"
        recs = {True: obs.get_recorder(), False: jobs.get_recorder()}

        def legs():
            t_post = recs[not lead_is_port].trace(_tid(4001))
            t_lead = recs[lead_is_port].trace(_tid(4001))
            if t_post is None or t_lead is None:
                return None
            props = [s for s in t_lead["spans"] if s["name"] == "peer.raft-propose"]
            return (t_post, props) if props else None

        assert _wait(lambda: legs() is not None, timeout=15.0)
        t_post, props = legs()
        roots = [s for s in t_post["spans"] if s["name"] == "query"]
        assert roots and roots[0]["attrs"]["node"] == poster.cluster.node_id
        assert any(s["name"] == "rpc.forward" for s in t_post["spans"])
        assert all(s["trace_id"] == _tid(4001) for s in t_post["spans"] + props)
        assert {s["attrs"]["node"] for s in props} <= {
            s.cluster.node_id for s in servers if s is not poster
        }
    finally:
        _stop(servers)


def test_cli_environment_ratio_drives_both_rings(tmp_path):
    """``DGRAPH_TPU_TRACE_RATIO`` set and ``--trace`` left at 0: the CLI
    server's /debug/requests ring samples at the flight recorder's ratio,
    so one knob fills both rings."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, DGRAPH_TPU_TRACE_RATIO="1")
    env["PYTHONPATH"] = str(root) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dgraph_tpu_torch.cli.server",
         "--p", str(tmp_path / "p"), "--export", str(tmp_path / "export"),
         "--port", "0", "--device", "cpu", "--expose_trace"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env,
    )
    try:
        addr, lines = None, []
        deadline = time.monotonic() + 120
        while addr is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line.strip())
            if line.startswith("serving on "):
                addr = line.split()[2]
        assert addr, f"server did not start: {lines}"
        out = _post(addr, "/query", "{ q(func: uid(0x1)) { uid } }")
        assert out["q"] == [{"_uid_": "0x1"}]
        requests = _get(addr, "/debug/requests")
        traces = _get(addr, "/debug/traces")
        assert len(requests) == 1 and len(traces) == 1
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


# --------------------------------------------------- gRPC metadata plumbing


def test_grpc_metadata_traceparent_joins_trace(srv):
    """A ``traceparent`` in gRPC metadata joins the flight recorder's
    trace (the HTTP header's twin); a malformed one is ignored."""
    grpc = pytest.importorskip("grpc")
    from dgraph_tpu_torch.serve.grpc_server import GrpcServer, encode_request

    obs.configure(ratio=1e-9)  # armed: honour the metadata header
    gsrv = GrpcServer(srv, port=0)
    gsrv.start()
    try:
        with grpc.insecure_channel(f"127.0.0.1:{gsrv.port}") as ch:
            run = ch.unary_unary("/protos.Dgraph/Run")
            run(encode_request("{ t8(func: uid(0x1)) { name } }"),
                metadata=(("traceparent", _tp(1008)),), timeout=30)
            run(encode_request("{ t8b(func: uid(0x1)) { name } }"),
                metadata=(("traceparent", "junk"),), timeout=30)
    finally:
        gsrv.stop()
    t = _trace(srv.addr, _tid(1008))
    by_name = {s["name"]: s for s in t["spans"]}
    assert by_name["query"]["parent_id"] == f"{1008:016x}"
    assert "engine" in by_name or "cache.result" in by_name


def test_grpc_span_tree_matches_reference():
    """The same traced Run on a port and a reference gRPC server: equal
    bodies, and the same span names with the same nesting."""
    grpc = pytest.importorskip("grpc")
    from dgraph_tpu.serve.grpc_server import GrpcServer as JGrpcServer
    from dgraph_tpu_torch.serve.grpc_server import GrpcServer, encode_request
    from dgraph_tpu_torch.serve.proto import decode_response

    port = DgraphServer(PostingStore(), device="cpu")
    ref = JDgraphServer(JPostingStore())
    gp, gr = GrpcServer(port, port=0), JGrpcServer(ref, port=0)
    for s in (port, ref, gp, gr):
        s.start()
    try:
        _post(port.addr, "/query", SEED)
        _post(ref.addr, "/query", SEED)
        obs.configure(ratio=1e-9)
        jobs.configure(ratio=1e-9)
        q = encode_request("{ q(func: uid(0x1)) { name follows { name } } }")
        outs = []
        for g in (gp, gr):
            with grpc.insecure_channel(f"127.0.0.1:{g.port}") as ch:
                out = decode_response(ch.unary_unary("/protos.Dgraph/Run")(
                    q, metadata=(("traceparent", _tp(4242)),), timeout=30))
            out.pop("server_latency")
            outs.append(out)
        assert outs[0] == outs[1]
        tp = _settled(lambda: obs.get_recorder().trace(_tid(4242)))
        tr = _settled(lambda: jobs.get_recorder().trace(_tid(4242)))
        assert _shape(tp["spans"]) == _shape(tr["spans"])
    finally:
        for s in (gp, gr, port, ref):
            s.stop()


def test_grpc_peer_call_carries_the_trace_to_the_remote_node():
    """The gRPC leg of trace propagation between nodes: a raft frame
    sent through ``PeerClient.grpc_unary`` under a sampled span carries
    ``traceparent`` in its metadata, and the receiving Worker plane
    records ``peer.raft-message`` under the same trace id."""
    grpc = pytest.importorskip("grpc")
    from dgraph_tpu_torch.cluster.peerclient import PeerClient
    from dgraph_tpu_torch.serve.grpc_server import (
        GrpcServer,
        encode_payload,
        frame_raft,
    )

    class _Cluster:
        node_id = "7"

        class auth:
            secret = ""

        def __init__(self):
            self.got = []

        def deliver(self, group, frame):
            self.got.append((group, frame))

    srv = DgraphServer(PostingStore(), device="cpu")
    srv.cluster = _Cluster()
    gsrv = GrpcServer(srv, port=0)
    gsrv.start()
    rec = obs.configure(ratio=1.0, seed=3)
    try:
        with grpc.insecure_channel(f"127.0.0.1:{gsrv.port}") as ch:
            root = obs.start_request("query")
            with root:
                PeerClient().grpc_unary("7", "raft.send", ch, "/protos.Worker/RaftMessage",
                                        encode_payload(frame_raft(2, b"f")), budget=30)
        assert srv.cluster.got == [(2, b"f")]
        spans = rec.trace(root.trace_id)["spans"]
        legs = [s for s in spans if s["name"] == "peer.raft-message"]
        assert legs and legs[0]["attrs"]["node"] == "7" and legs[0]["attrs"]["group"] == 2
        assert all(s["trace_id"] == root.trace_id for s in spans)
    finally:
        gsrv.stop()
