"""The port's per-query resource ledger and device telemetry
(``dgraph_tpu_torch/obs/ledger.py``, ``obs/device.py``): the cases of
tests/test_ledger.py on port servers (``device="cpu"``), and the
ledger's rendering held against the reference's for the same query.

- the ledger's ``dgraph_edges_traversed_total`` per-tenant series
  reconciles EXACTLY with the engine's own stats on a pinned query;
- ``DGRAPH_TPU_LEDGER=0`` is byte-identical through the full serving
  path (scheduler + cache + QoS armed);
- warm requests allocate zero ledger structs beyond the pool
  (``dgraph_ledger_structs_total``).
"""

import json
import urllib.request

import pytest

from dgraph_tpu import obs as jobs
from dgraph_tpu.models import PostingStore as JPostingStore
from dgraph_tpu.serve.server import DgraphServer as JDgraphServer
from dgraph_tpu_torch import obs
from dgraph_tpu_torch.models import PostingStore
from dgraph_tpu_torch.obs import ledger as ledgermod
from dgraph_tpu_torch.serve.server import DgraphServer
from dgraph_tpu_torch.utils.metrics import (
    EDGES_TRAVERSED,
    LEDGER_HOPS,
    LEDGERS_CREATED,
)
from torch_pins import pinned_planner  # noqa: F401

# every route decision of both planners is pinned (tests/torch_pins.py)
pytestmark = pytest.mark.usefixtures("pinned_planner")

SEED = """
mutation {
  schema { name: string . follows: uid . }
  set {
    <0x1> <name> "Alice" .
    <0x2> <name> "Bob" .
    <0x3> <name> "Carol" .
    <0x1> <follows> <0x2> .
    <0x1> <follows> <0x3> .
    <0x2> <follows> <0x3> .
  }
}
"""


@pytest.fixture(autouse=True)
def _recorder_reset():
    yield
    obs.configure()
    jobs.configure()


def _post(addr, path, body, headers=None):
    req = urllib.request.Request(addr + path, data=body.encode(), method="POST")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read().decode())


def _get(addr, path):
    with urllib.request.urlopen(addr + path, timeout=30) as r:
        return json.loads(r.read().decode())


def _boot(monkeypatch, cache="0", **env):
    monkeypatch.setenv("DGRAPH_TPU_SCHED", "1")
    monkeypatch.setenv("DGRAPH_TPU_CACHE", cache)
    monkeypatch.setenv("DGRAPH_TPU_QOS", "1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    server = DgraphServer(PostingStore(), device="cpu")
    server.start()
    _post(server.addr, "/query", SEED)
    return server


@pytest.fixture()
def srv(monkeypatch):
    """Caches OFF so every query runs the engine."""
    server = _boot(monkeypatch)
    yield server
    server.stop()


# ------------------------------------------------------------- reconcile


def test_ledger_reconciles_with_engine_stats_exact(srv):
    """0x1 has 2 ``follows`` edges; level 2 expands 0x2→0x3, 0x3→none:
    3 edges in the ledger, the engine's stats and the tenant series."""
    before = EDGES_TRAVERSED.snapshot().get("default", 0)
    out = _post(
        srv.addr, "/query?ledger=true&debug=true",
        "{ q(func: uid(0x1)) { follows { follows { uid } } } }",
    )
    led = out["extensions"]["ledger"]
    eng = out["server_latency"]["engine"]
    assert led["edges"] == eng["edges"] == 3
    assert EDGES_TRAVERSED.snapshot().get("default", 0) - before == 3
    assert sum(led["hops"].values()) >= 2


def test_ledger_tenant_scoped_series(srv):
    before = EDGES_TRAVERSED.snapshot().get("acme", 0)
    _post(srv.addr, "/query", "{ q(func: uid(0x1)) { follows { uid } } }",
          headers={"X-Dgraph-Tenant": "acme"})
    assert EDGES_TRAVERSED.snapshot().get("acme", 0) - before == 2


# ------------------------------------------------------ zero-overhead guard


def test_warm_requests_allocate_zero_ledger_structs(srv):
    q = "{ q(func: uid(0x1)) { follows { uid } } }"
    _post(srv.addr, "/query", q)  # warm the pool
    before = LEDGERS_CREATED.value()
    for _ in range(16):
        _post(srv.addr, "/query", q)
    assert LEDGERS_CREATED.value() == before, (
        "warm serial requests constructed new Ledger structs"
    )


def test_ledger_off_is_byte_identical_and_allocation_free(monkeypatch):
    qs = [
        "{ q(func: uid(0x1)) { follows { name } } }",
        "{ q(func: has(follows)) { name } }",
        "{ q(func: uid(0x1)) { c: count(follows) } }",
    ]

    def serve(flag):
        server = _boot(monkeypatch, cache="1", DGRAPH_TPU_LEDGER=flag)
        try:
            out = []
            for q in qs:
                for _ in range(2):  # the second pass exercises the caches
                    r = _post(server.addr, "/query", q)
                    r.pop("server_latency", None)
                out.append(r)
            return out
        finally:
            server.stop()

    on = serve("1")
    before = LEDGERS_CREATED.value()
    off = serve("0")
    assert off == on
    assert LEDGERS_CREATED.value() == before
    server = _boot(monkeypatch, DGRAPH_TPU_LEDGER="0")
    try:
        r = _post(server.addr, "/query?ledger=true",
                  "{ q(func: uid(0x1)) { follows { uid } } }")
        assert "extensions" not in r
    finally:
        server.stop()


def test_default_responses_carry_no_ledger_key(srv):
    r = _post(srv.addr, "/query", "{ q(func: uid(0x1)) { follows { uid } } }")
    assert "extensions" not in r


# -------------------------------------------------------- route accounting


def test_cache_hit_accounting(monkeypatch):
    server = _boot(monkeypatch, cache="1")
    try:
        q = "{ q(func: uid(0x1)) { follows { uid } } }"
        led1 = _post(server.addr, "/query?ledger=true", q)["extensions"]["ledger"]
        assert led1["edges"] > 0
        led2 = _post(server.addr, "/query?ledger=true", q)["extensions"]["ledger"]
        assert led2["cache_hits"] >= 1
        assert led2["edges"] == 0  # no engine work
    finally:
        server.stop()


def test_hops_by_route_and_metric_family(srv):
    before = dict(LEDGER_HOPS.snapshot())
    _post(srv.addr, "/query",
          "{ q(func: uid(0x1)) { follows { follows { uid } } } }")
    after = LEDGER_HOPS.snapshot()
    delta = {
        k: after.get(k, 0) - before.get(k, 0)
        for k in after if after.get(k, 0) != before.get(k, 0)
    }
    assert sum(delta.values()) >= 2, delta
    assert set(delta) <= {
        "cache", "merged", "host", "resident", "csr", "chain", "mxu", "empty",
    }, delta


def test_sampled_trace_carries_ledger_attr(srv):
    obs.configure(ratio=1.0, seed=7)
    _post(srv.addr, "/query", "{ q(func: uid(0x1)) { follows { uid } } }")
    traces = _get(srv.addr, "/debug/traces")
    assert traces
    t = _get(srv.addr, f"/debug/traces/{traces[-1]['trace_id']}")
    roots = [s for s in t["spans"] if s["parent_id"] is None]
    assert roots and "ledger" in roots[0]["attrs"]
    assert roots[0]["attrs"]["ledger"]["edges"] == 2


def test_ledger_rendering_matches_reference(monkeypatch):
    """The same request on a port and a reference server: the ledger's
    keys and counts agree (times and staged bytes are each engine's
    own)."""
    monkeypatch.setenv("DGRAPH_TPU_CACHE", "1")
    port = _boot(monkeypatch, cache="1")
    ref = JDgraphServer(JPostingStore())
    ref.start()
    try:
        _post(ref.addr, "/query", SEED)
        q = "{ q(func: uid(0x1)) { follows { follows { uid } } } }"
        for _ in range(2):  # cold, then a tier-2 hit
            a = _post(port.addr, "/query?ledger=true", q)["extensions"]["ledger"]
            b = _post(ref.addr, "/query?ledger=true", q)["extensions"]["ledger"]
            assert list(a) == list(b)
            for k in ("edges", "cache_hits", "coalesced", "repairs"):
                assert a[k] == b[k], k
    finally:
        port.stop()
        ref.stop()


# --------------------------------------------------------- device telemetry


def test_debug_device_snapshot(srv):
    _post(srv.addr, "/query", "{ q(func: uid(0x1)) { follows { uid } } }")
    d = _get(srv.addr, "/debug/device")
    assert d["backend"] == "cpu" and d["device_name"] == "cpu"
    assert d["devices"] >= 1
    res = d["arenas"]
    assert res["resident_bytes"] == srv.engine.arenas._lru_total > 0
    assert set(res["program_caches"]) == {
        "classed_expanders", "classed_programs", "tile_sets",
    }
    assert set(d["compiles"]) == {"total", "seconds_sum", "builds"}


def test_kernel_builds_counted_as_compiles(monkeypatch):
    """A kernel-library build at first use lands in the reference's
    compile families and on the building request's ledger."""
    from dgraph_tpu_torch.ops import _build
    from dgraph_tpu_torch.utils.metrics import XLA_COMPILES

    n0 = XLA_COMPILES.value()
    led = ledgermod.start("t")
    tok = ledgermod.activate(led)
    monkeypatch.setattr(_build, "built", [])
    try:
        _build._note_build("unit_lib", 0.5)
    finally:
        ledgermod.deactivate(tok)
    assert led.compiles == 1
    ledgermod.finish(led)
    assert XLA_COMPILES.value() == n0 + 1
    assert obs.device.builds() == {"unit_lib": 1}


def test_debug_bundle_is_one_consistent_postmortem(srv):
    _post(srv.addr, "/query", "{ q(func: uid(0x1)) { follows { uid } } }")
    b = _get(srv.addr, "/debug/bundle")
    for key in (
        "generated_unix", "traces", "slow_queries", "planner", "qos",
        "ivm", "qcache", "device", "ledger",
    ):
        assert key in b, key
    assert b["ledger"]["structs_created"] >= 1
    assert "edges_by_tenant" in b["ledger"]
    # the planner section is the planner's own summary (/debug/planner)
    pl = b["planner"]
    assert set(pl) == set(_get(srv.addr, "/debug/planner"))
    assert pl["enabled"] is True
    assert pl["calibration"]["source"] == "pinned"
    assert pl["counts"].get("expand:host", 0) >= 1


def test_build_info_and_uptime_on_metrics(srv):
    with urllib.request.urlopen(srv.addr + "/metrics", timeout=30) as r:
        body = r.read().decode()
    assert 'dgraph_build_info{version="' in body
    assert 'backend="cpu"' in body and 'torch="' in body
    up = [l for l in body.splitlines() if l.startswith("dgraph_uptime_seconds ")]
    assert up and float(up[0].split()[1]) > 0


def test_ledger_pool_roundtrip_unit():
    led = ledgermod.start("t1")
    assert led is not None
    led.edges = 5
    led.note_hop("host")
    before = EDGES_TRAVERSED.snapshot().get("t1", 0)
    summary = ledgermod.finish(led)
    assert summary["edges"] == 5
    assert EDGES_TRAVERSED.snapshot().get("t1", 0) - before == 5
    again = ledgermod.start("t2")
    assert again.edges == 0 and not again.hops
    ledgermod.finish(again)
