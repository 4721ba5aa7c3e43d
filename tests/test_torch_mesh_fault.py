"""The elastic mesh fault domain on the port (``mesh/fault.py``): chip
loss is a capacity event, not a route event.  One case for each case of
the reference's ``tests/test_mesh_fault.py``; its compile-count case has
no counterpart here (torch compiles nothing), and
``test_warm_shapes_stay_bounded`` holds the fault domain's record of
served shapes (``note_shape``) bounded instead.

A server here drives a mesh of 8 CPU shards with every predicate
sharded; bodies are compared byte for byte with the reference's
unsharded engine (``dgraph_tpu.query.QueryEngine``) over the same
data."""

import json
import time
import urllib.request

import numpy as np
import pytest

from dgraph_tpu.models import PostingStore as JaxStore
from dgraph_tpu.query import QueryEngine as JaxEngine
from dgraph_tpu_torch.mesh import fault as mesh_fault
from dgraph_tpu_torch.models import PostingStore
from dgraph_tpu_torch.parallel import make_mesh
from dgraph_tpu_torch.sched import segments
from dgraph_tpu_torch.serve.server import DgraphServer
from dgraph_tpu_torch.utils import devguard
from dgraph_tpu_torch.utils.failpoints import FailpointError, _Action, fail
from tests.torch_parity import REFERENCE_ENV
from torch_pins import pinned_planner  # noqa: F401

pytestmark = [pytest.mark.usefixtures("pinned_planner"), pytest.mark.chaos]


def _post(addr, path, body):
    req = urllib.request.Request(addr + path, data=body.encode(), method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read().decode())


_DATA = None


def _dataset(n=120, seed=3):
    global _DATA
    if _DATA is None:
        rng = np.random.default_rng(seed)
        lines = [f'<0x{i:x}> <name> "node {i}" .' for i in range(1, n + 1)]
        for i in range(1, n + 1):
            for d in rng.integers(1, n + 1, size=4):
                lines.append(f"<0x{i:x}> <link> <0x{d:x}> .")
        _DATA = (
            "mutation { schema { name: string @index(term) . "
            "link: uid @reverse @count . } set { %s } }" % "\n".join(lines)
        )
    return _DATA


QUERIES = [
    "{ q(func: uid(0x1)) { name link { name link { name } } } }",
    "{ q(func: uid(0x2, 0x3, 0x5)) { link @filter(ge(count(link), 1)) { _uid_ } } }",
    "{ q(func: uid(0x4)) { count(link) count(~link) } }",
    "{ q(func: uid(0x1)) @recurse(depth: 3) { name link } }",
]
CHAIN = ("{ var(func: uid(0x1, 0x2, 0x3)) { link { link { f as link } } } "
         "q(func: uid(f)) { count() } }")

_REF = None


def _reference():
    """Each of ``QUERIES`` and ``CHAIN``'s body from the reference's
    unsharded engine over ``_dataset()``."""
    global _REF
    if _REF is None:
        with pytest.MonkeyPatch.context() as mp:
            for k, v in REFERENCE_ENV.items():
                mp.setenv(k, v)
            eng = JaxEngine(JaxStore())
            eng.run(_dataset())
            _REF = {q: eng.run(q) for q in QUERIES + [CHAIN]}
    return _REF


def _boot(monkeypatch, width=8, **env):
    monkeypatch.setenv("DGRAPH_TPU_MESH_SHARD_ROWS", "1")
    monkeypatch.setenv("DGRAPH_TPU_CACHE", "0")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    devguard.reset_for_tests()
    mesh = make_mesh(devices=["cpu"] * width)
    srv = DgraphServer(PostingStore(), device="cpu", mesh=mesh)
    srv.engine.expand_device_min = 1
    srv.start()
    _post(srv.addr, "/query", _dataset())
    return srv


def _ask(srv, q):
    out = _post(srv.addr, "/query", q)
    out.pop("server_latency", None)
    return out


def _until(cond, secs=15.0, every=0.05):
    deadline = time.monotonic() + secs
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(every)
    return False


def _stop(*srvs):
    fail.reset()
    devguard.reset_for_tests()
    for s in srvs:
        s.stop()


# -- grammar / attribution (no server) ------------------------------------------


def test_chip_selector_grammar():
    a = _Action.parse("error(p=1,n=1,chip=3)")
    assert (a.kind, a.n, a.chip) == ("error", 1, 3)
    a = _Action.parse("xla_oom(chip=0)")
    assert (a.kind, a.chip) == ("xla_oom", 0)
    assert _Action.parse("error(n=2)").chip == -1
    for bad in ("crash(chip=1)", "hang(chip=2,ms=10)", "delay(chip=0)"):
        with pytest.raises(ValueError):
            _Action.parse(bad)
    fp = fail.__class__(seed=0)
    fp.arm("t.site", "error(chip=5)")
    with pytest.raises(OSError) as ei:
        fp.point("t.site")
    assert "chip=5" in str(ei.value)
    assert devguard.chip_of(ei.value) == 5
    wrapped = devguard.DeviceFaultError("mesh", "op", "transient", "x")
    wrapped.__cause__ = ei.value
    assert devguard.chip_of(wrapped) == 5
    assert devguard.chip_of(RuntimeError("no attribution")) is None
    # a fault on one of several distinct cards carries its chip
    # (classified as its cause is)
    cf = devguard.ChipFaultError(6, OSError("ECC"))
    cf.__cause__ = OSError("ECC")
    assert devguard.chip_of(cf) == 6
    assert devguard.classify(cf) == "transient"
    cf.__cause__ = ValueError("a shape bug")
    assert devguard.classify(cf) is None


# -- loss: the route stays sharded ------------------------------------------------


def test_chip_loss_stays_sharded_byte_identical(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_DEVICE_COOLDOWN_S", "60")
    meshed = _boot(monkeypatch)
    try:
        baseline = _reference()
        for q in QUERIES:
            assert _ask(meshed, q) == baseline[q]
        dom = meshed.engine.arenas.mesh_fault
        assert dom is not None and dom.width == 8
        fail.seed(0)
        fail.arm("device.mesh", "error(n=1,chip=3)")
        out = _ask(meshed, QUERIES[0])
        deg = out.pop("degraded")
        assert out == baseline[QUERIES[0]], "post-loss response diverged"
        assert deg["mesh"]["chips_healthy"] == 7, deg
        assert deg["mesh"]["chips_total"] == 8, deg
        assert "device" not in deg, deg  # the route stayed mesh
        assert devguard.get("mesh").state == devguard.HEALTHY
        assert meshed.engine.arenas.mesh is not dom.boot_mesh
        for q in QUERIES:
            out = _ask(meshed, q)
            out.pop("degraded", None)
            assert out == baseline[q]
        sh = meshed.engine.arenas._sharded
        assert sh and all(e[1].n_shards == 7 for e in sh.values())
        h = json.loads(urllib.request.urlopen(
            meshed.addr + "/health?detail=1", timeout=30).read())
        assert h["mesh"]["chips"]["3"] == "sick (evicted)", h["mesh"]
        assert h["mesh"]["chips_healthy"] == 7
        assert h["mesh"]["epoch"] == dom.epoch
    finally:
        _stop(meshed)


def test_staged_rejoin_restores_full_mesh(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_DEVICE_COOLDOWN_S", "0.2")
    srv = _boot(monkeypatch)
    try:
        baseline = _reference()
        for q in QUERIES:
            assert _ask(srv, q) == baseline[q]
        dom = srv.engine.arenas.mesh_fault
        epoch0 = dom.epoch
        reshards0 = dom.status()["reshards"]
        fail.seed(0)
        fail.arm("device.mesh", "error(n=1,chip=2)")
        out = _ask(srv, QUERIES[0])
        assert out.pop("degraded")["mesh"]["resumed"] >= 1
        assert out == baseline[QUERIES[0]]
        assert dom.status()["reshards"] >= reshards0 + 1
        assert _until(
            lambda: dom.width == 8
            and dom.status()["reshards"] >= reshards0 + 2
        ), f"rejoin never converged: {dom.status()}"
        assert dom.epoch > epoch0
        assert dom.mesh is dom.boot_mesh
        for q in QUERIES:
            out = _ask(srv, q)
            assert "degraded" not in out, out.get("degraded")
            assert out == baseline[q]
        assert dom.status()["chips"]["2"] == "healthy"
    finally:
        _stop(srv)


def test_flapping_chip_never_cuts_over(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_DEVICE_COOLDOWN_S", "0.2")
    srv = _boot(monkeypatch)
    try:
        baseline = _reference()[QUERIES[0]]
        assert _ask(srv, QUERIES[0]) == baseline
        dom = srv.engine.arenas.mesh_fault
        fail.seed(0)
        fail.arm("mesh.warm", "error")
        fail.arm("device.mesh", "error(n=1,chip=5)")
        out = _ask(srv, QUERIES[0])
        assert out.pop("degraded")["mesh"]["chips_healthy"] == 7
        assert out == baseline
        epoch7 = dom.epoch
        assert _until(lambda: fail.hits("mesh.warm") >= 2), dom.status()
        assert dom.width == 7 and dom.epoch == epoch7, dom.status()
        out = _ask(srv, QUERIES[0])
        assert out.pop("degraded")["mesh"]["chips_healthy"] == 7
        assert out == baseline
        fail.disarm("mesh.warm")
        assert _until(lambda: dom.width == 8), dom.status()
        out = _ask(srv, QUERIES[0])
        assert "degraded" not in out and out == baseline
    finally:
        _stop(srv)


def test_sequential_double_loss_converges(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_DEVICE_COOLDOWN_S", "60")
    srv = _boot(monkeypatch)
    try:
        baseline = _reference()
        dom = srv.engine.arenas.mesh_fault
        fail.seed(0)
        for chip, left in ((3, 7), (5, 6)):
            fail.arm("device.mesh", f"error(n=1,chip={chip})")
            out = _ask(srv, QUERIES[0])
            deg = out.pop("degraded")
            assert out == baseline[QUERIES[0]]
            assert deg["mesh"]["chips_healthy"] == left, deg
            assert "device" not in deg, deg
        assert dom.width == 6
        for q in QUERIES:
            out = _ask(srv, q)
            out.pop("degraded", None)
            assert out == baseline[q]
        sh = srv.engine.arenas._sharded
        assert sh and all(e[1].n_shards == 6 for e in sh.values())
        st = dom.status()
        assert st["chips"]["3"] == "sick (evicted)"
        assert st["chips"]["5"] == "sick (evicted)"
        assert devguard.get("mesh").state == devguard.HEALTHY
    finally:
        _stop(srv)


# -- drain-and-resume ---------------------------------------------------------


def _segmented(monkeypatch):
    return _boot(
        monkeypatch, DGRAPH_TPU_DEVICE_COOLDOWN_S="60",
        DGRAPH_TPU_SEGMENT="force", DGRAPH_TPU_SEGMENT_K="1",
    )


def test_segmented_query_resumes_after_losing_its_chip(monkeypatch):
    srv = _segmented(monkeypatch)
    try:
        ex = srv.engine.arenas.mesh_executor()
        dom = srv.engine.arenas.mesh_fault
        src = np.array([1, 2, 3], dtype=np.int64)
        cap = 1024
        fs0, tot0 = ex.multi_hop("link", False, src, 3, cap, {})
        assert dom.width == 8
        fail.seed(0)
        fail.arm("device.mesh", "error(n=1,after=1,chip=2)")
        stats = {}
        prev = segments.activate(segments.SegmentContext(stats=stats))
        try:
            fs1, tot1 = ex.multi_hop("link", False, src, 3, cap, stats)
        finally:
            segments.deactivate(prev)
        assert np.array_equal(fs1, fs0) and np.array_equal(tot1, tot0)
        assert dom.width == 7
        assert stats["mesh_degraded"]["resumed"] >= 1, stats
        assert stats.get("resumed", {}).get("loss", 0) >= 1, stats
        assert stats.get("device_failover", 0) == 0, stats
        # served: the fused chain's segments resume past a second loss
        srv.engine.chain_threshold = 0
        fail.arm("device.mesh", "error(n=1,after=1,chip=5)")
        out = _post(srv.addr, "/query?debug=true", CHAIN)
        eng = out.pop("server_latency")["engine"]
        deg = out.pop("degraded")
        assert out == _reference()[CHAIN]
        assert eng["chain_fused_levels"] == 3, eng.get("chain_reject")
        assert deg["mesh"]["chips_healthy"] == 6 and "device" not in deg, deg
        assert deg["mesh"]["resumed"] >= 1, deg
    finally:
        _stop(srv)


def test_segmented_query_resumes_across_epoch_flip_at_seam(monkeypatch):
    srv = _segmented(monkeypatch)
    try:
        ex = srv.engine.arenas.mesh_executor()
        dom = srv.engine.arenas.mesh_fault
        src = np.array([1, 2, 3], dtype=np.int64)
        cap = 1024
        fs0, tot0 = ex.multi_hop("link", False, src, 3, cap, {})
        flipped = []

        def flip_once():
            # fires inside segments.seam(), between two segments of the
            # in-flight query: where a concurrent loss lands
            if not flipped:
                flipped.append(1)
                dom._sink("transient", "mesh.multi_hop",
                          FailpointError("concurrent loss (chip=4)"))

        stats = {}
        prev = segments.activate(
            segments.SegmentContext(preempt=flip_once, stats=stats)
        )
        try:
            fs1, tot1 = ex.multi_hop("link", False, src, 3, cap, stats)
        finally:
            segments.deactivate(prev)
        assert flipped and dom.width == 7
        assert np.array_equal(fs1, fs0) and np.array_equal(tot1, tot0)
        assert stats.get("resumed", {}).get("epoch", 0) >= 1, stats
    finally:
        _stop(srv)


def test_segmented_query_finishes_unsharded_after_a_wedge(monkeypatch):
    """A wedged segment (no chip to blame) latches the plane; the query's
    remaining hops finish on the unsharded multi-hop pass from the host
    carry, byte-identically, and the failover is counted."""
    srv = _segmented(monkeypatch)
    try:
        ex = srv.engine.arenas.mesh_executor()
        src = np.array([1, 2, 3], dtype=np.int64)
        cap = 1024
        fs0, tot0 = ex.multi_hop("link", False, src, 3, cap, {})
        devguard.get("mesh").hang_ms = 100
        fail.seed(0)
        fail.arm("device.mesh", "hang(ms=600,n=1,after=1)")
        stats = {}
        prev = segments.activate(segments.SegmentContext(stats=stats))
        try:
            fs1, tot1 = ex.multi_hop("link", False, src, 3, cap, stats)
        finally:
            segments.deactivate(prev)
        assert np.array_equal(fs1, fs0) and np.array_equal(tot1, tot0)
        assert stats.get("resumed", {}).get("hang", 0) == 1, stats
        assert stats.get("device_failover", 0) == 1, stats
        assert devguard.get("mesh").state == devguard.SICK
        time.sleep(0.6)  # let the wedged worker wake before teardown
    finally:
        _stop(srv)


# -- bounded shape record --------------------------------------------------------


def test_warm_shapes_stay_bounded(monkeypatch):
    """Repeat-shape queries after an epoch flip add no new shapes to the
    rejoin's warm set, and the set never outgrows its cap."""
    monkeypatch.setenv("DGRAPH_TPU_DEVICE_COOLDOWN_S", "60")
    srv = _boot(monkeypatch)
    try:
        dom = srv.engine.arenas.mesh_fault
        for q in QUERIES:
            _ask(srv, q)
        fail.seed(0)
        fail.arm("device.mesh", "error(n=1,chip=1)")
        _ask(srv, QUERIES[0])
        assert dom.width == 7
        for q in QUERIES:
            _ask(srv, q)
        shapes = dict(dom._shapes)
        for q in QUERIES:
            _ask(srv, q)
        assert dom._shapes == shapes
        for n in range(40):
            dom.note_shape("hop", 8 << n, 1)
        assert len(dom._shapes) == mesh_fault._WARM_CAP
    finally:
        _stop(srv)


# -- observability / gate --------------------------------------------------------


def test_mesh_metrics_and_scrape_surface(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_DEVICE_COOLDOWN_S", "0.2")
    srv = _boot(monkeypatch)
    try:
        dom = srv.engine.arenas.mesh_fault
        fail.seed(0)
        fail.arm("device.mesh", "error(n=1,chip=6)")
        _ask(srv, QUERIES[0])
        assert _until(lambda: dom.width == 8), dom.status()
        text = urllib.request.urlopen(srv.addr + "/metrics", timeout=30).read().decode()
        assert 'dgraph_mesh_reshard_total{reason="loss"}' in text
        assert 'dgraph_mesh_reshard_total{reason="rejoin"}' in text
        assert "dgraph_mesh_epoch" in text
        assert "dgraph_mesh_chips_healthy 8" in text
        assert "dgraph_mesh_reshard_seconds" in text
        assert "dgraph_query_resumed_total" in text
    finally:
        _stop(srv)


def test_elastic_off_restores_plane_latch(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_DEVICE_COOLDOWN_S", "60")
    monkeypatch.setenv("DGRAPH_TPU_MESH_ELASTIC", "0")
    srv = _boot(monkeypatch)
    try:
        assert srv.engine.arenas.mesh_fault is None
        baseline = _reference()[QUERIES[0]]
        fail.seed(0)
        fail.arm("device.mesh", "error(n=1,chip=3)")
        out = _ask(srv, QUERIES[0])
        deg = out.pop("degraded")
        assert out == baseline
        assert deg["device"]["failovers"] >= 1, deg
        assert "mesh" not in deg, deg
        assert int(srv.engine.arenas.mesh.shape["model"]) == 8
    finally:
        _stop(srv)


def test_grpc_trailer_carries_the_mesh_epoch(monkeypatch):
    grpc = pytest.importorskip("grpc")
    from dgraph_tpu_torch.serve import grpc_server as tg

    monkeypatch.setenv("DGRAPH_TPU_DEVICE_COOLDOWN_S", "60")
    srv = _boot(monkeypatch)
    g = tg.GrpcServer(srv, port=0)
    g.start()
    try:
        dom = srv.engine.arenas.mesh_fault
        fail.seed(0)
        fail.arm("device.mesh", "error(n=1,chip=4)")
        with grpc.insecure_channel(f"127.0.0.1:{g.port}") as ch:
            _resp, call = ch.unary_unary("/protos.Dgraph/Run").with_call(
                tg.encode_request(QUERIES[0]), timeout=30
            )
        md = dict(call.trailing_metadata())
        assert md["dgraph-mesh-epoch"] == str(dom.epoch)
        assert json.loads(md["dgraph-degraded"])["mesh"]["chips_healthy"] == 7
    finally:
        g.stop()
        _stop(srv)
