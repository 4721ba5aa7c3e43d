"""The port's device fault domain (``dgraph_tpu_torch/utils/devguard.py``)
against the reference's (``dgraph_tpu/utils/devguard.py``).

- The reference's cases that do not use its host failover, run through
  both packages' guards: the classifier, suspect → sick → the probe
  re-admits, a hang latches sick and abandons its worker, a failed probe
  re-opens the cooldown, non-device errors are never masked, the guard
  off runs inline, contextvars reach the worker, the ``xla_oom`` and
  ``hang`` failpoints.  The port's classifier cases: a CUDA OOM, an
  accelerator error, a failed kernel launch with code 2 and with
  another code, and a shape bug's ``RuntimeError`` left unclassified.
- Engines of both packages over the same graph, with the same op and
  failpoint sequence: the same state transitions, fault, probe and
  eviction counts, and byte-identical bodies wherever both answer.  An
  OOM evicts the LRU and retries once in both; a hang latches both sick,
  the reference answers from the host, the port raises, and both answer
  again after re-admission.
- Port-only, in place of the reference's failover cases: a wedged
  dispatch answers 503 with ``Retry-After`` and the scheduler serves
  again after re-admission; a sick domain makes the chain and tile
  routes raise; the ``/health?detail=1`` device section and
  ``/debug/device``'s ``guard``; LRU eviction racing an in-flight expand
  (the evicted arena stays alive while the expand holds it).

Every wait is bounded; no wall-clock assertion is tighter than whole
seconds.  Hangs use ``hang_ms`` 100-200 against ``hang(ms≈1500)``.
"""

import contextvars
import gc
import json
import sys
import threading
import time
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest
import torch

from dgraph_tpu.models import PostingStore as JaxStore
from dgraph_tpu.query import QueryEngine as JaxEngine
from dgraph_tpu.utils import devguard as jdevguard
from dgraph_tpu.utils import failpoints as jfailpoints
from dgraph_tpu.utils.metrics import DEVICE_FAILOVER as J_DEVICE_FAILOVER
from dgraph_tpu_torch.models import PostingStore
from dgraph_tpu_torch.ops._build import KernelLaunchError
from dgraph_tpu_torch.query import QueryEngine
from dgraph_tpu_torch.serve.server import DgraphServer
from dgraph_tpu_torch.utils import devguard
from dgraph_tpu_torch.utils import failpoints as tfailpoints
from dgraph_tpu_torch.utils.metrics import DEVICE_FAILOVER

from torch_pins import pinned_planner  # noqa: F401

# every route decision of both planners is pinned, and both packages'
# guards and failpoints start fresh (tests/torch_pins.py)
pytestmark = pytest.mark.usefixtures("pinned_planner")

# package -> (devguard module, failpoints module, evict-retry counter)
PACKAGES = {
    "reference": (jdevguard, jfailpoints, J_DEVICE_FAILOVER),
    "port": (devguard, tfailpoints, DEVICE_FAILOVER),
}
BOTH = pytest.mark.parametrize("pkg", sorted(PACKAGES))


def _wait(cond, timeout=10.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return False


def _boom():
    raise OSError("injected")


# ------------------------------------------------------------ classifier


@BOTH
@pytest.mark.parametrize("exc, kind", [
    (OSError("boom"), "transient"),
    (ValueError("shape bug"), None),
    (IndexError("index 9 out of range"), None),
])
def test_classifier_shared_cases(pkg, exc, kind):
    dg = PACKAGES[pkg][0]
    assert dg.classify(exc) == kind


@pytest.mark.parametrize("exc, kind", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory."), "oom"),
    (KernelLaunchError("gather.dg_gather", 2), "oom"),
    (KernelLaunchError("gather.dg_gather", 700), "transient"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "transient"),
    (RuntimeError("shape '[4, 3]' is invalid for input of size 10"), None),
    (RuntimeError("out of memory in my own bookkeeping"), None),
    (devguard.DeviceHangError("device", "op", 5.0), "hang"),
])
def test_classifier_torch_cases(exc, kind):
    assert devguard.classify(exc) == kind


@pytest.mark.skipif(
    getattr(torch, "AcceleratorError", None) is None,
    reason="this torch has no AcceleratorError",
)
def test_classifier_accelerator_error():
    exc = torch.AcceleratorError.__new__(torch.AcceleratorError)
    assert devguard.classify(exc) == "transient"


@BOTH
def test_xla_oom_failpoint_classifies_as_oom(pkg):
    dg, fp, _m = PACKAGES[pkg]
    fp.fail.arm("site.x", "xla_oom(n=1)")
    with pytest.raises(BaseException) as ei:
        fp.fail.point("site.x")
    assert dg.classify(ei.value) == "oom"
    fp.fail.point("site.x")  # n-cap spent: no-op


def test_port_injected_oom_is_the_allocators_class():
    tfailpoints.fail.arm("site.x", "xla_oom(n=1)")
    with pytest.raises(torch.cuda.OutOfMemoryError):
        tfailpoints.fail.point("site.x")


@BOTH
def test_hang_failpoint_sleeps(pkg):
    _dg, fp, _m = PACKAGES[pkg]
    fp.fail.arm("site.h", "hang(ms=80,n=1)")
    t0 = time.monotonic()
    fp.fail.point("site.h")
    assert time.monotonic() - t0 >= 0.07
    assert fp.fail.hits("site.h") == 1


# ------------------------------------------------------- guard state machine


@BOTH
def test_suspect_then_sick_then_probe_readmits(pkg):
    dg = PACKAGES[pkg][0]
    g = dg.DeviceGuard("t", hang_ms=2000, cooldown_s=0.05, sick_after=2)
    states = [g.state]
    with pytest.raises(dg.DeviceFaultError):
        g.run("op", _boom)
    states.append(g.state)
    assert g.run("op", lambda: 1) == 1  # a success resets the walk
    states.append(g.state)
    for _ in range(2):
        with pytest.raises(dg.DeviceFaultError):
            g.run("op", _boom)
        states.append(g.state)
    with pytest.raises(dg.DeviceSickError):
        g.run("op", lambda: 1)  # shed without dispatch
    assert _wait(lambda: g.state == "healthy")
    states.append(g.state)
    assert states == [
        "healthy", "suspect", "healthy", "suspect", "sick", "healthy",
    ]
    st = g.status()
    assert st["readmissions"] == 1 and st["probes_ok"] == 1
    assert st["faults"] == {"transient": 3}
    assert g.run("op", lambda: 2) == 2


@BOTH
def test_hang_latches_sick_and_abandons_the_worker(pkg):
    dg = PACKAGES[pkg][0]
    g = dg.DeviceGuard("t", hang_ms=150, cooldown_s=10.0, sick_after=3)
    t0 = time.monotonic()
    with pytest.raises(dg.DeviceHangError):
        g.run("op", lambda: time.sleep(1.5) or 7)
    assert time.monotonic() - t0 < 1.5, "the watchdog did not bound the wait"
    assert g.state == "sick"
    assert g.status()["wedged_workers"] == 1
    assert g.faults.get("hang") == 1


@BOTH
def test_probe_failure_reopens_cooldown(pkg):
    dg = PACKAGES[pkg][0]
    bad = {"on": True}

    def probe():
        if bad["on"]:
            raise OSError("still wedged")

    g = dg.DeviceGuard(
        "t", hang_ms=2000, cooldown_s=0.03, sick_after=1, probe_fn=probe
    )
    with pytest.raises(dg.DeviceFaultError):
        g.run("op", _boom)
    assert g.state == "sick"
    assert _wait(lambda: g.status()["probes_failed"] >= 1)
    assert g.state == "sick"
    bad["on"] = False
    assert _wait(lambda: g.state == "healthy")


@BOTH
def test_non_device_errors_never_masked(pkg):
    dg = PACKAGES[pkg][0]
    g = dg.DeviceGuard("t", hang_ms=2000, cooldown_s=1.0)

    def shape_bug():
        raise ValueError("shape bug")

    with pytest.raises(ValueError, match="shape bug"):
        g.run("op", shape_bug)
    assert g.state == "healthy" and g.faults == {}


def test_port_shape_bug_runtime_error_never_masked():
    g = devguard.DeviceGuard("t", hang_ms=2000, cooldown_s=1.0)

    def shape_bug():
        torch.zeros(10).reshape(4, 3)

    with pytest.raises(RuntimeError) as ei:
        g.run("op", shape_bug)
    assert not isinstance(ei.value, devguard.DeviceFaultError)
    assert g.state == "healthy" and g.faults == {}


@BOTH
def test_guard_disabled_is_inline_passthrough(pkg, monkeypatch):
    dg = PACKAGES[pkg][0]
    monkeypatch.setenv("DGRAPH_TPU_DEVGUARD", "0")
    g = dg.DeviceGuard("t", hang_ms=1, cooldown_s=1.0)
    assert g.run("op", threading.get_ident) == threading.get_ident()
    with pytest.raises(OSError):
        g.run("op", _boom)
    assert g.state == "healthy"


@BOTH
def test_contextvars_propagate_to_guard_worker(pkg):
    dg = PACKAGES[pkg][0]
    v = contextvars.ContextVar("v", default="unset")
    v.set("request-scoped")
    g = dg.DeviceGuard("t", hang_ms=2000, cooldown_s=1.0)
    assert g.run("op", v.get) == "request-scoped"
    # and the closure runs on a worker, not on the caller
    assert g.run("op", threading.get_ident) != threading.get_ident()


@BOTH
def test_concurrent_runs_count_every_fault(pkg):
    """Many threads through one guard at once, a short switch interval:
    every fault is counted once and every success returns its own
    value (a lost update in the state machine would break either)."""
    dg = PACKAGES[pkg][0]
    g = dg.DeviceGuard("t", hang_ms=10_000, cooldown_s=60, sick_after=1 << 30)
    n_threads, per = 16, 40
    got, faults, errs = [], [], []
    lock = threading.Lock()

    def worker(k):
        for i in range(per):
            try:
                if i % 5 == 0:
                    g.run("op", _boom)
                else:
                    v = g.run("op", lambda k=k, i=i: (k, i))
                    with lock:
                        got.append(v == (k, i))
            except dg.DeviceFaultError:
                with lock:
                    faults.append(1)
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append(repr(e))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=worker, args=(k,)) for k in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert not errs, errs[:3]
    assert len(faults) == n_threads * per // 5
    assert g.faults == {"transient": len(faults)}
    assert len(got) == n_threads * per - len(faults) and all(got)
    assert g.state in ("healthy", "suspect")


def test_reset_closes_probe_loop_and_idle_workers():
    g = devguard.get()
    g.run("op", lambda: None)  # one idle worker in the pool
    g.note_fault("hang", "test")  # latch sick: the probe loop starts
    names = {t.name for t in threading.enumerate()}
    assert "dgraph-devguard-device" in names
    devguard.reset_for_tests()
    assert _wait(lambda: not any(
        t.name.startswith("dgraph-devguard-device")
        for t in threading.enumerate()
    ))
    assert devguard.summary() == {}


def test_retry_after_is_the_cooldown_ceiling(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_DEVICE_COOLDOWN_S", "2.5")
    devguard.reset_for_tests()
    devguard.get()
    assert devguard.retry_after_s() == 3
    devguard.reset_for_tests()
    monkeypatch.setenv("DGRAPH_TPU_DEVICE_COOLDOWN_S", "0.1")
    devguard.get()
    assert devguard.retry_after_s() == 1


# -------------------------------------------- engines of both packages


_N, _DEG = 40, 3
_SCHEMA = "name: string @index(term) .\nlink: [uid] @reverse @count ."
_Q = "{ q(func: uid(0x1)) { name link { name link { name } } } }"
_Q_REV = "{ q(func: uid(0x2)) { ~link { name } } }"


def _rdf():
    rng = np.random.default_rng(11)
    lines = [f'<0x{i:x}> <name> "node {i}" .' for i in range(1, _N + 1)]
    for i in range(1, _N + 1):
        for d in rng.integers(1, _N + 1, size=_DEG):
            lines.append(f"<0x{i:x}> <link> <0x{d:x}> .")
    return "\n".join(lines)


def _engine(pkg):
    """An engine over the seeded graph, every level device-routed, the
    chain pinned off and no hop cache, so each run dispatches every
    level through ``device.hop``."""
    rdf = _rdf()
    if pkg == "reference":
        eng = JaxEngine(JaxStore())
        eng.run("mutation { schema { %s } set { %s } }" % (_SCHEMA, rdf))
        eng.expand_device_min = 0
    else:
        eng = QueryEngine(PostingStore(), device="cpu")
        eng.run("mutation { schema { %s } set { %s } }" % (_SCHEMA, rdf))
        eng.expand_device_min = 1
    eng.chain_threshold = 1 << 62
    eng.arenas.hop_cache = None
    return eng


def _body(out):
    return {k: v for k, v in out.items() if k not in ("degraded", "server_latency")}


def _guard_view(dg):
    st = dg.get().status()
    return {k: st[k] for k in (
        "state", "faults", "probes_ok", "readmissions", "wedged_workers",
    )}


@BOTH
def test_oom_evicts_lru_and_retries_once(pkg):
    dg, fp, m = PACKAGES[pkg]
    eng = _engine(pkg)
    eng.run(_Q_REV)  # a second arena: the pressure valve has a victim
    baseline = eng.run(_Q)
    ev0 = eng.arenas.evictions
    r0 = m.snapshot().get("evict_retry", 0)
    states = []
    fp.fail.arm("device.hop", "xla_oom(n=1)")
    out = eng.run(_Q)
    states.append(dg.get().state)
    assert _body(out) == _body(baseline)
    assert eng.arenas.evictions > ev0, "the OOM evicted nothing"
    assert m.snapshot().get("evict_retry", 0) == r0 + 1
    assert fp.fail.hits("device.hop") >= 1
    assert _guard_view(dg)["faults"] == {"oom": 1}
    assert states == ["healthy"]  # suspect for the retry, then healthy


def test_oom_sequence_matches_reference():
    """The same op and failpoint sequence through both packages: equal
    bodies, equal evictions, equal guard state and counts."""
    seen = {}
    for pkg in ("reference", "port"):
        dg, fp, _m = PACKAGES[pkg]
        eng = _engine(pkg)
        bodies = [_body(eng.run(_Q_REV)), _body(eng.run(_Q))]
        ev0 = eng.arenas.evictions
        fp.fail.arm("device.hop", "xla_oom(n=1)")
        bodies.append(_body(eng.run(_Q)))
        bodies.append(_body(eng.run(_Q_REV)))
        seen[pkg] = (bodies, eng.arenas.evictions - ev0, _guard_view(dg))
    assert json.dumps(seen["port"][0]) == json.dumps(seen["reference"][0])
    assert seen["port"][1] == seen["reference"][1]
    assert seen["port"][2] == seen["reference"][2]


def test_oom_with_nothing_to_evict_raises():
    eng = _engine("port")
    eng.arenas.evict_for_oom(n=1 << 20)  # one arena is always kept
    assert len(eng.arenas._lru) <= 1
    tfailpoints.fail.arm("device.hop", "xla_oom(n=1)")
    with pytest.raises(devguard.DeviceFaultError) as ei:
        eng.run(_Q)
    assert ei.value.kind == "oom"


def test_second_oom_raises_after_one_retry():
    eng = _engine("port")
    eng.run(_Q_REV)
    eng.run(_Q)
    tfailpoints.fail.arm("device.hop", "xla_oom(n=2)")
    with pytest.raises(devguard.DeviceFaultError):
        eng.run(_Q)
    assert tfailpoints.fail.hits("device.hop") == 2
    assert devguard.get().faults == {"oom": 2}
    assert devguard.get().evict_retries == 1


def test_hang_sequence_matches_reference(monkeypatch):
    """A hang latches both packages' guards sick; the reference answers
    from its host route, the port raises; both answer the same bytes
    after re-admission, with the same fault and probe counts."""
    monkeypatch.setenv("DGRAPH_TPU_DEVICE_COOLDOWN_S", "0.2")
    seen = {}
    for pkg in ("reference", "port"):
        dg, fp, _m = PACKAGES[pkg]
        dg.reset_for_tests()
        eng = _engine(pkg)
        base = _body(eng.run(_Q))  # builds and compiles outside the window
        dg.get().hang_ms = 150
        fp.fail.arm("device.hop", "hang(ms=1500,n=1)")
        if pkg == "port":
            with pytest.raises(devguard.DeviceHangError):
                eng.run(_Q)
        else:
            assert _body(eng.run(_Q)) == base  # served from the host
        sick = dg.get().state
        assert _wait(lambda: dg.get().state == "healthy", timeout=15)
        after = _body(eng.run(_Q))
        assert after == base
        view = _guard_view(dg)
        seen[pkg] = (base, sick, view)
    assert json.dumps(seen["port"][0]) == json.dumps(seen["reference"][0])
    assert seen["port"][1] == seen["reference"][1] == "sick"
    assert seen["port"][2] == seen["reference"][2]


def test_guard_off_lets_faults_through_raw(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_DEVGUARD", "0")
    eng = _engine("port")
    base = eng.run(_Q)
    tfailpoints.fail.arm("device.hop", "hang(ms=60,n=1)")
    assert eng.run(_Q) == base  # blocks inline, then serves
    tfailpoints.fail.arm("device.hop", "xla_oom(n=1)")
    with pytest.raises(torch.cuda.OutOfMemoryError):
        eng.run(_Q)
    assert devguard.get().faults == {}  # nothing classified or counted


def test_failed_dispatch_is_no_planner_sample(monkeypatch):
    """A faulted expansion must not close its planner decision: the
    failed attempt is no rate sample for the device route."""
    from dgraph_tpu_torch.query import planner

    eng = _engine("port")
    eng.run(_Q)
    closed = []
    monkeypatch.setattr(
        planner, "note_outcome", lambda dec, us: closed.append(dec)
    )
    tfailpoints.fail.arm("device.hop", "error(n=1)")
    with pytest.raises(devguard.DeviceFaultError):
        eng.run(_Q)
    assert all(d is None for d in closed)
    assert eng.expander._expand_dec is None


# --------------------------------------------------------------- fused routes


_CHAIN_Q = (
    "{ v as var(func: uid(0x1)) { link { link { l2 as link } } } "
    "q(func: uid(v, l2), first: 3) { name } }"
)


def _fused_engine(monkeypatch, tile):
    monkeypatch.setenv("DGRAPH_TPU_MXU_JOIN", "force" if tile else "0")
    eng = _engine("port")
    eng.chain_threshold = 0
    return eng


@pytest.mark.parametrize("tile", [False, True], ids=["gather_chain", "tile"])
def test_sick_domain_makes_fused_routes_raise(monkeypatch, tile):
    eng = _fused_engine(monkeypatch, tile)
    base = eng.run(_CHAIN_Q)
    routes = eng.stats["join_routes"]
    if tile:
        assert any(r["route"] == "mxu" for r in routes), routes
    else:
        assert eng.stats["chain_fused_levels"] > 0
    devguard.get().note_fault("hang", "test")  # latch sick by hand
    with pytest.raises(devguard.DeviceSickError):
        eng.run(_CHAIN_Q)
    devguard.reset_for_tests()
    assert eng.run(_CHAIN_Q) == base


@pytest.mark.parametrize("site, tile", [
    ("device.multi_hop", False),
    ("device.spgemm", True),
])
def test_fused_oom_declines_to_per_level(monkeypatch, site, tile):
    eng = _fused_engine(monkeypatch, tile)
    base = _body(eng.run(_CHAIN_Q))
    tfailpoints.fail.arm(site, "xla_oom(n=1)")
    out = eng.run(_CHAIN_Q)
    assert _body(out) == base
    assert tfailpoints.fail.hits(site) == 1
    assert any("device oom" in r for r in eng.stats["chain_reject"])


@pytest.mark.parametrize("site, tile", [
    ("device.multi_hop", False),
    ("device.spgemm", True),
])
def test_fused_transient_fault_raises(monkeypatch, site, tile):
    eng = _fused_engine(monkeypatch, tile)
    eng.run(_CHAIN_Q)
    tfailpoints.fail.arm(site, "error(n=1)")
    with pytest.raises(devguard.DeviceFaultError) as ei:
        eng.run(_CHAIN_Q)
    assert ei.value.kind == "transient"


def test_kway_step_fault_raises(monkeypatch):
    from dgraph_tpu_torch.query import joinplan

    monkeypatch.setenv("DGRAPH_TPU_MXU_JOIN", "force")
    sets = [np.arange(0, 40, 2), np.arange(0, 40, 3)]
    assert list(joinplan.kway_intersect(sets, device="cpu")) == list(
        np.arange(0, 40, 6)
    )
    tfailpoints.fail.arm("device.spgemm", "xla_oom(n=1)")
    with pytest.raises(devguard.DeviceFaultError) as ei:
        joinplan.kway_intersect(sets, device="cpu")
    assert ei.value.kind == "oom"


# ----------------------------------------------------------- the server


def _server(**env):
    srv = DgraphServer(PostingStore(), device="cpu")
    srv.start()
    _post(srv.addr, "mutation { schema { %s } set { %s } }" % (_SCHEMA, _rdf()))
    srv.engine.expand_device_min = 1
    srv.engine.chain_threshold = 1 << 62
    srv.engine.arenas.hop_cache = None
    if srv.scheduler is not None:
        srv.scheduler.result_cache = None
    return srv


def _post(addr, text, timeout=30):
    req = urllib.request.Request(addr + "/query", data=text.encode())
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read().decode())


def _get(addr, path):
    with urllib.request.urlopen(addr + path, timeout=30) as r:
        return json.loads(r.read().decode())


def test_health_detail_and_debug_device_carry_the_guard():
    srv = _server()
    try:
        detail = _get(srv.addr, "/health?detail=1")
        assert detail["device"]["enabled"] is True
        _post(srv.addr, _Q)  # the first guarded dispatch registers it
        dom = _get(srv.addr, "/health?detail=1")["device"]["domains"]["device"]
        assert dom["state"] == "healthy"
        assert set(dom) >= {"faults", "evict_retries", "probes_ok", "hang_ms"}
        dbg = _get(srv.addr, "/debug/device")
        assert dbg["guard"]["domains"]["device"]["state"] == "healthy"
        bundle = _get(srv.addr, "/debug/bundle")
        assert bundle["device"]["guard"]["enabled"] is True
        eng = json.loads(urllib.request.urlopen(urllib.request.Request(
            srv.addr + "/query?debug=true", data=_Q.encode()), timeout=30
        ).read())["server_latency"]["engine"]
        assert eng["device_guard"]["device"]["state"] == "healthy"
    finally:
        srv.stop()


@pytest.mark.parametrize("sched", ["1", "0"], ids=["scheduled", "serial"])
def test_wedged_dispatch_answers_503_then_serves_again(monkeypatch, sched):
    monkeypatch.setenv("DGRAPH_TPU_DEVICE_COOLDOWN_S", "0.5")
    monkeypatch.setenv("DGRAPH_TPU_SCHED", sched)
    srv = _server()
    try:
        base = _post(srv.addr, _Q)
        devguard.get().hang_ms = 150
        tfailpoints.fail.arm("device.hop", "hang(ms=1500,n=1)")
        t0 = time.monotonic()
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.addr, _Q)
        assert time.monotonic() - t0 < 1.5
        assert ei.value.code == 503
        assert ei.value.headers["Retry-After"] == "1"
        body = json.loads(ei.value.read().decode())
        assert body["code"] == "ErrorServiceUnavailable"
        assert "hang" in body["message"]
        # while sick: 503 at once, nothing dispatched
        hits = tfailpoints.fail.hits("device.hop")
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(srv.addr, _Q)
        assert ei.value.code == 503
        assert tfailpoints.fail.hits("device.hop") == hits
        detail = _get(srv.addr, "/health?detail=1")
        assert detail["device"]["domains"]["device"]["state"] == "sick"
        assert _wait(lambda: devguard.get().state == "healthy", timeout=15)
        assert _body(_post(srv.addr, _Q)) == _body(base)
    finally:
        srv.stop()


def test_concurrent_clients_all_503_and_workers_survive(monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_DEVICE_COOLDOWN_S", "0.5")
    srv = _server()
    try:
        base = _post(srv.addr, _Q)
        devguard.get().note_fault("hang", "test")  # sick by hand
        codes = []
        lock = threading.Lock()

        def client():
            try:
                _post(srv.addr, _Q)
                code = 200
            except urllib.error.HTTPError as e:
                code = e.code
            with lock:
                codes.append(code)

        ts = [threading.Thread(target=client) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
        assert codes == [503] * 8
        assert _wait(lambda: devguard.get().state == "healthy", timeout=15)
        assert _body(_post(srv.addr, _Q)) == _body(base)
    finally:
        srv.stop()


# ---------------------------------------- eviction vs an in-flight expand


def test_eviction_races_inflight_expand():
    """``evict_for_oom`` under a reader that holds its arena across the
    eviction window: every expansion stays correct, and an evicted arena
    the reader still holds stays alive (its device blocks are not freed
    while an expand holds it)."""
    st = PostingStore()
    eng = QueryEngine(st, device="cpu")
    eng.run("mutation { schema { a: [uid] .\nb: [uid] . } set { %s } }" % "\n".join(
        f"<0x{i:x}> <a> <0x{i + 1:x}> .\n<0x{i:x}> <b> <0x{i + 1:x}> ."
        for i in range(1, 33)
    ))
    eng.expand_device_min = 1
    am = eng.arenas
    src = np.arange(1, 33, dtype=np.int64)
    stop = threading.Event()
    errs = []
    held = []

    def reader():
        while not stop.is_set():
            try:
                arena = am.data("a")
                held.append(weakref.ref(arena))
                out, _seg = eng.expander._expand_cached(arena, src, "a", False)
                if len(out) != 32:
                    errs.append(f"wrong expansion: {len(out)} edges")
            except Exception as e:  # noqa: BLE001 — surfaced below
                errs.append(repr(e))

    ts = [threading.Thread(target=reader, daemon=True) for _ in range(4)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    dropped = 0
    try:
        for t in ts:
            t.start()
        deadline = time.monotonic() + 1.0
        while time.monotonic() < deadline:
            am.data("b")
            am.data("a")
            dropped += am.evict_for_oom(n=2)
    finally:
        stop.set()
        sys.setswitchinterval(old)
        for t in ts:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in ts)
    assert not errs, errs[:3]
    assert dropped > 0 and am.evictions >= dropped
    assert len(am._lru) >= 1  # one entry is always kept
    # an evicted arena lives on while an expand holds it, and goes (its
    # device blocks back to the allocator) with the last reference
    arena = am.data("a")
    ref = weakref.ref(arena)
    am.data("b")  # "a" is now the least recently used
    assert am.evict_for_oom(n=1) == 1
    assert am._data.get("a") is not arena
    assert ref() is not None
    out, _seg = eng.expander._expand_cached(arena, src, "a", False)
    assert len(out) == 32
    del arena, out, _seg
    gc.collect()
    assert ref() is None, "the evicted arena outlived its last holder"
