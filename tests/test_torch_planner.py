"""The port's measured-cost planner (``dgraph_tpu_torch.query.planner``,
``dgraph_tpu_torch.utils.calibrate``) held against the reference's
(``dgraph_tpu.query.planner``, ``dgraph_tpu.utils.calibrate``), both
given the same calibration:

- over a seeded grid of sizes, k, levels, residency and knob pins
  (planner on or off, env pins, runtime pins), every route and
  ``merge_gate`` returns the same verdict and the same decision dict;
- a seeded sequence of ``note_outcome`` calls (outliers,
  dispatch-dominated units, wrong-side times) leaves equal rates (to
  1e-12 relative), ``mispredict_stats()`` and recent-ring entries;
- ``CohortController`` replays a seeded occupancy / queue-wait sequence
  to the same (max_batch, flush_s) at every step, within its bounds;
- the calibration file round-trips, a reference-written CPU file loads
  in the port, and a file of another backend is refused by both;
- the golden queries answer byte-identically through the port's server
  with the planner on (priors, and a calibration that sends every route
  to the device), off and under pinned knobs, equal to the reference
  server's bytes with its planner on and off; ``/debug/planner`` has the
  reference's keys;
- a served query's priced decisions equal the reference engine's.

Every test runs under ``pinned_planner`` (tests/torch_pins.py); the
refinement test turns the EWMA back on in both modules itself.
"""

import json
import urllib.error
import urllib.request
from dataclasses import replace

import numpy as np
import pytest

from dgraph_tpu.models import PostingStore as JaxStore
from dgraph_tpu.query import planner as ref
from dgraph_tpu.query.engine import QueryEngine as JaxEngine
from dgraph_tpu.serve.server import DgraphServer as JaxServer
from dgraph_tpu.utils import calibrate as ref_cal
from dgraph_tpu_torch.models import PostingStore
from dgraph_tpu_torch.query import planner as port
from dgraph_tpu_torch.query.engine import QueryEngine
from dgraph_tpu_torch.serve.server import DgraphServer
from dgraph_tpu_torch.utils import calibrate as port_cal
from dgraph_tpu_torch.utils import planconfig

from tests import test_goldens
from tests.torch_parity import REFERENCE_ENV, golden_queries, port_store_of
from torch_pins import pinned_calibration, pinned_planner  # noqa: F401

pytestmark = [
    pytest.mark.compile_budget(400),
    pytest.mark.usefixtures("pinned_planner"),
]

# calibrations both planners are given: the priors, a card-like one (a
# cheap dispatch, fast device rates: most routes go to the device) and a
# slow-device one (every route stays on the host)
_CARD_LIKE = dict(
    dispatch_us=9.5, device_edge_us=0.0021, resident_edge_us=0.0009,
    host_edge_us=0.021, host_touch_us=0.004, host_setup_us=6.0,
    host_intersect_us=0.011, device_intersect_us=0.0007,
    tile_mac_us=3e-6,
)
# a near-free dispatch: every expansion and k-way step of the goldens'
# small graph goes to the device
_DEVICE_FIRST = dict(_CARD_LIKE, dispatch_us=0.5)
_SLOW_DEVICE = dict(dispatch_us=5000.0, device_edge_us=0.5,
                    resident_edge_us=0.4, device_intersect_us=0.3)
CALIBRATIONS = {"priors": {}, "card_like": _CARD_LIKE,
                "device_first": _DEVICE_FIRST, "slow_device": _SLOW_DEVICE}


def _install(rates: dict) -> None:
    for planner, cal in ((ref, ref_cal), (port, port_cal)):
        planner.install_calibration(
            replace(pinned_calibration(cal), **rates)
        )


class _Eng:
    """chain_threshold carrier for the decision-only tests."""

    def __init__(self, threshold=planconfig.CHAIN_THRESHOLD_DEFAULT):
        self.chain_threshold = threshold


# knob settings of the grid: (name, env to set, runtime expand min,
# runtime chain threshold)
_KNOBS = [
    ("default", {}, None, None),
    ("planner_off", {"DGRAPH_TPU_PLANNER": "0"}, None, None),
    ("env_pinned", {"DGRAPH_TPU_EXPAND_DEVICE_MIN": "4096",
                    "DGRAPH_TPU_CHAIN_THRESHOLD": "9000",
                    "DGRAPH_TPU_KWAY_DEVICE_MIN": "5000",
                    "DGRAPH_TPU_SEGMENT_K": "3",
                    "DGRAPH_TPU_IVM_REPAIR_MAX_DELTA": "300"}, None, None),
    ("runtime_pinned", {}, 1, 1),
    ("segment_force", {"DGRAPH_TPU_SEGMENT": "force"}, None, None),
    ("repair_force", {"DGRAPH_TPU_IVM_REPAIR": "force"}, None, None),
    ("repair_off", {"DGRAPH_TPU_IVM_REPAIR": "0"}, None, None),
]


@pytest.mark.parametrize("cal", sorted(CALIBRATIONS))
@pytest.mark.parametrize("knobs", [k[0] for k in _KNOBS])
def test_route_verdicts_and_decisions_match_reference(cal, knobs, monkeypatch):
    _name, env, emin, cthr = next(k for k in _KNOBS if k[0] == knobs)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    _install(CALIBRATIONS[cal])
    expand_min = planconfig.expand_device_min() if emin is None else emin
    eng = _Eng(planconfig.chain_threshold() if cthr is None else cthr)
    rng = np.random.default_rng(sum(map(ord, cal + knobs)))
    totals = np.unique(np.concatenate([
        [0, 1, 511, 512, 5_000, 5_300, 8_286, 18_714, 262_143, 262_144],
        rng.integers(1, 1 << 22, size=40),
    ]))
    n = 0
    for total in totals.tolist():
        for resident in (False, True):
            assert port.expand_route(total, expand_min, resident) == \
                ref.expand_route(total, expand_min, resident), (total, resident)
        assert port.merge_gate(float(total), expand_min) == \
            ref.merge_gate(float(total), expand_min), total
        for k in (2, 3, 7, 16):
            assert port.kway_route(total, k) == ref.kway_route(total, k), (total, k)
        for levels in (2, 3, 5):
            assert port.chain_route(eng, total, levels) == \
                ref.chain_route(eng, total, levels), (total, levels)
            assert port.mxu_fanout_ok(eng, total, levels) == \
                ref.mxu_fanout_ok(eng, total, levels)
        for steps in (1, 2, 4, 9):
            assert port.segment_route(steps, total, "chain") == \
                ref.segment_route(steps, total, "chain"), (steps, total)
        for delta in (1, 64, 300, 512, 513):
            assert port.repair_route(delta, float(total)) == \
                ref.repair_route(delta, float(total)), (delta, total)
        n += 1
    assert n == len(totals)


def test_runtime_kway_gate_pins_the_static_compare():
    """The port's one addition: an arena's ``kway_device_min`` assigned
    away from its default keeps the caller's static compare, as an
    assigned ``expand_device_min`` does in both packages."""
    dflt = planconfig.KWAY_DEVICE_MIN_DEFAULT
    assert port.kway_route(100_000, 3, dflt) == ref.kway_route(100_000, 3)
    assert port.kway_route(100_000, 3, 1) == (None, None)


@pytest.mark.parametrize("kind", ["expand", "kway"])
def test_first_served_outcome_of_a_route_is_an_outlier(kind, monkeypatch):
    """The port's one addition to the refinement (a divergence by
    design): the first outcome of each (kind, route) a served request
    closes is an outlier, recorded but neither a rate sample nor a
    mispredict; from the second on, ``note_served_outcome`` refines as
    the reference's ``note_outcome`` does."""
    monkeypatch.setattr(ref, "_EWMA_ALPHA", 0.2)
    monkeypatch.setattr(port, "_EWMA_ALPHA", 0.2)
    _install(_CARD_LIKE)

    def decide(planner):
        if kind == "expand":
            _u, d = planner.expand_route(100_000, 262144, resident=True)
        else:
            _u, d = planner.kway_route(100_000, 3)
        planner.record(None, d)
        return d

    before = port.rates()
    first = decide(port)
    port.note_served_outcome(first, first["est_chosen_us"] * 20.0)
    assert first["outlier"] is True and "mispredict" not in first
    assert first["actual_us"] == round(first["est_chosen_us"] * 20.0, 1)
    assert port.rates() == before
    assert port.mispredict_stats()["mispredicts"] == 0
    for factor in (20.0, 0.7, 9.0):
        d_ref, d_port = decide(ref), decide(port)
        assert d_ref == d_port
        actual = d_ref["est_chosen_us"] * factor
        ref.note_outcome(d_ref, actual)
        port.note_served_outcome(d_port, actual)
        assert d_ref == d_port, factor
    assert port.rates() != before
    rr, pr = ref.rates(), port.rates()
    for k in rr:
        assert pr[k] == pytest.approx(rr[k], rel=1e-12, abs=0.0), k


@pytest.mark.parametrize("seed", [3, 17, 101])
def test_note_outcome_sequence_refines_like_reference(seed, monkeypatch):
    monkeypatch.setattr(ref, "_EWMA_ALPHA", 0.2)
    monkeypatch.setattr(port, "_EWMA_ALPHA", 0.2)
    _install(_CARD_LIKE if seed % 2 else {})
    installed = port.rates()
    rng = np.random.default_rng(seed)
    for step in range(300):
        kind = rng.choice(["expand", "expand_res", "kway", "chain"])
        total = int(rng.choice([rng.integers(1, 512),
                                rng.integers(512, 1 << 21)]))
        k = int(rng.integers(2, 6))
        decs = []
        for planner in (ref, port):
            if kind == "expand":
                _u, d = planner.expand_route(total, 262144)
            elif kind == "expand_res":
                _u, d = planner.expand_route(total, 262144, resident=True)
            elif kind == "kway":
                _u, d = planner.kway_route(total, k)
            else:
                _u, d = planner.chain_route(_Eng(), total, 3)
            planner.record(None, d)
            decs.append(d)
        assert decs[0] == decs[1], step
        est = max(decs[0]["est_chosen_us"], 1.0)
        shape = rng.choice(["honest", "outlier", "wrong_side", "blowout",
                            "zero"])
        actual = {
            "honest": est * float(rng.uniform(0.5, 1.4)),
            "outlier": est * 150.0,
            "wrong_side": max(decs[0]["est_other_us"], 1.0) * 1.7,
            "blowout": est * 9.0,
            "zero": 0.0,
        }[shape]
        ref.note_outcome(decs[0], actual)
        port.note_outcome(decs[1], actual)
        assert decs[0] == decs[1], (step, shape)
    rr, pr = ref.rates(), port.rates()
    assert set(rr) == set(pr)
    for k in rr:
        assert pr[k] == pytest.approx(rr[k], rel=1e-12, abs=0.0), k
    assert port.mispredict_stats() == ref.mispredict_stats()
    assert port.mispredict_stats()["mispredicts"] > 0
    assert port.debug_summary()["recent"] == ref.debug_summary()["recent"]
    # refinement moved the rates (the pinned α=0 would not have)
    assert pr != installed


@pytest.mark.parametrize("seed", [5, 23])
@pytest.mark.parametrize("base", [(32, 0.002), (4, 0.0005), (1, 0.01)])
def test_cohort_controller_replays_like_reference(seed, base):
    mb0, fs0 = base
    a = ref.CohortController(mb0, fs0)
    b = port.CohortController(mb0, fs0)
    rng = np.random.default_rng(seed)
    hi = min(mb0 * 8, 1024)
    moved = set()
    for phase in ("ramp", "burst", "drain"):
        for _ in range(120):
            if phase == "ramp":
                occ = int(b.max_batch * rng.uniform(0.6, 1.0))
                wait = float(rng.uniform(0.0, 12.0)) * b.flush_s
            elif phase == "burst":
                occ = int(rng.integers(0, 2 * hi))
                wait = float(rng.exponential(0.02))
            else:
                occ, wait = 0, 0.0
            svc = float(rng.uniform(0, 0.01))
            ra, rb = a.update(occ, wait, svc), b.update(occ, wait, svc)
            assert ra == rb
            assert mb0 <= rb[0] <= hi
            assert fs0 / 8 - 1e-12 <= rb[1] <= fs0 + 1e-12
            moved.add(rb)
    assert b.state() == {k: v for k, v in a.state().items()}
    assert len(moved) > 1 or mb0 == hi


def test_calibration_file_roundtrip_and_backend_gate(tmp_path, monkeypatch):
    path = str(tmp_path / "calib.json")
    cal = replace(port_cal.PRIORS, dispatch_us=55.5, host_edge_us=0.011,
                  backend="cuda", source="measured", measured_at=123.0)
    port_cal.save(cal, path)
    back = port_cal.load(path, backend="cuda")
    assert back is not None and back.source == "file"
    assert back.rates() == cal.rates() and back.measured_at == 123.0
    # the same bytes as the reference writes for the same calibration
    rpath = str(tmp_path / "ref.json")
    ref_cal.save(replace(ref_cal.PRIORS, **cal.rates(), backend="cuda",
                         source="measured", measured_at=123.0), rpath)
    assert open(rpath, "rb").read() == open(path, "rb").read()
    # another backend is refused by both
    assert port_cal.load(path, backend="cpu") is None
    assert ref_cal.load(path, backend="cpu") is None
    # a reference-written CPU file loads in the port on the CPU
    cpath = str(tmp_path / "cpu.json")
    ref_cal.save(replace(ref_cal.PRIORS, dispatch_us=42.0, backend="cpu",
                         source="measured"), cpath)
    got = port_cal.load(cpath, backend="cpu")
    assert got is not None and got.dispatch_us == 42.0
    assert got.rates() == ref_cal.load(cpath, backend="cpu").rates()
    # boot on a CPU server device: the CPU file loads, the card's not
    monkeypatch.setenv("DGRAPH_TPU_CALIBRATION_FILE", cpath)
    assert port.boot(device="cpu").dispatch_us == 42.0
    assert port.calibration_info()["source"] == "file"
    port._reset_for_tests()
    monkeypatch.setenv("DGRAPH_TPU_CALIBRATION_FILE", path)
    assert port.boot(device="cpu").source == "prior"
    # corrupt and wrong-version files degrade to None in both
    for text in ("{not json", json.dumps({"version": 99})):
        (tmp_path / "bad.json").write_text(text)
        for mod in (port_cal, ref_cal):
            assert mod.load(str(tmp_path / "bad.json"), backend="cpu") is None


def test_port_default_calibration_file_is_its_own(monkeypatch):
    monkeypatch.delenv("DGRAPH_TPU_CALIBRATION_FILE", raising=False)
    from dgraph_tpu.utils import planconfig as ref_planconfig

    assert planconfig.calibration_file() != ref_planconfig.calibration_file()
    monkeypatch.setenv("DGRAPH_TPU_CALIBRATION_FILE", "")
    assert planconfig.calibration_file() == ""


def test_measure_on_cpu_gives_positive_rates_and_boot_persists(
    tmp_path, monkeypatch
):
    cal = port_cal.measure(edges=1 << 12, reps=2, device="cpu")
    assert cal.source == "measured" and cal.backend == "cpu"
    for k, v in cal.rates().items():
        assert v > 0, k
    path = str(tmp_path / "m.json")
    monkeypatch.setenv("DGRAPH_TPU_CALIBRATION_FILE", path)
    monkeypatch.setattr(
        port, "measure",
        lambda device=None: port_cal.measure(edges=1 << 12, reps=2,
                                             device=device),
    )
    got = port.boot(measure_now=True, device="cpu")
    assert got.source == "measured"
    assert port_cal.load(path, backend="cpu").rates() == got.rates()


# -- the golden queries through the servers ----------------------------------

GOLDEN_CASES = [
    c for c in golden_queries("test_goldens.py")
    if "mutation" not in c[1]
]
_SETUP = [
    "mutation { schema { %s } set { %s } }"
    % (test_goldens.SCHEMA, test_goldens.RDF),
    'mutation { set { <0x4> <pwd> "hunter2" . } }',
]


def _post(addr, text, variables=None):
    headers = {}
    if variables:
        headers["X-Dgraph-Vars"] = json.dumps(variables)
    req = urllib.request.Request(
        addr + "/query", data=text.encode(), method="POST", headers=headers
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(addr, path):
    with urllib.request.urlopen(addr + path, timeout=60) as r:
        return json.loads(r.read())


def _strip(raw: bytes) -> bytes:
    try:
        d = json.loads(raw)
    except ValueError:
        return raw
    if isinstance(d, dict):
        d.pop("server_latency", None)
    return json.dumps(d).encode()


def _serve(make, env: dict, rates: dict):
    """Each golden case's (status, body) through one server built by
    ``make`` under ``env``, with both planners given ``rates``; and the
    server's /debug/planner."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv(k, v)
        ref._reset_for_tests()
        port._reset_for_tests()
        _install(rates)
        srv = make()
        srv.start()
        try:
            for text in _SETUP:
                code, raw = _post(srv.addr, text)
                assert code == 200, raw
            out = {cid: _post(srv.addr, text, variables)
                   for cid, text, variables in GOLDEN_CASES}
            dbg = _get(srv.addr, "/debug/planner")
        finally:
            srv.stop()
            ref._reset_for_tests()
            port._reset_for_tests()
    return out, dbg


_PORT_MODES = {
    "on_priors": ({}, {}),
    "on_device_first": ({"DGRAPH_TPU_RESIDENT": "force"}, _DEVICE_FIRST),
    "off": ({"DGRAPH_TPU_PLANNER": "0"}, {}),
    "pinned_knobs": ({"DGRAPH_TPU_EXPAND_DEVICE_MIN": "1",
                      "DGRAPH_TPU_KWAY_DEVICE_MIN": "1",
                      "DGRAPH_TPU_CHAIN_THRESHOLD": "1",
                      "DGRAPH_TPU_RESIDENT": "force"}, _DEVICE_FIRST),
}
_REF_ENV = dict(REFERENCE_ENV, DGRAPH_TPU_RESIDENT="0")


@pytest.fixture(scope="module")
def served():
    got = {
        "ref_on": _serve(lambda: JaxServer(JaxStore()), _REF_ENV, {}),
        "ref_off": _serve(lambda: JaxServer(JaxStore()),
                          dict(_REF_ENV, DGRAPH_TPU_PLANNER="0"), {}),
    }
    for mode, (env, rates) in _PORT_MODES.items():
        got[mode] = _serve(
            lambda: DgraphServer(PostingStore(), device="cpu"), env, rates
        )
    return got


def test_golden_cases_cover_the_goldens():
    assert len(GOLDEN_CASES) >= 60


@pytest.mark.parametrize("cid", [c[0] for c in GOLDEN_CASES])
def test_golden_bodies_identical_planner_on_off_pinned(served, cid):
    wc, wb = served["ref_on"][0][cid]
    oc, ob = served["ref_off"][0][cid]
    assert (oc, _strip(ob)) == (wc, _strip(wb)), "reference on/off differ"
    for mode in _PORT_MODES:
        gc, gb = served[mode][0][cid]
        assert gc == wc, (mode, gb)
        assert _strip(gb) == _strip(wb), mode


def test_debug_planner_has_the_reference_keys(served):
    # the reference server runs without its scheduler (REFERENCE_ENV),
    # so its summary has no "sched"; the port's scheduler reports the
    # reference controller's state keys
    want = served["ref_on"][1]
    ctl_keys = set(ref.CohortController(32, 0.002).state())
    for mode in _PORT_MODES:
        got = served[mode][1]
        assert set(got) == set(want) | {"sched"}, mode
        assert set(got["calibration"]) == set(want["calibration"])
        assert set(got["calibration"]["rates"]) == set(
            want["calibration"]["rates"]
        )
        if mode != "off":
            assert set(got["sched"]) == ctl_keys, mode
    on = served["on_device_first"][1]
    assert on["enabled"] is True
    assert on["counts"].get("expand:resident", 0) > 0, on["counts"]
    assert on["counts"].get("kway:device", 0) > 0, on["counts"]
    assert served["on_priors"][1]["counts"].get("expand:host", 0) > 0
    off = served["off"][1]
    assert off["enabled"] is False and off["counts"] == {}
    assert off["sched"] == {"adaptive": False, "max_batch": 32,
                            "flush_ms": 2.0}
    assert served["on_priors"][1]["sched"]["base_batch"] == 32


# -- a served query's decisions ----------------------------------------------


def _decisions(stats):
    return [d for d in stats.get("planner", []) if d["kind"] != "segment"]


@pytest.mark.parametrize("text", [
    "{ me(func: uid(0x1, 0x2, 0x3, 0x4)) { uid friend { uid friend { uid } } } }",
    '{ me(func: anyofterms(name, "Ann Ben")) { name friend { name } } }',
    "{ var(func: uid(0x1)) { friend { f as friend } } me(func: uid(f)) { uid } }",
])
def test_engine_decisions_match_reference(text, monkeypatch):
    """The same query over the same graph, both engines' planners given
    the device-first calibration and the resident route: every priced
    decision (kind, route, units, both estimates) is the same."""
    for k, v in REFERENCE_ENV.items():
        monkeypatch.setenv(k, v)
    _install(_DEVICE_FIRST)
    jeng = JaxEngine(JaxStore())
    for m in _SETUP:
        jeng.run(m)
    teng = QueryEngine(port_store_of(jeng.store), device="cpu")
    want = jeng.run(text)
    got = teng.run(text)
    assert json.dumps(got) == json.dumps(want)
    strip = ("actual_us", "mispredict", "outlier")
    wd = [{k: v for k, v in d.items() if k not in strip}
          for d in _decisions(jeng.stats)]
    gd = [{k: v for k, v in d.items() if k not in strip}
          for d in _decisions(teng.stats)]
    assert gd == wd
    assert any(d["route"] == "resident" for d in gd), gd


@pytest.mark.parametrize("env", [
    {}, {"DGRAPH_TPU_SCHED_MAX_BATCH": "16"}, {"DGRAPH_TPU_SCHED_FLUSH_MS": "4"},
    {"DGRAPH_TPU_PLANNER": "0"},
])
def test_cohort_controller_armed_like_reference(env, monkeypatch):
    """The scheduler arms the controller when the planner is on and
    neither scheduler knob is pinned, as the reference's does; a pinned
    knob keeps its static value.  The reference runs without its mesh
    (whose width would raise its controller's ceiling)."""
    monkeypatch.setenv("DGRAPH_TPU_MESH", "0")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    srv = DgraphServer(PostingStore(), device="cpu")
    jsrv = JaxServer(JaxStore())
    try:
        ctl, jctl = srv.scheduler._adaptive, jsrv.scheduler._adaptive
        assert (ctl is None) == (jctl is None) == bool(env)
        assert srv.scheduler.max_batch == jsrv.scheduler.max_batch
        assert srv.scheduler.flush_s == jsrv.scheduler.flush_s
        if ctl is not None:
            assert ctl.state() == jctl.state()
    finally:
        srv.stop()
        jsrv.stop()
