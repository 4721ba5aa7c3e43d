"""The port's k-way join path (dgraph_tpu_torch/query/joinplan.py and its
callers) against the reference's.

- ``kway_intersect`` on both routes — the host fold and the device route
  (on the CPU the intersect wrapper runs its plain version) — against
  the reference's ``joinplan.kway_intersect`` on its device route (the
  XLA ``intersect_stack``) and its host fold: the same result bytes, and
  the same stats keys.
- The port's engine against the JAX engine, byte for byte, on the
  ``@filter`` AND query of tests/test_spgemm.py (``KWAY_Q`` over its
  ``_seed_store``), an ``allofterms``, a term ``eq`` over several tokens
  and a trigram ``regexp``, as root functions and as filter leaves, under
  ``DGRAPH_TPU_KWAY_DEVICE_MIN`` ∈ {1, 2^30}; the store is carried into
  the port with ``snapshot_of``.

Tolerance: none."""

import json

import numpy as np
import pytest

from dgraph_tpu.models.types import TypeID, TypedValue
from dgraph_tpu.query import QueryEngine as JaxEngine
from dgraph_tpu.query import joinplan as jjoin
from dgraph_tpu_torch.query import QueryEngine
from dgraph_tpu_torch.query import joinplan as tjoin

from tests.test_spgemm import KWAY_Q, _seed_store
from tests.torch_parity import REFERENCE_ENV, body, port_store_of
from torch_pins import pinned_planner  # noqa: F401

# every route decision of both planners is pinned (tests/torch_pins.py)
pytestmark = pytest.mark.usefixtures("pinned_planner")

KWAY_STAT_KEYS = ("kway_ms", "kway_device", "kway_host")


def _sets(seed, k, universe=400):
    rng = np.random.default_rng(seed)
    return [np.unique(rng.integers(0, universe, size=int(rng.integers(1, 300))))
            for _ in range(k)]


SET_CASES = {
    **{f"k{k}_seed{s}": (lambda k=k, s=s: _sets(s, k)) for k in (2, 3, 8, 16)
       for s in (0, 1)},
    "k17_host_only": lambda: _sets(5, 17, universe=60),
    "one_set": lambda: _sets(6, 1),
    "empty_member": lambda: _sets(7, 3)[:2] + [np.empty(0, np.int64)],
    "disjoint": lambda: [np.arange(0, 50), np.arange(50, 90)],
    "identical": lambda: [np.arange(3, 300, 7)] * 4,
}


def _reference(sets, device_min, monkeypatch):
    for k, v in REFERENCE_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DGRAPH_TPU_KWAY_DEVICE_MIN", str(device_min))
    stats = {}
    return jjoin.kway_intersect(sets, stats=stats), stats


@pytest.mark.parametrize("case", sorted(SET_CASES))
@pytest.mark.parametrize("route", ["device", "host"])
def test_kway_intersect_matches_the_reference(case, route, monkeypatch):
    sets = SET_CASES[case]()
    device_min = 1 if route == "device" else 1 << 62
    want, jstats = _reference(sets, device_min, monkeypatch)
    stats = {}
    got = tjoin.kway_intersect(sets, stats=stats, device="cpu",
                               device_min=device_min)
    assert got.dtype == np.int64 and want.dtype == np.int64
    assert got.tobytes() == want.tobytes()
    # the same route taken, counted under the same keys
    for key in KWAY_STAT_KEYS:
        assert (key in stats) == (key in jstats), (key, stats, jstats)
    if "kway_device" in jstats:
        assert stats["kway_device"] == jstats["kway_device"] == 1
        assert route == "device" and len(sets) <= tjoin.KWAY_K_MAX
    if "kway_host" in jstats:
        assert stats["kway_host"] == jstats["kway_host"] == 1


def test_kway_route_gates_on_size_and_k(monkeypatch):
    sets = _sets(3, 3)
    total = sum(len(s) for s in sets)
    many = _sets(4, tjoin.KWAY_K_MAX + 1, universe=60)
    tjoin._reset_for_tests()
    for sets_, device_min, route in ((sets, total, "kway_device"),
                                     (sets, total + 1, "kway_host"),
                                     (many, 1, "kway_host")):
        stats = {}
        tjoin.kway_intersect(sets_, stats=stats, device="cpu",
                             device_min=device_min)
        assert stats[route] == 1 and stats["kway_ms"] >= 0
        # as in the reference, a k-way route is counted, not logged among
        # the tile tier's decisions
        assert "join_routes" not in stats
    # without an argument the gate is DGRAPH_TPU_KWAY_DEVICE_MIN
    monkeypatch.setenv("DGRAPH_TPU_KWAY_DEVICE_MIN", str(total))
    stats = {}
    tjoin.kway_intersect(sets, stats=stats, device="cpu")
    assert stats["kway_device"] == 1
    assert tjoin.debug_summary() == {
        "counts": {"mxu": 0, "pairwise": 0, "kway_device": 2, "kway_host": 2},
        "recent": []}


@pytest.mark.parametrize("mode", ["0", "1", "force"])
def test_kway_route_honours_the_mxu_mode(mode, monkeypatch):
    """DGRAPH_TPU_MXU_JOIN '0' folds on the host whatever the size,
    'force' takes the device below the gate, '1' is the size gate — in
    both packages alike, with the same bytes."""
    sets = _sets(8, 3)
    total = sum(len(s) for s in sets)
    for k, v in REFERENCE_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DGRAPH_TPU_PLANNER", "0")
    monkeypatch.setenv("DGRAPH_TPU_MXU_JOIN", mode)
    for gate in (1, total + 1):
        monkeypatch.setenv("DGRAPH_TPU_KWAY_DEVICE_MIN", str(gate))
        jstats, stats = {}, {}
        want = jjoin.kway_intersect(sets, stats=jstats)
        got = tjoin.kway_intersect(sets, stats=stats, device="cpu")
        assert got.tobytes() == want.tobytes()
        route = {"0": "kway_host", "force": "kway_device"}.get(
            mode, "kway_device" if gate == 1 else "kway_host")
        assert stats[route] == jstats[route] == 1
        assert set(stats) & {"kway_device", "kway_host"} == {route}


# -- engine parity ------------------------------------------------------------

TITLES = ["red blue", "red blue green", "blue green", "green red blue",
          "red blue green", "blue"]
NICKS = ["annabel", "annabelle", "bella", "anna bell", "mirabel", "annabel lee"]

QUERIES = {
    "kway_filter": KWAY_Q,
    "allofterms_root": '{ q(func: allofterms(title, "red blue")) { uid title } }',
    "allofterms_filter": (
        '{ q(func: has(e1)) @filter(allofterms(title, "blue green") AND '
        'has(e2) AND has(e3)) { uid title } }'),
    "term_eq_root": '{ q(func: eq(title, "red blue green")) { uid title } }',
    "term_eq_filter": (
        '{ q(func: has(e2)) @filter(eq(title, "green red blue") AND '
        'has(e1) AND uid(0x3, 0x9, 0xf, 0x15, 0x1b, 0x21)) { uid } }'),
    "trigram_root": '{ q(func: regexp(nick, /annabel/)) { uid nick } }',
    "trigram_filter": (
        '{ q(func: has(e1)) @filter(regexp(nick, /bell/) AND has(e4)) '
        '{ uid nick } }'),
    "var_filter": (
        '{ var(func: has(e1)) { e1 { f as e2 } } '
        'q(func: allofterms(title, "red blue")) @filter(has(e3) AND uid(f)) '
        '{ uid } }'),
}


def _store():
    st = _seed_store()
    st.apply_schema("title: string @index(term) .\nnick: string @index(trigram) .")
    for u in range(1, 61):
        st.set_value("title", u, TypedValue(TypeID.STRING, TITLES[u % 6]))
        st.set_value("nick", u, TypedValue(TypeID.STRING, NICKS[(u // 2) % 6]))
    return st


@pytest.fixture(scope="module")
def reference_store():
    return _store()


@pytest.mark.parametrize("query", sorted(QUERIES))
@pytest.mark.parametrize("device_min", [1, 1 << 30])
def test_engine_parity_on_the_join_path(query, device_min, reference_store,
                                        monkeypatch):
    for k, v in REFERENCE_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("DGRAPH_TPU_KWAY_DEVICE_MIN", str(device_min))
    text = QUERIES[query]
    jeng = JaxEngine(reference_store)
    want = jeng.run(text)
    teng = QueryEngine(port_store_of(reference_store), device="cpu")
    assert teng.arenas.kway_device_min == device_min
    got = teng.run(text)
    assert body(got) == body(want)
    assert json.loads(body(got))["q"], "the case must match something"
    st = teng.stats
    assert st["kway_device"] + st["kway_host"] >= 1  # every case has one
    if device_min == 1:
        assert st["kway_device"] >= 1 and st["kway_host"] == 0
    else:
        assert st["kway_device"] == 0
    assert st["kway_device"] == jeng.stats["kway_device"]
    assert st["kway_host"] == jeng.stats["kway_host"]
