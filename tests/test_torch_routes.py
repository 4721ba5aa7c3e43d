"""The port's engine on each of its four device routes against the JAX
engine, golden query by golden query.

Both engines hold the fixture graphs of tests/test_goldens.py and
tests/test_film.py (built in the reference, carried into the port with
``models/carry.store_from_snapshot``), every level on a device route
(``expand_device_min`` 1, no fused chain).  The reference answers on its
resident tier (the Pallas gather in interpret mode); the port answers on
each route in turn, its kernels' plain versions on the CPU:

- ``classed``: ``DGRAPH_TPU_RESIDENT=0`` (the CPU default of
  ``DGRAPH_TPU_FUSED_HOP=1`` takes it);
- ``inline``: ``DGRAPH_TPU_RESIDENT=0`` and ``DGRAPH_TPU_FUSED_HOP=0``;
- ``csr``: ``DGRAPH_TPU_RESIDENT=0`` with every frontier read as not
  ascending (``torch_parity.csr_only``), as an ordered root's is: the
  only frontier a deployment sends to csr, which
  ``test_ordered_frontier_takes_csr`` drives as it comes;
- ``resident``: ``DGRAPH_TPU_RESIDENT=force``.

Responses must be byte-identical JSON (tolerance none), and every hop
must have taken the forced route — or, on the classed and inline
routes, ``csr`` where the frontier is not ascending (an ordered root), as
in the reference — or found nothing to walk (``empty``).  The classed and
inline routes are also held against the reference's own classed and
inline routes on the film goldens: both engines' ledgers must name the
same routes, hop for hop."""

import pytest

from dgraph_tpu.models import PostingStore as JaxStore
from dgraph_tpu.obs import ledger as jledger
from dgraph_tpu.query import QueryEngine as JaxEngine
from dgraph_tpu_torch.obs import ledger as tledger
from dgraph_tpu_torch.query import QueryEngine

from tests import test_film, test_goldens
from tests.torch_parity import (
    REFERENCE_ENV, body, csr_only, golden_queries, port_store_of,
)
from torch_pins import pinned_planner  # noqa: F401

pytestmark = [
    pytest.mark.compile_budget(400),
    pytest.mark.pallas_interpret,
    pytest.mark.usefixtures("pinned_planner"),
]

ROUTE_ENV = {
    "classed": {"DGRAPH_TPU_RESIDENT": "0", "DGRAPH_TPU_FUSED_HOP": "1"},
    "inline": {"DGRAPH_TPU_RESIDENT": "0", "DGRAPH_TPU_FUSED_HOP": "0"},
    "csr": {"DGRAPH_TPU_RESIDENT": "0"},
    "resident": {"DGRAPH_TPU_RESIDENT": "force"},
}
ROUTES = list(ROUTE_ENV)


def _goldens_setup(e):
    e.run("mutation { schema { %s } set { %s } }"
          % (test_goldens.SCHEMA, test_goldens.RDF))
    e.run('mutation { set { <0x4> <pwd> "hunter2" . } }')


def _film_setup(e):
    e.run("mutation { schema { %s } set { %s } }"
          % (test_film.SCHEMA, test_film.RDF))


def _reference(setup, env=None):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in dict(REFERENCE_ENV, **(env or {})).items():
            mp.setenv(k, v)
        jeng = JaxEngine(JaxStore())
        setup(jeng)
        jeng.expand_device_min = 1
        jeng.chain_threshold = 1 << 62  # per-level hops, no fused chain
        return jeng


def _port(jstore, route):
    # no hop cache, guard or scheduler knobs of its own: the parity run's
    with pytest.MonkeyPatch.context() as mp:
        for k, v in dict(REFERENCE_ENV, **ROUTE_ENV[route]).items():
            mp.setenv(k, v)
        teng = QueryEngine(port_store_of(jstore), device="cpu")
    if route == "csr":
        csr_only(teng)
    teng.expand_device_min = 1
    teng.chain_threshold = 1 << 62
    return teng


class _Pair:
    """A reference engine and the port's engine on each route over one
    graph; the reference's answers are computed once per query."""

    def __init__(self, setup):
        self.jeng = _reference(setup)
        self.ports = {r: _port(self.jeng.store, r) for r in ROUTES}
        self._want = {}

    def want(self, text, variables):
        key = (text, repr(variables))
        if key not in self._want:
            try:
                self._want[key] = (body(self.jeng.run(text, variables)), None)
            except Exception as e:  # noqa: BLE001 — the reference's verdict
                self._want[key] = (None, e)
        return self._want[key]


@pytest.fixture(scope="module")
def goldens():
    return _Pair(_goldens_setup)


@pytest.fixture(scope="module")
def film():
    return _Pair(_film_setup)


def _allowed(route):
    return {route, "empty"} | ({"csr"} if route in ("classed", "inline") else set())


def _check(pair, route, text, variables):
    want, err = pair.want(text, variables)
    teng = pair.ports[route]
    if err is not None:
        with pytest.raises(Exception) as got:
            teng.run(text, variables)
        assert type(got.value).__name__ == type(err).__name__
        assert str(got.value) == str(err)
        return
    assert body(teng.run(text, variables)) == want
    routes = teng.stats["routes"]
    assert set(routes) <= _allowed(route), routes


GOLDEN_CASES = [
    c for c in golden_queries("test_goldens.py") + golden_queries("test_goldens2.py")
    if "mutation" not in c[1] or c[0].split("::")[1].startswith("PARSER_ERRORS")
]
FILM_CASES = [c for c in golden_queries("test_film.py") if "mutation" not in c[1]]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize(
    "text,variables", [c[1:] for c in GOLDEN_CASES], ids=[c[0] for c in GOLDEN_CASES]
)
def test_golden_on_each_route(goldens, route, text, variables):
    _check(goldens, route, text, variables)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize(
    "text,variables", [c[1:] for c in FILM_CASES], ids=[c[0] for c in FILM_CASES]
)
def test_film_on_each_route(film, route, text, variables):
    _check(film, route, text, variables)


TWO_HOP = ("{ me(func: uid(0x1, 0x2, 0x3, 0x4)) { uid friend { uid name "
           "friend { uid name } } ~cares_for { uid } } }")
ORDERED = "{ me(func: uid(0x1, 0x2, 0x3, 0x4), orderdesc: name) { name friend { uid } } }"


@pytest.mark.parametrize("route", ROUTES)
def test_each_route_is_taken(goldens, route):
    """An ascending frontier takes the forced route: friend and
    friend.friend walk it, ~cares_for finds no reverse rows."""
    teng = goldens.ports[route]
    teng.run(TWO_HOP)
    assert teng.stats["routes"] == {route: 2, "empty": 1}
    assert teng.stats["edges"] > 0


@pytest.mark.parametrize("route", ["classed", "inline"])
def test_ordered_frontier_takes_csr(goldens, route):
    """An ordered root permutes the frontier: the classed and inline
    routes need ascending rows, so its hop takes csr, as in the
    reference."""
    teng = goldens.ports[route]
    want, _err = goldens.want(ORDERED, None)
    assert body(teng.run(ORDERED)) == want
    assert teng.stats["routes"].get("csr", 0) >= 1, teng.stats["routes"]


REF_ROUTE_ENV = {
    "classed": {"DGRAPH_TPU_RESIDENT": "0", "DGRAPH_TPU_FUSED_HOP": "force"},
    "inline": {"DGRAPH_TPU_RESIDENT": "0", "DGRAPH_TPU_FUSED_HOP": "0"},
}


@pytest.fixture(scope="module")
def film_by_route():
    out = {}
    for route, env in REF_ROUTE_ENV.items():
        jeng = _reference(_film_setup, env)
        out[route] = (jeng, _port(jeng.store, route))
    return out


def _hops(ledger_mod, eng, text, variables):
    led = ledger_mod.Ledger()
    tok = ledger_mod.activate(led)
    try:
        return body(eng.run(text, variables)), dict(led.hops)
    finally:
        ledger_mod.deactivate(tok)


@pytest.mark.parametrize("route", list(REF_ROUTE_ENV))
@pytest.mark.parametrize(
    "text,variables", [c[1:] for c in FILM_CASES], ids=[c[0] for c in FILM_CASES]
)
def test_film_routes_match_the_reference_hop_for_hop(film_by_route, route, text,
                                                     variables):
    jeng, teng = film_by_route[route]
    jbody, jhops = _hops(jledger, jeng, text, variables)
    tbody, thops = _hops(tledger, teng, text, variables)
    assert tbody == jbody
    assert thops == jhops
    assert set(thops) <= _allowed(route), thops
