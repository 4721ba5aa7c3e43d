"""The port's engine against the reference's, query by query.

Both engines hold the same graph — the fixtures of tests/test_goldens.py
and tests/test_film.py, built in the reference and carried into the port
with ``models/carry.store_from_snapshot`` — and both expand every level
on the resident route: the reference's Pallas gather in interpret mode,
the port's gather wrapper (its plain version, on the CPU); the film
cases run once more on the port's staged-CSR route.  Responses must be
byte-identical JSON; tolerance none.

Every literal golden query is a case (tests/torch_parity.py reads them
from the golden files).  Excluded, with the reason:

- golden tests that build their own engine, or build a query at run
  time — not literal queries over the shared fixture;
- ``mutation`` queries in the goldens — they would change the shared
  fixture; ``test_parity_after_uid_mutation`` covers mutations instead.

A query the reference rejects must be rejected by the port with the same
error type and message.  A small geo + fulltext graph covers the
functions the golden fixtures do not reach (near/within/contains/
intersects, anyoftext/alloftext with a language)."""

import json

import pytest

from dgraph_tpu.models import PostingStore as JaxStore
from dgraph_tpu.obs import ledger as jledger
from dgraph_tpu.query import QueryEngine as JaxEngine
from dgraph_tpu_torch.query import QueryEngine

from tests import test_film, test_goldens
from tests.torch_parity import (
    REFERENCE_ENV, body, csr_only, golden_queries, port_store_of,
)
from torch_pins import pinned_planner  # noqa: F401

# interpret-mode Pallas compiles one program per (frontier, capacity)
# bucket; the reference side of these tests needs more than the default
pytestmark = [
    pytest.mark.compile_budget(400),
    pytest.mark.pallas_interpret,
    pytest.mark.usefixtures("pinned_planner"),
]


def _fixture_pair(setup, port_resident="force"):
    """(reference engine, port engine, the port's allowed routes) over one
    graph built by ``setup`` in the reference store, every level on the
    device route: the reference's resident tier, and the port's resident
    route (``port_resident="force"``) or its csr route ("0", every
    frontier read as not ascending, so that no hop takes the classed or
    inline route first)."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in REFERENCE_ENV.items():
            mp.setenv(k, v)
        jeng = JaxEngine(JaxStore())
        setup(jeng)
        jeng.expand_device_min = 1
        jeng.chain_threshold = 1 << 62  # per-level hops, no fused chain
        mp.setenv("DGRAPH_TPU_RESIDENT", port_resident)
        teng = QueryEngine(port_store_of(jeng.store), device="cpu")
        if port_resident == "0":
            csr_only(teng)
        teng.expand_device_min = 1
        teng.chain_threshold = 1 << 62
        routes = {"resident" if port_resident == "force" else "csr", "empty"}
        yield jeng, teng, routes


def _goldens_setup(e):
    e.run("mutation { schema { %s } set { %s } }"
          % (test_goldens.SCHEMA, test_goldens.RDF))
    e.run('mutation { set { <0x4> <pwd> "hunter2" . } }')


def _film_setup(e):
    e.run("mutation { schema { %s } set { %s } }"
          % (test_film.SCHEMA, test_film.RDF))


@pytest.fixture(scope="module")
def goldens_pair():
    yield from _fixture_pair(_goldens_setup)


@pytest.fixture(scope="module")
def film_pair():
    yield from _fixture_pair(_film_setup)


def _run_reference(jeng, text, variables):
    led = jledger.Ledger()
    tok = jledger.activate(led)
    try:
        return jeng.run(text, variables), dict(led.hops)
    finally:
        jledger.deactivate(tok)


def _check(pair, text, variables):
    jeng, teng, routes = pair
    try:
        want, jhops = _run_reference(jeng, text, variables)
        err = None
    except Exception as e:  # noqa: BLE001 — the reference's verdict
        err = e
    if err is not None:
        # the port's error classes are its own copies: same name, same
        # message, same base
        with pytest.raises(Exception) as got:
            teng.run(text, variables)
        assert type(got.value).__name__ == type(err).__name__
        assert isinstance(got.value, ValueError) == isinstance(err, ValueError)
        assert str(got.value) == str(err)
        return
    got = teng.run(text, variables)
    assert body(got) == body(want)
    # the device route carried every expansion in both engines
    assert set(teng.stats["routes"]) <= routes, teng.stats["routes"]
    assert set(jhops) <= {"resident", "empty"}, jhops


GOLDEN_CASES = [
    c for c in golden_queries("test_goldens.py") + golden_queries("test_goldens2.py")
    if "mutation" not in c[1] or c[0].split("::")[1].startswith("PARSER_ERRORS")
]
FILM_CASES = [c for c in golden_queries("test_film.py") if "mutation" not in c[1]]


def test_case_lists_cover_the_goldens():
    assert len(GOLDEN_CASES) >= 120
    assert len(FILM_CASES) >= 10


@pytest.mark.parametrize(
    "text,variables", [c[1:] for c in GOLDEN_CASES], ids=[c[0] for c in GOLDEN_CASES]
)
def test_golden_parity(goldens_pair, text, variables):
    _check(goldens_pair, text, variables)


@pytest.mark.parametrize(
    "text,variables", [c[1:] for c in FILM_CASES], ids=[c[0] for c in FILM_CASES]
)
def test_film_parity(film_pair, text, variables):
    _check(film_pair, text, variables)


@pytest.fixture(scope="module")
def film_csr_pair():
    yield from _fixture_pair(_film_setup, port_resident="0")


@pytest.mark.parametrize(
    "text,variables", [c[1:] for c in FILM_CASES], ids=[c[0] for c in FILM_CASES]
)
def test_film_parity_on_the_csr_route(film_csr_pair, text, variables):
    """DGRAPH_TPU_RESIDENT=0: the port's staged-CSR route (torch
    expand_csr) answers like the reference's resident tier."""
    _check(film_csr_pair, text, variables)


TWO_HOP = "{ me(func: uid(0x1, 0x2, 0x3, 0x4)) { uid friend { uid name friend { uid name } } ~cares_for { uid } } }"


def test_resident_route_taken(goldens_pair):
    teng = goldens_pair[1]
    teng.run(TWO_HOP)
    # friend and friend.friend walk the kernel; ~cares_for finds no
    # reverse rows for these keepers
    assert teng.stats["routes"] == {"resident": 2, "empty": 1}
    assert teng.stats["edges"] > 0


def _mutate_both(pair, text):
    jeng, teng, _routes = pair
    assert body(teng.run(text)) == body(jeng.run(text))


@pytest.mark.parametrize("reseed", [False, True], ids=["merge", "reseed"])
def test_parity_after_uid_mutation(reseed):
    """A point mutation on a uid predicate reaches the port's resident
    CSR through the device merge (or, when it adds a source row, a
    reseed), and both engines answer alike afterwards."""
    gen = _fixture_pair(_goldens_setup)
    pair = next(gen)
    try:
        teng = pair[1]
        _check(pair, TWO_HOP, None)  # builds and seeds the arenas
        arena = teng.arenas.data("friend")
        ra0, epoch0 = arena.resident(), arena.epoch
        if reseed:  # 0xb has no friend edges yet: a new source row
            mu = "mutation { set { <0xb> <friend> <0x1> . <0x2> <friend> <0x4> . } }"
        else:
            mu = ("mutation { set { <0x2> <friend> <0x4> . <0x3> <friend> <0x1> . }"
                  " delete { <0x1> <friend> <0x3> . } }")
        _mutate_both(pair, mu)
        for text in (
            TWO_HOP,
            "{ me(func: uid(0x1, 0x2, 0x3, 0x4, 0xb)) { uid count(friend) ~friend { uid } } }",
            "{ me(func: has(friend)) { uid friend { uid } } }",
        ):
            _check(pair, text, None)
        arena = teng.arenas.data("friend")
        assert arena.epoch == epoch0 + 1
        assert (arena.resident() is ra0) is (not reseed)
        got = json.loads(body(teng.run("{ me(func: uid(0x2)) { friend { uid } } }")))
        assert {"_uid_": "0x4"} in got["me"][0]["friend"]
    finally:
        gen.close()


# geo and fulltext: functions the golden fixtures do not reach
GEO_TEXT_SCHEMA = """
    name: string @index(term, trigram) .
    bio: string @index(fulltext) .
    loc: geo @index(geo) .
    knows: uid @reverse .
"""
_PT = '"{\\"type\\":\\"Point\\",\\"coordinates\\":[%s,%s]}"^^<geo>'
_SQ = ('"{\\"type\\":\\"Polygon\\",\\"coordinates\\":[[[2.0,48.5],[2.8,48.5],'
       '[2.8,49.2],[2.0,49.2],[2.0,48.5]]]}"^^<geo>')
GEO_TEXT_RDF = "\n".join([
    '<0x1> <name> "Noor Haddad" .', "<0x1> <loc> %s ." % (_PT % ("2.35", "48.86")),
    '<0x1> <bio> "runs the bakery near the river and loves bread"@en .',
    '<0x2> <name> "Silas Reed" .', "<0x2> <loc> %s ." % (_PT % ("2.36", "48.87")),
    '<0x2> <bio> "a baker who ran marathons" .',
    '<0x3> <name> "Imre Toth" .', "<0x3> <loc> %s ." % (_PT % ("13.40", "52.52")),
    '<0x3> <bio> "Brot backen ist seine Leidenschaft"@de .',
    '<0x4> <name> "Paris Region" .', "<0x4> <loc> %s ." % _SQ,
    "<0x1> <knows> <0x2> .", "<0x2> <knows> <0x3> .", "<0x3> <knows> <0x1> .",
])
GEO_TEXT_CASES = [
    "{ me(func: near(loc, [2.35, 48.86], 2000)) { name knows { name } } }",
    "{ me(func: within(loc, [[[2.0, 48.0], [3.0, 48.0], [3.0, 49.5], [2.0, 49.5], [2.0, 48.0]]])) { name } }",
    "{ me(func: contains(loc, [2.5, 48.9])) { name } }",
    "{ me(func: intersects(loc, [[[2.3, 48.8], [2.4, 48.8], [2.4, 48.9], [2.3, 48.9], [2.3, 48.8]]])) { name } }",
    '{ me(func: anyoftext(bio, "baker bread")) { name bio ~knows { name } } }',
    '{ me(func: alloftext(bio, "baker marathon")) { name } }',
    '{ me(func: anyoftext(bio@de, "backen")) { name bio@de } }',
    "{ me(func: regexp(name, /Ree/)) { name knows { name knows { name } } } }",
]


@pytest.fixture(scope="module")
def geo_text_pair():
    yield from _fixture_pair(lambda e: e.run(
        "mutation { schema { %s } set { %s } }" % (GEO_TEXT_SCHEMA, GEO_TEXT_RDF)
    ))


@pytest.mark.parametrize("text", GEO_TEXT_CASES)
def test_geo_and_fulltext_parity(geo_text_pair, text):
    _check(geo_text_pair, text, None)
    assert json.loads(body(geo_text_pair[1].run(text)))["me"], "no match: a vacuous case"


# the root filter's `first: k` early exit: 5000 named uids, every third
# with an `e` edge; the windows past the first 1024-candidate chunk stop
# early, the others filter the whole set
FIRST_RDF = "\n".join(
    ['<0x%x> <name> "n%d" .' % (u, u) for u in range(1, 5001)]
    + ["<0x%x> <e> <0x%x> ." % (u, u + 1) for u in range(1, 5001, 3)]
)
FIRST_CASES = [
    "{ q(func: has(name), first: 5) @filter(has(e)) { uid } }",
    "{ q(func: has(name), first: 3, offset: 200) @filter(has(e)) { uid name } }",
    "{ q(func: has(name), first: 4, after: 0x800) @filter(has(e)) { uid } }",
    "{ q(func: has(name), first: 3000) @filter(has(e)) { uid } }",
    "{ q(func: has(name), first: 5, orderdesc: name) @filter(has(e)) { uid } }",
    "{ q(func: has(name), first: -5) @filter(has(e)) { uid } }",
]


@pytest.fixture(scope="module")
def first_pair():
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("DGRAPH_TPU_QOS", raising=False)  # the early exit's gate
        jeng = JaxEngine(JaxStore())
        jeng.run("mutation { schema { name: string . e: uid . } }")
        jeng.run("mutation { set { %s } }" % FIRST_RDF)
        teng = QueryEngine(port_store_of(jeng.store), device="cpu")
        yield jeng, teng


@pytest.mark.parametrize("text", FIRST_CASES)
def test_root_filter_first_early_exit_matches_reference(first_pair, text):
    jeng, teng = first_pair
    want = jeng.run(text)
    got = teng.run(text)
    assert body(got) == body(want)
    assert teng.stats["first_early_exit"] == jeng.stats["first_early_exit"]
    if text == FIRST_CASES[0]:
        assert teng.stats["first_early_exit"] == 1
        assert json.loads(body(got))["q"] == [
            {"_uid_": "0x%x" % u} for u in (1, 4, 7, 10, 13)
        ]
