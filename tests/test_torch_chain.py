"""The port's fused uid chain (``dgraph_tpu_torch/query/chain.py``) against
the reference's, query by query.

Each graph is built in the reference's store and carried into the port
with ``port_store_of``.  Three engines answer every query: the
reference and the port with every fusable chain fused
(``chain_threshold`` 0; the reference with ``DGRAPH_TPU_MXU_JOIN=0``, so
that it takes its gather chain, not the tile route), and the port with
the chain pinned off (its per-level path).  The three bodies must be
equal, and where the reference fused a level the port must have fused
one too.  The port's chain runs on its resident route (the gather
wrapper's plain version on the CPU); the film shapes run once more on
its staged-CSR route.  The queries and graphs are those of
``tests/test_chain.py``.

Tolerance: none (the response JSON, equal)."""

import json

import numpy as np
import pytest

from dgraph_tpu.models import PostingStore as JaxStore
from dgraph_tpu.query import QueryEngine as JaxEngine
from dgraph_tpu_torch import ops as tops
from dgraph_tpu_torch.query import QueryEngine

from tests.test_chain import QUERIES, SCHEMA
from tests.torch_parity import REFERENCE_ENV, body, port_store_of

# the reference compiles one chain program per capacity tuple
pytestmark = pytest.mark.compile_budget(400)

PINNED_OFF = 1 << 62


@pytest.fixture(autouse=True)
def _reference_env(monkeypatch):
    for k, v in {**REFERENCE_ENV, "DGRAPH_TPU_MXU_JOIN": "0"}.items():
        monkeypatch.setenv(k, v)


def _engines(setup, threshold=0, port_resident="force"):
    """(reference, port, port with the chain pinned off) over the graph
    ``setup`` writes into a reference engine."""
    jeng = JaxEngine(JaxStore())
    setup(jeng)
    jeng.chain_threshold = threshold
    out = [jeng]
    for thr in (threshold, PINNED_OFF):
        teng = QueryEngine(port_store_of(jeng.store), device="cpu")
        teng.expander.resident_mode = port_resident
        teng.chain_threshold = thr
        out.append(teng)
    return out


def _check(engines, q):
    """The three bodies agree; returns (reference, port) fused levels."""
    jeng, teng, tplain = engines
    want = body(jeng.run(q))
    assert body(teng.run(q)) == want
    assert body(tplain.run(q)) == want
    assert tplain.stats["chain_fused_levels"] == 0
    jf, tf = jeng.stats["chain_fused_levels"], teng.stats["chain_fused_levels"]
    if jf:
        assert tf >= jf, (q, jeng.stats["chain_reject"], teng.stats["chain_reject"])
    return jf, tf


def _random_graph(seed: int, n: int = 60):
    """tests/test_chain.py's build_engine graph."""
    def setup(e):
        rng = np.random.default_rng(seed)
        lines = []
        for u in range(1, n + 1):
            lines.append(f'<0x{u:x}> <name> "P{u}" .')
            for pred, fan in (("knows", 4), ("likes", 3), ("boss", 1)):
                for v in rng.integers(1, n + 1, size=rng.integers(0, fan + 1)):
                    lines.append(f"<0x{u:x}> <{pred}> <0x{int(v):x}> .")
        e.run("mutation { schema { %s } }" % SCHEMA)
        e.run("mutation { set { %s } }" % "\n".join(lines))
    return setup


@pytest.mark.parametrize("qi", range(len(QUERIES)))
@pytest.mark.parametrize("seed", [1, 2])
def test_chain_matches_reference(qi, seed):
    _check(_engines(_random_graph(seed)), QUERIES[qi])


def test_chain_fuses_and_records_rejects():
    """A plain 3-level chain fuses in the port as in the reference, with
    no reject; a chain below the threshold says why."""
    engines = _engines(_random_graph(3))
    jf, tf = _check(engines, '{ q(func: eq(name, "P1")) { knows { likes '
                             '{ boss { name } } } } }')
    assert jf > 0 and tf > 0
    teng = engines[1]
    assert teng.stats["chain_reject"] == []
    teng.chain_threshold = 1 << 60
    teng.run("{ q(func: uid(0x1)) { knows { knows { name } } } }")
    assert any("below threshold" in r for r in teng.stats["chain_reject"])
    assert teng.stats["chain_fused_levels"] == 0


def test_chain_deep_and_empty_levels():
    """A chain that dead-ends mid-way (an empty tail predicate)."""
    def setup(e):
        e.run("mutation { schema { %s } }" % SCHEMA)
        e.run('mutation { set { <0x1> <name> "A" . <0x1> <knows> <0x2> . '
              "<0x2> <likes> <0x3> . } }")
    _check(_engines(setup),
           '{ q(func: eq(name, "A")) { knows { likes { boss { name } } } } }')


def test_light_mode_keeps_rowless_leaf_uids():
    """Light-mode dest sets keep leaf uids above every chain arena's
    source range (the next frontier is bounded by the arena's distinct
    targets, not its source universe)."""
    def setup(e):
        e.run("mutation { schema { %s } }" % SCHEMA)
        lines = ['<0x1> <name> "root" .']
        for mid in range(2, 10):
            lines.append(f"<0x1> <knows> <0x{mid:x}> .")
            for leaf in range(4):
                lines.append(f"<0x{mid:x}> <likes> <0x{0x1000 + mid * 8 + leaf:x}> .")
        e.run("mutation { set { %s } }" % "\n".join(lines))
    engines = _engines(setup)
    q = ('{ var(func: eq(name, "root")) { knows { L as likes } } '
         "  r(func: uid(L)) { _uid_ } }")
    jf, tf = _check(engines, q)
    assert jf > 0 and tf > 0
    got = sorted(int(x["_uid_"], 16) for x in json.loads(body(engines[1].run(q)))["r"])
    assert got == sorted({0x1000 + m * 8 + l for m in range(2, 10) for l in range(4)})


def test_chain_cap_u_clamped_to_slot_count():
    """Every target distinct: the deduplicated frontier's capacity must
    not exceed the level's slots (16 roots x 14 distinct targets)."""
    def setup(e):
        lines = []
        t = 10_000
        for r in range(1, 17):
            for _k in range(14):
                t += 1
                lines.append(f"<0x{r:x}> <knows> <0x{t:x}> .")
                lines.append(f"<0x{t:x}> <likes> <0x{t + 50_000:x}> .")
        e.run("mutation { set { %s } }" % "\n".join(lines))
    q = ("{ var(func: uid(%s)) { x as knows { likes } } "
         "  r(func: uid(x)) { _uid_ } }" % ", ".join(str(i) for i in range(1, 17)))
    engines = _engines(setup)
    jf, tf = _check(engines, q)
    assert jf > 0 and tf > 0
    assert len(json.loads(body(engines[1].run(q)))["r"]) == 16 * 14


def _film_setup(e, n_dirs=4, films_per=80):
    """tests/test_chain.py's star-shaped film graph."""
    e.run("mutation { schema { tag: string @index(term) . year: int . } }")
    lines = []
    uid = 1000
    for d in range(1, n_dirs + 1):
        for _f in range(films_per):
            uid += 1
            lines.append(f"<0x{d:x}> <film> <0x{uid:x}> .")
            lines.append(f'<0x{uid:x}> <year> "{1980 + (uid % 40)}"^^<xs:int> .')
            if uid % 2 == 0:
                lines.append(f'<0x{uid:x}> <tag> "good" .')
            for a in range(3):
                lines.append(f"<0x{uid:x}> <starring> <0x{uid * 10 + a:x}> .")
    e.run("mutation { set { %s } }" % "\n".join(lines))


# (query, whether its decorated level fuses in the reference)
FILM_QUERIES = [
    # filtered + ordered + windowed level
    ('{ d(func: uid(1, 2, 3, 4)) { film (orderdesc: year, first: 5) '
     '@filter(anyofterms(tag, "good")) { starring { _uid_ } } } }', True),
    # not-filters stay on the per-level path
    ('{ d(func: uid(1, 2)) { film @filter(not anyofterms(tag, "good")) '
     "{ _uid_ } } }", False),
    # filter only, window only, order only
    ('{ d(func: uid(1, 2, 3, 4)) { film @filter(anyofterms(tag, "good")) '
     "{ starring { _uid_ } } } }", True),
    ("{ d(func: uid(1, 2, 3, 4)) { film (first: 7, offset: 2) "
     "{ starring { _uid_ } } } }", True),
    ("{ d(func: uid(1, 2, 3, 4)) { film (orderasc: year) "
     "{ starring { _uid_ } } } }", True),
    # first: -N is "last N", host semantics: never fused
    ("{ d(func: uid(1, 2)) { film (orderasc: year, first: -3) { _uid_ } } }", False),
]


@pytest.mark.parametrize("route", ["resident", "csr"])
@pytest.mark.parametrize("qi", range(len(FILM_QUERIES)))
def test_film_shapes(qi, route):
    q, fuses = FILM_QUERIES[qi]
    engines = _engines(_film_setup, threshold=1,
                       port_resident="force" if route == "resident" else "0")
    jf, tf = _check(engines, q)
    if fuses:
        assert jf >= 2 and tf >= 2
    r = engines[1].stats["routes"]
    # the chain's levels never took the per-level device routes
    assert "resident" not in r and "csr" not in r, r


def test_parity_after_a_new_source_row():
    """A mutation adding a source row between two chain queries renumbers
    the arena's rows: its delta patches the arena in place and must drop
    the uid->row table, so the same queries stay byte-identical."""
    engines = _engines(_random_graph(1))
    queries = [q for q in QUERIES if "has(" not in q]  # keep the arena patchable
    for q in queries:
        _check(engines, q)
    teng = engines[1]
    a = teng.arenas.data("knows")
    assert a._lut is not None, "the chain queries built no uid->row table"
    rowless = np.setdiff1d(np.arange(1, 61), a.h_src)
    assert len(rowless), "every uid already has a knows row"
    new = int(rowless[len(rowless) // 2])
    assert new < a.h_src[-1]  # inserted before existing rows: renumbers them
    mu = ("mutation { set { <0x%x> <knows> <0x1> . <0x%x> <knows> <0x2> . "
          "<0x1> <knows> <0x%x> . } }" % (new, new, new))
    for e in engines:
        e.run(mu)
    epoch = a.epoch
    assert teng.arenas.data("knows") is a and a.epoch == epoch + 1
    assert a._lut is None and new in a.h_src
    for q in queries:
        _check(engines, q)
    # and the renumbered rows are walked: new's edges reach 0x1 and 0x2
    got = json.loads(body(teng.run("{ q(func: uid(0x%x)) { knows { _uid_ "
                                   "knows { _uid_ } } } }" % new)))
    assert {k["_uid_"] for k in got["q"][0]["knows"]} >= {"0x1", "0x2"}
    assert teng.stats["chain_fused_levels"] == 2


# (name, query, resident mode): the staged pass, the multi-hop pass and
# the fused @recurse, each of which must reach the gather
RAISING = [
    ("staged", '{ q(func: eq(name, "P1")) { knows { likes { boss { name } } } } }',
     "force"),
    ("scan", '{ var(func: eq(name, "P1")) { knows { y as knows } } '
             "r(func: uid(y)) { name } }", "0"),
    ("recurse", '{ var(func: eq(name, "P1")) @recurse(depth: 3) { r as knows } '
                "q(func: uid(r)) { name } }", "0"),
]


@pytest.mark.parametrize("name,q,resident", RAISING, ids=[r[0] for r in RAISING])
def test_gather_fault_propagates(name, q, resident, monkeypatch):
    """No fallback: when the gather raises inside a fused dispatch, the
    request raises; it is not answered by the per-level path."""
    _jeng, teng, tplain = _engines(_random_graph(1), port_resident=resident)
    want = body(tplain.run(q))
    assert body(teng.run(q)) == want
    assert teng.stats["fused_gathers"] > 0
    if name != "recurse":
        assert teng.stats["chain_fused_levels"] >= 2

    def fault(*_a, **_k):
        raise RuntimeError("injected device fault")

    monkeypatch.setattr(tops, "gather_packed", fault)
    with pytest.raises(RuntimeError, match="injected device fault"):
        teng.run(q)


# light same-arena chains the multi-hop pass serves: a var on the first
# and the last level, a var on the middle level only, and none but the
# chain's end; only the frontiers the host consumes are fetched
SCANNED = [
    '{ var(func: uid(0x1, 0x2, 0x3)) { a as knows { knows { c as knows } } } '
    "q(func: uid(a)) { count() } r(func: uid(c)) { name } }",
    '{ var(func: uid(0x4, 0x9)) { knows { b as knows { knows } } } '
    "q(func: uid(b)) { name } }",
    '{ var(func: eq(name, "P7")) { knows { knows { d as knows } } } '
    "q(func: uid(d)) { count() } }",
]


@pytest.mark.parametrize("qi", range(len(SCANNED)))
def test_scan_serves_light_chains(qi, monkeypatch):
    """Each query takes the multi-hop pass once, fuses its three levels
    and answers the reference's bytes, vars on any level included."""
    engines = _engines(_random_graph(4))
    calls = []
    multi_hop = tops.multi_hop

    def counting(*a, **k):
        calls.append(a[4])
        return multi_hop(*a, **k)

    monkeypatch.setattr(tops, "multi_hop", counting)
    _jf, tf = _check(engines, SCANNED[qi])
    assert calls == [3] and tf == 3
