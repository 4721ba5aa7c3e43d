"""@recurse, shortest paths, @groupby and order-by through the port's
engine and the reference's, byte for byte, on a random skewed graph.

The graph is ``bench2hop.gen_edges``'s at a small size (uniform sources,
half the targets pareto-skewed, so a few nodes collect most in-edges) on
the uid predicate ``e`` (with ``@reverse``), a seeded int ``rank`` on
most nodes (a narrow range: ties), ``weight`` facets on a third of the
``e`` edges, and a facet-free uid predicate ``f`` for unweighted paths.
It is built in the reference's store and carried into the port with
``port_store_of``.  Both engines run every expansion on their device
route (``expand_device_min`` 1): the reference's resident Pallas gather
in interpret mode, the port's gather wrapper (its plain version on the
CPU), which must carry every level that has edges.

Tolerance: none (the response JSON, equal)."""

import json

import numpy as np
import pytest

from dgraph_tpu_torch import ops as tops
from dgraph_tpu_torch.bench2hop import gen_edges

from tests.test_torch_engine import _fixture_pair, _run_reference
from tests.torch_parity import body
from torch_pins import pinned_planner  # noqa: F401

# every route decision of both planners is pinned (tests/torch_pins.py)
pytestmark = pytest.mark.usefixtures("pinned_planner")

N_NODES, N_EDGES, N_RANK = 300, 1500, 40


def _setup(e):
    src, dst = gen_edges(N_NODES, N_EDGES)
    rng = np.random.default_rng(5)
    e.run("mutation { schema { e: uid @reverse . f: uid . "
          "rank: int @index(int) . } }")
    e.store.bulk_set_uid_edges("e", src, dst)
    pairs = sorted({(int(s), int(d)) for s, d in zip(src, dst)})
    lines = ['<0x%x> <rank> "%d" .' % (u, rng.integers(0, N_RANK))
             for u in range(1, N_NODES + 1) if rng.random() < 0.85]
    for s, d in pairs[::3]:
        lines.append("<0x%x> <e> <0x%x> (weight=%.1f) ." % (s, d, rng.integers(1, 40) / 4))
    for s in range(1, N_NODES + 1):  # f: a ring with chords, no facets
        for d in (s + 1, s + 7):
            lines.append("<0x%x> <f> <0x%x> ." % (s, 1 + (d - 1) % N_NODES))
    e.run("mutation { set { %s } }" % "\n".join(lines))


@pytest.fixture(scope="module")
def surface_pair():
    yield from _fixture_pair(_setup)


def _seeds(k, seed):
    """k sources of ``e`` edges, drawn with a fixed seed."""
    src, _dst = gen_edges(N_NODES, N_EDGES)
    have = np.unique(src)
    return ", ".join("0x%x" % u for u in
                     np.random.default_rng(seed).choice(have, k, replace=False))


def _reach(seed_uid, hops):
    """A node exactly ``hops`` hops from ``seed_uid`` over ``e``."""
    src, dst = gen_edges(N_NODES, N_EDGES)
    seen, ring = {seed_uid}, {seed_uid}
    for _ in range(hops):
        ring = {int(d) for s, d in zip(src, dst) if int(s) in ring} - seen
        seen |= ring
    return "0x%x" % min(ring)


S4, S1 = _seeds(4, 1), _seeds(1, 2)
A = int(S1, 16)
FAR = _reach(A, 3)

CASES = {
    # @recurse: depth, cycles, value leaves, two templates, a filter
    "recurse_depth3_values": "{ me(func: uid(%s)) @recurse(depth: 3) { uid rank e } }" % S4,
    "recurse_cycles_deep": "{ recurse(func: uid(%s), depth: 12) { rank e } }" % S1,
    "recurse_two_templates": "{ me(func: uid(%s)) @recurse(depth: 2) { uid e ~e } }" % S1,
    "recurse_filtered": ("{ me(func: uid(%s)) @recurse(depth: 3) "
                         "{ uid rank e @filter(ge(rank, 20)) } }" % S4),
    "recurse_var_block": ("{ var(func: uid(%s)) @recurse(depth: 3) { r as e } "
                          "q(func: uid(r)) { uid rank } }" % S4),
    # shortest: weighted (e carries weight facets) and unweighted (f)
    "shortest_weighted_1": "{ shortest(from: %s, to: %s) { e } }" % (S1, FAR),
    "shortest_weighted_2": "{ shortest(from: %s, to: %s, numpaths: 2) { e } }" % (S1, FAR),
    "shortest_weighted_3": "{ shortest(from: %s, to: %s, numpaths: 3) { e } }" % (S1, FAR),
    "shortest_unweighted_2": "{ shortest(from: 0x1, to: 0x20, numpaths: 2) { f } }",
    "shortest_unreachable": "{ shortest(from: %s, to: 0x%x) { e } }" % (S1, N_NODES + 7),
    "shortest_then_block": ("{ p as shortest(from: %s, to: %s, numpaths: 2) { e } "
                            "q(func: uid(p)) { uid rank } }" % (S1, FAR)),
    # @groupby: root and child, by value and by uid edge
    "groupby_root_value": "{ me(func: uid(%s)) @groupby(rank) { count(uid) } }" % S4,
    "groupby_root_edge": "{ me(func: has(e)) @groupby(e) { count(uid) } }",
    "groupby_child_value": "{ me(func: uid(%s)) { e @groupby(rank) { count(uid) } } }" % S4,
    "groupby_child_edge": "{ me(func: uid(%s)) { uid e @groupby(e) { count(uid) } } }" % S4,
    # order-by over the value arena: ties, missing values, pagination
    "order_root": "{ me(func: has(rank), orderasc: rank, first: 25) { uid rank } }",
    "order_child_2hop": ("{ me(func: uid(%s)) { e { e (orderdesc: rank, first: 2) "
                         "{ uid } } } }" % S4),
    "order_offset_after": ("{ me(func: has(rank), orderdesc: rank, offset: 5, "
                           "first: 10, after: 0x40) { uid rank } }"),
}
# the cases that expand at least one level over e or f (a root @groupby
# reads the arena's host mirrors, a root order-by expands nothing)
EXPANDS = {n for n in CASES
           if not n.startswith(("groupby_root", "order_root", "order_offset"))}
# both engines serve an internal single-template @recurse as one fused
# device BFS (ops.multi_hop): one gather a level, which the reference's
# ledger counts as no hop and the port counts under fused_gathers
FUSED = {"recurse_var_block": 3}


def _serve(pair, name, monkeypatch):
    """Both engines answer CASES[name] alike; returns (the port's
    response, its stats, its gather calls, the reference's hops)."""
    jeng, teng, routes = pair
    text = CASES[name]
    calls = []

    def counting(*a, **k):
        calls.append(1)
        return gather(*a, **k)

    gather = tops.gather_packed
    monkeypatch.setattr(tops, "gather_packed", counting)
    want, jhops = _run_reference(jeng, text, None)
    got = teng.run(text)
    assert body(got) == body(want)
    assert set(teng.stats["routes"]) <= routes, teng.stats["routes"]
    return got, teng.stats, len(calls), jhops


@pytest.mark.parametrize("name", sorted(CASES))
def test_query_surface_parity(surface_pair, name, monkeypatch):
    got, stats, calls, jhops = _serve(surface_pair, name, monkeypatch)
    r = stats["routes"]
    # the gather wrapper carried every level that had edges to walk: per
    # level on the resident route, or inside the fused BFS
    assert stats["fused_gathers"] == FUSED.get(name, 0)
    assert calls == r.get("resident", 0) + stats["fused_gathers"]
    if name in EXPANDS:
        assert calls > 0
    if name not in FUSED:
        assert set(jhops) <= {"resident", "empty"}, jhops
    if name.startswith("order_"):
        assert stats["device_order"] >= 1
    out = json.loads(body(got))
    assert any(out.values()) != (name == "shortest_unreachable"), out


def test_recurse_var_block_per_level(surface_pair, monkeypatch):
    """With the fused BFS off (``fused_hop`` "0") the port walks the
    var-block @recurse level by level, every level through the gather on
    the resident route, and still answers the reference's bytes."""
    teng = surface_pair[1]
    monkeypatch.setattr(teng.expander, "fused_hop", "0")
    _got, stats, calls, _jhops = _serve(surface_pair, "recurse_var_block",
                                        monkeypatch)
    assert stats["fused_gathers"] == 0
    assert calls == stats["routes"].get("resident", 0) > 0


@pytest.mark.parametrize("off", [False, "0"])
def test_fused_hop_false_reads_as_off(surface_pair, off, monkeypatch):
    """``fused_hop`` holds the reference's string; the older bool
    spelling maps onto it (True "1", False "0"), so ``False`` turns the
    fused var-block @recurse off and the classed route with it."""
    ex = surface_pair[1].expander
    monkeypatch.setattr(ex, "fused_hop", True)
    assert ex.fused_hop == "1"
    monkeypatch.setattr(ex, "fused_hop", off)
    assert ex.fused_hop == "0" and not ex._use_classed()
    _got, stats, calls, _jhops = _serve(surface_pair, "recurse_var_block",
                                        monkeypatch)
    assert stats["fused_gathers"] == 0
    assert calls == stats["routes"].get("resident", 0) > 0


def test_fused_hop_env_off_walks_recurse_per_level_in_both(monkeypatch):
    """DGRAPH_TPU_FUSED_HOP=0, read by both engines when they are built,
    turns the fused var-block @recurse off in both: the reference's
    ledger then counts its levels as resident hops (the fused BFS counts
    none), and the port walks the same levels through the gather, with
    the same body."""
    monkeypatch.setenv("DGRAPH_TPU_FUSED_HOP", "0")
    gen = _fixture_pair(_setup)
    pair = next(gen)
    try:
        jeng, teng, _routes = pair
        assert jeng.expander.fused_hop == teng.expander.fused_hop == "0"
        _got, stats, calls, jhops = _serve(pair, "recurse_var_block", monkeypatch)
        assert stats["fused_gathers"] == 0
        assert calls == stats["routes"].get("resident", 0) > 0
        assert jhops.get("resident", 0) == stats["routes"]["resident"]
    finally:
        gen.close()
