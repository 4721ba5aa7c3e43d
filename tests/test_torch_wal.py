"""The port's WAL, snapshots and codec (``dgraph_tpu_torch.models.wal``,
``models/codec.py``) against the reference's.

The first ten cases are those of tests/test_wal.py, run on the port's
modules.  Then the two packages side by side, tolerance 0 (everything
is bytes or integers):

- one op sequence, drawn from a numpy seed, writes byte-identical
  ``wal.log``, ``wal-<n>.seg`` and ``snapshot.bin`` files in both;
- a store directory written by either package recovers in the other,
  and the golden queries then answer with identical bytes through the
  JAX engine and the port's engine.
"""

import datetime
import os
import shutil

import numpy as np
import pytest

from dgraph_tpu.models import codec as jcodec
from dgraph_tpu.models import store as jstore
from dgraph_tpu.models import types as jtypes
from dgraph_tpu.models import wal as jwal
from dgraph_tpu.query import QueryEngine as JaxEngine
from dgraph_tpu_torch.models import codec
from dgraph_tpu_torch.models import store as tstore
from dgraph_tpu_torch.models import types as ttypes
from dgraph_tpu_torch.models import wal as twal
from dgraph_tpu_torch.models.store import Edge
from dgraph_tpu_torch.models.types import TypeID, TypedValue
from dgraph_tpu_torch.models.wal import DurableStore, replay_records
from dgraph_tpu_torch.query import QueryEngine

from tests import test_goldens
from tests.torch_parity import body, golden_queries
from torch_pins import pinned_planner  # noqa: F401

# every route decision of both planners is pinned (tests/torch_pins.py)
pytestmark = pytest.mark.usefixtures("pinned_planner")


def _mk(tmp_path, name="s"):
    return DurableStore(str(tmp_path / name))


def _nb(store, pred, uid):
    """The sorted neighbours of ``uid`` under ``pred`` (the reference
    store's ``neighbors``)."""
    p = store.peek(pred)
    return [] if p is None else sorted(p.edges.get(uid, ()))


def _set_edge(s, pred, src, dst, facets=None):
    s.apply(Edge(pred=pred, src=src, dst=dst, facets=facets))


def _set_value(s, pred, uid, value, lang=""):
    s.apply(Edge(pred=pred, src=uid, value=value, lang=lang))


# -- the reference's cases (tests/test_wal.py) on the port --------------------


def test_edge_codec_roundtrip():
    dt = datetime.datetime(2001, 2, 3, 4, 5, 6)
    cases = [
        Edge(pred="friend", src=1, dst=2),
        Edge(pred="friend", src=1, dst=2, op="del"),
        Edge(pred="name", src=3, value=TypedValue(TypeID.STRING, "ábc"), lang="en"),
        Edge(pred="age", src=4, value=TypedValue(TypeID.INT, -42)),
        Edge(pred="score", src=5, value=TypedValue(TypeID.FLOAT, 2.5)),
        Edge(pred="alive", src=6, value=TypedValue(TypeID.BOOL, True)),
        Edge(pred="born", src=7, value=TypedValue(TypeID.DATETIME, dt)),
        Edge(
            pred="follows", src=8, dst=9,
            facets={"since": TypedValue(TypeID.INT, 1999),
                    "close": TypedValue(TypeID.BOOL, False)},
        ),
    ]
    for e in cases:
        d = codec.decode_edge(codec.encode_edge(e))
        assert (d.pred, d.src, d.dst, d.lang, d.op) == (
            e.pred, e.src, e.dst, e.lang, e.op
        )
        if e.value is None:
            assert d.value is None
        else:
            assert d.value.tid == e.value.tid and d.value.value == e.value.value
        assert (d.facets or {}).keys() == (e.facets or {}).keys()


def test_bulk_values_codec_and_durability(tmp_path):
    """BULKVALS record round-trips (order preserved, last-write-wins)
    and bulk-ingested values survive a restart."""
    dt = datetime.datetime(1999, 12, 31)
    items = [
        (1, "", TypedValue(TypeID.STRING, "first")),
        (2, "en", TypedValue(TypeID.STRING, "héllo")),
        (3, "", TypedValue(TypeID.INT, -7)),
        (4, "", TypedValue(TypeID.DATETIME, dt)),
        (1, "", TypedValue(TypeID.STRING, "second")),  # same key: wins
    ]
    pred, got = codec.decode_bulk_values(codec.encode_bulk_values("p", items))
    assert pred == "p" and len(got) == len(items)
    for (s0, l0, v0), (s1, l1, v1) in zip(items, got):
        assert (s0, l0, v0.tid, v0.value) == (s1, l1, v1.tid, v1.value)

    s = _mk(tmp_path)
    s.apply_schema("name: string @index(exact) .")
    s.bulk_set_values("name", items)
    assert s.value("name", 1).value == "second"  # input order applied
    s.close()
    r = _mk(tmp_path)
    assert r.value("name", 1).value == "second"
    assert r.value("name", 2, "en").value == "héllo"
    assert r.value("name", 3).value == -7
    assert r.value("name", 4).value == dt
    r.close()


def test_replay_restores_state(tmp_path):
    s = _mk(tmp_path)
    s.apply_schema("name: string @index(exact) .\nfriend: uid @reverse .")
    u1 = s.uids.assign("alice")
    u2 = s.uids.assign("bob")
    _set_edge(s, "friend", u1, u2)
    _set_value(s, "name", u1, TypedValue(TypeID.STRING, "Alice"))
    s.apply(Edge(pred="friend", src=u1, dst=u2, op="del"))
    _set_edge(s, "friend", u2, u1)
    s.close()

    r = _mk(tmp_path)
    assert r.uids.lookup("alice") == u1
    assert r.uids.lookup("bob") == u2
    assert _nb(r, "friend", u1) == []
    assert _nb(r, "friend", u2) == [u1]
    assert r.value("name", u1).value == "Alice"
    assert r.schema.peek("name").tokenizers == ["exact"]
    assert r.schema.peek("friend").reverse


def test_torn_tail_truncated(tmp_path):
    s = _mk(tmp_path)
    _set_edge(s, "p", 1, 2)
    s.close()
    wal = tmp_path / "s" / "wal.log"
    good = wal.read_bytes()
    wal.write_bytes(good + b"\x40\x00\x00\x00garbage")  # half a record
    r = _mk(tmp_path)
    assert _nb(r, "p", 1) == [2]
    assert wal.read_bytes() == good  # tail cut
    r.close()


def test_snapshot_compacts_and_recovers(tmp_path):
    s = _mk(tmp_path)
    s.apply_schema("name: string .")
    for i in range(1, 20):
        _set_edge(s, "friend", i, i + 1)
    _set_value(s, "name", 1, TypedValue(TypeID.STRING, "x"))
    s.snapshot()
    assert os.path.getsize(tmp_path / "s" / "wal.log") == 0
    _set_edge(s, "friend", 100, 200)  # post-snapshot delta
    s.close()

    r = _mk(tmp_path)
    assert _nb(r, "friend", 1) == [2]
    assert _nb(r, "friend", 100) == [200]
    assert r.value("name", 1).value == "x"
    assert r.schema.peek("name") is not None
    r.close()


def test_fresh_uids_not_reused_after_restart(tmp_path):
    s = _mk(tmp_path)
    got = s.uids.fresh(5)
    s.close()
    r = _mk(tmp_path)
    again = r.uids.fresh(1)[0]
    assert again > max(got)
    r.close()


def test_delete_predicate_durable(tmp_path):
    s = _mk(tmp_path)
    _set_edge(s, "gone", 1, 2)
    _set_edge(s, "kept", 1, 2)
    s.delete_predicate("gone")
    s.close()
    r = _mk(tmp_path)
    assert r.peek("gone") is None
    assert _nb(r, "kept", 1) == [2]
    r.close()


def test_facets_and_values_survive_snapshot(tmp_path):
    s = _mk(tmp_path)
    _set_edge(s, "knows", 1, 2, facets={"w": TypedValue(TypeID.FLOAT, 0.5)})
    _set_value(s, "bio", 3, TypedValue(TypeID.STRING, "hej"), lang="sv")
    s.snapshot()
    s.close()
    r = _mk(tmp_path)
    assert r.pred("knows").edge_facets[(1, 2)]["w"].value == 0.5
    assert r.value("bio", 3, "sv").value == "hej"
    r.close()


def test_mutation_path_journals_schema(tmp_path):
    s = _mk(tmp_path)
    eng = QueryEngine(s, device="cpu")
    eng.run(
        'mutation { schema { name: string @index(term) . } '
        'set { _:a <name> "Zoe" . } }'
    )
    s.close()
    r = _mk(tmp_path)
    eng2 = QueryEngine(r, device="cpu")
    out = eng2.run('{ q(func: anyofterms(name, "Zoe")) { name } }')
    assert out["q"] == [{"name": "Zoe"}]
    r.close()


def test_strict_replay_rejects_short_trailing_garbage(tmp_path):
    """A torn tail shorter than a record header is still corruption in
    strict mode (snapshot recovery)."""
    from dgraph_tpu_torch.models.wal import Wal

    p = str(tmp_path / "w.bin")
    w = Wal(p)
    w.append(b"good")
    w.close()
    with open(p, "ab") as f:
        f.write(b"\x01\x02\x03")  # 3 garbage bytes < header size
    with pytest.raises(ValueError, match="trailing garbage"):
        list(replay_records(p, strict=True))
    # lenient path recovers (and repairs) the good prefix
    assert [r for r in replay_records(p)] == [b"good"]


# -- the two packages side by side --------------------------------------------

PKGS = {
    "jax": (jwal, jstore, jtypes),
    "torch": (twal, tstore, ttypes),
}


def _op_sequence(pkg: str, d: str, seed: int) -> dict:
    """Run one op sequence drawn from ``seed`` on ``pkg``'s DurableStore
    in ``d``: schema, xid assigns, fresh uids, single sets and deletes
    (uid, value, lang, facets), a bulk edge group, a bulk value group,
    delete_predicate, a seal, more writes, a compact, more writes.
    Returns the bytes of every file it left, the sealed segment (copied
    before the compact deletes it) and the snapshot's replay."""
    wal_mod, store_mod, types_mod = PKGS[pkg]
    E, TV, T = store_mod.Edge, types_mod.TypedValue, types_mod.TypeID
    rng = np.random.default_rng(seed)
    ints = lambda n, hi: [int(x) for x in rng.integers(1, hi, size=n)]  # noqa: E731
    s = wal_mod.DurableStore(d)
    s.apply_schema("name: string @index(term) .\nfriend: uid @reverse .\n"
                   "age: int @index(int) .\nscore: float .")
    for i in range(6):
        s.uids.assign(f"xid-{seed}-{i}")
    s.uids.fresh(3)
    a, b = ints(12, 40), ints(12, 40)
    for x, y in zip(a, b):
        s.apply(E(pred="friend", src=x, dst=y))
    s.apply(E(pred="friend", src=a[0], dst=b[0], op="del"))
    s.apply(E(pred="knows", src=a[1], dst=b[1],
              facets={"w": TV(T.FLOAT, float(rng.random())),
                      "since": TV(T.INT, int(rng.integers(1990, 2030)))}))
    s.apply(E(pred="name", src=a[2], value=TV(T.STRING, "ábc déf"), lang="en"))
    s.apply(E(pred="score", src=a[3], value=TV(T.FLOAT, float(rng.random()))))
    s.bulk_set_uid_edges("friend", rng.integers(1, 300, 500), rng.integers(1, 300, 500))
    s.bulk_set_values("age", [(u, "", TV(T.INT, int(v)))
                              for u, v in zip(ints(40, 300), ints(40, 100))])
    s.apply(E(pred="gone", src=1, dst=2))
    s.delete_predicate("gone")
    out = {}
    seg = s.seal_segment()
    out["segment:" + os.path.basename(seg)] = open(seg, "rb").read()
    for x, y in zip(ints(5, 40), ints(5, 40)):
        s.apply(E(pred="friend", src=x, dst=y, op="del"))
    s.uids.reserve_through(int(rng.integers(400, 500)))
    s.compact()
    s.apply(E(pred="name", src=a[4], value=TV(T.STRING, "ghi")))
    s.bulk_set_uid_edges("friend", rng.integers(1, 600, 300), rng.integers(1, 600, 300))
    s.close()
    for name in sorted(os.listdir(d)):
        out[name] = open(os.path.join(d, name), "rb").read()
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_ops_write_byte_identical_files(tmp_path, seed):
    j = _op_sequence("jax", str(tmp_path / "jax"), seed)
    t = _op_sequence("torch", str(tmp_path / "torch"), seed)
    assert sorted(t) == sorted(j) == sorted(
        [k for k in j if k.startswith("segment:")] + ["snapshot.bin", "wal.log"])
    for name in j:
        assert t[name] == j[name], name
    assert len(j["snapshot.bin"]) > 8 and len(j["wal.log"]) > 0


def test_bulk_edges_record_matches_reference():
    """encode_bulk_edges builds its record by one join: byte-identical
    to the reference's, on strided, int32 and empty inputs."""
    rng = np.random.default_rng(5)
    src = rng.integers(0, 1 << 40, size=1001)
    dst = rng.integers(0, 1 << 31, size=1001).astype(np.int32)
    for a, b in ((src, dst), (src[::3], dst[::3]), (src[:0], dst[:0]),
                 (list(src[:7]), list(dst[:7]))):
        rec = codec.encode_bulk_edges("friend", a, b)
        assert rec == jcodec.encode_bulk_edges("friend", a, b)
        pred, s2, d2 = codec.decode_bulk_edges(rec)
        assert pred == "friend"
        assert np.array_equal(s2, np.asarray(a, np.int64))
        assert np.array_equal(d2, np.asarray(b, np.int64))


GOLDEN_READS = [
    c for c in golden_queries("test_goldens.py") + golden_queries("test_goldens2.py")
    if "mutation" not in c[1] and "PARSER_ERRORS" not in c[0]
]
MUTATION = "mutation { schema { %s } set { %s } }" % (test_goldens.SCHEMA, test_goldens.RDF)


def _write_goldens(pkg: str, d: str) -> None:
    """The goldens' fixture written through ``pkg``'s engine onto its
    DurableStore in ``d``, sealed and compacted half way so that the
    recovery reads a snapshot, a segment and the WAL."""
    wal_mod = PKGS[pkg][0]
    s = wal_mod.DurableStore(d)
    eng = (QueryEngine(s, device="cpu") if pkg == "torch" else JaxEngine(s))
    eng.run(MUTATION)
    s.snapshot()
    eng.run('mutation { set { <0x4> <pwd> "hunter2" . } }')
    s.seal_segment()
    eng.run('mutation { set { <0x2> <friend> <0x4> . } delete { <0x1> <friend> <0x3> . } }')
    s.close()


@pytest.fixture(scope="module", params=["jax", "torch"])
def recovered_pair(request, tmp_path_factory):
    """(JAX engine, port engine), each over its own package's recovery
    of one directory written by ``request.param``."""
    d = str(tmp_path_factory.mktemp("goldens") / "p")
    _write_goldens(request.param, d)
    jst = jwal.DurableStore(d)
    tst = twal.DurableStore(d)
    keys = ("snapshot_records", "segment_records", "wal_records", "segments",
            "torn_bytes")
    assert [tst.recovery[k] for k in keys] == [jst.recovery[k] for k in keys]
    assert all(tst.recovery[k] for k in keys[:4])
    yield JaxEngine(jst), QueryEngine(tst, device="cpu")
    jst.close()
    tst.close()


def test_golden_reads_cover_the_fixture():
    assert len(GOLDEN_READS) >= 100


@pytest.mark.parametrize("text,variables", [c[1:] for c in GOLDEN_READS],
                         ids=[c[0] for c in GOLDEN_READS])
def test_cross_package_recovery_answers_golden_reads_alike(recovered_pair, text, variables):
    jeng, teng = recovered_pair
    try:
        want = body(jeng.run(text, variables))
    except Exception as e:  # noqa: BLE001 — the reference's verdict
        with pytest.raises(Exception) as got:
            teng.run(text, variables)
        assert type(got.value).__name__ == type(e).__name__
        assert str(got.value) == str(e)
        return
    assert body(teng.run(text, variables)) == want


def test_recovered_stores_hold_the_same_state(tmp_path):
    """A directory of each package, recovered in both: every record of
    the recovered state (iter_state_records) is byte-identical, and
    both carry the write after the snapshot."""
    for writer in ("jax", "torch"):
        d = str(tmp_path / writer)
        _write_goldens(writer, d)
        j = jwal.DurableStore(d)
        t = twal.DurableStore(d)
        assert list(twal.iter_state_records(t)) == list(jwal.iter_state_records(j))
        assert _nb(t, "friend", 2) == sorted(j.neighbors("friend", 2))
        assert 4 in _nb(t, "friend", 2) and 3 not in _nb(t, "friend", 1)
        assert (t.version, t.pred_versions) == (j.version, j.pred_versions)
        j.close()
        t.close()
        shutil.rmtree(d)
