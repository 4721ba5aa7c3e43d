"""The port's native N-Quad path (``dgraph_tpu_torch/native``,
``serve/bulk.py``, the fast-path hook of ``serve/mutations.py``).

The six cases of tests/test_native.py, run on the port: the C++ bulk
path and the Python parser give the same store state on the same body.
Then against the reference: the port's scanner, built by g++ from its
own copy of ``nquad_scan.cpp`` into ``dgraph_tpu_torch/_build/``, returns
the same arrays as the reference's on the same texts (tolerance 0); the
route counter; and a failed build raises instead of falling back.
"""

import numpy as np
import pytest

from dgraph_tpu import native as jnative
from dgraph_tpu_torch import native
from dgraph_tpu_torch.gql.ast import Mutation
from dgraph_tpu_torch.models import PostingStore
from dgraph_tpu_torch.ops import _build
from dgraph_tpu_torch.serve.mutations import apply_mutation
from dgraph_tpu_torch.utils.metrics import BULK_QUADS
from torch_pins import pinned_planner  # noqa: F401

# every route decision of both planners is pinned (tests/torch_pins.py)
pytestmark = pytest.mark.usefixtures("pinned_planner")

CORPUS = r"""
<0x1> <name> "Noor Haddad" .
<0x1> <age> "44"^^<xs:int> .
<0x2> <name> "Silas \"the\" Reed" .
<0x1> <friend> <0x2> (since=2009-08-15, close=true, weight=1.5) .
<0x2> <friend> <0x3> .
_:blank1 <name> "Blanka" .
_:blank1 <knows> _:blank2 .
<http://example.org/alice> <name> "Alice xid"@en .
<0x3> <bio> "line one\nline two" .
<0x4> <score> "2.75"^^<xs:float> .   # trailing comment
# full comment line
<0x5> <alive> "true"^^<xs:boolean> .
<0x6> <tag> "hola"@es .
<0x6> <tag> "hello"@en .
<0x6> <tag> "fallback" .
"""

SCHEMA = """
    name: string @index(term) .
    age: int @index(int) .
    friend: uid @reverse .
    score: float .
    alive: bool .
"""


def _nb(store, pred, uid):
    p = store.peek(pred)
    return [] if p is None else sorted(p.edges.get(uid, ()))


def _route(no_native: bool, monkeypatch):
    if no_native:
        monkeypatch.setenv("DGRAPH_TPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("DGRAPH_TPU_NO_NATIVE", raising=False)


def _apply(no_native: bool, monkeypatch):
    _route(no_native, monkeypatch)
    st = PostingStore()
    st.apply_schema(SCHEMA)
    blanks = apply_mutation(st, Mutation(set_nquads=CORPUS))
    return st, blanks


def _canon(st: PostingStore, blanks):
    """State with blank/xid uids replaced by stable labels: assignment
    ORDER differs between the two paths (both are legal — uids for blank
    nodes are arbitrary), so parity is up to renaming."""
    label = {u: f"blank:{b}" for b, u in blanks.items()}
    for xid, u in st.uids.snapshot().items():
        label[u] = f"xid:{xid}"

    def lab(u):
        return label.get(u, u)

    out = {}
    for pr in st.predicates():
        p = st.pred(pr)
        out[pr] = (
            {lab(u): sorted(lab(d) for d in s) for u, s in p.edges.items()},
            {(lab(u), l): (v.tid, v.value) for (u, l), v in p.values.items()},
            {(lab(a), lab(b)): {fk: (fv.tid, fv.value) for fk, fv in f.items()}
             for (a, b), f in p.edge_facets.items()},
        )
    return out


# -- the reference's cases (tests/test_native.py) on the port -----------------


def test_native_matches_python(monkeypatch):
    st_n, blanks_n = _apply(False, monkeypatch)
    st_p, blanks_p = _apply(True, monkeypatch)
    assert sorted(blanks_n) == sorted(blanks_p)
    assert _canon(st_n, blanks_n) == _canon(st_p, blanks_p)


def test_native_rejects_what_python_rejects(monkeypatch):
    from dgraph_tpu_torch.rdf.parse import ParseError

    monkeypatch.delenv("DGRAPH_TPU_NO_NATIVE", raising=False)
    st = PostingStore()
    with pytest.raises(ParseError):
        apply_mutation(st, Mutation(set_nquads='<0x1> <name> "unterminated .'))
    with pytest.raises(ParseError):
        apply_mutation(st, Mutation(set_nquads="<0x1> <name> missing_dot"))
    # '*' is delete-only; in a set block both paths must reject it
    with pytest.raises((ParseError, ValueError)):
        apply_mutation(st, Mutation(set_nquads="<0x1> * * ."))
    # the grammar requires \s+ BETWEEN terms and [^\S\n]+ before a label:
    # the scanner must not accept what the Python grammar refuses
    with pytest.raises(ParseError):
        apply_mutation(st, Mutation(set_nquads="<0x1><p> <0x2> ."))
    with pytest.raises(ParseError):
        apply_mutation(st, Mutation(set_nquads="<0x1> <p><0x2> ."))
    with pytest.raises(ParseError):
        apply_mutation(st, Mutation(set_nquads='<0x1> <p> "v"<g> .'))


def test_bulk_edges_wal_roundtrip(tmp_path):
    from dgraph_tpu_torch.models.wal import DurableStore

    st = DurableStore(str(tmp_path / "d"))
    st.bulk_set_uid_edges("friend", np.array([1, 1, 2]), np.array([2, 3, 4]))
    st.close()
    st2 = DurableStore(str(tmp_path / "d"))
    assert _nb(st2, "friend", 1) == [2, 3]
    assert _nb(st2, "friend", 2) == [4]
    st2.close()


def test_value_order_preserved_across_facet_quads(monkeypatch):
    """Last-write-wins for the same (pred, src, lang) must follow input
    order even when the earlier write carries facets (the native path
    must not segregate faceted quads into a later phase)."""
    body = '<0x1> <name> "old" (src=a) .\n<0x1> <name> "new" .'
    for no_native in (False, True):
        _route(no_native, monkeypatch)
        st = PostingStore()
        apply_mutation(st, Mutation(set_nquads=body))
        assert st.value("name", 1).value == "new", f"no_native={no_native}"


def test_bad_value_in_set_applies_no_edges(monkeypatch):
    """All-or-nothing within one set block: a schema type-conversion
    error on a LATER value quad must fail the request before the fast
    path durably applies EARLIER uid edges (both paths must agree)."""
    body = '<0x1> <link> <0x2> .\n<0x1> <age> "notanint" .'
    for no_native in (False, True):
        _route(no_native, monkeypatch)
        st = PostingStore()
        st.apply_schema("age: int .\nlink: uid .")
        with pytest.raises(Exception):
            apply_mutation(st, Mutation(set_nquads=body))
        assert _nb(st, "link", 1) == [], f"no_native={no_native}"


def test_bad_delete_applies_no_sets(monkeypatch):
    """A delete that fails uid conversion must fail the whole mutation
    BEFORE the fast path durably applies the set block."""
    monkeypatch.delenv("DGRAPH_TPU_NO_NATIVE", raising=False)
    st = PostingStore()
    with pytest.raises(ValueError):
        apply_mutation(
            st,
            Mutation(set_nquads='<0x1> <name> "x" .', del_nquads="<0x1> <p> <0xzz> ."),
        )
    assert st.value("name", 1) is None


# -- the port's scanner against the reference's -------------------------------

FIELDS = ("n", "subj_idx", "pred_idx", "obj_idx", "lang_idx", "type_idx",
          "lit_s", "lit_e", "facet_s", "facet_e", "flags", "subj_spans",
          "subj_uid", "pred_spans", "obj_spans", "obj_uid", "lang_spans",
          "type_spans")


def _random_nquads(seed: int, n: int) -> str:
    """N-Quads of every shape the scanner interns, drawn from ``seed``:
    hex and string-xid subjects, blank nodes, uid objects, plain, typed,
    language-tagged and escaped literals, facets, labels, comments."""
    rng = np.random.default_rng(seed)
    words = ["alpha", "bravo", "charlie", "dé\\\"lta", "echo\\nfox", "Ω"]
    preds = ["friend", "name", "age", "tag", "f.x-y", "_p"]
    lines = []
    for _ in range(n):
        k = int(rng.integers(0, 4))
        subj = ("<0x%x>" % int(rng.integers(1, 1 << 40)), "_:b%d" % int(rng.integers(0, 30)),
                "<xid-%d>" % int(rng.integers(0, 50)), "<0x%X>" % int(rng.integers(1, 99)))[k]
        pred = "<%s>" % preds[int(rng.integers(0, len(preds)))]
        kind = int(rng.integers(0, 6))
        if kind == 0:
            obj = "<0x%x>" % int(rng.integers(1, 1 << 31))
        elif kind == 1:
            obj = "_:b%d" % int(rng.integers(0, 30))
        elif kind == 2:
            obj = '"%d"^^<xs:int>' % int(rng.integers(-999, 999))
        elif kind == 3:
            obj = '"%s"@%s' % (words[int(rng.integers(0, 6))], ("en", "ru", "zh-Hans")[int(rng.integers(0, 3))])
        else:
            obj = '"%s %s"' % (words[int(rng.integers(0, 6))], words[int(rng.integers(0, 6))])
        tail = ""
        if rng.random() < 0.15:
            tail += " (since=2009-08-15, w=%d)" % int(rng.integers(0, 9))
        if rng.random() < 0.05:
            tail = " <graph-%d>" % int(rng.integers(0, 3)) + tail
        line = f"{subj} {pred} {obj}{tail} ."
        if rng.random() < 0.1:
            line += "   # a comment"
        lines.append(line)
        if rng.random() < 0.05:
            lines.append("# a comment line")
    return "\n".join(lines) + "\n"


TEXTS = {"corpus": CORPUS, "stars": "<0x1> * * .\n<0x2> <p> * .",
         "empty": "", "blank_lines": "\n\n   \n"}
TEXTS.update({f"random_{s}": _random_nquads(s, 400) for s in range(4)})


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_scanner_arrays_match_reference(name, monkeypatch):
    monkeypatch.delenv("DGRAPH_TPU_NO_NATIVE", raising=False)
    if jnative._lib is None:  # a test in this worker may have cached "off"
        monkeypatch.setattr(jnative, "_tried", False)
    text = TEXTS[name]
    want = jnative.scan(text)
    assert want is not None, "the reference's scanner did not build"
    got = native.scan(text)
    assert got.buf == want.buf
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(got, f)), np.asarray(getattr(want, f))), f
    if name.startswith("random"):
        assert got.n == 400


@pytest.mark.parametrize("text", ['<0x1> <name> "unterminated .', "<0x1><p> <0x2> .",
                                  "<0x1> <p> <0x2>"])
def test_scanner_rejects_what_the_reference_rejects(text, monkeypatch):
    monkeypatch.delenv("DGRAPH_TPU_NO_NATIVE", raising=False)
    if jnative._lib is None:
        monkeypatch.setattr(jnative, "_tried", False)
    with pytest.raises(ValueError) as want:
        jnative.scan(text)
    with pytest.raises(ValueError) as got:
        native.scan(text)
    assert str(got.value) == str(want.value)


def test_routes_are_counted(monkeypatch):
    before = BULK_QUADS.snapshot()
    _apply(False, monkeypatch)
    mid = BULK_QUADS.snapshot()
    _apply(True, monkeypatch)
    after = BULK_QUADS.snapshot()
    n = 14  # the corpus's quads
    assert mid.get("native", 0) - before.get("native", 0) == n
    assert after.get("python", 0) - mid.get("python", 0) == n
    assert after.get("native", 0) == mid.get("native", 0)


def test_scanner_builds_into_the_build_dir(monkeypatch):
    monkeypatch.delenv("DGRAPH_TPU_NO_NATIVE", raising=False)
    lib = native.scanner()
    path = _build.host_lib(native.SOURCE)
    assert path.parent == _build.BUILD_DIR and path.exists()
    assert path.name.startswith("nquad_scan-")
    assert lib._name == str(path)


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """No quiet fallback to the Python parser: a scanner that does not
    compile raises, naming the source and carrying g++'s message."""
    bad = tmp_path / "nquad_scan.cpp"
    bad.write_text("this is not C++ at all;\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.delenv("DGRAPH_TPU_NO_NATIVE", raising=False)
    with pytest.raises(RuntimeError, match="nquad_scan.cpp") as ei:
        native.scan("<0x1> <p> <0x2> .")
    assert "error" in str(ei.value)
    with pytest.raises(RuntimeError):
        apply_mutation(PostingStore(), Mutation(set_nquads="<0x1> <p> <0x2> ."))
    assert not list((tmp_path / "_build").glob("*.so"))
