"""The port's device order-by (``dgraph_tpu_torch/ops/order.py``, the
``ValueArena`` of ``models/arena.py`` and the engine's
``_device_order_perm``) against the reference's.

- ``gather_ranks`` and ``segmented_sort_perm`` against
  ``dgraph_tpu.ops.order``'s on seeded numpy inputs: ties, missing
  values, SENT padding, ``desc``, an empty input and a single segment.
- ``ValueArena`` (host mirrors, ``langless``, the device columns) against
  the reference's on the goldens' fixture, and again after a mutation of
  each predicate.
- The cases of tests/test_order.py on the port's engine: the rank sort
  matches the host ``sorted`` below and above the device gate, the
  device route is taken when ``expand_device_min`` is 1, ties keep their
  input order, and lang-tagged values order on the host.

Tolerance: none (integer outputs, equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dgraph_tpu.models import PostingStore as JaxStore
from dgraph_tpu.ops import order as jorder
from dgraph_tpu.query import QueryEngine as JaxEngine
from dgraph_tpu_torch.models import PostingStore
from dgraph_tpu_torch.ops import SENT
from dgraph_tpu_torch.ops import order as torder
from dgraph_tpu_torch.query import QueryEngine

from tests import test_goldens
from tests.test_order import ORDER_QUERIES
from tests.torch_parity import port_store_of


def _case(name, desc_seed=0):
    """(src, ranks, uids, seg): a value arena's sorted SENT-padded src and
    its ranks, and a flattened uid matrix with its segment ids."""
    rng = np.random.default_rng(sum(map(ord, name)) + desc_seed)
    have = np.unique(rng.integers(1, 400, size=120))
    sb = 1 << int(np.ceil(np.log2(len(have) + 1)))
    src = np.full(sb, SENT, np.int32)
    src[: len(have)] = have
    ranks = np.full(sb, -1, np.int32)
    n_vals = 3 if name == "ties" else 60
    ranks[: len(have)] = rng.integers(0, n_vals, size=len(have))
    n, n_seg = {"empty": (0, 1), "single_segment": (97, 1)}.get(name, (300, 7))
    uids = rng.integers(1, 400, size=n).astype(np.int32)
    if name == "missing":  # about half of the uids have no value
        uids[rng.random(n) < 0.5] += 1000
    seg = np.sort(rng.integers(0, n_seg, size=n)).astype(np.int32)
    if name == "padding":  # bucket padding: SENT uids, segment -1
        cap = 512
        uids = np.concatenate([uids, np.full(cap - n, SENT, np.int32)])
        seg = np.concatenate([seg, np.full(cap - n, -1, np.int32)])
    return src, ranks, uids, seg


ORDER_CASES = ["ties", "missing", "padding", "empty", "single_segment", "random"]


@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
@pytest.mark.parametrize("name", ORDER_CASES)
def test_order_ops_match_reference(name, desc):
    src, ranks, uids, seg = _case(name)
    want_r = np.asarray(jorder.gather_ranks(
        jnp.asarray(src), jnp.asarray(ranks), jnp.asarray(uids)))
    got_r = torder.gather_ranks(
        torch.from_numpy(src), torch.from_numpy(ranks), torch.from_numpy(uids))
    assert got_r.dtype == torch.int32
    assert np.array_equal(got_r.numpy(), want_r)
    if name == "missing":
        assert (want_r == -1).sum() > 50  # the case holds missing values
    want_p = np.asarray(jorder.segmented_sort_perm(
        jnp.asarray(seg), jnp.asarray(want_r), desc))
    got_p = torder.segmented_sort_perm(
        torch.from_numpy(seg), got_r, desc).numpy()
    assert np.array_equal(got_p, want_p)
    if name == "ties":  # equal ranks inside a segment keep input order
        key = np.stack([seg[got_p], got_r.numpy()[got_p]])
        tie = (key[:, 1:] == key[:, :-1]).all(0)
        assert tie.sum() > 100 and (got_p[1:][tie] > got_p[:-1][tie]).all()


# every value type of the goldens' schema: int, float, datetime, bool, and
# a string with lang-tagged values (no numeric view: an empty arena)
VALUE_PREDS = ["age", "weight", "dob", "wild", "name"]
MUTATION = ('mutation { set { <0x1> <age> "7" . <0x30> <age> "41" . '
            '<0x2> <weight> "0.5" . <0x31> <dob> "1999-12-31" . '
            '<0x32> <wild> "true" . <0x33> <name> "Zed"@fr . } '
            'delete { <0x3> <age> * . } }')


def _value_arenas_equal(jeng, teng, pred):
    ja, ta = jeng.arenas.values(pred), teng.arenas.values(pred)
    assert ta.n == ja.n and ta.langless == ja.langless
    assert np.array_equal(ta.h_src, ja.h_src)
    assert np.array_equal(ta.h_vals, ja.h_vals)
    assert np.array_equal(ta.h_ranks, ja.h_ranks)
    for col in ("src", "ranks"):
        got = getattr(ta, col)
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        assert np.array_equal(got.numpy(), np.asarray(getattr(ja, col)))
    assert np.array_equal(ta.vals.numpy(), np.asarray(ja.vals), equal_nan=True)
    return ta


def test_value_arena_matches_reference():
    jeng = JaxEngine(JaxStore())
    jeng.run("mutation { schema { %s } set { %s } }"
             % (test_goldens.SCHEMA, test_goldens.RDF))
    teng = QueryEngine(port_store_of(jeng.store), device="cpu")
    before = {p: _value_arenas_equal(jeng, teng, p) for p in VALUE_PREDS}
    assert before["age"].n > 0 and not before["name"].langless
    jeng.run(MUTATION)
    teng.run(MUTATION)
    for p in VALUE_PREDS:
        after = _value_arenas_equal(jeng, teng, p)
        assert after is not before[p], f"{p}: the mutation did not rebuild"
    assert 0x30 in teng.arenas.values("age").h_src.tolist()
    assert 0x3 not in teng.arenas.values("age").h_src.tolist()


def _build(seed=11, n=120):
    """tests/test_order.py's graph on the port's engine."""
    rng = np.random.default_rng(seed)
    eng = QueryEngine(PostingStore(), device="cpu")
    lines = []
    for i in range(1, n + 1):
        lines.append(f'<0x{i:x}> <name> "node{i:03d}" .')
        if rng.random() < 0.8:
            lines.append(f'<0x{i:x}> <age> "{int(rng.integers(0, 40))}" .')
        if rng.random() < 0.7:
            lines.append(f'<0x{i:x}> <score> "{rng.random() * 10:.6f}"^^<xs:float> .')
        for d in rng.integers(1, n + 1, size=int(rng.integers(2, 9))):
            lines.append(f"<0x{i:x}> <follows> <0x{d:x}> .")
    eng.run(
        "mutation { schema { name: string . age: int @index(int) . "
        "score: float . follows: uid . } set { %s } }" % "\n".join(lines)
    )
    return eng


@pytest.mark.parametrize("gate", [1, None], ids=["device", "host_ranks"])
@pytest.mark.parametrize("q", ORDER_QUERIES)
def test_device_order_matches_host(q, gate, monkeypatch):
    """The rank sort (on the device above the gate, in numpy over the
    rank mirror below it) answers like the host ``sorted``."""
    eng = _build()
    if gate is not None:
        eng.expand_device_min = gate
    rank = eng.run(q)
    n_dev = eng.stats["device_order"]
    assert n_dev == (1 if gate == 1 else 0)
    monkeypatch.setattr(QueryEngine, "_device_order_perm", lambda *a, **k: None)
    assert eng.run(q) == rank, f"the rank sort diverged for {q}"


def test_device_order_engaged():
    """With the gate at 1 an int-keyed child order runs on the engine's
    device, counted in its stats and timed."""
    eng = _build()
    eng.expand_device_min = 1
    eng.run("{ q(func: uid(0x1)) { follows (orderasc: age) { name } } }")
    assert eng.stats["device_order"] == 1
    assert eng.stats["device_order_ms"] > 0


def test_device_order_ties_are_stable():
    """Equal keys keep their input (ascending-uid) order, on the device
    route and on the host one."""
    eng = QueryEngine(PostingStore(), device="cpu")
    lines = [f"<0x1> <follows> <0x{i:x}> ." for i in range(2, 12)]
    lines += [f'<0x{i:x}> <grp> "7" .' for i in range(2, 12)]
    eng.run(
        "mutation { schema { grp: int . follows: uid . } set { %s } }"
        % "\n".join(lines)
    )
    for gate in (1, 1 << 30):
        eng.expand_device_min = gate
        for d in ("orderasc", "orderdesc"):
            out = eng.run("{ q(func: uid(0x1)) { follows (%s: grp) { _uid_ } } }" % d)
            uids = [int(o["_uid_"], 16) for o in out["q"][0]["follows"]]
            assert uids == list(range(2, 12)), (gate, d)
        assert eng.stats["device_order"] == (1 if gate == 1 else 0)


def test_lang_tagged_values_fall_back_to_host(monkeypatch):
    """A predicate with lang-tagged values must not order through the
    ValueArena (untagged-else-first-lang): the host path orders it."""
    eng = QueryEngine(PostingStore(), device="cpu")
    eng.expand_device_min = 1
    eng.run(
        "mutation { schema { n: int . follows: uid . } set { "
        '<0x2> <n> "1"@en . <0x3> <n> "2" . <0x1> <follows> <0x2> . '
        "<0x1> <follows> <0x3> . } }"
    )
    called = []
    orig = QueryEngine._device_order_perm

    def spy(self, *a, **k):
        r = orig(self, *a, **k)
        called.append(r is not None)
        return r

    monkeypatch.setattr(QueryEngine, "_device_order_perm", spy)
    eng.run("{ q(func: uid(0x1)) { follows (orderasc: n) { _uid_ } } }")
    assert called and not any(called), "lang-tagged values must force host path"
    assert eng.stats["device_order"] == 0
