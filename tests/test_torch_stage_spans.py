"""The port's stage spans inside the batched 2-hop
(``dgraph_tpu_torch.bench2hop.two_hop_batch`` and
``ops.expand_inline_grouped_kernel``), on the CPU.

- Under ``torch.profiler`` every span is a ``record_function`` range of
  its own name: the range tree of one batch, names and nesting exact.
- With the profiler off and no sampled request, the batches construct no
  Span (``dgraph_trace_spans_total`` unchanged) and enter no range;
  ``DGRAPH_TPU_TRACE=0`` keeps the profiler from turning them on.
- ``obs.span_totals()``: one ``two_hop.batch`` a batch, each stage once,
  each ``expand.*`` twice; device time None on CPU tensors; the tally's
  lazy resolution of timing pairs, with stand-in events.
- The answers are byte-identical with tracing off, under the profiler
  and under a sampled request; a sampled request nests the stages in its
  trace with the batch's and the overflow gather's attributes.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dgraph_tpu_torch import bench2hop, obs, ops
from dgraph_tpu_torch.models.arena import csr_dense_from_edges
from dgraph_tpu_torch.obs import spans
from dgraph_tpu_torch.utils.metrics import SPANS_RECORDED
from torch_pins import pinned_planner  # noqa: F401

# every route decision of both planners is pinned (tests/torch_pins.py)
pytestmark = pytest.mark.usefixtures("pinned_planner")

Q = 8

# (span, its nearest enclosing span) of one batch, in start order
TREE = [
    ("two_hop.batch", None),
    ("two_hop.hop1", "two_hop.batch"),
    ("expand.inline", "two_hop.hop1"),
    ("expand.slotmap", "two_hop.hop1"),
    ("expand.overflow", "two_hop.hop1"),
    ("two_hop.dedup", "two_hop.batch"),
    ("two_hop.hop2", "two_hop.batch"),
    ("expand.inline", "two_hop.hop2"),
    ("expand.slotmap", "two_hop.hop2"),
    ("expand.overflow", "two_hop.hop2"),
    ("two_hop.checksum", "two_hop.batch"),
]
NAMES = {n for n, _p in TREE}


@pytest.fixture(autouse=True)
def _recorder_reset():
    """A fresh process recorder (empty totals) for each test, and the
    env-default one after."""
    obs.configure()
    yield
    obs.configure()


@pytest.fixture(scope="module")
def graph():
    """A tiny skewed graph in the grouped layout, its plan and frontiers:
    (metap, ov_chunks, plan, fmat)."""
    rng = np.random.default_rng(5)
    n = 3000
    src = rng.integers(1, n + 1, 40_000)
    dst = np.where(rng.random(40_000) < 0.3, rng.integers(1, 40, 40_000),
                   rng.integers(1, n + 1, 40_000))
    a = csr_dense_from_edges(src, dst, n, torch.device("cpu"))
    fronts = [np.unique(rng.integers(1, n + 1, 48)) for _ in range(4 * Q)]
    fcap = ops.bucket(max(len(f) for f in fronts))
    metap, ov, plan, fmat = bench2hop.prepare(a, fronts, fcap)
    assert plan.grouped and plan.capo1 > 0 and plan.capo2 > 0
    return metap, ov, plan, fmat


def _batch(graph, b=0):
    metap, ov, plan, fmat = graph
    return bench2hop.two_hop_batch(metap, ov, fmat[b * Q:(b + 1) * Q], plan)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def _tree(prof):
    """(name, nearest enclosing span) of every span range, in start order."""
    out = []
    evs = sorted((e for e in prof.events() if e.name in NAMES),
                 key=lambda e: e.time_range.start)
    for e in evs:
        p = e.cpu_parent
        while p is not None and p.name not in NAMES:
            p = p.cpu_parent
        out.append((e.name, None if p is None else p.name))
    return out


def _same(a, b):
    chk_a, cnt_a, (i_a, o_a) = a
    chk_b, cnt_b, (i_b, o_b) = b
    for x, y in ((chk_a, chk_b), (cnt_a, cnt_b), (i_a, i_b), (o_a, o_b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.numpy().tobytes() == y.numpy().tobytes()


@pytest.mark.parametrize("batches", [1, 3])
def test_profiler_sees_the_stage_range_tree(graph, batches):
    _out, prof = _profiled(lambda: [_batch(graph, b) for b in range(batches)])
    assert _tree(prof) == TREE * batches


def test_profiler_off_builds_no_span_and_enters_no_range(graph, monkeypatch):
    entered = []
    real = spans.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(spans, "record_function", counting)
    before = SPANS_RECORDED.value()
    for b in range(50):
        _batch(graph, b % 4)
    assert SPANS_RECORDED.value() == before
    assert entered == []
    assert obs.span_totals() == {}
    # the same site records once the profiler collects
    _profiled(lambda: _batch(graph))
    assert SPANS_RECORDED.value() == before + len(TREE)
    assert sorted(entered) == sorted(n for n, _p in TREE)


def test_kill_switch_holds_under_the_profiler(graph, monkeypatch):
    monkeypatch.setenv("DGRAPH_TPU_TRACE", "0")
    obs.configure()
    before = SPANS_RECORDED.value()
    _out, prof = _profiled(lambda: _batch(graph))
    assert SPANS_RECORDED.value() == before
    assert _tree(prof) == []
    assert obs.span_totals() == {}


@pytest.mark.parametrize("batches", [1, 4])
def test_span_totals_count_one_batch_a_batch(graph, batches):
    _profiled(lambda: [_batch(graph, b) for b in range(batches)])
    tot = obs.span_totals()
    assert set(tot) == NAMES
    for name, t in tot.items():
        want = 2 * batches if name.startswith("expand.") else batches
        assert t["count"] == want, name
        assert t["host_s"] > 0
        assert t["device_ms"] is None  # CPU tensors: no events
    assert tot["two_hop.batch"]["host_s"] >= tot["two_hop.hop1"]["host_s"]
    # a reset hands the totals over and starts again
    assert obs.span_totals(reset=True) == tot
    assert obs.span_totals() == {}


def test_totals_cover_only_the_profiled_slice(graph):
    _batch(graph, 0)
    _profiled(lambda: _batch(graph, 1))
    _batch(graph, 2)
    assert obs.span_totals()["two_hop.batch"]["count"] == 1


@pytest.mark.parametrize("mode", ["profiler", "sampled"])
def test_answers_are_byte_identical_with_tracing_on_and_off(graph, mode):
    for b in range(4):
        off = _batch(graph, b)
        if mode == "profiler":
            on, _prof = _profiled(lambda: _batch(graph, b))
        else:
            obs.configure(ratio=1.0, seed=3)
            root = obs.start_request("query")
            with root:
                on = _batch(graph, b)
            obs.configure()
        _same(off, on)


def test_sampled_request_nests_the_stages_in_its_trace(graph):
    rec = obs.configure(ratio=1.0, seed=3)
    metap, ov, plan, fmat = graph
    root = rec.start_request("query")
    with root:
        _batch(graph)
    t = rec.trace(root.trace_id)
    by_id = {s["span_id"]: s for s in t["spans"]}
    got = [(s["name"], by_id[s["parent_id"]]["name"]
            if s["parent_id"] in by_id else None) for s in t["spans"]]
    assert got == [("query", None)] + [(n, p or "query") for n, p in TREE]
    batch = next(s for s in t["spans"] if s["name"] == "two_hop.batch")
    assert batch["attrs"] == {"Q": Q, "ucap": plan.ucap, "capo1": plan.capo1,
                              "capo2": plan.capo2}
    lanes = [s["attrs"]["lanes"] for s in t["spans"]
             if s["name"] == "expand.overflow"]
    assert lanes == [Q * plan.capo1 * 8, Q * plan.capo2 * 8]
    assert obs.span_totals()["two_hop.batch"]["count"] == 1


def test_profiler_only_span_is_never_current_and_lands_in_no_ring():
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.child("outer", device=torch.device("cpu")) as sp:
            assert sp.recording and obs.current_span() is None
            inner = obs.child("inner")
            assert inner is not obs.NOOP
            inner.finish()
            assert sp.child("leaf") is not obs.NOOP
    assert obs.get_recorder().traces() == []
    tot = obs.span_totals()
    assert tot["outer"]["count"] == tot["inner"]["count"] == 1
    assert tot["outer"]["device_ms"] is None
    # nothing records once the profiler stops
    assert obs.child("after") is obs.NOOP


class _Event:
    """A stand-in CUDA timing event: ready after ``ready`` queries."""

    def __init__(self, t_ms, ready=0):
        self.t_ms, self.ready, self.waited = t_ms, ready, False

    def query(self):
        self.ready -= 1
        return self.ready < 0

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, end):
        return end.t_ms - self.t_ms


def test_tally_resolves_its_pairs_when_read():
    rec = obs.configure()
    done = (_Event(0.0), _Event(1.5))
    late = (_Event(2.0), _Event(2.25, ready=10))
    rec.tally("s", 1000, done)
    rec.tally("s", 3000, late)
    rec.tally("s", 500, None)
    assert done[1].ready == 0  # the finishing thread made no runtime call
    tot = rec.span_totals()["s"]
    assert tot == {"count": 3, "host_s": 4500 / 1e9, "device_ms": 1.75}
    assert done[1].waited and late[1].waited  # the reader waits
    rec.tally("cpu", 10, None)
    assert rec.span_totals()["cpu"]["device_ms"] is None


def test_tally_past_its_bound_resolves_completed_pairs_without_waiting(
        monkeypatch):
    monkeypatch.setattr(spans, "_PENDING_MAX", 2)
    rec = obs.configure()
    pairs = [(_Event(0.0), _Event(1.0)), (_Event(0.0), _Event(2.0)),
             (_Event(0.0), _Event(4.0, ready=10))]
    for ev in pairs:
        rec.tally("s", 1, ev)
    # the two completed pairs resolved by query alone, the third kept
    assert [end.waited for _s, end in pairs] == [False, False, False]
    assert len(rec._totals["s"].pending) == 1
    assert rec._totals["s"].device_ms == 3.0
    assert rec.span_totals()["s"]["device_ms"] == 7.0
