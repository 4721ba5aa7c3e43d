"""The port's analysis (``dgraph_tpu_torch/analysis/``) against the
reference's (``dgraph_tpu/analysis/``) on the CPU.

- The rules kept unchanged give the same rule ids and lines as the
  reference's on the reference's golden-bad, counterexample and pragma
  snippets (tests/test_analysis.py, tests/test_ivm.py), the port reading
  each snippet under its own path (``dgraph_tpu_torch/...``).
- The rules rewritten for torch (``naked-device-sync``,
  ``naked-resident-transfer``, ``naked-collective``'s homes, the port's
  metric catalog) have their own golden-bad, clean and pragma cases.
- The lock-order and thread-escape passes give the same graphs and
  findings as the reference's on seeded trees and snippets; the
  witnesses give the same reports on seeded inversions and races, and a
  subprocess that arms only the port's witness over a CPU server serving
  8 concurrent scheduled requests reports neither.
- Both passes over ``dgraph_tpu_torch/`` find nothing; the baseline and
  ``shared.json`` ship empty; the CLI's golden-bad, baseline and
  manifest workflows match the reference's.
- The kernel contract registry's CPU half holds, and its site coverage
  fails on a seeded extra ``CudaKernel`` or ``extern "C"`` entry.

Tolerance 0 throughout (equal ids, lines, graphs and values)."""

import json
import re
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest

from dgraph_tpu.analysis import escape as jescape
from dgraph_tpu.analysis import framework as jframework
from dgraph_tpu.analysis import lockorder as jlockorder
from dgraph_tpu.analysis import rules as jrules
from dgraph_tpu.analysis import witness as jwitness
from dgraph_tpu_torch.analysis import escape, framework, lockorder, programs
from dgraph_tpu_torch.analysis import rules, witness
from dgraph_tpu_torch.analysis.__main__ import main
from torch_pins import pinned_planner  # noqa: F401

# every route decision of both planners is pinned (tests/torch_pins.py)
pytestmark = pytest.mark.usefixtures("pinned_planner")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "dgraph_tpu_torch"


def _d(src: str) -> str:
    return textwrap.dedent(src)


def _rule(mod, rule_id):
    (r,) = [r for r in mod.ALL_RULES if r.id == rule_id]
    return r


def _hits(findings):
    return [(f.rule, f.line) for f in findings]


def _port_path(path: str) -> str:
    return path.replace("dgraph_tpu/", "dgraph_tpu_torch/", 1)


# ------------------------------------------------- rules kept unchanged

# (case id, rule id, path, source): the reference's snippets
UNCHANGED = [
    ("wallclock_deadline", "wallclock-duration", "<snippet>", _d("""
        import time

        def wait(timeout):
            deadline = time.time() + timeout
            while time.time() < deadline:
                pass
    """)),
    ("wallclock_names", "wallclock-duration", "<snippet>", _d("""
        import time

        def rate(n):
            t0 = time.time()
            work()
            return n / (time.time() - t0)
    """)),
    ("wallclock_timestamp", "wallclock-duration", "<snippet>", _d("""
        import time

        def stamp(record):
            record["created_at"] = time.time()
            return record
    """)),
    ("wallclock_monotonic", "wallclock-duration", "<snippet>", _d("""
        import time

        def wait(timeout):
            deadline = time.monotonic() + timeout
            while time.monotonic() < deadline:
                pass
    """)),
    ("wallclock_pragma", "wallclock-duration", "<snippet>", _d("""
        import time

        def wait(timeout):
            # graftlint: ignore[wallclock-duration]
            deadline = time.time() + timeout
            return deadline
    """)),
    ("wallclock_closure_scope", "wallclock-duration", "<snippet>", _d("""
        import time

        def outer(ts):
            def inner():
                ts = time.time()
                return ts
            return ts + 1
    """)),
    ("swallowed_broad", "swallowed-exception", "<snippet>", _d("""
        def f():
            try:
                g()
            except Exception:
                pass
    """)),
    ("swallowed_narrow_or_counted", "swallowed-exception", "<snippet>", _d("""
        def f():
            try:
                g()
            except OSError:
                pass
            try:
                g()
            except Exception as e:
                note_swallowed("site", e)
    """)),
    ("swallowed_bare_tuple", "swallowed-exception", "<snippet>", _d("""
        def f():
            try:
                g()
            except:
                continue_ = 1
            try:
                g()
            except (ValueError, BaseException):
                pass
    """)),
    ("peer_rpc_urlopen", "naked-peer-rpc", "dgraph_tpu/serve/foo.py", _d("""
        from dgraph_tpu.cluster.transport import urlopen_peer

        def fetch(req, auth):
            with urlopen_peer(req, 5, auth) as resp:
                return resp.read()
    """)),
    ("peer_rpc_channel", "naked-peer-rpc", "dgraph_tpu/cluster/newtransport.py", _d("""
        def send(channel, payload):
            rpc = channel.unary_unary("/protos.Worker/RaftMessage")
            return rpc(payload, timeout=2.0)
    """)),
    ("peer_rpc_funnel", "naked-peer-rpc", "dgraph_tpu/cluster/peerclient.py", _d("""
        def call(self, req, channel, payload, auth):
            with urlopen_peer(req, 5, auth) as resp:
                resp.read()
            return channel.unary_unary("/m")(payload)
    """)),
    ("peer_rpc_routed", "naked-peer-rpc", "dgraph_tpu/cluster/service.py", _d("""
        def forward(self, peer, req):
            with self.peerclient.urlopen(peer, req, op="forward", budget=5) as r:
                return r.read()
    """)),
    ("peer_rpc_client_side", "naked-peer-rpc", "dgraph_tpu/serve/grpc_server.py", _d("""
        def probe(channel):
            return channel.unary_unary("/protos.Dgraph/CheckVersion")(b"")
    """)),
    ("atomic_os_replace", "naked-atomic-write", "dgraph_tpu/models/x.py", _d("""
        import os

        def persist(path, blob):
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
    """)),
    ("atomic_imported_rename", "naked-atomic-write", "dgraph_tpu/cli/x.py", _d("""
        from os import replace as _rp

        def persist(tmp, path):
            _rp(tmp, path)
    """)),
    ("atomic_helper_home", "naked-atomic-write", "dgraph_tpu/utils/atomicio.py", _d("""
        import os

        def atomic_write_file(path, data):
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
    """)),
    ("atomic_routed", "naked-atomic-write", "dgraph_tpu/cluster/raft.py", _d("""
        from dgraph_tpu.utils.atomicio import atomic_write_file

        def persist(path, blob):
            atomic_write_file(path, blob, site="raft.hardstate")
    """)),
    ("atomic_str_replace", "naked-atomic-write", "dgraph_tpu/gql/x.py", _d("""
        def norm(s):
            return s.replace("a", "b")
    """)),
    ("atomic_pragma", "naked-atomic-write", "dgraph_tpu/models/wal.py", _d("""
        import os

        def seal(path, seg):
            os.replace(path, seg)  # graftlint: ignore[naked-atomic-write]
    """)),
    ("stage_bracketing", "naked-stage-timing", "dgraph_tpu/query/newexec.py", _d("""
        import time as _time

        def expand(self, rows):
            t0 = _time.perf_counter()
            out = do_expand(rows)
            self.stats["ms"] += (_time.perf_counter() - t0) * 1e3
            return out
    """)),
    ("stage_inline_ns", "naked-stage-timing", "dgraph_tpu/serve/handler.py", _d("""
        import time

        def handle(self):
            start = time.perf_counter_ns()
            serve()
            return time.perf_counter_ns() - start
    """)),
    ("stage_span_api_home", "naked-stage-timing", "dgraph_tpu/obs/spans.py", _d("""
        import time

        class _Stage:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, et, ev, tb):
                self.stats[self.key] += (time.perf_counter() - self.t0) * 1e3
    """)),
    ("stage_trace_home", "naked-stage-timing", "dgraph_tpu/utils/trace.py", _d("""
        import time

        def mark(self):
            t0 = time.perf_counter()
            return time.perf_counter() - t0
    """)),
    ("stage_routed", "naked-stage-timing", "dgraph_tpu/query/engine.py", _d("""
        from dgraph_tpu import obs

        def expand(self, rows):
            with obs.stage(self.stats, "device_expand_ms"):
                return do_expand(rows)
    """)),
    ("stage_outside_dirs", "naked-stage-timing", "dgraph_tpu/models/arena.py", _d("""
        import time

        def measure():
            t0 = time.perf_counter()
            work()
            return time.perf_counter() - t0
    """)),
    ("stage_monotonic_deadline", "naked-stage-timing", "dgraph_tpu/sched/scheduler.py", _d("""
        import time

        def wait(timeout):
            deadline = time.monotonic() + timeout
            return deadline - time.monotonic()
    """)),
    ("stage_pragma", "naked-stage-timing", "dgraph_tpu/query/profiler.py", _d("""
        import time

        def profile(self):
            t0 = time.perf_counter()
            run()
            # offline profiling harness, never in the serving path
            # graftlint: ignore[naked-stage-timing]
            return time.perf_counter() - t0
    """)),
    ("threshold_env_read", "naked-route-threshold", "dgraph_tpu/query/newroute.py", _d("""
        import os

        def gate():
            return int(os.environ.get("DGRAPH_TPU_NEW_ROUTE_MIN", 262144))
    """)),
    ("threshold_getenv_ops", "naked-route-threshold", "dgraph_tpu/ops/newkernel.py", _d("""
        import os

        def gate():
            return os.getenv("DGRAPH_TPU_KERNEL_PICK", "auto")
    """)),
    ("threshold_literal_compare", "naked-route-threshold", "dgraph_tpu/query/route.py", _d("""
        def pick(est_total, capc):
            if est_total < 262144:
                return "host"
            if capc > 1 << 21:
                return "abort"
            return "device"
    """)),
    ("threshold_named", "naked-route-threshold", "dgraph_tpu/query/route.py", _d("""
        from dgraph_tpu.utils import planconfig

        def pick(est_total):
            if est_total < planconfig.chain_threshold():
                return "host"
            return "device"
    """)),
    ("threshold_small_literal", "naked-route-threshold", "dgraph_tpu/ops/kern.py", _d("""
        def bucketed(n):
            if n < 4096:
                return 4096
            return n
    """)),
    ("threshold_outside_dirs", "naked-route-threshold", "dgraph_tpu/models/arena.py", _d("""
        import os

        def budget():
            return int(os.environ.get("DGRAPH_TPU_ARENA_BUDGET", 262144))
    """)),
    ("threshold_pragma", "naked-route-threshold", "dgraph_tpu/ops/kern.py", _d("""
        def sanity(cap):
            # jit-cache hard stop, not a route gate
            # graftlint: ignore[naked-route-threshold]
            assert cap < 16777216
    """)),
    ("version_key_bad", "naked-version-key", "dgraph_tpu/cache/newtier.py", (
        "def probe(self, key):\n"
        "    v = self.engine.store.version\n"
        "    w = getattr(self._server.store, \"version\", None)\n"
        "    return self.cache.get(key, v or w)\n"
    )),
    ("version_key_ivm_home", "naked-version-key", "dgraph_tpu/ivm/versions.py", (
        "def probe(self, key):\n"
        "    v = self.engine.store.version\n"
        "    return v\n"
    )),
    ("version_key_outside_dirs", "naked-version-key", "dgraph_tpu/models/store.py", (
        "def probe(self, key):\n"
        "    return self.engine.store.version\n"
    )),
    ("version_key_non_store", "naked-version-key", "dgraph_tpu/cache/core.py", (
        "def f(self):\n"
        "    return self.calibration.version + entry.version\n"
    )),
    ("version_key_pragma", "naked-version-key", "dgraph_tpu/sched/x.py", (
        "def sig(self):\n"
        "    # graftlint: ignore[naked-version-key]\n"
        "    return getattr(self._server.store, \"version\", None)\n"
    )),
    ("hop_loop_exec_child", "unchecked-hop-loop", "dgraph_tpu/query/newpath.py", _d("""
        def run_levels(engine, levels, src, resolver):
            for child in levels:
                engine._exec_child(child, src, resolver, {}, {})
    """)),
    ("hop_loop_bare_expand", "unchecked-hop-loop", "dgraph_tpu/query/walk.py", _d("""
        def search(expand, heap):
            while heap:
                u = heap.pop()
                expand(u)
    """)),
    ("hop_loop_checked", "unchecked-hop-loop", "dgraph_tpu/query/newpath.py", _d("""
        def run_levels(engine, levels, src, resolver):
            for child in levels:
                engine.checkpoint()
                engine._exec_child(child, src, resolver, {}, {})

        def probe_tokens(self, idx, toks):
            for t in toks:
                self.cancel_token.check()
                self._expand_rows(idx.csr, [t])
    """)),
    ("hop_loop_plain", "unchecked-hop-loop", "dgraph_tpu/query/enc.py", _d("""
        def tally(children):
            total = 0
            for c in children:
                total += len(c.values)
            return total
    """)),
    ("hop_loop_ops_exempt", "unchecked-hop-loop", "dgraph_tpu/ops/kern.py", _d("""
        def kernel(ce, fronts):
            for f in fronts:
                ce.expand(f)
    """)),
    ("hop_loop_pragma", "unchecked-hop-loop", "dgraph_tpu/query/fixture.py", _d("""
        def replay(engine, levels, src, resolver):
            # replay of an already-admitted fixture: no live client
            # graftlint: ignore[unchecked-hop-loop]
            for child in levels:
                engine._exec_child(child, src, resolver, {}, {})
    """)),
    ("hop_loop_nested_checkpoint", "unchecked-hop-loop", "dgraph_tpu/query/walk2.py", _d("""
        def walk(engine, parents, templates, src, resolver):
            while parents:
                for tmpl in templates:
                    engine.checkpoint()
                    engine._exec_child(tmpl, src, resolver, {}, {})
                parents = parents[1:]
    """)),
] + [
    (f"segment_loop_{p.split('/')[1]}", "unchecked-hop-loop", p, _d("""
        def run_segments(carry, n, k):
            lo = 0
            while lo < n:
                carry = _dispatch_segment(carry, lo, min(lo + k, n))
                lo += k
            return carry
    """)) for p in ("dgraph_tpu/ops/batch.py", "dgraph_tpu/query/chain.py",
                    "dgraph_tpu/mesh/executor.py")
] + [
    ("segment_loop_method", "unchecked-hop-loop", "dgraph_tpu/ops/x.py", _d("""
        def run(self, parts):
            for lo, hi in parts:
                self._dispatch_segment(lo, hi)
    """)),
    ("segment_loop_seamed", "unchecked-hop-loop", "dgraph_tpu/ops/batch.py", _d("""
        from dgraph_tpu.sched import segments

        def run_segments(carry, n, k):
            lo = 0
            while lo < n:
                if lo:
                    segments.seam("chain")
                carry = _dispatch_segment(carry, lo, min(lo + k, n))
                lo += k
            return carry
    """)),
    ("segment_loop_token", "unchecked-hop-loop", "dgraph_tpu/mesh/executor.py", _d("""
        def run_segments(self, parts):
            for lo, hi in parts:
                self.cancel_token.check()
                self._dispatch_segment(lo, hi)
    """)),
    ("segment_loop_pragma", "unchecked-hop-loop", "dgraph_tpu/query/fixture.py", _d("""
        def replay_segments(carry, parts):
            # offline fixture replay: no live client, nothing queued
            # graftlint: ignore[unchecked-hop-loop]
            for lo, hi in parts:
                carry = _dispatch_segment(carry, lo, hi)
            return carry
    """)),
    ("metric_unregistered", "unregistered-metric", "<snippet>", _d("""
        from dgraph_tpu.utils.metrics import metrics

        ROGUE = metrics.counter("dgraph_totally_new_series_total")
        ROGUE_H = metrics.histogram("dgraph_rogue_seconds", (0.1, 1))
        ROGUE_KW = metrics.counter(name="dgraph_kwarg_series_total")
    """)),
    ("metric_cataloged", "unregistered-metric", "<snippet>", _d("""
        from dgraph_tpu.utils.metrics import metrics

        NQ = metrics.counter("dgraph_num_queries_total")
        OTHER = metrics.counter("python_gc_collections_total")
    """)),
    ("metric_pragma", "unregistered-metric", "<snippet>", _d("""
        from dgraph_tpu.utils.metrics import metrics

        # internal-only A/B probe, removed with the experiment
        # graftlint: ignore[unregistered-metric]
        EXP = metrics.counter("dgraph_experiment_total")
    """)),
]


@pytest.fixture
def pinned_catalogs(monkeypatch):
    """Both metric rules read one pinned catalog."""
    cat = {"dgraph_num_queries_total"}
    monkeypatch.setattr(jrules.UnregisteredMetric, "catalog_override", cat)
    monkeypatch.setattr(rules.UnregisteredMetric, "catalog_override", cat)


@pytest.mark.parametrize("case", UNCHANGED, ids=[c[0] for c in UNCHANGED])
def test_unchanged_rule_matches_reference(case, pinned_catalogs):
    _cid, rule_id, path, src = case
    want = jframework.check_source(src, [_rule(jrules, rule_id)], path=path)
    got = framework.check_source(src, [_rule(rules, rule_id)], path=_port_path(path))
    assert _hits(got) == _hits(want)
    assert all(f.rule == rule_id for f in got)


def test_unchanged_cases_cover_each_unchanged_rule_both_ways(pinned_catalogs):
    """Every unchanged rule has a case it flags and a case it passes."""
    kept = {"wallclock-duration", "swallowed-exception", "naked-peer-rpc",
            "naked-atomic-write", "naked-stage-timing", "naked-route-threshold",
            "naked-version-key", "unchecked-hop-loop", "unregistered-metric"}
    flagged, clean = set(), set()
    for _cid, rule_id, path, src in UNCHANGED:
        hit = framework.check_source(src, [_rule(rules, rule_id)], path=_port_path(path))
        (flagged if hit else clean).add(rule_id)
    assert flagged == kept and clean == kept
    assert {r.id for r in rules.ALL_RULES} == kept | {
        "naked-device-sync", "naked-resident-transfer", "naked-collective"}
    dropped = {"host-sync-in-jit", "recompile-hazard", "unregistered-program-factory"}
    assert {r.id for r in jrules.ALL_RULES} - {r.id for r in rules.ALL_RULES} == dropped


def test_fingerprint_matches_reference():
    src = "def f():\n    try:\n        g()\n    except Exception:\n        pass\n"
    (mine,) = framework.check_source(src, [rules.SwallowedException()])
    (ref,) = jframework.check_source(src, [jrules.SwallowedException()])
    (moved,) = framework.check_source("# moved\n\n" + src, [rules.SwallowedException()])
    assert mine.fingerprint == ref.fingerprint == moved.fingerprint
    assert moved.line != mine.line


# ------------------------------------------------------ rewritten rules

SYNC = "naked-device-sync"
RESIDENT = "naked-resident-transfer"

# (case id, rule id, path, source, flagged lines)
REWRITTEN = [
    ("sync_item_tolist_cpu", SYNC, "dgraph_tpu_torch/query/newexec.py", _d("""
        import torch

        def serve_hop(rows):
            dev = torch.as_tensor(rows).to("cuda")
            n = dev.sum().item()
            host = dev.cpu()
            return n, torch.unique(dev).tolist(), host
    """), [6, 7, 8]),
    ("sync_synchronize", SYNC, "dgraph_tpu_torch/ops/newkernel.py", _d("""
        import torch

        def wait(ev, stream):
            torch.cuda.synchronize()
            ev.synchronize()
            stream.synchronize()
    """), [5, 6, 7]),
    ("sync_each_serving_dir", SYNC, "dgraph_tpu_torch/{d}/x.py", _d("""
        def f(x):
            return x.cpu()
    """), [3]),
    ("sync_numpy_host_values", SYNC, "dgraph_tpu_torch/query/x.py", _d("""
        import numpy as np

        def host_count(counts):
            a = np.asarray(counts)
            return a.sum().item(), a.tolist(), counts.cpu().numpy().tolist()
    """), [6]),
    ("sync_guard_bracketed", SYNC, "dgraph_tpu_torch/query/engine.py", _d("""
        import torch
        from dgraph_tpu_torch.utils import devguard

        def hop(self, rows):
            def _dispatch():
                dev = self.expand_rows(rows)
                return dev.cpu().numpy()

            a = self._run_guarded("device.hop", _dispatch)
            b = devguard.get().run("device.x", lambda: torch.ones(2).cpu())
            c = devguard.get().run("device.y", lambda u=rows: _seg(u))
            return a, b, c

        def _seg(u):
            return torch.as_tensor(u).sum().item()
    """), []),
    ("sync_outside_dirs", SYNC, "dgraph_tpu_torch/utils/devguard.py", _d("""
        import torch

        def probe(dev):
            torch.arange(8, device=dev).sum().item()
            torch.cuda.synchronize()
    """), []),
    ("sync_obs_home", SYNC, "dgraph_tpu_torch/obs/spans.py", _d("""
        def block_ready_ms(x, ev):
            ev.synchronize()
            return x.cpu()
    """), []),
    ("sync_pragma", SYNC, "dgraph_tpu_torch/parallel/x.py", _d("""
        import torch

        def timed(fn):
            fn()
            # a timing harness: the sync is the measurement
            # graftlint: ignore[naked-device-sync]
            torch.cuda.synchronize()
    """), []),
    ("resident_transfers", RESIDENT, "dgraph_tpu_torch/query/engine.py", _d("""
        import numpy as np
        import torch

        def f(arena, dev):
            ra = arena.resident()
            a = ra.dst.cpu()
            b = arena.resident().off.to(dev)
            c = torch.as_tensor(ra.dst, device="cuda")
            d = np.asarray(ra.off)
            e = self._resident.cuda()
            return a, b, c, d, e
    """), [7, 8, 9, 10, 11]),
    ("resident_home", RESIDENT, "dgraph_tpu_torch/models/arena.py", _d("""
        def seed(self, dev):
            return self.resident().dst.to(dev)
    """), []),
    ("resident_other_buffers", RESIDENT, "dgraph_tpu_torch/query/engine.py", _d("""
        import torch

        def f(arena, rows, dev):
            out = arena.expand_packed(torch.as_tensor(rows, device=dev))
            return arena.offsets.to(dev), out.cpu()
    """), []),
    ("resident_pragma", RESIDENT, "dgraph_tpu_torch/utils/x.py", _d("""
        def dump(ra):
            # offline debug dump, never on the serving path
            # graftlint: ignore[naked-resident-transfer]
            return ra.dst.cpu()
    """), []),
    ("collective_outside_homes", "naked-collective", "dgraph_tpu_torch/query/engine.py", _d("""
        from dgraph_tpu_torch.parallel.mesh import all_gather, psum

        def combine(parts, root):
            return all_gather(parts, root), psum(parts, root)
    """), [5, 5]),
    ("collective_reference_home", "naked-collective", "dgraph_tpu/mesh/programs.py", _d("""
        def combine(parts, root):
            return psum(parts, root)
    """), [3]),
] + [
    (f"collective_home_{h.split('/')[1]}", "naked-collective", h, _d("""
        def combine(parts, root):
            return psum(parts, root), all_gather(parts, root)
    """), []) for h in ("dgraph_tpu_torch/mesh/programs.py",
                        "dgraph_tpu_torch/parallel/mesh.py")
]


def _expand_dirs(cases):
    out = []
    for cid, rid, path, src, lines in cases:
        if "{d}" in path:
            for d in ("query", "ops", "parallel", "mesh", "sched"):
                out.append((f"{cid}_{d}", rid, path.format(d=d), src, lines))
        else:
            out.append((cid, rid, path, src, lines))
    return out


REWRITTEN = _expand_dirs(REWRITTEN)


@pytest.mark.parametrize("case", REWRITTEN, ids=[c[0] for c in REWRITTEN])
def test_rewritten_rule_cases(case):
    _cid, rule_id, path, src, lines = case
    got = framework.check_source(src, [_rule(rules, rule_id)], path=path)
    assert sorted(f.line for f in got) == lines, [f.render() for f in got]
    assert all(f.rule == rule_id for f in got)


def test_port_metric_catalog_is_read_beside_deploy_md(monkeypatch):
    """The real catalogs: deploy.md's rows and the port's own
    (dgraph_tpu_torch/METRICS.md) both register; a series in neither is
    flagged."""
    monkeypatch.setattr(rules.UnregisteredMetric, "_catalog_cache", None)
    cat = rules.UnregisteredMetric.catalog()
    assert "dgraph_num_queries_total" in cat
    assert "dgraph_bulk_set_quads_total" in cat
    assert rules.parse_catalog(PKG / "METRICS.md") == {"dgraph_bulk_set_quads_total"}
    assert "dgraph_bulk_set_quads_total" not in rules.parse_catalog(ROOT / "docs" / "deploy.md")
    src = _d("""
        from dgraph_tpu_torch.utils.metrics import metrics

        A = metrics.labeled("dgraph_bulk_set_quads_total", label="route")
        B = metrics.counter("dgraph_not_in_any_catalog_total")
    """)
    got = framework.check_source(src, [rules.UnregisteredMetric()])
    assert _hits(got) == [("unregistered-metric", 5)]


# --------------------------------------------------- lock order, escape

LOCK_TREES = {
    "cycle": """
        import threading

        class S:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def one(self):
                with self._a:
                    with self._b:
                        pass

            def two(self):
                with self._b:
                    with self._a:
                        pass
    """,
    "call_propagation": """
        import threading

        class S:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def outer(self):
                with self._a:
                    self.inner()

            def inner(self):
                with self._b:
                    pass
    """,
    "deferred_closures": """
        import threading

        class S:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def outer(self):
                with self._a:
                    self._cb = lambda: self.later()

                def deferred():
                    self.later()
                with self._a:
                    self._worker = deferred

            def later(self):
                with self._b:
                    pass
    """,
    "self_nesting": """
        import threading

        class S:
            def __init__(self):
                self._a = threading.Lock()

            def bad(self):
                with self._a:
                    with self._a:
                        pass
    """,
    "rwlock_and_aliases": """
        import threading
        from dgraph_tpu_torch.utils.rwlock import RWLock

        class S:
            def __init__(self):
                self._engine_lock = RWLock()
                self._cache_lock = threading.RLock()
                self._build_locks = {}

            def read(self, k):
                with self._engine_lock.read():
                    bl = self._build_locks.setdefault(k, threading.Lock())
                    with bl:
                        with self._cache_lock:
                            with self._cache_lock:
                                pass

            def write(self):
                with self._engine_lock.write():
                    pass
    """,
}


def _graph_key(g):
    return (
        {n: (c.kind, c.site) for n, c in g.classes.items()},
        {k: (e.site, e.via) for k, e in g.edges.items()},
        [(e.src, e.site) for e in g.self_nesting],
    )


@pytest.mark.parametrize("tree", sorted(LOCK_TREES))
def test_lock_order_matches_reference(tree, tmp_path):
    (tmp_path / "mod.py").write_text(_d(LOCK_TREES[tree]))
    g, problems = lockorder.check_lock_order([str(tmp_path)], repo_root=str(tmp_path))
    jg, jproblems = jlockorder.check_lock_order([str(tmp_path)], repo_root=str(tmp_path))
    assert _graph_key(g) == _graph_key(jg)
    assert problems == jproblems
    if tree in ("cycle", "self_nesting"):
        assert problems
    if tree == "call_propagation":
        assert ("mod.S._a", "mod.S._b") in g.edges


ESCAPE_SNIPPETS = {
    "two_thread_unlocked": """
        import threading

        class Pump:
            def __init__(self):
                self.count = 0
                threading.Thread(target=self._run, daemon=True).start()

            def _run(self):
                while True:
                    self.count += 1

            def poke(self):
                self.count = 0
    """,
    "locked": """
        import threading

        class Pump:
            def __init__(self):
                self._lock = threading.Lock()
                self.count = 0
                threading.Thread(target=self._run, daemon=True).start()

            def _run(self):
                with self._lock:
                    self.count += 1

            def poke(self):
                with self._lock:
                    self.count = 0
    """,
    "caller_holds_lock": """
        import threading

        class Guard:
            def __init__(self):
                self._lock = threading.Lock()
                self.state = "ok"
                threading.Thread(target=self._probe, daemon=True).start()

            def _set_state(self, s):
                self.state = s

            def _probe(self):
                with self._lock:
                    self._set_state("degraded")

            def readmit(self):
                with self._lock:
                    self._set_state("ok")
    """,
    "pragma_without_why": """
        import threading

        class Flag:
            def __init__(self):
                self.done = False
                threading.Thread(target=self._run, daemon=True).start()

            def _run(self):
                # graftlint: shared[done]
                self.done = True

            def stop(self):
                self.done = False
    """,
    "executor_submit": """
        from concurrent.futures import ThreadPoolExecutor

        class Fan:
            def __init__(self):
                self.done = 0
                self._ex = ThreadPoolExecutor(4)

            def kick(self):
                for _ in range(4):
                    self._ex.submit(self._work)

            def _work(self):
                self.done += 1
    """,
    "conn_handler_global": """
        from http.server import BaseHTTPRequestHandler

        HITS = 0

        class H(BaseHTTPRequestHandler):
            def do_GET(self):
                global HITS
                HITS += 1
                self.body = b"ok"
    """,
    "scheduler_adapt_shape": """
        import threading

        class Sched:
            def __init__(self, n):
                self._cond = threading.Condition()
                self.max_batch = 8
                for _ in range(n):
                    threading.Thread(target=self._worker).start()

            def _worker(self):
                self._adapt()

            def _adapt(self):
                self.max_batch = 16
    """,
}


@pytest.mark.parametrize("name", sorted(ESCAPE_SNIPPETS))
def test_escape_matches_reference(name):
    src = _d(ESCAPE_SNIPPETS[name])
    got = escape.check_escape_source(src)
    want = jescape.check_escape_source(src)
    assert [(f.rule, f.line, f.message) for f in got] == [
        (f.rule, f.line, f.message) for f in want]
    if name in ("locked", "caller_holds_lock"):
        assert got == []
    else:
        assert got


def test_thread_entry_discovery_matches_reference():
    import ast

    src = _d("""
        import threading
        from concurrent.futures import ThreadPoolExecutor

        def loose():
            pass

        class S:
            def __init__(self):
                threading.Thread(target=self._run).start()
                threading.Timer(1.0, self._tick).start()
                with ThreadPoolExecutor(2) as ex:
                    ex.submit(self._job)

            def _run(self): pass
            def _tick(self): pass
            def _job(self): pass

        # graftlint: thread-entry
        def marked():
            pass
    """)
    from dataclasses import astuple

    got = lockorder.discover_thread_entries(ast.parse(src), "m", "m.py", src.splitlines())
    want = jlockorder.discover_thread_entries(ast.parse(src), "m", "m.py", src.splitlines())
    assert [astuple(e) for e in got] == [astuple(e) for e in want]
    assert {e.qual: e.kind for e in got} == {
        "m.S._run": "thread", "m.S._tick": "timer", "m.S._job": "executor",
        "m.marked": "pragma"}


# -------------------------------------------------------------- witness

def _scenario_inversion(mod):
    w = mod.Witness()
    a = mod._WLock(w, "lock.A", threading.Lock())
    b = mod._WLock(w, "lock.B", threading.Lock())
    with a:
        with b:
            pass

    def t2():
        with b:
            with a:
                pass

    _in_thread(t2)
    return w


def _scenario_instance_inversion(mod):
    w = mod.Witness()
    a = mod._WLock(w, "lock.C", threading.Lock())
    b = mod._WLock(w, "lock.C", threading.Lock())
    with a:
        with b:
            pass

    def rev():
        with b:
            with a:
                pass

    _in_thread(rev)
    return w


def _scenario_rlock(mod):
    w = mod.Witness()
    r = mod._WLock(w, "lock.R", threading.RLock())
    with r:
        with r:
            pass
    return w


def _scenario_condition_wait(mod):
    w = mod.Witness()
    cond = mod._WCondition(w, "lock.cond")
    other = mod._WLock(w, "lock.other", threading.Lock())
    started = threading.Event()

    def waiter():
        with cond:
            started.set()
            cond.wait(timeout=5)

    th = threading.Thread(target=waiter)
    th.start()
    started.wait(5)
    with other:
        with cond:
            cond.notify_all()
    th.join(5)
    return w


class _Obj:
    """A bare field-state carrier."""


def _in_thread(fn):
    th = threading.Thread(target=fn)
    th.start()
    th.join()


def _scenario_race(mod):
    w = mod.Witness()
    o = _Obj()
    w.note_field_write(o, "x")
    _in_thread(lambda: w.note_field_write(o, "x"))
    w.note_field_write(o, "x")
    _in_thread(lambda: w.note_field_write(o, "x"))
    return w


def _scenario_handoff(mod):
    w = mod.Witness()
    o = _Obj()
    w.note_field_write(o, "x")
    w.note_field_write(o, "x")

    def worker():
        for _ in range(3):
            w.note_field_write(o, "x")

    _in_thread(worker)
    return w


def _scenario_common_lock(mod):
    w = mod.Witness()
    lk = mod._WLock(w, "lock.L", threading.Lock())
    o = _Obj()

    def locked_write():
        with lk:
            w.note_field_write(o, "x")

    locked_write()
    _in_thread(locked_write)
    locked_write()
    _in_thread(locked_write)
    _in_thread(lambda: w.note_field_write(o, "x"))
    return w


def _scenario_reset_epoch(mod):
    w = mod.Witness()
    o = _Obj()
    w.note_field_write(o, "x")
    _in_thread(lambda: w.note_field_write(o, "x"))
    w.reset_fields(o)
    w.note_field_write(o, "x")
    _in_thread(lambda: w.note_field_write(o, "x"))
    return w


SCENARIOS = {
    "inversion": _scenario_inversion,
    "instance_inversion": _scenario_instance_inversion,
    "rlock_recursion": _scenario_rlock,
    "condition_wait": _scenario_condition_wait,
    "race": _scenario_race,
    "handoff": _scenario_handoff,
    "common_lock": _scenario_common_lock,
    "reset_epoch": _scenario_reset_epoch,
}


def _norm(report: str) -> str:
    """A report without its sites, thread tokens and serials (those
    name where and in which run it was seen, not what)."""
    report = re.sub(r"at \[[^\]]*\]", "at []", report)
    report = re.sub(r"@ \S+", "@", report)
    report = re.sub(r"(#|thread )\d+", r"\1N", report)
    return report


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_witness_reports_match_reference(name):
    w = SCENARIOS[name](witness)
    jw = SCENARIOS[name](jwitness)
    assert [_norm(r) for r in w.inversions()] == [_norm(r) for r in jw.inversions()]
    assert [_norm(r) for r in w.races()] == [_norm(r) for r in jw.races()]
    assert set(w.edges()) == set(jw.edges())
    expect = {"inversion": (1, 0), "instance_inversion": (1, 0), "race": (0, 1),
              "common_lock": (0, 1)}.get(name, (0, 0))
    assert (len(w.inversions()), len(w.races())) == expect


def test_race_instrumentation_is_arm_time_only(monkeypatch):
    class Box:
        __race_fields__ = frozenset({"v"})

        def __init__(self):
            self.v = 0

    assert "__setattr__" not in vars(Box)
    fresh = witness.Witness()
    monkeypatch.setattr(witness, "_global", fresh)
    witness._instrument_one_class(Box)
    witness._instrument_one_class(Box)  # idempotent
    b = Box()
    _in_thread(lambda: setattr(b, "v", 1))
    b.v = 2
    races = fresh.races()
    assert len(races) == 1 and "Box.v" in races[0]
    for cls, own in list(witness._race_patched):
        if cls is Box:
            witness._race_patched.remove((cls, own))


RACE_CLASSES = [
    ("dgraph_tpu_torch.mesh.fault", "MeshFaultDomain"),
    ("dgraph_tpu_torch.sched.qos", "CancelToken"),
    ("dgraph_tpu_torch.sched.scheduler", "CohortScheduler"),
    ("dgraph_tpu_torch.obs.ledger", "Ledger"),
    ("dgraph_tpu_torch.ivm.deltas", "DeltaStream"),
    ("dgraph_tpu_torch.models.arena", "ArenaManager"),
    ("dgraph_tpu_torch.cluster.peerclient", "_PeerState"),
    ("dgraph_tpu_torch.utils.devguard", "_Job"),
    ("dgraph_tpu_torch.utils.devguard", "DeviceGuard"),
]


@pytest.mark.parametrize("mod,cls", RACE_CLASSES, ids=[c for _m, c in RACE_CLASSES])
def test_race_fields_match_reference_and_are_witnessed(mod, cls):
    """The port's nine annotated classes carry the reference's field sets
    (ArenaManager without the build generation the port does not keep),
    every name is a slot where __slots__ is declared, and the suite's
    armed witness wraps each class."""
    import importlib

    port_cls = getattr(importlib.import_module(mod), cls)
    ref_cls = getattr(importlib.import_module(mod.replace("dgraph_tpu_torch", "dgraph_tpu")), cls)
    fields = set(vars(port_cls)["__race_fields__"])
    ref_fields = set(vars(ref_cls)["__race_fields__"])
    if cls == "ArenaManager":
        assert ref_fields - fields == {"_inval_gen_star"} and fields <= ref_fields
    else:
        assert fields == ref_fields
    slots = vars(port_cls).get("__slots__")
    if slots is not None:
        assert fields <= set(slots) and "_race_serial" in slots
    if jwitness.current() is None or not jwitness.races_enabled():
        pytest.skip("the suite's witness is disarmed for this run")
    jwitness.arm()
    assert vars(port_cls).get("_race_instrumented") is True


def test_port_handoffs_and_rwlock_report_to_the_suites_witness():
    """tests/torch_witness.py pointed the port's hand-offs and RWLock at
    the suite's armed witness: the wraps are in place, an RWLock
    acquisition lands on the held stack, and a ledger hand-off resets
    its field states."""
    from dgraph_tpu_torch.obs import ledger
    from dgraph_tpu_torch.sched import cohort
    from dgraph_tpu_torch.utils.rwlock import RWLock

    if jwitness.current() is None or not jwitness.races_enabled():
        pytest.skip("the suite's witness is disarmed for this run")
    jwitness.arm()
    assert getattr(ledger.activate, "_race_wrap", False)
    assert getattr(ledger.finish, "_race_wrap", False)
    assert getattr(cohort.SchedRequest.complete, "_race_wrap", False)
    assert getattr(cohort.SchedRequest.fail, "_race_wrap", False)
    w = jwitness.current()
    lk = RWLock()
    with lk.read():
        assert (lk._witness_name, lk._witness_serial) in w._held()
    assert (lk._witness_name, lk._witness_serial) not in w._held()
    led = ledger.Ledger()
    led.edges = 5
    assert getattr(led, "_race_serial", None) in w._fields
    tok = ledger.activate(led)
    ledger.deactivate(tok)
    assert led._race_serial not in w._fields


_SERVE_8 = r"""
import json, sys, threading, urllib.request
sys.path.insert(0, {root!r})
import dgraph_tpu_torch.serve.server as server_mod
from dgraph_tpu_torch.models import PostingStore
from dgraph_tpu_torch.analysis import witness
from dgraph_tpu_torch.utils import metrics
w = witness.arm()
import numpy as np
st = PostingStore()
st.apply_schema("friend: [uid] .")
src = np.repeat(np.arange(1, 41), 2)
dst = np.concatenate([[1 + (i % 40), 1 + ((i * 7) % 40)] for i in range(1, 41)])
st.bulk_set_uid_edges("friend", src, dst)
srv = server_mod.DgraphServer(st, device="cpu")
assert srv.scheduler is not None
srv.start()
errors, bodies = [], []
def client(k):
    try:
        q = "{{ q(func: uid(0x%x)) {{ uid friend {{ uid friend {{ uid }} }} }} }}" % (1 + k)
        req = urllib.request.Request(srv.addr + "/query", data=q.encode(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            bodies.append(json.loads(r.read()))
    except Exception as e:
        errors.append(repr(e))
threads = [threading.Thread(target=client, args=(k,)) for k in range(8)]
for t in threads: t.start()
for t in threads: t.join(60)
srv.stop()
print(json.dumps(dict(errors=errors, n=len(bodies), inversions=w.inversions(),
    races=w.races(), edges=len(w.edges()),
    fields=metrics.RACE_WITNESS_FIELDS.value())))
"""


def test_port_witness_alone_over_a_scheduled_server():
    """A fresh process arms only the port's witness, boots a CPU server
    (reads through the cohort scheduler) and serves 8 concurrent 2-hop
    requests: every one answers, the witness saw lock orders and field
    writes, and it reports no inversion and no race."""
    r = subprocess.run(
        [sys.executable, "-I", "-c", _SERVE_8.format(root=str(ROOT))],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
    )
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["errors"] == [] and out["n"] == 8
    assert out["inversions"] == [] and out["races"] == []
    assert out["edges"] > 0 and out["fields"] > 0


# ---------------------------------------------------------- clean tree

def test_shipped_tree_is_clean():
    findings = framework.run_rules(
        [str(PKG)], rules.ALL_RULES, repo_root=str(ROOT),
        exclude=("dgraph_tpu_torch/analysis/",),
    )
    assert findings == [], "\n".join(f.render() for f in findings)


def test_shipped_lock_graph_cycle_free():
    graph, problems = lockorder.check_lock_order(
        [str(PKG)], repo_root=str(ROOT), exclude=("dgraph_tpu_torch/analysis/",))
    assert problems == [], "\n".join(problems)
    assert len(graph.classes) >= 15
    assert len(graph.edges) >= 3


def test_shipped_tree_has_no_escapes_and_empty_manifests():
    findings = escape.check_escapes(
        [str(PKG)], repo_root=str(ROOT), exclude=("dgraph_tpu_torch/analysis/",))
    assert findings == [], "\n".join(f.render() for f in findings)
    shared = json.loads((PKG / "analysis" / "shared.json").read_text())
    assert shared["fingerprints"] == []


# ------------------------------------------------------------------ CLI

CLI_BAD = {
    "wallclock-duration": "import time\n\ndef f(t):\n    return time.time() + t\n",
    "swallowed-exception": (
        "def f():\n    try:\n        g()\n    except Exception:\n        pass\n"),
    "naked-peer-rpc": (
        "from dgraph_tpu_torch.cluster.transport import urlopen_peer\n\n"
        "def f(req, auth):\n    return urlopen_peer(req, 5, auth)\n"),
    "naked-atomic-write": "import os\n\ndef f(tmp, path):\n    os.replace(tmp, path)\n",
    "naked-resident-transfer": (
        "def f(arena):\n    ra = arena.resident()\n    return ra.dst.cpu()\n"),
    "naked-collective": "def f(t, root):\n    return psum(t, root)\n",
    "unregistered-metric": (
        "from dgraph_tpu_torch.utils.metrics import metrics\n\n"
        "X = metrics.counter(\"dgraph_nowhere_total\")\n"),
}


@pytest.mark.parametrize("rule", sorted(CLI_BAD))
def test_cli_exits_nonzero_on_golden_bad(rule, tmp_path, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text(CLI_BAD[rule])
    assert main([str(bad)]) == 1
    assert f"[{rule}]" in capsys.readouterr().out


def test_cli_clean_tree_and_baseline_roundtrip(tmp_path, capsys):
    assert main([]) == 0
    out = capsys.readouterr().out
    assert "graftlint: clean" in out and "lock-order: cycle-free" in out
    bad = tmp_path / "bad.py"
    bad.write_text(CLI_BAD["wallclock-duration"])
    base = tmp_path / "baseline.json"
    assert main([str(bad), "--write-baseline", str(base)]) == 0
    assert main([str(bad), "--baseline", str(base)]) == 0
    bad.write_text(CLI_BAD["wallclock-duration"]
                   + "\ndef g():\n    try:\n        f(1)\n    except Exception:\n        pass\n")
    assert main([str(bad), "--baseline", str(base)]) == 1


def test_baseline_is_a_multiset(tmp_path):
    one = "def f():\n    try:\n        g()\n    except Exception:\n        pass\n"
    bad = tmp_path / "bad.py"
    bad.write_text(one)
    base = tmp_path / "baseline.json"
    assert main([str(bad), "--write-baseline", str(base)]) == 0
    assert main([str(bad), "--baseline", str(base)]) == 0
    bad.write_text(one + "\n\ndef h():\n    try:\n        g()\n    except Exception:\n        pass\n")
    assert main([str(bad), "--baseline", str(base)]) == 1


def test_lock_graph_flag_prints_the_graph(capsys):
    assert main(["--no-lint", "--lock-graph"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("lock classes:")
    assert ("dgraph_tpu_torch.serve.server.DgraphServer._stop_lock -> "
            "dgraph_tpu_torch.serve.server.DgraphServer._engine_lock") in out


_RACY = _d("""
    import threading

    class P:
        def __init__(self):
            self.n = 0
            threading.Thread(target=self.run).start()

        def run(self):
            self.n += 1

        def poke(self):
            self.n = 2
""")


def test_races_cli_and_manifest_roundtrip(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(_RACY)
    assert main(["--races", str(bad)]) == 1
    assert main(["--races"]) == 0
    manifest = tmp_path / "shared.json"
    assert main(["--races", str(bad), "--write-shared", str(manifest)]) == 0
    assert main(["--races", str(bad), "--shared-manifest", str(manifest)]) == 0
    bad.write_text(_RACY + _RACY.replace("class P", "class Q").replace(
        "import threading\n", ""))
    assert main(["--races", str(bad), "--shared-manifest", str(manifest)]) == 1


# ------------------------------------------------------------ contracts

@pytest.mark.parametrize("contract", programs.CONTRACTS, ids=[c.kernel for c in programs.CONTRACTS])
def test_contract_cpu_half(contract):
    """On CPU tensors each wrapper is its plain version: the dtype, shape
    and values match, and nothing launches."""
    rows = programs.check_cpu(contract)
    assert len(rows) == 3
    assert all(r["max_abs_err"] == 0 and r["dtype"] == "int32" for r in rows)


def test_contract_instances_match_the_reference_kernels():
    """The contract inputs through the port's wrappers equal the
    reference's Pallas kernels (interpret mode) on the same inputs."""
    import jax.numpy as jnp
    import torch

    from dgraph_tpu.ops.pallas_gather import gather_pallas_packed
    from dgraph_tpu.ops.pallas_intersect import intersect_pallas
    from dgraph_tpu.ops.pallas_slotmap import slotmap_pallas

    by = {c.kernel: c for c in programs.CONTRACTS}
    from dgraph_tpu_torch.ops import gather, kway, slotmap

    for inst in by["gather_fused"].build():
        cap = int(inst.key.split("C")[1])
        got = inst.call(gather, *[torch.from_numpy(x) for x in inst.inputs])
        want = gather_pallas_packed(*[jnp.asarray(x) for x in inst.inputs],
                                    cap=cap, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for inst in by["slotmap_tiles"].build():
        capc = int(inst.key.split("C")[1])
        got = inst.call(slotmap, *[torch.from_numpy(x) for x in inst.inputs])
        want = slotmap_pallas(*[jnp.asarray(x) for x in inst.inputs],
                              capc=capc, interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for inst in by["intersect_tiles"].build():
        got = inst.call(kway, torch.from_numpy(inst.inputs[0])).numpy()
        mats = inst.inputs[0] if inst.inputs[0].ndim == 3 else inst.inputs[0][None]
        want = np.stack([np.asarray(intersect_pallas(jnp.asarray(m), interpret=True))
                         for m in mats])
        np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_shipped_sites_are_all_covered():
    assert programs.uncovered_sites() == []
    cons = programs.kernel_constructions()
    ents = programs.extern_entries()
    assert sorted((s, e) for _site, s, e in cons) == sorted(
        (c.source, c.entry) for c in programs.CONTRACTS)
    assert sorted((s, e) for _site, s, e in ents) == sorted(
        (c.source, c.entry) for c in programs.CONTRACTS)


def _seeded_pkg(tmp_path):
    pkg = tmp_path / "dgraph_tpu_torch"
    (pkg / "ops").mkdir(parents=True)
    (pkg / "csrc").mkdir()
    for c in programs.CONTRACTS:
        (pkg / "ops" / f"{c.source}.py").write_text(
            f"KERNEL = CudaKernel({c.source!r}, {c.entry!r}, [])\n")
        (pkg / "csrc" / f"{c.source}.cu").write_text(
            f'extern "C" int {c.entry}(const void* a, void* stream) {{ return 0; }}\n')
    return pkg


def test_coverage_fails_on_a_seeded_kernel_site(tmp_path):
    pkg = _seeded_pkg(tmp_path)
    assert programs.uncovered_sites(pkg) == []
    (pkg / "ops" / "extra.py").write_text(
        "from dgraph_tpu_torch.ops._build import CudaKernel\n\n"
        "KERNEL = CudaKernel(\"extra\", \"extra_entry\", [])\n")
    missing = programs.uncovered_sites(pkg)
    assert len(missing) == 1 and "extra_entry" in missing[0]
    assert missing[0].startswith("dgraph_tpu_torch/ops/extra.py:3")
    (pkg / "csrc" / "extra.cu").write_text(
        '__global__ void k() {}\nextern "C" int extra_entry(void* s) { return 0; }\n')
    missing = programs.uncovered_sites(pkg)
    assert len(missing) == 2 and "csrc/extra.cu:2" in missing[1]
    (pkg / "ops" / "gather.py").write_text("KERNEL = None\n")
    missing = programs.uncovered_sites(pkg)
    assert any(m.startswith("contract gather_fused: no CudaKernel") for m in missing)


def test_programs_cuda_raises_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        programs.check_all("cuda")
    assert main(["--programs", "--device", "cpu"]) == 0
