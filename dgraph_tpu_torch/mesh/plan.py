"""MeshPlan: predicate→shard placement for the mesh serving plane
(copy of ``dgraph_tpu/mesh/plan.py``; host-only).

``shard_arena_rows`` (parallel/mesh.py) always puts a predicate's
first uid-range shard at model-axis position 0.  Left alone, EVERY
predicate's densest region (low uids are the oldest, usually hottest
rows) lands on chip 0 — the mesh-wide analog of the reference's group
hot-spotting (group/conf.go's fingerprint-mod placement exists for the
same reason).  A ``MeshPlan`` assigns each predicate a START OFFSET on
the model axis; the sharded arrays are rolled by that offset before
upload, so different predicates' shard 0 lands on different chips.

Correctness: the roll permutes WHICH device owns WHICH uid-range
slice, nothing else.  Every cross-shard combine in the mesh kernels is
position-independent — ``rows_of`` resolves a uid only on its owner
wherever it sits, the packed reassembly combines via ``psum``/``pmin``
(commutative), and the gather-merge path re-sorts — so placement is
byte-invisible to results (tests/test_torch_mesh_serving.py pins this).

Placement is greedy least-loaded: a predicate's shard 0 goes to the
chip with the least placed bytes so far.  ``rebalance()`` re-runs the
assignment over everything seen (big predicates first), for operators
reshaping a skewed mesh; the plan version bumps so cached sharded
arenas rebuild under the new offsets.

Persistence: ``DGRAPH_TPU_MESH_PLAN`` names a JSON file; the plan
loads on boot and every placement change writes back atomically
(tmp + rename, the models/durability.py discipline).  Unset = in-memory
only (tests, embedded engines).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional


def plan_path() -> str:
    """The DGRAPH_TPU_MESH_PLAN knob ("" = in-memory plan)."""
    return os.environ.get("DGRAPH_TPU_MESH_PLAN", "")


def _greedy_pack(order, n_shards: int):
    """The one greedy bin-pack (biggest predicate first, least-loaded
    chip): ``rebalance`` commits its result, ``preview`` only looks.
    Shared so the two can never disagree — the staged rejoin warms
    shards under preview's offsets and relies on the cutover rebalance
    reproducing them exactly."""
    load = [0] * n_shards
    placement: Dict[str, int] = {}
    for pred, nb in order:
        off = min(range(n_shards), key=lambda i: load[i])
        placement[pred] = off
        load[off] += nb
    return placement, load


class MeshPlan:
    """Predicate→start-shard placement over an ``n_shards``-wide model
    axis.  Thread-safe: the serving layer places from concurrent read
    shells (ArenaManager.sharded_csr builds under arena locks)."""

    def __init__(self, n_shards: int, path: str = ""):
        self.n_shards = max(1, int(n_shards))
        self.path = path
        self.version = 0
        # pred -> model-axis offset of the predicate's shard 0
        self.placement: Dict[str, int] = {}
        # pred -> device bytes at placement time (the rebalance input)
        self._bytes: Dict[str, int] = {}
        self._load = [0] * self.n_shards  # placed bytes per chip
        self._lock = threading.Lock()

    # -- placement -----------------------------------------------------------

    def offset_for(self, pred: str, device_bytes: int = 0) -> int:
        """This predicate's start offset, assigning (least-loaded chip)
        and persisting on first sight."""
        with self._lock:
            off = self.placement.get(pred)
            if off is not None:
                return off
            off = min(range(self.n_shards), key=lambda i: self._load[i])
            self.placement[pred] = off
            self._bytes[pred] = int(device_bytes)
            self._load[off] += int(device_bytes)
            self.version += 1
            self._save_locked()
            return off

    def placed(self, pred: str, sharded):
        """Apply this predicate's placement to a freshly built
        ``ShardedArena``: roll the shard axis so shard 0 lands on the
        assigned chip.  Offset 0 (and a 1-wide mesh) returns the input
        untouched — the staged arrays never copy for the common case."""
        off = self.offset_for(pred, sharded.device_bytes()) % self.n_shards
        return self.rolled(sharded, off)

    @staticmethod
    def rolled(sharded, off: int):
        """Apply one start offset to a freshly built ``ShardedArena``
        (shared with the staged-rejoin warm path, which rolls under a
        PREVIEWED placement before the plan itself re-targets): position
        j takes shard (j - off) mod n, as ``jnp.roll`` along the shard
        axis does.  The shards keep their tensors; the caller moves each
        onto its position's device."""
        if off == 0:
            return sharded
        from dgraph_tpu_torch.parallel.mesh import ShardedArena

        n = sharded.n_shards

        def roll(ts):
            return [ts[(j - off) % n] for j in range(n)]

        return ShardedArena(
            src=roll(sharded.src),
            offsets=roll(sharded.offsets),
            dst=roll(sharded.dst),
            n_shards=n,
        )

    def preview(self, n_shards: int) -> Dict[str, int]:
        """The placement ``rebalance(n_shards=n)`` WOULD commit, without
        touching the plan: the staged rejoin (mesh/fault.py) warms
        sharded views under the candidate width's offsets so the
        post-cutover rebalance finds them already valid.  Greedy is
        deterministic — same recorded bytes + same width ⇒ same
        offsets — which is the whole contract here."""
        with self._lock:
            order = sorted(self._bytes.items(), key=lambda kv: -kv[1])
        placement, _load = _greedy_pack(order, max(1, int(n_shards)))
        return placement

    def rebalance(self, n_shards: Optional[int] = None) -> Dict[str, int]:
        """Re-place everything seen so far, biggest predicate first
        (greedy bin-pack by recorded device bytes).  Returns the new
        placement; the version bump invalidates cached sharded arenas
        (ArenaManager keys the cache on it).

        ``n_shards`` re-targets the plan at a DIFFERENT model-axis
        width — the elastic mesh fault domain's re-shard (mesh/fault.py):
        chip loss packs everything onto the N−1 … 1 surviving chips,
        staged rejoin widens back.  The version bump is the mesh EPOCH
        FENCE — every dispatched mesh program carries the version it was
        planned under, and an in-flight query observing a bump at a
        segment seam re-plans its remaining hops under the new width."""
        with self._lock:
            if n_shards is not None:
                self.n_shards = max(1, int(n_shards))
            order = sorted(
                self._bytes.items(), key=lambda kv: -kv[1]
            )
            self.placement, self._load = _greedy_pack(
                order, self.n_shards
            )
            self.version += 1
            self._save_locked()
            return dict(self.placement)

    # -- persistence ---------------------------------------------------------

    def _save_locked(self) -> None:
        if not self.path:
            return
        from dgraph_tpu_torch.utils.atomicio import atomic_write_file

        try:
            atomic_write_file(
                self.path,
                json.dumps(
                    self.to_dict(), indent=1, sort_keys=True
                ).encode(),
            )
        except OSError:
            # read-only scratch: the in-memory plan still serves; the
            # next boot just re-derives placement
            pass

    def to_dict(self) -> dict:
        return {
            "n_shards": self.n_shards,
            "version": self.version,
            "placement": dict(self.placement),
            "bytes": dict(self._bytes),
        }

    @classmethod
    def load(cls, n_shards: int, path: Optional[str] = None) -> "MeshPlan":
        """Boot-time constructor: adopt a persisted plan when its shard
        width still matches the live mesh (a resized mesh re-derives —
        stale offsets beyond the new width would wrap arbitrarily)."""
        p = plan_path() if path is None else path
        plan = cls(n_shards, path=p)
        if not p:
            return plan
        try:
            with open(p) as f:
                d = json.load(f)
        except (OSError, ValueError):
            return plan
        if int(d.get("n_shards", 0)) != plan.n_shards:
            return plan
        plan.version = int(d.get("version", 0))
        plan.placement = {
            str(k): int(v) % plan.n_shards
            for k, v in d.get("placement", {}).items()
        }
        plan._bytes = {
            str(k): int(v) for k, v in d.get("bytes", {}).items()
        }
        plan._load = [0] * plan.n_shards
        for pred, off in plan.placement.items():
            plan._load[off] += plan._bytes.get(pred, 0)
        return plan
