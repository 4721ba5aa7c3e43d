"""Elastic mesh fault domain: chip loss as a CAPACITY event (PyTorch
port of ``dgraph_tpu/mesh/fault.py``).

Without it a single sick chip collapses the whole mesh route:
devguard's monolithic "mesh" domain latches on any classified fault and
every eligible expansion re-plans unsharded — N−1 healthy chips'
capacity forfeited to one failure.  The fault domain splits the plane:

- **Per-chip sub-domains** — each mesh chip gets its own
  :class:`~dgraph_tpu_torch.utils.devguard.DeviceGuard` (``mesh.chip<i>``,
  ``sick_after=1``: one attributed fault evicts).  The plane guard's
  ``fault_sink`` consults :func:`devguard.chip_of` — a fault whose
  exception chain names a chip (``devguard.ChipFaultError`` from one of
  several distinct cards, or the ``chip=`` failpoint selector) charges
  THAT chip's guard and leaves the plane guard untouched; un-attributed
  faults (any real CUDA fault on virtual chips of one card, which is the
  whole card's) latch the plane, and levels re-plan unsharded.

- **Epoch-fenced re-shard** — evicting a chip re-targets the
  :class:`~dgraph_tpu_torch.mesh.plan.MeshPlan` at the surviving sub-mesh
  (``rebalance(n_shards=k)``, N−1 … down to 1 chip), drops the stale
  sharded views (survivors re-seed lazily under the existing HBM
  budget/LRU), and publishes a new epoch — the plan version the new
  sub-mesh was sharded under.  Every dispatched mesh program carries
  the fence it was planned under (:meth:`fence`); an in-flight
  segmented query observing a flip at a ``segments.seam()`` drains its
  carry to host and resumes under the new plan (mesh/executor.py).

- **Staged rejoin (warm-then-cutover)** — a healed chip re-enters
  behind its guard's half-open probe via ``on_readmit``: the candidate
  sub-mesh is built, sharded views are re-built at the candidate width
  and the recently-served dispatch shapes are run against them
  BEFORE the epoch flips (``fail.point("mesh.warm")`` is the
  chaos hook).  A warm failure re-latches the chip sick without
  touching live traffic — a flapping chip can never bounce the serving
  plan — and a clean warm cuts over atomically, adopting the staged
  shards.

Gate: ``DGRAPH_TPU_MESH_ELASTIC`` (default on).  ``0`` keeps one
"mesh" domain: chip loss degrades to unsharded.
``DGRAPH_TPU_MESH_RESUME_RETRIES`` (default 2) bounds the re-plans of
one in-flight query.  Observability: ``dgraph_mesh_epoch``,
``dgraph_mesh_chips_healthy``, ``dgraph_mesh_reshard_total{reason}``,
``dgraph_mesh_reshard_seconds``, the ``mesh.reshard`` span, the
``/health?detail=1`` ``mesh`` section, and the ``degraded.mesh`` /
``dgraph-mesh-epoch`` response annotations.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dgraph_tpu_torch.utils import devguard
from dgraph_tpu_torch.utils.failpoints import fail
from dgraph_tpu_torch.utils.metrics import (
    MESH_CHIPS_HEALTHY,
    MESH_EPOCH,
    MESH_RESHARD,
    MESH_RESHARD_SECONDS,
)


def elastic_enabled() -> bool:
    """The DGRAPH_TPU_MESH_ELASTIC gate (default ON); ``0`` keeps the
    monolithic mesh domain — chip loss degrades the route to unsharded
    instead of re-sharding onto survivors."""
    return os.environ.get("DGRAPH_TPU_MESH_ELASTIC", "1") != "0"


def resume_retries() -> int:
    """How many times one in-flight query may re-plan-and-resume before
    surrendering the mesh route to the caller's unsharded fallback
    (bounded retry budget — a re-shard storm must degrade, not loop)."""
    return int(os.environ.get("DGRAPH_TPU_MESH_RESUME_RETRIES", "2"))


# at most this many (shape × staged arena) warm dispatches per rejoin:
# the warm proves the candidate sub-mesh on the shapes live traffic is
# using, not the whole shape space
_WARM_CAP = 16


class StagedShards:
    """Sharded views pre-built at a rejoin CANDIDATE width, before the
    epoch flips.  ``views`` holds ArenaManager ``_sharded``-shaped
    entries — ``(source arena, ShardedArena, offset)`` keyed by
    ``(pred, reverse)`` — built under the plan's PREVIEWED candidate
    placement; the cutover adopts them only if the survivor set decided
    at cutover still matches ``width`` (a loss racing the warm just
    discards the stage)."""

    __slots__ = ("width", "views")

    def __init__(self, width: int):
        self.width = int(width)
        self.views: Dict[tuple, tuple] = {}


class MeshFaultDomain:
    """Per-chip health + epoch-fenced sub-mesh re-sharding for one
    ArenaManager's mesh.  Created by the manager at boot (elastic gate
    permitting); the executor reads :meth:`fence`/:attr:`mesh` on every
    dispatch and the per-chip guards own eviction/rejoin."""

    # callers (the plane guard's fault_sink runs on query threads), the
    # chip guards' probe loops (rejoin) and /health readers all touch the
    # serving plan: every write below holds self._lock, and _fence is
    # published as ONE tuple swap so readers never see a torn pair (the
    # armed lockset witness, analysis/witness.py, checks the writes)
    __race_fields__ = frozenset({
        "epoch", "reshards", "drains", "_healthy", "_mesh", "_fence",
    })

    def __init__(self, arenas, mesh):
        self.arenas = arenas          # models/arena.py::ArenaManager
        self.boot_mesh = mesh
        # model-axis device order of the boot mesh — chip i everywhere
        # in this module means THIS index (failpoint chip=, guard
        # domain names, /health chips)
        self.devices = mesh.model_devices()
        self.n_chips = len(self.devices)
        self._lock = threading.RLock()
        self._healthy = frozenset(range(self.n_chips))
        # healthy-set → Mesh, memoized so a rejoin back to a previously
        # served set reuses the SAME Mesh object (the boot mesh on a
        # rejoin to full width)
        self._meshes: Dict[frozenset, object] = {
            self._healthy: mesh
        }
        self._mesh = mesh
        self.epoch = self.plan.version if self.plan is not None else 0
        # the dispatch fence: ONE tuple, swapped atomically at re-shard
        # — executors capture it at plan time and compare identity at
        # every segment seam
        self._fence: Tuple[int, object] = (self.epoch, mesh)
        self.reshards = 0
        self.drains = 0               # in-flight drain-and-resumes
        # dispatch shapes live traffic used — what a rejoin warms.
        # dict as an ordered bounded set: kind → ("hop", cap, hops) or
        # ("expand", cap, fcap)
        self._shapes: Dict[tuple, None] = {}
        self._chip_guards: Dict[int, devguard.DeviceGuard] = {}
        self.attach()
        MESH_EPOCH.set(self.epoch)
        MESH_CHIPS_HEALTHY.set(self.n_chips)

    # -- wiring ---------------------------------------------------------------

    @property
    def plan(self):
        return self.arenas.mesh_plan

    @property
    def mesh(self):
        """The CURRENT serving sub-mesh (the boot mesh until a chip is
        evicted)."""
        return self._mesh

    @property
    def width(self) -> int:
        return int(self._mesh.shape["model"])

    def attach(self) -> None:
        """(Re-)attach the fault sink to the plane guard — devguard's
        ``reset_for_tests`` builds fresh guards, so the executor
        re-checks on each dispatch via :meth:`plane_guard`."""
        devguard.get("mesh").fault_sink = self._sink

    def plane_guard(self) -> devguard.DeviceGuard:
        g = devguard.get("mesh")
        if g.fault_sink is not self._sink:
            g.fault_sink = self._sink
        return g

    def fence(self) -> Tuple[int, object]:
        """The (epoch, mesh) pair a dispatch is planned under.  Compare
        pairs: an epoch bump with the same mesh never happens (the
        epoch only moves at re-shard), and placement-only plan-version
        bumps between re-shards are byte-invisible by the MeshPlan
        correctness argument, so they need no fence at all."""
        return self._fence

    def chip_guard(self, chip: int) -> devguard.DeviceGuard:
        # resolved through the registry EVERY call (not a held
        # reference): devguard.reset_for_tests rebuilds guards, and a
        # stale object here would split the domain's view of chip
        # health from the registry's
        g = devguard.ensure(
            f"mesh.chip{chip}",
            sick_after=1,
            probe_fn=lambda c=chip: self._chip_probe(c),
            on_readmit=lambda c=chip: self._chip_rejoin(c),
        )
        with self._lock:
            self._chip_guards[chip] = g
        return g

    def note_shape(self, kind: str, *dims: int) -> None:
        """Record a dispatch shape live traffic used (the rejoin warm
        set).  Bounded FIFO — shapes are bucketed caps, so the set
        is small by construction."""
        key = (kind, *dims)
        with self._lock:
            self._shapes[key] = None
            while len(self._shapes) > _WARM_CAP:
                self._shapes.pop(next(iter(self._shapes)))

    # -- fault attribution ----------------------------------------------------

    def _sink(self, kind: str, op: str, exc: BaseException) -> bool:
        """The plane guard's fault_sink: True = one chip owns this
        fault (guard charged, plan re-sharded, plane untouched)."""
        if not elastic_enabled():
            return False
        if kind == "hang":
            # a watchdog overrun has no exception to attribute: the
            # plane latches sick and in-flight segmented queries finish
            # their remaining hops unsharded
            return False
        chip = devguard.chip_of(exc)
        if chip is None or not (0 <= chip < self.n_chips):
            return False
        g = self.chip_guard(chip)
        g.note_fault(kind, op, exc)
        with self._lock:
            lost = chip in self._healthy
        if lost:
            self.reshard("loss")
        return True

    # -- re-shard -------------------------------------------------------------

    def _survivors(self, admit: Optional[int] = None) -> frozenset:
        """The healthy chip set, derived from guard states — eviction
        is one-way except through ``admit`` (the staged-rejoin cutover
        names the chip it just warmed; a merely-probed chip whose warm
        has not passed can never slip back in via someone else's
        re-shard)."""
        # caller holds self._lock
        alive = {
            i for i in self._healthy
            if i not in self._chip_guards or self._chip_guards[i].allowed()
        }
        if admit is not None and 0 <= admit < self.n_chips:
            g = self._chip_guards.get(admit)
            if g is None or g.allowed():
                alive.add(admit)
        return frozenset(alive)

    def _submesh(self, chips: frozenset):
        # caller holds self._lock
        m = self._meshes.get(chips)
        if m is None:
            from dgraph_tpu_torch.parallel.mesh import Mesh

            m = Mesh([[self.devices[i] for i in sorted(chips)]])
            self._meshes[chips] = m
        return m

    def reshard(
        self, reason: str, admit: Optional[int] = None, staged=None
    ) -> bool:
        """Re-target the serving plan at the current survivor set.
        Returns whether the plan changed.  ``reason`` ∈ loss / rejoin /
        manual (the metric label); ``staged`` is a rejoin's pre-built
        sharded views, adopted only when their width still matches the
        survivor set decided HERE (a loss racing the warm simply
        discards the stage — correctness never depends on it)."""
        t0 = time.perf_counter()
        from dgraph_tpu_torch import obs

        with self._lock:
            chips = self._survivors(admit)
            if not chips:
                # nothing to serve on: leave the plan alone and let the
                # plane guard's ordinary latch degrade the route
                return False
            if chips == self._healthy:
                return False
            mesh = self._submesh(chips)
            if self.plan is not None:
                self.plan.rebalance(n_shards=len(chips))
                self.epoch = self.plan.version
            else:
                self.epoch += 1
            self._healthy = chips
            self._mesh = mesh
            self._fence = (self.epoch, mesh)
            self.reshards += 1
            epoch, width = self.epoch, len(chips)
        # cache surgery outside the domain lock (it takes the arena
        # cache lock; the build path takes them in the other order)
        self.arenas.drop_sharded()
        if staged is not None and width == staged.width:
            self.arenas.adopt_sharded(staged)
        MESH_RESHARD.add(reason)
        MESH_EPOCH.set(epoch)
        MESH_CHIPS_HEALTHY.set(width)
        dt = time.perf_counter() - t0
        MESH_RESHARD_SECONDS.observe(dt)
        with obs.child("mesh.reshard") as rs:
            rs.set_attr("reason", reason)
            rs.set_attr("epoch", epoch)
            rs.set_attr("chips", width)
        print(
            f"# mesh fault domain re-sharded ({reason}): epoch {epoch}, "
            f"{width}/{self.n_chips} chips healthy "
            f"({dt * 1e3:.1f}ms drain window)",
            file=sys.stderr,
        )
        return True

    # -- drain accounting -----------------------------------------------------

    def note_drain(self, delta: int) -> None:
        with self._lock:
            self.drains += delta

    # -- staged rejoin --------------------------------------------------------

    def _chip_probe(self, chip: int) -> None:
        """The half-open probe for one chip: a trivial dispatch that
        must round-trip THAT device (the plane's default probe only
        proves the default device answers)."""
        fail.point("mesh.chip.probe")
        # the half-open probe: its round trip IS the health check, run on
        # the guard's probe loop (the reference's block_until_ready,
        # mesh/fault.py)
        # graftlint: ignore[naked-device-sync]
        torch.arange(8, device=self.devices[chip]).sum().item()

    def _chip_rejoin(self, chip: int) -> None:
        """on_readmit for one chip guard: warm-then-cutover.  Runs on
        the guard's probe loop thread — live traffic keeps serving the
        surviving sub-mesh until the cutover flips the epoch, and a
        warm failure re-latches the chip without any epoch churn."""
        if not elastic_enabled():
            return
        with self._lock:
            if chip in self._healthy:
                return
            candidate = self._survivors(admit=chip)
            if chip not in candidate:
                return
            cand_mesh = self._submesh(candidate)
            shapes = list(self._shapes)
        try:
            fail.point("mesh.warm")
            staged = self.arenas.warm_sharded(cand_mesh)
            self._warm_programs(cand_mesh, staged, shapes)
        except Exception as e:  # noqa: BLE001 — ANY warm failure means
            # the candidate plan is unproven: re-latch the chip (its
            # probe loop restarts) and keep serving the current plan —
            # the flapping-chip contract
            self.chip_guard(chip).note_fault(
                "transient", "mesh.warm", e
            )
            print(
                f"# mesh chip {chip} rejoin warm failed "
                f"({type(e).__name__}: {e}); chip re-latched sick, "
                "serving plan unchanged",
                file=sys.stderr,
            )
            return
        self.reshard("rejoin", admit=chip, staged=staged)

    def _warm_programs(self, mesh, staged, shapes) -> None:
        """Run the recently-served dispatch shapes on the candidate mesh
        BEFORE cutover, against the staged shards, and wait for them: a
        chip that cannot serve them never joins the serving plan."""
        from dgraph_tpu_torch.mesh.programs import mesh_multi_hop_step
        from dgraph_tpu_torch.ops.sets import SENT
        from dgraph_tpu_torch.parallel.mesh import (
            seg_expand_packed_step,
            shard_arena_rows,
        )

        views = list(staged.views.values())
        if not views:
            # nothing sharded yet: prove the collective plane itself
            # with a minimal synthetic arena
            views = [(
                None,
                shard_arena_rows(
                    np.array([1], dtype=np.int64),
                    np.array([0, 0], dtype=np.int64),
                    np.empty(0, dtype=np.int64),
                    int(mesh.shape["model"]),
                    devices=mesh.model_devices(),
                ),
                0,
            )]
        budget = _WARM_CAP
        for _a, sa, _off in views:
            for shape in shapes or [("hop", 256, 1)]:
                if budget <= 0:
                    return
                budget -= 1
                if shape[0] == "hop":
                    _kind, cap, hops = shape
                    f = torch.full((cap,), SENT, dtype=torch.int32,
                                   device=mesh.root)
                    out = mesh_multi_hop_step(mesh, sa, f, cap, hops)[0]
                else:
                    _kind, cap, fcap = shape
                    f = torch.full((fcap,), SENT, dtype=torch.int32,
                                   device=mesh.root)
                    out, _slots = seg_expand_packed_step(
                        mesh, sa, f, cap, fcap
                    )
                # the rejoin's warm-up waits for each program on the
                # rejoining chip, as the reference's block_until_ready
                # (mesh/fault.py)
                # graftlint: ignore[naked-device-sync]
                out.cpu()

    # -- surfaces -------------------------------------------------------------

    def degraded_info(self) -> dict:
        """The response annotation for sub-mesh serving (the
        degraded-read disclosure, mesh flavored): results are
        byte-identical, capacity is not."""
        with self._lock:
            return {
                "epoch": self.epoch,
                "chips_healthy": len(self._healthy),
                "chips_total": self.n_chips,
            }

    def status(self) -> dict:
        """The /health?detail=1 ``mesh`` section."""
        with self._lock:
            healthy = self._healthy
            epoch = self.epoch
            reshards = self.reshards
            drains = self.drains
            guards = dict(self._chip_guards)
        chips = {}
        for i in range(self.n_chips):
            g = guards.get(i)
            chips[str(i)] = (
                "healthy" if g is None
                else g.state + ("" if i in healthy else " (evicted)")
            )
        plan = self.plan
        placement = None
        if plan is not None:
            with plan._lock:
                placement = {
                    "n_shards": plan.n_shards,
                    "predicates": len(plan.placement),
                    "version": plan.version,
                }
        return {
            "elastic": elastic_enabled(),
            "epoch": epoch,
            "chips_total": self.n_chips,
            "chips_healthy": len(healthy),
            "chips": chips,
            "reshards": reshards,
            "drains_in_flight": drains,
            "placement": placement,
        }
