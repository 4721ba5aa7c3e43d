"""MeshExecutor: the engine-facing entry points of the mesh plane
(PyTorch port of ``dgraph_tpu/mesh/executor.py``).

``parallel/mesh.py`` holds the raw sharded steps; the executor is what
the serving path calls — the one-hop sharded expansion behind
``DeviceExpander`` (query/engine.py ``_mesh_expand``) and the fused
multi-hop behind the chain (query/chain.py ``_try_mesh_chain``).  Both
carry the serving contract the steps alone do not:

- **fault domain**: every dispatch runs under the ``"mesh"`` device
  guard (utils/devguard.py).  With the elastic fault domain active
  (mesh/fault.py) a chip-attributed fault evicts that chip, re-shards
  the plan onto the survivors, and the executor retries under the new
  epoch (at most ``DGRAPH_TPU_MESH_RESUME_RETRIES`` times): the route
  stays mesh on the surviving sub-mesh.  An un-attributed fault raises
  ``DeviceFaultError`` and the caller re-plans the level or chain on the
  card's unsharded routes.
- **epoch fence + drain-and-resume**: a segmented multi-hop captures the
  fault domain's fence (epoch, mesh) at plan time and re-checks it at
  every ``segments.seam()``.  On a flip (another query's chip loss, a
  staged rejoin cutting over) the carry is already mirrored on the host
  (``f_host``: each segment's fetched last frontier row IS the carry's
  value), so the query re-fetches the sharded arena at the new width and
  resumes byte-identically.  A wedged dispatch (``DeviceHangError``) or a
  plane latched sick mid-query finishes the remaining hops on the card's
  unsharded ``ops.multi_hop`` from the host carry, never on the host.
- **ledger attribution**: wall time inside mesh dispatches, the width
  they ran on and the estimated exchange payload land on the request's
  ledger (obs/ledger.py ``mesh_ms`` / ``mesh_chips`` /
  ``exchange_bytes``).
- **placement**: sharded arenas come through
  ``ArenaManager.sharded_csr``, which applies the ``MeshPlan`` roll.

As in the engine's own guarded closures, a dispatch closure returns
plain data and writes no stats: a wedged worker that wakes later
writes nothing a newer request owns.
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch

from dgraph_tpu_torch import obs, ops
from dgraph_tpu_torch.obs import ledger as _ledger
from dgraph_tpu_torch.utils import devguard


class MeshExecutor:
    """Serving-path executor over one ArenaManager's mesh.  Holds no
    device state of its own (the sharded arenas are the manager's);
    ArenaManager memoizes one per manager (``mesh_executor()``)."""

    def __init__(self, arenas):
        self.arenas = arenas  # models/arena.py::ArenaManager

    @property
    def mesh(self):
        return self.arenas.mesh

    @property
    def width(self) -> int:
        """Model-axis width: the chips one dispatch spans."""
        m = self.mesh
        return int(m.shape["model"]) if m is not None else 1

    def allowed(self) -> bool:
        """May the mesh domain be dispatched to now (the plane guard's
        latch and half-open probe)?"""
        return self._guard().allowed()

    def _guard(self) -> devguard.DeviceGuard:
        """The plane guard, its fault sink re-attached when the elastic
        domain is live (devguard.reset_for_tests builds fresh guards)."""
        dom = self.arenas.mesh_fault
        if dom is not None:
            return dom.plane_guard()
        return devguard.get("mesh")

    def _retries(self) -> int:
        if self.arenas.mesh_fault is None:
            return 0
        from dgraph_tpu_torch.mesh.fault import resume_retries

        return resume_retries()

    def _chip_retryable(self, e: BaseException) -> bool:
        """A fault the elastic domain already attributed to one chip: its
        sink re-sharded the plan before the raise, so a retry dispatches
        the surviving sub-mesh.  Hangs and the sick latch never are."""
        if self.arenas.mesh_fault is None:
            return False
        if isinstance(e, (devguard.DeviceHangError, devguard.DeviceSickError)):
            return False
        return devguard.chip_of(e) is not None

    def _run(self, op: str, fn):
        if not devguard.enabled():
            return fn()
        return self._guard().run(op, fn)

    def _note_degraded(self, stats: dict, resumed: int = 0) -> None:
        """Stamp the per-request sub-mesh disclosure: results are
        byte-identical, capacity is not (the engine lifts it into the
        response's ``degraded.mesh``)."""
        dom = self.arenas.mesh_fault
        if dom is None:
            return
        info = dom.degraded_info()
        if resumed or info["chips_healthy"] < info["chips_total"]:
            info["resumed"] = resumed + (
                stats.get("mesh_degraded", {}).get("resumed", 0)
            )
            stats["mesh_degraded"] = info

    # -- entry points --------------------------------------------------------

    def expand(
        self, attr: str, reverse: bool, src: np.ndarray, cap: int, stats: dict
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One engine-level sharded expansion (the ``route: mesh`` leaf).
        Returns (out, seg_ptr) byte-identical to the single-device
        expand.  A chip-attributed fault re-shards and retries on the
        surviving sub-mesh (reads are idempotent); anything else raises
        ``devguard.DeviceFaultError`` so the caller re-plans unsharded."""
        from dgraph_tpu_torch.parallel.mesh import (
            _fcap_bucket,
            sharded_expand_segments,
        )
        from dgraph_tpu_torch.sched import segments

        dom = self.arenas.mesh_fault
        retries = self._retries()
        resumed = 0
        t0 = time.perf_counter()
        while True:
            sharded = self.arenas.sharded_csr(attr, reverse=reverse)
            mesh = self.mesh
            if dom is not None:
                dom.note_shape("expand", cap, _fcap_bucket(len(src)))

            def _dispatch(mesh=mesh, sharded=sharded):
                t = {}
                with obs.stage(t, "ms"):
                    out, seg_ptr = sharded_expand_segments(
                        mesh, sharded, src, cap
                    )
                return out, seg_ptr, t["ms"]

            try:
                out, seg_ptr, ms = self._run("mesh.expand", _dispatch)
                break
            except devguard.DeviceFaultError as e:
                if retries <= 0 or not self._chip_retryable(e):
                    raise
                retries -= 1
                resumed += 1
                segments.resume("mesh", "loss")
        stats["device_expand_ms"] = stats.get("device_expand_ms", 0.0) + ms
        self._charge(
            h2d=int(src.nbytes),
            d2h=int(out.nbytes + seg_ptr.nbytes),
            cap=cap,
            hops=1,
            wall_ms=(time.perf_counter() - t0) * 1e3,
        )
        self._note_degraded(stats, resumed)
        return out, seg_ptr

    def multi_hop(
        self,
        attr: str,
        reverse: bool,
        src: np.ndarray,
        n_hops: int,
        cap: int,
        stats: dict,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """The fused multi-hop chain over the mesh: the exchange of every
        hop stays on the devices (mesh/programs.py), one fetch per
        segment.  Returns (frontiers int32[n_hops, cap], totals
        int32[n_hops]) — per-level sorted-unique-padded frontiers equal
        to the unsharded multi-hop pass's value for value.

        Raises ``devguard.DeviceFaultError`` when a fault cannot be owned
        by one chip; the chain then declines the fused path and its
        levels re-plan per level."""
        from dgraph_tpu_torch.sched import segments

        n_hops = int(n_hops)
        # segmented dataflow: k hops a dispatch, the exchange untouched
        # inside a segment, the final frontier threaded on the device
        # between segments with a yield point at every seam
        seg_k = segments.plan(n_hops, cap, "mesh")
        t0 = time.perf_counter()
        resumed = [0]
        if 0 < seg_k < n_hops:
            fs, totals = self._run_segmented(
                attr, reverse, src, n_hops, cap, seg_k, stats, resumed
            )
        else:
            fs, totals = self._run_monolithic(
                attr, reverse, src, n_hops, cap, resumed
            )
        self._charge(
            h2d=cap * 4,
            d2h=int(fs.nbytes + totals.nbytes),
            cap=cap,
            hops=n_hops,
            wall_ms=(time.perf_counter() - t0) * 1e3,
        )
        self._note_degraded(stats, resumed[0])
        return fs, totals

    # -- dispatch strategies --------------------------------------------------

    def _segment(self, mesh, sharded, f, cap: int, hops: int):
        """One dispatched segment of ``hops`` hops from the carry ``f``
        (the device carry, or its host mirror): a closure for the guard
        returning the fetched (frontiers, totals) and the device carry of
        the next segment.  The engine's ``chain_ms`` bracket times it."""
        from dgraph_tpu_torch.mesh.programs import mesh_multi_hop_step
        from dgraph_tpu_torch.utils.failpoints import fail

        def _dispatch():
            # the chip-loss probe fires on the guard's worker, like the
            # one-hop path's
            fail.point("device.mesh")
            carry = f
            if not isinstance(carry, torch.Tensor):
                carry = torch.from_numpy(carry).to(mesh.root)
            sfs, stot, final = mesh_multi_hop_step(
                mesh, sharded, carry, cap, hops
            )
            # one fetch: every frontier of the segment, then its counts
            host = torch.cat([sfs.reshape(-1), stot]).cpu().numpy()
            return host[: hops * cap].reshape(hops, cap), host[hops * cap:], final

        return _dispatch

    def _run_monolithic(self, attr, reverse, src, n_hops, cap, resumed):
        from dgraph_tpu_torch.sched import segments

        dom = self.arenas.mesh_fault
        retries = self._retries()
        seed = ops.pad_to(np.asarray(src, dtype=np.int64), cap)
        while True:
            sharded = self.arenas.sharded_csr(attr, reverse=reverse)
            if dom is not None:
                dom.note_shape("hop", cap, n_hops)
            try:
                fs, totals, _final = self._run(
                    "mesh.multi_hop",
                    self._segment(self.mesh, sharded, seed, cap, n_hops),
                )
                return fs, totals
            except devguard.DeviceFaultError as e:
                if retries <= 0 or not self._chip_retryable(e):
                    raise
                # the sink already evicted the chip and re-sharded: the
                # loop re-fetches the arena at the new width and re-runs
                # the whole (idempotent) read on the surviving sub-mesh
                retries -= 1
                resumed[0] += 1
                segments.resume("mesh", "loss")

    def _run_segmented(
        self, attr, reverse, src, n_hops, cap, seg_k, stats, resumed
    ):
        from dgraph_tpu_torch.sched import segments

        dom = self.arenas.mesh_fault
        retries = self._retries()
        sharded = self.arenas.sharded_csr(attr, reverse=reverse)
        mesh = self.mesh
        fence = dom.fence() if dom is not None else None
        # the host mirror of the device carry: the padded seed before the
        # first segment, then each fetched segment's last frontier row —
        # a drain never fetches the device carry itself
        f_host = ops.pad_to(np.asarray(src, dtype=np.int64), cap)
        f = f_host
        fs_parts, tot_parts = [], []
        done = 0
        while done < n_hops:
            if done:
                segments.seam("mesh")
                if dom is not None and dom.fence() != fence:
                    # the epoch flipped between segments: drain (the
                    # carry already lives in f_host) and resume under the
                    # new sub-mesh's plan
                    sharded, fence, mesh = self._replan(attr, reverse, dom)
                    f = f_host
                    resumed[0] += 1
                    segments.resume("mesh", "epoch")
            hops = min(seg_k, n_hops - done)
            if dom is not None:
                dom.note_shape("hop", cap, hops)
            try:
                sfs, stot, f = self._run(
                    "mesh.multi_hop",
                    self._segment(mesh, sharded, f, cap, hops),
                )
            except devguard.DeviceFaultError as e:
                if dom is not None and isinstance(
                    e, (devguard.DeviceHangError, devguard.DeviceSickError)
                ):
                    # a wedged dispatch, or the plane latched sick
                    # mid-query: no chip to blame — finish the remaining
                    # hops on the card's unsharded multi-hop pass from
                    # the host carry, and disclose the failover
                    sfs, stot = self._finish_unsharded(
                        attr, reverse, f_host, n_hops - done, cap
                    )
                    fs_parts.append(sfs)
                    tot_parts.append(stot)
                    resumed[0] += 1
                    segments.resume("mesh", "hang")
                    devguard.count_failover("unsharded", stats, "mesh")
                    break
                if retries <= 0 or not self._chip_retryable(e):
                    raise
                retries -= 1
                sharded, fence, mesh = self._replan(attr, reverse, dom)
                f = f_host
                resumed[0] += 1
                segments.resume("mesh", "loss")
                continue  # retry THIS segment on the surviving sub-mesh
            fs_parts.append(sfs)
            tot_parts.append(stot)
            done += hops
            f_host = np.asarray(sfs[-1])
            if done < n_hops and sfs[-1][0] == ops.SENT:
                # a drained frontier: the remaining hops are all-SENT
                # rows and zero counts on every chip — synthesize them
                segments.early_exit("mesh")
                r = n_hops - done
                fs_parts.append(np.full((r, cap), ops.SENT, sfs.dtype))
                tot_parts.append(np.zeros((r,), stot.dtype))
                break
        return np.concatenate(fs_parts), np.concatenate(tot_parts)

    def _replan(self, attr, reverse, dom):
        """Drain-and-resume bookkeeping: re-fetch the sharded arena under
        the new epoch's plan (a new width makes sharded_csr rebuild: the
        survivors' re-seed); the caller rebuilds the device carry from
        its host mirror."""
        dom.note_drain(1)
        try:
            sharded = self.arenas.sharded_csr(attr, reverse=reverse)
            fence = dom.fence()
        finally:
            dom.note_drain(-1)
        return sharded, fence, fence[1]

    def _finish_unsharded(self, attr, reverse, f_host, hops, cap):
        """Complete a drained query's remaining hops on the card's
        unsharded multi-hop pass (``ops.multi_hop``, the pass the mesh
        program is held value-for-value against), fed the same
        sorted-unique-padded carry, so the stitched result equals an
        all-mesh run."""
        a = self.arenas.reverse(attr) if reverse else self.arenas.data(attr)
        a.ensure_device()
        dev = a.offsets.device
        f = torch.from_numpy(np.asarray(f_host, dtype=np.int32)).to(dev)
        vis = torch.full((cap,), ops.SENT, dtype=torch.int32, device=dev)
        fs, totals, _vis = ops.multi_hop(
            a.offsets, a.dst, f, vis, hops, cap, lut=a.lut()
        )
        # ops.multi_hop's guarded dispatch already waited for these buffers
        # (ops/batch.py); the one fetch copies ready data, as the
        # reference's np.asarray does
        # graftlint: ignore[naked-device-sync]
        host = torch.cat([fs.reshape(-1), totals]).cpu().numpy()
        return host[: hops * cap].reshape(hops, cap), host[hops * cap:]

    # -- attribution ---------------------------------------------------------

    def _charge(
        self, h2d: int, d2h: int, cap: int, hops: int, wall_ms: float
    ) -> None:
        led = _ledger.current()
        if led is None:
            return
        from dgraph_tpu_torch.mesh.programs import exchange_bytes_per_hop

        led.bytes_h2d += h2d
        led.bytes_d2h += d2h
        led.exchange_bytes += exchange_bytes_per_hop(self.mesh, cap) * hops
        led.mesh_ms += wall_ms
        led.mesh_chips = max(led.mesh_chips, self.width)
