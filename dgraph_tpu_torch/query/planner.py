"""Measured-cost planner: one calibrated model for every route (port of
``dgraph_tpu/query/planner.py``).

Every route decision of the engine prices its candidates from measured
per-route rates and picks the cheaper one:

- ``expand_route``: one level's expansion as numpy over the host mirror,
  or one device dispatch (the resident gather kernel, route
  ``resident``, or the staged ``expand_csr``, route ``device``);
- ``mesh_route``: a shard-eligible level's expansion over the mesh
  (route ``mesh``: priced and recorded; eligibility is the arena
  manager's);
- ``merge_gate``: whether a cohort hop-merge admits an expansion (the
  expand decision on the estimated fan-out);
- ``chain_route``: a uid chain fused into one device pass, or run level
  by level (``query/chain.py``); ``mxu_fanout_ok`` is the tile tier's
  admission by the same model;
- ``kway_route``: a k-way intersection as the host fold or one call of
  the intersect kernel (``query/joinplan.py``);
- ``segment_route``: how many hops one segment of a fused hop loop
  covers (``sched/segments.py``);
- ``repair_route``: a mutation's edge delta repairs a cached view in
  place, or the view is dropped and rebuilt on demand.

Rates come from ``utils/calibrate.py``: the priors, a persisted file, or
a measurement on the card (``boot(measure_now=True)``), then refined
online: ``note_outcome`` folds each decision's measured latency into an
EWMA of the chosen route's per-unit rate, and flags a mispredict when
the chosen route cost more than the rejected one was priced at.  Each
decision is recorded with both estimates in the request's
``stats["planner"]``, a process ring behind ``/debug/planner`` and
``dgraph_planner_decisions_total{kind,route}``.  ``CohortController``
moves the scheduler's cohort size and flush deadline with measured
occupancy and queue wait, inside hard bounds.

Override discipline: ``DGRAPH_TPU_PLANNER=0`` restores every static
compare, and any pinned knob (an env value, or a runtime assignment such
as ``engine.expand_device_min = 1``) keeps the static compare for its
gate: calibration never overrules an operator.

Where the port differs from the reference:

- ``_device_factor`` is the constant 1.0.  The reference multiplies
  device costs by its device guard's price-out factor while a device is
  sick; the port has no host failover, and a device fault raises.
- ``boot`` takes the backend from the server's torch device (``cuda``
  or ``cpu``), not from a JAX backend.
- ``mesh_route`` prices the mesh without the guard's price-out factor
  (the port has no ``cost_factor``); its rate ``mesh_edge_us`` is
  measured by ``DGRAPH_TPU_CALIBRATE=1`` on a virtual-width mesh of the
  card.
- ``kway_route`` also takes the caller's runtime gate
  (``configured_min``): an arena's ``kway_device_min`` assigned away from
  its default pins the static compare, as ``expand_device_min`` does.

``_LOCK`` and each controller's lock are leaves: nothing outside this
module is called while either is held.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional, Tuple

from dgraph_tpu_torch.utils import planconfig
from dgraph_tpu_torch.utils.calibrate import (
    PRIORS,
    Calibration,
    load,
    measure,
    save,
)
from dgraph_tpu_torch.utils.metrics import (
    PLANNER_CALIBRATIONS,
    PLANNER_DECISIONS,
    PLANNER_MISPREDICTS,
)

# decision units below which a measured latency is dispatch-dominated
# noise: no rate refinement, no mispredict verdict
_MIN_UNITS_FOR_RATE = 512
_EWMA_ALPHA = 0.2
# mispredict margins: wrong side needs 1.5× past the rejected estimate,
# an own-estimate blowout 8×
_MISPREDICT_OTHER_MARGIN = 1.5
_MISPREDICT_SELF_MARGIN = 8.0
# observations past this multiple of the route's own estimate are cold
# builds or host outliers, not routing evidence
_OUTLIER_FACTOR = 100.0


def _device_factor() -> float:
    """The device's price multiplier: 1.0 always (no host failover in
    the port; the reference raises it while its device guard is
    latched sick)."""
    return 1.0


_LOCK = threading.Lock()
_RECENT: "deque[dict]" = deque(maxlen=64)
_COUNTS: dict = {}
_MISPREDICTS: dict = {}
# the (kind, route) pairs that have closed a served decision in this
# process (note_served_outcome)
_WARMED: set = set()
_CAL: Calibration = PRIORS
_RATES: dict = PRIORS.rates()  # live copy the EWMA refines


def enabled() -> bool:
    return planconfig.planner_enabled()


# -- calibration lifecycle ---------------------------------------------------


def boot(measure_now: bool = False, device=None) -> Calibration:
    """Install the best available calibration for ``device`` (a torch
    device or its name; None = no known backend, keep the rates).

    ``measure_now=False`` (every server construction): load a valid
    persisted file of the same backend, else keep the current rates
    (priors on a cold process).  ``measure_now=True``
    (``DGRAPH_TPU_CALIBRATE=1``): re-measure on ``device`` and persist,
    replacing any file.  A measurement that fails raises."""
    global _CAL
    path = planconfig.calibration_file()
    backend = None
    if device is not None:
        import torch

        backend = torch.device(device).type
    cal = None
    if measure_now and backend is not None:
        cal = measure(device=device)
        PLANNER_CALIBRATIONS.add()
        if path:
            try:
                save(cal, path)
            except OSError:
                pass  # read-only disk: serve from the in-memory rates
    if cal is None and path and backend:
        # a file of another backend is never loaded, and with no known
        # backend no file is trusted
        cal = load(path, backend=backend)
    if cal is not None:
        with _LOCK:
            _CAL = cal
            _RATES.update(cal.rates())
    return _CAL


def install_calibration(cal: Calibration) -> None:
    """Adopt an explicit calibration (tests, operator tooling)."""
    global _CAL
    with _LOCK:
        _CAL = cal
        _RATES.update(cal.rates())


def rates() -> dict:
    """Snapshot of the live (online-refined) rate table, µs units."""
    with _LOCK:
        return dict(_RATES)


def calibration_info() -> dict:
    with _LOCK:
        return {
            "source": _CAL.source,
            "backend": _CAL.backend,
            "measured_at": _CAL.measured_at,
            "rates": dict(_RATES),
        }


# -- decision recording ------------------------------------------------------


def record(stats: Optional[dict], dec: dict) -> None:
    """Log one routing decision where it must be visible: the bounded
    per-request stats list, the process ring behind /debug/planner and
    the counter."""
    PLANNER_DECISIONS.add((dec["kind"], dec["route"]))
    with _LOCK:
        _RECENT.append(dec)
        k = (dec["kind"], dec["route"])
        _COUNTS[k] = _COUNTS.get(k, 0) + 1
    if stats is not None:
        lst = stats.setdefault("planner", [])
        if len(lst) < 8:
            lst.append(dec)


def note_outcome(dec: Optional[dict], actual_us: float) -> None:
    """Post-hoc check of one recorded decision: refine the chosen
    route's rate EWMA from the measured latency and flag a mispredict
    when the model picked the wrong side."""
    if dec is None or actual_us <= 0.0:
        return
    units = int(dec.get("units", 0))
    est_self = float(dec.get("est_chosen_us", 0.0))
    est_other = float(dec.get("est_other_us", 0.0))
    # a first-time kernel build dwarfs any honest estimate: recorded for
    # the ring, but neither a rate sample nor a mispredict
    outlier = est_self > 0 and actual_us > est_self * _OUTLIER_FACTOR
    wrong_side = est_other > 0 and actual_us > est_other * _MISPREDICT_OTHER_MARGIN
    blowout = est_self > 0 and actual_us > est_self * _MISPREDICT_SELF_MARGIN
    mispredict = (
        not outlier
        and units >= _MIN_UNITS_FOR_RATE
        and (wrong_side or blowout)
    )
    # dec is already in the ring: mutate it only under the lock (the
    # debug summary copies entries under the same lock)
    with _LOCK:
        dec["actual_us"] = round(float(actual_us), 1)
        if outlier:
            dec["outlier"] = True
        if mispredict:
            dec["mispredict"] = True
            _MISPREDICTS[dec["kind"]] = _MISPREDICTS.get(dec["kind"], 0) + 1
    if mispredict:
        PLANNER_MISPREDICTS.add(dec["kind"])
    if not outlier:
        _refine(dec["kind"], dec["route"], units, actual_us)


def note_served_outcome(dec: Optional[dict], actual_us: float) -> None:
    """``note_outcome`` for a decision a served hop or k-way call closed.
    The port's one addition: the first outcome of each (kind, route) in
    the process is an outlier (recorded for the ring, neither a rate
    sample nor a mispredict).  It carries the card's one-off costs of a
    route's first dispatch, which land below the outlier bar yet, at
    α 0.2, raise the route's rate enough that the next large hop is
    priced onto the host."""
    if dec is not None and actual_us > 0.0:
        key = (dec["kind"], dec["route"])
        with _LOCK:
            first = key not in _WARMED
            _WARMED.add(key)
            if first:
                dec["actual_us"] = round(float(actual_us), 1)
                dec["outlier"] = True
        if first:
            return
    note_outcome(dec, actual_us)


# chain and tile timings are composite (planning + packing + the kernel)
# and refine nothing: only the leaf routes teach the model their rates
_RATE_KEY = {
    ("expand", "host"): ("host_edge_us", 0.0),
    ("expand", "device"): ("device_edge_us", 1.0),   # minus one dispatch
    ("expand", "resident"): ("resident_edge_us", 1.0),
    ("expand", "mesh"): ("mesh_edge_us", 1.0),
    ("kway", "host"): ("host_intersect_us", 0.0),
    ("kway", "device"): ("device_intersect_us", 1.0),
}


def _refine(kind: str, route: str, units: int, actual_us: float) -> None:
    """EWMA-refine the per-unit rate of the route that ran.  Observed
    rates clamp to prior/64 .. prior×64, so one pause cannot poison the
    model."""
    key = _RATE_KEY.get((kind, route))
    if key is None or units < _MIN_UNITS_FOR_RATE:
        return
    field, dispatches = key
    with _LOCK:
        work_us = actual_us - dispatches * _RATES["dispatch_us"]
        if work_us <= 0:
            return
        obs = work_us / units
        prior = getattr(PRIORS, field)
        obs = min(max(obs, prior / 64.0), prior * 64.0)
        _RATES[field] = (1 - _EWMA_ALPHA) * _RATES[field] + _EWMA_ALPHA * obs


# -- route decisions ---------------------------------------------------------


def chain_route(
    engine, est_total: int, n_levels: int
) -> Tuple[bool, Optional[dict]]:
    """Fuse this chain into one device pass, or run it per level?

    Static path (planner off, env-pinned threshold, or a runtime
    ``engine.chain_threshold`` assignment): ``est_total >= threshold``,
    decision None.  Planner path: price the whole chain both ways —
      per-level = min(host numpy, per-level dispatches + the host
                      conversion each level pays)
      chain     = one dispatch + capacity planning + device edge rate
    and fuse when the chain is cheaper."""
    if (
        not enabled()
        or planconfig.overridden("DGRAPH_TPU_CHAIN_THRESHOLD")
        or engine.chain_threshold != planconfig.CHAIN_THRESHOLD_DEFAULT
    ):
        return est_total >= engine.chain_threshold, None
    r = rates()
    df = _device_factor()
    host_c = n_levels * r["host_setup_us"] + est_total * r["host_edge_us"]
    dev_c = df * (
        n_levels * r["dispatch_us"]
        + est_total * (r["device_edge_us"] + r["host_touch_us"])
    )
    per_level = min(host_c, dev_c)
    chain_c = df * (
        r["dispatch_us"] + r["chain_plan_us"] + est_total * r["device_edge_us"]
    )
    fuse = chain_c < per_level
    dec = {
        "kind": "chain",
        "route": "chain" if fuse else "perlevel",
        "units": int(est_total),
        "levels": int(n_levels),
        "est_chosen_us": round(chain_c if fuse else per_level, 1),
        "est_other_us": round(per_level if fuse else chain_c, 1),
        "reason": (
            "calibrated break-even favors one fused program"
            if fuse
            else "calibrated break-even favors per-level execution"
        ),
    }
    return fuse, dec


def expand_route(
    total: int, configured_min: int, resident: bool = False
) -> Tuple[bool, Optional[dict]]:
    """Host numpy or one device dispatch for a single level's expansion
    of ``total`` edges?  Returns (use_device, decision).  Static compare
    when the planner is off or the knob is pinned (env or runtime
    assignment).

    ``resident=True``: the engine's device dispatch for this arena is
    the resident gather kernel, priced at ``resident_edge_us`` with no
    h2d staging term; the decision's route is ``resident`` so
    ``note_outcome`` refines that rate, never the staged one."""
    if (
        not enabled()
        or planconfig.overridden("DGRAPH_TPU_EXPAND_DEVICE_MIN")
        or configured_min != planconfig.EXPAND_DEVICE_MIN_DEFAULT
    ):
        return total >= configured_min, None
    r = rates()
    host_c = r["host_setup_us"] + total * r["host_edge_us"]
    edge = r["resident_edge_us"] if resident else r["device_edge_us"]
    dev_c = _device_factor() * (r["dispatch_us"] + total * edge)
    use_device = dev_c < host_c
    dev_route = "resident" if resident else "device"
    dec = {
        "kind": "expand",
        "route": dev_route if use_device else "host",
        "units": int(total),
        "est_chosen_us": round(dev_c if use_device else host_c, 1),
        "est_other_us": round(host_c if use_device else dev_c, 1),
        "reason": (
            "calibrated host/resident break-even (zero staging term)"
            if resident
            else "calibrated host/device break-even"
        ),
    }
    return use_device, dec


def mesh_route(total: int, width: int) -> Tuple[bool, Optional[dict]]:
    """Price one shard-eligible level's expansion over the mesh (the
    ``route: mesh`` leaf, mesh/executor.py).

    Eligibility is the operator's verdict (``ArenaManager.use_mesh_for``:
    a mesh, the shard threshold and, on distinct cards, the crossover
    model) and the planner does not overrule it, which keeps
    ``DGRAPH_TPU_MESH=0`` a pure availability switch.  What the planner adds is the price: the
    recorded decision carries the mesh estimate against the best
    unsharded route, ``note_outcome`` refines ``mesh_edge_us`` from the
    measured dispatch, and the mispredict counters show arenas where
    sharding costs more than it saves.

    Returns (True, dec); dec is None when the planner is off."""
    if not enabled():
        return True, None
    r = rates()
    host_c = r["host_setup_us"] + total * r["host_edge_us"]
    dev_c = _device_factor() * (r["dispatch_us"] + total * r["device_edge_us"])
    mesh_c = r["dispatch_us"] + total * r["mesh_edge_us"]
    dec = {
        "kind": "expand",
        "route": "mesh",
        "units": int(total),
        "width": int(width),
        "est_chosen_us": round(mesh_c, 1),
        "est_other_us": round(min(host_c, dev_c), 1),
        "reason": "shard-eligible arena priced over the mesh",
    }
    return True, dec


def merge_gate(est_edges: float, configured_min: int) -> bool:
    """Should a cohort hop-merge rendezvous admit this expansion?
    Merging only amortizes when the union expansion device-routes, so
    the gate IS the expand decision on the estimated fan-out (nothing
    recorded: the real expansion downstream records itself)."""
    if (
        not enabled()
        or planconfig.overridden("DGRAPH_TPU_EXPAND_DEVICE_MIN")
        or configured_min != planconfig.EXPAND_DEVICE_MIN_DEFAULT
    ):
        return est_edges >= configured_min
    r = rates()
    return (
        _device_factor() * (r["dispatch_us"] + est_edges * r["device_edge_us"])
        < r["host_setup_us"] + est_edges * r["host_edge_us"]
    )


def kway_route(
    total: int, k: int, configured_min: Optional[int] = None
) -> Tuple[Optional[bool], Optional[dict]]:
    """Host ``np.intersect1d`` fold or one intersect kernel call for a
    k-way intersection?  Returns (use_device, decision); (None, None)
    means the static gate (the caller compares against its configured
    min): the planner is off, the env knob is pinned, or
    ``configured_min`` was assigned away from the default."""
    if (
        not enabled()
        or planconfig.overridden("DGRAPH_TPU_KWAY_DEVICE_MIN")
        or (
            configured_min is not None
            and configured_min != planconfig.KWAY_DEVICE_MIN_DEFAULT
        )
    ):
        return None, None
    r = rates()
    host_c = k * r["host_setup_us"] + total * r["host_intersect_us"]
    dev_c = _device_factor() * (
        r["dispatch_us"] + total * r["device_intersect_us"]
    )
    use_device = dev_c < host_c
    dec = {
        "kind": "kway",
        "route": "device" if use_device else "host",
        "units": int(total),
        "k": int(k),
        "est_chosen_us": round(dev_c if use_device else host_c, 1),
        "est_other_us": round(host_c if use_device else dev_c, 1),
        "reason": "calibrated fold/device break-even",
    }
    return use_device, dec


def repair_route(
    n_delta: int, avg_entry_edges: float
) -> Tuple[bool, Optional[dict]]:
    """IVM delta repair: apply a mutation's edge delta to a cached view
    in place, or drop it and let the next read rebuild?  Returns
    (repair, decision).

    Modes (DGRAPH_TPU_IVM_REPAIR): '0' never, 'force' within the cap,
    '1' the cost compare below.  Static path (planner off or cap
    pinned): repair iff the delta fits the cap.

    Repair is paid once, now: one pass over the entry plus the delta
    (``(E + D) × host_edge``).  Dropping defers to refills, priced at two
    re-expansions of the entry (a cached entry is read more than once),
    each at the cheaper of the host and device routes.  Small deltas
    against warm entries repair; a delta rivaling the entry rebuilds."""
    mode = planconfig.ivm_repair_mode()
    if mode == "0":
        return False, None
    cap = planconfig.ivm_repair_max_delta()
    if mode == "force":
        return n_delta <= cap, None
    if n_delta > cap:
        return False, None
    if not enabled() or planconfig.overridden(
        "DGRAPH_TPU_IVM_REPAIR_MAX_DELTA"
    ):
        return True, None  # static gate: the cap is the decision
    r = rates()
    e = max(float(avg_entry_edges), 1.0)
    repair_us = r["host_setup_us"] + (e + n_delta) * r["host_edge_us"]
    refill_us = 2.0 * min(
        r["host_setup_us"] + e * r["host_edge_us"],
        r["dispatch_us"] + e * r["device_edge_us"],
    )
    repair = repair_us < refill_us
    dec = {
        "kind": "repair",
        "route": "repair" if repair else "rebuild",
        "units": int(n_delta),
        "entry_edges": int(e),
        "est_chosen_us": round(repair_us if repair else refill_us, 1),
        "est_other_us": round(refill_us if repair else repair_us, 1),
        "reason": (
            "delta repair cheaper than the expected refills"
            if repair
            else "delta rivals the entry: drop and rebuild on demand"
        ),
    }
    return repair, dec


def segment_route(
    n_steps: int, est_step_units: int, driver: str
) -> Tuple[int, Optional[dict]]:
    """How many steps (hop levels, mask-chain levels) one dispatched
    segment of a fused loop covers.  Returns (k, decision); k == 0 means
    one segment, no seam.

    Modes (DGRAPH_TPU_SEGMENT): '0' never segments, 'force' every
    DGRAPH_TPU_SEGMENT_K steps, 'auto' prices it (a pinned
    DGRAPH_TPU_SEGMENT_K then only decides whether, never re-sizes k).

    Segments bound the wait of a yield (cancellation, preemption, an
    early exit) at ``ceil(n/k) - 1`` extra dispatches; k is the smallest
    segment whose work dwarfs one dispatch by 10×, clamped to
    [1, n_steps].  When even that leaves one segment, the route stays
    monolithic."""
    mode = planconfig.segment_mode()
    if mode == "0" or n_steps <= 1:
        return 0, None
    if mode == "force":
        return max(1, min(planconfig.segment_k(), n_steps)), None
    if not enabled():
        return 0, None
    r = rates()
    step_us = max(float(est_step_units), 1.0) * r["device_edge_us"]
    if planconfig.overridden("DGRAPH_TPU_SEGMENT_K"):
        k = max(1, min(planconfig.segment_k(), n_steps))
    else:
        k = int(-(-10.0 * r["dispatch_us"] // step_us))
        k = max(1, min(k, n_steps))
    n_segs = -(-n_steps // k)
    seg_c = n_segs * r["dispatch_us"] + n_steps * step_us
    mono_c = r["dispatch_us"] + n_steps * step_us
    if k >= n_steps:
        dec = {
            "kind": "segment",
            "route": "monolithic",
            "units": int(n_steps),
            "driver": driver,
            "k": 0,
            "est_chosen_us": round(mono_c, 1),
            "est_other_us": round(seg_c, 1),
            "reason": "program too small to amortize a second dispatch",
        }
        return 0, dec
    dec = {
        "kind": "segment",
        "route": "segmented",
        "units": int(n_steps),
        "driver": driver,
        "k": int(k),
        "est_chosen_us": round(seg_c, 1),
        "est_other_us": round(mono_c, 1),
        "reason": "bounded yield latency within 10% dispatch overhead",
    }
    return k, dec


def mxu_fanout_ok(engine, est_total: int, n_levels: int) -> bool:
    """The tile tier's fan-out admission: is this chain big enough to
    leave the host at all?  chain_route's model and override discipline,
    without recording (joinplan records its own decision)."""
    ok, _dec = chain_route(engine, est_total, n_levels)
    return ok


# -- scheduler feedback ------------------------------------------------------


class CohortController:
    """Load-adaptive cohort admission: max_batch and the flush deadline
    move with measured queue wait and cohort occupancy, inside hard
    bounds, instead of sitting at the static ``DGRAPH_TPU_SCHED`` knobs.

    Deterministic given the observation sequence, and bounded:

      max_batch ∈ [base, min(8×base×width, 1024)]
      flush deadline ∈ [base/8, base]

    Rules per update (EWMA α=0.25 on occupancy and queue wait):
    - occupancy ≥ 3/4 of the current cap → the cap doubles;
    - occupancy under 1/4 of the base → the cap halves toward base;
    - queue wait past 4× the deadline → the deadline halves;
    - queue wait under 1/4 of the deadline → it relaxes toward base.

    The ceiling scales with the serving mesh's width (``mesh_width`` in
    ``state()``): N chips drain one merged cohort frontier, so sustained
    load may batch N× harder before the 1024 clamp; the base, the floor
    and the idle behaviour stay put.
    """

    def __init__(self, base_batch: int, base_flush_s: float, width: int = 1):
        self.base_batch = max(1, int(base_batch))
        self.width = max(1, int(width))
        self._clamp_cap = 1024
        self.hi_batch = min(self.base_batch * 8 * self.width, self._clamp_cap)
        self.base_flush_s = float(base_flush_s)
        self.lo_flush_s = self.base_flush_s / 8.0
        self.max_batch = self.base_batch
        self.flush_s = self.base_flush_s
        self._occ = 0.0
        self._wait = 0.0
        self._service = 0.0
        self._updates = 0
        self._lock = threading.Lock()

    def set_width(self, width: int) -> None:
        """Re-target the batching ceiling at a new mesh width: the
        elastic fault domain (mesh/fault.py) shrinks and widens the
        serving sub-mesh at run time, and the scheduler re-samples it per
        flush.  A shrink clamps the live cap at once; growth lets the
        occupancy rule climb back on its own evidence."""
        width = max(1, int(width))
        with self._lock:
            if width == self.width:
                return
            self.width = width
            self.hi_batch = min(self.base_batch * 8 * width, self._clamp_cap)
            if self.max_batch > self.hi_batch:
                self.max_batch = self.hi_batch

    def update(
        self, occupancy: int, queue_wait_s: float, service_s: float = 0.0
    ) -> Tuple[int, float]:
        """Fold one flush's measurements in; returns the (possibly
        adjusted) (max_batch, flush_deadline_s)."""
        a = 0.25
        with self._lock:
            self._occ = (1 - a) * self._occ + a * float(occupancy)
            self._wait = (1 - a) * self._wait + a * float(queue_wait_s)
            self._service = (1 - a) * self._service + a * float(service_s)
            self._updates += 1
            if self._occ >= 0.75 * self.max_batch and self.max_batch < self.hi_batch:
                self.max_batch = min(self.max_batch * 2, self.hi_batch)
            elif self._occ <= 0.25 * self.base_batch and self.max_batch > self.base_batch:
                self.max_batch = max(self.max_batch // 2, self.base_batch)
            if self._wait > 4.0 * self.flush_s and self.flush_s > self.lo_flush_s:
                self.flush_s = max(self.flush_s * 0.5, self.lo_flush_s)
            elif self._wait < 0.25 * self.flush_s and self.flush_s < self.base_flush_s:
                self.flush_s = min(self.flush_s * 1.5, self.base_flush_s)
            return self.max_batch, self.flush_s

    def state(self) -> dict:
        with self._lock:
            return {
                "max_batch": self.max_batch,
                "flush_ms": round(self.flush_s * 1e3, 3),
                "base_batch": self.base_batch,
                "base_flush_ms": round(self.base_flush_s * 1e3, 3),
                "mesh_width": self.width,
                "hi_batch": self.hi_batch,
                "occupancy_ewma": round(self._occ, 2),
                "queue_wait_ms_ewma": round(self._wait * 1e3, 3),
                "service_ms_ewma": round(self._service * 1e3, 3),
                "updates": self._updates,
            }


# -- debug surface -----------------------------------------------------------


def debug_summary(scheduler=None) -> dict:
    """The /debug/planner view: calibration provenance, live rates,
    per-(kind, route) decision counts, mispredicts, the recent ring, the
    join tier's own ring, and the scheduler's adaptive state when one is
    given."""
    from dgraph_tpu_torch.query import joinplan

    with _LOCK:
        counts = {f"{k}:{r}": v for (k, r), v in sorted(_COUNTS.items())}
        mis = dict(_MISPREDICTS)
        # per-entry copies: note_outcome mutates ring entries under
        # this lock
        recent = [dict(d) for d in _RECENT]
    out = {
        "enabled": enabled(),
        "calibration": calibration_info(),
        "counts": counts,
        "mispredicts": mis,
        "mispredict_total": sum(mis.values()),
        "recent": recent,
        "join": joinplan.debug_summary(),
    }
    if scheduler is not None:
        ctl = getattr(scheduler, "_adaptive", None)
        out["sched"] = ctl.state() if ctl is not None else {
            "adaptive": False,
            "max_batch": scheduler.max_batch,
            "flush_ms": round(scheduler.flush_s * 1e3, 3),
        }
    return out


def mispredict_stats() -> dict:
    """Decisions, mispredicts and their rate."""
    with _LOCK:
        total = sum(_COUNTS.values())
        mis = sum(_MISPREDICTS.values())
    return {
        "decisions": total,
        "mispredicts": mis,
        "mispredict_rate": round(mis / total, 4) if total else 0.0,
    }


def _reset_for_tests() -> None:
    global _CAL
    with _LOCK:
        _RECENT.clear()
        _COUNTS.clear()
        _MISPREDICTS.clear()
        _WARMED.clear()
        _CAL = PRIORS
        _RATES.clear()
        _RATES.update(PRIORS.rates())
