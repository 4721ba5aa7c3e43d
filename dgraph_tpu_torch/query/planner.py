"""Route planning for the port (the static half of
``dgraph_tpu/query/planner.py``).

The reference prices every route from calibrated per-kernel rates and
falls back to static threshold compares when its planner is off or a
knob is pinned.  The port has no calibration on the card yet, so it
keeps only those static compares:

- an expansion whose exact fan-out reaches ``expand_device_min``
  (default ``EXPAND_DEVICE_MIN_DEFAULT``, 262144) runs on the device, a
  smaller one as numpy over the host mirror;
- a uid chain whose estimated fan-out over all its levels reaches
  ``chain_threshold`` (default ``CHAIN_THRESHOLD_DEFAULT``, 262144)
  fuses (``query/chain.py``), a smaller one runs level by level;
- a cohort hop-merge admits an expansion whose estimated fan-out
  reaches ``expand_device_min`` (``merge_gate``);
- a fused hop loop yields at a segment seam every
  ``DGRAPH_TPU_SEGMENT_K`` hops under ``DGRAPH_TPU_SEGMENT=force``,
  never otherwise (``segment_route``);
- the tile join tier admits a chain by the chain's own compare
  (``mxu_fanout_ok``);
- a mutation's edge delta repairs a derived view in place when it is
  within ``DGRAPH_TPU_IVM_REPAIR_MAX_DELTA`` (``repair_route``).
"""

from __future__ import annotations

from dgraph_tpu_torch.utils import planconfig


def expand_route(total: int, configured_min: int) -> bool:
    """Host numpy (False) or one device dispatch (True) for a single
    level's expansion of ``total`` edges."""
    return total >= configured_min


def chain_route(est_total: int, threshold: int) -> bool:
    """Fuse a chain whose levels are estimated at ``est_total`` edges in
    all (True), or run it level by level (False)."""
    return est_total >= threshold


def merge_gate(est_edges: float, configured_min: int) -> bool:
    """Should a cohort hop-merge rendezvous admit this expansion?
    Merging only amortizes when the union expansion device-routes, so
    the gate IS the expand decision on the estimated fan-out."""
    return est_edges >= configured_min


def segment_route(n_steps: int, est_step_units: int, loop: str) -> int:
    """How many hops one segment of a fused hop loop covers: k > 0 puts
    a seam every k hops, 0 none.  DGRAPH_TPU_SEGMENT '0' never, 'force'
    every DGRAPH_TPU_SEGMENT_K hops, 'auto' never (the reference prices
    k from calibrated rates there; with its planner off it is 0 too)."""
    if planconfig.segment_mode() != "force" or n_steps <= 1:
        return 0
    return max(1, min(planconfig.segment_k(), n_steps))


def mxu_fanout_ok(engine, est_total: int, n_levels: int) -> bool:
    """The tile join tier's fan-out admission: is this chain big enough
    to leave the host at all?  The chain tier's compare."""
    return chain_route(est_total, engine.chain_threshold)


def repair_route(n_delta: int, avg_entry_edges: float) -> bool:
    """Repair a cached derived view in place with an edge delta of
    ``n_delta`` (True), or drop it and let the next read rebuild?
    DGRAPH_TPU_IVM_REPAIR '0' never; '1' and 'force' within
    DGRAPH_TPU_IVM_REPAIR_MAX_DELTA (the reference prices '1' against
    the expected refills when its planner is armed; ``avg_entry_edges``
    is that price's input, unused here)."""
    if planconfig.ivm_repair_mode() == "0":
        return False
    return n_delta <= planconfig.ivm_repair_max_delta()
