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
  fuses (``query/chain.py``), a smaller one runs level by level.
"""

from __future__ import annotations


def expand_route(total: int, configured_min: int) -> bool:
    """Host numpy (False) or one device dispatch (True) for a single
    level's expansion of ``total`` edges."""
    return total >= configured_min


def chain_route(est_total: int, threshold: int) -> bool:
    """Fuse a chain whose levels are estimated at ``est_total`` edges in
    all (True), or run it level by level (False)."""
    return est_total >= threshold
