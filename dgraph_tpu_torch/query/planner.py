"""Route planning for the port (the static half of
``dgraph_tpu/query/planner.py``).

The reference prices every route from calibrated per-kernel rates and
falls back to static threshold compares when its planner is off or a
knob is pinned.  The port has no calibration on the card yet, so it
keeps only that static compare: an expansion whose exact fan-out
reaches ``expand_device_min`` (default ``EXPAND_DEVICE_MIN_DEFAULT``,
262144) runs on the device, a smaller one as numpy over the host mirror.
"""

from __future__ import annotations


def expand_route(total: int, configured_min: int) -> bool:
    """Host numpy (False) or one device dispatch (True) for a single
    level's expansion of ``total`` edges."""
    return total >= configured_min
