"""Route knobs of the port's engine (copy of the subset of
``dgraph_tpu/utils/planconfig.py`` it reads; same environment names, so
one setting steers both engines).

Env knob                      Default  Meaning
DGRAPH_TPU_EXPAND_DEVICE_MIN  262144   min per-level fan-out before an
                                       expansion leaves host numpy for a
                                       device dispatch
DGRAPH_TPU_RESIDENT           1        resident-CSR gather tier: '0' never,
                                       '1' on a CUDA device, 'force' on any
                                       device (the CPU runs the kernel's
                                       plain version; the parity tests)
DGRAPH_TPU_KWAY_DEVICE_MIN    262144   min total elements of a k-way
                                       intersection before the host fold
                                       yields to the intersect kernel
DGRAPH_TPU_CHAIN_THRESHOLD    262144   min estimated fan-out of a uid chain
                                       before it fuses (query/chain.py)
DGRAPH_TPU_SEGMENT            auto     segment seams in the fused hop loops
                                       (sched/segments.py): '0' never,
                                       'force' every DGRAPH_TPU_SEGMENT_K
                                       hops, 'auto' never (the reference
                                       prices it with its calibrated
                                       planner, which the port lacks)
DGRAPH_TPU_SEGMENT_K          4        hops per segment under 'force'
"""

from __future__ import annotations

import os

EXPAND_DEVICE_MIN_DEFAULT = 262144
KWAY_DEVICE_MIN_DEFAULT = 262144
CHAIN_THRESHOLD_DEFAULT = 262144
SEGMENT_K_DEFAULT = 4


def _int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return int(raw)


def expand_device_min() -> int:
    """Static min per-level fan-out before host numpy yields to a device
    dispatch (shared by the engine and the function resolver)."""
    return _int("DGRAPH_TPU_EXPAND_DEVICE_MIN", EXPAND_DEVICE_MIN_DEFAULT)


def resident() -> str:
    """DGRAPH_TPU_RESIDENT: '0', '1' (auto) or 'force'."""
    return os.environ.get("DGRAPH_TPU_RESIDENT", "1")


def kway_device_min() -> int:
    """Static min total candidate elements before a k-way intersection
    takes the intersect kernel over the host fold."""
    return _int("DGRAPH_TPU_KWAY_DEVICE_MIN", KWAY_DEVICE_MIN_DEFAULT)


def chain_threshold() -> int:
    """Static min estimated fan-out before a uid chain fuses."""
    return _int("DGRAPH_TPU_CHAIN_THRESHOLD", CHAIN_THRESHOLD_DEFAULT)



def segment_mode() -> str:
    """DGRAPH_TPU_SEGMENT: '0', 'auto' or 'force'."""
    return os.environ.get("DGRAPH_TPU_SEGMENT", "auto")


def segment_k() -> int:
    """Hops per segment under DGRAPH_TPU_SEGMENT=force."""
    return _int("DGRAPH_TPU_SEGMENT_K", SEGMENT_K_DEFAULT)
