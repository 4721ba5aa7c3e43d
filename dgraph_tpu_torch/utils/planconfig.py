"""Route knobs of the port's engine (copy of the subset of
``dgraph_tpu/utils/planconfig.py`` it reads; same environment names, so
one setting steers both engines).

Env knob                      Default  Meaning
DGRAPH_TPU_PLANNER            1        measured-cost planner
                                       (query/planner.py): '0' restores
                                       every static compare below
DGRAPH_TPU_CALIBRATION_FILE   scratch/planner_calib_torch.json
                                       persisted calibration ('' keeps none);
                                       the port's own default path, so the
                                       two packages never share a file
DGRAPH_TPU_CALIBRATE          0        '1' re-measures the rates on the
                                       card at server boot and persists them
DGRAPH_TPU_EXPAND_DEVICE_MIN  262144   min per-level fan-out before an
                                       expansion leaves host numpy for a
                                       device dispatch
DGRAPH_TPU_RESIDENT           1        resident-CSR gather tier: '0' never,
                                       '1' on a CUDA device, 'force' on any
                                       device (the CPU runs the kernel's
                                       plain version; the parity tests)
DGRAPH_TPU_FUSED_HOP          1        the reference's fused-hop gate: '0'
                                       never (no classed route, no multi-hop
                                       pass, no fused @recurse), '1' the
                                       classed route on a CPU device only,
                                       'force' the classed route on any
                                       device (ops/batch.py ClassedExpander)
DGRAPH_TPU_CLASS_W_MAX        10       widest classed-gather degree class
                                       (log2 width), bound when ops.batch is
                                       imported; wider rows form the classed
                                       programs' residual bucket
DGRAPH_TPU_KWAY_DEVICE_MIN    262144   min total elements of a k-way
                                       intersection before the host fold
                                       yields to the intersect kernel
                                       (static; the planner prices it)
DGRAPH_TPU_CHAIN_THRESHOLD    262144   min estimated fan-out of a uid chain
                                       before it fuses (query/chain.py)
DGRAPH_TPU_SEGMENT            auto     segment seams in the fused hop loops
                                       (sched/segments.py): '0' never,
                                       'force' every DGRAPH_TPU_SEGMENT_K
                                       hops, 'auto' priced by the planner
                                       (never while it is off)
DGRAPH_TPU_SEGMENT_K          4        hops per segment under 'force' (and
                                       under 'auto' when pinned)
DGRAPH_TPU_MXU_JOIN           1        tile join tier (query/joinplan.py):
                                       '0' off, '1' behind the cost model,
                                       'force' skips the cost compare
                                       (structural checks still apply)
DGRAPH_TPU_MXU_MASK_MAX       1<<22    largest frontier-mask lane count the
                                       tile route may allocate
DGRAPH_TPU_TILE               128      adjacency tile edge length
DGRAPH_TPU_TILE_BUDGET        1<<28    per-arena tile byte budget
DGRAPH_TPU_IVM_REPAIR         1        in-place repair of hop-cache entries
                                       and tiles after a delta: '0' drop
                                       only, '1' within the cap below and
                                       priced by the planner, 'force'
                                       within the cap
DGRAPH_TPU_IVM_REPAIR_MAX_DELTA 512    largest edge delta repaired in place

Every knob is read per call, so a test or an operator flips it without
rebuilding the engine, except DGRAPH_TPU_CLASS_W_MAX (bound when
ops.batch is imported) and the expansion route gates DGRAPH_TPU_RESIDENT
and _FUSED_HOP (read when an engine is built).  A knob set in the
environment is pinned (``overridden``): the planner then keeps the
static compare for the gate it steers.
"""

from __future__ import annotations

import os

EXPAND_DEVICE_MIN_DEFAULT = 262144
KWAY_DEVICE_MIN_DEFAULT = 262144
CHAIN_THRESHOLD_DEFAULT = 262144
SEGMENT_K_DEFAULT = 4
MXU_MASK_MAX_DEFAULT = 1 << 22
TILE_DEFAULT = 128
TILE_BUDGET_DEFAULT = 1 << 28
IVM_REPAIR_MAX_DELTA_DEFAULT = 512
CLASS_W_MAX_DEFAULT = 10
CALIBRATION_FILE_DEFAULT = "scratch/planner_calib_torch.json"


def overridden(name: str) -> bool:
    """Is this knob explicitly pinned in the environment?  The planner
    treats a pinned knob as an operator override and keeps the static
    compare for that gate."""
    return name in os.environ


def _int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    return int(raw)


def planner_enabled() -> bool:
    """DGRAPH_TPU_PLANNER: the measured-cost planner gate (default on).
    ``0`` restores every static compare."""
    return os.environ.get("DGRAPH_TPU_PLANNER", "1") != "0"


def calibration_file() -> str:
    """Path of the persisted calibration JSON ('' keeps none)."""
    return os.environ.get(
        "DGRAPH_TPU_CALIBRATION_FILE", CALIBRATION_FILE_DEFAULT
    )


def calibrate_at_boot() -> bool:
    """DGRAPH_TPU_CALIBRATE=1: re-measure the rates at server boot and
    persist them, replacing any file (the stale-calibration remedy).
    Default off: a boot loads the persisted file or keeps the priors."""
    return os.environ.get("DGRAPH_TPU_CALIBRATE", "0") == "1"


def expand_device_min() -> int:
    """Static min per-level fan-out before host numpy yields to a device
    dispatch (shared by the engine and the function resolver)."""
    return _int("DGRAPH_TPU_EXPAND_DEVICE_MIN", EXPAND_DEVICE_MIN_DEFAULT)


def resident() -> str:
    """DGRAPH_TPU_RESIDENT: '0', '1' (auto) or 'force'."""
    return os.environ.get("DGRAPH_TPU_RESIDENT", "1")


def fused_hop() -> str:
    """DGRAPH_TPU_FUSED_HOP: the classed route and the fused hop loops
    ('0' / '1' / 'force')."""
    return os.environ.get("DGRAPH_TPU_FUSED_HOP", "1")


def class_w_max() -> int:
    """Widest classed-gather degree class (log2 width); rows above it go
    to the residual bucket."""
    return _int("DGRAPH_TPU_CLASS_W_MAX", CLASS_W_MAX_DEFAULT)


def kway_device_min() -> int:
    """Static min total candidate elements before a k-way intersection
    takes the intersect kernel over the host fold."""
    return _int("DGRAPH_TPU_KWAY_DEVICE_MIN", KWAY_DEVICE_MIN_DEFAULT)


def chain_threshold() -> int:
    """Static min estimated fan-out before a uid chain fuses."""
    return _int("DGRAPH_TPU_CHAIN_THRESHOLD", CHAIN_THRESHOLD_DEFAULT)


def segment_mode() -> str:
    """DGRAPH_TPU_SEGMENT: '0', 'auto' (priced) or 'force'."""
    return os.environ.get("DGRAPH_TPU_SEGMENT", "auto")


def segment_k() -> int:
    """Hops per segment under DGRAPH_TPU_SEGMENT=force (and under
    'auto' when pinned)."""
    return _int("DGRAPH_TPU_SEGMENT_K", SEGMENT_K_DEFAULT)


def mxu_mode() -> str:
    """DGRAPH_TPU_MXU_JOIN: '0' off, '1' cost-modeled (default), 'force'
    always (structural eligibility permitting)."""
    return os.environ.get("DGRAPH_TPU_MXU_JOIN", "1")


def mask_max_lanes() -> int:
    """Largest frontier-mask length the tile route may allocate (float32
    lanes; the default 1<<22 is 16 MiB a mask)."""
    return _int("DGRAPH_TPU_MXU_MASK_MAX", MXU_MASK_MAX_DEFAULT)


def tile_size() -> int:
    """Adjacency tile edge length (uids per block side)."""
    return _int("DGRAPH_TPU_TILE", TILE_DEFAULT)


def tile_budget() -> int:
    """Per-arena tile byte budget."""
    return _int("DGRAPH_TPU_TILE_BUDGET", TILE_BUDGET_DEFAULT)


def ivm_repair_mode() -> str:
    """DGRAPH_TPU_IVM_REPAIR: '0' never repair (drop only), '1' (default)
    a delta within the cap when the planner prices repair below the
    refills, 'force' any delta within the cap."""
    return os.environ.get("DGRAPH_TPU_IVM_REPAIR", "1")


def ivm_repair_max_delta() -> int:
    """Largest edge delta a derived view is repaired with in place."""
    return _int(
        "DGRAPH_TPU_IVM_REPAIR_MAX_DELTA", IVM_REPAIR_MAX_DELTA_DEFAULT
    )
