"""Join-route choice (the PyTorch port of ``dgraph_tpu/query/joinplan.py``),
for now its k-way half.

- **`kway_intersect`** — the k-way set-intersection router: the host
  ``np.intersect1d`` fold below the size gate (``kway_device_min``,
  ``DGRAPH_TPU_KWAY_DEVICE_MIN``), one call of the intersect kernel
  (``ops.kway.intersect_batch``) above it.  The engine's ``@filter``
  AND and the resolver's token / trigram folds (term ``eq``,
  ``allofterms`` / ``alloftext``, ``regexp``) route through here.
- **decision recording** — every route choice lands in the per-request
  ``engine.stats["join_routes"]`` (bounded) and a process-level ring
  with counts (``debug_summary``).

The reference's ``DGRAPH_TPU_MXU_JOIN`` knob is not read: it gates the
tile route, which is not ported, and the size gate alone picks host or
device.  The reference's device guard, failpoints and metrics belong to
the serving plane and are not ported: a device fault propagates.
``try_mxu_route`` (the fused tile route for var-block chains) comes
with the port of ``query/chain.py``, its only caller.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from dgraph_tpu_torch import device as devmod
from dgraph_tpu_torch import obs, ops
from dgraph_tpu_torch.ops.kway import intersect_batch
from dgraph_tpu_torch.ops.sets import SENT
from dgraph_tpu_torch.utils import planconfig

_EMPTY = np.empty(0, dtype=np.int64)

# the reference's bound on the sets of one device k-way call
KWAY_K_MAX = 16


# -- decision recording -------------------------------------------------------

_ROUTE_LOCK = threading.Lock()
_RECENT: "deque[dict]" = deque(maxlen=16)
_COUNTS = {"kway_device": 0, "kway_host": 0}


def record_route(stats: Optional[dict], decision: dict) -> None:
    """Log one join-route decision where it must be visible: the
    per-request engine stats (bounded) and the process ring."""
    route = decision["route"]
    with _ROUTE_LOCK:
        _RECENT.append(decision)
        _COUNTS[route] = _COUNTS.get(route, 0) + 1
    if stats is not None:
        rj = stats.setdefault("join_routes", [])
        if len(rj) < 8:
            rj.append(decision)


def debug_summary() -> dict:
    """Process-level routing summary: counts by route, last decisions."""
    with _ROUTE_LOCK:
        return {"counts": dict(_COUNTS), "recent": list(_RECENT)}


def _reset_for_tests() -> None:
    with _ROUTE_LOCK:
        _RECENT.clear()
        for k in list(_COUNTS):
            _COUNTS[k] = 0


# -- k-way set intersection ---------------------------------------------------


def kway_intersect(
    sets: List[np.ndarray],
    stats: Optional[dict] = None,
    device=None,
    device_min: Optional[int] = None,
) -> np.ndarray:
    """Intersection of k sorted-unique uid sets, size-routed: one call of
    the intersect kernel on ``device`` (default cuda) when the total size
    reaches ``device_min`` (default ``planconfig.kway_device_min()``) and
    there are at most ``KWAY_K_MAX`` sets, the numpy fold otherwise.
    Byte-identical either way (sorted-unique int64)."""
    sets = [np.asarray(s, dtype=np.int64) for s in sets]
    if not sets:
        return _EMPTY
    if len(sets) == 1:
        return sets[0]
    if min(len(s) for s in sets) == 0:
        return _EMPTY
    total = sum(len(s) for s in sets)
    k = len(sets)
    gate = planconfig.kway_device_min() if device_min is None else device_min
    use_device = k <= KWAY_K_MAX and total >= gate
    st = stats if stats is not None else {}
    route = "kway_device" if use_device else "kway_host"
    if use_device:
        dev = devmod.resolve(device)
        with obs.stage(st, "kway_ms"):
            L = ops.bucket(max(len(s) for s in sets))
            mat = np.stack([ops.pad_to(s, L) for s in sets])
            out = intersect_batch(torch.from_numpy(mat).to(dev)[None])[0]
            out = out.cpu().numpy()
            res = out[out != SENT].astype(np.int64)
    else:
        with obs.stage(st, "kway_ms"):
            res = sets[0]
            for s in sets[1:]:
                res = np.intersect1d(res, s)
    if stats is not None:
        stats[route] = stats.get(route, 0) + 1
    record_route(stats, {"route": route, "k": k, "units": int(total)})
    return res


def filter_leaf_global(fn) -> bool:
    """Does this filter Function resolve to a uid set WITHOUT the
    candidate frontier?  Index functions, ``has()`` and ``uid(...)`` —
    a bound uid variable is a global set, it only looks
    frontier-dependent — but not value-variable compares, counts,
    functions that read variables, ``uid_in`` or ``checkpwd``."""
    if fn.name == "uid":
        return True
    return not (
        fn.is_val_var
        or fn.is_count
        or fn.needs_vars
        or fn.name in ("uid_in", "checkpwd")
    )
