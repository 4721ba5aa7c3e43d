"""Device telemetry: residency, program caches, kernel builds (the
counterpart of ``dgraph_tpu/obs/device.py`` on PyTorch).

The ArenaManager enforces a device-memory budget (models/arena.py LRU
eviction) and the tile join tier keeps per-arena tile sets; this module
turns that bookkeeping into gauges and one snapshot endpoint:

- **residency** — resident bytes vs budget (headroom is the
  difference), dense join-tile bytes, cumulative arena evictions;
- **program caches** — tile sets per kind
  (``dgraph_program_cache_entries{kind}``);
- **kernel builds** — the port's counterpart of the reference's XLA
  backend compilations is a kernel library built at first use
  (``ops/_build.py``: ``nvcc`` per CUDA source, ``g++`` per host
  library).  Each build made by this process is counted under the
  reference's families, ``dgraph_xla_compiles_total`` and the
  ``dgraph_xla_compile_seconds`` histogram, and onto the active
  request's ledger (``compiles``);
- **build identity** — ``dgraph_build_info{version,backend,torch}`` = 1
  (the reference's third label is ``jax``).

Served at ``GET /debug/device`` and folded into ``GET /debug/bundle``
(serve/server.py).  The snapshot's keys differ from the reference's
where the platforms differ: ``torch`` and ``cuda`` (the toolkit torch
was built with) and ``device_name`` stand where the reference has
``jax``; ``compiles.builds`` lists the builds by library.  The
``guard`` key is the device fault domain's state (``utils/devguard.py``:
enabled, and per domain its state, faults, probes and knobs), as in the
reference.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict

from dgraph_tpu_torch.obs import ledger as _ledger
from dgraph_tpu_torch.utils import devguard
from dgraph_tpu_torch.utils.metrics import (
    BUILD_INFO,
    HBM_BUDGET_BYTES,
    HBM_RESIDENT_BYTES,
    HBM_TILE_BYTES,
    PROGRAM_CACHE_ENTRIES,
    XLA_COMPILE_SECONDS,
    XLA_COMPILES,
)


def note_build(secs: float) -> None:
    """Count one kernel-library build (ops/_build.py calls it after each
    successful compile)."""
    XLA_COMPILES.add(1)
    XLA_COMPILE_SECONDS.observe(secs)
    led = _ledger.current()
    if led is not None:
        # a build lands on whichever request's thread triggered it
        led.compiles += 1


def builds() -> Dict[str, int]:
    """Library name -> builds this process made (ops/_build.py's record)."""
    from dgraph_tpu_torch.ops import _build

    return dict(Counter(_build.built))


def _backend(device) -> str:
    import torch

    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def stamp_build_info(device=None) -> None:
    """Publish dgraph_build_info{version,backend,torch} = 1 for the
    engine's ``device`` (server start)."""
    import torch

    from dgraph_tpu_torch import __version__

    BUILD_INFO.set((__version__, _backend(device), torch.__version__), 1.0)


def snapshot(server=None) -> dict:
    """One device-telemetry snapshot (the /debug/device body), updating
    the gauges as a side effect so a scrape that never hits the debug
    endpoint still sees fresh residency numbers after any snapshot.

    ``server`` is a DgraphServer when called from the serving surface;
    None gives the process-wide view (backend + builds)."""
    import torch

    engine = getattr(server, "engine", None)
    device = getattr(engine, "device", None)
    backend = _backend(device)
    if backend == "cuda":
        dev = torch.device(device) if device is not None else torch.device("cuda")
        name = torch.cuda.get_device_name(dev)
        n_dev = torch.cuda.device_count()
    else:
        name, n_dev = "cpu", 1
    out: dict = {
        "backend": backend,
        "devices": n_dev,
        "device_name": name,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "compiles": {
            "total": XLA_COMPILES.value(),
            "seconds_sum": round(XLA_COMPILE_SECONDS.snapshot()[1], 3),
            "builds": builds(),
        },
        "guard": {"enabled": devguard.enabled(), "domains": devguard.summary()},
    }
    arenas = getattr(engine, "arenas", None)
    if arenas is None:
        return out
    res = arenas.residency()
    HBM_RESIDENT_BYTES.set(res["resident_bytes"])
    HBM_BUDGET_BYTES.set(res["budget_bytes"])
    HBM_TILE_BYTES.set(res["tile_bytes"])
    for kind, n in res["program_caches"].items():
        PROGRAM_CACHE_ENTRIES.set(kind, n)
    out["arenas"] = res
    return out
