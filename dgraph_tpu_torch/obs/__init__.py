"""Request accounting for the port: the per-request resource ledger
(``obs.ledger``) and the engine's stage timer.  Sampled spans and the
flight recorder of ``dgraph_tpu.obs`` are not ported yet."""

from __future__ import annotations

import time

from dgraph_tpu_torch.obs import ledger  # noqa: F401 — submodule surface


class _Stage:
    """Accumulating stage timer for the engine's per-request stats dicts
    (host_expand_ms / device_expand_ms / ...), in milliseconds."""

    __slots__ = ("stats", "key", "t0")

    def __init__(self, stats: dict, key: str):
        self.stats = stats
        self.key = key

    def __enter__(self) -> "_Stage":
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb) -> None:
        self.stats[self.key] = self.stats.get(self.key, 0.0) + (
            (time.perf_counter() - self.t0) * 1e3
        )


def stage(stats: dict, key: str) -> _Stage:
    return _Stage(stats, key)
