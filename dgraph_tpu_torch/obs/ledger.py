"""Per-query resource ledger (trimmed copy of ``dgraph_tpu/obs/ledger.py``).

One :class:`Ledger` per request, installed in a context variable for the
request's thread; the engine charges hop routes, edges, stage time and
host<->device bytes to it, and ``/query?ledger=true`` returns it in the
response extensions.  The metric families, the struct pool, the
on/off gate and the cache/mesh fields of the reference are not ported
yet.
"""

from __future__ import annotations

import contextvars
from typing import Dict, Optional

_current: "contextvars.ContextVar[Optional[Ledger]]" = contextvars.ContextVar(
    "dgraph_tpu_torch_ledger", default=None
)


def current() -> Optional["Ledger"]:
    """The calling thread's active ledger, or None."""
    return _current.get()


class Ledger:
    """One request's resource account."""

    __slots__ = (
        "edges", "hops", "host_ms", "device_ms", "bytes_h2d", "bytes_d2h",
    )

    def __init__(self):
        self.edges = 0
        self.hops: Dict[str, int] = {}
        self.host_ms = 0.0
        self.device_ms = 0.0
        self.bytes_h2d = 0
        self.bytes_d2h = 0

    def note_hop(self, route: str) -> None:
        self.hops[route] = self.hops.get(route, 0) + 1

    def merge_engine_stats(self, stats: dict) -> None:
        """Fold one engine's per-request stats in at completion."""
        self.edges += int(stats.get("edges", 0))
        self.host_ms += stats.get("host_expand_ms", 0.0) + stats.get(
            "resolver_expand_ms", 0.0
        )
        self.device_ms += stats.get("device_expand_ms", 0.0) + stats.get(
            "device_order_ms", 0.0
        )

    def to_dict(self) -> dict:
        return {
            "edges": self.edges,
            "hops": dict(self.hops),
            "host_ms": round(self.host_ms, 3),
            "device_ms": round(self.device_ms, 3),
            "bytes_h2d": self.bytes_h2d,
            "bytes_d2h": self.bytes_d2h,
        }


def start() -> Ledger:
    """A fresh ledger for one request."""
    return Ledger()


def activate(led: Ledger):
    """Install ``led`` as the calling thread's ledger; returns the reset
    token for :func:`deactivate`."""
    return _current.set(led)


def deactivate(token) -> None:
    _current.reset(token)
