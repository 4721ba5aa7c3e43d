"""The mutation delta stream: a bounded, versioned ring of store edits
(copy of ``dgraph_tpu/ivm/deltas.py``).

Published from the store's commit path (models/store.py — every
``apply``/bulk/schema/delete site; on a ``DurableStore`` the same call
that journals the record, so "journaled" and "streamed" are one event),
consumed by the live-query notifier (ivm/subs.py).  Cache and arena
repair do NOT consume this stream: the store's per-predicate journal
(``store.delta``) already carries exact (src, dst, ±1) batches to
``ArenaManager.refresh``.  The stream's job is the PUSH half: which
predicates changed, at which version, with which edges.

Events are plain tuples ``(seq, version, pred, kind, src, dst, sign)``:

- ``kind="edge"`` — one uid-edge add (+1) or delete (-1);
- ``kind="pred"`` — a whole-predicate change with no per-edge form
  (value mutations, bulk loads, predicate deletes);
- ``kind="epoch"`` — a non-scopeable change (schema mutation,
  full-store replacement): everything is dirty.

Bounded by ``DGRAPH_TPU_IVM_STREAM_CAP`` (default 65536 events):
overflow drops the OLDEST events, and a reader whose cursor fell off the
tail is told so (``lost=True``) and must treat every predicate as dirty.

Thread-safety: publishers (mutations) are serialized by the server's
write lock; the ring's own lock only bridges to readers (the notifier
thread).  The server attaches the stream after a durable store's
recovery, so replayed records publish nothing.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import List, Optional, Tuple

from dgraph_tpu_torch.utils.metrics import IVM_DELTAS, IVM_STREAM_DROPPED

_DEFAULT_CAP = 65536


def _cap() -> int:
    try:
        return max(16, int(os.environ.get("DGRAPH_TPU_IVM_STREAM_CAP",
                                          _DEFAULT_CAP)))
    except ValueError:
        return _DEFAULT_CAP


Event = Tuple[int, int, str, str, int, int, int]


class DeltaStream:
    """One per store.  See the module docstring for the event model."""

    # publishers (mutation path) and the notifier both advance these
    # under _cond — checked by the lockset witness when armed
    __race_fields__ = frozenset({"_seq", "_dropped"})

    def __init__(self, cap: Optional[int] = None):
        self._cap = cap if cap is not None else _cap()
        self._ring: "deque[Event]" = deque(maxlen=self._cap)
        self._cond = threading.Condition()
        self._seq = 0          # seq of the NEXT event to be published
        self._dropped = 0      # events lost to ring overflow (monotonic)

    # -- publication (store commit path) ------------------------------------

    def publish_edge(
        self, pred: str, src: int, dst: int, sign: int, version: int
    ) -> None:
        self._publish((pred, "edge", int(src), int(dst), int(sign)), version)

    def publish_pred(self, pred: str, version: int) -> None:
        """Whole-predicate change (value mutation, bulk load, delete)."""
        self._publish((pred, "pred", 0, 0, 0), version)

    def publish_epoch(self, version: int) -> None:
        """Non-scopeable change (schema, full-store replacement)."""
        self._publish(("", "epoch", 0, 0, 0), version)

    def _publish(self, body: tuple, version: int) -> None:
        pred, kind, src, dst, sign = body
        with self._cond:
            if len(self._ring) == self._cap:
                self._dropped += 1
                IVM_STREAM_DROPPED.add(1)
            self._ring.append(
                (self._seq, int(version), pred, kind, src, dst, sign)
            )
            self._seq += 1
            self._cond.notify_all()
        IVM_DELTAS.add(kind)

    # -- consumption (notifier threads) --------------------------------------

    @property
    def seq(self) -> int:
        """Seq the NEXT published event will carry (== count ever
        published)."""
        with self._cond:
            return self._seq

    @property
    def dropped(self) -> int:
        return self._dropped

    def read_since(self, cursor: int) -> Tuple[List[Event], int, bool]:
        """Events with seq >= ``cursor``: (events, next_cursor, lost).
        ``lost=True`` means the cursor fell off the ring's tail — the
        reader missed events and must treat every predicate as dirty."""
        with self._cond:
            if not self._ring:
                return [], self._seq, cursor < self._seq
            first = self._ring[0][0]
            lost = cursor < first
            evs = [e for e in self._ring if e[0] >= cursor]
            return evs, self._seq, lost

    def wait_for(self, cursor: int, timeout: Optional[float] = None) -> bool:
        """Block until an event with seq >= ``cursor`` exists (or
        timeout).  Returns whether one does."""
        with self._cond:
            return self._cond.wait_for(
                lambda: self._seq > cursor, timeout=timeout
            )

    def snapshot(self) -> dict:
        """/debug introspection: cap / live length / seq / dropped."""
        with self._cond:
            return {
                "cap": self._cap,
                "len": len(self._ring),
                "seq": self._seq,
                "dropped": self._dropped,
            }


def attach_stream(store) -> DeltaStream:
    """Attach (or return the existing) DeltaStream on a store.  The
    store publishes to ``store.delta_stream`` when the attribute is set
    — None (the default on every store) costs one attribute read per
    mutation."""
    ds = getattr(store, "delta_stream", None)
    if ds is None:
        ds = DeltaStream()
        store.delta_stream = ds
    return ds
