"""WaterMark: lowest-contiguous-done index tracker (copy of
``dgraph_tpu/utils/watermark.py``).

Equivalent of x/watermark.go:64 — begin/done marks at arbitrary indices,
DoneUntil() reports the highest index i such that every index <= i is
done.  The reference feeds a channel into a min-heap goroutine; here a
lock plus heap."""

from __future__ import annotations

import heapq
import threading


class WaterMark:
    def __init__(self, name: str = ""):
        self.name = name
        self._lock = threading.Condition()
        self._pending: dict[int, int] = {}  # index -> outstanding begins
        self._heap: list[int] = []
        self._done_until = 0

    def begin(self, index: int) -> None:
        with self._lock:
            if index not in self._pending:
                heapq.heappush(self._heap, index)
                self._pending[index] = 0
            self._pending[index] += 1

    def done(self, index: int) -> None:
        with self._lock:
            if index not in self._pending:
                # done without begin: treat as begin+done (the reference
                # asserts; we tolerate for replay paths)
                heapq.heappush(self._heap, index)
                self._pending[index] = 0
            self._pending[index] -= 1
            self._advance()

    def _advance(self) -> None:
        moved = False
        while self._heap and self._pending.get(self._heap[0], 0) <= 0:
            idx = heapq.heappop(self._heap)
            self._pending.pop(idx, None)
            if idx > self._done_until:
                self._done_until = idx
            moved = True
        if moved:
            self._lock.notify_all()

    def done_until(self) -> int:
        with self._lock:
            return self._done_until
