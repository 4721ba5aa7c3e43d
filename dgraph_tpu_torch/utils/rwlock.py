"""Writer-preferring readers-writer lock (copy of
``dgraph_tpu/utils/rwlock.py``).

The reference runs every request concurrently (per-request goroutines,
query/query.go:1684-1714) over posting lists guarded by per-list RWMutex
(posting/list.go).  Our read path shares immutable device arenas between
mutations, so the serving layer needs exactly one coarse RW lock: many
concurrent read-only queries, exclusive mutations.  Python's stdlib has no
RW lock; this is the classic two-condition implementation with writer
preference (a waiting writer blocks new readers, so a mutation stream
cannot be starved by a heavy read load).

NOT reentrant, on either side.  A thread already holding the read side
that re-acquires it deadlocks whenever a writer is queued (new readers
block on _writers_waiting) — and the deadlock is load-dependent, so it
would pass quiet tests and hang in production.  acquire_read therefore
tracks holder thread idents and raises RuntimeError on recursive
acquisition instead of deadlocking.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class RWLock:
    def __init__(self) -> None:
        self._cond = threading.Condition()
        self._readers = 0          # active readers
        self._writer = False       # a writer holds the lock
        self._writers_waiting = 0  # writers queued (blocks new readers)
        self._reader_idents: set[int] = set()  # recursive-read detection

    def acquire_read(self) -> None:
        ident = threading.get_ident()
        with self._cond:
            if ident in self._reader_idents:
                raise RuntimeError(
                    "recursive RWLock.acquire_read from the same thread "
                    "(would deadlock whenever a writer is queued)"
                )
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
            self._reader_idents.add(ident)

    def release_read(self) -> None:
        with self._cond:
            self._readers -= 1
            self._reader_idents.discard(threading.get_ident())
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self) -> None:
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def release_write(self) -> None:
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    @contextmanager
    def read(self):
        self.acquire_read()
        try:
            yield
        finally:
            self.release_read()

    @contextmanager
    def write(self):
        self.acquire_write()
        try:
            yield
        finally:
            self.release_write()
