"""Background re-prove loop shared by the port's latches (the
``CooldownProbeLoop`` of ``dgraph_tpu/utils/health.py``; the storage
plane's read-only latch, ``models/durability.StorageHealth``, is its one
user in the port)."""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional


class CooldownProbeLoop:
    """Background re-prove loop: sleep one interval FIRST, then probe
    once per interval on a single daemon thread.

    ``probe`` returns True when the resource healed (the loop exits);
    ``active`` returns False when probing should stop (owner stopped,
    or the latch already cleared some other way).  ``start()`` is
    idempotent while a loop thread is alive — a storm of concurrent
    faults spawns at most one prober.
    """

    def __init__(
        self,
        probe: Callable[[], bool],
        interval_s: float,
        active: Callable[[], bool],
        name: str = "dgraph-probe",
    ):
        self._probe = probe
        self.interval_s = interval_s
        self._active = active
        self._name = name
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> bool:
        """Spawn the loop unless one is already running; returns whether
        this call spawned it."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False
            self._thread = threading.Thread(
                target=self._loop, name=self._name, daemon=True
            )
            t = self._thread
        t.start()
        return True

    def _loop(self) -> None:
        while True:
            # cooldown FIRST (half-open semantics): give the condition
            # one interval to clear before re-proving anything
            if not self._active():
                return
            time.sleep(self.interval_s)
            if not self._active():
                return
            if self._probe():
                return
