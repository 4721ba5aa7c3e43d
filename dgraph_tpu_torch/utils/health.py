"""Health primitives shared across the port's fault domains (copy of
``dgraph_tpu/utils/health.py``):

- :class:`HealthGate` — the boot-readiness bit behind ``/health``;
- :class:`HalfOpenGate` — the probe-slot discipline of the per-(peer, op)
  circuit breaker (``cluster/peerclient.py``): after a cooldown exactly
  one caller at a time holds the half-open probe slot, owns it via a
  token, and hands it back on every exit path;
- :class:`CooldownProbeLoop` — the background re-prove loop of the
  storage plane's read-only latch (``models/durability.StorageHealth``)
  and of the device fault domain (``utils/devguard.py``); ``stop()``
  ends it at once (the reference's loop sleeps its interval out).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Tuple


class HealthGate:
    def __init__(self):
        self._ok = threading.Event()

    def set_ok(self, ok: bool = True) -> None:
        if ok:
            self._ok.set()
        else:
            self._ok.clear()

    def ok(self) -> bool:
        return self._ok.is_set()


class HalfOpenGate:
    """Single-probe admission for an OPEN/SICK circuit.

    NOT thread-safe on its own: the owner calls every method under its
    own state lock (the gate is a few fields of that state, not a new
    lock — a second lock here would buy deadlock risk for nothing).

    Lifecycle: ``open(now)`` (re)starts the cooldown and clears the
    probe slot; ``admit(now, cooldown, half_open)`` grants the slot to
    exactly one caller once the cooldown elapsed (``half_open=True``
    skips the cooldown check — the circuit already transitioned, only
    the slot matters); ``release(token)`` frees the slot WITHOUT
    judging the resource, stale tokens are no-ops.
    """

    __slots__ = ("opened_at", "probe_inflight", "probe_token")

    def __init__(self):
        self.opened_at = 0.0
        self.probe_inflight = False
        self.probe_token = 0  # ownership of the half-open probe slot

    def open(self, now: float) -> None:
        """(Re-)enter the open state: restart the cooldown clock and
        clear the probe slot (the failed prober's release becomes a
        stale-token no-op)."""
        self.opened_at = now
        self.probe_inflight = False

    def admit(
        self, now: float, cooldown: float, half_open: bool
    ) -> Tuple[bool, float, Optional[int]]:
        """(granted, retry_after, probe_token).  A non-None token means
        the caller HOLDS the probe slot and must hand it back to
        :meth:`release` on every exit path, or the circuit wedges
        shedding forever."""
        if not half_open:
            waited = now - self.opened_at
            if waited < cooldown:
                return False, cooldown - waited, None
        if self.probe_inflight:
            return False, cooldown, None
        self.probe_inflight = True
        self.probe_token += 1
        return True, 0.0, self.probe_token

    def release(self, token: Optional[int]) -> None:
        """Free the probe slot without judging the resource.  A stale
        token (the slot was re-granted to a newer probe after
        :meth:`open` cleared it) is a no-op."""
        if token is not None and self.probe_token == token:
            self.probe_inflight = False


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
        self._stop = threading.Event()

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

    def stop(self, join_s: float = 0.0) -> None:
        """End the loop at its next wake (the owner is going away); with
        ``join_s`` wait that long for the thread to exit."""
        self._stop.set()
        t = self._thread
        if join_s and t is not None and t is not threading.current_thread():
            t.join(join_s)

    def _loop(self) -> None:
        while True:
            # cooldown FIRST (half-open semantics): give the condition
            # one interval to clear before re-proving anything
            if self._stop.is_set() or not self._active():
                return
            if self._stop.wait(self.interval_s) or not self._active():
                return
            if self._probe():
                return
