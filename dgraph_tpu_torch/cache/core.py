"""Snapshot-versioned, byte-budgeted cache core shared by both tiers
(copy of ``dgraph_tpu/cache/core.py``).

Under concurrent skewed workloads, cross-query reuse of intermediate
results dominates served QPS.  This module supplies the one mechanism
both cache tiers (cache/hop.py, cache/result.py) share:

- **Snapshot versioning.**  Every entry is keyed under a caller-chosen
  monotonic version — the footprint-scoped predicate version
  (ivm/versions.py), the store's global mutation ``version`` under
  ``DGRAPH_TPU_IVM=0``.  A probe carries the *current* version; an
  entry recorded under any older version can never match, so
  invalidation is O(1): no flush stall, no lockstep with writers.
  ``repair_where`` lets the IVM layer transform-and-re-key entries a
  delta can fix in place.

- **Reclaim on probe.**  A probe that finds its key under another
  version reclaims that entry on the spot; a dead entry no probe
  reaches again loses its heat and leaves through LFU eviction.  The
  reference also sweeps, on every put, a handful of entries whose
  version differs from the put's.  That reclaims live entries: under
  IVM an entry is keyed on its own footprint's version, so an entry of
  another footprint is live at another version.  The port does not
  sweep (the difference only moves hits; responses are the same).

- **LFU-with-aging admission/eviction** under a byte budget.  Plain
  LRU lets one megaquery walk the whole hot head out of the cache;
  plain LFU never forgets, so yesterday's hot key squats forever.
  Here each entry carries a frequency that ages (halves) every
  ``age_interval`` puts, eviction takes the lowest (frequency, recency)
  victim, and entries larger than ``max_entry_frac`` of the budget are
  refused admission outright — one giant expansion cannot displace
  thousands of hot small ones (the scan-resistance half of TinyLFU's
  argument, without the sketch).

Thread-safe; all operations are O(1) amortized except eviction scans,
which touch only as many entries as they free.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple


def cache_enabled() -> bool:
    """The DGRAPH_TPU_CACHE gate (default ON; ``0`` restores today's
    cache-less behavior byte-identically)."""
    return os.environ.get("DGRAPH_TPU_CACHE", "1") != "0"


class _Entry:
    __slots__ = ("value", "version", "nbytes", "freq", "seq", "born")

    def __init__(self, value, version: int, nbytes: int, seq: int):
        self.value = value
        self.version = version
        self.nbytes = nbytes
        self.freq = 1.0
        self.seq = seq          # recency tiebreak (monotonic put/hit seq)
        self.born = time.monotonic()


class VersionedLFUCache:
    """One cache tier: dict of key → entry under a byte budget.

    ``stats_hook(event, entry_or_none)`` fires outside hot math but
    inside the lock-free tail of each operation with event ∈
    {"hit", "miss", "stale", "evicted", "rejected"} so the tiers can
    pump the metrics registry without this module importing it.
    """

    def __init__(
        self,
        budget_bytes: int,
        max_entry_frac: float = 0.125,
        age_interval: int = 256,
        stats_hook: Optional[Callable] = None,
    ):
        self.budget_bytes = int(budget_bytes)
        self.max_entry_bytes = max(1, int(self.budget_bytes * max_entry_frac))
        self.age_interval = max(1, int(age_interval))
        self._hook = stats_hook
        self._lock = threading.Lock()
        self._m: Dict[object, _Entry] = {}
        self._bytes = 0
        self._seq = 0
        self._puts_since_age = 0

    # -- introspection -----------------------------------------------------

    @property
    def occupancy_bytes(self) -> int:
        return self._bytes

    def __len__(self) -> int:
        return len(self._m)

    # -- operations --------------------------------------------------------

    def get(self, key, version: int):
        """Return (value, age_seconds) on a live hit, else None.  An
        entry recorded under an older version counts as stale (dead),
        is reclaimed immediately, and reads as a miss."""
        return self.get_ev(key, version)[0]

    def get_ev(self, key, version: int):
        """``(hit_or_None, event, nbytes)`` — the probe plus WHICH event
        it was (hit / miss / stale) and the hit entry's stored byte
        size, for callers that record the outcome on a trace span or the
        request's ledger (cache/hop.py, cache/result.py)."""
        hit = None
        nbytes = 0
        with self._lock:
            e = self._m.get(key)
            if e is None:
                ev = "miss"
            elif e.version != version:
                del self._m[key]
                self._bytes -= e.nbytes
                ev = "stale"
            else:
                e.freq += 1.0
                self._seq += 1
                e.seq = self._seq
                ev = "hit"
                nbytes = e.nbytes
                hit = (e.value, time.monotonic() - e.born)
        hook = self._hook
        if hook is not None:
            hook(ev, e if hit is not None else None)
        return hit, ev, nbytes

    def contains(self, key, version: int) -> bool:
        """Live-entry probe with NO side effects (no heat, no reclaim,
        no stats) — lets callers skip redundant value preparation before
        a re-put of a key a twin already stored."""
        with self._lock:
            e = self._m.get(key)
            return e is not None and e.version == version

    def put(self, key, version: int, value, nbytes: int) -> bool:
        """Admit ``value`` under the budget; returns False when refused
        (over the per-entry cap, or a zero budget).  Also performs, when
        needed, LFU-aging eviction."""
        nbytes = int(nbytes)
        if self.budget_bytes <= 0 or nbytes > self.max_entry_bytes:
            hook = self._hook
            if hook is not None:
                hook("rejected", None)
            return False
        evicted = 0
        with self._lock:
            old = self._m.get(key)
            if old is not None:
                self._bytes -= old.nbytes
            self._seq += 1
            e = _Entry(value, version, nbytes, self._seq)
            if old is not None and old.version == version:
                e.freq = old.freq + 1.0  # re-put of a live key keeps heat
                e.born = old.born        # …and its age (hit-age histogram
                # must not reset when coalesced twins re-store the entry)
            self._m[key] = e
            self._bytes += nbytes
            self._puts_since_age += 1
            if self._puts_since_age >= self.age_interval:
                self._puts_since_age = 0
                for ent in self._m.values():
                    ent.freq *= 0.5
            evicted = self._evict_locked(protect=key)
        hook = self._hook
        if hook is not None:
            for _ in range(evicted):
                hook("evicted", None)
        return True

    def repair_where(
        self,
        pred: Callable[[object], bool],
        old_version: int,
        new_version: int,
        fix: Callable,
    ) -> Tuple[int, int]:
        """IVM delta repair (dgraph_tpu/ivm/): for every entry whose KEY
        satisfies ``pred``, entries recorded at exactly ``old_version``
        are transformed by ``fix(value) -> (new_value, nbytes) | None``
        and RE-KEYED to ``new_version`` (heat and age preserved — the
        repaired entry IS the same logical entry); entries at any other
        version, and entries ``fix`` declines, are dropped.  Returns
        (repaired, dropped).

        ``fix`` runs under the tier lock — callers gate repair to small
        deltas (query/planner.py repair_route), so the hold is bounded
        the same way the eviction scan is."""
        repaired = dropped = 0
        with self._lock:
            for k in [k for k in self._m if pred(k)]:
                e = self._m[k]
                out = None
                if e.version == old_version:
                    out = fix(e.value)
                if out is None:
                    del self._m[k]
                    self._bytes -= e.nbytes
                    dropped += 1
                    continue
                value, nbytes = out
                self._bytes += int(nbytes) - e.nbytes
                e.value = value
                e.nbytes = int(nbytes)
                e.version = new_version
                repaired += 1
        return repaired, dropped

    def rekey_where(
        self,
        pred: Callable[[object], bool],
        keyfn: Callable[[object], object],
    ) -> int:
        """Move every entry whose KEY satisfies ``pred`` to
        ``keyfn(key)``, preserving value/version/heat/age (the moved
        entry IS the same logical entry — used by the arena-epoch flip,
        which changes WHERE a hop result is keyed, not whether it is
        still correct).  A collision with an existing destination key
        keeps the moved entry (the mover has strictly fresher context).
        Returns how many entries moved."""
        moved = 0
        with self._lock:
            for k in [k for k in self._m if pred(k)]:
                nk = keyfn(k)
                if nk == k:
                    continue
                e = self._m.pop(k)
                old = self._m.get(nk)
                if old is not None:
                    self._bytes -= old.nbytes
                self._m[nk] = e
                moved += 1
        return moved

    def drop_where(self, pred: Callable[[object], bool]) -> int:
        """Remove every entry whose KEY satisfies ``pred`` (explicit
        invalidation — e.g. tier 1 on arena eviction).  Returns count."""
        with self._lock:
            dead = [k for k in self._m if pred(k)]
            for k in dead:
                self._bytes -= self._m.pop(k).nbytes
            return len(dead)

    def clear(self) -> None:
        with self._lock:
            self._m.clear()
            self._bytes = 0

    # -- internals (lock held) ---------------------------------------------

    def _evict_locked(self, protect) -> int:
        """Evict lowest-(freq, seq) entries until within budget; never
        the entry just admitted.  ONE O(n) heapify per overflowing put,
        then O(log n) per victim — not a full scan per eviction (an
        at-budget steady state evicts on every miss-put, so the per-put
        cost is what bounds admission-path latency under the tier lock).
        Returns how many were evicted."""
        if self._bytes <= self.budget_bytes:
            return 0
        import heapq

        heap = [
            (e.freq, e.seq, k)
            for k, e in self._m.items()
            if k != protect
        ]
        heapq.heapify(heap)
        n = 0
        while self._bytes > self.budget_bytes and heap:
            _f, _s, victim = heapq.heappop(heap)
            e = self._m.pop(victim, None)
            if e is None:
                continue
            self._bytes -= e.nbytes
            n += 1
        return n


def env_bytes(name: str, default: int) -> int:
    """Parse a byte-count env knob (plain integer bytes)."""
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default
