"""Storage-plane resilience: disk-fault read-only mode + the background
snapshotter that keeps the WAL bounded (copy of
``dgraph_tpu/models/durability.py``).

- :class:`StorageHealth` — the moment a WAL append/flush/fsync raises
  ``OSError`` (ENOSPC, EIO, or an injected ``FailpointError``), the node
  flips READ-ONLY: mutations shed with 503 + Retry-After while reads
  keep serving from the in-memory store.  A background probe
  (``DGRAPH_TPU_STORAGE_PROBE_S``, default 2s) re-proves the directory
  accepts durable writes and re-arms the write path — the storage
  analog of a circuit breaker's half-open probe.

- :class:`Snapshotter` — the serving path's caller of
  ``DurableStore.snapshot()``: watches WAL bytes/records against
  ``DGRAPH_TPU_SNAPSHOT_WAL_MB`` / ``DGRAPH_TPU_SNAPSHOT_WAL_RECORDS``,
  seals the active log into a segment under the serving write lock
  (microseconds), then compacts OFF the write path (models/wal.py
  ``compact``), so under sustained writes the WAL stays bounded and
  restart replay stays O(recent writes), the reference's draft.go:849
  calculateSnapshot loop.  ``/admin/snapshot`` triggers it on demand.
"""

from __future__ import annotations

import sys
import threading
from typing import Callable, Optional

from dgraph_tpu_torch.utils.env import env_float, env_int
from dgraph_tpu_torch.utils.health import CooldownProbeLoop
from dgraph_tpu_torch.utils.metrics import (
    SNAPSHOT_AGE,
    STORAGE_ERRORS,
    STORAGE_READONLY,
    WAL_BYTES,
)


class StorageFaultError(OSError):
    """A durability operation failed against the underlying disk.  The
    serving layer maps this to HTTP 503 + Retry-After
    — the write was NOT acknowledged and may not survive a restart."""

    def __init__(self, msg: str, retry_after: float = 2.0):
        self.retry_after = retry_after
        super().__init__(msg)


class ReadOnlyError(StorageFaultError):
    """Mutation rejected at admission: the node is in storage read-only
    mode (a previous disk fault; the re-arm probe has not cleared yet)."""


class SnapshotCorruptError(RuntimeError):
    """Boot refused: ``snapshot.bin`` failed strict replay.  Never an
    OSError — retrying cannot help, and booting from the WAL alone would
    silently lose every snapshotted record."""

    def __init__(self, path: str, quarantine: str, detail: str):
        self.path = path
        self.quarantine = quarantine
        super().__init__(
            f"snapshot {path} is corrupt ({detail}); quarantined to "
            f"{quarantine}.  Refusing to boot from the WAL alone — that "
            "would silently drop every snapshotted record.  Restore the "
            "snapshot from a replica or backup (move it back over "
            f"{path}), or accept the loss explicitly by deleting the "
            "quarantined file AND the store directory's WAL files to "
            "start empty."
        )


class StorageHealth:
    """Read-only latch + re-arm probe for one store directory.

    ``probe_fn`` must raise ``OSError`` while the storage is still bad
    and return cleanly once durable writes work again (DurableStore
    passes a write+fsync probe that also reopens the WAL past any torn
    tail)."""

    def __init__(
        self,
        probe_fn: Callable[[], None],
        probe_interval_s: Optional[float] = None,
    ):
        self._probe_fn = probe_fn
        self.probe_interval_s = (
            probe_interval_s
            if probe_interval_s is not None
            else env_float("DGRAPH_TPU_STORAGE_PROBE_S", 2.0)
        )
        self._lock = threading.Lock()
        self._readonly = False
        self._stopped = False
        # cooldown-FIRST re-arm loop: the shared discipline
        # (utils/health.py CooldownProbeLoop — the peer breaker and the
        # device guard probe the same way): the fault just happened,
        # and re-proving the disk in the same microsecond mostly proves
        # nothing (a failpoint-injected or transient fault would re-arm
        # instantly and flap) — give the condition one interval to clear
        self._probe_loop = CooldownProbeLoop(
            self.probe_now,
            self.probe_interval_s,
            self._probing_active,
            name="dgraph-storage-probe",
        )
        self.errors = 0
        self.rearms = 0
        self.last_error = ""
        self.last_site = ""

    def readonly(self) -> bool:
        return self._readonly

    def note_error(self, site: str, exc: BaseException) -> None:
        """Record a storage fault and latch read-only mode; idempotent
        under a storm of concurrent faults (one probe thread only)."""
        STORAGE_ERRORS.add(site)
        with self._lock:
            self.errors += 1
            self.last_error = f"{type(exc).__name__}: {exc}"
            self.last_site = site
            if not self._readonly:
                self._readonly = True
                STORAGE_READONLY.set(1)
                print(
                    f"# storage fault at {site}: {self.last_error}; "
                    "entering READ-ONLY mode (mutations shed 503, reads "
                    "keep serving; re-arm probe every "
                    f"{self.probe_interval_s:g}s)",
                    file=sys.stderr,
                )
            stopped = self._stopped
        if not stopped:
            # idempotent under a storm of concurrent faults — the loop
            # spawns at most one prober thread
            self._probe_loop.start()

    def note_ok(self) -> None:
        with self._lock:
            if self._readonly:
                self._readonly = False
                self.rearms += 1
                STORAGE_READONLY.set(0)
                print(
                    "# storage probe succeeded; write path RE-ARMED",
                    file=sys.stderr,
                )

    def probe_now(self) -> bool:
        """One synchronous probe (tests; the loop calls this too)."""
        try:
            self._probe_fn()
        except OSError:
            return False
        self.note_ok()
        return True

    def _probing_active(self) -> bool:
        with self._lock:
            return not self._stopped and self._readonly

    def stop(self) -> None:
        with self._lock:
            self._stopped = True

    def status(self) -> dict:
        with self._lock:
            return {
                "readonly": self._readonly,
                "errors": self.errors,
                "rearms": self.rearms,
                "last_error": self.last_error,
                "last_site": self.last_site,
            }


class Snapshotter:
    """Background snapshot/compaction driver for one DurableStore.

    ``exclusive`` is a zero-arg callable returning a context manager
    granting WRITE exclusivity over the store (DgraphServer passes its
    engine write lock) — held only for the seal (rename + reopen, no
    serialization); ``None`` means the caller guarantees no concurrent
    writers (tests).  Compaction then runs off the write path entirely:
    it replays snapshot + sealed segments into a scratch store, so reads
    AND writes proceed while the new snapshot is built (memory cost: one
    extra copy of the snapshotted state, the price of zero write-path
    stalls)."""

    def __init__(
        self,
        store,
        exclusive: Optional[Callable[[], object]] = None,
        wal_mb: Optional[float] = None,
        wal_records: Optional[int] = None,
        interval_s: float = 1.0,
    ):
        self._store = store
        self._exclusive = exclusive
        self.wal_bytes = int(
            (wal_mb if wal_mb is not None
             else env_float("DGRAPH_TPU_SNAPSHOT_WAL_MB", 64.0)) * (1 << 20)
        )
        self.wal_records = (
            wal_records
            if wal_records is not None
            else env_int("DGRAPH_TPU_SNAPSHOT_WAL_RECORDS", 200_000)
        )
        self.interval_s = interval_s
        self._cond = threading.Condition()
        self._stopped = False
        self._req = 0         # explicit trigger requests issued
        self._served = 0      # highest request a COMPLETED round observed
        #                       BEFORE its seal — a waiter is only
        #                       satisfied by a round whose seal covers
        #                       every record journaled before its request
        self._last_ok = True  # did the latest round actually snapshot?
        self._last_error = ""
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="dgraph-snapshotter", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def trigger(self, wait: bool = False, timeout: float = 60.0) -> bool:
        """Request a snapshot now (``/admin/snapshot``).  With ``wait``,
        block until a round that STARTED after this request completed
        (False on timeout) — a round already mid-compaction when the
        request lands sealed too early to cover it and does not count."""
        with self._cond:
            if self._stopped:
                return False
            self._req += 1
            my = self._req
            self._cond.notify_all()
            if not wait:
                return True
            ok = self._cond.wait_for(
                lambda: self._served >= my or self._stopped, timeout=timeout
            )
            return bool(ok) and self._served >= my and self._last_ok

    def due(self) -> bool:
        import os

        store = self._store
        try:
            size = os.path.getsize(store.wal_path)
        except OSError:
            size = 0
        WAL_BYTES.set(size)
        return size >= self.wal_bytes or store.wal.count >= self.wal_records

    def snapshot_once(self) -> bool:
        """One seal+compact round; False (and a counted storage error)
        when the disk refused.  Runs on the loop thread or inline from
        tests."""
        store = self._store
        if getattr(store, "storage_readonly", lambda: False)():
            return False  # a faulted disk cannot take a snapshot either
        try:
            if self._exclusive is not None:
                with self._exclusive():
                    store.seal_segment()
            else:
                store.seal_segment()
            store.compact()
        except OSError as e:
            # seal/compact faults latch read-only via the store's own
            # guards; anything that slipped past still must not kill
            # the snapshotter thread
            # graftlint: shared[_last_error] GIL-atomic string store read only by stats(); last-error-wins is the intended semantics when the loop thread and an inline test caller both fail
            self._last_error = f"{type(e).__name__}: {e}"
            return False
        except ValueError as e:
            # strict replay of the existing snapshot failed during
            # compaction: disk rot after a clean boot.  Keep serving
            # (reads are from memory) but say so loudly.
            self._last_error = f"{type(e).__name__}: {e}"
            STORAGE_ERRORS.add("wal.compact")
            print(
                f"# snapshot compaction failed: {e}; WAL keeps growing "
                "until the snapshot file is repaired",
                file=sys.stderr,
            )
            return False
        self._refresh_age()
        return True

    def _refresh_age(self) -> None:
        # one implementation of snapshot age, owned by the store
        # (models/wal.py _snapshot_age)
        age_fn = getattr(self._store, "_snapshot_age", None)
        age = age_fn() if age_fn is not None else None
        if age is not None:
            SNAPSHOT_AGE.set(age)

    def _loop(self) -> None:
        while True:
            with self._cond:
                if self._stopped:
                    return
                if self._req == self._served:
                    # idle: poll the thresholds each interval; a trigger
                    # notify cuts the wait short
                    self._cond.wait(timeout=self.interval_s)
                if self._stopped:
                    return
                # every request issued BEFORE this read is covered by
                # this round's seal (the seal happens after, under the
                # caller's exclusivity)
                serving = self._req
            explicit = serving > self._served
            ran = explicit or self.due()
            fired = self.snapshot_once() if ran else False
            self._refresh_age()
            with self._cond:
                if ran:
                    # an explicit trigger round completes even when the
                    # disk refused — the waiter gets its answer either
                    # way, with _last_ok telling success apart
                    self._last_ok = fired
                self._served = serving
                self._cond.notify_all()
