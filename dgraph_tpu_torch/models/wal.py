"""Write-ahead log + snapshots: the durability layer (copy of
``dgraph_tpu/models/wal.py``; its files are byte-identical to the
reference's, so a store directory written by either package recovers
in the other).

Equivalent of the reference's raftwal/wal.go (entry log in Badger) plus
posting's dirty-sync contract (posting/lists.go:47-58: snapshots only up
to the synced watermark).  Design: every mutation is appended to an
append-only CRC-framed log *before* it is applied to the in-memory
store; a snapshot is the compacted log — the full state re-encoded as
the same record stream — written atomically, after which the covered
log files are deleted.  Recovery = replay snapshot records, then sealed
segments, then the active WAL; a torn tail (crash mid-append) is
detected by CRC/length and truncated, like Badger's value-log replay.

File layout in the store directory:
  snapshot.bin      magic "DGTPSNP1" + record stream
  wal-<n>.seg       sealed (fully fsynced) log segments awaiting compaction
  wal.log           the active record stream
Record framing: u32 payload-length | u32 crc32(payload) | payload.

Snapshotting is a two-phase seal/compact (draft.go:849 snapshot + wal
truncation analog, made safe against concurrent writers): ``seal``
durably renames the active log to a segment and reopens fresh — the
only step needing write exclusivity, microseconds; ``compact`` then
replays snapshot+segments into a scratch store OFF the write path and
atomically installs the new snapshot before deleting the segments it
folded.  A crash between install and delete merely replays the
segments twice — every record type is last-writer-wins per key or an
idempotent union, so re-applying an already-folded prefix is a fixpoint.

Durability modes: ``sync_writes`` fsyncs before acknowledging, as
before; :meth:`DurableStore.enable_group_commit` lets a serving layer
move that fsync OUT of its exclusive section into a shared
:meth:`DurableStore.sync_barrier` so concurrent writers amortize one
fsync (leader/follower group commit — the reference's gentle-commit
batching applied to fsyncs).

Disk faults (ENOSPC/EIO/injected) latch the store read-only via
:class:`~dgraph_tpu_torch.models.durability.StorageHealth`: mutations raise
:class:`~dgraph_tpu_torch.models.durability.StorageFaultError` (503 at the
serving layer), reads keep working, and a background probe re-arms the
write path — reopening the WAL past any torn tail first, so post-fault
appends can never land after garbage and become unreachable to replay.
"""

from __future__ import annotations

import os
import re
import struct
import sys
import threading
import time
import zlib
from typing import Callable, Iterator, List, Optional

from dgraph_tpu_torch import obs
from dgraph_tpu_torch.models import codec
from dgraph_tpu_torch.models.durability import (
    SnapshotCorruptError,
    StorageFaultError,
    StorageHealth,
)
from dgraph_tpu_torch.models.schema import parse_schema
from dgraph_tpu_torch.models.store import Edge, PostingStore
from dgraph_tpu_torch.models.uids import UidMap
from dgraph_tpu_torch.utils.atomicio import atomic_write_file, fsync_dir
from dgraph_tpu_torch.utils.failpoints import fail
from dgraph_tpu_torch.utils.metrics import (
    GROUP_COMMIT_SYNCS,
    GROUP_COMMIT_WRITES,
    RECOVERY_RECORDS,
    RECOVERY_SECONDS,
    RECOVERY_TORN_BYTES,
    SNAPSHOT_AGE,
    SNAPSHOTS,
    WAL_SEGMENTS,
)

_MAGIC = b"DGTPSNP1"
_HDR = struct.Struct("<II")
_SEG_RE = re.compile(r"^wal-(\d+)\.seg$")


class Wal:
    """Append-only CRC-framed record log (raftwal analog).

    Appends must be serialized by the caller (the engine write lock, the
    raft loop thread, or a batch context) — appends are NOT internally
    locked.  :meth:`sync_upto` is safe from any thread."""

    def __init__(self, path: str, sync: bool = False):
        self.path = path
        self.sync = sync
        # group-commit mode (DurableStore.enable_group_commit): flush()
        # stops fsyncing; callers ack only after sync_upto()
        self.group_commit = False
        self._f = open(path, "ab")
        self.count = 0  # records appended this session
        self._seq = 0          # appends issued (caller-serialized)
        self._flushed_seq = 0  # pushed to the OS through
        self._synced_seq = 0   # fsynced through
        # leader/follower fsync: the first barrier in holds the lock
        # through ONE fsync; followers blocked on the lock find their
        # seq already covered when they get in and return without I/O
        self._sync_lock = threading.Lock()

    def append(self, payload: bytes) -> None:
        fail.point("wal.append")
        # the frame is built in ONE buffer and written with ONE call: an
        # exception mid-append (or a future concurrent writer) can never
        # leave a header in the file with a foreign/absent payload
        self._f.write(_HDR.pack(len(payload), zlib.crc32(payload)) + payload)
        self.count += 1
        self._seq += 1

    def flush(self) -> None:
        fail.point("wal.flush")
        seq = self._seq
        self._f.flush()
        if seq > self._flushed_seq:
            self._flushed_seq = seq
        if self.sync and not self.group_commit:
            with self._sync_lock:
                os.fsync(self._f.fileno())
                fail.point("wal.post_flush")
                if seq > self._synced_seq:
                    self._synced_seq = seq

    def sync_upto(self, seq: Optional[int] = None) -> None:
        """Group-commit barrier: make every record appended+flushed
        through ``seq`` (default: all so far) durable, sharing fsyncs —
        barriers that queue behind a leader's fsync covering their seq
        return without touching the disk.

        Sampled mutations record the barrier as a span
        (``wal.group_commit``): its duration is the ack's durability
        cost, and the ``fsync`` attr says whether THIS writer led the
        fsync or rode a leader's."""
        if not self.sync:
            return
        if seq is None:
            seq = self._seq
        sp = obs.current_span()
        if sp is None:
            self._sync_upto(seq)
            return
        with sp.child("wal.group_commit") as bs:
            bs.set_attr("seq", seq)
            bs.set_attr("fsync", self._sync_upto(seq))

    def _sync_upto(self, seq: int) -> bool:
        """The barrier proper; True when this caller LED an fsync."""
        GROUP_COMMIT_WRITES.add(1)
        with self._sync_lock:
            if self._synced_seq >= seq:
                return False  # a leader's fsync already covered us
            target = self._flushed_seq
            os.fsync(self._f.fileno())
            fail.point("wal.post_flush")
            GROUP_COMMIT_SYNCS.add(1)
            if target > self._synced_seq:
                self._synced_seq = target
            return True

    def close(self) -> None:
        self.flush()
        if self.sync and self.group_commit:
            # flush() skipped the fsync in group-commit mode; a clean
            # close must still leave everything durable
            os.fsync(self._f.fileno())
        self._f.close()

    def reset(self) -> None:
        """Truncate in place (raft log rewrite after a raft snapshot;
        the store WAL compacts via seal/compact instead)."""
        with self._sync_lock:
            self._f.close()
            self._f = open(self.path, "wb")
            self.count = 0
        self.flush()

    def seal(self, seg_path: str) -> None:
        """Durably rename the active log to ``seg_path`` and reopen
        fresh.  Caller must hold append exclusivity; the segment is
        fully fsynced BEFORE the rename, so a sealed file never has a
        torn tail."""
        self.flush()
        with self._sync_lock:
            os.fsync(self._f.fileno())
            self._synced_seq = self._flushed_seq
            fail.point("wal.seal")
            self._f.close()
            # rename of a fully-synced file: atomic without a tmp hop
            os.replace(self.path, seg_path)  # graftlint: ignore[naked-atomic-write]
            fsync_dir(os.path.dirname(os.path.abspath(self.path)))
            self._f = open(self.path, "ab")
            self.count = 0

    def rearm(self) -> None:
        """Recover the handle after a storage fault: drop any half-
        written tail (a failed append/flush can leave a torn frame) so
        post-fault appends never land after garbage and vanish from
        replay, then reopen.  Callers guarantee no append is in flight
        (mutations are shed while the store is read-only)."""
        with self._sync_lock:
            try:
                self._f.close()
            except OSError:
                pass
            for _ in replay_records(self.path, truncate_torn=True):
                pass
            self._f = open(self.path, "ab")


def replay_records(
    path: str,
    truncate_torn: bool = True,
    strict: bool = False,
    stats: Optional[dict] = None,
) -> Iterator[bytes]:
    """Yield record payloads; stop at (and optionally cut) a torn tail.
    ``strict`` raises instead — for atomically-written files (snapshots)
    where a bad record is corruption, not a crash artifact, and loading
    a partial state would silently lose data.

    Frames are streamed with a bounded buffer (one chunk + the largest
    in-flight record), so recovering a multi-GB WAL does not double
    resident memory.  ``stats`` (optional dict) receives ``records``,
    ``bytes`` and ``torn_bytes`` when the iterator is exhausted."""
    if stats is not None:
        stats.setdefault("records", 0)
        stats.setdefault("bytes", 0)
        stats.setdefault("torn_bytes", 0)
    if not os.path.exists(path):
        return
    chunk_size = 1 << 20
    buf = bytearray()
    base = 0          # file offset of buf[0]
    good_end = 0      # file offset after the last valid record
    size = 0
    bad = False       # CRC/garbage hit: stop yielding, keep sizing
    with open(path, "rb") as f:
        head = f.read(len(_MAGIC))
        size += len(head)
        if head == _MAGIC:
            base = good_end = len(_MAGIC)
        else:
            buf.extend(head)
        while True:
            pos = 0  # parse offset within buf
            n = len(buf)
            while not bad and pos + _HDR.size <= n:
                length, crc = _HDR.unpack_from(buf, pos)
                start = pos + _HDR.size
                end = start + length
                if end > n:
                    break  # need more bytes (or it's the torn tail)
                # one copy of the record (slicing the bytearray first
                # would make two): a 336 MB bulk record costs one buffer
                # of it here, never three
                with memoryview(buf) as mv:
                    payload = bytes(mv[start:end])
                if zlib.crc32(payload) != crc:
                    if strict:
                        raise ValueError(
                            f"{path}: CRC mismatch at offset {base + pos}"
                        )
                    bad = True
                    break
                yield payload
                if stats is not None:
                    stats["records"] += 1
                pos = end
                good_end = base + end
            if pos:
                del buf[:pos]
                base += pos
            chunk = f.read(chunk_size)
            if not chunk:
                break
            size += len(chunk)
            if not bad:
                buf.extend(chunk)
    # whatever remains past good_end is a torn tail / trailing garbage
    torn = size - good_end
    if strict and torn:
        # distinguish the messages the old reader produced: a header
        # promising more bytes than exist is a truncated record; bytes
        # shorter than a header are trailing garbage
        if len(buf) >= _HDR.size and not bad:
            raise ValueError(f"{path}: truncated record at offset {good_end}")
        raise ValueError(f"{path}: trailing garbage at offset {good_end}")
    if stats is not None:
        stats["bytes"] = size
        stats["torn_bytes"] = torn
    if truncate_torn and torn:
        with open(path, "r+b") as f:
            f.truncate(good_end)


def apply_record(store: PostingStore, payload: bytes):
    """Apply one record to a store WITHOUT journaling — used for WAL/
    snapshot replay, Raft committed-entry application, and replica
    catch-up (the processMutation → posting apply path, draft.go:514).
    Returns the touched predicate name (or None for non-predicate
    records) so replicas can version predicates individually."""
    tag = payload[0]
    if tag == codec.EDGE:
        e = codec.decode_edge(payload)
        PostingStore.apply(store, e)
        return e.pred
    elif tag == codec.SCHEMA:
        text, _ = codec.get_str(payload, 1)
        parse_schema(text, into=store.schema)
        # schema semantics (index/reverse/type) change how EVERY
        # predicate reads: bump the version and the IVM floor exactly
        # like a live apply_schema, so replica-backed caches (and the
        # cluster version clock's floor) observe the change
        store.version += 1
        note = getattr(store, "note_global_change", None)
        if note is not None:
            note()
    elif tag == codec.XID:
        xid, pos = codec.get_str(payload, 1)
        uid, _ = codec.uvarint(payload, pos)
        # first write wins: concurrent assigns of one xid race their XID
        # records through the metadata group; applying in log order with
        # setdefault makes every replica agree on the winner
        store.uids._xid_to_uid.setdefault(xid, uid)
        store.uids.reserve_through(uid)
    elif tag == codec.LEASE:
        nxt, _ = codec.uvarint(payload, 1)
        store.uids.reserve_through(nxt - 1)
    elif tag == codec.BULKEDGES:
        pred, src, dst = codec.decode_bulk_edges(payload)
        PostingStore.bulk_set_uid_edges(store, pred, src, dst)
        return pred
    elif tag == codec.BULKVALS:
        pred, items = codec.decode_bulk_values(payload)
        PostingStore.bulk_set_values(store, pred, items)
        return pred
    elif tag == codec.DELPRED:
        pred, _ = codec.get_str(payload, 1)
        PostingStore.delete_predicate(store, pred)
        return pred
    elif tag == codec.MEMBER:
        nid, addr, groups = codec.decode_member(payload)
        store.members[nid] = (addr, tuple(groups))
        hook = getattr(store, "member_hook", None)
        if hook is not None:
            hook(nid, addr, groups)
    else:
        raise ValueError(f"unknown WAL record tag {tag:#x}")
    return None


def iter_state_records(store: PostingStore):
    """Encode a store's full state as a record stream (compacted log).
    Used for snapshots, replica catch-up (worker/predicate.go
    populateShard analog) and binary export."""
    text = store.schema.to_text()
    if text:
        yield codec.encode_schema(text)
    for nid, (addr, groups) in sorted(store.members.items()):
        yield codec.encode_member(nid, addr, groups)
    for xid, uid in sorted(store.uids.snapshot().items(), key=lambda kv: kv[1]):
        yield codec.encode_xid(xid, uid)
    yield codec.encode_lease(store.uids._next)
    for pred in store.predicates():
        pd = store.pred(pred)
        for src in sorted(pd.edges):
            for dst in sorted(pd.edges[src]):
                yield codec.encode_edge(
                    Edge(pred=pred, src=src, dst=dst,
                         facets=pd.edge_facets.get((src, dst)))
                )
        for (src, lang) in sorted(pd.values):
            yield codec.encode_edge(
                Edge(pred=pred, src=src, value=pd.values[(src, lang)],
                     lang=lang, facets=pd.value_facets.get(src))
            )


class _JournaledUidMap(UidMap):
    """UidMap that journals new xid assignments and lease movement."""

    def __init__(self, journal: Callable[[bytes], None]):
        super().__init__()
        self._journal: Optional[Callable[[bytes], None]] = journal

    def assign(self, xid: str) -> int:
        known = xid in self._xid_to_uid
        uid = super().assign(xid)
        if not known and self._journal is not None:
            self._journal(codec.encode_xid(xid, uid))
        return uid

    def fresh(self, n: int = 1) -> List[int]:
        out = super().fresh(n)
        if self._journal is not None:
            self._journal(codec.encode_lease(self._next))
        return out

    def reserve_through(self, uid: int) -> None:
        moved = uid >= self._next
        super().reserve_through(uid)
        if moved and self._journal is not None:
            self._journal(codec.encode_lease(self._next))


class DurableStore(PostingStore):
    """PostingStore journaled to a WAL with atomic snapshots.

    The write path mirrors the reference's raft-then-apply order
    (worker/draft.go:514 processMutation → posting apply): journal
    first, apply second, so recovery can always re-apply.
    """

    def __init__(self, directory: str, sync_writes: bool = False):
        super().__init__()
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.snapshot_path = os.path.join(directory, "snapshot.bin")
        self.wal_path = os.path.join(directory, "wal.log")
        self._replaying = True
        self._in_batch = False
        self._group_commit = False
        self.applied_index = 0  # records applied (watermark analog)
        self._compact_lock = threading.Lock()
        # guards the _segments LIST only (compact holds _compact_lock for
        # its whole replay+write; a seal on the write path must never
        # queue behind that — it only needs the list for a microsecond)
        self._seg_lock = threading.Lock()
        # boot hygiene: a crash mid-compaction leaves a half-written tmp
        for name in os.listdir(directory):
            if name.endswith(".tmp"):
                try:
                    os.unlink(os.path.join(directory, name))
                except OSError:
                    pass
        # recover: snapshot stream, then sealed segments, then wal stream
        t0 = time.monotonic()
        snap_stats: dict = {}
        seg_stats: dict = {}
        wal_stats: dict = {}
        try:
            for payload in replay_records(
                self.snapshot_path, truncate_torn=False, strict=True,
                stats=snap_stats,
            ):
                apply_record(self, payload)
                self.applied_index += 1
        except ValueError as e:
            # quarantine the bad file and refuse to boot with an
            # actionable message — silently replaying WAL-only would
            # lose every snapshotted record (models/durability.py)
            corrupt = self.snapshot_path + ".corrupt"
            # preserving evidence, not writing durable state: plain rename
            os.replace(self.snapshot_path, corrupt)  # graftlint: ignore[naked-atomic-write]
            fsync_dir(directory)
            raise SnapshotCorruptError(
                self.snapshot_path, corrupt, str(e)
            ) from e
        self._segments = self._list_segments()
        self._seal_counter = 0
        for seg in self._segments:
            # sealed segments were fully fsynced before their rename, so
            # a torn tail here is disk damage, not a crash artifact —
            # still replay the good prefix (lenient), but never truncate
            # a sealed file in place
            for payload in replay_records(
                seg, truncate_torn=False, stats=seg_stats
            ):
                apply_record(self, payload)
                self.applied_index += 1
        for payload in replay_records(self.wal_path, stats=wal_stats):
            apply_record(self, payload)
            self.applied_index += 1
        self._replaying = False
        self.wal = Wal(self.wal_path, sync=sync_writes)
        self.uids = self._rebind_uids()
        self.health = StorageHealth(self._storage_probe)
        self._record_recovery(t0, snap_stats, seg_stats, wal_stats)

    # -- recovery observability ---------------------------------------------

    def _record_recovery(self, t0, snap_stats, seg_stats, wal_stats) -> None:
        dur = time.monotonic() - t0
        torn = wal_stats.get("torn_bytes", 0) + seg_stats.get("torn_bytes", 0)
        total = (
            snap_stats.get("records", 0)
            + seg_stats.get("records", 0)
            + wal_stats.get("records", 0)
        )
        age = self._snapshot_age()
        self.recovery = {
            "snapshot_records": snap_stats.get("records", 0),
            "segment_records": seg_stats.get("records", 0),
            "wal_records": wal_stats.get("records", 0),
            "segments": len(self._segments),
            "torn_bytes": torn,
            "duration_s": round(dur, 4),
            "snapshot_age_s": None if age is None else round(age, 1),
        }
        RECOVERY_RECORDS.set(total)
        RECOVERY_TORN_BYTES.set(torn)
        RECOVERY_SECONDS.set(dur)
        if age is not None:
            SNAPSHOT_AGE.set(age)
        if total or torn:
            r = self.recovery
            print(
                f"# recovery {self.dir}: "
                f"snapshot_records={r['snapshot_records']} "
                f"segments={r['segments']} "
                f"segment_records={r['segment_records']} "
                f"wal_records={r['wal_records']} "
                f"torn_bytes={r['torn_bytes']} "
                f"duration={r['duration_s']}s "
                f"snapshot_age={r['snapshot_age_s']}s",
                file=sys.stderr,
            )

    def _snapshot_age(self) -> Optional[float]:
        try:
            mtime = os.path.getmtime(self.snapshot_path)
        except OSError:
            return None
        # wall-clock minus file mtime: mtimes ARE wall clock
        return max(0.0, time.time() - mtime)  # graftlint: ignore[wallclock-duration]

    def _list_segments(self) -> List[str]:
        segs = []
        for name in os.listdir(self.dir):
            m = _SEG_RE.match(name)
            if m:
                segs.append((int(m.group(1)), os.path.join(self.dir, name)))
        return [p for _n, p in sorted(segs)]

    # -- journaling hooks ---------------------------------------------------

    def _rebind_uids(self) -> UidMap:
        jm = _JournaledUidMap(self._journal_durable)
        jm._xid_to_uid = self.uids._xid_to_uid
        jm._next = self.uids._next
        return jm

    def _storage_fault(self, site: str, exc: OSError) -> None:
        """Latch read-only mode and surface the fault as the serving
        layer's retriable class."""
        self.health.note_error(site, exc)
        raise StorageFaultError(
            f"storage fault at {site}: {exc}",
            retry_after=self.health.probe_interval_s,
        ) from exc

    def _append_guarded(self, payload: bytes) -> None:
        try:
            self.wal.append(payload)
        except StorageFaultError:
            raise
        except OSError as e:
            self._storage_fault("wal.append", e)

    def _flush_guarded(self) -> None:
        try:
            self.wal.flush()
        except StorageFaultError:
            raise
        except OSError as e:
            self._storage_fault("wal.flush", e)

    def _journal(self, payload: bytes) -> None:
        if not self._replaying:
            self._append_guarded(payload)

    def _journal_durable(self, payload: bytes) -> None:
        """Journal + flush: uid handouts must be durable before the uid is
        visible to a client, or a crash re-issues it and a new entity
        aliases the old one's postings (lease.py's contract).  Under
        group commit "visible to a client" means after the serving
        layer's sync_barrier, which covers this append too."""
        if not self._replaying:
            self._append_guarded(payload)
            if not self._in_batch:
                self._flush_guarded()

    # -- group commit --------------------------------------------------------

    def enable_group_commit(self) -> None:
        """Serving-layer opt-in (DGRAPH_TPU_GROUP_COMMIT, default on with
        --sync): apply() stops fsyncing inside the caller's exclusive
        section; the caller PROMISES to run :meth:`sync_barrier` after
        each mutation BEFORE acknowledging it, outside that section, so
        concurrent writers share one fsync.  Library users who never
        opt in keep the fsync-per-acknowledged-write contract."""
        if self.wal.sync:
            self._group_commit = True
            self.wal.group_commit = True

    def sync_barrier(self) -> None:
        """Block until everything journaled so far is fsynced (one
        shared fsync per convoy of concurrent writers).  No-op unless
        group commit is enabled."""
        if not self._group_commit:
            return
        try:
            self.wal.sync_upto()
        except StorageFaultError:
            raise
        except OSError as e:
            self._storage_fault("wal.sync", e)

    # -- storage health ------------------------------------------------------

    def storage_readonly(self) -> bool:
        return self.health.readonly()

    def _storage_probe(self) -> None:
        """Re-arm probe: prove the directory takes durable writes, then
        reopen the WAL past any torn tail.  Raises OSError while bad."""
        probe = os.path.join(self.dir, ".probe")
        with open(probe, "wb") as f:
            f.write(b"ok")
            f.flush()
            os.fsync(f.fileno())
        os.unlink(probe)
        self.wal.rearm()

    def storage_status(self) -> dict:
        st = self.health.status()
        try:
            wal_bytes = os.path.getsize(self.wal_path)
        except OSError:
            wal_bytes = 0
        age = self._snapshot_age()
        st.update(
            wal_bytes=wal_bytes,
            wal_records=self.wal.count,
            sealed_segments=len(self._segments),
            snapshot_age_s=None if age is None else round(age, 1),
            last_recovery=self.recovery,
            sync=self.wal.sync,
            group_commit=self._group_commit,
        )
        return st

    # -- the write path -----------------------------------------------------

    def batch(self):
        """Context manager deferring WAL flushes to the end of a multi-
        record operation (gentle-commit batching, posting/lists.go:109)."""
        import contextlib

        @contextlib.contextmanager
        def _cm():
            self._in_batch = True
            try:
                yield self
            finally:
                self._in_batch = False
                self._flush_guarded()

        return _cm()

    def apply(self, e: Edge) -> None:
        if e.op not in ("set", "del"):  # validate BEFORE journaling: a
            # rejected mutation must not resurface from the WAL on restart
            raise ValueError(f"unknown mutation op {e.op!r}")
        self._journal(codec.encode_edge(e))
        super().apply(e)
        self.applied_index += 1
        # an acknowledged single write must survive a process crash; batch
        # paths flush once at the end (gentleCommit analog)
        if not self._replaying and not self._in_batch:
            self._flush_guarded()

    def apply_many(self, edges, flush: bool = True) -> int:
        self._in_batch = True
        try:
            n = super().apply_many(edges)
        finally:
            self._in_batch = False
        if flush and not self._replaying:
            self._flush_guarded()
        return n

    def bulk_set_uid_edges(self, pred: str, src, dst) -> None:
        # one WAL record for the whole predicate group
        self._journal(codec.encode_bulk_edges(pred, src, dst))
        super().bulk_set_uid_edges(pred, src, dst)
        self.applied_index += 1
        if not self._replaying and not self._in_batch:
            self._flush_guarded()

    def bulk_set_values(self, pred: str, items) -> None:
        if not items:
            return
        self._journal(codec.encode_bulk_values(pred, items))
        super().bulk_set_values(pred, items)
        self.applied_index += 1
        if not self._replaying and not self._in_batch:
            self._flush_guarded()

    def apply_schema(self, text: str) -> None:
        parse_schema(text, into=self.schema)  # validate before journaling
        self._journal(codec.encode_schema(text))
        # schema semantics change how every predicate reads: bump the
        # version and the IVM floor as the replay's SCHEMA branch does
        # (the reference's live path bumps neither)
        self.version += 1
        self.note_global_change()
        self.applied_index += 1
        if not self._replaying:
            self._flush_guarded()

    def delete_predicate(self, pred: str) -> None:
        self._journal(codec.encode_delpred(pred))
        super().delete_predicate(pred)
        self.applied_index += 1
        if not self._replaying:
            self._flush_guarded()

    # -- snapshots ----------------------------------------------------------

    def seal_segment(self) -> Optional[str]:
        """Phase 1 (needs write exclusivity, microseconds): durably move
        the active WAL aside as a sealed segment and reopen fresh.
        Returns the segment path, or None when there is nothing to seal."""
        try:
            size = os.path.getsize(self.wal_path)
        except OSError:
            size = 0
        if size == 0 and self.wal.count == 0:
            return None
        with self._seg_lock:
            nxt = self._seal_counter
            if self._segments:
                m = _SEG_RE.match(os.path.basename(self._segments[-1]))
                if m:
                    nxt = max(nxt, int(m.group(1)) + 1)
            self._seal_counter = nxt + 1
        seg = os.path.join(self.dir, f"wal-{nxt:016d}.seg")
        try:
            self.wal.seal(seg)
        except StorageFaultError:
            raise
        except OSError as e:
            self._storage_fault("wal.seal", e)
        with self._seg_lock:
            self._segments.append(seg)
            WAL_SEGMENTS.set(len(self._segments))
        return seg

    def compact(self) -> None:
        """Phase 2 (no locks, off the write path): fold snapshot +
        sealed segments into a new snapshot installed atomically, then
        delete the folded segments.  State is rebuilt by REPLAY into a
        scratch store, never read from the live dicts — concurrent
        readers and writers proceed untouched (memory cost: one scratch
        copy of the snapshotted state).  Crash windows are all safe:
        before install the old snapshot + segments still recover; after
        install but before the deletes, the segments replay twice, which
        is a fixpoint (every record type is last-writer-wins per key or
        an idempotent union)."""
        with self._compact_lock:
            with self._seg_lock:
                segs = [s for s in self._segments if os.path.exists(s)]
            scratch = PostingStore()
            for payload in replay_records(
                self.snapshot_path, truncate_torn=False, strict=True
            ):
                apply_record(scratch, payload)
            for seg in segs:
                for payload in replay_records(seg, truncate_torn=False):
                    apply_record(scratch, payload)

            def chunks():
                yield _MAGIC
                for payload in iter_state_records(scratch):
                    yield _HDR.pack(
                        len(payload), zlib.crc32(payload)
                    ) + payload

            try:
                atomic_write_file(
                    self.snapshot_path, chunks(), site="wal.snapshot"
                )
                fail.point("wal.snapshot.installed")
                for seg in segs:
                    os.unlink(seg)
            except StorageFaultError:
                raise
            except OSError as e:
                self._storage_fault("wal.snapshot", e)
            with self._seg_lock:
                self._segments = [
                    s for s in self._segments if s not in segs
                ]
                WAL_SEGMENTS.set(len(self._segments))
            SNAPSHOTS.add(1)
            SNAPSHOT_AGE.set(0)

    def snapshot(self) -> None:
        """Synchronous seal + compact (draft.go:849 snapshot + wal
        truncation analog).  Callers guarantee no concurrent appends
        during the seal, as before; the background Snapshotter
        (models/durability.py) takes the seal under the serving write
        lock instead and compacts off it."""
        self.seal_segment()
        self.compact()

    def close(self) -> None:
        self.health.stop()
        self.wal.close()
