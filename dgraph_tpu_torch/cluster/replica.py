"""A replicated store group: Raft log → PostingStore replicas (copy of
``dgraph_tpu/cluster/replica.py``; batches, snapshots and predicate
streams are byte-identical to the reference's).

Equivalent of upstream Dgraph's per-group stack (worker/draft.go
processMutation → runMutations → posting apply): mutations are encoded
as codec record batches, proposed through the group's Raft node, and
applied to every replica's store when committed.  The Raft log IS the
durability layer here (the reference similarly persists raft WAL +
posting store; our snapshot = the store state record-stream, so a
restarted or lagging replica restores from it and replays the log
suffix — retrieveSnapshot, draft.go:679).
"""

from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import Dict, List, Optional

from dgraph_tpu_torch.models import codec
from dgraph_tpu_torch.models.store import Edge, PostingStore
from dgraph_tpu_torch.models.wal import apply_record, iter_state_records
from dgraph_tpu_torch.cluster.raft import RaftNode, RaftStorage, Transport

_HDR = struct.Struct("<II")


def encode_batch(records: List[bytes]) -> bytes:
    buf = bytearray()
    codec.put_uvarint(buf, len(records))
    for r in records:
        codec.put_uvarint(buf, len(r))
        buf.extend(r)
    return bytes(buf)


def decode_batch(data: bytes) -> List[bytes]:
    n, pos = codec.uvarint(data, 0)
    out = []
    for _ in range(n):
        ln, pos = codec.uvarint(data, pos)
        out.append(data[pos : pos + ln])
        pos += ln
    return out


def state_to_bytes(store: PostingStore) -> bytes:
    """Full store state as CRC-framed record stream (snapshot payload)."""
    buf = bytearray()
    for payload in iter_state_records(store):
        buf.extend(_HDR.pack(len(payload), zlib.crc32(payload)))
        buf.extend(payload)
    return bytes(buf)


def pred_to_bytes(store: PostingStore, pred: str) -> bytes:
    """One predicate's postings as a CRC-framed record stream — the
    payload of the cross-server read path (/pred-snapshot).  The analog of
    the reference's PredicateAndSchemaData shard stream
    (worker/predicate.go:71-201), scoped to one predicate."""
    pd = store.peek(pred)
    buf = bytearray()
    if pd is None:
        return bytes(buf)
    for src in sorted(pd.edges):
        for dst in sorted(pd.edges[src]):
            payload = codec.encode_edge(
                Edge(pred=pred, src=src, dst=dst,
                     facets=pd.edge_facets.get((src, dst)))
            )
            buf.extend(_HDR.pack(len(payload), zlib.crc32(payload)))
            buf.extend(payload)
    for (src, lang) in sorted(pd.values):
        payload = codec.encode_edge(
            Edge(pred=pred, src=src, value=pd.values[(src, lang)],
                 lang=lang, facets=pd.value_facets.get(src))
        )
        buf.extend(_HDR.pack(len(payload), zlib.crc32(payload)))
        buf.extend(payload)
    return bytes(buf)


def bytes_to_pred(data: bytes, pred: str):
    """Decode a pred_to_bytes stream into a standalone PredicateData."""
    tmp = PostingStore()
    pos = 0
    n = len(data)
    while pos + _HDR.size <= n:
        length, crc = _HDR.unpack_from(data, pos)
        start = pos + _HDR.size
        payload = data[start : start + length]
        if zlib.crc32(payload) != crc:
            raise ValueError("corrupt predicate snapshot payload")
        apply_record(tmp, payload)
        pos = start + length
    return tmp.peek(pred)


def bytes_to_state(data: bytes, store: PostingStore) -> None:
    """Replace store contents from a snapshot payload."""
    store._preds.clear()
    store.uids._xid_to_uid.clear()
    store.uids._next = 1
    store.members.clear()
    store.dirty.add("*")
    pos = 0
    n = len(data)
    while pos + _HDR.size <= n:
        length, crc = _HDR.unpack_from(data, pos)
        start = pos + _HDR.size
        payload = data[start : start + length]
        if zlib.crc32(payload) != crc:
            raise ValueError("corrupt snapshot payload")
        apply_record(store, payload)
        pos = start + length
    # full-store replacement: predicates absent from the snapshot kept
    # their old per-pred versions above — only an IVM floor bump makes
    # every footprint-keyed cache entry stale (ivm/versions.py)
    note = getattr(store, "note_global_change", None)
    if note is not None:
        note()


class ReplicatedGroup:
    """One server's replica of one group (draft.go node + its store)."""

    def __init__(
        self,
        node_id: str,
        group: int,
        peers: List[str],
        directory: str,
        transport: Transport,
        sync_writes: bool = False,
        **raft_opts,
    ):
        self.store = PostingStore()
        self.group = group
        # per-predicate change versions = the raft index of the last record
        # touching the predicate: durable-monotone across restarts and
        # identical on every replica (unlike a process-local counter, which
        # could repeat a value over different content after a restart and
        # make remote readers' 304 checks serve stale data forever)
        self.pred_versions: Dict[str, int] = {}
        self._lock = threading.Lock()  # guards store during apply/snapshot
        storage = RaftStorage(
            os.path.join(directory, f"raft-g{group}"), sync=sync_writes
        )
        self.node = RaftNode(
            node_id=node_id,
            group=group,
            peers=peers,
            storage=storage,
            transport=transport,
            apply_fn=self._apply_committed,
            snapshot_fn=self._snapshot_state,
            restore_fn=self._restore_state,
            **raft_opts,
        )

    def start(self) -> None:
        self.node.start()

    def stop(self) -> None:
        self.node.stop()

    def force_snapshot(self) -> None:
        """Compact this group's raft log now (/admin/snapshot's cluster
        leg): group replicas ride the same trigger machinery as the
        single-node store WAL's Snapshotter."""
        self.node.request_snapshot()

    # -- raft callbacks (loop thread) ---------------------------------------

    def _apply_committed(self, index: int, data: bytes) -> None:
        with self._lock:
            for payload in decode_batch(data):
                pred = apply_record(self.store, payload)
                if pred is not None:
                    self.pred_versions[pred] = index

    def _snapshot_state(self) -> bytes:
        with self._lock:
            return state_to_bytes(self.store)

    def _restore_state(self, data: bytes) -> None:
        if not data:
            return
        with self._lock:
            bytes_to_state(data, self.store)
            # every predicate in the snapshot is current as of its index
            snap_idx = self.node.storage.snap_index
            self.pred_versions = {
                p: snap_idx for p in self.store._preds.keys()
            }

    def pred_version(self, pred: str) -> int:
        """Caller holds _lock (or tolerates a racy read)."""
        return self.pred_versions.get(pred, 0)

    # -- public write path ---------------------------------------------------

    def propose_edges(
        self, edges: List[Edge], timeout: Optional[float] = None
    ) -> None:
        """MutateOverNetwork's per-group proposeOrSend (mutation.go:319)."""
        self.node.propose_and_wait(
            encode_batch([codec.encode_edge(e) for e in edges]), timeout
        )

    def propose_schema(self, text: str, timeout: Optional[float] = None) -> None:
        self.node.propose_and_wait(
            encode_batch([codec.encode_schema(text)]), timeout
        )

    def propose_records(
        self, records: List[bytes], timeout: Optional[float] = None
    ) -> None:
        self.node.propose_and_wait(encode_batch(records), timeout)
