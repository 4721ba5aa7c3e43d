"""Raft consensus for replication groups (copy of
``dgraph_tpu/cluster/raft.py``: its ``raft.log``, ``hardstate.bin``,
``snapshot.meta`` and ``snapshot.bin`` are byte-identical to the
reference's for the same entries).

Equivalent of upstream Dgraph's worker/draft.go + vendored etcd/raft +
raftwal/: one Raft node per (server × group) replicates a mutation log;
committed entries are applied to the group's DurableStore; snapshots
compact the log once applied state is durably synced (draft.go:827-877's
"snapshot only up to the synced watermark" contract).

Design: a single event-loop thread per node owns ALL state (the same
model as etcd/raft's Run loop, draft.go:709) — messages, proposals and
ticks arrive on one queue, so there are no data races by construction.
Safety-critical persistence (term/vote on change, log entries before
acking) goes through the same CRC-framed Wal as the store.

Transport is pluggable: InMemoryTransport for tests/embedded mode
(worker.Config.InMemoryComm analog), HTTP between server processes
(cluster/transport.py).
"""

from __future__ import annotations

import os
import queue
import random
import struct
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from dgraph_tpu_torch.models import codec
from dgraph_tpu_torch.models.wal import Wal, replay_records
from dgraph_tpu_torch.utils.atomicio import atomic_write_file
from dgraph_tpu_torch.utils.env import env_float, env_int
from dgraph_tpu_torch.utils.failpoints import fail


def propose_patience(timeout: Optional[float] = None) -> float:
    """How long a proposer waits for commit+apply before giving up.

    ``DGRAPH_TPU_PROPOSE_TIMEOUT`` overrides the 10s default (read at
    call time so tests can set it per-module): on a slow or instrumented
    host a single commit+apply round trip can exceed 10s, and a
    timed-out proposal invites the client to re-post a duplicate that
    queues behind the still-running original — patience here is what
    breaks that amplification loop.  An explicit ``timeout`` argument
    always wins."""
    if timeout is not None:
        return timeout
    return env_float("DGRAPH_TPU_PROPOSE_TIMEOUT", 10.0)

FOLLOWER, CANDIDATE, LEADER = "follower", "candidate", "leader"


@dataclass
class Entry:
    term: int
    index: int
    data: bytes


@dataclass
class VoteReq:
    term: int
    candidate: str
    last_log_index: int
    last_log_term: int
    # pre-vote (raft thesis §9.6 / etcd PreVote, the refinement the
    # reference gets from etcd/raft): a probe at term+1 that mutates NO
    # persistent state — a partitioned node rejoining cannot inflate the
    # cluster term and force a needless election
    pre: bool = False


@dataclass
class VoteResp:
    term: int
    granted: bool
    sender: str
    pre: bool = False


@dataclass
class TimeoutNow:
    """Leadership transfer (draft.go:788-805 TransferLeadership): the
    leader tells its most caught-up follower to campaign IMMEDIATELY
    (bypassing pre-vote and its own election timer), so a graceful stop
    hands off leadership with no availability gap."""

    term: int
    leader: str


@dataclass
class AppendReq:
    term: int
    leader: str
    prev_log_index: int
    prev_log_term: int
    entries: List[Entry]
    leader_commit: int


@dataclass
class AppendResp:
    term: int
    success: bool
    match_index: int
    sender: str


@dataclass
class SnapshotReq:
    term: int
    leader: str
    last_index: int
    last_term: int
    data: bytes


@dataclass
class SnapshotResp:
    term: int
    sender: str
    last_index: int


class Transport:
    """Delivers messages between nodes; implementations must be safe to
    call from the node loop thread."""

    def send(self, to: str, group: int, msg) -> None:  # pragma: no cover
        raise NotImplementedError


class InMemoryTransport(Transport):
    """Single-process delivery (embedded/InMemoryComm mode). Supports
    partitions for tests (cut/heal)."""

    def __init__(self):
        self.nodes: Dict[Tuple[str, int], "RaftNode"] = {}
        self._cut: set = set()
        self._lock = threading.Lock()

    def register(self, node: "RaftNode") -> None:
        with self._lock:
            self.nodes[(node.node_id, node.group)] = node

    def cut(self, a: str, b: str) -> None:
        with self._lock:
            self._cut.add((a, b))
            self._cut.add((b, a))

    def heal(self) -> None:
        with self._lock:
            self._cut.clear()

    def send(self, to: str, group: int, msg) -> None:
        with self._lock:
            sender = getattr(msg, "leader", None) or getattr(
                msg, "candidate", None
            ) or getattr(msg, "sender", None)
            if (sender, to) in self._cut:
                return
            node = self.nodes.get((to, group))
        if node is not None:
            node.deliver(msg)


# -- persistent state -------------------------------------------------------

_HS = struct.Struct("<QI")  # term, voted_for length follows


class RaftStorage:
    """Durable term/vote/log/snapshot (raftwal/wal.go analog).

    Layout in dir/: hardstate.bin (term + voted_for, atomic rewrite),
    raft.log (Wal of entries), snapshot.meta + snapshot.bin.
    """

    def __init__(self, directory: str, sync: bool = False):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self._hs_path = os.path.join(directory, "hardstate.bin")
        self._log_path = os.path.join(directory, "raft.log")
        self._snap_meta = os.path.join(directory, "snapshot.meta")
        self._snap_path = os.path.join(directory, "snapshot.bin")
        self.term = 0
        self.voted_for: Optional[str] = None
        self.snap_index = 0
        self.snap_term = 0
        self.entries: List[Entry] = []  # entries after snap_index
        t0 = time.monotonic()
        self._replay_stats: dict = {}
        self._load()
        self._wal = Wal(self._log_path, sync=sync)
        if self._replay_stats.get("records") or self._replay_stats.get(
            "torn_bytes"
        ):
            # the raft twin of DurableStore's recovery line: how much log
            # was replayed and whether a torn tail was cut
            import sys

            print(
                f"# recovery {directory}: snap_index={self.snap_index} "
                f"log_records={self._replay_stats.get('records', 0)} "
                f"torn_bytes={self._replay_stats.get('torn_bytes', 0)} "
                f"duration={time.monotonic() - t0:.4f}s",
                file=sys.stderr,
            )

    def _load(self) -> None:
        if os.path.exists(self._hs_path):
            with open(self._hs_path, "rb") as f:
                raw = f.read()
            self.term, vlen = _HS.unpack_from(raw, 0)
            self.voted_for = (
                raw[_HS.size : _HS.size + vlen].decode() if vlen else None
            )
        if os.path.exists(self._snap_meta):
            with open(self._snap_meta, "rb") as f:
                self.snap_index, self.snap_term = struct.unpack("<QQ", f.read(16))
        for payload in replay_records(self._log_path, stats=self._replay_stats):
            term, pos = codec.uvarint(payload, 0)
            index, pos = codec.uvarint(payload, pos)
            data = bytes(payload[pos:])
            # replay may contain superseded suffixes from old terms; a
            # later append with the same index overwrites (truncate-then-
            # append is recorded as re-append in the log stream)
            e = Entry(term, index, data)
            while self.entries and self.entries[-1].index >= index:
                self.entries.pop()
            if index > self.snap_index:
                self.entries.append(e)

    def save_hardstate(self, term: int, voted_for: Optional[str]) -> None:
        self.term, self.voted_for = term, voted_for
        v = (voted_for or "").encode()
        # durable BEFORE any vote/term is acted on (Raft's safety
        # prerequisite); crash sites raft.hardstate.{tmp,replace}
        atomic_write_file(
            self._hs_path, _HS.pack(term, len(v)) + v, site="raft.hardstate"
        )

    def append(self, entries: List[Entry]) -> None:
        fail.point("raft.log_append")
        for e in entries:
            buf = bytearray()
            codec.put_uvarint(buf, e.term)
            codec.put_uvarint(buf, e.index)
            buf.extend(e.data)
            self._wal.append(bytes(buf))
            while self.entries and self.entries[-1].index >= e.index:
                self.entries.pop()
            self.entries.append(e)
        self._wal.flush()

    def last_index(self) -> int:
        return self.entries[-1].index if self.entries else self.snap_index

    def last_term(self) -> int:
        return self.entries[-1].term if self.entries else self.snap_term

    def term_at(self, index: int) -> Optional[int]:
        if index == self.snap_index:
            return self.snap_term
        if index < self.snap_index:
            return None  # compacted away
        i = index - self.snap_index - 1
        if 0 <= i < len(self.entries):
            return self.entries[i].term
        return None

    def entries_from(self, index: int) -> List[Entry]:
        i = index - self.snap_index - 1
        if i < 0:
            return []
        return self.entries[i:]

    def entry_at(self, index: int) -> Optional[Entry]:
        i = index - self.snap_index - 1
        if 0 <= i < len(self.entries):
            return self.entries[i]
        return None

    def save_snapshot(self, index: int, term: int, data: bytes) -> None:
        """Install/record a snapshot and drop covered entries.  Order
        matters for crash safety: data first, META LAST — snap_index only
        advances once the data it points at is durably in place (a crash
        between the two replays the old snapshot + full log, which is
        merely slower, never wrong)."""
        atomic_write_file(self._snap_path, data, site="raft.snapshot")
        atomic_write_file(
            self._snap_meta, struct.pack("<QQ", index, term)
        )
        self.entries = [e for e in self.entries if e.index > index]
        self.snap_index, self.snap_term = index, term
        # rewrite the log with only the surviving suffix
        self._wal.reset()
        tail, self.entries = self.entries, []
        self.append(tail)

    def load_snapshot(self) -> Optional[bytes]:
        if not os.path.exists(self._snap_path) or self.snap_index == 0:
            return None
        with open(self._snap_path, "rb") as f:
            return f.read()

    def close(self) -> None:
        self._wal.close()


# -- the node ---------------------------------------------------------------

class RaftNode:
    """One replica of one group's log (draft.go node analog)."""

    def __init__(
        self,
        node_id: str,
        group: int,
        peers: List[str],
        storage: RaftStorage,
        transport: Transport,
        apply_fn: Callable[[int, bytes], None],
        snapshot_fn: Optional[Callable[[], bytes]] = None,
        restore_fn: Optional[Callable[[bytes], None]] = None,
        tick_ms: int = 15,
        election_ticks: int = 10,
        snapshot_threshold: Optional[int] = None,
        passive: bool = False,
    ):
        self.node_id = node_id
        self.group = group
        self.peers = [p for p in peers if p != node_id]
        self.storage = storage
        self.transport = transport
        self.apply_fn = apply_fn
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.tick_s = tick_ms / 1000.0
        self.election_ticks = election_ticks
        # raft-log compaction threshold: the raft leg of the snapshot
        # knob family (the store WAL has DGRAPH_TPU_SNAPSHOT_WAL_MB/
        # _RECORDS; /admin/snapshot force-compacts both planes)
        self.snapshot_threshold = (
            snapshot_threshold
            if snapshot_threshold is not None
            else env_int("DGRAPH_TPU_SNAPSHOT_RAFT_RECORDS", 10_000)
        )

        # passive: a joining node that does not yet know the membership —
        # it never campaigns (it would split-brain-elect itself with an
        # empty log) until activated by the first add_peer (JoinCluster
        # analog, draft.go:1049)
        self.passive = passive
        self.state = FOLLOWER
        self.leader_id: Optional[str] = None
        self.commit_index = storage.snap_index
        self.last_applied = storage.snap_index
        self.next_index: Dict[str, int] = {}
        self.match_index: Dict[str, int] = {}
        self.votes: set = set()
        self._prevotes: set = set()
        self._prevoting = False  # an open pre-vote round of OUR own
        # ticks since we last heard from a live leader — the pre-vote
        # stickiness clock.  Deliberately separate from _elapsed, which
        # our own election activity resets (etcd tracks these apart too).
        self._since_leader = 0
        self._transfer_target: Optional[str] = None
        self._transfer_ticks = 0
        self._transfer_sent = False
        self._elapsed = 0
        self._timeout = self._rand_timeout()
        self._inbox: "queue.Queue" = queue.Queue()
        self._pending: Dict[int, Future] = {}  # log index -> proposal future
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._applying_snapshot = False

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        snap = self.storage.load_snapshot()
        if snap is not None and self.restore_fn is not None:
            self.restore_fn(snap)
        self._thread = threading.Thread(
            target=self._run, name=f"raft-{self.node_id}-g{self.group}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._stop.is_set():  # idempotent: tests/admin can double-stop
            return
        # graceful-stop leadership transfer (draft.go:788-805): hand the
        # lead to the most caught-up follower and wait briefly for its
        # first heartbeat to demote us, so the group never waits out an
        # election timeout.  Crash-stops skip this naturally (no stop()).
        if self.state == LEADER and self.peers and self._thread is not None:
            # graftlint: shared[_transfer_sent] GIL-atomic bool handshake: stop() arms it False then polls; _run stores True exactly once — no compound update, staleness bounded by the poll sleep
            self._transfer_sent = False
            self._inbox.put(("transfer",))
            deadline = time.monotonic() + 2.0
            # exit on demotion (new leader's message reached us) OR once
            # TimeoutNow has flown plus a short grace — when our inbound
            # plane is already closing we can't observe the demotion, and
            # the handoff itself completes on the survivors' side
            while self.state == LEADER and time.monotonic() < deadline:
                if self._transfer_sent:
                    time.sleep(self.tick_s * 4)
                    break
                time.sleep(self.tick_s)
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.storage.close()

    def transfer_leadership(self) -> None:
        """Ask the most caught-up follower to take over (TimeoutNow)."""
        self._inbox.put(("transfer",))

    def request_snapshot(self) -> None:
        """Force a raft-log compaction regardless of threshold
        (/admin/snapshot's cluster leg).  Runs on the loop thread — the
        only thread allowed to touch storage — at the next dequeue."""
        self._inbox.put(("snapshot",))

    # -- public API (thread-safe) -------------------------------------------

    def deliver(self, msg) -> None:
        self._inbox.put(("msg", msg))

    def propose(self, data: bytes) -> Future:
        fut: Future = Future()
        self._inbox.put(("propose", data, fut))
        return fut

    def add_peer(self, nid: str) -> None:
        """Runtime membership addition (single-server change, the
        simplified ConfChange the reference gets from etcd/raft): the
        peer joins the replication set and — on the leader — starts
        receiving appends/snapshots immediately.  Idempotent."""
        self._inbox.put(("conf_add", nid))

    def remove_peer(self, nid: str) -> None:
        """Runtime membership removal: a MEMBER record declaring a peer's
        group placement excludes it from groups it does not serve — a
        voter that never answers would otherwise depress this group's
        quorum forever.  Idempotent; removing an absent peer is a no-op."""
        self._inbox.put(("conf_remove", nid))

    def propose_and_wait(self, data: bytes, timeout: Optional[float] = None):
        """draft.go:341 ProposeAndWait: block until applied or error."""
        return self.propose(data).result(timeout=propose_patience(timeout))

    @property
    def is_leader(self) -> bool:
        return self.state == LEADER

    # -- event loop ---------------------------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                item = self._inbox.get(timeout=self.tick_s)
            except queue.Empty:
                try:
                    self._tick()
                except Exception:  # noqa: BLE001
                    import traceback

                    traceback.print_exc()
                continue
            kind = item[0]
            try:
                if kind == "msg":
                    self._handle(item[1])
                elif kind == "propose":
                    self._handle_propose(item[1], item[2])
                elif kind == "conf_add":
                    self._handle_conf_add(item[1])
                elif kind == "conf_remove":
                    self._handle_conf_remove(item[1])
                elif kind == "transfer":
                    self._handle_transfer()
                elif kind == "snapshot":
                    self._maybe_snapshot(force=True)
            except Exception:  # noqa: BLE001 — a bad entry/storage error must
                # not silently kill the event loop and wedge the group
                import traceback

                traceback.print_exc()
                if kind == "propose" and not item[2].done():
                    item[2].set_exception(RuntimeError("raft apply failed"))

    def _rand_timeout(self) -> int:
        return self.election_ticks + random.randrange(self.election_ticks)

    def _tick(self) -> None:
        if self.state == LEADER:
            if self._transfer_target is not None:
                self._transfer_ticks -= 1
                if self._transfer_ticks <= 0:
                    self._finish_transfer()  # best effort at deadline
            self._broadcast_append()
            return
        if self.passive:
            return  # joining node: wait to be contacted, never campaign
        self._elapsed += 1
        self._since_leader += 1
        if self._elapsed >= self._timeout:
            self._prevote()

    def _handle_conf_add(self, nid: str) -> None:
        if nid == self.node_id:
            # learning only our OWN id must not activate a passive joiner:
            # with an empty peer list it would instantly self-elect and
            # force the real leader down when their messages cross
            return
        if nid not in self.peers:
            self.peers.append(nid)
            self.next_index[nid] = self.storage.last_index() + 1
            self.match_index[nid] = 0
            if self.state == LEADER:
                self._send_append(nid)
        # learning a real peer activates a passive joiner
        self.passive = False

    def _handle_transfer(self) -> None:
        if self.state != LEADER or not self.peers:
            return
        # flush our tail, pick the most caught-up peer, and hand off only
        # once it confirms our last index (etcd waits for catch-up before
        # MsgTimeoutNow); a tick-bounded deadline fires best-effort if the
        # confirmation never lands
        self._broadcast_append()
        target = max(self.peers, key=lambda p: self.match_index.get(p, 0))
        self._transfer_target = target
        self._transfer_ticks = self.election_ticks
        if self.match_index.get(target, 0) >= self.storage.last_index():
            self._finish_transfer()

    def _finish_transfer(self) -> None:
        target = self._transfer_target
        self._transfer_target = None
        if target is not None and self.state == LEADER:
            self.transport.send(
                target, self.group, TimeoutNow(self.storage.term, self.node_id)
            )
        self._transfer_sent = True

    def _handle_conf_remove(self, nid: str) -> None:
        if nid == self.node_id or nid not in self.peers:
            return
        self.peers.remove(nid)
        self.next_index.pop(nid, None)
        self.match_index.pop(nid, None)
        if self.state == LEADER:
            # quorum may have shrunk: entries waiting on the removed voter
            # can be committable now
            self._maybe_commit()

    # -- elections ----------------------------------------------------------

    def _prevote(self) -> None:
        """Probe electability at term+1 without touching persistent state;
        only a pre-vote majority starts a real (term-bumping) campaign."""
        if not self.peers:
            self._campaign()
            return
        self._prevotes = {self.node_id}
        self._prevoting = True
        self._elapsed = 0
        self._timeout = self._rand_timeout()
        req = VoteReq(
            term=self.storage.term + 1,
            candidate=self.node_id,
            last_log_index=self.storage.last_index(),
            last_log_term=self.storage.last_term(),
            pre=True,
        )
        for p in self.peers:
            self.transport.send(p, self.group, req)

    def _campaign(self) -> None:
        if not self.peers:  # single-node group: self-elect immediately
            self.storage.save_hardstate(self.storage.term + 1, self.node_id)
            self._become_leader()
            return
        self.state = CANDIDATE
        self.storage.save_hardstate(self.storage.term + 1, self.node_id)
        self.votes = {self.node_id}
        self._elapsed = 0
        self._timeout = self._rand_timeout()
        req = VoteReq(
            term=self.storage.term,
            candidate=self.node_id,
            last_log_index=self.storage.last_index(),
            last_log_term=self.storage.last_term(),
        )
        for p in self.peers:
            self.transport.send(p, self.group, req)

    def _become_leader(self) -> None:
        self.state = LEADER
        self.leader_id = self.node_id
        self._prevoting = False
        self._prevotes = set()
        self._transfer_target = None
        self._transfer_ticks = 0
        nxt = self.storage.last_index() + 1
        self.next_index = {p: nxt for p in self.peers}
        self.match_index = {p: 0 for p in self.peers}
        # commit a no-op to learn the commit point of prior terms (Raft §8)
        self._append_local(b"")
        self._broadcast_append()

    def _step_down(self, term: int, leader: Optional[str] = None) -> None:
        if term > self.storage.term:
            self.storage.save_hardstate(term, None)
        was_leader = self.state == LEADER
        self.state = FOLLOWER
        if leader is not None:
            self.leader_id = leader
            self._since_leader = 0  # heard from a live leader just now
        self._elapsed = 0
        self._timeout = self._rand_timeout()
        self._prevoting = False
        self._prevotes = set()
        # a transfer begun under an old leadership must not fire later
        self._transfer_target = None
        self._transfer_ticks = 0
        if was_leader:
            err = RuntimeError("leadership lost")
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(err)
            self._pending.clear()

    # -- proposals ----------------------------------------------------------

    def _handle_propose(self, data: bytes, fut: Future) -> None:
        if self.state != LEADER:
            fut.set_exception(
                NotLeaderError(self.leader_id)
            )
            return
        # register the future BEFORE appending: with no peers the append
        # commits and resolves pending futures synchronously
        idx = self.storage.last_index() + 1
        self._pending[idx] = fut
        self._append_local(data)
        self._broadcast_append()

    def _append_local(self, data: bytes) -> int:
        idx = self.storage.last_index() + 1
        self.storage.append([Entry(self.storage.term, idx, data)])
        if not self.peers:
            self._advance_commit(idx)
        return idx

    # -- replication --------------------------------------------------------

    def _broadcast_append(self) -> None:
        for p in self.peers:
            self._send_append(p)

    def _send_append(self, peer: str) -> None:
        nxt = self.next_index.get(peer, self.storage.last_index() + 1)
        prev = nxt - 1
        prev_term = self.storage.term_at(prev)
        if prev_term is None:
            # follower is behind the snapshot horizon: ship the snapshot
            snap = self.storage.load_snapshot()
            if snap is None and self.snapshot_fn is not None:
                snap = self.snapshot_fn()
            if snap is None:
                snap = b""
            self.transport.send(
                peer,
                self.group,
                SnapshotReq(
                    term=self.storage.term,
                    leader=self.node_id,
                    last_index=self.storage.snap_index,
                    last_term=self.storage.snap_term,
                    data=snap,
                ),
            )
            return
        entries = self.storage.entries_from(nxt)
        self.transport.send(
            peer,
            self.group,
            AppendReq(
                term=self.storage.term,
                leader=self.node_id,
                prev_log_index=prev,
                prev_log_term=prev_term,
                entries=entries,
                leader_commit=self.commit_index,
            ),
        )

    # -- message handling ----------------------------------------------------

    def _handle(self, msg) -> None:
        if isinstance(msg, VoteReq):
            self._on_vote_req(msg)
        elif isinstance(msg, VoteResp):
            self._on_vote_resp(msg)
        elif isinstance(msg, AppendReq):
            self._on_append(msg)
        elif isinstance(msg, AppendResp):
            self._on_append_resp(msg)
        elif isinstance(msg, SnapshotReq):
            self._on_snapshot(msg)
        elif isinstance(msg, SnapshotResp):
            self._on_snapshot_resp(msg)
        elif isinstance(msg, TimeoutNow):
            self._on_timeout_now(msg)

    def _on_timeout_now(self, m: TimeoutNow) -> None:
        """Transfer target: campaign NOW, bypassing pre-vote and the
        election timer (we were chosen as most caught-up; the old leader
        is about to stop)."""
        if m.term < self.storage.term or self.state == LEADER:
            return
        if self.passive or not self.peers:
            # a joiner that has not learned the membership yet would
            # "win" a single-node election and split-brain — ignore
            return
        self._campaign()

    def _on_vote_req(self, m: VoteReq) -> None:
        if m.pre:
            # pre-vote: assess, mutate NOTHING persistent.  Reject while
            # this node believes a live leader exists (heard from it
            # within the minimum election timeout) — leader stickiness,
            # the property that makes rejoining nodes non-disruptive.
            up_to_date = (m.last_log_term, m.last_log_index) >= (
                self.storage.last_term(),
                self.storage.last_index(),
            )
            leader_alive = (
                self.state == LEADER
                or (
                    self.leader_id is not None
                    and self._since_leader < self.election_ticks
                )
            )
            grant = m.term >= self.storage.term and up_to_date and not leader_alive
            self.transport.send(
                m.candidate, self.group,
                VoteResp(self.storage.term, grant, self.node_id, pre=True),
            )
            return
        if m.term < self.storage.term:
            self.transport.send(
                m.candidate, self.group,
                VoteResp(self.storage.term, False, self.node_id),
            )
            return
        if m.term > self.storage.term:
            self._step_down(m.term)
        up_to_date = (m.last_log_term, m.last_log_index) >= (
            self.storage.last_term(),
            self.storage.last_index(),
        )
        grant = up_to_date and self.storage.voted_for in (None, m.candidate)
        if grant:
            self.storage.save_hardstate(self.storage.term, m.candidate)
            self._elapsed = 0
        self.transport.send(
            m.candidate, self.group, VoteResp(self.storage.term, grant, self.node_id)
        )

    def _on_vote_resp(self, m: VoteResp) -> None:
        if m.pre:
            if m.term > self.storage.term:
                # a rejection from a higher-term node: adopt the term so
                # a later REAL campaign is viable (without this, a stale
                # node with the freshest log can deadlock the election)
                self._step_down(m.term)
                return
            if (
                self._prevoting  # stale grants after the round closed
                # (e.g. a live leader re-acknowledged us) must not count
                and m.granted
                and self.state != LEADER
                and m.term <= self.storage.term + 1
            ):
                self._prevotes.add(m.sender)
                if len(self._prevotes) * 2 > len(self.peers) + 1:
                    self._prevotes = set()
                    self._prevoting = False
                    self._campaign()
            return
        if self.state != CANDIDATE or m.term != self.storage.term:
            if m.term > self.storage.term:
                self._step_down(m.term)
            return
        if m.granted:
            self.votes.add(m.sender)
            if len(self.votes) * 2 > len(self.peers) + 1:
                self._become_leader()

    def _on_append(self, m: AppendReq) -> None:
        if m.term < self.storage.term:
            self.transport.send(
                m.leader, self.group,
                AppendResp(self.storage.term, False, 0, self.node_id),
            )
            return
        self._step_down(m.term, leader=m.leader)
        prev_term = self.storage.term_at(m.prev_log_index)
        if prev_term is None or prev_term != m.prev_log_term:
            # prev missing (behind our snapshot / past our log): hint the
            # leader where to resume as next_index = snap_index + 1.  The
            # +1 bias keeps the hint truthy even for an EMPTY log
            # (snap_index 0) — a fresh runtime joiner otherwise degrades
            # to a one-entry-per-roundtrip backoff walk.  0 = no hint
            # (term-mismatch case).
            self.transport.send(
                m.leader, self.group,
                AppendResp(self.storage.term, False,
                           self.storage.snap_index + 1
                           if prev_term is None else 0, self.node_id),
            )
            return
        new = [e for e in m.entries if e.index > self.storage.last_index()
               or self.storage.term_at(e.index) != e.term]
        if new:
            self.storage.append(new)  # durably, before acking
        match = m.prev_log_index + len(m.entries)
        if m.leader_commit > self.commit_index:
            self._set_commit(min(m.leader_commit, self.storage.last_index()))
        self.transport.send(
            m.leader, self.group,
            AppendResp(self.storage.term, True, match, self.node_id),
        )

    def _on_append_resp(self, m: AppendResp) -> None:
        if m.term > self.storage.term:
            self._step_down(m.term)
            return
        if self.state != LEADER:
            return
        if m.success:
            self.match_index[m.sender] = max(
                self.match_index.get(m.sender, 0), m.match_index
            )
            self.next_index[m.sender] = self.match_index[m.sender] + 1
            self._maybe_commit()
            # pending leadership transfer: hand off the moment the chosen
            # target confirms our whole log
            if (
                self._transfer_target == m.sender
                and self.match_index[m.sender] >= self.storage.last_index()
            ):
                self._finish_transfer()
        else:
            # back off; a truthy hint is the follower's snap_index + 1
            # (jump straight there), 0 means plain log mismatch
            hint = m.match_index
            cur = self.next_index.get(m.sender, self.storage.last_index() + 1)
            self.next_index[m.sender] = max(1, hint if hint else cur - 1)
            self._send_append(m.sender)

    def _on_snapshot(self, m: SnapshotReq) -> None:
        if m.term < self.storage.term:
            return
        self._step_down(m.term, leader=m.leader)
        if m.last_index <= self.storage.snap_index:
            return
        self.storage.save_snapshot(m.last_index, m.last_term, m.data)
        if self.restore_fn is not None:
            self.restore_fn(m.data)
        self.commit_index = max(self.commit_index, m.last_index)
        self.last_applied = max(self.last_applied, m.last_index)
        self.transport.send(
            m.leader, self.group,
            SnapshotResp(self.storage.term, self.node_id, m.last_index),
        )

    def _on_snapshot_resp(self, m: SnapshotResp) -> None:
        if self.state != LEADER:
            return
        self.match_index[m.sender] = max(
            self.match_index.get(m.sender, 0), m.last_index
        )
        self.next_index[m.sender] = m.last_index + 1

    # -- commit / apply ------------------------------------------------------

    def _maybe_commit(self) -> None:
        for idx in range(self.storage.last_index(), self.commit_index, -1):
            votes = 1 + sum(1 for p in self.peers if self.match_index.get(p, 0) >= idx)
            if votes * 2 > len(self.peers) + 1 and self.storage.term_at(idx) == self.storage.term:
                self._set_commit(idx)
                break

    def _advance_commit(self, idx: int) -> None:
        if self.storage.term_at(idx) == self.storage.term:
            self._set_commit(idx)

    def _set_commit(self, idx: int) -> None:
        self.commit_index = idx
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            entry = self.storage.entry_at(self.last_applied)
            apply_err: Optional[Exception] = None
            if entry is not None and entry.data:
                try:
                    self.apply_fn(entry.index, entry.data)
                except Exception as e:  # noqa: BLE001 — a bad entry must not
                    # wedge the group: report to the proposer and keep
                    # advancing, as the reference resolves the proposal
                    # with the apply error (draft.go process→props.Done)
                    import traceback

                    traceback.print_exc()
                    apply_err = e
            fut = self._pending.pop(self.last_applied, None)
            if fut is not None and not fut.done():
                if apply_err is not None:
                    fut.set_exception(apply_err)
                else:
                    fut.set_result(self.last_applied)
        self._maybe_snapshot()

    def _maybe_snapshot(self, force: bool = False) -> None:
        if self.snapshot_fn is None:
            return
        behind = self.last_applied - self.storage.snap_index
        if behind <= 0 or (not force and behind < self.snapshot_threshold):
            return
        term = self.storage.term_at(self.last_applied)
        if term is None:
            return
        data = self.snapshot_fn()
        self.storage.save_snapshot(self.last_applied, term, data)


class NotLeaderError(Exception):
    """Proposal sent to a non-leader; carries the leader hint for
    client-side redirect (the reference forwards via AnyServer/Leader
    routing, worker/groups.go:323)."""

    def __init__(self, leader: Optional[str]):
        super().__init__(f"not the leader; try {leader!r}")
        self.leader = leader
