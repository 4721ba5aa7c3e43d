"""Raft message wire codec + the HTTP and gRPC transports between server
processes (copy of ``dgraph_tpu/cluster/transport.py``: the frames are
byte-identical to the reference's, so port and reference servers can
share one Raft group).

Equivalent of upstream Dgraph's raft gRPC plane (worker/draft.go:437
batchAndSendMessages → grpc RaftMessage:1017): messages are length-framed
binary (the shared varint codec — NOT pickle: raft frames arrive off the
network and must never execute anything), queued per peer and shipped by
a sender thread so the raft event loop never blocks on the network.
Delivery is best-effort; raft tolerates loss and the queue drops when a
peer is down (the reference's conn pool likewise drops on dead conns).

Frames travel over HTTP(S) (``HttpRaftTransport``: ``POST /raft/<g>``)
or over the gRPC Worker plane (``GrpcRaftTransport``:
``/protos.Worker/RaftMessage``).  ``https://`` peers are verified under
``PeerAuth``'s trust model: a pinned CA (``--peer_ca``), the explicit
``--peer_tls_insecure`` opt-out, or the system trust store.
"""

from __future__ import annotations

import queue
import threading
import urllib.request
from typing import Dict, List, Optional

from dgraph_tpu_torch.models import codec
from dgraph_tpu_torch.cluster.raft import (
    TimeoutNow,
    AppendReq,
    AppendResp,
    Entry,
    SnapshotReq,
    SnapshotResp,
    Transport,
    VoteReq,
    VoteResp,
)

(_VOTE_REQ, _VOTE_RESP, _APPEND_REQ, _APPEND_RESP, _SNAP_REQ, _SNAP_RESP,
 _TIMEOUT_NOW) = range(7)

# Header carrying the shared cluster secret on every intra-cluster call.
# The raft/propose/assign endpoints share the public port (the reference
# isolates them on an internal gRPC port); the secret is what stops
# anyone with network reach from injecting forged raft frames.
SECRET_HEADER = "X-Dgraph-Cluster-Secret"


class PeerAuth:
    """Security posture for intra-cluster calls: a shared secret attached
    to every request, and the TLS trust model for https peers —
    ``cafile`` pins a CA (chain verified, hostname check off: cluster
    certs are typically issued to names that don't match peer IPs, the
    reference's tls_helper has the same server-name override escape
    hatch); ``insecure=True`` is the explicit opt-out for throwaway
    self-signed setups; default is full system-store verification."""

    def __init__(self, secret: str = "", cafile: str = "", insecure: bool = False):
        self.secret = secret
        self.cafile = cafile
        self.insecure = insecure
        self._ctx = None

    def ssl_context(self):
        if self._ctx is None:
            import ssl

            if self.cafile:
                ctx = ssl.create_default_context(cafile=self.cafile)
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_REQUIRED
            elif self.insecure:
                ctx = ssl._create_unverified_context()
            else:
                ctx = ssl.create_default_context()
            self._ctx = ctx
        return self._ctx


def urlopen_peer(req, timeout: float, auth: Optional[PeerAuth] = None):
    """urlopen for intra-cluster calls: attaches the cluster secret and
    applies the PeerAuth TLS trust model for https peers."""
    if auth is not None and auth.secret and hasattr(req, "add_header"):
        req.add_header(SECRET_HEADER, auth.secret)
    url = req.full_url if hasattr(req, "full_url") else str(req)
    if url.startswith("https://"):
        ctx = (auth or PeerAuth()).ssl_context()
        return urllib.request.urlopen(req, timeout=timeout, context=ctx)
    return urllib.request.urlopen(req, timeout=timeout)


def _put_bytes(buf: bytearray, b: bytes) -> None:
    codec.put_uvarint(buf, len(b))
    buf.extend(b)


def _get_bytes(b: bytes, pos: int):
    n, pos = codec.uvarint(b, pos)
    if pos + n > len(b):
        # a frame cut short (a sender that timed out mid-body) must not
        # decode into a shorter entry under the right term and index:
        # appended, it would be acknowledged, committed and fail to
        # apply on this replica forever (the reference's slice would
        # silently shorten it)
        raise ValueError("truncated raft frame")
    return bytes(b[pos : pos + n]), pos + n


def _put_str(buf: bytearray, s: str) -> None:
    _put_bytes(buf, s.encode("utf-8"))


def _get_str(b: bytes, pos: int):
    raw, pos = _get_bytes(b, pos)
    return raw.decode("utf-8"), pos


def encode_msg(msg) -> bytes:
    buf = bytearray()
    if isinstance(msg, VoteReq):
        buf.append(_VOTE_REQ)
        codec.put_uvarint(buf, msg.term)
        _put_str(buf, msg.candidate)
        codec.put_uvarint(buf, msg.last_log_index)
        codec.put_uvarint(buf, msg.last_log_term)
        buf.append(1 if msg.pre else 0)
    elif isinstance(msg, VoteResp):
        buf.append(_VOTE_RESP)
        codec.put_uvarint(buf, msg.term)
        buf.append(1 if msg.granted else 0)
        _put_str(buf, msg.sender)
        buf.append(1 if msg.pre else 0)
    elif isinstance(msg, TimeoutNow):
        buf.append(_TIMEOUT_NOW)
        codec.put_uvarint(buf, msg.term)
        _put_str(buf, msg.leader)
    elif isinstance(msg, AppendReq):
        buf.append(_APPEND_REQ)
        codec.put_uvarint(buf, msg.term)
        _put_str(buf, msg.leader)
        codec.put_uvarint(buf, msg.prev_log_index)
        codec.put_uvarint(buf, msg.prev_log_term)
        codec.put_uvarint(buf, msg.leader_commit)
        codec.put_uvarint(buf, len(msg.entries))
        for e in msg.entries:
            codec.put_uvarint(buf, e.term)
            codec.put_uvarint(buf, e.index)
            _put_bytes(buf, e.data)
    elif isinstance(msg, AppendResp):
        buf.append(_APPEND_RESP)
        codec.put_uvarint(buf, msg.term)
        buf.append(1 if msg.success else 0)
        codec.put_uvarint(buf, msg.match_index)
        _put_str(buf, msg.sender)
    elif isinstance(msg, SnapshotReq):
        buf.append(_SNAP_REQ)
        codec.put_uvarint(buf, msg.term)
        _put_str(buf, msg.leader)
        codec.put_uvarint(buf, msg.last_index)
        codec.put_uvarint(buf, msg.last_term)
        _put_bytes(buf, msg.data)
    elif isinstance(msg, SnapshotResp):
        buf.append(_SNAP_RESP)
        codec.put_uvarint(buf, msg.term)
        _put_str(buf, msg.sender)
        codec.put_uvarint(buf, msg.last_index)
    else:
        raise TypeError(f"unknown raft message {type(msg)!r}")
    return bytes(buf)


def decode_msg(b: bytes):
    tag = b[0]
    pos = 1
    if tag == _VOTE_REQ:
        term, pos = codec.uvarint(b, pos)
        cand, pos = _get_str(b, pos)
        lli, pos = codec.uvarint(b, pos)
        llt, pos = codec.uvarint(b, pos)
        # trailing pre byte absent in frames of older builds: degrade to a
        # plain vote instead of crashing the receive path mid-upgrade
        pre = pos < len(b) and b[pos] == 1
        return VoteReq(term, cand, lli, llt, pre)
    if tag == _VOTE_RESP:
        term, pos = codec.uvarint(b, pos)
        granted = b[pos] == 1
        sender, pos = _get_str(b, pos + 1)
        pre = pos < len(b) and b[pos] == 1
        return VoteResp(term, granted, sender, pre)
    if tag == _TIMEOUT_NOW:
        term, pos = codec.uvarint(b, pos)
        leader, pos = _get_str(b, pos)
        return TimeoutNow(term, leader)
    if tag == _APPEND_REQ:
        term, pos = codec.uvarint(b, pos)
        leader, pos = _get_str(b, pos)
        pli, pos = codec.uvarint(b, pos)
        plt, pos = codec.uvarint(b, pos)
        commit, pos = codec.uvarint(b, pos)
        n, pos = codec.uvarint(b, pos)
        entries: List[Entry] = []
        for _ in range(n):
            et, pos = codec.uvarint(b, pos)
            ei, pos = codec.uvarint(b, pos)
            data, pos = _get_bytes(b, pos)
            entries.append(Entry(et, ei, data))
        return AppendReq(term, leader, pli, plt, entries, commit)
    if tag == _APPEND_RESP:
        term, pos = codec.uvarint(b, pos)
        success = b[pos] == 1
        match, pos = codec.uvarint(b, pos + 1)
        sender, pos = _get_str(b, pos)
        return AppendResp(term, success, match, sender)
    if tag == _SNAP_REQ:
        term, pos = codec.uvarint(b, pos)
        leader, pos = _get_str(b, pos)
        li, pos = codec.uvarint(b, pos)
        lt, pos = codec.uvarint(b, pos)
        data, pos = _get_bytes(b, pos)
        return SnapshotReq(term, leader, li, lt, data)
    if tag == _SNAP_RESP:
        term, pos = codec.uvarint(b, pos)
        sender, pos = _get_str(b, pos)
        li, pos = codec.uvarint(b, pos)
        return SnapshotResp(term, sender, li)
    raise ValueError(f"unknown raft message tag {tag:#x}")


class _QueuedPeerTransport(Transport):
    """Queue-per-peer / drop-don't-block sender discipline shared by the
    raft transports: one bounded queue + daemon sender thread per peer —
    the raft loop enqueues and returns; slow/dead peers drop frames
    instead of applying backpressure to consensus (batchAndSendMessages
    behavior, draft.go:434 'no need to send heartbeats if we can't send
    messages').  Subclasses implement ``_sender``."""

    _thread_prefix = "raft-send"

    def __init__(
        self,
        addr_of: Dict[str, str],
        timeout: float,
        auth: Optional["PeerAuth"] = None,
        peerclient=None,
    ):
        self.addr_of = dict(addr_of)      # node_id -> http(s)://host:port
        self.timeout = timeout
        self.auth = auth
        # all network sends route through the PeerClient funnel
        # (cluster/peerclient.py): bounded retries with backoff for
        # transient errors, and the per-peer breaker turns a dead peer's
        # frames into microsecond sheds instead of per-frame timeouts.
        # ClusterService shares ITS client so breaker knowledge is
        # cluster-wide; standalone transports build their own.  Lazy
        # import: peerclient imports PeerAuth/urlopen_peer from here.
        if peerclient is None:
            from dgraph_tpu_torch.cluster.peerclient import PeerClient

            peerclient = PeerClient(auth=auth)
        self.peerclient = peerclient
        self._queues: Dict[str, "queue.Queue"] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()

    def _queue_for(self, peer: str) -> "queue.Queue":
        with self._lock:
            q = self._queues.get(peer)
            if q is None:
                q = queue.Queue(maxsize=256)
                self._queues[peer] = q
                t = threading.Thread(
                    target=self._sender, args=(peer, q),
                    name=f"{self._thread_prefix}-{peer}", daemon=True,
                )
                t.start()
            return q

    def update_peer(self, nid: str, addr: str) -> None:
        """Runtime membership rewiring (atomic reference swap — sender
        threads re-read addr_of per message)."""
        self.addr_of = {**self.addr_of, nid: addr}

    def send(self, to: str, group: int, msg) -> None:
        if to not in self.addr_of:
            return
        try:
            self._queue_for(to).put_nowait((group, encode_msg(msg)))
        except queue.Full:
            pass  # drop: raft retries via next heartbeat

    def _sender(self, peer: str, q: "queue.Queue") -> None:
        raise NotImplementedError

    def stop(self) -> None:
        self._stop.set()


class HttpRaftTransport(_QueuedPeerTransport):
    """Ships raft frames to peers over HTTP POST /raft/<group>."""

    def __init__(
        self,
        addr_of: Dict[str, str],
        timeout: float = 2.0,
        auth: Optional[PeerAuth] = None,
        peerclient=None,
    ):
        super().__init__(addr_of, timeout, auth=auth, peerclient=peerclient)

    def _sender(self, peer: str, q: "queue.Queue") -> None:
        from dgraph_tpu_torch.utils.metrics import RAFT_DROPPED, note_swallowed

        while not self._stop.is_set():
            try:
                group, body = q.get(timeout=0.5)
            except queue.Empty:
                continue
            url = f"{self.addr_of[peer]}/raft/{group}"
            try:
                req = urllib.request.Request(
                    url, data=body,
                    headers={"Content-Type": "application/octet-stream"},
                )
                # bounded retry (2 attempts) through the shared breaker:
                # a transient blip no longer drops the frame, a dead
                # peer sheds in microseconds once its circuit opens.
                # slice_budget=False: halving the (already short) frame
                # timeout would make a healthy-but-loaded peer answering
                # in (timeout/2, timeout] fail BOTH slices — frames
                # dropped and its breaker charged where the legacy
                # single shot delivered; the first attempt keeps the
                # legacy window, the retry covers fast failures only
                with self.peerclient.urlopen(
                    peer, req, op="raft.send",
                    budget=self.timeout, attempts=2,
                    off_timeout=self.timeout, slice_budget=False,
                ) as resp:
                    resp.read()
            except OSError as e:
                # peer still down after retries: drop (raft re-sends via
                # the next heartbeat) — but COUNTED, never silent
                RAFT_DROPPED.add(peer)
                note_swallowed("transport.http_send", e)
            except Exception as e:  # noqa: BLE001 — ANY other failure
                # (IncompleteRead from a peer killed mid-response, encode
                # surprise) must not kill this peer's only sender thread
                # for the process lifetime; same discipline as the gRPC
                # twin: count under its own site AND print the traceback
                import traceback

                RAFT_DROPPED.add(peer)
                note_swallowed("transport.sender_unexpected", e)
                traceback.print_exc()


def grpc_target_of(http_addr: str, port_offset: int) -> str:
    """Peer address → its gRPC target.  Accepts full http(s)://host:port
    urls AND bare host:port (ClusterService's peers param admits both);
    raises on anything it cannot map rather than emitting a target that
    silently drops every frame."""
    from urllib.parse import urlsplit

    addr = http_addr
    if "://" not in addr:
        addr = "http://" + addr
    u = urlsplit(addr)
    if not u.hostname or not u.port:
        raise ValueError(f"cannot derive a gRPC target from peer address {http_addr!r}")
    return f"{u.hostname}:{u.port + port_offset}"


class GrpcRaftTransport(_QueuedPeerTransport):
    """Ships raft frames over the gRPC Worker plane
    (``/protos.Worker/RaftMessage``, serve/grpc_server.py) — the direct
    analog of the reference's raft gRPC leg (worker/draft.go:1017);
    the cluster secret rides gRPC metadata.

    ``addr_of`` holds peer HTTP addresses (same contract as
    HttpRaftTransport, so runtime membership rewiring via update_peer is
    transport-agnostic); targets derive per message, so a member that
    re-announces on a new address is picked up by the live sender.
    https peers require ``auth.cafile`` — gRPC channels are TLS-verified
    with the pinned CA; there is no silent plaintext downgrade."""

    _thread_prefix = "raft-grpc-send"

    def __init__(
        self,
        addr_of: Dict[str, str],  # node_id -> http(s)://host:port
        timeout: float = 2.0,
        secret: str = "",
        port_offset: int = 1000,
        auth: Optional[PeerAuth] = None,
        peerclient=None,
    ):
        super().__init__(addr_of, timeout, auth=auth, peerclient=peerclient)
        self.secret = secret
        self.port_offset = port_offset
        for a in self.addr_of.values():
            self._check_addr(a)
        self._chans: Dict[str, object] = {}  # target -> channel

    def _check_addr(self, addr: str) -> None:
        grpc_target_of(addr, self.port_offset)  # raises if unmappable
        if addr.startswith("https://") and not (self.auth and self.auth.cafile):
            raise ValueError(
                "https peers over the gRPC raft transport require a pinned "
                "CA (--peer_ca): gRPC has no unverified-TLS mode and "
                "silently downgrading raft frames to plaintext would leak "
                "the cluster secret"
            )

    def update_peer(self, nid: str, addr: str) -> None:
        self._check_addr(addr)
        old = self.addr_of.get(nid)
        super().update_peer(nid, addr)
        if old and old != addr:
            # close the superseded channel unless another peer still maps
            # to the same target — re-addressing members must not leak
            # one open HTTP/2 connection per churn for the process life
            old_t = grpc_target_of(old, self.port_offset)
            live = {
                grpc_target_of(a, self.port_offset)
                for a in self.addr_of.values()
            }
            if old_t not in live:
                with self._lock:
                    ch = self._chans.pop(old_t, None)
                if ch is not None:
                    try:
                        ch.close()
                    except Exception as e:  # noqa: BLE001 — grpc close
                        # failures are unactionable here, but visible
                        from dgraph_tpu_torch.utils.metrics import note_swallowed

                        note_swallowed("transport.channel_close", e)

    def _channel_for(self, addr: str):
        from dgraph_tpu_torch.serve.grpc_server import make_channel

        target = grpc_target_of(addr, self.port_offset)
        with self._lock:
            ch = self._chans.get(target)
            if ch is None:
                ch = make_channel(target, self.auth.cafile
                                  if addr.startswith("https://") else "")
                self._chans[target] = ch
            return ch

    def _sender(self, peer: str, q: "queue.Queue") -> None:
        import grpc

        from dgraph_tpu_torch.serve.grpc_server import (
            _SECRET_MD,
            encode_payload,
            frame_raft,
        )
        from dgraph_tpu_torch.utils.metrics import RAFT_DROPPED, note_swallowed

        md = [(_SECRET_MD, self.secret)] if self.secret else None
        while not self._stop.is_set():
            try:
                group, body = q.get(timeout=0.5)
            except queue.Empty:
                continue
            try:
                # re-resolve per message (like HttpRaftTransport): a
                # member re-announcing on a new address routes the next
                # frame to the new target
                addr = self.addr_of.get(peer)
                if addr is None:
                    continue
                payload = encode_payload(frame_raft(group, body))
                # the channel-RPC itself runs inside PeerClient (its
                # grpc_unary leg): bounded retries, breaker sheds, and
                # the ValueError a closing channel throws mid-call is
                # classified transient there — a ValueError out of
                # encode_payload above still reaches the unexpected
                # handler below, as before
                try:
                    # slice_budget=False for the same reason as the HTTP
                    # twin: a loaded peer answering within the legacy
                    # window must not fail two half-window slices
                    self.peerclient.grpc_unary(
                        peer, "raft.send", self._channel_for(addr),
                        "/protos.Worker/RaftMessage", payload,
                        metadata=md, budget=self.timeout, attempts=2,
                        slice_budget=False,
                    )
                except ValueError as e:
                    # the RESILIENCE=0 off-path returns the raw attempt,
                    # so the closed-channel ValueError arrives HERE
                    # instead of wrapped transient inside peerclient:
                    # same quiet counted drop as any peer-down error,
                    # not a per-frame traceback
                    RAFT_DROPPED.add(peer)
                    note_swallowed("transport.grpc_send", e)
            except (grpc.RpcError, OSError) as e:
                # peer still down after retries: drop (heartbeats will
                # re-send) — counted, never silent
                RAFT_DROPPED.add(peer)
                note_swallowed("transport.grpc_send", e)
            except Exception as e:  # noqa: BLE001 — ANY other failure
                # (encode bug, channel-construction surprise) must not
                # kill this peer's only sender thread for the process
                # lifetime; count under its own site AND print — an
                # unexpected type here is a bug worth a traceback
                import traceback

                note_swallowed("transport.sender_unexpected", e)
                traceback.print_exc()

    def stop(self) -> None:
        super().stop()
        from dgraph_tpu_torch.utils.metrics import note_swallowed

        with self._lock:
            for ch in self._chans.values():
                try:
                    ch.close()
                except Exception as e:  # noqa: BLE001 — best-effort teardown
                    note_swallowed("transport.channel_close", e)
            self._chans.clear()
