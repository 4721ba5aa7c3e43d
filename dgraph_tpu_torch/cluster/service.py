"""Cluster service: the server binary's StartRaftNodes analog (copy of
``dgraph_tpu/cluster/service.py``; raft frames over HTTP(S) or the gRPC
Worker plane).

Wires the cluster layer into a serving process (upstream Dgraph's
worker/groups.go:109 StartRaftNodes + dgraph/server.go storage bring-up):

- one ReplicatedGroup (Raft node + replica store) per group this server
  serves, talking to peers over HttpRaftTransport (POST /raft/<group>);
- group 0 is the metadata group (worker/groups.go:404): schema text, uid
  leases (LEASE records) and xid assignments (XID records) replicate
  through it;
- data predicates route to groups by GroupConfig (group/conf.go rules);
- `ClusterStore` — the store facade handed to the query engine: writes
  become Raft proposals to the owning group (MutateOverNetwork's
  proposeOrSend, worker/mutation.go:319 — non-leaders forward over HTTP
  to the leader); reads come from per-predicate SNAPSHOT copies of the
  local replica stores, refreshed when the replica applies new records,
  so queries never race the raft apply threads (the reference's
  immutable-layer read semantics).

Reads are local-replica reads: any server answers queries from its own
replicas (AnyServer read balancing, worker/groups.go:268) — writes are
linearizable through Raft, reads are eventually consistent, as in the
reference.  The engine builds its device arenas from the ClusterStore's
snapshot copies, so a cluster read runs the same gather / intersect
kernels as a single node's.
"""

from __future__ import annotations

import http.client
import threading
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from dgraph_tpu_torch.models import codec
from dgraph_tpu_torch.models.store import Edge, PredicateData
from dgraph_tpu_torch.models.schema import SchemaState
from dgraph_tpu_torch.cluster.groups import GroupConfig
from dgraph_tpu_torch.cluster.lease import LeaseManager
from dgraph_tpu_torch.cluster.peerclient import (
    PeerClient,
    StaleUnavailableError,
    resilience_enabled,
)
from dgraph_tpu_torch.cluster.raft import NotLeaderError, propose_patience
from dgraph_tpu_torch.cluster.replica import ReplicatedGroup, encode_batch
from dgraph_tpu_torch.cluster.transport import (
    HttpRaftTransport,
    PeerAuth,
    decode_msg,
)

METADATA_GROUP = 0


def parse_peers(peer_spec: str, default_scheme: str = "http") -> Dict[str, str]:
    """"1@host:8080,2@host:8081" (or full http(s):// urls) → id→addr.
    Bare host:port entries take ``default_scheme`` — a TLS-enabled server
    must default its peers to https or raft frames hit TLS listeners as
    plaintext and are silently dropped."""
    out: Dict[str, str] = {}
    for part in peer_spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "@" not in part:
            raise ValueError(f"peer {part!r} must be id@host:port")
        nid, addr = part.split("@", 1)
        if not addr.startswith(("http://", "https://")):
            addr = f"{default_scheme}://" + addr
        out[nid.strip()] = addr
    return out


def parse_peer_groups(spec: str) -> Dict[str, List[int]]:
    """"1=0,1;2=0,2" → {peer-id: [group,...]}.  Empty spec = {} (every
    peer serves every group)."""
    out: Dict[str, List[int]] = {}
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        nid, _, gs = part.partition("=")
        if not gs:
            raise ValueError(f"peer_groups entry {part!r} must be id=g1,g2")
        out[nid.strip()] = [int(g) for g in gs.split(",") if g.strip()]
    return out


class ClusterService:
    """Owns this server's raft groups, transport, lease and store facade."""

    def __init__(
        self,
        node_id: str,
        my_addr: str,
        peers: Dict[str, str],          # id -> addr, INCLUDING self
        group_ids: List[int],
        directory: str,
        group_config: Optional[GroupConfig] = None,
        sync_writes: bool = False,
        secret: str = "",
        peer_ca: str = "",
        peer_tls_insecure: bool = False,
        peer_groups: Optional[Dict[str, List[int]]] = None,
        raft_transport: str = "http",
        grpc_port_offset: int = 1000,
        **raft_opts,
    ):
        if METADATA_GROUP not in group_ids:
            group_ids = [METADATA_GROUP] + list(group_ids)
        self.node_id = node_id
        self.peers = dict(peers)
        self.peers.setdefault(node_id, my_addr)
        data_groups = sorted(g for g in group_ids if g != METADATA_GROUP)
        if group_config is not None:
            self.conf = group_config
        elif data_groups:
            # contiguous data groups 1..N: fingerprint mod N + 1
            self.conf = GroupConfig.parse(f"default: fp % {len(data_groups)} + 1")
        else:
            self.conf = GroupConfig.single_group()
        self.auth = PeerAuth(secret=secret, cafile=peer_ca, insecure=peer_tls_insecure)
        # one PeerClient for every peer RPC this server issues — the
        # retry/backoff/breaker funnel (cluster/peerclient.py); the raft
        # transports share it so a peer that times out on the read plane
        # is ALSO known-bad to the raft sender loops (and vice versa)
        self.peerclient = PeerClient(auth=self.auth)
        others = {nid: a for nid, a in self.peers.items() if nid != node_id}
        if raft_transport == "grpc":
            # raft frames over the gRPC Worker plane (upstream's native
            # raft leg, draft.go:1017).  gRPC listeners sit at the http
            # port + offset (the CLI's --grpc_port convention); the
            # transport derives targets per message, so members learned
            # or re-addressed at runtime route correctly too.
            from dgraph_tpu_torch.cluster.transport import GrpcRaftTransport

            self.transport = GrpcRaftTransport(
                others,
                secret=secret,
                port_offset=grpc_port_offset,
                auth=self.auth,
                peerclient=self.peerclient,
            )
        else:
            self.transport = HttpRaftTransport(
                others, auth=self.auth, peerclient=self.peerclient
            )
        # static placement (group/conf.go's server-side complement): which
        # groups each peer serves.  None/missing peer = serves everything
        # (full replication, the pre-placement behavior).  The metadata
        # group always spans every server.  MEMBER records refine this at
        # runtime (groups.go syncMemberships analog).
        self.peer_groups: Dict[str, Tuple[int, ...]] = {
            nid: tuple(sorted(set(gs) | {METADATA_GROUP}))
            for nid, gs in (peer_groups or {}).items()
        }
        self.peer_groups[node_id] = tuple(sorted(group_ids))
        peer_ids = sorted(self.peers)

        def raft_peers(g: int) -> List[str]:
            # a group's raft cluster spans only the servers that SERVE it;
            # peers with unknown placement are assumed to serve everything
            return [
                nid
                for nid in peer_ids
                if g == METADATA_GROUP
                or nid not in self.peer_groups
                or g in self.peer_groups[nid]
            ]

        self.groups: Dict[int, ReplicatedGroup] = {
            g: ReplicatedGroup(
                node_id=node_id, group=g, peers=raft_peers(g), directory=directory,
                transport=self.transport, sync_writes=sync_writes, **raft_opts,
            )
            for g in group_ids
        }
        self.lease = LeaseManager(self._propose_lease)
        self._stopped = False
        self.store = ClusterStore(self)
        # runtime membership: MEMBER records applied on the metadata
        # replica rewire this server live (groups.go applyMembershipUpdate)
        self.groups[METADATA_GROUP].store.member_hook = self._on_member_applied

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        for g in self.groups.values():
            g.start()
        # resume the lease above everything the metadata replica has seen
        meta = self.groups[METADATA_GROUP].store
        self.lease.init_from_recovery(meta.uids.max_uid + 1)
        # announce our own placement through the metadata group so every
        # server learns group→server routing (syncMemberships,
        # worker/groups.go:404 — periodic there, once-with-retry here
        # since membership is static between joins)
        threading.Thread(
            target=self._announce_self, name="announce", daemon=True
        ).start()

    def _announce_self(self) -> None:
        import sys
        import time

        rec = codec.encode_member(
            self.node_id, self.peers[self.node_id], sorted(self.groups)
        )
        attempt = 0
        delay = 0.2
        while not self._stopped:
            try:
                self.propose_records(METADATA_GROUP, [rec])
                return
            except Exception as e:  # noqa: BLE001 — keep trying: peers
                # route reads/writes by this announcement; giving up
                # silently would leave our groups unreachable forever
                attempt += 1
                if attempt == 25:
                    print(
                        f"# server {self.node_id}: membership announcement "
                        f"still failing after {attempt} attempts "
                        f"({type(e).__name__}: {e}); retrying",
                        file=sys.stderr,
                    )
                time.sleep(delay)
                delay = min(delay * 1.5, 2.0)

    def stop(self) -> None:
        self._stopped = True
        for g in self.groups.values():
            g.stop()
        self.transport.stop()

    def has_leader(self) -> bool:
        return all(g.node.leader_id is not None for g in self.groups.values())

    def health_summary(self) -> dict:
        """Peer/breaker/raft-leader state for the /health endpoint."""
        return {
            "node": self.node_id,
            "peers": self.peerclient.snapshot(),
            "raft": {
                str(gid): {
                    "leader": g.node.leader_id,
                    "is_leader": g.node.is_leader,
                    "snap_index": g.node.storage.snap_index,
                    "last_applied": g.node.last_applied,
                }
                for gid, g in sorted(self.groups.items())
            },
            "degraded": self.store.degraded_info(),
        }

    def snapshot_all(self) -> None:
        """Force raft-log compaction on every group this server serves
        (/admin/snapshot — the cluster twin of DurableStore.snapshot)."""
        for g in self.groups.values():
            g.force_snapshot()

    # -- runtime membership (JoinCluster, draft.go:1049 / groups.go:600) ----

    def _wait_local_apply(self, cond: Callable[[], bool], timeout: float = 5.0) -> bool:
        """Poll until a forwarded proposal becomes visible on the LOCAL
        replica (shared by xid assignment, schema apply and join)."""
        import time

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if cond():
                return True
            time.sleep(0.005)
        return False

    def _on_member_applied(self, nid: str, addr: str, groups=()) -> None:
        """Called (from a raft apply thread) when a MEMBER record lands on
        the metadata replica: rewire transport + the member's groups'
        peer sets.  Idempotent; safe on replay and snapshot restore.
        Dict updates are atomic reference swaps — HTTP handler threads
        iterate self.peers/addr_of concurrently."""
        if nid != self.node_id:
            self.peers = {**self.peers, nid: addr}
            # transport-agnostic rewiring: the gRPC transport derives its
            # target from the http address itself (update_peer validates).
            # Validation failures must NOT raise: this runs on the raft
            # apply thread, and aborting would leave the committed batch
            # partially applied on this replica — skip the rewiring (the
            # peer stays unreachable, which is true) and log instead.
            try:
                self.transport.update_peer(nid, addr)
            except ValueError as e:
                import sys as _sys

                print(
                    f"warning: cannot route raft frames to member {nid} "
                    f"at {addr!r}: {e}",
                    file=_sys.stderr,
                )
        member_groups = set(groups) if groups else None
        if member_groups is not None:
            self.peer_groups = {
                **self.peer_groups,
                nid: tuple(sorted(member_groups | {METADATA_GROUP})),
            }
        for gid, g in self.groups.items():
            # empty group list = legacy record = member serves every group;
            # the metadata group always includes every member
            if member_groups is None or gid in member_groups or gid == METADATA_GROUP:
                g.node.add_peer(nid)
            else:
                # the record authoritatively says this member does NOT
                # serve gid: drop it from the voter set so it can never
                # depress the group's quorum
                g.node.remove_peer(nid)

    def servers_of_group(self, gid: int) -> List[Tuple[str, str]]:
        """(node_id, addr) of every server EXPLICITLY placing group
        ``gid``, self excluded — the remote-read / remote-propose
        candidate list.  Peers with unknown placement are NOT counted:
        in legacy full-replication clusters every server already holds
        every group locally, so routing to an undeclared peer could only
        hit a server that errors 'group not served here'."""
        out = []
        for nid, addr in sorted(self.peers.items()):
            if nid == self.node_id:
                continue
            gs = self.peer_groups.get(nid)
            if gs is not None and gid in gs:
                out.append((nid, addr))
        return out

    def handle_join(self, nid: str, addr: str, groups=()) -> Dict[str, str]:
        """Server side of a join request: replicate the new member
        through the metadata group and hand back the full peer map so the
        joiner can configure itself.  propose_records returning means the
        membership IS committed (leader applied it); a lagging LOCAL
        apply only delays this server's own view, so it must not fail
        the join — the joiner would be a committed member with no
        removal path."""
        # propose the FULL membership (idempotent): the metadata log then
        # carries every member, so a joiner's restart — whose static
        # config lists only itself — replays the complete peer map
        records = [
            codec.encode_member(n, a, sorted(self.groups))
            for n, a in sorted(self.peers.items())
        ]
        records.append(codec.encode_member(nid, addr, sorted(groups)))
        self.propose_records(METADATA_GROUP, records)
        meta = self.groups[METADATA_GROUP].store
        self._wait_local_apply(lambda: nid in meta.members)
        peers = dict(self.peers)
        peers[nid] = addr
        return peers

    def join_cluster(self, seed_addr: str, timeout: float = 15.0) -> None:
        """Joiner side: announce ourselves to a live cluster via any
        server, then adopt the returned peer map.  The metadata leader's
        raft nodes start replicating to us the moment our MEMBER record
        applies on them; our passive nodes catch up via snapshot+log."""
        import json as _json

        req = urllib.request.Request(
            seed_addr.rstrip("/") + "/join",
            data=_json.dumps(
                {
                    "id": self.node_id,
                    "addr": self.peers[self.node_id],
                    "groups": sorted(self.groups),
                }
            ).encode(),
            headers={"Content-Type": "application/json"},
        )
        # key the breaker/metrics by the seed's node id when we know it
        # (static peer lists) so /health and dgraph_peer_rpc_total keep
        # one namespace per peer; a runtime joiner booted with only
        # itself has nothing better than the address yet
        seed_key = next(
            (
                nid
                for nid, a in self.peers.items()
                if a.rstrip("/") == seed_addr.rstrip("/")
            ),
            seed_addr,
        )
        # slice_budget=False, like forward: the seed server legitimately
        # blocks while the MEMBER record commits + applies
        # (_wait_local_apply), so a budget slice times out a join that
        # was about to succeed on a loaded host — the first attempt owns
        # the window, the retry covers only fast transport failures
        with self.peerclient.urlopen(
            seed_key, req, op="join", budget=timeout, attempts=2,
            slice_budget=False,
        ) as resp:
            got = _json.loads(resp.read())
        for nid, addr in got["peers"].items():
            self._on_member_applied(nid, addr)

    # -- raft plane (server endpoints call these) ---------------------------

    def deliver(self, group: int, body: bytes) -> None:
        g = self.groups.get(group)
        if g is not None:
            g.node.deliver(decode_msg(body))

    def propose_local(
        self, group: int, batch: bytes, timeout: Optional[float] = None
    ) -> None:
        """Propose on THIS server; raises NotLeaderError for the forwarder."""
        self.groups[group].node.propose_and_wait(batch, propose_patience(timeout))

    def propose_records(
        self, group: int, records: List[bytes], timeout: Optional[float] = None
    ) -> None:
        """Propose, forwarding to the leader over HTTP when we're not it
        (proposeOrSend: local → ProposeAndWait, remote → RPC).  A group
        this server does not place routes straight to that group's
        servers (MutateOverNetwork's remote grpc Mutate leg)."""
        timeout = propose_patience(timeout)
        batch = encode_batch(records)
        if group not in self.groups:
            return self._propose_remote_group(group, batch, timeout)
        self._route_to_leader(
            lambda: self.propose_local(group, batch, timeout),
            lambda peer: self._forward(peer, group, batch, timeout),
        )

    def _propose_remote_group(self, group: int, batch: bytes, timeout: float):
        members = self.servers_of_group(group)
        if not members:
            raise NotLeaderError(None)
        tried: set = set()
        target = members[0][0]
        for _ in range(2 * len(members) + 2):
            if target is None or target in tried:
                target = next(
                    (nid for nid, _a in members if nid not in tried), None
                )
                if target is None:
                    break
            _res, hint, ok = self._forward(target, group, batch, timeout)
            if ok:
                return
            tried.add(target)
            target = hint
        raise NotLeaderError(None)

    def _route_to_leader(
        self,
        local_fn: Callable[[], object],
        forward_fn: Callable[[str], Tuple[object, Optional[str], bool]],
    ):
        """The shared leader-chasing loop: try locally, follow leader
        hints, fall back to untried peers; bounded attempts.

        ``forward_fn(peer) -> (result, leader_hint, ok)``."""
        tried: set = set()
        target: Optional[str] = None  # None = local
        for _ in range(4):
            if target is None or target == self.node_id:
                try:
                    return local_fn()
                except NotLeaderError as e:
                    tried.add(self.node_id)
                    target = e.leader or self._next_untried(tried)
            else:
                result, hint, ok = forward_fn(target)
                if ok:
                    return result
                tried.add(target)
                target = hint or self._next_untried(tried)
            if target is None:
                break
        raise NotLeaderError(None)

    def _next_untried(self, tried: set) -> Optional[str]:
        for nid in sorted(self.peers):
            if nid not in tried:
                return nid
        return None

    def _forward(self, peer: str, group: int, batch: bytes, timeout: float):
        url = f"{self.peers[peer]}/raft-propose/{group}"
        req = urllib.request.Request(
            url, data=batch, headers={"Content-Type": "application/octet-stream"}
        )
        try:
            # budget = the proposal timeout (the old blanket `timeout+2`
            # survives only as the RESILIENCE=0 single-shot timeout);
            # transport failures retry with backoff inside the budget,
            # 409 leader hints come back instantly as HTTPError.
            # slice_budget=False: a forwarded proposal legitimately
            # BLOCKS while the leader commits+applies, so the FIRST
            # attempt must own the whole window — a half-window slice
            # times out work about to succeed and re-POSTs a duplicate
            # batch at the slow leader (the amplification loop the
            # propose_patience docstring describes); the retry only
            # fires on fast transport failures that leave the budget
            # intact
            with self.peerclient.urlopen(
                peer, req, op="forward",
                budget=timeout, attempts=2, off_timeout=timeout + 2,
                slice_budget=False,
            ) as resp:
                resp.read()
                return None, None, True
        except urllib.error.HTTPError as e:
            if e.code == 409:  # not the leader; body is the hint (or empty)
                hint = e.read().decode("utf-8").strip()
                return None, (hint or None), False
            return None, None, False
        except OSError:
            return None, None, False

    def _propose_lease(self, new_max: int) -> None:
        self.propose_records(METADATA_GROUP, [codec.encode_lease(new_max)])

    # -- cross-server reads (ServeTask analog, worker/task.go:54-68) --------

    def _iter_replicas(self, gid: int, op: str, timeout: float):
        """Shared cross-server-read replica walk: yields
        ``(nid, addr, per_replica_budget)`` for ``gid``'s servers,
        healthiest replica first (AnyServer read balancing, breaker-
        aware: the replica that just timed out sorts last, and its open
        breaker sheds in microseconds rather than re-stalling).  The
        overall ``timeout`` budget is split over the replicas still
        untried — a cold-breaker blackholed first replica must not
        starve a healthy second one of its chance (the last replica
        keeps everything that is left) — and iteration stops once the
        budget is spent (legacy one-shot semantics keep going when
        resilience is off)."""
        import time as _time

        deadline = _time.monotonic() + timeout
        members = self.peerclient.order_by_health(
            self.servers_of_group(gid), op=op
        )
        for i, (nid, addr) in enumerate(members):
            remaining = deadline - _time.monotonic()
            if remaining <= 0 and resilience_enabled():
                break  # the fetch's OVERALL budget is spent
            yield nid, addr, remaining / (len(members) - i)

    def fetch_pred_snapshot(
        self, pred: str, gid: int, since: int, timeout: float = 10.0
    ):
        """Pull a predicate snapshot from a server of its owning group.

        Returns (version, payload-bytes) — payload None when the remote
        copy is unchanged since ``since``.  Data ships to the query (the
        inversion of the reference's per-task fan-out): the reader caches
        the predicate and builds device arenas from it locally, so one
        transfer serves every subsequent query until the owner mutates.
        Raises OSError when no owning server is reachable."""
        from urllib.parse import quote

        last_err: Optional[Exception] = None
        for nid, addr, per_replica in self._iter_replicas(
            gid, "snapshot", timeout
        ):
            url = (
                f"{addr}/pred-snapshot?name="
                + quote(pred, safe="")
                + f"&since={since}"
            )
            req = urllib.request.Request(url)
            try:
                with self.peerclient.urlopen(
                    nid, req, op="snapshot",
                    budget=per_replica, off_timeout=timeout,
                ) as resp:
                    ver = int(resp.headers.get("X-Pred-Version", "0"))
                    if resp.status == 204:
                        return ver, None
                    return ver, resp.read()
            except urllib.error.HTTPError as e:
                if e.code == 304:
                    return since, None
                last_err = e
            except OSError as e:
                last_err = e
            except http.client.HTTPException as e:
                # an owner killed MID-RESPONSE truncates the body:
                # resp.read() raises IncompleteRead — an HTTPException,
                # not an OSError — after the peerclient attempt already
                # counted success.  Same remedy as a transport error:
                # try the next replica (legacy one-shot semantics keep
                # the pre-PR immediate propagation)
                if not resilience_enabled():
                    raise
                last_err = e
        raise last_err or OSError(f"no server for group {gid}")

    def fetch_predlist(self, gid: int, timeout: float = 5.0) -> Optional[List[str]]:
        """Predicate names a remote group currently stores; None when no
        owning server is reachable (distinct from a legitimately empty
        group, so stale caches converge after deletes)."""
        import json as _json

        for nid, addr, per_replica in self._iter_replicas(
            gid, "predlist", timeout
        ):
            req = urllib.request.Request(f"{addr}/predlist?group={gid}")
            try:
                with self.peerclient.urlopen(
                    nid, req, op="predlist",
                    budget=per_replica, off_timeout=timeout,
                ) as resp:
                    return list(_json.loads(resp.read()))
            except (urllib.error.HTTPError, OSError):
                continue
        return None

    # -- uid assignment (leader-only, worker/assign.go:59) ------------------

    def assign_local(self, n: int):
        """Assign n uids on THIS server; only the metadata leader may
        (assignUids asserts leadership, worker/assign.go:37)."""
        node = self.groups[METADATA_GROUP].node
        if not node.is_leader:
            raise NotLeaderError(node.leader_id)
        # a freshly-elected leader resumes above every lease any previous
        # leader durably recorded (resetLease on leader change, lease.go:57)
        meta_next = self.groups[METADATA_GROUP].store.uids.max_uid + 1
        if self.lease._leased < meta_next:
            self.lease.init_from_recovery(meta_next)
        return self.lease.assign(n)

    def assign_uids(self, n: int):
        """Route assignment to the metadata leader (AssignUidsOverNetwork)."""
        return self._route_to_leader(
            lambda: self.assign_local(n),
            lambda peer: self._forward_assign(peer, n),
        )

    def reserve_local(self, uid: int) -> Tuple[int, int]:
        """Leader-side explicit-uid reservation: the LEADER's allocation
        cursor must skip uids named explicitly in mutations, even inside
        the already-leased window — a follower-local note would let the
        leader hand the same uid to a blank node later."""
        node = self.groups[METADATA_GROUP].node
        if not node.is_leader:
            raise NotLeaderError(node.leader_id)
        meta_next = self.groups[METADATA_GROUP].store.uids.max_uid + 1
        if self.lease._leased < meta_next:
            self.lease.init_from_recovery(meta_next)
        self.lease.reserve_through(uid)
        return (uid, uid)

    def reserve_uid(self, uid: int) -> None:
        self._route_to_leader(
            lambda: self.reserve_local(uid),
            lambda peer: self._forward_assign(peer, -uid),  # negative = reserve
        )

    def _forward_assign(self, peer: str, n: int):
        url = f"{self.peers[peer]}/assign-uids"
        req = urllib.request.Request(url, data=str(n).encode())
        try:
            with self.peerclient.urlopen(peer, req, op="assign", budget=10) as resp:
                import json

                got = json.loads(resp.read())
                return (int(got["start"]), int(got["end"])), None, True
        except urllib.error.HTTPError as e:
            if e.code == 409:
                hint = e.read().decode("utf-8").strip()
                return None, (hint or None), False
            return None, None, False
        except OSError:
            return None, None, False


class _ClusterUids:
    """uid allocation facade: fresh uids via the replicated lease, xids via
    XID records on the metadata group (worker/assign.go semantics)."""

    def __init__(self, svc: ClusterService):
        self._svc = svc

    @property
    def _meta(self):
        return self._svc.groups[METADATA_GROUP].store.uids

    @property
    def max_uid(self) -> int:
        return max(self._svc.lease.max_assigned, self._meta.max_uid)

    def __len__(self) -> int:
        return len(self._meta)

    def fresh(self, n: int = 1) -> List[int]:
        start, end = self._svc.assign_uids(n)
        return list(range(start, end + 1))

    def assign(self, xid: str) -> int:
        existing = self._meta.lookup(xid)
        if existing is not None:
            return existing
        uid = self.fresh(1)[0]
        self._svc.propose_records(METADATA_GROUP, [codec.encode_xid(xid, uid)])
        # the applied map is authoritative (first XID record in log order
        # wins on every replica); on a follower the local apply can lag the
        # leader's commit, so wait for our record to land
        self._svc._wait_local_apply(lambda: self._meta.lookup(xid) is not None)
        got = self._meta.lookup(xid)
        return got if got is not None else uid

    def lookup(self, xid: str) -> Optional[int]:
        return self._meta.lookup(xid)

    def assign_many(self, xids) -> List[int]:
        return [self.assign(x) for x in xids]

    def reserve_through(self, uid: int) -> None:
        """Explicit uids route to the metadata LEADER's allocator (like
        fresh assignment): only its cursor decides future uids, so a
        follower-local note would not prevent aliasing.  Lease extensions
        batch by min_lease (minLeaseNum, lease.go:88-98)."""
        self._svc.reserve_uid(uid)

    def snapshot(self) -> Dict[str, int]:
        return self._meta.snapshot()


class _PredVersionClock:
    """Per-predicate cache versions for ClusterStore (duck-typed to the
    ``pred_versions`` mapping surface ivm/versions.py and the arena
    manager probe: ``.get(pred, default)`` + ``len()``).

    The obvious implementation — hand back the owning replica's raft
    index — is WRONG across groups: version_for takes a max over the
    footprint, and raft indices from different groups share no scale.
    A footprint {p@groupA, q@groupB} with B's log at index 900 would
    keep version_for pinned at 900 while p bumps 5→6 on A — the bump
    is masked and the stale cache entry keeps serving.  So this clock
    issues CLUSTER-LOCAL monotone ticks: each predicate's tick advances
    exactly when its source version — the owning local replica's
    ``pred_version`` (raft index, scoped to one group) or the remote
    snapshot cache's X-Pred-Version — is observed to change.  Ticks
    from different groups then compose under max() like PostingStore's
    single-scale versions do.

    Process-local by design: the caches these versions key (hop/result
    tiers, arena identity) are process-local too, so a restart starting
    the ticks over matches the caches starting over."""

    def __init__(self, store: "ClusterStore"):
        self._store = store
        self._tick = 0
        self._seen: Dict[str, Tuple[tuple, int]] = {}  # pred -> (src, tick)
        self._floors: Dict[int, int] = {}  # gid -> last-seen group floor
        self._floor_tick = 0
        self._lock = threading.Lock()

    def _source(self, pred: str) -> Optional[tuple]:
        """The pred's current content-version coordinate, or None when
        it has no stable source yet (owner unannounced, or a remote
        pred never fetched).  Never called under self._lock — the
        remote-cache read takes _remote_lock."""
        svc = self._store._svc
        try:
            gid = self._store._owner_gid(pred)
        except OSError:
            return None
        g = svc.groups.get(gid)
        if g is not None:
            # racy read is fine per pred_version's contract: a torn
            # observation at worst issues one extra tick (a cache miss)
            return ("raft", gid, g.pred_version(pred))
        with self._store._remote_lock:
            ent = self._store._remote.get(pred)
        if ent is None:
            return None
        return ("remote", gid, ent[0])

    def get(self, pred: str, default: int = 0) -> int:
        src = self._source(pred)
        with self._lock:
            if src is None:
                # unknown freshness must never look fresh: a new tick
                # per probe keys the entry but can never match it again
                self._tick += 1
                return self._tick
            ent = self._seen.get(pred)
            if ent is not None and ent[0] == src:
                return ent[1]
            self._tick += 1
            self._seen[pred] = (src, self._tick)
            return self._tick

    def floor(self) -> int:
        """The non-scopeable-change floor: advances when any local
        group replica's store floor moves (schema apply, raft snapshot
        restore — bytes_to_state's note_global_change)."""
        svc = self._store._svc
        with self._lock:
            for gid, g in svc.groups.items():
                f = getattr(g.store, "pred_floor", 0)
                prev = self._floors.get(gid)
                if prev is None:
                    self._floors[gid] = f  # first sight: adopt silently
                elif prev != f:
                    self._floors[gid] = f
                    self._tick += 1
                    self._floor_tick = self._tick
            return self._floor_tick

    def __len__(self) -> int:
        with self._lock:
            return len(self._seen)


class ClusterStore:
    """The engine-facing store: replicated writes, snapshot-stable reads.

    Implements PostingStore's read/write surface (duck-typed — the engine
    and serving layer never isinstance-check)."""

    # per-predicate versions exist for CACHE KEYING only: there is no
    # local mutation journal to stream deltas from, so the serving
    # layer must not attach an IVM delta stream or subscriptions here
    # (serve/server.py gates on this)
    supports_ivm_stream = False

    def __init__(self, svc: ClusterService, remote_ttl: float = 0.1):
        self._svc = svc
        self.uids = _ClusterUids(svc)
        self._dirty: set = set()
        self._snaps: Dict[str, PredicateData] = {}
        self._snap_lock = threading.Lock()
        # cross-server read cache: pred -> [version, PredicateData|None,
        # last-freshness-check monotonic time].  Freshness is checked at
        # most every remote_ttl seconds (bounded staleness, matching the
        # reference's eventually-consistent AnyServer reads).  Guarded by
        # its OWN lock: remote fetches block on the network and must never
        # stall local reads holding _snap_lock.
        self._remote: Dict[str, list] = {}
        self._predlists: Dict[int, list] = {}
        # stale-serving bookkeeping: pred -> [gid, last_success_monotonic,
        # last_stale_serve_monotonic] while the owner is unreachable and
        # the cached copy is being served.  Entries clear on the next
        # successful refresh of the predicate, or expire from
        # degraded_info() once no stale read has been SERVED recently —
        # a pred that is never queried again must not flag the node
        # degraded forever after the owner heals.  Guarded by
        # _remote_lock like the caches it shadows.
        self._degraded: Dict[str, list] = {}
        self._remote_lock = threading.Lock()  # guards the cache DICTS only
        # per-key fetch locks: one unreachable owner must stall only its
        # own key, not the whole cross-server read plane.  Keys are either
        # a predicate name (_remote_peek) or ("__predlist__", gid)
        # (predicates) — tuples can never collide with predicate strings.
        self._fetch_locks: Dict[object, threading.Lock] = {}
        self.remote_ttl = remote_ttl
        # per-predicate cache versions: hop/arena caches key on
        # the touched predicate's tick instead of the global sum, so a
        # write to one group no longer invalidates every other group's
        # cached expansions (ivm/versions.py version_for)
        self.pred_versions = _PredVersionClock(self)

    @property
    def dirty(self) -> set:
        """Drains the replicas' dirty marks on every read so consumers that
        watch ``store.dirty`` directly (ArenaManager.refresh) see replica
        applies without a peek() having run first."""
        with self._snap_lock:
            self._drain_dirty()
            return self._dirty

    # remote TTL-cached predicates refresh WITHOUT a version bump, and
    # those refreshes only fire during query execution — a tier-2 result
    # cache hit (which skips execution) would therefore starve the
    # freshness probe and serve the stale copy forever.  Declaring the
    # version non-strict keeps tier 2 off for clustered reads; tier 1
    # stays on (arena identity keys it, and a remote refresh marks the
    # predicate dirty → the arena rebuilds under a new identity).
    strict_snapshot_versions = False

    @property
    def version(self) -> int:
        """Snapshot version for the cohort scheduler's admission
        signature (PostingStore.version analog): local replica applies
        bump it.  Remote TTL-cached predicates refresh without a bump,
        but their staleness window (remote_ttl) dwarfs a cohort's queue
        time anyway — the signature only needs to split cohorts across
        LOCAL mutation boundaries."""
        return sum(
            getattr(g.store, "version", 0)
            for g in self._svc.groups.values()
        )

    @property
    def pred_floor(self) -> int:
        """The version_for floor (non-scopeable changes) on the
        cluster clock's scale — see _PredVersionClock.floor."""
        return self.pred_versions.floor()

    # -- schema (metadata group) -------------------------------------------

    @property
    def schema(self) -> SchemaState:
        return self._svc.groups[METADATA_GROUP].store.schema

    def apply_schema(self, text: str) -> None:
        from dgraph_tpu_torch.models.schema import parse_schema

        want = parse_schema(text, into=SchemaState())  # validate first
        self._svc.propose_records(METADATA_GROUP, [codec.encode_schema(text)])
        # On a follower the proposal is forwarded to the leader and the
        # LOCAL apply can lag its commit; a set block in the same request
        # would then convert values against the stale schema, durably
        # storing wrong-typed values.  Wait until every proposed predicate
        # is visible locally (later schema records for the same predicate
        # in log order simply overwrite, so observing ours is sufficient).
        ok = self._svc._wait_local_apply(
            lambda: all(
                self.schema._preds.get(p.name) == p
                for p in want._preds.values()
            )
        )
        if not ok:
            # the proposal IS durably committed at this point — only the
            # local apply is lagging.  Say so precisely: retrying the whole
            # request is safe (same-text schema records are idempotent
            # overwrites), but the client must know the schema itself did
            # not fail.
            raise TimeoutError(
                "schema change committed but not yet applied on this replica "
                "after 5s; retry the request (idempotent) or query another server"
            )

    # -- reads (snapshot copies of local replicas) --------------------------

    def _owner_gid(self, pred: str) -> int:
        """The group that PLACES this predicate.  Local groups and groups
        some peer serves route truthfully.  A group nobody is KNOWN to
        place: in a placement-aware cluster that's a transient state
        (owners announce via MEMBER records) and must fail loudly — a
        metadata-group fallback would durably commit writes where future
        reads will never look.  Only legacy full-replication clusters
        (no placement info beyond ourselves) keep the old fallback."""
        gid = self._svc.conf.belongs_to(pred)
        if gid in self._svc.groups or self._svc.servers_of_group(gid):
            return gid
        if len(self._svc.peer_groups) > 1:
            raise OSError(
                f"group {gid} has no known server yet (owner not announced); "
                "retry shortly"
            )
        return METADATA_GROUP

    def _remote_peek(self, pred: str, gid: int) -> Optional[PredicateData]:
        """Read a predicate another group owns: versioned snapshot pull
        with a TTL-gated freshness probe.  Serves the cached copy when the
        owner is unreachable (stale reads beat unavailability for the
        read plane; writes still require the owner's quorum), recording
        the degradation so responses carry a ``degraded`` annotation.  A
        reader with NO cached copy raises StaleUnavailableError — the
        serving layer maps it to 503 + Retry-After / gRPC UNAVAILABLE
        instead of a raw 500.  Holds only _remote_lock — the network
        fetch must never stall local reads."""
        import time as _time

        from dgraph_tpu_torch.cluster.replica import bytes_to_pred
        from dgraph_tpu_torch.utils.failpoints import fail
        from dgraph_tpu_torch.utils.metrics import DEGRADED_READS

        with self._remote_lock:
            ent = self._remote.get(pred)
            now = _time.monotonic()
            if ent is not None and now - ent[2] < self.remote_ttl:
                d = self._degraded.get(pred)
                if d is not None:
                    d[2] = now  # this response still serves the stale copy
                return ent[1]
            flock = self._fetch_locks.setdefault(pred, threading.Lock())
        with flock:  # only THIS predicate's readers wait on the network
            with self._remote_lock:
                ent = self._remote.get(pred)
                now = _time.monotonic()
                if ent is not None and now - ent[2] < self.remote_ttl:
                    d = self._degraded.get(pred)
                    if d is not None:
                        d[2] = now
                    return ent[1]  # refreshed while we waited for the lock
            since = ent[0] if ent is not None else -1
            try:
                ver, payload = self._svc.fetch_pred_snapshot(pred, gid, since)
                # a payload that FAILS TO DECODE degrades the same way an
                # unreachable owner does: the cached copy outranks an
                # error (ValueError/IndexError = corrupt frame,
                # http.client.IncompleteRead = owner died mid-response)
                fail.point("service.snapshot_decode")
                pd = ent[1] if payload is None else bytes_to_pred(payload, pred)
            except (
                OSError,
                ValueError,
                IndexError,
                http.client.HTTPException,
            ) as e:
                if not resilience_enabled() and not isinstance(e, OSError):
                    # legacy escape hatch is byte-identical to pre-PR:
                    # only the TRANSPORT class (OSError) fell back to the
                    # cached copy; a corrupt/truncated frame propagated.
                    # Serving stale here would mask corruption with both
                    # the annotation and the counter gated off.
                    raise
                if ent is None:
                    if resilience_enabled():
                        raise StaleUnavailableError(
                            f"predicate {pred!r}: owner group {gid} "
                            "unreachable and no cached snapshot to "
                            "degrade to",
                            retry_after=self._svc.peerclient.breaker_cooldown,
                        ) from e
                    raise
                with self._remote_lock:
                    now = _time.monotonic()
                    ent[2] = now  # unreachable: serve stale
                    if resilience_enabled():
                        self._degraded[pred] = [gid, ent[3], now]
                if resilience_enabled():
                    DEGRADED_READS.add(1)
                return ent[1]
            changed = ent is not None and payload is not None
            now = _time.monotonic()
            with self._remote_lock:
                self._remote[pred] = [ver, pd, now, now]
                self._degraded.pop(pred, None)
        if changed:
            with self._snap_lock:
                self._dirty.add(pred)  # arenas rebuild from the fresh copy
        return pd

    def degraded_info(self, preds=None) -> Optional[dict]:
        """The response annotation for stale-served reads: which owner
        groups are being served from cache, and how old the OLDEST such
        cache is (seconds since its last successful refresh).  None when
        nothing is degraded (the overwhelmingly common case).  An entry
        whose predicate hasn't actually SERVED a stale read recently is
        expired — stale serves stopped (owner healed, or nobody reads
        the pred anymore), so the node must stop advertising an outage.

        ``preds`` (gql.ast.referenced_preds, a set — or a zero-arg
        callable producing one, evaluated only once something IS
        degraded so the healthy path never pays the AST walk) scopes the
        answer to the predicates one query can read, so a query that
        never touches a stale group is not falsely branded degraded;
        None = node-wide view (the /health surface)."""
        if not resilience_enabled():
            return None
        import time as _time

        with self._remote_lock:
            if not self._degraded:
                return None
        if callable(preds):
            # the AST walk runs OUTSIDE _remote_lock: during an outage —
            # exactly when _degraded is non-empty and every response
            # lands here — holding the lock through it would serialize
            # the read plane's TTL fast path behind per-query AST walks
            preds = preds()
        with self._remote_lock:
            if not self._degraded:
                return None
            now = _time.monotonic()
            expire = max(5.0, 4.0 * self.remote_ttl)
            for pred in [
                p for p, e in self._degraded.items() if now - e[2] > expire
            ]:
                del self._degraded[pred]
            ents = [
                e for p, e in self._degraded.items()
                if preds is None or p in preds
            ]
            if not ents:
                return None
            gids = sorted({e[0] for e in ents})
            age = max(now - e[1] for e in ents)
        return {"stale_groups": gids, "age": round(age, 3)}

    def _drain_dirty(self) -> None:
        """Caller holds _snap_lock."""
        for g in self._svc.groups.values():
            with g._lock:
                if g.store.dirty:
                    self._dirty |= g.store.dirty
                    if "*" in g.store.dirty:
                        # full-store replacement (raft snapshot restore):
                        # every cached snapshot is stale
                        self._snaps.clear()
                    else:
                        for p in g.store.dirty:
                            self._snaps.pop(p, None)
                    g.store.dirty.clear()

    def peek(self, name: str) -> Optional[PredicateData]:
        gid = self._owner_gid(name)
        g = self._svc.groups.get(gid)
        if g is None:  # another group's data: cross-server read (own lock)
            return self._remote_peek(name, gid)
        with self._snap_lock:
            self._drain_dirty()
            snap = self._snaps.get(name)
            if snap is None:
                with g._lock:
                    live = g.store.peek(name)
                    if live is None:
                        return None
                    snap = _copy_pred(live)
                self._snaps[name] = snap
            return snap

    def pred(self, name: str) -> PredicateData:
        return self.peek(name) or PredicateData()

    def predicates(self) -> List[str]:
        out: set = set()
        for g in self._svc.groups.values():
            with g._lock:
                out.update(g.store._preds.keys())
        # union in the predicates of groups this server does not place
        # (expand(_all_) / export must see the whole graph)
        import time as _time

        for gid in self._svc.conf.known_groups():
            if gid in self._svc.groups:
                continue
            # same lock rule as _remote_peek: _remote_lock guards the cache
            # dicts only — the network fetch happens outside it, serialized
            # per-gid by a fetch lock so one unreachable group (5s timeout)
            # never stalls _remote_peek readers or other groups' fetches
            with self._remote_lock:
                now = _time.monotonic()
                ent = self._predlists.get(gid)
                if ent is not None and now - ent[1] < self.remote_ttl:
                    out.update(ent[0])
                    continue
                flock = self._fetch_locks.setdefault(
                    ("__predlist__", gid), threading.Lock()
                )
            with flock:
                with self._remote_lock:
                    ent = self._predlists.get(gid)
                    if ent is not None and _time.monotonic() - ent[1] < self.remote_ttl:
                        out.update(ent[0])
                        continue
                names = self._svc.fetch_predlist(gid)
                with self._remote_lock:
                    if names is None:  # owner unreachable: keep stale list
                        names = ent[0] if ent is not None else []
                    self._predlists[gid] = [names, _time.monotonic()]
                    out.update(names)
        return sorted(out)

    def value(self, pred: str, uid: int, lang: str = ""):
        p = self.peek(pred)
        if p is None:
            return None
        v = p.values.get((uid, lang))
        if v is None and lang:
            v = p.values.get((uid, ""))
        return v

    def any_value(self, pred: str, uid: int):
        p = self.peek(pred)
        if p is None:
            return None
        v = p.values.get((uid, ""))
        if v is not None:
            return v
        for (u, _l), val in p.values.items():
            if u == uid:
                return val
        return None

    def neighbors(self, pred: str, uid: int) -> List[int]:
        p = self.peek(pred)
        if p is None:
            return []
        return sorted(p.edges.get(uid, ()))

    def edge_count(self) -> int:
        total = 0
        for g in self._svc.groups.values():
            with g._lock:  # raft applies mutate these dicts concurrently
                total += sum(
                    sum(len(s) for s in p.edges.values()) + len(p.values)
                    for p in g.store._preds.values()
                )
        return total

    # -- writes (raft proposals, partitioned by owning group) --------------

    def apply(self, e: Edge) -> None:
        self.apply_many([e])

    def apply_many(self, edges) -> int:
        by_group: Dict[int, List[bytes]] = {}
        n = 0
        for e in edges:
            by_group.setdefault(self._owner_gid(e.pred), []).append(
                codec.encode_edge(e)
            )
            n += 1
        for gid, records in by_group.items():
            self._svc.propose_records(gid, records)
        return n

    def bulk_set_uid_edges(self, pred: str, src, dst) -> None:
        self._svc.propose_records(
            self._owner_gid(pred), [codec.encode_bulk_edges(pred, src, dst)]
        )

    def bulk_set_values(self, pred: str, items) -> None:
        if not items:
            return
        self._svc.propose_records(
            self._owner_gid(pred), [codec.encode_bulk_values(pred, items)]
        )

    def delete_predicate(self, pred: str) -> None:
        self._svc.propose_records(
            self._owner_gid(pred), [codec.encode_delpred(pred)]
        )

    def set_edge(self, pred: str, src: int, dst: int, facets=None):
        self.apply(Edge(pred=pred, src=src, dst=dst, facets=facets))

    def del_edge(self, pred: str, src: int, dst: int):
        self.apply(Edge(pred=pred, src=src, dst=dst, op="del"))


def _copy_pred(p: PredicateData) -> PredicateData:
    out = PredicateData()
    out.edges = {u: set(s) for u, s in p.edges.items()}
    out.values = dict(p.values)
    out.edge_facets = {k: dict(v) for k, v in p.edge_facets.items()}
    out.value_facets = {k: dict(v) for k, v in p.value_facets.items()}
    return out
