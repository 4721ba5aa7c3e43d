"""Server binary of the port:

    python -m dgraph_tpu_torch.cli.server --p DIR --port 8080 [--sync] [--device cpu]
    python -m dgraph_tpu_torch.cli.server --p DIR --port 8081 --idx 1 --groups 0,1 \
        --peer 1@127.0.0.1:8081,2@127.0.0.1:8082,3@127.0.0.1:8083 [--device cpu]

Boots on a ``DurableStore`` in ``--p`` (default ``p``): it replays the
snapshot, the sealed WAL segments and the active WAL, prints the
recovery line (records, torn bytes, seconds), then ``serving on``.  The
storage flags and their defaults are the reference's
(``dgraph_tpu/cli/server.py``, ``dgraph_tpu/utils/config.py``):
``--sync`` fsyncs before a mutation is acknowledged (group commit),
``--snapshot_wal_mb`` / ``--snapshot_wal_records`` set the background
snapshotter's thresholds (0 keeps ``DGRAPH_TPU_SNAPSHOT_WAL_MB`` /
``DGRAPH_TPU_SNAPSHOT_WAL_RECORDS`` or 64 MB / 200,000 records),
``--export`` the directory of ``/admin/export``.

Clustered (``--peer``, or ``--join`` a live member): the server is
node ``--idx`` of a Raft cluster serving the groups ``--groups`` (group 0,
the metadata group, always), placed by ``--peer_groups`` ("1=0,1;2=0,2",
absent peers serve every group) and reached by its peers at ``--my``
(default ``http://127.0.0.1:<port>``).  ``--p`` is then the directory of
the raft logs and snapshots (``raft-g<N>/``), as in the reference; it
prints ``cluster node N groups [...] peers {...}`` then ``serving on``.
``--cluster_secret`` gates the intra-cluster endpoints.  Raft frames
travel over HTTP: ``--raft_transport grpc`` and an ``https://`` peer
exit 2 with a message (the port has neither gRPC nor TLS).

Serves ``/query``, ``/health``, ``/metrics``, ``/admin/snapshot``,
``/admin/export``, ``/admin/cancel``, ``/admin/shutdown`` and the
``/debug/*`` surfaces.  ``--trace R`` samples a share R of requests into
the flight recorder (and the ``/debug/requests`` ring;
``DGRAPH_TPU_TRACE_RATIO`` wins when set); ``--expose_trace`` serves
``/debug/traces``, ``/debug/slow_queries`` and ``/debug/requests``
(403 otherwise).  The engine runs on ``cuda``
unless ``--device cpu`` is given; without a GPU the default fails at
start-up.  Reads go through the cohort scheduler, steered by the
reference's environment knobs (``DGRAPH_TPU_SCHED``,
``DGRAPH_TPU_SCHED_*``, ``DGRAPH_TPU_QOS*``, ``DGRAPH_TPU_CACHE*``,
``DGRAPH_TPU_IVM``, ``DGRAPH_TPU_SEGMENT*``).  The reference's gRPC
and TLS flags are not ported yet.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys

from dgraph_tpu_torch.device import resolve
from dgraph_tpu_torch.models.wal import DurableStore
from dgraph_tpu_torch.serve.server import DgraphServer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dgraph_tpu_torch.cli.server")
    ap.add_argument("--p", dest="postings_dir", default="p",
                    help="directory of the WAL, its sealed segments and snapshots")
    ap.add_argument("--sync", dest="sync_writes", action="store_true",
                    help="fsync the WAL before a mutation is acknowledged")
    ap.add_argument("--snapshot_wal_mb", type=float, default=0.0,
                    help="seal+compact the WAL once it passes this many MB "
                         "(0 = env DGRAPH_TPU_SNAPSHOT_WAL_MB or 64)")
    ap.add_argument("--snapshot_wal_records", type=int, default=0,
                    help="seal+compact once this many records are journaled "
                         "(0 = env DGRAPH_TPU_SNAPSHOT_WAL_RECORDS or 200000)")
    ap.add_argument("--export", dest="export_path", default="export",
                    help="directory /admin/export writes to")
    ap.add_argument("--port", type=int, default=8080, help="HTTP port (0 = any free port)")
    ap.add_argument("--bind", default="127.0.0.1", help="address to listen on")
    ap.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    ap.add_argument("--arena_budget_mb", type=int, default=0,
                    help="device memory budget for cached arenas (0 = 3/4 of free memory on cuda)")
    # cluster identity (the reference's --idx/--groups/--peer family)
    ap.add_argument("--idx", dest="raft_id", type=int, default=1,
                    help="this server's raft node id")
    ap.add_argument("--groups", dest="group_ids", default="0",
                    help="comma-separated groups this server serves (0 = metadata)")
    ap.add_argument("--peer", default="",
                    help='cluster members "1@host:port,2@host:port" (self included)')
    ap.add_argument("--peer_groups", default="",
                    help='per-peer group placement "1=0,1;2=0,2"; absent '
                         "peers serve every group")
    ap.add_argument("--join", default="",
                    help="address of a live cluster member; boot as a "
                         "joining node and acquire membership at runtime")
    ap.add_argument("--my", dest="my_addr", default="",
                    help="address peers reach this server at "
                         "(default http://127.0.0.1:<port>)")
    ap.add_argument("--cluster_secret", default="",
                    help="shared secret required on intra-cluster endpoints "
                         "(/raft*, /assign-uids, /join, /pred-snapshot, "
                         "/predlist); empty disables the gate")
    ap.add_argument("--trace", dest="trace_ratio", type=float, default=0.0,
                    help="share of requests sampled into the flight recorder "
                         "(DGRAPH_TPU_TRACE_RATIO wins when set)")
    ap.add_argument("--expose_trace", action="store_true",
                    help="serve /debug/traces, /debug/slow_queries and "
                         "/debug/requests")
    ap.add_argument("--raft_transport", default="http",
                    help="raft frame carrier between servers: http (grpc "
                         "is not ported and exits 2)")
    opts = ap.parse_args(argv)
    if opts.raft_transport != "http":
        print(f"--raft_transport {opts.raft_transport}: not supported by "
              "this port (http only; the reference's gRPC raft transport "
              "is not ported)", file=sys.stderr)
        return 2
    # the device first: a missing GPU fails start-up before the disk is
    # touched
    device = resolve(opts.device)
    cluster = None
    if opts.peer or opts.join:
        try:
            cluster = _boot_cluster(opts)
        except ValueError as e:  # an https peer: refused, never downgraded
            print(f"cluster configuration refused: {e}", file=sys.stderr)
            return 2
        store = cluster.store
        print(f"cluster node {cluster.node_id} groups {sorted(cluster.groups)} "
              f"peers {cluster.peers}", flush=True)
    else:
        store = DurableStore(opts.postings_dir, sync_writes=opts.sync_writes)
        r = store.recovery
        records = r["snapshot_records"] + r["segment_records"] + r["wal_records"]
        print(f"recovered {opts.postings_dir}: records={records} "
              f"(snapshot {r['snapshot_records']}, segments {r['segment_records']}, "
              f"wal {r['wal_records']}) torn_bytes={r['torn_bytes']} "
              f"seconds={r['duration_s']}", flush=True)
    from dgraph_tpu_torch import obs

    if opts.trace_ratio > 0 and not os.environ.get("DGRAPH_TPU_TRACE_RATIO"):
        obs.configure(ratio=opts.trace_ratio)
    # one knob for both samplers: the /debug/requests ring samples at the
    # flight recorder's ratio (--trace, or DGRAPH_TPU_TRACE_RATIO when set)
    srv = DgraphServer(
        store, port=opts.port, bind=opts.bind, device=device,
        arena_budget_mb=opts.arena_budget_mb, export_path=opts.export_path,
        cluster=cluster, trace_ratio=obs.get_recorder().sampler.ratio,
        expose_trace=opts.expose_trace,
    )
    # explicit flags win over the environment the snapshotter read
    if srv.snapshotter is not None and opts.snapshot_wal_mb:
        srv.snapshotter.wal_bytes = int(opts.snapshot_wal_mb * (1 << 20))
    if srv.snapshotter is not None and opts.snapshot_wal_records:
        srv.snapshotter.wal_records = opts.snapshot_wal_records
    srv.start()
    print(f"serving on {srv.addr} (device {srv.engine.device})", flush=True)

    def _on_signal(_sig, _frm):
        # a second signal must not re-enter stop() while the first holds
        # its (non-reentrant) lock
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        srv.stop()

    signal.signal(signal.SIGINT, _on_signal)
    signal.signal(signal.SIGTERM, _on_signal)
    srv.wait()
    return 0


def _boot_cluster(opts):
    """The clustered and joining boots (the reference's
    ``dgraph_tpu/cli/server.py``): a ``ClusterService`` over the raft
    logs in ``--p``, started before the HTTP surface.  A joiner boots
    passive with only itself as a member, then announces itself to
    ``--join`` and adopts the peer map it gets back."""
    from dgraph_tpu_torch.cluster.service import (
        ClusterService,
        parse_peer_groups,
        parse_peers,
    )

    my_addr = opts.my_addr or f"http://127.0.0.1:{opts.port}"
    group_ids = [int(g) for g in opts.group_ids.split(",") if g.strip()]
    if opts.join and not opts.peer:
        cluster = ClusterService(
            node_id=str(opts.raft_id),
            my_addr=my_addr,
            peers={str(opts.raft_id): my_addr},
            group_ids=group_ids,
            directory=opts.postings_dir,
            sync_writes=opts.sync_writes,
            secret=opts.cluster_secret,
            passive=True,
        )
        cluster.start()
        cluster.join_cluster(opts.join)
        return cluster
    cluster = ClusterService(
        node_id=str(opts.raft_id),
        my_addr=my_addr,
        peers=parse_peers(opts.peer),
        group_ids=group_ids,
        directory=opts.postings_dir,
        sync_writes=opts.sync_writes,
        secret=opts.cluster_secret,
        peer_groups=parse_peer_groups(opts.peer_groups),
    )
    cluster.start()
    return cluster


if __name__ == "__main__":
    sys.exit(main())
