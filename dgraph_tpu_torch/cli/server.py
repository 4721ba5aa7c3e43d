"""Server binary of the port:

    python -m dgraph_tpu_torch.cli.server --p DIR --port 8080 [--sync] [--device cpu]
    python -m dgraph_tpu_torch.cli.server --config conf.yaml [--dumpsg DIR] \
        [--cpu cpu.pstats] [--mem mem.txt] [--memory_mb 8192]
    python -m dgraph_tpu_torch.cli.server --p DIR --port 8081 --idx 1 --groups 0,1 \
        --peer 1@127.0.0.1:8081,2@127.0.0.1:8082,3@127.0.0.1:8083 [--device cpu]
    python -m dgraph_tpu_torch.cli.server --p DIR --port 8081 --idx 1 \
        --tls_cert cert.pem --tls_key key.pem --peer_ca cert.pem \
        --raft_transport grpc --peer 1@127.0.0.1:8081,2@127.0.0.1:8082

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

Options come from the defaults, then ``--config`` (a flat ``key: value``
YAML file of ``utils/config.Options``' field names), then the explicit
flags, which win (the reference's ``build_options``).  ``--memory_mb``
(alias ``--arena_budget_mb``) is the device memory budget of the cached
arenas (0 = 3/4 of free memory on cuda).  ``--dumpsg DIR`` writes each
query's execution-shape tree as JSON into DIR.  ``--cpu PATH`` profiles
query execution with cProfile (the server then runs the serial path)
and ``--mem PATH`` traces allocations with tracemalloc; both are
written at shutdown (pstats, and the top 50 lines as text).  ``--w``,
``--workers``, ``--num_pending`` and ``--max_edges`` are accepted and
kept in the options, as the reference keeps them.

Multi-device: the server builds its mesh as ``DgraphServer`` does
(``DGRAPH_TPU_MESH``: ``auto`` shards over every card when there are two
or more, ``force`` over the one card too, ``0`` never;
``DGRAPH_TPU_MESH_SHARD_ROWS`` the rows a predicate needs to shard);
there is no flag for virtual chips.

Clustered (``--peer``, or ``--join`` a live member): the server is
node ``--idx`` of a Raft cluster serving the groups ``--groups`` (group 0,
the metadata group, always), placed by ``--peer_groups`` ("1=0,1;2=0,2",
absent peers serve every group) and reached by its peers at ``--my``
(default ``http://127.0.0.1:<port>``).  ``--p`` is then the directory of
the raft logs and snapshots (``raft-g<N>/``), as in the reference; it
prints ``cluster node N groups [...] peers {...}`` then ``serving on``.
``--cluster_secret`` gates the intra-cluster endpoints.  Raft frames
travel over HTTP(S), or with ``--raft_transport grpc`` over the gRPC
Worker plane (``/protos.Worker/RaftMessage`` at each peer's HTTP port +
the same offset as this server's ``--grpc_port``; it needs an explicit
``--port``, an enabled gRPC listener and grpcio, else it exits 2).

``--grpc_port`` is the gRPC listener (``protos.Dgraph``: Run,
CheckVersion, AssignUids, Subscribe; ``protos.Worker``: Echo,
RaftMessage): 0, the default, is the HTTP port + 1000, below 0 turns it
off.  Where grpcio is not importable the server says so and serves HTTP
alone.  ``--tls_cert`` / ``--tls_key`` serve HTTPS and gRPC over TLS (1.2
and up); a TLS server defaults bare peer addresses and ``--my`` to
``https://``.  ``https://`` peers are verified against ``--peer_ca``
(a pinned CA), not at all under ``--peer_tls_insecure``, else against
the system trust store (with a warning).

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
``DGRAPH_TPU_IVM``, ``DGRAPH_TPU_SEGMENT*``).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys

from dgraph_tpu_torch.device import resolve
from dgraph_tpu_torch.models.wal import DurableStore
from dgraph_tpu_torch.serve.server import DgraphServer
from dgraph_tpu_torch.utils.config import Options


def build_options(argv=None) -> Options:
    """Options from the defaults, the ``--config`` YAML, then the
    explicit flags: the YAML's values become the flags' defaults, so an
    explicit flag always wins and a YAML-only key survives."""
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config", default="")
    pre_ns, _ = pre.parse_known_args(argv)
    d = Options()
    if pre_ns.config:
        d = d.merged_with_yaml(pre_ns.config)
    ap = argparse.ArgumentParser(prog="dgraph_tpu_torch.cli.server")
    ap.add_argument("--config", default="", help="YAML config file (flat key: value)")
    ap.add_argument("--p", dest="postings_dir", default=d.postings_dir,
                    help="directory of the WAL, its sealed segments and snapshots")
    ap.add_argument("--w", dest="wal_dir", default=d.wal_dir,
                    help="(reserved) separate WAL directory; the WAL lives in --p")
    ap.add_argument("--sync", dest="sync_writes", action="store_true",
                    default=d.sync_writes,
                    help="fsync the WAL before a mutation is acknowledged")
    ap.add_argument("--snapshot_wal_mb", type=float, default=d.snapshot_wal_mb,
                    help="seal+compact the WAL once it passes this many MB "
                         "(0 = env DGRAPH_TPU_SNAPSHOT_WAL_MB or 64)")
    ap.add_argument("--snapshot_wal_records", type=int,
                    default=d.snapshot_wal_records,
                    help="seal+compact once this many records are journaled "
                         "(0 = env DGRAPH_TPU_SNAPSHOT_WAL_RECORDS or 200000)")
    ap.add_argument("--export", dest="export_path", default=d.export_path,
                    help="directory /admin/export writes to")
    ap.add_argument("--port", type=int, default=d.port,
                    help="HTTP port (0 = any free port)")
    ap.add_argument("--grpc_port", type=int, default=d.grpc_port,
                    help="gRPC listener port (protos.Dgraph service); "
                         "0 = http port + 1000, below 0 disables")
    ap.add_argument("--tls_cert", default=d.tls_cert,
                    help="PEM certificate chain: serve HTTPS and gRPC over TLS")
    ap.add_argument("--tls_key", default=d.tls_key,
                    help="PEM key of --tls_cert (empty = inside the cert file)")
    ap.add_argument("--bind", default=d.bind, help="address to listen on")
    ap.add_argument("--device", default=d.device,
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--memory_mb", "--arena_budget_mb", dest="memory_mb",
                    type=int, default=d.memory_mb,
                    help="device memory budget for cached arenas in MB "
                         "(0 = 3/4 of free memory on cuda)")
    ap.add_argument("--dumpsg", default=d.dumpsg,
                    help="directory to dump each query's execution-shape "
                         "tree as JSON")
    ap.add_argument("--cpu", dest="cpu_profile", default=d.cpu_profile,
                    help="write a CPU profile of query execution (pstats "
                         "format) here at shutdown")
    ap.add_argument("--mem", dest="mem_profile", default=d.mem_profile,
                    help="write a memory allocation profile (tracemalloc "
                         "top-50 text) here at shutdown")
    ap.add_argument("--workers", type=int, default=d.workers)
    ap.add_argument("--num_pending", type=int, default=d.num_pending)
    ap.add_argument("--max_edges", type=int, default=d.max_edges)
    # cluster identity (the reference's --idx/--groups/--peer family)
    ap.add_argument("--idx", dest="raft_id", type=int, default=d.raft_id,
                    help="this server's raft node id")
    ap.add_argument("--groups", dest="group_ids", default=d.group_ids,
                    help="comma-separated groups this server serves (0 = metadata)")
    ap.add_argument("--peer", default=d.peer,
                    help='cluster members "1@host:port,2@host:port" (self included)')
    ap.add_argument("--peer_groups", default=d.peer_groups,
                    help='per-peer group placement "1=0,1;2=0,2"; absent '
                         "peers serve every group")
    ap.add_argument("--join", default=d.join,
                    help="address of a live cluster member; boot as a "
                         "joining node and acquire membership at runtime")
    ap.add_argument("--my", dest="my_addr", default=d.my_addr,
                    help="address peers reach this server at "
                         "(default http://127.0.0.1:<port>)")
    ap.add_argument("--cluster_secret", default=d.cluster_secret,
                    help="shared secret required on intra-cluster endpoints "
                         "(/raft*, /assign-uids, /join, /pred-snapshot, "
                         "/predlist); empty disables the gate")
    ap.add_argument("--peer_ca", default=d.peer_ca,
                    help="PEM CA bundle to verify peer TLS certs against "
                         "(CA pinning for the raft plane)")
    ap.add_argument("--peer_tls_insecure", action="store_true",
                    default=d.peer_tls_insecure,
                    help="explicitly skip peer TLS verification "
                         "(throwaway self-signed clusters only)")
    ap.add_argument("--trace", dest="trace_ratio", type=float,
                    default=d.trace_ratio,
                    help="share of requests sampled into the flight recorder "
                         "(DGRAPH_TPU_TRACE_RATIO wins when set)")
    ap.add_argument("--expose_trace", action="store_true",
                    default=d.expose_trace,
                    help="serve /debug/traces, /debug/slow_queries and "
                         "/debug/requests")
    ap.add_argument("--raft_transport", default=d.raft_transport,
                    choices=("http", "grpc"),
                    help="raft frame carrier between servers; grpc uses "
                         "/protos.Worker/RaftMessage at peer http port + "
                         "the gRPC offset")
    ns = ap.parse_args(argv)
    return Options(**{**d.__dict__,
                      **{k: v for k, v in vars(ns).items() if k != "config"}})


def _write_profiles(opts, profiler) -> None:
    """The shutdown profiles: cProfile's pstats file and tracemalloc's
    top 50 lines by size."""
    if profiler is not None:
        profiler.dump_stats(opts.cpu_profile)
        print(f"cpu profile written to {opts.cpu_profile}", flush=True)
    if opts.mem_profile:
        import tracemalloc

        snap = tracemalloc.take_snapshot()
        with open(opts.mem_profile, "w") as f:
            for stat in snap.statistics("lineno")[:50]:
                f.write(str(stat) + "\n")
        print(f"memory profile written to {opts.mem_profile}", flush=True)


def main(argv=None) -> int:
    opts = build_options(argv)
    # the gRPC listener this process binds (0 = http port + 1000)
    grpc_port = (
        -1
        if opts.grpc_port < 0
        else (opts.grpc_port or (opts.port + 1000 if opts.port else 0))
    )
    if opts.raft_transport == "grpc":
        # fail fast: a node whose raft plane is gRPC but that serves no
        # gRPC listener (or lacks grpcio) can neither send nor receive
        # frames — it would boot, never elect, and give no hint why
        if grpc_port <= 0 or opts.port <= 0:
            print("--raft_transport grpc requires explicit --port and an "
                  "enabled gRPC listener (--grpc_port >= 0); peers derive "
                  "each other's raft targets as http port + the same offset",
                  file=sys.stderr)
            return 2
        try:
            import grpc  # noqa: F401
        except ImportError:
            print("--raft_transport grpc requires grpcio, which is not "
                  "importable in this environment", file=sys.stderr)
            return 2
    # the device first: a missing GPU fails start-up before the disk is
    # touched
    device = resolve(opts.device or None)
    # profiles: cProfile covers query execution (enabled per request on
    # the serial path), tracemalloc the whole process from here
    profiler = None
    if opts.cpu_profile:
        import cProfile

        profiler = cProfile.Profile()
    if opts.mem_profile:
        import tracemalloc

        tracemalloc.start(10)
    cluster = None
    if opts.peer or opts.join:
        try:
            cluster = _boot_cluster(opts, grpc_port)
        except ValueError as e:  # e.g. an https peer over gRPC without --peer_ca
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
        arena_budget_mb=opts.memory_mb, export_path=opts.export_path,
        cluster=cluster, trace_ratio=obs.get_recorder().sampler.ratio,
        expose_trace=opts.expose_trace, tls_cert=opts.tls_cert,
        tls_key=opts.tls_key, profiler=profiler, dumpsg_path=opts.dumpsg,
    )
    # explicit flags win over the environment the snapshotter read
    if srv.snapshotter is not None and opts.snapshot_wal_mb:
        srv.snapshotter.wal_bytes = int(opts.snapshot_wal_mb * (1 << 20))
    if srv.snapshotter is not None and opts.snapshot_wal_records:
        srv.snapshotter.wal_records = opts.snapshot_wal_records
    srv.start()

    def _on_signal(_sig, _frm):
        # a second signal must not re-enter stop() while the first holds
        # its (non-reentrant) lock
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        srv.stop()

    # before the serving line: a client that signals as soon as it reads
    # it must find the handlers in place
    signal.signal(signal.SIGINT, _on_signal)
    signal.signal(signal.SIGTERM, _on_signal)
    print(f"serving on {srv.addr} (device {srv.engine.device})", flush=True)
    grpc_srv = None
    if grpc_port >= 0:
        try:
            from dgraph_tpu_torch.serve.grpc_server import GrpcServer

            grpc_srv = GrpcServer(srv, bind=opts.bind, port=grpc_port)
            grpc_srv.start()
            print(f"gRPC (protos.Dgraph) at {opts.bind}:{grpc_srv.port}", flush=True)
        except ImportError:
            # a missing transport library, not a device fallback: the
            # HTTP surface serves on, as the reference's does
            print("grpcio unavailable; gRPC surface disabled", file=sys.stderr)
            grpc_srv = None
    srv.wait()
    if grpc_srv is not None:
        grpc_srv.stop()
    _write_profiles(opts, profiler)
    return 0


def _boot_cluster(opts, grpc_port: int):
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

    scheme = "https" if opts.tls_cert else "http"
    my_addr = opts.my_addr or f"{scheme}://127.0.0.1:{opts.port}"
    group_ids = [int(g) for g in opts.group_ids.split(",") if g.strip()]
    common = dict(
        node_id=str(opts.raft_id),
        my_addr=my_addr,
        group_ids=group_ids,
        directory=opts.postings_dir,
        sync_writes=opts.sync_writes,
        secret=opts.cluster_secret,
        peer_ca=opts.peer_ca,
        peer_tls_insecure=opts.peer_tls_insecure,
        raft_transport=opts.raft_transport,
        grpc_port_offset=max(0, grpc_port - opts.port),
    )
    if opts.join and not opts.peer:
        cluster = ClusterService(
            peers={str(opts.raft_id): my_addr}, passive=True, **common
        )
        cluster.start()
        cluster.join_cluster(opts.join)
        return cluster
    cluster = ClusterService(
        peers=parse_peers(opts.peer, default_scheme=scheme),
        peer_groups=parse_peer_groups(opts.peer_groups),
        **common,
    )
    if (
        any(a.startswith("https://") for a in cluster.peers.values())
        and not opts.peer_ca
        and not opts.peer_tls_insecure
    ):
        print("warning: TLS peers will be verified against the system "
              "trust store; for self-signed cluster certs pass --peer_ca "
              "(pin) or --peer_tls_insecure", file=sys.stderr)
    cluster.start()
    return cluster


if __name__ == "__main__":
    sys.exit(main())
