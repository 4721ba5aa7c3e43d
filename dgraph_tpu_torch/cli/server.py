"""Server binary of the port:

    python -m dgraph_tpu_torch.cli.server --p DIR --port 8080 [--sync] [--device cpu]

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

Serves ``/query``, ``/health``, ``/metrics``, ``/admin/snapshot``,
``/admin/export`` and ``/admin/shutdown``.  The engine runs on ``cuda``
unless ``--device cpu`` is given; without a GPU the default fails at
start-up.  Reads go through the cohort scheduler, steered by the
reference's environment knobs (``DGRAPH_TPU_SCHED``,
``DGRAPH_TPU_SCHED_*``, ``DGRAPH_TPU_QOS*``, ``DGRAPH_TPU_CACHE*``,
``DGRAPH_TPU_IVM``, ``DGRAPH_TPU_SEGMENT*``).  The reference's gRPC,
cluster and tracing flags are not ported yet.
"""

from __future__ import annotations

import argparse
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
    opts = ap.parse_args(argv)
    # the device first: a missing GPU fails start-up before the disk is
    # touched
    device = resolve(opts.device)
    store = DurableStore(opts.postings_dir, sync_writes=opts.sync_writes)
    r = store.recovery
    records = r["snapshot_records"] + r["segment_records"] + r["wal_records"]
    print(f"recovered {opts.postings_dir}: records={records} "
          f"(snapshot {r['snapshot_records']}, segments {r['segment_records']}, "
          f"wal {r['wal_records']}) torn_bytes={r['torn_bytes']} "
          f"seconds={r['duration_s']}", flush=True)
    srv = DgraphServer(
        store, port=opts.port, bind=opts.bind, device=device,
        arena_budget_mb=opts.arena_budget_mb, export_path=opts.export_path,
    )
    # explicit flags win over the environment the snapshotter read
    if opts.snapshot_wal_mb:
        srv.snapshotter.wal_bytes = int(opts.snapshot_wal_mb * (1 << 20))
    if opts.snapshot_wal_records:
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


if __name__ == "__main__":
    sys.exit(main())
