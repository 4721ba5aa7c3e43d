"""Server binary of the port:

    python -m dgraph_tpu_torch.cli.server --port 8080 [--device cpu]

Serves ``/query``, ``/health``, ``/metrics`` and ``/admin/shutdown``
over an in-memory store (load data with ``mutation { set { ... } }``
requests).  The engine runs on ``cuda`` unless ``--device cpu`` is
given; without a GPU the default fails at start-up.  Reads go through
the cohort scheduler, steered by the reference's environment knobs
(``DGRAPH_TPU_SCHED``, ``DGRAPH_TPU_SCHED_*``, ``DGRAPH_TPU_QOS*``,
``DGRAPH_TPU_CACHE*``, ``DGRAPH_TPU_IVM``, ``DGRAPH_TPU_SEGMENT*``).
The reference's ``--p`` write-ahead log directory and the rest of its
flags are not ported yet.
"""

from __future__ import annotations

import argparse
import signal
import sys

from dgraph_tpu_torch.models.store import PostingStore
from dgraph_tpu_torch.serve.server import DgraphServer


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dgraph_tpu_torch.cli.server")
    ap.add_argument("--port", type=int, default=8080, help="HTTP port (0 = any free port)")
    ap.add_argument("--bind", default="127.0.0.1", help="address to listen on")
    ap.add_argument("--device", default=None, help="torch device: cuda (default) or cpu")
    ap.add_argument("--arena_budget_mb", type=int, default=0,
                    help="device memory budget for cached arenas (0 = 3/4 of free memory on cuda)")
    opts = ap.parse_args(argv)
    srv = DgraphServer(
        PostingStore(), port=opts.port, bind=opts.bind, device=opts.device,
        arena_budget_mb=opts.arena_budget_mb,
    )
    srv.start()
    print(f"serving on {srv.addr} (device {srv.engine.device})", flush=True)

    def _on_signal(_sig, _frm):
        srv.stop()

    signal.signal(signal.SIGINT, _on_signal)
    signal.signal(signal.SIGTERM, _on_signal)
    srv.wait()
    return 0


if __name__ == "__main__":
    sys.exit(main())
