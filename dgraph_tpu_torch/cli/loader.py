"""Bulk RDF loader of the port (port of ``dgraph_tpu/cli/loader.py``):

    python -m dgraph_tpu_torch.cli.loader -r data.rdf.gz -s schema.txt \\
        -d http://127.0.0.1:8080 [--batch 1000] [-c 4] [--cd ckptdir] \\
        [--grpc [--ca cert.pem]]

Equivalent of cmd/dgraphloader/main.go: gzip-aware line reader
(readLine:68), batches of N quads through the batching client
(processFile:151), optional schema file first (processSchemaFile:85),
round-robin over multiple server addresses (setupConnection:222), and
checkpoint/resume per input file via client sync marks.  ``--grpc``
loads over ``protos.Dgraph/Run`` instead of HTTP (an ``http(s)://``
address maps to its port + 1000; an ``https://`` one needs ``--ca``).
"""

from __future__ import annotations

import argparse
import gzip
import itertools
import sys
import threading
import time
from typing import Iterator, Optional, Tuple

from dgraph_tpu_torch.client import (
    BatchMutationOptions,
    DgraphClient,
    HttpTransport,
    SyncMarks,
)
from dgraph_tpu_torch.client.client import Transport


def _make_transport(addr: str, use_grpc: bool, cafile: str = "") -> Transport:
    """One server's transport: gRPC (upstream loader's native wire,
    cmd/dgraphloader/main.go:222 grpc conns) or HTTP.  gRPC targets may
    be given bare (host:port) or as http(s)://host:port (mapped to the
    +1000 convention); https-derived targets need ``cafile`` (--ca) and
    dial TLS-verified (GrpcTransport's pinned-CA path)."""
    if not use_grpc:
        return HttpTransport(addr)
    from dgraph_tpu_torch.client import GrpcTransport

    # the CA applies only to https-derived targets: handing it to a
    # plaintext member of a mixed fleet would dial TLS into a plaintext
    # listener and fail every RPC with an opaque UNAVAILABLE
    return GrpcTransport(
        addr, cafile=cafile if addr.startswith("https://") else ""
    )


class RoundRobinTransport(Transport):
    """Spread requests over several servers (loader main.go:222)."""

    def __init__(self, addrs, use_grpc: bool = False, cafile: str = ""):
        self._ts = [_make_transport(a, use_grpc, cafile) for a in addrs]
        self._next = itertools.cycle(self._ts)
        self._lock = threading.Lock()

    def run(self, text, variables=None):
        with self._lock:
            t = next(self._next)
        return t.run(text, variables)


def open_lines(path: str) -> Iterator[Tuple[int, str]]:
    """(1-based line number, stripped line) pairs; transparent gzip."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt", encoding="utf-8", errors="replace") as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if line and not line.startswith("#"):
                yield i, line


def load_file(
    client: DgraphClient,
    path: str,
    marks: Optional[SyncMarks] = None,
    batch: int = 1000,
    window: int = 4,
    progress_every: float = 2.0,
) -> int:
    """Stream one RDF file through the client; returns quads submitted.

    Checkpointing: quads accumulate into line-delimited chunks; each
    chunk's last line number is begun before submit and marked done only
    after a flush that covers it.  Up to ``window`` chunks are enqueued
    between flushes so the client's ``pending`` workers actually overlap
    submissions (one flush per window, not per chunk)."""
    skip_through = marks.done_until(path) if marks else 0
    pending: list = []
    in_flight: list = []
    chunk_end = 0
    n = 0
    t0 = time.monotonic()  # interval math only: rate + progress beats
    last_report = t0

    def drain():
        nonlocal in_flight
        if not in_flight and not pending:
            return
        client.flush()
        if marks:
            for ce in in_flight:
                marks.done(path, ce)
        in_flight = []

    def submit_chunk():
        nonlocal pending
        if not pending:
            return
        if marks:
            marks.begin(path, chunk_end)
        for q in pending:
            client.batch_set(q)
        in_flight.append(chunk_end)
        pending = []
        if len(in_flight) >= max(1, window):
            drain()

    for line_no, line in open_lines(path):
        if line_no <= skip_through:
            continue
        pending.append(line)
        chunk_end = line_no
        n += 1
        if len(pending) >= batch:
            submit_chunk()
            now = time.monotonic()
            if now - last_report >= progress_every:
                rate = n / max(now - t0, 1e-9)
                print(f"  {path}: {n} quads, {rate:,.0f}/s", file=sys.stderr)
                last_report = now
    submit_chunk()
    drain()
    return n


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="dgraph_tpu_torch.cli.loader",
                                description=__doc__)
    p.add_argument("--rdf", "-r", required=True, nargs="+",
                   help="RDF N-Quad files (.rdf or .rdf.gz)")
    p.add_argument("--schema", "-s", default="", help="schema file to apply first")
    p.add_argument("--dgraph", "-d", default="http://127.0.0.1:8080",
                   help="comma-separated server addresses")
    p.add_argument("--batch", type=int, default=1000)
    p.add_argument("--concurrent", "-c", type=int, default=4,
                   help="concurrent in-flight batch submitters")
    p.add_argument("--cd", dest="client_dir", default="",
                   help="client checkpoint dir (enables resume)")
    p.add_argument("--grpc", action="store_true",
                   help="connect over gRPC (protos.Dgraph/Run) instead of "
                        "HTTP; http(s):// addresses map to port + 1000")
    p.add_argument("--ca", default="",
                   help="pinned CA / server-cert PEM for https gRPC "
                        "targets (a --tls_cert server serves gRPC over "
                        "TLS; required with https:// + --grpc)")
    ns = p.parse_args(argv)

    addrs = [a.strip() for a in ns.dgraph.split(",") if a.strip()]
    transport = (
        RoundRobinTransport(addrs, use_grpc=ns.grpc, cafile=ns.ca)
        if len(addrs) > 1
        else _make_transport(addrs[0], ns.grpc, ns.ca)
    )
    client = DgraphClient(
        transport, BatchMutationOptions(size=ns.batch, pending=ns.concurrent)
    )
    marks = SyncMarks(ns.client_dir) if ns.client_dir else None

    if ns.schema:
        with open(ns.schema) as f:
            client.add_schema(f.read())
        print(f"applied schema from {ns.schema}", file=sys.stderr)

    total, t0 = 0, time.monotonic()
    for path in ns.rdf:
        total += load_file(client, path, marks, batch=ns.batch, window=ns.concurrent)
    client.close()
    dt = time.monotonic() - t0
    print(f"loaded {total} quads in {dt:.1f}s ({total / max(dt, 1e-9):,.0f}/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
