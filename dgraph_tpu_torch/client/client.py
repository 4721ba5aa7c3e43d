"""Batching Dgraph client (port of ``dgraph_tpu/client/client.py``).

Mirrors client/mutations.go: callers stream N-Quads via BatchSet /
BatchDelete; `pending` worker threads drain batches of `size` quads and
submit them as mutation blocks; Flush waits for everything in flight.
Three transports: HTTP (JSON, or the binary protobuf ``Response`` with
``binary=True``), gRPC (``protos.Dgraph/Run``, upstream's native client
wire) and embedded (upstream's in-process InMemoryComm client,
dgraph/embedded.go:39).
"""

from __future__ import annotations

import json
import queue
import threading
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import List, Optional


class Transport:
    def run(self, text: str, variables: Optional[dict] = None) -> dict:
        raise NotImplementedError


class HttpTransport(Transport):
    """HTTP transport: POST /query with the text, variables in the
    X-Dgraph-Vars header; error statuses raise with the server's
    message.  ``binary=True`` asks for the protobuf wire-format
    ``Response`` (``Accept: application/protobuf``, serve/proto.py) and
    decodes it to the JSON path's result-dict shape, with proto3's
    inherent divergences: a ONE-element scalar list decodes as the bare
    scalar (the repeated-field ambiguity, serve/proto.py decode_node) and
    a mutation's code/message strings are not carried (Response has no
    fields for them)."""

    def __init__(self, addr: str, binary: bool = False):
        self.addr = addr.rstrip("/")
        self.binary = binary

    def run(self, text: str, variables: Optional[dict] = None) -> dict:
        req = urllib.request.Request(
            self.addr + "/query", data=text.encode("utf-8"), method="POST"
        )
        if variables:
            req.add_header("X-Dgraph-Vars", json.dumps(variables))
        if self.binary:
            req.add_header("Accept", "application/protobuf")
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                raw = resp.read()
                if self.binary and resp.headers.get("Content-Type", "").startswith(
                    "application/protobuf"
                ):
                    from dgraph_tpu_torch.serve.proto import decode_response

                    out = decode_response(raw)
                else:
                    out = json.loads(raw.decode())
        except urllib.error.HTTPError as e:
            # the server answers errors with a JSON {code, message} body;
            # surface the message, not just the status line
            try:
                body = json.loads(e.read().decode())
                msg = body.get("message", str(e))
            except (ValueError, AttributeError):
                msg = str(e)
            raise RuntimeError(msg) from None
        if out.get("code") == "ErrorInvalidRequest":
            raise RuntimeError(out.get("message", "request failed"))
        return out


class EmbeddedTransport(Transport):
    """In-process transport against a DgraphServer (or bare engine)."""

    def __init__(self, server):
        self.server = server

    def run(self, text: str, variables: Optional[dict] = None) -> dict:
        return self.server.run_query(text, variables)


class GrpcTransport(Transport):
    """gRPC transport against serve/grpc_server.py — upstream's native
    client wire (client/client.go over protos.Dgraph/Run).
    Channels come from a shared refcounted pool with a CheckVersion
    liveness probe (the worker/conn.go:108 pool analog); call close()
    to release this transport's reference.

    ``target`` is a bare host:port, or an http(s):// server address
    (mapped to the +1000 gRPC port convention).  A server started with
    --tls_cert serves gRPC over TLS, so https-derived targets require
    ``cafile`` (its cert / a pinned CA, PEM) and dial a verified
    grpc.secure_channel — mirroring GrpcRaftTransport: there is no
    silent plaintext downgrade and no unverified-TLS mode.

    ``timeout`` is every call's deadline in seconds (None: none); the
    server turns it into the request's budget, as it does
    ``X-Dgraph-Timeout``."""

    _pool = None  # class-level shared ChannelPool

    def __init__(self, target: str, cafile: str = "",
                 timeout: Optional[float] = None):
        from dgraph_tpu_torch.serve.grpc_server import ChannelPool

        if GrpcTransport._pool is None:
            GrpcTransport._pool = ChannelPool()
        if "://" in target:
            from dgraph_tpu_torch.cluster.transport import grpc_target_of

            if target.startswith("https://") and not cafile:
                raise ValueError(
                    "https gRPC targets require cafile= (the server's "
                    "TLS cert or a pinned CA): dialing plaintext into a "
                    "--tls_cert server fails every RPC"
                )
            target = grpc_target_of(target, 1000)
        self.target = target
        self.cafile = cafile
        self.timeout = timeout
        self._chan = GrpcTransport._pool.get(target, cafile or None)
        self._run = self._chan.unary_unary("/protos.Dgraph/Run")
        self._check = self._chan.unary_unary("/protos.Dgraph/CheckVersion")
        self._assign = self._chan.unary_unary("/protos.Dgraph/AssignUids")

    def run(self, text: str, variables: Optional[dict] = None) -> dict:
        import grpc

        from dgraph_tpu_torch.serve.grpc_server import encode_request
        from dgraph_tpu_torch.serve.proto import decode_response

        try:
            raw = self._run(encode_request(text, variables), timeout=self.timeout)
        except grpc.RpcError as e:
            raise RuntimeError(e.details() or str(e.code())) from None
        return decode_response(raw)

    def check_version(self) -> str:
        from dgraph_tpu_torch.serve.grpc_server import decode_version

        return decode_version(self._check(b"", timeout=self.timeout))

    def assign_uids(self, n: int) -> tuple:
        from dgraph_tpu_torch.serve.grpc_server import (
            decode_assigned_ids,
            encode_num,
        )

        return decode_assigned_ids(
            self._assign(encode_num(n), timeout=self.timeout)
        )

    def close(self) -> None:
        if self._chan is not None:
            GrpcTransport._pool.release(self.target, self.cafile or None)
            self._chan = None


@dataclass
class BatchMutationOptions:
    """client/mutations.go:56 BatchMutationOptions."""

    size: int = 1000
    pending: int = 4


@dataclass
class Edge:
    """One pending N-Quad, built by the typed setters
    (client/client.go Edge + SetValue*)."""

    subject: str
    predicate: str
    object_id: str = ""
    literal: str = ""
    lang: str = ""

    @staticmethod
    def connect(subj: str, pred: str, obj: str) -> "Edge":
        return Edge(subj, pred, object_id=obj)

    @staticmethod
    def value(subj: str, pred: str, v, lang: str = "") -> "Edge":
        if isinstance(v, bool):
            lit = f'"{str(v).lower()}"^^<xs:boolean>'
        elif isinstance(v, int):
            lit = f'"{v}"^^<xs:int>'
        elif isinstance(v, float):
            lit = f'"{v}"^^<xs:float>'
        else:
            s = str(v).replace("\\", "\\\\").replace('"', '\\"')
            lit = f'"{s}"'
        return Edge(subj, pred, literal=lit, lang=lang)

    def nquad(self) -> str:
        subj = self.subject if self.subject.startswith("_:") else f"<{self.subject}>"
        if self.object_id:
            obj = f"<{self.object_id}>" if not self.object_id.startswith("_:") else self.object_id
        else:
            obj = self.literal + (f"@{self.lang}" if self.lang else "")
        return f"{subj} <{self.predicate}> {obj} ."


class DgraphClient:
    """Pipelined batching client (client/mutations.go NewDgraphClient)."""

    def __init__(self, transport: Transport, opts: BatchMutationOptions = BatchMutationOptions()):
        self.transport = transport
        self.opts = opts
        self._set_q: "queue.Queue[Optional[str]]" = queue.Queue(maxsize=opts.size * opts.pending)
        self._del_q: "queue.Queue[Optional[str]]" = queue.Queue(maxsize=opts.size * opts.pending)
        self._err: Optional[BaseException] = None
        self._last_op: Optional[str] = None
        self._prod_lock = threading.Lock()
        self._mutations = 0
        self._lock = threading.Lock()
        self._workers: List[threading.Thread] = []
        self._stop = threading.Event()
        for i in range(opts.pending):
            t = threading.Thread(target=self._worker, name=f"client-batch-{i}", daemon=True)
            t.start()
            self._workers.append(t)

    # -- public mutation surface ------------------------------------------

    def query(self, text: str, variables: Optional[dict] = None) -> dict:
        return self.transport.run(text, variables)

    def batch_set(self, e) -> None:
        self._check_err()
        with self._prod_lock:
            self._op_barrier("set")
            self._set_q.put(e.nquad() if isinstance(e, Edge) else str(e))

    def batch_delete(self, e) -> None:
        self._check_err()
        with self._prod_lock:
            self._op_barrier("del")
            self._del_q.put(e.nquad() if isinstance(e, Edge) else str(e))

    def _op_barrier(self, op: str) -> None:
        """Sets and deletes travel in separate queues drained concurrently;
        without a barrier a delete enqueued after a set of the same quad
        could reach the server first.  On an op-type flip, drain what's
        queued so cross-op order is preserved.  Caller holds _prod_lock so
        the flip check and the enqueue are atomic across producer threads
        (alternating ops serialize — bulk loads are single-op, so the
        common path never blocks here)."""
        if self._last_op != op:
            if self._last_op is not None:
                self._set_q.join()
                self._del_q.join()
                self._check_err()
            self._last_op = op

    def add_schema(self, schema: str) -> None:
        self.transport.run("mutation { schema {\n" + schema + "\n} }")

    def flush(self) -> None:
        """Drain all queued quads and wait (BatchFlush, mutations.go:452)."""
        self._set_q.join()
        self._del_q.join()
        self._check_err()

    def close(self) -> None:
        self.flush()
        self._stop.set()
        # wake workers blocked on get()
        for _ in self._workers:
            self._set_q.put(None)
        for t in self._workers:
            t.join(timeout=5)

    def mutation_count(self) -> int:
        return self._mutations

    # -- internals ---------------------------------------------------------

    def _check_err(self):
        if self._err is not None:
            raise RuntimeError(f"batch worker failed: {self._err}")

    def _drain(self, q: "queue.Queue", first: Optional[str]) -> List[str]:
        batch = [] if first is None else [first]
        while len(batch) < self.opts.size:
            try:
                item = q.get_nowait()
            except queue.Empty:
                break
            if item is None:
                q.task_done()
                continue
            batch.append(item)
        return batch

    def _submit(self, sets: List[str], dels: List[str]) -> None:
        parts = []
        if sets:
            parts.append("set {\n" + "\n".join(sets) + "\n}")
        if dels:
            parts.append("delete {\n" + "\n".join(dels) + "\n}")
        self.transport.run("mutation {\n" + "\n".join(parts) + "\n}")
        with self._lock:
            self._mutations += 1

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._set_q.get(timeout=0.05)
            except queue.Empty:
                # nothing queued for set; try deletes
                try:
                    dfirst = self._del_q.get_nowait()
                except queue.Empty:
                    continue
                dels = self._drain(self._del_q, dfirst)
                try:
                    self._submit([], dels)
                except Exception as e:  # noqa: BLE001 — surfaced by flush()
                    # several workers can fail at once: publish the
                    # error under the client lock, not as a bare store
                    with self._lock:
                        self._err = e
                finally:
                    for _ in dels:
                        self._del_q.task_done()
                continue
            if first is None:
                self._set_q.task_done()
                continue
            sets = self._drain(self._set_q, first)
            try:
                self._submit(sets, [])
            except Exception as e:  # noqa: BLE001 — surfaced by flush()
                with self._lock:
                    self._err = e
            finally:
                for _ in sets:
                    self._set_q.task_done()
