"""Batching Dgraph client (port of ``dgraph_tpu/client/client.py``; the
reference's ``GrpcTransport`` and the binary-protobuf HTTP response are
not ported).

Mirrors client/mutations.go: callers stream N-Quads via BatchSet /
BatchDelete; `pending` worker threads drain batches of `size` quads and
submit them as mutation blocks; Flush waits for everything in flight.
Two transports: HTTP (the reference's network client) and embedded
(the reference's in-process InMemoryComm client, dgraph/embedded.go:39).
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
    message."""

    def __init__(self, addr: str):
        self.addr = addr.rstrip("/")

    def run(self, text: str, variables: Optional[dict] = None) -> dict:
        req = urllib.request.Request(
            self.addr + "/query", data=text.encode("utf-8"), method="POST"
        )
        if variables:
            req.add_header("X-Dgraph-Vars", json.dumps(variables))
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                out = json.loads(resp.read().decode())
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
