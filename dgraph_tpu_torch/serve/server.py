"""HTTP serving surface of the port (minimal ``DgraphServer``).

The subset of ``dgraph_tpu/serve/server.py`` the 2-hop slice serves:

- ``POST /query`` — a query, a ``mutation {}`` block, or both; variables
  ride the ``X-Dgraph-Vars`` header; ``?debug=true`` adds the engine's
  stats to ``server_latency``, ``?ledger=true`` the request's resource
  ledger to ``extensions``.  The response body is built exactly as the
  reference builds it, so its JSON is byte-identical.
- ``GET /health`` — ``OK`` while serving.
- ``GET /admin/shutdown`` — stops the server.

One lock serializes request execution on the shared engine and device.
The reference's cohort scheduler, query caches, QoS, tracing, cluster
and durable storage are not ported yet.
"""

from __future__ import annotations

import json
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from dgraph_tpu_torch import gql
from dgraph_tpu_torch.models.store import PostingStore
from dgraph_tpu_torch.obs import ledger as _ledger
from dgraph_tpu_torch.query.engine import QueryEngine

_CORS = {
    "Access-Control-Allow-Origin": "*",
    "Access-Control-Allow-Methods": "POST, GET, OPTIONS",
    "Access-Control-Allow-Headers": "Content-Type",
}


def _fmt_ns(ns: int) -> str:
    """Render a duration the way Go's time.Duration.String does."""
    if ns < 1_000:
        return f"{ns}ns"
    if ns < 1_000_000:
        return f"{ns / 1_000:.6g}µs"
    if ns < 1_000_000_000:
        return f"{ns / 1_000_000:.6g}ms"
    return f"{ns / 1_000_000_000:.6g}s"


class Latency:
    """Per-request stage timing; ``to_map()`` is the response's
    ``server_latency`` (copy of dgraph_tpu/utils/trace.py Latency)."""

    def __init__(self):
        self.start = time.perf_counter_ns()
        self.parsing_ns = 0
        self.processing_ns = 0
        self.json_ns = 0

    def _mark(self) -> int:
        now = time.perf_counter_ns()
        elapsed = now - self.start
        self.start = now
        return elapsed

    def record_parsing(self) -> None:
        self.parsing_ns = self._mark()

    def record_processing(self) -> None:
        self.processing_ns = self._mark()

    def record_json(self) -> None:
        self.json_ns = self._mark()

    def to_map(self) -> dict:
        total = self.parsing_ns + self.processing_ns + self.json_ns
        out = {"total": _fmt_ns(total)}
        if self.parsing_ns:
            out["parsing"] = _fmt_ns(self.parsing_ns)
        if self.processing_ns:
            out["processing"] = _fmt_ns(self.processing_ns)
        if self.json_ns:
            out["json"] = _fmt_ns(self.json_ns)
        return out


class DgraphServer:
    """Owns the store + engine and serves the HTTP surface.  ``device``
    is the engine's device: ``cuda`` by default (raises without a GPU)."""

    def __init__(
        self,
        store: PostingStore,
        port: int = 0,
        bind: str = "127.0.0.1",
        device=None,
        arena_budget_mb: int = 0,
    ):
        self.store = store
        self.engine = QueryEngine(
            store, device=device,
            arena_budget_bytes=(arena_budget_mb * (1 << 20)) or None,
        )
        self._exec_lock = threading.Lock()
        self._stop_lock = threading.Lock()
        self._serving = False
        self._stopped = False
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._bind = bind
        self._port = port

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._httpd = ThreadingHTTPServer(
            (self._bind, self._port), _make_handler(self)
        )
        self._port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="dgraph-http", daemon=True
        )
        self._thread.start()
        self._serving = True

    @property
    def port(self) -> int:
        return self._port

    @property
    def addr(self) -> str:
        return f"http://{self._bind}:{self._port}"

    def healthy(self) -> bool:
        return self._serving

    def stop(self) -> None:
        """Stop accepting, wait for the listener thread, and mark the
        server stopped (idempotent)."""
        with self._stop_lock:
            if self._stopped:
                return
            self._serving = False
            if self._httpd is not None:
                self._httpd.shutdown()
                self._httpd.server_close()
                self._httpd = None
            if self._thread is not None:
                self._thread.join(timeout=30)
            self._stopped = True

    def wait(self) -> None:
        """Block until the server is stopped (the CLI's main loop)."""
        while not self._stopped:
            time.sleep(0.2)

    # -- request execution -------------------------------------------------

    def run_query(
        self,
        text: str,
        variables: Optional[dict] = None,
        debug: bool = False,
        ledger_out: bool = False,
    ) -> dict:
        """Parse, execute (mutation and/or queries) and return the
        response dict with its latency map."""
        from dgraph_tpu_torch.query import outputnode

        lat = Latency()
        led = _ledger.start()
        ltoken = _ledger.activate(led)
        try:
            parsed = gql.parse(text, variables)
            lat.record_parsing()
            out: dict = {}
            debug_token = outputnode.DEBUG_UIDS.set(debug)
            try:
                with self._exec_lock:
                    out.update(self.engine.run_parsed(parsed))
                    stats = self.engine.stats
            finally:
                outputnode.DEBUG_UIDS.reset(debug_token)
            led.merge_engine_stats(stats)
            lat.record_processing()
            lat.record_json()
            out["server_latency"] = lat.to_map()
            if ledger_out:
                out.setdefault("extensions", {})["ledger"] = led.to_dict()
            if debug:
                out["server_latency"]["engine"] = {
                    k: (round(v, 3) if isinstance(v, float) else v)
                    for k, v in stats.items()
                }
            return out
        finally:
            _ledger.deactivate(ltoken)


def _make_handler(srv: DgraphServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        timeout = 60
        disable_nagle_algorithm = True
        server_version = "dgraph-tpu-torch/0.1"

        def log_message(self, *a):  # quiet
            pass

        def _reply(self, code: int, body: bytes, ctype: str = "application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in _CORS.items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _err(self, code: int, msg: str, kind: str = "ErrorInvalidRequest"):
            self._reply(code, json.dumps({"code": kind, "message": msg}).encode())

        def do_OPTIONS(self):
            self._reply(200, b"")

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/health":
                if srv.healthy():
                    self._reply(200, b"OK", "text/plain")
                else:
                    self._reply(503, b"\"uninitialized\"")
            elif path == "/admin/shutdown":
                self._reply(200, json.dumps(
                    {"code": "Success", "message": "Server is shutting down"}
                ).encode())
                threading.Thread(target=srv.stop, daemon=True).start()
            else:
                self._err(404, "no such endpoint")

        def do_POST(self):
            u = urlparse(self.path)
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n).decode("utf-8", "replace")
            if u.path != "/query":
                return self._err(404, "no such endpoint")
            qs = parse_qs(u.query)
            debug = qs.get("debug", ["false"])[0] == "true"
            want_ledger = qs.get("ledger", ["false"])[0] == "true"
            try:
                vars_hdr = self.headers.get("X-Dgraph-Vars")
                variables = json.loads(vars_hdr) if vars_hdr else None
                out = srv.run_query(
                    body, variables, debug=debug, ledger_out=want_ledger
                )
            except ValueError as e:
                # parse, query and mutation errors (ParseError, QueryError,
                # bad variables) are the client's: 400 as in the reference
                return self._err(400, str(e))
            except Exception as e:  # noqa: BLE001 — the request boundary
                # anything else (a device or kernel fault) is the server's:
                # reported as a 500 with its traceback on stderr
                traceback.print_exc(file=sys.stderr)
                return self._err(500, f"{type(e).__name__}: {e}", "ErrorInternal")
            self._reply(200, json.dumps(out).encode())

    return Handler
