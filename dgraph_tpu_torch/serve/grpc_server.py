"""gRPC transport of the port: the ``protos.Dgraph`` service and the
``protos.Worker`` plane (copy of ``dgraph_tpu/serve/grpc_server.py``).

Upstream Dgraph's machine API is gRPC (protos/graphresponse.proto:24-28
``service Dgraph { rpc Run (Request) returns (Response); rpc
CheckVersion(Check) returns (Version); rpc AssignUids(Num) returns
(AssignedIds); }``, served from cmd/dgraph/main.go:602 grpcListener).
grpcio provides ONLY the HTTP/2 transport — every message is encoded and
decoded by the hand-rolled proto3 wire codec that backs the binary HTTP
surface (serve/proto.py), no generated stubs, through grpc's generic
handlers with identity serializers.  ``grpc`` is imported inside the
functions that use it, so the package imports where grpcio is absent.

Request decoding (graphresponse.proto:75-80):
  Request:  query=1, mutation=2, schema=3 (SchemaRequest), vars=4 (map)
  Mutation: set=1, del=2 (repeated NQuad), schema=3 (repeated SchemaUpdate)
  NQuad:    subject=1, predicate=2, object_id=3, object_value=4,
            label=5, objectType=6 (sint32), lang=7, facets=8
  Facet:    key=1, value=2, val_type=3, tokens=4, val=5
  SchemaUpdate (schema.proto:42): predicate=1, value_type=2 (Posting
            ValType enum == our TypeID), directive=3, tokenizer=4, count=5

Decoded NQuads are rendered to RDF lines and flow through the SAME
parse → mutate → query path as the HTTP surface (server.run_query), so
the two transports cannot diverge: a Run over gRPC launches the same
gather and intersect kernels on the card as a POST /query.  Documented
substitutions (as in serve/proto.py): datetime_val/date_val bytes are
accepted as UTF-8 ISO-8601 (the Go client's binary time.MarshalBinary
form is not), and geo_val bytes as UTF-8 GeoJSON rather than WKB.

Two things differ from the reference's by design.  A device fault
(utils/devguard.DeviceFaultError — a sick, wedged or faulted card, the
HTTP surface's 503 with Retry-After) aborts Run with UNAVAILABLE, not
INTERNAL: the reference fails over to the host and never meets it; the
port serves nothing from the host instead.  And every listener and
channel takes messages up to ``MAX_MESSAGE_BYTES`` (1 GiB) where grpcio's
default receive limit, the reference's, is 4 MB: a bulk load's raft
entries and snapshots cross the Worker plane as they cross HTTP.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from dgraph_tpu_torch.serve import proto as _p

_TAG = "0.7.0-tpu"  # CheckVersion tag (x/version analog)

# the largest message a listener or a channel of the port takes, bytes.
# grpcio's default receive limit is 4 MB, and a bulk load's raft entry
# (about 16 bytes an edge: 4.2 MB at 262,144 edges), an AppendReq that
# carries several of them, a snapshot or a large Run response is bigger;
# the HTTP transports set no limit at all
MAX_MESSAGE_BYTES = 1 << 30
MESSAGE_OPTIONS = (
    ("grpc.max_receive_message_length", MAX_MESSAGE_BYTES),
    ("grpc.max_send_message_length", MAX_MESSAGE_BYTES),
)


def make_channel(target: str, cafile: str = ""):
    """A channel to ``target`` under MESSAGE_OPTIONS: TLS verified against
    ``cafile`` (a pinned CA / server-cert PEM) when one is given, else
    plaintext."""
    import grpc

    if cafile:
        with open(cafile, "rb") as f:
            creds = grpc.ssl_channel_credentials(f.read())
        return grpc.secure_channel(target, creds, options=MESSAGE_OPTIONS)
    return grpc.insecure_channel(target, options=MESSAGE_OPTIONS)


def _zigzag(n: int) -> int:
    """sint32/sint64 wire decode (objectType is sint32)."""
    return (n >> 1) ^ -(n & 1)


def _esc(s: str) -> str:
    return (
        s.replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
        .replace("\t", "\\t")
    )


def _ref(s: str) -> str:
    """subject/object_id string → RDF term (blank nodes pass through)."""
    return s if s.startswith("_:") else f"<{s}>"


def _value_literal(b: bytes) -> str:
    """Value message bytes → RDF literal text (typed where the oneof
    carries a type; schema conversion still happens server-side, exactly
    as for text-submitted RDF)."""
    import struct

    for f, _w, v in _p.iter_fields(b):
        if f == 1:  # default_val
            return f'"{_esc(v.decode("utf-8"))}"'
        if f == 2:  # bytes_val
            return f'"{_esc(v.decode("utf-8", "replace"))}"^^<binary>'
        if f == 3:  # int_val
            iv = v if v < (1 << 63) else v - (1 << 64)
            return f'"{iv}"^^<xs:int>'
        if f == 4:  # bool_val
            return f'"{"true" if v else "false"}"^^<xs:boolean>'
        if f == 5:  # str_val
            return f'"{_esc(v.decode("utf-8"))}"'
        if f == 6:  # double_val
            return f'"{struct.unpack("<d", v)[0]!r}"^^<xs:double>'
        if f == 7:  # geo_val: UTF-8 GeoJSON (documented substitution)
            return f'"{_esc(v.decode("utf-8"))}"^^<geo>'
        if f in (8, 9):  # date_val / datetime_val as ISO-8601 text
            return f'"{_esc(v.decode("utf-8"))}"^^<xs:dateTime>'
        if f == 10:  # password_val
            return f'"{_esc(v.decode("utf-8"))}"^^<password>'
        if f == 11:  # uid_val — an edge, not a literal
            return f"<0x{v:x}>"
    return '""'


def _decode_facet(b: bytes) -> Optional[str]:
    key = val = None
    raw = None
    vt = 0
    for f, _w, v in _p.iter_fields(b):
        if f == 1:
            key = v.decode("utf-8")
        elif f == 2:
            raw = v
        elif f == 3:
            vt = v
        elif f == 5:
            val = v.decode("utf-8")
    if key is None:
        return None
    if val is None and raw is not None:
        if vt == 1:
            val = str(int.from_bytes(raw[:8].ljust(8, b"\0"), "little", signed=True))
        elif vt == 2:
            import struct

            val = repr(struct.unpack("<d", raw[:8].ljust(8, b"\0"))[0])
        elif vt == 3:
            val = "true" if raw and raw[0] else "false"
        else:
            val = raw.decode("utf-8", "replace")
    return f"{key}={val}" if val is not None else key


def _decode_nquad(b: bytes) -> str:
    subject = predicate = ""
    object_id = ""
    value_txt = ""
    lang = ""
    facets: List[str] = []
    for f, _w, v in _p.iter_fields(b):
        if f == 1:
            subject = v.decode("utf-8")
        elif f == 2:
            predicate = v.decode("utf-8")
        elif f == 3:
            object_id = v.decode("utf-8")
        elif f == 4:
            value_txt = _value_literal(v)
        elif f == 7:
            lang = v.decode("utf-8")
        elif f == 8:
            fc = _decode_facet(v)
            if fc:
                facets.append(fc)
    obj = _ref(object_id) if object_id else value_txt or '""'
    if lang and not object_id:
        obj += f"@{lang}"
    ftxt = f" ({', '.join(facets)})" if facets else ""
    pred = predicate if predicate == "*" else f"<{predicate}>"
    return f"{_ref(subject)} {pred} {obj}{ftxt} ."


def _decode_schema_update(b: bytes) -> str:
    """SchemaUpdate → schema-block line (value_type enum == our TypeID)."""
    from dgraph_tpu_torch.models.types import TypeID

    pred = ""
    vt = 0
    directive = 0
    toks: List[str] = []
    count = False
    for f, _w, v in _p.iter_fields(b):
        if f == 1:
            pred = v.decode("utf-8")
        elif f == 2:
            vt = v
        elif f == 3:
            directive = v
        elif f == 4:
            toks.append(v.decode("utf-8"))
        elif f == 5:
            count = bool(v)
    try:
        tname = TypeID(vt).name.lower()
    except ValueError:
        tname = "default"
    line = f"{pred}: {tname}"
    if directive == 1 or toks:  # INDEX
        line += f" @index({', '.join(toks)})" if toks else " @index(term)"
    elif directive == 2:  # REVERSE
        line += " @reverse"
    if count:
        line += " @count"
    return line + " ."


def _decode_mutation(b: bytes) -> Tuple[List[str], List[str], List[str]]:
    sets: List[str] = []
    dels: List[str] = []
    schema: List[str] = []
    for f, _w, v in _p.iter_fields(b):
        if f == 1:
            sets.append(_decode_nquad(v))
        elif f == 2:
            dels.append(_decode_nquad(v))
        elif f == 3:
            schema.append(_decode_schema_update(v))
    return sets, dels, schema


def _decode_schema_request(b: bytes) -> str:
    preds: List[str] = []
    fields: List[str] = []
    for f, _w, v in _p.iter_fields(b):
        if f == 2:
            preds.append(v.decode("utf-8"))
        elif f == 3:
            fields.append(v.decode("utf-8"))
    inner = " ".join(fields)
    if preds:
        plist = ", ".join(preds)
        return f"schema (pred: [{plist}]) {{ {inner} }}"
    return f"schema {{ {inner} }}"


def decode_request(b: bytes) -> Tuple[str, Dict[str, str]]:
    """Request bytes → (effective query text, vars).

    A Request carrying mutation/schema parts composes them into the SAME
    text form the HTTP surface accepts, so both transports execute one
    code path."""
    query = ""
    vars_: Dict[str, str] = {}
    sets: List[str] = []
    dels: List[str] = []
    schema: List[str] = []
    schema_q = ""
    for f, _w, v in _p.iter_fields(b):
        if f == 1:
            query = v.decode("utf-8")
        elif f == 2:
            s, d, sc = _decode_mutation(v)
            sets += s
            dels += d
            schema += sc
        elif f == 3:
            schema_q = _decode_schema_request(v)
        elif f == 4:  # map<string,string> entry {1: key, 2: value}
            k = mv = ""
            for f2, _w2, v2 in _p.iter_fields(v):
                if f2 == 1:
                    k = v2.decode("utf-8")
                elif f2 == 2:
                    mv = v2.decode("utf-8")
            if k:
                vars_[k] = mv
    parts: List[str] = []
    if sets or dels or schema:
        m = "mutation {"
        if schema:
            m += " schema { %s }" % "\n".join(schema)
        if sets:
            m += " set { %s }" % "\n".join(sets)
        if dels:
            m += " delete { %s }" % "\n".join(dels)
        m += " }"
        parts.append(m)
    if query.strip():
        parts.append(query)
    if schema_q:  # schema blocks are top-level (gql: `schema (...) {...}`)
        parts.append(schema_q)
    return "\n".join(parts), vars_


# ----------------------------------------------------------- client side


def encode_request(
    query: str = "",
    vars: Optional[Dict[str, str]] = None,
    set_nquads: str = "",
    del_nquads: str = "",
) -> bytes:
    """Client-side Request encoder (query + vars; RDF text mutations ride
    inside the query string, which the server surface accepts natively)."""
    out = b""
    text = query
    if set_nquads or del_nquads:
        m = "mutation {"
        if set_nquads:
            m += " set { %s }" % set_nquads
        if del_nquads:
            m += " delete { %s }" % del_nquads
        m += " }"
        text = m + "\n" + query
    if text:
        out += _p._str_field(1, text)
    for k, v in (vars or {}).items():
        entry = _p._str_field(1, k) + _p._str_field(2, v)
        out += _p._len_field(4, entry)
    return out


def encode_version(tag: str = _TAG) -> bytes:
    return _p._str_field(1, tag)


def decode_version(b: bytes) -> str:
    for f, _w, v in _p.iter_fields(b):
        if f == 1:
            return v.decode("utf-8")
    return ""


def encode_assigned_ids(start: int, end: int) -> bytes:
    return _p._varint_field(1, start) + _p._varint_field(2, end)


def decode_assigned_ids(b: bytes) -> Tuple[int, int]:
    start = end = 0
    for f, _w, v in _p.iter_fields(b):
        if f == 1:
            start = v
        elif f == 2:
            end = v
    return start, end


def encode_num(n: int) -> bytes:
    return _p._varint_field(1, n)


def decode_num(b: bytes) -> int:
    for f, _w, v in _p.iter_fields(b):
        if f == 1:
            return v
    return 0


# -------------------------------------------------- Worker plane helpers

_SECRET_MD = "x-dgraph-cluster-secret"  # gRPC metadata key (lowercase)


def encode_payload(data: bytes) -> bytes:
    """protos.Payload{Data=1} (payload.proto:9)."""
    return _p._len_field(1, data)


def decode_payload(b: bytes) -> bytes:
    for f, _w, v in _p.iter_fields(b):
        if f == 1:
            return v
    return b""


def frame_raft(group: int, frame: bytes) -> bytes:
    """Payload.Data for RaftMessage: varint group id + the binary raft
    frame (cluster/transport.py codec).  The reference routes group via
    RaftContext inside the payload (worker/draft.go:1017); a leading
    varint carries the same information without re-parsing the frame."""
    out = bytearray()
    from dgraph_tpu_torch.models import codec as _codec

    _codec.put_uvarint(out, group)
    return bytes(out) + frame


def unframe_raft(data: bytes):
    from dgraph_tpu_torch.models import codec as _codec

    group, pos = _codec.uvarint(data, 0)
    return int(group), data[pos:]


# ----------------------------------------------------------- the server


class GrpcServer:
    """protos.Dgraph over grpcio generic handlers (bytes in/bytes out).

    Wraps a DgraphServer: Run rides run_query (same lock, latency map and
    trace path as HTTP), CheckVersion is the health/Echo analog
    (worker/conn.go:108), AssignUids leases from the store's uid space.
    """

    def __init__(self, server, bind: str = "127.0.0.1", port: int = 0,
                 max_workers: int = 8):
        self._server = server
        self._bind = bind
        self._port = port
        self._max_workers = max_workers
        self._grpc = None

    @property
    def port(self) -> int:
        return self._port

    def start(self) -> None:
        import grpc
        from concurrent import futures

        svc = self

        class _Handler(grpc.GenericRpcHandler):
            def service(self, hcd):
                m = hcd.method
                if m == "/protos.Dgraph/Run":
                    return grpc.unary_unary_rpc_method_handler(svc._run)
                if m == "/protos.Dgraph/CheckVersion":
                    return grpc.unary_unary_rpc_method_handler(svc._check)
                if m == "/protos.Dgraph/AssignUids":
                    return grpc.unary_unary_rpc_method_handler(svc._assign)
                if m == "/protos.Dgraph/Subscribe":
                    # live-query subscription (ivm/subs.py):
                    # one Request in, a server-stream of Responses out —
                    # the gRPC twin of POST /subscribe's SSE
                    return grpc.unary_stream_rpc_method_handler(
                        svc._subscribe
                    )
                # Worker plane (payload.proto:28): the intra-cluster RPCs
                if m == "/protos.Worker/Echo":
                    return grpc.unary_unary_rpc_method_handler(svc._echo)
                if m == "/protos.Worker/RaftMessage":
                    return grpc.unary_unary_rpc_method_handler(svc._raft)
                return None

        self._grpc = grpc.server(
            futures.ThreadPoolExecutor(
                max_workers=self._max_workers,
                thread_name_prefix="dgraph-grpc",
            ),
            options=MESSAGE_OPTIONS,
        )
        self._grpc.add_generic_rpc_handlers((_Handler(),))
        # TLS follows the HTTP surface: a server started with --tls_cert
        # serves gRPC over TLS too — otherwise an https cluster running
        # --raft_transport grpc would dial TLS into a plaintext listener
        # and the raft plane would be silently dead
        cert = getattr(self._server, "_tls_cert", "")
        key = getattr(self._server, "_tls_key", "")
        if cert:
            with open(cert, "rb") as f:
                chain = f.read()
            kb = chain
            if key:
                with open(key, "rb") as f:
                    kb = f.read()
            creds = grpc.ssl_server_credentials(((kb, chain),))
            self._port = self._grpc.add_secure_port(
                f"{self._bind}:{self._port}", creds
            )
        else:
            self._port = self._grpc.add_insecure_port(f"{self._bind}:{self._port}")
        self._grpc.start()

    def stop(self, grace: float = 0.5) -> None:
        if self._grpc is not None:
            self._grpc.stop(grace).wait()
            self._grpc = None

    # -- RPC behaviors (bytes → bytes; identity serializers) --------------

    def _run(self, req: bytes, context):
        import grpc

        from dgraph_tpu_torch.utils.metrics import NUM_GRPC_RUNS

        NUM_GRPC_RUNS.add(1)
        try:
            text, vars_ = decode_request(req)
        except Exception as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"bad Request message: {e}")
        if not text.strip():
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "empty request")
        # propagate the client's gRPC deadline into the cohort
        # scheduler's per-request budget via the SAME deadline
        # resolution the HTTP surface uses (sched/qos.py): a request that
        # cannot make
        # its deadline sheds (DEADLINE_EXCEEDED) instead of queueing
        # forever, and under QoS the deadline also bounds EXECUTION
        # through the request's CancelToken
        from dgraph_tpu_torch.sched import qos as _qos

        timeout_s = _qos.grpc_timeout(context)
        # tenant scope + client-disconnect probe: gRPC metadata keys are
        # lowercased by grpc; context.is_active() flips false when the
        # caller cancelled or hung up, which the engine's checkpoints
        # turn into cooperative cancellation
        try:
            md = dict(context.invocation_metadata())
        except Exception:  # noqa: BLE001 — metadata is optional
            md = {}
        tenant = md.get("x-dgraph-tenant", "")

        def _client_gone() -> bool:
            try:
                return not context.is_active()
            except Exception:  # noqa: BLE001 — transport quirk: assume live
                return False

        # W3C trace propagation over the gRPC leg: traceparent rides
        # invocation metadata; malformed values parse to None and are
        # ignored, never an error
        tctx = self._md_trace_ctx(context)
        try:
            out = self._server.run_query(text, vars_ or None,
                                         timeout_s=timeout_s,
                                         trace_ctx=tctx,
                                         tenant=tenant,
                                         cancel_probe=_client_gone)
        except Exception as e:
            from dgraph_tpu_torch.cluster.peerclient import StaleUnavailableError
            from dgraph_tpu_torch.models.durability import StorageFaultError
            from dgraph_tpu_torch.sched import (
                QueryCancelledError,
                SchedDeadlineError,
                SchedOverloadError,
            )
            from dgraph_tpu_torch.utils.devguard import DeviceFaultError

            if isinstance(e, DeviceFaultError):
                # the card is sick, wedged or faulted: retriable once the
                # re-admission probe re-proves it (the HTTP surface's 503
                # + Retry-After).  Nothing is served from the host
                context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
            if isinstance(e, SchedOverloadError):
                # SchedQuotaError included: RESOURCE_EXHAUSTED either
                # way (the tenant-scoped retry hint is an HTTP header
                # nicety; gRPC clients back off on the status code)
                context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
            if isinstance(e, SchedDeadlineError):
                context.abort(grpc.StatusCode.DEADLINE_EXCEEDED, str(e))
            if isinstance(e, QueryCancelledError):
                # mid-execution deadline lapse reads like the queued
                # shed; disconnect/admin cancels read as CANCELLED
                context.abort(
                    grpc.StatusCode.DEADLINE_EXCEEDED
                    if e.reason == "deadline"
                    else grpc.StatusCode.CANCELLED,
                    str(e),
                )
            if isinstance(e, StorageFaultError):
                # disk fault / read-only mode: mutation not acknowledged,
                # retriable after the re-arm probe (HTTP's 503 twin).
                # Checked BEFORE StaleUnavailableError: both are OSError
                # family but this one names the local disk, not a peer.
                context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
            if isinstance(e, StaleUnavailableError):
                # owner group unreachable with no cached copy: retriable
                # service condition (the HTTP surface's 503 + Retry-After)
                context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
            # isinstance, not a name list: every client-input error
            # subclasses ValueError (gql.ParseError, rdf.ParseError,
            # QueryError)
            code = (
                grpc.StatusCode.INVALID_ARGUMENT
                if isinstance(e, ValueError)
                else grpc.StatusCode.INTERNAL
            )
            context.abort(code, str(e))
        deg = out.get("degraded")
        if deg:
            # stale-read disclosure: the proto Response has no field for
            # it (graphresponse.proto is frozen), so it rides a trailer —
            # same shape as the JSON extension.  Sub-mesh serving also
            # mirrors the epoch as a trailer of its own (ONE
            # set_trailing_metadata call: grpc replaces, not merges)
            import json as _json

            md = [("dgraph-degraded", _json.dumps(deg))]
            mesh_deg = deg.get("mesh")
            if mesh_deg:
                md.append(("dgraph-mesh-epoch", str(mesh_deg.get("epoch", 0))))
            context.set_trailing_metadata(tuple(md))
        return _p.encode_response(out)

    def _subscribe(self, req: bytes, context):
        """Server-stream of re-evaluated results for one registered
        live query.  Each message is a normal Response whose extra
        ``_subscription_`` block carries the push metadata (sub id,
        seq, trigger preds, trace id); the stream ends when the
        subscription is cancelled (unsubscribe/shutdown) and the
        registry drops the subscription when the CLIENT goes away
        (``context.is_active()`` — a live query with no listener is
        pure waste).  An evaluation that meets a device fault is
        deferred by the registry, not ended: the stream stays open and
        pushes once the card is re-admitted."""
        import grpc

        srv = self._server
        if srv.subs is None:
            context.abort(
                grpc.StatusCode.UNIMPLEMENTED,
                "subscriptions disabled (DGRAPH_TPU_IVM/DGRAPH_TPU_SUBS)",
            )
        try:
            text, vars_ = decode_request(req)
        except Exception as e:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                          f"bad Request message: {e}")
        try:
            md = dict(context.invocation_metadata())
        except Exception:  # noqa: BLE001 — metadata is optional
            md = {}
        from dgraph_tpu_torch.ivm.subs import SubQuotaError

        try:
            sub = srv.subs.register(
                text, vars_ or None, tenant=md.get("x-dgraph-tenant", "")
            )
        except SubQuotaError as e:
            context.abort(grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))
        except Exception as e:
            context.abort(
                grpc.StatusCode.INVALID_ARGUMENT
                if isinstance(e, ValueError)
                else grpc.StatusCode.INTERNAL,
                str(e),
            )
        try:
            while True:
                try:
                    active = context.is_active()
                except Exception:  # noqa: BLE001 — transport quirk
                    active = True
                if not active:
                    return
                ev = sub.next_event(timeout=1.0)
                if ev is None:
                    continue
                if ev.get("kind") == "cancelled":
                    return
                out = dict(ev.get("data") or {})
                out["_subscription_"] = [{
                    "sub_id": ev.get("sub_id", ""),
                    "seq": int(ev.get("seq", 0)),
                    "kind": ev.get("kind", "update"),
                    "version": int(ev.get("version", 0)),
                    "preds": ",".join(ev.get("preds") or []),
                    "trace_id": ev.get("trace_id") or "",
                }]
                yield _p.encode_response(out)
        finally:
            if not sub.token.cancelled:
                srv.subs.cancel(sub.id, reason="disconnect")

    def _check(self, req: bytes, context):
        return encode_version()

    def _md_trace_ctx(self, context):
        """Incoming traceparent from gRPC metadata (None on anything
        malformed or absent — same contract as the HTTP header)."""
        from dgraph_tpu_torch import obs

        try:
            md = dict(context.invocation_metadata())
        except Exception:  # noqa: BLE001 — metadata is optional
            md = {}
        return obs.parse_traceparent(md.get("traceparent"))

    def _assign(self, req: bytes, context):
        import grpc

        from dgraph_tpu_torch import obs

        n = decode_num(req)
        if n <= 0:
            context.abort(grpc.StatusCode.INVALID_ARGUMENT, "Num.val must be > 0")
        from dgraph_tpu_torch.models.durability import ReadOnlyError, StorageFaultError

        srv = self._server
        # gRPC leg of the distributed trace: a sampled caller's uid
        # lease records this node's half under the same trace_id (the
        # HTTP /assign-uids endpoint's twin)
        with obs.server_span(
            "peer.assign-uids", self._md_trace_ctx(context)
        ) as ss:
            if srv.cluster is not None:
                ss.set_attr("node", srv.cluster.node_id)
            try:
                # read-only admission, same gate as the HTTP mutation
                # path: a latched disk fault may have left a torn WAL
                # tail, and an append landing after it would vanish from
                # replay — the handed-out lease would be re-issued after
                # restart
                ro = getattr(srv.store, "storage_readonly", None)
                if ro is not None and ro():
                    st = srv.store.health
                    raise ReadOnlyError(
                        "storage is in read-only mode "
                        f"({st.last_site}: {st.last_error}); "
                        "uid leasing shed until the re-arm probe clears",
                        retry_after=st.probe_interval_s,
                    )
                # the lease journals to the WAL: take the engine write
                # lock like every other journaling path, so a concurrent
                # snapshotter seal (segment swap) or re-arm reopen can
                # never interleave with this append
                with srv._engine_lock.write():
                    uids = srv.store.uids.fresh(n)
                # uid handouts must be DURABLE before the client sees
                # them (a crash re-issuing a uid aliases entities);
                # under group commit the fsync lives in this barrier,
                # OUTSIDE the lock, shared with concurrent writers
                barrier = getattr(srv.store, "sync_barrier", None)
                if barrier is not None:
                    barrier()
            except StorageFaultError as e:
                context.abort(grpc.StatusCode.UNAVAILABLE, str(e))
            return encode_assigned_ids(uids[0], uids[-1])

    # -- Worker plane (the reference's internal gRPC port) ----------------

    def _echo(self, req: bytes, context):
        # conn.go:108 Echo: payload round-trip, no auth needed (liveness)
        return req

    def _cluster_ok(self, context) -> bool:
        cluster = getattr(self._server, "cluster", None)
        if cluster is None:
            return False
        secret = getattr(getattr(cluster, "auth", None), "secret", "")
        if not secret:
            return True
        md = dict(context.invocation_metadata())
        return md.get(_SECRET_MD, "") == secret

    def _raft(self, req: bytes, context):
        import grpc

        cluster = getattr(self._server, "cluster", None)
        if cluster is None:
            context.abort(grpc.StatusCode.UNIMPLEMENTED, "not clustered")
        if not self._cluster_ok(context):
            context.abort(grpc.StatusCode.PERMISSION_DENIED, "bad cluster secret")
        from dgraph_tpu_torch import obs
        from dgraph_tpu_torch.utils.metrics import NUM_GRPC_RAFT

        NUM_GRPC_RAFT.add(1)
        # raft frames from SENDER LOOPS carry no trace context, but a
        # frame sent from a traced call path does — record its leg here
        # so the gRPC transport matches the HTTP /raft endpoint's story
        with obs.server_span(
            "peer.raft-message", self._md_trace_ctx(context)
        ) as ss:
            # duck clusters in tests may not carry an id
            ss.set_attr("node", getattr(cluster, "node_id", ""))
            try:
                group, frame = unframe_raft(decode_payload(req))
                ss.set_attr("group", group)
                cluster.deliver(group, frame)
            except Exception as e:
                context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
            return encode_payload(b"")


# ----------------------------------------------------------- client pool


class ChannelPool:
    """Refcounted gRPC channel pool with an Echo-style liveness probe —
    the analog of the reference's worker conn pool (worker/conn.go:108-173
    Pool.Get/release + query.Echo probe, here CheckVersion).  Channels are
    created on first Get(target), shared by refcount, and closed when the
    last user releases them.

    ``cafile`` (a pinned CA / server-cert PEM) builds a TLS-verified
    channel — the client-side mirror of GrpcRaftTransport's pinned-CA
    path, for servers started with ``--tls_cert`` (their gRPC listener
    serves TLS too).  Pool entries key on (target, cafile) so a
    plaintext and a TLS channel to the same host:port never alias."""

    def __init__(self):
        self._lock = threading.Lock()
        self._chans: Dict[Tuple[str, str], Tuple[object, int]] = {}

    def get(self, target: str, cafile: Optional[str] = None):
        key = (target, cafile or "")
        with self._lock:
            ent = self._chans.get(key)
            if ent is None:
                ch = make_channel(target, cafile or "")
                self._chans[key] = (ch, 1)
                return ch
            ch, rc = ent
            self._chans[key] = (ch, rc + 1)
            return ch

    def release(self, target: str, cafile: Optional[str] = None) -> None:
        key = (target, cafile or "")
        with self._lock:
            ent = self._chans.get(key)
            if ent is None:
                return
            ch, rc = ent
            if rc <= 1:
                del self._chans[key]
                ch.close()
            else:
                self._chans[key] = (ch, rc - 1)

    def probe(
        self, target: str, timeout: float = 2.0,
        cafile: Optional[str] = None,
    ) -> bool:
        """CheckVersion round-trip (conn.go's Echo/Ping analog)."""
        ch = self.get(target, cafile)
        try:
            fn = ch.unary_unary("/protos.Dgraph/CheckVersion")
            tag = decode_version(fn(b"", timeout=timeout))
            return bool(tag)
        except Exception:
            return False
        finally:
            self.release(target, cafile)
