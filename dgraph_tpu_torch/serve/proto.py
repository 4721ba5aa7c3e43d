"""Protobuf wire-format Response encoding for binary clients (copy of
``dgraph_tpu/serve/proto.py``: the bytes are the reference's).

Upstream Dgraph's machine API returns protobuf Response messages
(protos/graphresponse.proto:24-28 ``service Dgraph { rpc Run (Request)
returns (Response) }``; query/outputnode.go:240 ToProtocolBuffer).  The
protobuf *wire format* needs no library: this module hand-encodes
Response/Node/Property/Value/Latency/SchemaNode exactly as proto3
serializes them, so any stock protobuf client compiled from
graphresponse.proto can decode the bytes.  Served from /query when the
request carries ``Accept: application/protobuf`` (or
``application/x-protobuf``), and as the message codec under the gRPC
transport (serve/grpc_server.py: grpcio provides the HTTP/2 framing,
this module the bytes).

Field numbers below mirror graphresponse.proto:

  Response: n=1 (repeated Node), l=2 (Latency), AssignedUids=3 (map),
            schema=4 (repeated SchemaNode)
  Node:     attribute=1, properties=2, children=3
  Property: prop=1, value=2
  Value:    default_val=1, bytes_val=2, int_val=3, bool_val=4, str_val=5,
            double_val=6, geo_val=7, date_val=8, datetime_val=9,
            password_val=10, uid_val=11
  Latency:  parsing=1, processing=2, pb=3
  SchemaNode: predicate=1, type=2, index=3, tokenizer=4, reverse=5, count=6

The encoder walks the JSON-able result tree produced by
query/outputnode.py, so the two surfaces can never disagree about
*content*; value typing follows upstream's types.ObjectValue
(types/conversion.go:457) with two documented substitutions: datetime
values — already rendered to ISO-8601 by the JSON path — ship as str_val
rather than Go binary-marshaled time, and geo values ship as geo_val
bytes holding UTF-8 GeoJSON rather than WKB (conversion.go:497).
"""

from __future__ import annotations

import json as _json
import struct
from typing import Any, Dict, Iterator, List, Tuple

from dgraph_tpu_torch.models import codec as _codec

# wire types
_VARINT = 0
_I64 = 1
_LEN = 2


def _varint(n: int) -> bytes:
    """Unsigned LEB128 (delegates to the WAL codec's audited encoder)."""
    if n < 0:
        n &= (1 << 64) - 1  # two's-complement 64-bit, proto int64 rule
    out = bytearray()
    _codec.put_uvarint(out, n)
    return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _key(field, _LEN) + _varint(len(payload)) + payload


def _str_field(field: int, s: str) -> bytes:
    return _len_field(field, s.encode("utf-8"))


def _varint_field(field: int, n: int) -> bytes:
    return _key(field, _VARINT) + _varint(n)


def _double_field(field: int, v: float) -> bytes:
    return _key(field, _I64) + struct.pack("<d", v)


def encode_value(v: Any) -> bytes:
    """Python JSON scalar → Value message bytes (types.ObjectValue analog).

    Hex uid strings are handled by the caller (uid properties use uid_val);
    here: bool→bool_val, int→int_val, float→double_val, str→str_val,
    bytes→bytes_val.
    """
    if isinstance(v, bool):  # before int: bool is an int subclass
        return _varint_field(4, 1 if v else 0)
    if isinstance(v, int):
        return _varint_field(3, v)
    if isinstance(v, float):
        return _double_field(6, v)
    if isinstance(v, bytes):
        return _len_field(2, v)
    if isinstance(v, (list, dict)):
        # should not occur (geo dicts take the geo_val path in encode_node;
        # the JSON surface has no other nested-scalar shapes) — but never
        # ship a Python repr: JSON-encode so any client can still parse it
        return _str_field(5, _json.dumps(v))
    return _str_field(5, str(v))


def _is_geojson(v: Any) -> bool:
    return (
        isinstance(v, dict)
        and isinstance(v.get("type"), str)
        and "coordinates" in v
    )


def _property(prop: str, value_msg: bytes) -> bytes:
    return _str_field(1, prop) + _len_field(2, value_msg)


def encode_node(attribute: str, obj: Dict[str, Any]) -> bytes:
    """One result object → Node message bytes (preorder, like
    ToProtocolBuffer).  Lists of objects become repeated children with the
    key as their attribute; "_uid_"/"uid" hex strings become uid_val
    properties (protoNode.SetUID, outputnode.go:150); nested dicts
    (@facets/@groupby buckets) become single child nodes."""
    out = bytearray(_str_field(1, attribute))
    for k, v in obj.items():
        if k in ("_uid_", "uid") and isinstance(v, str) and v.startswith("0x"):
            out += _len_field(2, _property(k, _varint_field(11, int(v, 16))))
        elif _is_geojson(v):
            # geo values: geo_val bytes carrying the GeoJSON document
            gv = _len_field(7, _json.dumps(v).encode("utf-8"))
            out += _len_field(2, _property(k, gv))
        elif isinstance(v, list):
            if v and all(isinstance(e, dict) for e in v):
                for e in v:
                    out += _len_field(3, encode_node(k, e))
            else:
                for e in v:
                    out += _len_field(2, _property(k, encode_value(e)))
        elif isinstance(v, dict):
            out += _len_field(3, encode_node(k, v))
        else:
            out += _len_field(2, _property(k, encode_value(v)))
    return bytes(out)


def _latency(lat: Dict[str, Any]) -> bytes:
    out = bytearray()
    if lat.get("parsing"):
        out += _str_field(1, str(lat["parsing"]))
    if lat.get("processing"):
        out += _str_field(2, str(lat["processing"]))
    if lat.get("json") or lat.get("pb"):
        out += _str_field(3, str(lat.get("pb") or lat.get("json")))
    return bytes(out)


def _schema_node(s: Dict[str, Any]) -> bytes:
    out = bytearray()
    if s.get("predicate"):
        out += _str_field(1, s["predicate"])
    if s.get("type"):
        out += _str_field(2, s["type"])
    if s.get("index"):
        out += _varint_field(3, 1)
    for t in s.get("tokenizer", []) or []:
        out += _str_field(4, t)
    if s.get("reverse"):
        out += _varint_field(5, 1)
    if s.get("count"):
        out += _varint_field(6, 1)
    return bytes(out)


def _is_meta(k: str, v: Any) -> bool:
    """Response-metadata keys, shape-gated so a user block that happens to
    be aliased "uids"/"code"/"message" (always a list of result objects)
    still encodes as a query block.  "schema" is inherently ambiguous —
    both a schema query's result and a hypothetical alias are lists of
    dicts — and always takes Response.schema (field 4), matching the
    reference where schema results never ride in Node trees
    (graphresponse.proto Response.schema)."""
    if k == "server_latency":
        return True
    if k == "uids":
        return isinstance(v, dict)
    if k == "degraded":
        # stale-read disclosure (resilience layer): metadata, not a
        # result block — gRPC carries it as a trailer instead
        return isinstance(v, dict)
    if k in ("code", "message"):
        return isinstance(v, str)
    return k == "schema"


def encode_response(out: Dict[str, Any]) -> bytes:
    """Full query result dict → Response message bytes.

    Each query block becomes one Node{attribute:"_root_"} whose children
    all carry the block name as attribute — the exact shape
    ToProtocolBuffer emits per SubGraph (outputnode.go:240-287)."""
    buf = bytearray()
    for k, v in out.items():
        if _is_meta(k, v):
            continue
        root = bytearray(_str_field(1, "_root_"))
        items = v if isinstance(v, list) else [v]
        wrote = 0
        for obj in items:
            if isinstance(obj, dict):
                root += _len_field(3, encode_node(k, obj))
                wrote += 1
        if not wrote:
            # empty block: a bare named child keeps the block key on the
            # wire (JSON surface always reports {"k": []}); the decoder
            # folds a lone empty object back to [] — unambiguous because
            # the JSON encoder never emits empty result objects
            root += _len_field(3, _str_field(1, k))
        buf += _len_field(1, bytes(root))
    lat = out.get("server_latency")
    if lat:
        buf += _len_field(2, _latency(lat))
    uids = out.get("uids")
    if isinstance(uids, dict):  # same shape gate as _is_meta
        for name, uid in uids.items():
            n = int(uid, 16) if isinstance(uid, str) else int(uid)
            entry = _str_field(1, name) + _varint_field(2, n)
            buf += _len_field(3, entry)
    for s in out.get("schema", []) or []:
        buf += _len_field(4, _schema_node(s))
    return bytes(buf)


# ---------------------------------------------------------------------------
# Generic wire-format reader + typed Response decoder (client side / tests).


_read_varint = _codec.uvarint  # same LEB128, one audited implementation


def iter_fields(b: bytes) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field, wire, value) triples from a message payload."""
    i = 0
    while i < len(b):
        tag, i = _read_varint(b, i)
        field, wire = tag >> 3, tag & 7
        if wire == _VARINT:
            v, i = _read_varint(b, i)
        elif wire == _I64:
            v, i = b[i : i + 8], i + 8
        elif wire == _LEN:
            ln, i = _read_varint(b, i)
            v, i = b[i : i + ln], i + ln
        elif wire == 5:  # I32
            v, i = b[i : i + 4], i + 4
        else:
            raise ValueError(f"bad wire type {wire}")
        yield field, wire, v


def decode_value(b: bytes) -> Any:
    for field, _, v in iter_fields(b):
        if field == 4:
            return bool(v)
        if field == 3:
            return v - (1 << 64) if v >= 1 << 63 else v
        if field == 6:
            return struct.unpack("<d", v)[0]
        if field in (1, 5, 10):
            return v.decode("utf-8")
        if field == 11:
            return hex(v)
        if field == 7:  # geo_val: UTF-8 GeoJSON (see module docstring)
            return _json.loads(v.decode("utf-8"))
        if field in (2, 8, 9):
            return bytes(v)
    return None


def decode_node(b: bytes) -> Tuple[str, Dict[str, Any]]:
    """Node bytes → (attribute, result-object dict). Inverse of
    encode_node: repeated children with one attribute fold back into a
    list; uid_val properties render as hex strings.  Name collisions
    between properties and children (legal protobuf, not produced by our
    encoder) coerce into one list rather than crashing.

    Known wire ambiguity (inherent to proto3 repeated fields): a
    one-element scalar list like {"tags": ["a"]} encodes to a single
    Property and decodes back as the bare scalar {"tags": "a"} — the
    bytes cannot distinguish the two shapes."""
    attribute = ""
    obj: Dict[str, Any] = {}
    for field, _, v in iter_fields(b):
        if field == 1:
            attribute = v.decode("utf-8")
        elif field == 2:  # property
            prop, val = "", None
            for f2, _, v2 in iter_fields(v):
                if f2 == 1:
                    prop = v2.decode("utf-8")
                elif f2 == 2:
                    val = decode_value(v2)
            if prop not in obj:
                obj[prop] = val
            elif isinstance(obj[prop], list):
                obj[prop].append(val)
            else:
                obj[prop] = [obj[prop], val]
        elif field == 3:  # child node
            cattr, cobj = decode_node(v)
            if cattr in obj and not isinstance(obj[cattr], list):
                obj[cattr] = [obj[cattr]]
            obj.setdefault(cattr, []).append(cobj)
    # On the wire every child is repeated; in the JSON surface "@facets"
    # always maps each attr (or "_" for edge facets) to a single facet
    # map (outputnode.py _facets_json), so unwrap the whole subtree —
    # "@groupby" and edge attributes stay lists.
    if "@facets" in obj and isinstance(obj["@facets"], list) and len(obj["@facets"]) == 1:
        fac = obj["@facets"][0]
        obj["@facets"] = {
            k: (v[0] if isinstance(v, list) and len(v) == 1 and isinstance(v[0], dict) else v)
            for k, v in fac.items()
        }
    return attribute, obj


def decode_response(b: bytes) -> Dict[str, Any]:
    """Response bytes → result dict in the JSON encoder's shape."""
    out: Dict[str, Any] = {}
    for field, _, v in iter_fields(b):
        if field == 1:
            _, root = decode_node(v)
            for k, nodes in root.items():
                if nodes == [{}]:  # empty-block marker (see encode_response)
                    out.setdefault(k, [])
                else:
                    out.setdefault(k, []).extend(nodes)
        elif field == 2:
            lat = {}
            lat_names = {1: "parsing", 2: "processing", 3: "pb"}
            for f2, _, v2 in iter_fields(v):
                # proto3 unknown-field tolerance: a newer server may add
                # Latency fields old clients must skip, not crash on
                name = lat_names.get(f2)
                if name is not None:
                    lat[name] = v2.decode()
            out["server_latency"] = lat
        elif field == 3:
            name = uid = None
            for f2, w2, v2 in iter_fields(v):
                if f2 == 1:
                    name = v2.decode("utf-8")
                elif f2 == 2:
                    uid = hex(v2)
            out.setdefault("uids", {})[name] = uid
        elif field == 4:
            s: Dict[str, Any] = {}
            for f2, _, v2 in iter_fields(v):
                if f2 == 1:
                    s["predicate"] = v2.decode()
                elif f2 == 2:
                    s["type"] = v2.decode()
                elif f2 == 3:
                    s["index"] = bool(v2)
                elif f2 == 4:
                    s.setdefault("tokenizer", []).append(v2.decode())
                elif f2 == 5:
                    s["reverse"] = bool(v2)
                elif f2 == 6:
                    s["count"] = bool(v2)
            out.setdefault("schema", []).append(s)
    return out
