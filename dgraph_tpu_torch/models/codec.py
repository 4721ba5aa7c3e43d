"""Binary codec for durable records: varints + typed values + edges
(copy of ``dgraph_tpu/models/codec.py``; the bytes are the same, so a
store directory written by either package recovers in the other).

The reference serializes postings/WAL entries as protobuf into Badger
(posting/list.go SyncIfDirty, raftwal/wal.go).  Here the equivalent wire
format is a hand-rolled varint codec shared by the WAL, snapshots and the
bulk loader; the layout is deliberately language-neutral so the C++
fast-path (native/) encodes/decodes the same bytes.

Record payloads (first byte = record tag):

  0x01 EDGE    flags pred src [dst | value] [lang] [facets]
  0x02 SCHEMA  utf8 schema-language text
  0x03 XID     xid-string uid
  0x04 LEASE   next-uid
  0x05 DELPRED pred

Typed values: type byte (TypeID) + payload — zigzag varint for INT,
8-byte LE double for FLOAT, raw byte for BOOL, length-prefixed utf8 for
string-ish types, isoformat string for datetimes, GeoJSON string for GEO.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Tuple

from dgraph_tpu_torch.models.types import TypeID, TypedValue, parse_datetime

EDGE = 0x01
SCHEMA = 0x02
XID = 0x03
LEASE = 0x04
DELPRED = 0x05
BULKEDGES = 0x06
MEMBER = 0x07   # cluster membership: node_id + serving address
BULKVALS = 0x08  # one record for a predicate group of plain value edges

_F_DEL = 1
_F_VALUE = 2
_F_FACETS = 4
_F_LANG = 8


# -- varints ----------------------------------------------------------------

def put_uvarint(buf: bytearray, x: int) -> None:
    while x >= 0x80:
        buf.append((x & 0x7F) | 0x80)
        x >>= 7
    buf.append(x)


def uvarint(b: bytes, pos: int) -> Tuple[int, int]:
    x = 0
    shift = 0
    while True:
        c = b[pos]
        pos += 1
        x |= (c & 0x7F) << shift
        if c < 0x80:
            return x, pos
        shift += 7


def put_varint(buf: bytearray, x: int) -> None:
    put_uvarint(buf, (x << 1) ^ (x >> 63) if x < 0 else x << 1)


def varint(b: bytes, pos: int) -> Tuple[int, int]:
    u, pos = uvarint(b, pos)
    return (u >> 1) ^ -(u & 1), pos


def put_str(buf: bytearray, s: str) -> None:
    raw = s.encode("utf-8")
    put_uvarint(buf, len(raw))
    buf.extend(raw)


def get_str(b: bytes, pos: int) -> Tuple[str, int]:
    n, pos = uvarint(b, pos)
    return b[pos : pos + n].decode("utf-8"), pos + n


# -- typed values -----------------------------------------------------------

def put_value(buf: bytearray, v: TypedValue) -> None:
    buf.append(int(v.tid))
    t, val = v.tid, v.value
    if t == TypeID.INT:
        put_varint(buf, int(val))
    elif t == TypeID.FLOAT:
        buf.extend(struct.pack("<d", float(val)))
    elif t == TypeID.BOOL:
        buf.append(1 if val else 0)
    elif t in (TypeID.DATETIME, TypeID.DATE):
        put_str(buf, val.isoformat())
    elif t == TypeID.GEO:
        put_str(buf, json.dumps(val.to_geojson(), separators=(",", ":")))
    elif t == TypeID.BINARY:
        raw = bytes(val)
        put_uvarint(buf, len(raw))
        buf.extend(raw)
    else:  # STRING / DEFAULT / PASSWORD / UID-as-str
        put_str(buf, str(val))


def get_value(b: bytes, pos: int) -> Tuple[TypedValue, int]:
    t = TypeID(b[pos])
    pos += 1
    if t == TypeID.INT:
        x, pos = varint(b, pos)
        return TypedValue(t, x), pos
    if t == TypeID.FLOAT:
        (x,) = struct.unpack_from("<d", b, pos)
        return TypedValue(t, x), pos + 8
    if t == TypeID.BOOL:
        return TypedValue(t, b[pos] != 0), pos + 1
    if t in (TypeID.DATETIME, TypeID.DATE):
        s, pos = get_str(b, pos)
        return TypedValue(t, parse_datetime(s)), pos
    if t == TypeID.GEO:
        s, pos = get_str(b, pos)
        from dgraph_tpu_torch.models.geo import parse_geojson

        return TypedValue(t, parse_geojson(s)), pos
    if t == TypeID.BINARY:
        n, pos = uvarint(b, pos)
        return TypedValue(t, bytes(b[pos : pos + n])), pos + n
    s, pos = get_str(b, pos)
    return TypedValue(t, s), pos


def put_facets(buf: bytearray, facets: Dict[str, TypedValue]) -> None:
    put_uvarint(buf, len(facets))
    for k in sorted(facets):
        put_str(buf, k)
        put_value(buf, facets[k])


def get_facets(b: bytes, pos: int) -> Tuple[Dict[str, TypedValue], int]:
    n, pos = uvarint(b, pos)
    out = {}
    for _ in range(n):
        k, pos = get_str(b, pos)
        v, pos = get_value(b, pos)
        out[k] = v
    return out, pos


# -- records ----------------------------------------------------------------

def encode_edge(e) -> bytes:
    """Edge (models/store.py) → EDGE record payload."""
    buf = bytearray([EDGE])
    flags = 0
    if e.op == "del":
        flags |= _F_DEL
    if e.value is not None:
        flags |= _F_VALUE
    if e.facets:
        flags |= _F_FACETS
    if e.lang:
        flags |= _F_LANG
    buf.append(flags)
    put_str(buf, e.pred)
    put_uvarint(buf, e.src)
    if e.value is not None:
        put_value(buf, e.value)
    else:
        put_uvarint(buf, e.dst)
    if e.lang:
        put_str(buf, e.lang)
    if e.facets:
        put_facets(buf, e.facets)
    return bytes(buf)


def decode_edge(b: bytes):
    from dgraph_tpu_torch.models.store import Edge

    assert b[0] == EDGE
    flags = b[1]
    pos = 2
    pred, pos = get_str(b, pos)
    src, pos = uvarint(b, pos)
    value = None
    dst = 0
    if flags & _F_VALUE:
        value, pos = get_value(b, pos)
    else:
        dst, pos = uvarint(b, pos)
    lang = ""
    if flags & _F_LANG:
        lang, pos = get_str(b, pos)
    facets = None
    if flags & _F_FACETS:
        facets, pos = get_facets(b, pos)
    return Edge(
        pred=pred,
        src=src,
        dst=dst,
        value=value,
        lang=lang,
        facets=facets,
        op="del" if flags & _F_DEL else "set",
    )


def encode_bulk_edges(pred: str, src, dst) -> bytes:
    """One record for a whole group of plain uid edges (the native bulk
    ingest journals per predicate-group, not per edge).  The record is
    assembled by one join over views of the arrays: one copy of the
    16·n bytes (336 MB for a 21M-edge group), where growing a bytearray
    and converting it would make three."""
    import numpy as np

    head = bytearray([BULKEDGES])
    put_str(head, pred)
    src = np.ascontiguousarray(src, dtype="<i8")
    dst = np.ascontiguousarray(dst, dtype="<i8")
    put_uvarint(head, len(src))
    return b"".join((head, memoryview(src).cast("B"), memoryview(dst).cast("B")))


def decode_bulk_edges(b: bytes):
    import numpy as np

    assert b[0] == BULKEDGES
    pred, pos = get_str(b, 1)
    n, pos = uvarint(b, pos)
    src = np.frombuffer(b, dtype="<i8", count=n, offset=pos)
    dst = np.frombuffer(b, dtype="<i8", count=n, offset=pos + 8 * n)
    return pred, src, dst


def encode_bulk_values(pred: str, items) -> bytes:
    """One record for a predicate group of plain (facet-less) value
    edges; ``items`` = [(src, lang, TypedValue)] in INPUT ORDER (repeated
    writes of one (src, lang) are last-write-wins, so order is part of
    the record's meaning)."""
    buf = bytearray([BULKVALS])
    put_str(buf, pred)
    put_uvarint(buf, len(items))
    for src, lang, v in items:
        put_uvarint(buf, src)
        put_str(buf, lang)
        put_value(buf, v)
    return bytes(buf)


def decode_bulk_values(b: bytes):
    assert b[0] == BULKVALS
    pred, pos = get_str(b, 1)
    n, pos = uvarint(b, pos)
    items = []
    for _ in range(n):
        src, pos = uvarint(b, pos)
        lang, pos = get_str(b, pos)
        v, pos = get_value(b, pos)
        items.append((src, lang, v))
    return pred, items


def encode_schema(text: str) -> bytes:
    buf = bytearray([SCHEMA])
    put_str(buf, text)
    return bytes(buf)


def encode_xid(xid: str, uid: int) -> bytes:
    buf = bytearray([XID])
    put_str(buf, xid)
    put_uvarint(buf, uid)
    return bytes(buf)


def encode_lease(next_uid: int) -> bytes:
    buf = bytearray([LEASE])
    put_uvarint(buf, next_uid)
    return bytes(buf)


def encode_delpred(pred: str) -> bytes:
    buf = bytearray([DELPRED])
    put_str(buf, pred)
    return bytes(buf)


def encode_member(node_id: str, addr: str, groups=()) -> bytes:
    """Runtime membership record (worker/groups.go applyMembershipUpdate
    analog): replicated through the metadata group so every server —
    including restarts replaying the log — learns the peer.  ``groups``
    lists the raft groups the member serves; empty = all (legacy)."""
    buf = bytearray([MEMBER])
    put_str(buf, node_id)
    put_str(buf, addr)
    put_uvarint(buf, len(groups))
    for g in groups:
        put_uvarint(buf, g)
    return bytes(buf)


def decode_member(payload: bytes):
    nid, pos = get_str(payload, 1)
    addr, pos = get_str(payload, pos)
    groups = []
    if pos < len(payload):
        n, pos = uvarint(payload, pos)
        for _ in range(n):
            g, pos = uvarint(payload, pos)
            groups.append(g)
    return nid, addr, groups
