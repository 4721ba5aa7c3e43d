"""The port's protobuf wire codec (``dgraph_tpu_torch/serve/proto.py``)
against the reference's (``dgraph_tpu/serve/proto.py``), on the CPU.

The cases of tests/test_proto.py, each held to the reference: the same
value or result tree through both encoders gives the same bytes, both
decoders give the same tree back, and the live ``/query`` endpoint of a
port server and of a reference server over the same mutation answer
``Accept: application/protobuf`` (and ``application/x-protobuf``) with
the same ``Response`` bytes, the latency field aside.  Tolerance 0
throughout.
"""

import json
import struct
import urllib.request

import pytest

from dgraph_tpu.models import PostingStore as JaxStore
from dgraph_tpu.serve import proto as jproto
from dgraph_tpu.serve.server import DgraphServer as JaxServer
from dgraph_tpu_torch.models import PostingStore
from dgraph_tpu_torch.serve import proto
from dgraph_tpu_torch.serve.server import DgraphServer

from torch_pins import pinned_planner  # noqa: F401

pytestmark = [
    pytest.mark.compile_budget(400),
    pytest.mark.usefixtures("pinned_planner"),
]


# ---------------------------------------------------------------- wire level


@pytest.mark.parametrize("n,want", [
    (0, b"\x00"), (1, b"\x01"), (150, b"\x96\x01"),  # protobuf docs' example
    (-1, None),  # int64 negatives are 10-byte two's complement
    ((1 << 63) - 1, None),
])
def test_varint_wire_bytes(n, want):
    got = proto._varint(n)
    assert got == jproto._varint(n)
    if want is not None:
        assert got == want
    if n < 0:
        assert len(got) == 10


VALUES = [True, False, 42, -7, 0, 1 << 40, 2.5, -0.0, "hi", "", "ünï",
          b"\x00\x01", b""]


@pytest.mark.parametrize("v", VALUES, ids=repr)
def test_value_encoding_types(v):
    # bool must win over int (bool is an int subclass)
    b = proto.encode_value(v)
    assert b == jproto.encode_value(v)
    got = proto.decode_value(b)
    assert got == jproto.decode_value(b)
    assert type(got) is type(v) and got == v


def test_value_field_numbers_match_proto():
    # str_val is field 5 (graphresponse.proto Value), len-delimited
    b = proto.encode_value("x")
    assert b[0] == (5 << 3) | 2
    # int_val field 3 varint
    b = proto.encode_value(3)
    assert b[0] == (3 << 3) | 0
    # double_val field 6 wire type I64
    b = proto.encode_value(1.0)
    assert b[0] == (6 << 3) | 1
    assert struct.unpack("<d", b[1:9])[0] == 1.0
    # a list or dict never ships as a Python repr: JSON in str_val
    for v in ([1, 2], {"a": 1}):
        assert proto.encode_value(v) == jproto.encode_value(v)
        assert json.loads(proto.decode_value(proto.encode_value(v))) == v


# ------------------------------------------------------------- round trips

POLY = {
    "type": "Polygon",
    "coordinates": [[[0.0, 1.0], [1.0, 1.0], [1.0, 0.0], [0.0, 1.0]]],
}

TREES = {
    "simple_block": {"q": [{"name": "Alice", "age": 30}, {"name": "Bob"}]},
    "nested_children_and_uids": {"me": [{
        "_uid_": "0x1", "name": "Michonne",
        "friend": [{"_uid_": "0x17", "name": "Rick", "alive": True},
                   {"name": "Glenn", "age": 22}],
    }]},
    # value facets: attr → facet map; edge facets: "_" → facet map;
    # @groupby is a list of group buckets
    "facets_and_groupby": {
        "q": [
            {"name": "A",
             "@facets": {"name": {"origin": "fr", "since": "2006-01-02T15:04:05Z"}}},
            {"name": "B", "@facets": {"_": {"close": True, "weight": 0.5}}},
        ],
        "g": [{"@groupby": [{"age": 17, "count": 2}, {"age": 19, "count": 1}]}],
    },
    # geo values ride geo_val bytes as GeoJSON: had the polygon shipped
    # as str_val, the decode would yield a JSON string, not the dict
    "geo_value": {"q": [{"name": "A", "loc": POLY}]},
    "scalar_list_property": {"q": [{"tags": ["a", "b", "c"]}]},
    # a user block named "uids" (list shape) encodes as a query block;
    # only the mutation's AssignedUids map (dict shape) takes field 3
    "block_aliased_uids": {"uids": [{"name": "A"}]},
    "empty_block": {"q": [], "r": [{"uid": "0x2"}]},
    "uid_hex": {"q": [{"uid": "0xffffffffff", "e": [{"uid": "0x1"}]}]},
}


@pytest.mark.parametrize("name", sorted(TREES))
def test_roundtrip_matches_reference(name):
    out = TREES[name]
    b = proto.encode_response(out)
    assert b == jproto.encode_response(out)
    got = proto.decode_response(b)
    assert got == jproto.decode_response(b) == out


def test_roundtrip_latency_uids_schema():
    out = {
        "q": [{"n": 1}],
        "server_latency": {"parsing": "1ms", "processing": "2ms", "pb": "0.1ms"},
        "uids": {"new": "0x2711"},
        "schema": [{"predicate": "name", "type": "string", "index": True,
                    "tokenizer": ["term"]}],
    }
    b = proto.encode_response(out)
    assert b == jproto.encode_response(out)
    got = proto.decode_response(b)
    assert got == jproto.decode_response(b)
    for k in ("q", "server_latency", "uids", "schema"):
        assert got[k] == out[k]


@pytest.mark.parametrize("child_first", [False, True])
def test_decoder_survives_property_child_name_collision(child_first):
    # legal protobuf a foreign encoder could emit: a property and a child
    # node sharing a name — coerced to a list, in wire order
    prop = proto._property("x", proto.encode_value("scalar"))
    assert prop == jproto._property("x", jproto.encode_value("scalar"))
    child = proto.encode_node("x", {"y": 1})
    parts = [proto._len_field(3, child), proto._len_field(2, prop)]
    if not child_first:
        parts.reverse()
    node = proto._str_field(1, "n") + b"".join(parts)
    _, obj = proto.decode_node(node)
    assert (_, obj) == jproto.decode_node(node)
    want = [{"y": 1}, "scalar"] if child_first else ["scalar", {"y": 1}]
    assert obj["x"] == want


def test_iter_fields_matches_reference():
    b = proto.encode_response(TREES["facets_and_groupby"]) + proto._key(9, 5) + b"\x01\x02\x03\x04"
    assert list(proto.iter_fields(b)) == list(jproto.iter_fields(b))
    with pytest.raises(ValueError):
        list(proto.iter_fields(proto._key(1, 3)))


# ------------------------------------------------------------ live endpoint

SEED = (b'mutation { schema { name: string @index(term) . } set { '
        b'<0x1> <name> "Alice" . <0x1> <follows> <0x2> . <0x2> <name> "Bob" . '
        b'<0x1> <age> "30"^^<xs:int> . <0x2> <follows> <0x3> . } }')


def _query(addr, body, accept=None):
    req = urllib.request.Request(
        addr + "/query", data=body, method="POST",
        headers={"Accept": accept} if accept else {},
    )
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.headers["Content-Type"], r.read()


def _without_latency(raw: bytes) -> list:
    """Top-level (field, wire, value) triples with the Latency (field 2)
    left out: the only field whose bytes differ between two runs."""
    return [f for f in proto.iter_fields(raw) if f[0] != 2]


@pytest.fixture(scope="module")
def servers():
    port = DgraphServer(PostingStore(), device="cpu")
    ref = JaxServer(JaxStore())
    for s in (port, ref):
        s.start()
    try:
        for s in (port, ref):
            _query(s.addr, SEED)
        yield port, ref
    finally:
        for s in (port, ref):
            s.stop()


QUERIES = [
    b"{ q(func: uid(0x1)) { name follows { name } } }",
    b"{ q(func: uid(0x1, 0x2)) { uid name age follows { uid follows { uid } } } }",
    b'{ q(func: anyofterms(name, "Alice Bob")) { name count(follows) } }',
    b"{ q(func: uid(0x9)) { name } }",  # an empty block
]


@pytest.mark.parametrize("accept", ["application/protobuf", "application/x-protobuf"])
@pytest.mark.parametrize("qi", range(len(QUERIES)))
def test_query_serves_protobuf(servers, accept, qi):
    port, ref = servers
    q = QUERIES[qi]
    ctype, raw = _query(port.addr, q, accept)
    assert ctype == "application/protobuf"
    rtype, rraw = _query(ref.addr, q, accept)
    assert rtype == ctype
    assert _without_latency(raw) == _without_latency(rraw)
    got = proto.decode_response(raw)
    assert "server_latency" in got
    # the same query over JSON: the two surfaces agree on content
    _t, js = _query(port.addr, q)
    want = json.loads(js)
    want.pop("server_latency")
    got.pop("server_latency")
    assert got == want
