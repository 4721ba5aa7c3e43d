"""Value type system.

Equivalent of the reference's types/ package: the TypeID enum mirrors
Posting_ValType (types/scalar_types.go:60 in /root/reference), and
``convert`` implements the useful part of the conversion matrix
(types/conversion.go:36) for the types the engine supports.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from enum import IntEnum
from typing import Any, Optional


def _ts(d: _dt.datetime) -> float:
    """Timestamp treating naive datetimes as UTC (all internal datetimes
    are naive-UTC; .timestamp() alone would apply the host timezone)."""
    if d.tzinfo is None:
        d = d.replace(tzinfo=_dt.timezone.utc)
    return d.timestamp()


class TypeID(IntEnum):
    DEFAULT = 0
    BINARY = 1
    INT = 2
    FLOAT = 3
    BOOL = 4
    DATETIME = 5
    GEO = 6
    UID = 7
    PASSWORD = 8
    STRING = 9
    DATE = 10


_NAME_TO_TYPE = {
    "default": TypeID.DEFAULT,
    "binary": TypeID.BINARY,
    "int": TypeID.INT,
    "float": TypeID.FLOAT,
    "bool": TypeID.BOOL,
    "datetime": TypeID.DATETIME,
    "geo": TypeID.GEO,
    "uid": TypeID.UID,
    "password": TypeID.PASSWORD,
    "string": TypeID.STRING,
    "date": TypeID.DATE,
    # xsd names accepted in RDF typed literals (rdf/parse.go typeMap)
    "xs:string": TypeID.STRING,
    "xs:int": TypeID.INT,
    "xs:integer": TypeID.INT,
    "xs:boolean": TypeID.BOOL,
    "xs:double": TypeID.FLOAT,
    "xs:float": TypeID.FLOAT,
    "xs:date": TypeID.DATE,
    "xs:dateTime": TypeID.DATETIME,
    "http://www.w3.org/2001/XMLSchema#string": TypeID.STRING,
    "http://www.w3.org/2001/XMLSchema#int": TypeID.INT,
    "http://www.w3.org/2001/XMLSchema#integer": TypeID.INT,
    "http://www.w3.org/2001/XMLSchema#boolean": TypeID.BOOL,
    "http://www.w3.org/2001/XMLSchema#double": TypeID.FLOAT,
    "http://www.w3.org/2001/XMLSchema#float": TypeID.FLOAT,
    "http://www.w3.org/2001/XMLSchema#date": TypeID.DATE,
    "http://www.w3.org/2001/XMLSchema#dateTime": TypeID.DATETIME,
    "http://www.w3.org/2001/XMLSchema#gYear": TypeID.DATETIME,
}


def type_from_name(name: str) -> TypeID:
    t = _NAME_TO_TYPE.get(name)
    if t is None:
        raise ValueError(f"unknown type name: {name!r}")
    return t


@dataclass(frozen=True)
class TypedValue:
    """A typed scalar value, the analog of types.Val."""

    tid: TypeID
    value: Any

    def __repr__(self):  # pragma: no cover
        return f"TypedValue({self.tid.name}, {self.value!r})"


def parse_datetime(s: str) -> _dt.datetime:
    """Parse the RFC3339-ish formats the reference accepts
    (types/conversion.go ParseTime): full datetime, date, or bare year."""
    s = s.strip()
    # fast paths for the dominant shapes: bulk loads hit this once per
    # dated quad, and strptime costs ~18µs/value in locale machinery —
    # direct slicing is ~20× cheaper and bit-identical for these forms
    n = len(s)
    try:
        if (
            n == 10
            and s[4] == "-"
            and s[7] == "-"
            and s[:4].isdigit()
            and s[5:7].isdigit()
            and s[8:10].isdigit()
        ):
            return _dt.datetime(int(s[:4]), int(s[5:7]), int(s[8:10]))
        if (
            n == 19
            and s[4] == "-"
            and s[7] == "-"
            and s[10] == "T"
            and s[13] == ":"
            and s[16] == ":"
            and s[:4].isdigit()
            and s[5:7].isdigit()
            and s[8:10].isdigit()
            and s[11:13].isdigit()
            and s[14:16].isdigit()
            and s[17:19].isdigit()
        ):
            return _dt.datetime(
                int(s[:4]), int(s[5:7]), int(s[8:10]),
                int(s[11:13]), int(s[14:16]), int(s[17:19]),
            )
        if n == 4 and s.isdigit():
            return _dt.datetime(int(s), 1, 1)
    except ValueError:
        pass  # e.g. month 13: fall through to the full chain's error
    for fmt in ("%Y-%m-%dT%H:%M:%S%z", "%Y-%m-%dT%H:%M:%S", "%Y-%m-%d", "%Y"):
        try:
            return _dt.datetime.strptime(s, fmt)
        except ValueError:
            continue
    # fromisoformat handles fractional seconds and offsets
    try:
        return _dt.datetime.fromisoformat(s.replace("Z", "+00:00"))
    except ValueError:
        raise ValueError(f"cannot parse datetime: {s!r}")


def convert(v: TypedValue, to: TypeID) -> TypedValue:
    """Convert a value between types (subset of types/conversion.go:36)."""
    if v.tid == to:
        return v
    src, val = v.tid, v.value
    if src in (TypeID.DEFAULT, TypeID.STRING, TypeID.BINARY):
        s = val if isinstance(val, str) else bytes(val).decode("utf-8")
        if to in (TypeID.STRING, TypeID.DEFAULT):
            return TypedValue(to, s)
        if to == TypeID.INT:
            return TypedValue(to, int(s))
        if to == TypeID.FLOAT:
            return TypedValue(to, float(s))
        if to == TypeID.BOOL:
            if s in ("true", "1", "T", "True"):
                return TypedValue(to, True)
            if s in ("false", "0", "F", "False"):
                return TypedValue(to, False)
            raise ValueError(f"cannot convert {s!r} to bool")
        if to in (TypeID.DATETIME, TypeID.DATE):
            return TypedValue(to, parse_datetime(s))
        if to == TypeID.PASSWORD:
            return TypedValue(to, s)
        if to == TypeID.GEO:
            from dgraph_tpu_torch.models import geo as _geo

            return TypedValue(to, _geo.parse_geojson(s))
    if src == TypeID.INT:
        if to == TypeID.FLOAT:
            return TypedValue(to, float(val))
        if to == TypeID.BOOL:
            return TypedValue(to, val != 0)
        if to in (TypeID.STRING, TypeID.DEFAULT):
            return TypedValue(to, str(val))
        if to in (TypeID.DATETIME, TypeID.DATE):
            return TypedValue(to, _dt.datetime.utcfromtimestamp(val))
    if src == TypeID.FLOAT:
        if to == TypeID.INT:
            return TypedValue(to, int(val))
        if to == TypeID.BOOL:
            return TypedValue(to, val != 0.0)
        if to in (TypeID.STRING, TypeID.DEFAULT):
            return TypedValue(to, str(val))
    if src == TypeID.BOOL:
        if to == TypeID.INT:
            return TypedValue(to, int(val))
        if to == TypeID.FLOAT:
            return TypedValue(to, float(val))
        if to in (TypeID.STRING, TypeID.DEFAULT):
            return TypedValue(to, "true" if val else "false")
    if src in (TypeID.DATETIME, TypeID.DATE):
        if to in (TypeID.DATETIME, TypeID.DATE):
            return TypedValue(to, val)
        if to in (TypeID.STRING, TypeID.DEFAULT):
            return TypedValue(to, val.isoformat())
        if to == TypeID.INT:
            return TypedValue(to, int(_ts(val)))
        if to == TypeID.FLOAT:
            return TypedValue(to, _ts(val))
    raise ValueError(f"cannot convert {src.name} -> {to.name}")


def compare_vals(op: str, a: TypedValue, b: TypedValue) -> bool:
    """types.CompareVals (types/compare.go:23): numeric promotion, then
    python comparison."""
    av, bv = a.value, b.value
    if {a.tid, b.tid} <= {TypeID.INT, TypeID.FLOAT}:
        av, bv = float(av), float(bv)
    elif a.tid != b.tid:
        try:
            bv = convert(b, a.tid).value
        except ValueError:
            return False
    if op == "eq":
        return av == bv
    if op == "lt":
        return av < bv
    if op == "le":
        return av <= bv
    if op == "gt":
        return av > bv
    if op == "ge":
        return av >= bv
    raise ValueError(f"unknown comparison op {op!r}")


def sort_key(v: TypedValue):
    """A python sort key for host-side value sorting (types/sort.go:92)."""
    if v.tid in (TypeID.INT, TypeID.FLOAT):
        return (0, float(v.value))
    if v.tid in (TypeID.DATETIME, TypeID.DATE):
        return (1, _ts(v.value) if hasattr(v.value, "timestamp") else 0)
    if v.tid == TypeID.BOOL:
        return (2, bool(v.value))
    return (3, str(v.value))


def numeric(v: TypedValue) -> Optional[float]:
    """Float view for device value arenas (order-by / aggregation / math)."""
    if v.tid in (TypeID.INT, TypeID.FLOAT):
        return float(v.value)
    if v.tid == TypeID.BOOL:
        return 1.0 if v.value else 0.0
    if v.tid in (TypeID.DATETIME, TypeID.DATE):
        try:
            return _ts(v.value)
        except (OSError, OverflowError, ValueError):
            return None
    return None
