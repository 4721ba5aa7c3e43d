"""Unmarshal query-response nodes into typed Python objects (copy of
``dgraph_tpu/client/unmarshal.py``).

Equivalent of client/unmarshal.go:253 — the Go client reflects over
struct tags to fill user structs from protobuf Node trees.  The Python
analog fills dataclasses (or plain classes with annotations) from the
JSON response tree — or from a protobuf ``Response``'s Node trees,
which ``serve/proto.decode_response`` (``HttpTransport(binary=True)``,
``GrpcTransport``) folds into the same dict shape: field name =
predicate (override with `dgraph_field` metadata), nested dataclass /
List[dataclass] fields recurse.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, List, Type, TypeVar, get_args, get_origin, get_type_hints

T = TypeVar("T")


def _field_key(f: dataclasses.Field) -> str:
    return f.metadata.get("dgraph", f.name) if f.metadata else f.name


def _convert_scalar(v: Any, t: Type) -> Any:
    if t is int:
        return int(v)
    if t is float:
        return float(v)
    if t is bool:
        return v if isinstance(v, bool) else str(v).lower() == "true"
    if t is str:
        return str(v)
    return v


def unmarshal(node: dict, cls: Type[T]) -> T:
    """Fill one dataclass instance from one response node dict."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"unmarshal target must be a dataclass, got {cls!r}")
    hints = get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        key = _field_key(f)
        if key not in node:
            continue
        v = node[key]
        t = hints.get(f.name, f.type)
        origin = get_origin(t)
        if origin in (list, typing.List):
            (inner,) = get_args(t) or (Any,)
            items = v if isinstance(v, list) else [v]
            if dataclasses.is_dataclass(inner):
                kwargs[f.name] = [unmarshal(x, inner) for x in items]
            else:
                kwargs[f.name] = [_convert_scalar(x, inner) for x in items]
        elif dataclasses.is_dataclass(t):
            item = v[0] if isinstance(v, list) else v
            kwargs[f.name] = unmarshal(item, t)
        else:
            item = v[0] if isinstance(v, list) else v
            if isinstance(item, dict):
                # scalar predicates may come back as attribute dicts
                item = item.get(key, item)
            kwargs[f.name] = _convert_scalar(item, t)
    return cls(**kwargs)


def unmarshal_list(nodes: List[dict], cls: Type[T]) -> List[T]:
    """Fill one dataclass instance per response node."""
    return [unmarshal(n, cls) for n in nodes]
