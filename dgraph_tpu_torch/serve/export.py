"""RDF export: store state → gzipped N-Quad files + schema file (copy of
``dgraph_tpu/serve/export.py``).

Equivalent of worker/export.go (export:190, toRDF:72, toSchema:138):
walk every predicate's postings, emit one N-Quad per posting with typed
literals, lang tags, and facets, plus the schema in schema-file syntax.
Filenames follow the reference's dgraph-{group}-{timestamp}.rdf.gz form.
"""

from __future__ import annotations

import datetime as _dt
import gzip
import os
from typing import Iterator

from dgraph_tpu_torch.models.store import PostingStore
from dgraph_tpu_torch.models.types import TypeID, TypedValue

_XSD = {
    TypeID.INT: "xs:int",
    TypeID.FLOAT: "xs:float",
    TypeID.BOOL: "xs:boolean",
    TypeID.DATETIME: "xs:dateTime",
    TypeID.DATE: "xs:date",
    TypeID.GEO: "geo:geojson",
    TypeID.PASSWORD: "pwd:password",
}


def _escape(s: str) -> str:
    return (
        s.replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
        .replace("\t", "\\t")
    )


def _literal(v: TypedValue) -> str:
    if v.tid == TypeID.GEO:
        import json as _json

        g = v.value
        body = _escape(_json.dumps(g.to_geojson() if hasattr(g, "to_geojson") else g))
    elif v.tid == TypeID.DATETIME and isinstance(v.value, _dt.datetime):
        body = v.value.isoformat()
    elif v.tid == TypeID.BOOL:
        body = "true" if v.value else "false"
    else:
        body = _escape(str(v.value))
    suffix = _XSD.get(v.tid)
    return f'"{body}"^^<{suffix}>' if suffix else f'"{body}"'


def _facet_str(facets: dict) -> str:
    if not facets:
        return ""
    parts = []
    for k in sorted(facets):
        fv = facets[k]
        val = fv.value if isinstance(fv, TypedValue) else fv
        if isinstance(val, _dt.datetime):
            val = val.isoformat()
        elif isinstance(val, bool):
            val = "true" if val else "false"
        parts.append(f"{k}={val}")
    return " (" + ", ".join(parts) + ")"


def iter_rdf_lines(store: PostingStore) -> Iterator[str]:
    """Yield one N-Quad line per posting, deterministic order."""
    for pred in sorted(store.predicates()):
        pd = store.peek(pred)
        if pd is None:
            continue
        for src in sorted(pd.edges):
            for dst in sorted(pd.edges[src]):
                f = _facet_str(pd.edge_facets.get((src, dst), {}))
                yield f"<0x{src:x}> <{pred}> <0x{dst:x}>{f} ."
        for (src, lang) in sorted(pd.values):
            v = pd.values[(src, lang)]
            lit = _literal(v)
            if lang:
                lit += f"@{lang}"
            f = _facet_str(pd.value_facets.get(src, {}))
            yield f"<0x{src:x}> <{pred}> {lit}{f} ."


def export(store: PostingStore, out_dir: str, group: int = 0) -> dict:
    """Write dgraph-{group}-{ts}.rdf.gz and .schema.gz; returns paths
    (the reference's handleExportForGroup per-group fan-out collapses to
    one local group here; multi-group callers invoke per shard)."""
    os.makedirs(out_dir, exist_ok=True)
    ts = _dt.datetime.now().strftime("%Y-%m-%d-%H-%M")
    rdf_path = os.path.join(out_dir, f"dgraph-{group}-{ts}.rdf.gz")
    schema_path = os.path.join(out_dir, f"dgraph-schema-{group}-{ts}.schema.gz")
    n = 0
    with gzip.open(rdf_path, "wt", encoding="utf-8") as f:
        for line in iter_rdf_lines(store):
            f.write(line + "\n")
            n += 1
    with gzip.open(schema_path, "wt", encoding="utf-8") as f:
        f.write(store.schema.to_text())
    return {"rdf": rdf_path, "schema": schema_path, "nquads": n}
