"""Shared helpers of the port's parity tests (tests/test_torch_*.py):
hand the JAX engine's state to the port, and compare the two engines.

``snapshot_of`` is the one place that reads a ``dgraph_tpu`` store: it
renders it as the plain data ``dgraph_tpu_torch.models.carry`` accepts,
so the port itself never shares a class with the reference."""

from __future__ import annotations

import ast
import json
from pathlib import Path

import numpy as np

from dgraph_tpu.models.types import TypeID

HERE = Path(__file__).resolve().parent

# the reference engine's knobs for a parity run, set before its
# constructors read them: the resident Pallas tier on any backend
# (interpret mode on the CPU), no hop/result caches that would answer a
# hop without the kernel, no device guard that could fail a hop over to
# the host quietly, no cohort scheduler or QoS in the serving path
REFERENCE_ENV = {
    "DGRAPH_TPU_RESIDENT": "force",
    "DGRAPH_TPU_CACHE": "0",
    "DGRAPH_TPU_DEVGUARD": "0",
    "DGRAPH_TPU_SCHED": "0",
    "DGRAPH_TPU_QOS": "0",
    "DGRAPH_TPU_MESH": "0",
}


def _plain(tv):
    v = tv.value
    if tv.tid == TypeID.GEO:
        v = (v.kind, v.coords)
    return (int(tv.tid), v)


def snapshot_of(st) -> dict:
    """A ``dgraph_tpu`` PostingStore as a carry snapshot (plain data)."""
    schema = []
    for name in st.schema.predicates():
        s = st.schema.peek(name)
        schema.append({
            "name": s.name, "type": int(s.tid),
            "tokenizers": list(s.tokenizers),
            "reverse": bool(s.reverse), "count": bool(s.count),
        })
    preds = {}
    for name in st.predicates():
        pd = st.peek(name)
        src = [s for s, ds in pd.edges.items() for _ in ds]
        dst = [d for ds in pd.edges.values() for d in ds]
        preds[name] = {
            "edges": (np.array(src, np.int64), np.array(dst, np.int64)),
            "values": [(u, l, _plain(v)) for (u, l), v in pd.values.items()],
            "edge_facets": [
                (s, d, [(k, _plain(v)) for k, v in f.items()])
                for (s, d), f in pd.edge_facets.items()
            ],
            "value_facets": [
                (u, [(k, _plain(v)) for k, v in f.items()])
                for u, f in pd.value_facets.items()
            ],
        }
    return {
        "schema": schema,
        "uids": {"xids": st.uids.snapshot(), "next": st.uids.max_uid + 1},
        "preds": preds,
    }


def port_store_of(st):
    from dgraph_tpu_torch.models.carry import store_from_snapshot

    return store_from_snapshot(snapshot_of(st))


def body(resp: dict) -> str:
    """A response's JSON with its timing map stripped: the bytes the two
    engines must agree on."""
    resp = dict(resp)
    resp.pop("server_latency", None)
    return json.dumps(resp)


def golden_queries(fname: str):
    """(id, text, variables) of every literal query a golden test sends
    through the shared ``eng`` fixture (``q(eng, ...)`` / ``eng.run``),
    plus the literal PARSER_ERRORS list.  Read from the source, so the
    parity suite follows the goldens as they grow."""
    tree = ast.parse((HERE / fname).read_text())
    out = []
    stem = fname[len("test_"):-len(".py")]
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "PARSER_ERRORS"
            for t in node.targets
        ):
            for i, text in enumerate(ast.literal_eval(node.value)):
                out.append((f"{stem}::PARSER_ERRORS[{i}]", text, None))
        if not isinstance(node, ast.FunctionDef) or not node.name.startswith("test_"):
            continue
        if "eng" not in [a.arg for a in node.args.args]:
            continue  # builds its own engine
        k = 0
        calls = sorted(
            (c for c in ast.walk(node) if isinstance(c, ast.Call)),
            key=lambda c: (c.lineno, c.col_offset),
        )
        for c in calls:
            f = c.func
            if isinstance(f, ast.Name) and f.id == "q":
                args = c.args[1:]
            elif (isinstance(f, ast.Attribute) and f.attr == "run"
                  and isinstance(f.value, ast.Name) and f.value.id == "eng"):
                args = c.args
            else:
                continue
            try:
                vals = [ast.literal_eval(a) for a in args]
            except ValueError:
                continue  # built at run time
            if not vals or not isinstance(vals[0], str):
                continue
            out.append((f"{stem}::{node.name}#{k}", vals[0],
                        vals[1] if len(vals) > 1 else None))
            k += 1
    return out
