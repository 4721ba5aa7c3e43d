"""Server options: flags and an optional YAML config file (the port's
copy of ``dgraph_tpu/utils/config.py``; the reference's is
dgraph/config.go:82-104 + x.LoadConfigFromYAML, cmd/dgraph/main.go:
164-168).  Precedence: the defaults, then the YAML file, then explicit
flags (``cli/server.build_options``).

The YAML is the flat ``key: value`` subset the reference's config files
use, parsed by hand: ``#`` starts a comment, values may be quoted, keys
may use ``-`` for ``_``, and unknown keys are ignored."""

from __future__ import annotations

from dataclasses import dataclass, fields, replace


@dataclass
class Options:
    # storage
    postings_dir: str = "p"
    wal_dir: str = "w"
    export_path: str = "export"
    sync_writes: bool = False
    # background snapshotter thresholds (models/durability.py): 0 keeps
    # DGRAPH_TPU_SNAPSHOT_WAL_MB (64) / DGRAPH_TPU_SNAPSHOT_WAL_RECORDS
    # (200000); explicit flags win over the environment
    snapshot_wal_mb: float = 0.0
    snapshot_wal_records: int = 0
    # serving
    port: int = 8080
    # gRPC listener: 0 = the HTTP port + 1000, below 0 off
    grpc_port: int = 0
    bind: str = "127.0.0.1"
    tls_cert: str = ""
    tls_key: str = ""
    # cluster identity (--idx/--groups/--peer)
    raft_id: int = 1
    group_ids: str = "0"
    peer: str = ""
    peer_groups: str = ""
    my_addr: str = ""
    join: str = ""
    workers: int = 4
    cluster_secret: str = ""
    peer_ca: str = ""
    peer_tls_insecure: bool = False
    raft_transport: str = "http"
    # observability
    trace_ratio: float = 0.0
    expose_trace: bool = False
    # profiles written at shutdown: cProfile over query execution
    # (pstats format) and tracemalloc's top 50 lines; empty = off
    cpu_profile: str = ""
    mem_profile: str = ""
    # engine
    num_pending: int = 1000
    max_edges: int = 1_000_000
    # device memory budget for cached arenas in MB (0 = the port's
    # default: 3/4 of free memory on cuda)
    memory_mb: int = 0
    # directory of each query's execution-shape dump; empty = off
    dumpsg: str = ""
    # the torch device the engine runs on ("" = cuda); the port's own
    device: str = ""

    def merged_with_yaml(self, path: str) -> "Options":
        """Overlay the keys of a flat ``key: value`` YAML file onto self.
        Merge BEFORE applying flags for flags-beat-YAML precedence."""
        vals = _load_simple_yaml(path)
        known = {f.name for f in fields(self)}
        updates = {}
        for k, v in vals.items():
            k = k.replace("-", "_")
            if k in known:
                updates[k] = _coerce(v, type(getattr(self, k)))
        return replace(self, **updates)


def _coerce(v: str, t):
    if t is bool:
        return str(v).strip().lower() in ("1", "true", "yes", "on")
    if t is int:
        return int(v)
    if t is float:
        return float(v)
    return str(v)


def _load_simple_yaml(path: str) -> dict:
    """The flat ``key: value`` YAML subset (the reference's config files
    are flat, cmd/dgraph/testrun/conf1.yaml)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or ":" not in line:
                continue
            k, v = line.split(":", 1)
            out[k.strip()] = v.strip().strip("'\"")
    return out
