"""Client SDK of the port: batching mutations, query over HTTP (JSON or
binary protobuf) or gRPC, unmarshal, checkpointing (the reference's
``dgraph_tpu/client``).

Equivalent of the reference's client/ package: `NewDgraphClient`-style
batching client (client/mutations.go:206) with pipelined request workers
(makeRequests:364), typed edge builders (client/client.go:266+), reflTag
unmarshal (client/unmarshal.go:253), and per-source-file checkpoint
watermarks for resumable bulk loads (client/checkpoint.go:29-95).
"""

from dgraph_tpu_torch.client.client import (
    BatchMutationOptions,
    DgraphClient,
    Edge as ClientEdge,
    EmbeddedTransport,
    GrpcTransport,
    HttpTransport,
)
from dgraph_tpu_torch.client.checkpoint import SyncMarks
from dgraph_tpu_torch.client.unmarshal import unmarshal, unmarshal_list

__all__ = [
    "BatchMutationOptions",
    "DgraphClient",
    "ClientEdge",
    "EmbeddedTransport",
    "GrpcTransport",
    "HttpTransport",
    "SyncMarks",
    "unmarshal",
    "unmarshal_list",
]
