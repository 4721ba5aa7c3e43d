"""The port's query engine: AST -> SubGraph tree, level-batched
execution over the device arenas, and JSON encoding."""

from dgraph_tpu_torch.query.engine import QueryEngine  # noqa: F401
from dgraph_tpu_torch.query.subgraph import SubGraph, Params  # noqa: F401
