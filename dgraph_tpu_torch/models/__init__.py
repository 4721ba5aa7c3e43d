"""Data model of the port: value types, uid dictionary, schema state,
the host posting store, and the device-resident CSR arenas (torch)."""

from dgraph_tpu_torch.models.types import TypeID, TypedValue  # noqa: F401
from dgraph_tpu_torch.models.uids import UidMap  # noqa: F401
from dgraph_tpu_torch.models.schema import SchemaState, parse_schema  # noqa: F401
from dgraph_tpu_torch.models.store import PostingStore  # noqa: F401
from dgraph_tpu_torch.models.arena import ArenaManager  # noqa: F401
