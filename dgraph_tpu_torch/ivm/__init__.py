"""Incremental view maintenance (the subset of ``dgraph_tpu.ivm`` the
port has): predicate-scoped cache versions (``versions.py``), the
in-place delta repair of cached hop expansions (``repair.py``), which
``models/arena.py`` drives together with the tile repair of
``ops/spgemm.py``, the mutation delta stream (``deltas.py``) and the
live-query subscriptions it wakes (``subs.py``, served at ``POST
/subscribe`` and as the gRPC ``/protos.Dgraph/Subscribe`` stream)."""

from dgraph_tpu_torch.ivm.deltas import DeltaStream, attach_stream  # noqa: F401
from dgraph_tpu_torch.ivm.versions import (  # noqa: F401
    hop_version,
    ivm_enabled,
    result_version,
    version_for,
)
