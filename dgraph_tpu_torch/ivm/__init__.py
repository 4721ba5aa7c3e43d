"""Incremental view maintenance (the subset of ``dgraph_tpu.ivm`` the
port has): predicate-scoped cache versions (``versions.py``).  The delta
stream, live-query subscriptions and in-place repair of hop-cache
entries are not ported yet."""

from dgraph_tpu_torch.ivm.versions import (  # noqa: F401
    hop_version,
    ivm_enabled,
    result_version,
    version_for,
)
