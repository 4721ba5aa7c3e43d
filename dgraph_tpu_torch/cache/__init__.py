"""Snapshot-versioned two-tier query cache (copy of ``dgraph_tpu.cache``).

Tier 1 (`HopCache`, cache/hop.py): hop-expansion memoization at the
DeviceExpander seam — repeat per-level expansions over an unchanged
predicate skip the gather launch entirely.

Tier 2 (`ResultCache`, cache/result.py): whole-response memoization in
front of the cohort scheduler — repeat queries skip admission, cohort
wait and execution.

Both tiers share the `VersionedLFUCache` core (cache/core.py):
predicate-version invalidation, reclaim on probe, and
byte-budgeted LFU-with-aging admission.  Gate: ``DGRAPH_TPU_CACHE``
(default on; ``0`` restores the cache-less path byte-identically).
"""

from dgraph_tpu_torch.cache.core import VersionedLFUCache, cache_enabled
from dgraph_tpu_torch.cache.hop import HopCache, frontier_digest
from dgraph_tpu_torch.cache.result import ResultCache, cacheable, request_digest

__all__ = [
    "VersionedLFUCache",
    "HopCache",
    "ResultCache",
    "cache_enabled",
    "cacheable",
    "frontier_digest",
    "request_digest",
]
