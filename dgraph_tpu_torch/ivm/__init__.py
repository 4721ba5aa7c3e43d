"""Incremental view maintenance (the subset of ``dgraph_tpu.ivm`` the
port has): predicate-scoped cache versions (``versions.py``) and the
in-place delta repair of cached hop expansions (``repair.py``), which
``models/arena.py`` drives together with the tile repair of
``ops/spgemm.py``.  The delta stream and live-query subscriptions
(``deltas.py``, ``subs.py``) are not ported yet."""

from dgraph_tpu_torch.ivm.versions import (  # noqa: F401
    hop_version,
    ivm_enabled,
    result_version,
    version_for,
)
