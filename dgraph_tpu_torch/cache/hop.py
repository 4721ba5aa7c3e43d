"""Tier 1: hop-expansion memoization at the DeviceExpander seam (copy of
``dgraph_tpu/cache/hop.py`` without the in-place delta repair).

The engine's per-level expansion — ``(arena, predicate, direction,
frontier) → (out_flat, seg_ptr)`` — is deterministic over an immutable
arena snapshot (the property the cohort HopMerger relies on to deal
union expansions back byte-identically, sched/cohort.py).  That makes
it memoizable: key the call by ``(arena identity, predicate, direction,
arena epoch, frontier digest)`` under the predicate's version and a
repeat hop under an unchanged PREDICATE returns the SAME arrays with no
device work: no gather launch, no host<->device copy.

The version is the PREDICATE's last-mutation version
(ivm/versions.py::hop_version — the global ``store.version`` under
``DGRAPH_TPU_IVM=0``), so writes to other predicates never touch this
tier's entries.  A write to the entry's own predicate makes it stale;
the reference's in-place repair of such entries is not ported yet, so
``ArenaManager`` drops every entry of an arena a delta patched
(``drop_stale_epoch``) and of an arena it evicts or rebuilds
(``drop_arena``), so an id()-keyed entry never outlives its arena.

Entries hold host numpy arrays — the one fetch every device route
already makes — never device tensors: a hit pays no device interaction
at all.  They hold exactly the arrays the expansion returned; the
engine treats (out_flat, seg_ptr) as immutable (every downstream
transform allocates fresh arrays), so sharing one entry between
requests is safe, as HopMerger's dealt segments and the scheduler's
singleflight results are.

Knobs: ``DGRAPH_TPU_CACHE`` (shared gate), ``DGRAPH_TPU_CACHE_HOP_BYTES``
(budget, default 64 MiB, 0 disables this tier only).
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

import numpy as np

from dgraph_tpu_torch.cache.core import VersionedLFUCache, env_bytes
from dgraph_tpu_torch.utils.metrics import (
    QCACHE_HIT_AGE,
    QCACHE_HOP_BYTES,
    QCACHE_HOP_EVENTS,
)

_DEFAULT_BUDGET = 64 << 20


def frontier_digest(src: np.ndarray) -> bytes:
    """Order-sensitive digest of a frontier uid array (expansion output
    depends on row order, so permutations must NOT collide)."""
    a = np.ascontiguousarray(src, dtype=np.int64)
    h = hashlib.blake2b(a.tobytes(), digest_size=16)
    return h.digest()


class HopCache:
    """One per ArenaManager (per store): expansions are arena-snapshot
    state, exactly like the arenas themselves."""

    def __init__(self, budget_bytes: Optional[int] = None):
        self._c = VersionedLFUCache(
            budget_bytes=(
                budget_bytes
                if budget_bytes is not None
                else env_bytes("DGRAPH_TPU_CACHE_HOP_BYTES", _DEFAULT_BUDGET)
            ),
            stats_hook=self._on_event,
        )

    def _on_event(self, event: str, entry) -> None:
        QCACHE_HOP_EVENTS.add(event)
        QCACHE_HOP_BYTES.set(self._c.occupancy_bytes)

    # -- introspection (tests / bench) -------------------------------------

    @property
    def occupancy_bytes(self) -> int:
        return self._c.occupancy_bytes

    @property
    def max_entry_bytes(self) -> int:
        """Per-entry admission cap — the expander pre-screens on the
        ESTIMATED result size so a hopeless megaquery never even pays
        for the frontier digest."""
        return self._c.max_entry_bytes

    def __len__(self) -> int:
        return len(self._c)

    # -- the seam -----------------------------------------------------------

    def key_for(self, arena, attr: str, reverse: bool, src: np.ndarray):
        """The entry key, computed once per expansion (the digest is the
        expensive part, and a miss needs the SAME key for its fill).
        The arena EPOCH (bumped once per applied delta) rides at index
        3: an entry filled before a delta can never match a probe after
        it through key equality alone."""
        return (
            id(arena), attr, bool(reverse),
            getattr(arena, "epoch", 0), frontier_digest(src),
        )

    def get(
        self, arena, attr: str, reverse: bool, src: np.ndarray, version: int,
        key=None,
    ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        if key is None:
            key = self.key_for(arena, attr, reverse, src)
        hit = self._c.get(key, version)
        if hit is None:
            return None
        value, age = hit
        QCACHE_HIT_AGE.observe(age)
        return value[0], value[1]

    def put(
        self,
        arena,
        attr: str,
        reverse: bool,
        src: np.ndarray,
        version: int,
        out: np.ndarray,
        seg_ptr: np.ndarray,
        key=None,
    ) -> None:
        if key is None:
            key = self.key_for(arena, attr, reverse, src)
        # the reference keeps the frontier beside the expansion for its
        # delta repair; its bytes are charged here too, so both tiers
        # admit and evict the same entries
        frontier = np.ascontiguousarray(src, dtype=np.int64)
        nbytes = (
            int(out.nbytes) + int(seg_ptr.nbytes) + int(frontier.nbytes) + 64
        )
        self._c.put(key, version, (out, seg_ptr), nbytes)
        # admissions and sweeps change occupancy without a get-event
        QCACHE_HOP_BYTES.set(self._c.occupancy_bytes)

    # -- invalidation --------------------------------------------------------

    def drop_stale_epoch(self, arena_id: int, epoch: int) -> int:
        """Drop every entry for ``arena_id`` NOT keyed at ``epoch`` —
        the post-delta sweep (``ArenaManager._try_apply_delta``): such
        an entry describes a snapshot that no longer exists, and must
        not squat in the budget waiting for its generation sweep."""
        n = self._c.drop_where(
            lambda k: k[0] == arena_id and k[3] != epoch
        )
        QCACHE_HOP_BYTES.set(self._c.occupancy_bytes)
        return n

    def drop_arena(self, arena_id: int) -> int:
        """Explicit drop when the ArenaManager evicts (or rebuilds) an
        arena: its ``id()`` may be recycled by a LATER allocation, and
        id-keyed entries must never outlive the object they describe."""
        n = self._c.drop_where(lambda k: k[0] == arena_id)
        QCACHE_HOP_BYTES.set(self._c.occupancy_bytes)
        return n

    def clear(self) -> None:
        self._c.clear()
        QCACHE_HOP_BYTES.set(0)
