"""Tier 1: hop-expansion memoization at the DeviceExpander seam (copy of
``dgraph_tpu/cache/hop.py``).

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
tier's entries.  A small delta to the entry's own predicate REPAIRS it
in place (``repair_pred``, driven by ``ArenaManager._try_apply_delta``
under the repair-vs-rebuild gate) — the entry carries its frontier for
exactly this purpose; an entry the repair cannot carry to the arena's
new epoch is dropped (``drop_stale_epoch``), as is every entry of an
arena the manager evicts or rebuilds (``drop_arena``), so an id()-keyed
entry never outlives its arena.

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

from dgraph_tpu_torch import obs
from dgraph_tpu_torch.cache.core import VersionedLFUCache, env_bytes
from dgraph_tpu_torch.obs import ledger
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
        sp = obs.current_span()
        if sp is None:  # unsampled hot path: probe only
            hit, ev, nb = self._c.get_ev(key, version)
        else:
            # sampled: the probe records its outcome (hit/miss/stale) and
            # the stored payload size, so a trace shows WHICH hops the
            # cache absorbed and how many bytes each hit saved
            with sp.child("cache.hop") as cs:
                hit, ev, nb = self._c.get_ev(key, version)
                cs.set_attr("pred", attr)
                cs.set_attr("outcome", ev)
                if hit is not None:
                    cs.set_attr("bytes", nb)
        led = ledger.current()
        if led is not None:
            led.note_cache("hop", ev, nb or 0)
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
        # the FRONTIER rides in the entry beside the expansion: delta
        # repair (repair_pred below) must know which rows an edge delta
        # touches, and the digest in the key is one-way.  Its bytes are
        # charged to the budget like the payload's.
        frontier = np.ascontiguousarray(src, dtype=np.int64)
        nbytes = (
            int(out.nbytes) + int(seg_ptr.nbytes) + int(frontier.nbytes) + 64
        )
        self._c.put(key, version, (out, seg_ptr, frontier), nbytes)
        # admissions and evictions change occupancy without a get-event
        QCACHE_HOP_BYTES.set(self._c.occupancy_bytes)

    # -- delta repair (ivm/repair.py) -----------------------------------------

    def repair_pred(
        self,
        arena_id: int,
        attr: str,
        reverse: bool,
        adds: np.ndarray,
        dels: np.ndarray,
        old_version: int,
        new_version: int,
        old_epoch: int = 0,
        new_epoch: int = 0,
    ):
        """Apply a predicate's edge deltas to every cached entry for
        ``(arena_id, attr, reverse)`` recorded at ``old_version``,
        re-keying survivors to ``new_version`` — entries the delta
        cannot repair (or that sit at any other version) drop.  Called
        from ``ArenaManager._try_apply_delta`` after the arena's own
        host mirrors were updated, under the repair cost gate
        (query/planner.py).  Returns (repaired, dropped).

        ``old_epoch → new_epoch``: the delta that drives this repair
        also bumped the arena's epoch (a key element), so entries at the
        pre-delta epoch are MOVED to the post-delta key first — otherwise
        the value repair would strand them at a key no probe can ever
        form again.  The defaults (0, 0) move nothing."""
        from dgraph_tpu_torch.ivm.repair import repair_hop_entry

        def match(k):
            return k[0] == arena_id and k[1] == attr and k[2] == bool(reverse)

        if new_epoch != old_epoch:
            self._c.rekey_where(
                lambda k: match(k) and k[3] == old_epoch,
                lambda k: k[:3] + (new_epoch,) + k[4:],
            )

        def fix(value):
            out, seg_ptr, frontier = value
            fixed = repair_hop_entry(out, seg_ptr, frontier, adds, dels)
            if fixed is None:
                return None
            out2, seg2 = fixed
            nbytes = (
                int(out2.nbytes) + int(seg2.nbytes)
                + int(frontier.nbytes) + 64
            )
            return (out2, seg2, frontier), nbytes

        res = self._c.repair_where(
            match,
            old_version,
            new_version,
            fix,
        )
        QCACHE_HOP_BYTES.set(self._c.occupancy_bytes)
        return res

    # -- invalidation --------------------------------------------------------

    def drop_stale_epoch(self, arena_id: int, epoch: int) -> int:
        """Drop every entry for ``arena_id`` NOT keyed at ``epoch`` —
        the post-delta sweep (``ArenaManager._try_apply_delta``): any
        entry the repair pass did not carry forward describes a snapshot
        that no longer exists, and must not squat in the budget until
        LFU eviction reaches it."""
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
