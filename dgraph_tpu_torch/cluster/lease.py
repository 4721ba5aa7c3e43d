"""Leased UID allocation (copy of ``dgraph_tpu/cluster/lease.py``).

Equivalent of upstream Dgraph's worker/assign.go + worker/lease.go: a
central counter owned by the metadata group's leader hands out uid
ranges; lease extension is itself a durable proposal so a restarted
leader never re-issues uids (proposeAndWaitForLease, lease.go:106).
Extensions are batched — the counter is bumped in chunks of at least
``min_lease`` so one durable write covers many allocations
(minLeaseNum batching, lease.go:88-98).

Here the "proposal" is a callable supplied by the owner: standalone it
journals straight into the store's WAL (LEASE records); under
replication the Raft node wires it to ProposeAndWait.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional, Tuple


class LeaseManager:
    """Monotonic uid-range allocator with durable batched leases."""

    def __init__(
        self,
        propose_lease: Callable[[int], None],
        start: int = 1,
        min_lease: int = 10_000,
    ):
        """``propose_lease(new_max)`` must durably record that uids up to
        ``new_max`` (exclusive) may be handed out before it returns."""
        self._propose = propose_lease
        self._lock = threading.Lock()
        self._next = start      # next uid to hand out
        self._leased = start    # uids below this are durably leased
        self.min_lease = min_lease

    @property
    def max_assigned(self) -> int:
        return self._next - 1

    def init_from_recovery(self, next_uid: int, leased_through: Optional[int] = None):
        """After WAL replay: resume above everything ever leased."""
        with self._lock:
            self._leased = max(self._leased, leased_through or next_uid)
            # never reuse any uid that may have been handed out under the
            # old lease, even if unused — monotonicity is the contract
            self._next = self._leased

    def reserve_through(self, uid: int) -> None:
        """Mark an explicitly-named uid as taken: the allocator must never
        hand it out as a fresh uid.  Extends the durable lease (batched)
        when the uid lies beyond the leased window; always advances the
        allocation cursor past it."""
        with self._lock:
            if uid >= self._leased:
                new_max = max(uid + 1, self._leased + self.min_lease)
                self._propose(new_max)
                self._leased = new_max
            self._next = max(self._next, uid + 1)

    def assign(self, n: int) -> Tuple[int, int]:
        """Allocate n consecutive uids; returns [start, end] inclusive
        (AssignUids semantics, worker/assign.go:37)."""
        if n <= 0:
            raise ValueError("must request at least one uid")
        with self._lock:
            start = self._next
            end = start + n - 1
            if end >= self._leased:
                new_max = max(end + 1, self._leased + self.min_lease)
                self._propose(new_max)  # durable before handing out
                self._leased = new_max
            self._next = end + 1
            return start, end
