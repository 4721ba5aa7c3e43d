"""Uid dictionary: external ids ↔ dense internal int32 uids.

The reference leases sparse uint64 uids from a Raft-replicated counter
(worker/assign.go, worker/lease.go).  The device tier works on int32 and
sparse ids waste gather bandwidth, so we instead assign *dense* int32 uids
at ingest: uid N is row N of every dense per-predicate value table.  The
external representation (client-visible `_uid_`, RDF `<0x...>` subjects)
remains hex of the internal id; string xids (`<name>`, `_:blank`) resolve
through this dictionary exactly like the reference's client-side allocator
(client/mutations.go:125).
"""

from __future__ import annotations

from typing import Dict, List, Optional

# Hard ceiling of the dense id space: uids are int32 row indexes into
# device arenas (ops/sets.py uses int32 throughout; SENT = 2^31-1 is
# reserved as the padding sentinel).  Beyond it the design requires
# sharding the uid space across groups — see docs/design.md "uid-space
# ceiling".  We fail LOUDLY well before silent int32 wraparound.
UID_CEILING = (1 << 31) - 2  # last assignable uid (SENT is reserved)
# start warning when within 1/64 of the ceiling (~33M uids of headroom)
_WARN_MARGIN = UID_CEILING >> 6


class UidSpaceExhausted(RuntimeError):
    """The dense int32 uid space is exhausted for this group.

    Remedies: split predicates across more groups (each group owns its
    own dense space), or re-shard the uid range (docs/design.md)."""


class UidMap:
    """Monotonic allocator: xid string → dense uid, starting at 1."""

    def __init__(self):
        self._xid_to_uid: Dict[str, int] = {}
        self._next = 1
        self._warned = False

    def __len__(self) -> int:
        return self._next - 1

    @property
    def max_uid(self) -> int:
        return self._next - 1

    def _check_ceiling(self, top: int) -> None:
        if top > UID_CEILING:
            raise UidSpaceExhausted(
                f"dense uid space exhausted: next uid {top} exceeds the "
                f"int32 ceiling {UID_CEILING}; shard the uid space across "
                "groups (docs/design.md: uid-space ceiling)"
            )
        if not self._warned and top > UID_CEILING - _WARN_MARGIN:
            self._warned = True
            import logging

            logging.getLogger("dgraph_tpu_torch.uids").warning(
                "uid space at %d of %d (%.1f%%): approaching the int32 "
                "ceiling — plan a group split (docs/design.md)",
                top, UID_CEILING, 100.0 * top / UID_CEILING,
            )

    def assign(self, xid: str) -> int:
        """Get or allocate the uid for an external id."""
        uid = self._xid_to_uid.get(xid)
        if uid is None:
            self._check_ceiling(self._next)
            uid = self._next
            self._next += 1
            self._xid_to_uid[xid] = uid
        return uid

    def lookup(self, xid: str) -> Optional[int]:
        return self._xid_to_uid.get(xid)

    def fresh(self, n: int = 1) -> List[int]:
        """Allocate n anonymous uids (blank nodes without reuse)."""
        self._check_ceiling(self._next + n - 1)
        out = list(range(self._next, self._next + n))
        self._next += n
        return out

    def reserve_through(self, uid: int) -> None:
        """Ensure explicit numeric uids (RDF `<0x5>`) stay allocatable."""
        if uid >= self._next:
            self._check_ceiling(uid)
            self._next = uid + 1

    def snapshot(self) -> Dict[str, int]:
        return dict(self._xid_to_uid)

    def restore(self, xids: Dict[str, int], next_uid: int) -> None:
        """Adopt a carried-over allocator state: the xid -> uid map and
        the next uid to hand out (models/carry.py)."""
        self._check_ceiling(next_uid - 1)
        self._xid_to_uid = dict(xids)
        self._next = int(next_uid)
