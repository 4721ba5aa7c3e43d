"""Tier 2: whole-response memoization in front of the cohort scheduler
(copy of ``dgraph_tpu/cache/result.py``).

The scheduler's singleflight (sched/scheduler.py) already collapses
identical requests that overlap in time; this tier extends the reuse
window from "while a twin is in flight" to "until the next mutation":
``(request key, store version) → (response dict, engine stats)``.  A
hit skips parsing's downstream entirely — no admission, no cohort
wait, no engine shell, no read-lock acquisition — which under zipf
traffic converts the head of the popularity curve into dict probes.

The request key is the serving layer's singleflight key — query text +
canonical (sorted-JSON) variables + debug flag — digested so the cache
holds no unbounded query texts.  Sharing the cached response dict is
safe by the same argument the scheduler's singleflight documents:
handlers only encode results, never mutate them.  Responses that
depend on wall-clock (``math(since(...))``) are detected at parse
shape and never cached.

Invalidation is the shared snapshot-version scheme (cache/core.py),
scoped to predicates (ivm/versions.py): the scheduler keys each entry on
the max last-mutation version over the request's referenced-predicate
footprint (ivm/versions.py::result_version; the global
``store.version`` when the footprint is unknowable or under
``DGRAPH_TPU_IVM=0``), so a mutation only kills the responses that
actually read its predicates; stale entries die logically at the
version advance and are reclaimed by the probe that finds them (or
leave through LFU eviction).

Knobs: ``DGRAPH_TPU_CACHE`` (shared gate),
``DGRAPH_TPU_CACHE_RESULT_BYTES`` (budget, default 32 MiB, 0 disables
this tier only).
"""

from __future__ import annotations

import hashlib
from typing import Optional, Tuple

from dgraph_tpu_torch import obs
from dgraph_tpu_torch.cache.core import VersionedLFUCache, env_bytes
from dgraph_tpu_torch.obs import ledger
from dgraph_tpu_torch.utils.metrics import (
    QCACHE_HIT_AGE,
    QCACHE_RESULT_BYTES,
    QCACHE_RESULT_EVENTS,
)

_DEFAULT_BUDGET = 32 << 20


def request_digest(key) -> bytes:
    """Normalized request digest: the serving layer's (text, canonical
    vars, debug) singleflight key, hashed so cache keys are fixed-size."""
    h = hashlib.blake2b(digest_size=16)
    for part in key:
        h.update(repr(part).encode("utf-8", "surrogatepass"))
        h.update(b"\x00")
    return h.digest()


def cacheable(parsed) -> bool:
    """A parsed request whose response is a pure function of (query,
    store snapshot): read-only and free of wall-clock math.  Mutations
    never reach the scheduler path, but the guard is cheap and keeps
    this module's contract self-contained."""
    if parsed.mutation is not None:
        return False

    def clock_free(mt) -> bool:
        if mt is None:
            return True
        if getattr(mt, "fn", None) == "since":
            return False
        return all(clock_free(c) for c in getattr(mt, "children", ()))

    def walk(q) -> bool:
        if not clock_free(getattr(q, "math_exp", None)):
            return False
        return all(walk(c) for c in q.children)

    return all(walk(q) for q in parsed.queries)


def _approx_bytes(obj) -> int:
    """Rough recursive footprint of a response dict — budget accounting,
    not accounting-grade (strings dominate real responses)."""
    if isinstance(obj, dict):
        return 64 + sum(
            _approx_bytes(k) + _approx_bytes(v) for k, v in obj.items()
        )
    if isinstance(obj, (list, tuple)):
        return 56 + sum(_approx_bytes(v) for v in obj)
    if isinstance(obj, str):
        return 49 + len(obj)
    if isinstance(obj, (bytes, bytearray)):
        return 33 + len(obj)
    return 28


class ResultCache:
    """One per server: responses are store-snapshot state."""

    def __init__(self, budget_bytes: Optional[int] = None):
        self._c = VersionedLFUCache(
            budget_bytes=(
                budget_bytes
                if budget_bytes is not None
                else env_bytes(
                    "DGRAPH_TPU_CACHE_RESULT_BYTES", _DEFAULT_BUDGET
                )
            ),
            stats_hook=self._on_event,
        )

    def _on_event(self, event: str, entry) -> None:
        QCACHE_RESULT_EVENTS.add(event)
        QCACHE_RESULT_BYTES.set(self._c.occupancy_bytes)

    @property
    def occupancy_bytes(self) -> int:
        return self._c.occupancy_bytes

    def __len__(self) -> int:
        return len(self._c)

    def hits(self) -> int:
        return QCACHE_RESULT_EVENTS.snapshot().get("hit", 0)

    def get(self, key, version: int) -> Optional[Tuple[dict, dict]]:
        """(response, stats) for the request ``key`` at ``version``, or
        None.  The returned response is SHARED — read-only downstream."""
        sp = obs.current_span()
        if sp is None:  # unsampled hot path: probe only
            hit, ev, nb = self._c.get_ev(request_digest(key), version)
        else:
            # sampled: a tier-2 hit is the most latency-deciding event a
            # request can have — the span says so (outcome + the STORED
            # size: re-walking the response would add O(response) work
            # to the fastest path there is)
            with sp.child("cache.result") as cs:
                hit, ev, nb = self._c.get_ev(request_digest(key), version)
                cs.set_attr("outcome", ev)
                if hit is not None:
                    cs.set_attr("bytes", nb)
        led = ledger.current()
        if led is not None:
            # a tier-2 hit is the whole request's account: no engine
            # numbers ever merge in
            led.note_cache("result", ev, nb or 0)
        if hit is None:
            return None
        value, age = hit
        QCACHE_HIT_AGE.observe(age)
        return value

    def put(self, key, version: int, response: dict, stats: dict) -> None:
        k = request_digest(key)
        # singleflight deals one result to K coalesced twins and each
        # calls put on return — one stored it already, so the other K-1
        # skip the footprint walk (benign race: a double put is a no-op
        # re-store of the same value)
        if self._c.contains(k, version):
            return
        self._c.put(
            k,
            version,
            (response, stats),
            _approx_bytes(response) + _approx_bytes(stats),
        )
        # admissions and evictions change occupancy without a get-event
        QCACHE_RESULT_BYTES.set(self._c.occupancy_bytes)

    def clear(self) -> None:
        self._c.clear()
        QCACHE_RESULT_BYTES.set(0)
