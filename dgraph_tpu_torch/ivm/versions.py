"""Predicate-scoped cache versions — the footprint-freshness primitive
(copy of ``dgraph_tpu/ivm/versions.py``).

Both cache tiers (cache/core.py) admit and probe entries under a caller
-supplied integer version: an entry recorded under any OLDER version
can never match.  Before IVM that integer was the store's global
``version`` — correct, but maximally pessimistic: one write anywhere
killed every entry.  These helpers substitute the tightest correct
version for a given read:

    version_for(store, preds) = max(pred_floor,
                                    max(pred_versions[p] for p in preds))

where ``pred_versions[p]`` is the version of the last mutation that
touched predicate ``p`` and ``pred_floor`` is the last NON-scopeable
mutation (schema changes, full-store replacement) — reads that touch
none of a mutation's predicates keep their cached version, so their
entries stay hits.

Correctness argument (the same stale-keyed-never-stale-served shape the
tiers already rely on): a response/expansion is a pure function of the
predicates it reads.  If no predicate in the footprint mutated between
fill and probe, the footprint version is unchanged and the cached value
is byte-identical to a re-execution; if any did, its pred version (and
hence the max) advanced past the entry's, and the entry can never be
served again.  Footprints err on the side of INCLUSION
(gql.ast.referenced_preds) and fall back to the global version when the
predicate set is not statically knowable (``expand()``/``_predicate_``)
or the store predates per-pred tracking.

Gate: ``DGRAPH_TPU_IVM`` (default on).  ``0`` restores the bare global
version for every helper — byte-identical keying to the pre-IVM tree.
"""

from __future__ import annotations

import os
from typing import Optional


def ivm_enabled() -> bool:
    """The DGRAPH_TPU_IVM gate (default ON; ``0`` restores global
    ``store.version`` cache keying byte-identically)."""
    return os.environ.get("DGRAPH_TPU_IVM", "1") != "0"


def version_for(store, preds) -> Optional[int]:
    """The cache version scoped to ``preds`` (an iterable of predicate
    names), or the store's global version when ``preds`` is None, the
    store has no per-predicate tracking, or IVM is off.  None when the
    store has no version at all (version-less duck stores never
    cache)."""
    ver = getattr(store, "version", None)
    if ver is None:
        return None
    if not ivm_enabled() or preds is None:
        return ver
    pv = getattr(store, "pred_versions", None)
    if pv is None:
        return ver
    floor = getattr(store, "pred_floor", 0)
    return max(floor, max((pv.get(p, 0) for p in preds), default=0))


def hop_version(store, pred: str) -> Optional[int]:
    """Tier-1 (hop cache) version for one predicate's expansion: the
    reverse direction reads the same predicate's data, so direction
    never enters the version."""
    return version_for(store, (pred,))


def _footprint(parsed):
    """The referenced-predicate footprint of a parsed request, memoized
    on the parsed object (the cached-hit fast path probes per request;
    the AST walk should run once, not once per probe)."""
    fp = getattr(parsed, "_ivm_footprint", False)
    if fp is False:
        from dgraph_tpu_torch.gql.ast import referenced_preds

        fp = referenced_preds(parsed.queries)
        try:
            parsed._ivm_footprint = fp
        except AttributeError:  # slotted/frozen parse results: recompute
            pass
    return fp


def result_version(store, parsed) -> Optional[int]:
    """Tier-2 (result cache) version for a parsed read request: scoped
    to its statically-known predicate footprint, global when that is
    unknowable (expand()/_predicate_ read schema-driven predicate
    lists).  A schema-only request has an EMPTY footprint and keys on
    the floor — apply_schema bumps the floor, so schema responses stay
    exactly as fresh as before."""
    return version_for(store, _footprint(parsed))
