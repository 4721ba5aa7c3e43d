"""Peaks of the card and the bytes each hand kernel must move.

``HBM_BYTES_PER_S``: one NVIDIA H100 SXM's device memory rate, 3.35 TB/s
(NVIDIA's data sheet, at the card's full 700 W power limit; the run
prints the card's limit beside its numbers).  Frozen copy of
``chip_smoke.py``'s constant.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def slotmap_bytes(q: int, pcap: int, capc: int) -> int:
    """Least traffic of one slot-map launch over int32[q, pcap] inputs
    ``cs`` and ``cd`` and an int32[q, capc] map: each input read once and
    the map written once.  Frozen copy of the count in ``chip_smoke.py``
    (``slotmap_timing``: ``4 * q * (2 * pcap + capc)``)."""
    return 4 * q * (2 * pcap + capc)
