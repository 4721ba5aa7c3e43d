"""Shared environment-variable parsing for tuning knobs (copy of
``dgraph_tpu/utils/env.py``).

Every subsystem with env-tunable numbers (scheduler flush timing,
peer-RPC retry/breaker knobs) parses them the same way: a float with a
default, where an unparsable value falls back to the default instead of
crashing process startup over a typo'd knob.
"""

from __future__ import annotations

import os


def env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def env_int(name: str, default: int) -> int:
    """Integer knob with the same typo-tolerant fallback (accepts float
    text like "1e6" since operators write snapshot thresholds that way)."""
    try:
        return int(float(os.environ.get(name, default)))
    except ValueError:
        return default
