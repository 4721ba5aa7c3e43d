"""Predicate → group sharding configuration (copy of
``dgraph_tpu/cluster/groups.py``: ``fingerprint64`` and ``belongs_to``
are bit-identical to the reference's, since placement depends on them
and a mixed cluster must agree on it).

Equivalent of upstream Dgraph's group/conf.go: a config of rules
``gid: pred, prefix*`` with a ``default: fp % N + k`` fallback
(ParseConfig group/conf.go:105, fpGroup:182, BelongsTo:190).  Groups are
the unit of placement: a group is a Raft cluster of the servers that
place it.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


def fingerprint64(s: str) -> int:
    """Stable 64-bit FNV-1a over utf-8 (stand-in for farm.Fingerprint64;
    only stability across hosts matters, not the exact hash family)."""
    h = 0xCBF29CE484222325
    for b in s.encode("utf-8"):
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


_DEFAULT_RE = re.compile(r"^fp\s*%\s*(\d+)\s*(?:\+\s*(\d+))?$")


@dataclass
class GroupConfig:
    """Parsed sharding rules; immutable after parse."""

    # gid -> exact predicate names
    exact: Dict[str, int] = field(default_factory=dict)
    # (prefix, gid), longest-prefix-wins
    prefixes: List[Tuple[str, int]] = field(default_factory=list)
    mod: int = 1
    offset: int = 1

    @classmethod
    def parse(cls, text: str) -> "GroupConfig":
        """Format (group/conf.go:105): one rule per line —
        ``<gid>: pred1, pref*`` or ``default: fp % N + k``; '#' comments."""
        cfg = cls()
        seen_default = False
        for lineno, raw in enumerate(text.splitlines(), 1):
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            head, _, body = line.partition(":")
            head, body = head.strip(), body.strip()
            if not body:
                raise ValueError(f"groups config line {lineno}: missing ':'")
            if head == "default":
                m = _DEFAULT_RE.match(body)
                if not m:
                    raise ValueError(
                        f"groups config line {lineno}: default must be 'fp % N [+ k]'"
                    )
                cfg.mod = int(m.group(1))
                cfg.offset = int(m.group(2) or 0)
                seen_default = True
                continue
            if not head.isdigit():
                raise ValueError(f"groups config line {lineno}: bad group id {head!r}")
            gid = int(head)
            for tok in body.split(","):
                tok = tok.strip()
                if not tok:
                    continue
                if tok.endswith("*"):
                    cfg.prefixes.append((tok[:-1], gid))
                else:
                    if tok in cfg.exact:
                        raise ValueError(
                            f"groups config line {lineno}: duplicate rule for {tok!r}"
                        )
                    cfg.exact[tok] = gid
        if not seen_default and (cfg.exact or cfg.prefixes):
            # reference requires an explicit default when rules exist
            raise ValueError("groups config: missing 'default: fp % N + k' rule")
        cfg.prefixes.sort(key=lambda p: -len(p[0]))  # longest prefix wins
        return cfg

    @classmethod
    def single_group(cls) -> "GroupConfig":
        """No config file: everything in group 1 (ParseGroupConfig:165)."""
        return cls()

    def belongs_to(self, pred: str) -> int:
        gid = self.exact.get(pred)
        if gid is not None:
            return gid
        for prefix, g in self.prefixes:
            if pred.startswith(prefix):
                return g
        return fingerprint64(pred) % self.mod + self.offset

    def known_groups(self) -> List[int]:
        out = set(self.exact.values()) | {g for _, g in self.prefixes}
        out.update(range(self.offset, self.offset + self.mod))
        return sorted(out)


# metadata group: membership + uid lease live here (worker/worker.go:59
# places "_lease_"; we pin group 0 explicitly like groups.go's group-0
# membership convention)
METADATA_GROUP = 0
