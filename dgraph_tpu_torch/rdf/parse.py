"""N-Quad line parser.

Equivalent of /root/reference/rdf/parse.go (Parse:59): subjects/objects as
<iri>, _:blank or <0xNN> explicit uids; typed literals ^^<type>; @lang
tags; facets in trailing parens (parseFacets:241); optional label; '*'
wildcards in delete mutations.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dgraph_tpu_torch.models.types import TypeID, TypedValue, parse_datetime, type_from_name


class ParseError(ValueError):
    pass


@dataclass
class NQuad:
    subject: str                   # xid / "0x.." hex / "_:blank"
    predicate: str
    object_id: str = ""            # set for uid objects
    object_value: Optional[TypedValue] = None
    lang: str = ""
    label: str = ""
    facets: Dict[str, TypedValue] = field(default_factory=dict)

    @property
    def is_star(self) -> bool:
        return self.object_id == "*" or self.predicate == "*"


_QUAD_RE = re.compile(
    r"""\s*
    (?P<subj><[^>]*>|_:[A-Za-z0-9._\-]+|\*)\s+
    (?P<pred><[^>]*>|\*)\s+
    (?P<obj><[^>]*>|_:[A-Za-z0-9._\-]+|"(?:\\.|[^"\\])*"(?:@[A-Za-z\-:]+|\^\^<[^>]*>)?|\*)
    (?:[^\S\n]+(?P<label><[^>]*>))?
    \s*(?:\((?P<facets>[^)]*)\))?
    \s*\.[^\S\n]*""",
    re.VERBOSE,
)
_LINE_RE = re.compile(_QUAD_RE.pattern + r"(?:\#.*)?$", re.VERBOSE)

_ESC = re.compile(r"\\(.)")


def _unescape(s: str) -> str:
    return _ESC.sub(
        lambda m: {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "'": "'",
                   "r": "\r"}.get(m.group(1), m.group(1)),
        s,
    )


def _strip_angle(s: str) -> str:
    return s[1:-1] if s.startswith("<") and s.endswith(">") else s


def _facet_value(raw: str) -> TypedValue:
    """Type sniffing for facet values (types/facets/utils.go FacetFor:105):
    int, float, datetime, bool, else string."""
    raw = raw.strip()
    if raw.startswith('"') and raw.endswith('"'):
        return TypedValue(TypeID.STRING, _unescape(raw[1:-1]))
    low = raw.lower()
    if low in ("true", "false"):
        return TypedValue(TypeID.BOOL, low == "true")
    try:
        return TypedValue(TypeID.INT, int(raw))
    except ValueError:
        pass
    try:
        return TypedValue(TypeID.FLOAT, float(raw))
    except ValueError:
        pass
    try:
        return TypedValue(TypeID.DATETIME, parse_datetime(raw))
    except ValueError:
        pass
    return TypedValue(TypeID.STRING, raw)


def parse_facets_body(body: str, context: str = "") -> Dict[str, TypedValue]:
    """Parse the inside of a facet list "(k=v, k2=v2)" — shared by the
    regex parser and the native scanner's Python side."""
    out: Dict[str, TypedValue] = {}
    pos = 0
    for fm in _FACET_PAIR_RE.finditer(body):
        if body[pos : fm.start()].strip(" ,\t"):
            raise ParseError(f"bad facet near {body[pos:fm.start()]!r} in {context!r}")
        out[fm.group(1)] = _facet_value(fm.group(2))
        pos = fm.end()
    if body[pos:].strip(" ,\t"):
        raise ParseError(f"bad facet near {body[pos:]!r} in {context!r}")
    return out


def typed_literal(body: str, tname: str) -> TypedValue:
    """Literal body + optional ^^<type> name → TypedValue (rdf/parse.go's
    typed-object handling)."""
    if tname:
        tid = type_from_name(tname)
        from dgraph_tpu_torch.models.types import convert

        return convert(TypedValue(TypeID.STRING, body), tid)
    return TypedValue(TypeID.DEFAULT, body)


def parse_line(line: str) -> Optional[NQuad]:
    """Parse one N-Quad; returns None for blank/comment lines."""
    s = line.strip()
    if not s or s.startswith("#"):
        return None
    m = _LINE_RE.fullmatch(s)
    if m is None:
        raise ParseError(f"bad N-Quad: {line!r}")
    return _quad_from_match(m, line)


def _quad_from_match(m, line: str) -> NQuad:
    subj = m.group("subj")
    pred = m.group("pred")
    obj = m.group("obj")
    nq = NQuad(
        subject=_strip_angle(subj) if subj != "*" else "*",
        predicate=_strip_angle(pred) if pred != "*" else "*",
    )
    if m.group("label"):
        nq.label = _strip_angle(m.group("label"))

    if obj == "*":
        nq.object_id = "*"
    elif obj.startswith("<") or obj.startswith("_:"):
        nq.object_id = _strip_angle(obj)
    else:
        # literal with optional @lang or ^^<type>
        lit = obj
        lang = ""
        tname = ""
        tm = re.match(r'^("(?:\\.|[^"\\])*")(?:@([A-Za-z\-:]+)|\^\^<([^>]*)>)?$', lit)
        if tm is None:
            raise ParseError(f"bad literal in N-Quad: {line!r}")
        body = _unescape(tm.group(1)[1:-1])
        nq.object_value = typed_literal(body, tm.group(3) or "")
        nq.lang = tm.group(2) or ""

    if m.group("facets"):
        nq.facets = parse_facets_body(m.group("facets"), line)
    return nq


_FACET_PAIR_RE = re.compile(
    r'\s*([\w.\-]+)\s*=\s*("(?:\\.|[^"\\])*"|[^,]*?)\s*(?=,|$)'
)


def parse_nquads(text: str) -> List[NQuad]:
    """Parse a block of N-Quads: statements are '.'-terminated and several
    may share a line (the reference's chunked reader is also terminator-
    driven, cmd/dgraphloader/main.go readLine)."""
    out = []
    pos, n = 0, len(text)
    while pos < n:
        # skip whitespace and comment lines
        while pos < n and text[pos] in " \t\r\n":
            pos += 1
        if pos >= n:
            break
        if text[pos] == "#":
            nl = text.find("\n", pos)
            pos = n if nl == -1 else nl + 1
            continue
        m = _QUAD_RE.match(text, pos)
        if m is None:
            bad = text[pos : text.find("\n", pos) if text.find("\n", pos) != -1 else n]
            raise ParseError(f"bad N-Quad: {bad!r}")
        out.append(_quad_from_match(m, m.group()))
        pos = m.end()
    return out
