"""Schema state and schema-language parser.

Equivalent of the reference's schema/ package: per-predicate type +
directives (@index(tokenizers), @reverse, @count) parsed from the schema
language (schema/parse.go:94-265), held in a mutable state object
(schema/schema.go:91).  The engine additionally derives from it which
arenas (data/reverse/index) each predicate materializes on device.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from dgraph_tpu_torch.models.types import TypeID, type_from_name
from dgraph_tpu_torch import tok


@dataclass
class PredicateSchema:
    name: str
    tid: TypeID = TypeID.DEFAULT
    tokenizers: List[str] = field(default_factory=list)  # @index(...)
    reverse: bool = False                                # @reverse
    count: bool = False                                  # @count

    @property
    def indexed(self) -> bool:
        return bool(self.tokenizers)


class SchemaState:
    """Mutable predicate → schema map (schema.State() analog)."""

    def __init__(self):
        self._preds: Dict[str, PredicateSchema] = {}

    def get(self, pred: str) -> PredicateSchema:
        s = self._preds.get(pred)
        if s is None:
            s = PredicateSchema(name=pred)
            self._preds[pred] = s
        return s

    def peek(self, pred: str) -> Optional[PredicateSchema]:
        return self._preds.get(pred)

    def set(self, s: PredicateSchema):
        self._preds[s.name] = s

    def predicates(self) -> List[str]:
        return sorted(self._preds)

    def type_of(self, pred: str) -> TypeID:
        s = self._preds.get(pred)
        return s.tid if s else TypeID.DEFAULT

    def tokenizers(self, pred: str) -> List[str]:
        s = self._preds.get(pred)
        return s.tokenizers if s else []

    def sortable_tokenizer(self, pred: str) -> Optional[str]:
        for t in self.tokenizers(pred):
            if tok.get_tokenizer(t).sortable:
                return t
        return None

_DEFAULT_TOKENIZER = {
    TypeID.INT: "int",
    TypeID.FLOAT: "float",
    TypeID.BOOL: "bool",
    TypeID.DATETIME: "year",
    TypeID.DATE: "year",
    TypeID.STRING: "term",
    TypeID.DEFAULT: "term",
    TypeID.GEO: "geo",
}

_LINE_RE = re.compile(
    r"""^\s*
    (?P<name>[^\s:]+)\s*:\s*
    (?P<type>\[?\s*[\w:]+\s*\]?)
    (?P<directives>(?:\s*@\w+(?:\([^)]*\))?)*)
    \s*\.?\s*$""",
    re.VERBOSE,
)
_DIRECTIVE_RE = re.compile(r"@(\w+)(?:\(([^)]*)\))?")


def split_entries(text: str) -> List[str]:
    """Split schema text into '.'-terminated entries (several may share a
    line); a standalone '.' token ends an entry — dots inside predicate
    names don't split."""
    stripped = "\n".join(l.split("#", 1)[0] for l in text.splitlines())
    return [e.strip() for e in re.split(r"(?<=[\s)])\.(?=\s|$)", stripped) if e.strip()]


def parse_schema(text: str, into: Optional[SchemaState] = None) -> SchemaState:
    """Parse schema-language text (schema/parse.go:265).

    Syntax per entry: ``pred: type [@index(tok1, tok2)] [@reverse] [@count] .``
    ``@index`` with no argument selects the default tokenizer for the type
    (schema/parse.go resolveTokenizers:216).
    """
    state = into if into is not None else SchemaState()
    for lineno, line in enumerate(split_entries(text), 1):
        m = _LINE_RE.match(line)
        if not m:
            raise ValueError(f"schema entry {lineno}: cannot parse {line!r}")
        name = m.group("name")
        tname = m.group("type").strip().strip("[]").strip()
        tid = type_from_name(tname)
        s = PredicateSchema(name=name, tid=tid)
        for dm in _DIRECTIVE_RE.finditer(m.group("directives") or ""):
            d, args = dm.group(1), dm.group(2)
            if d == "index":
                if args and args.strip():
                    toks = [t.strip() for t in args.split(",") if t.strip()]
                else:
                    toks = [_DEFAULT_TOKENIZER.get(tid, "term")]
                for t in toks:
                    tk = tok.get_tokenizer(t)  # validates name
                    if tk.typ != tid and not (
                        tk.typ == TypeID.STRING and tid == TypeID.DEFAULT
                    ):
                        raise ValueError(
                            f"schema line {lineno}: tokenizer {t!r} is for "
                            f"{tk.typ.name}, predicate is {tid.name}"
                        )
                s.tokenizers = toks
            elif d == "reverse":
                if tid != TypeID.UID:
                    raise ValueError(
                        f"schema line {lineno}: @reverse needs uid type"
                    )
                s.reverse = True
            elif d == "count":
                s.count = True
            else:
                raise ValueError(f"schema line {lineno}: unknown directive @{d}")
        state.set(s)
    return state
