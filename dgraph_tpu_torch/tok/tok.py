"""Tokenizer registry and implementations.

Mirrors /root/reference/tok/tok.go: registry (:60-125), term (0x1),
exact (0x2), datetime year/month/day/hour (0x4,0x41-0x43), geo (0x5),
int (0x6), float (0x7), fulltext (0x8), bool (0x9), trigram (0xA).

IsSortable ⇒ the token table's sort order equals the value order, so
le/ge/lt/gt become token-row ranges.  IsLossy ⇒ candidates from the index
need an exact re-check on the host (worker/task.go:542-585 does the same).
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass
from typing import Any, Callable, Dict, List

from dgraph_tpu_torch.models.types import TypeID, TypedValue, convert

from dgraph_tpu_torch.tok.stopwords import STOPWORDS
from dgraph_tpu_torch.tok.stem import stem


@dataclass(frozen=True)
class Tokenizer:
    name: str
    typ: TypeID           # value type this tokenizer accepts
    identifier: int       # byte tag, mirrors tok/tok.go for parity
    sortable: bool        # token order == value order
    lossy: bool           # index candidates need exact host re-check
    fn: Callable[[TypedValue], List[Any]]


_REGISTRY: Dict[str, Tokenizer] = {}


def _register(t: Tokenizer):
    _REGISTRY[t.name] = t
    return t


def get_tokenizer(name: str) -> Tokenizer:
    t = _REGISTRY.get(name)
    if t is None:
        raise ValueError(f"unknown tokenizer {name!r}")
    return t


def has_tokenizer(name: str) -> bool:
    return name in _REGISTRY


def registered() -> List[str]:
    return sorted(_REGISTRY)


# --- term / fulltext ------------------------------------------------------

_WORD_RE = re.compile(r"[\w']+", re.UNICODE)


def _normalize(s: str) -> str:
    # lowercase + strip diacritics, approximating bleve's unicode normalize
    s = unicodedata.normalize("NFKD", s.lower())
    return "".join(c for c in s if not unicodedata.combining(c))


def term_tokens(s: str) -> List[str]:
    """term tokenizer: unicode words, lowercased (tok/tok.go term, bleve)."""
    return sorted(set(_WORD_RE.findall(_normalize(s))))


# Stopwords are matched against NORMALIZED tokens, so the lists must
# live in the folded alphabet too ("és"→"es", "für"→"fur") — folded once
# at import, or accented entries silently never match.
_STOP_FOLDED = {
    code: frozenset(_normalize(x) for x in words)
    for code, words in STOPWORDS.items()
}


def fulltext_tokens(s: str, lang: str = "en") -> List[str]:
    """fulltext: term pipeline + stopword removal + stemming
    (tok/fts.go:46-142).  The language tag normalizes HERE — region
    subtags strip ("de-AT" → "de", "en-US" → "en") — so index build and
    every query surface reduce under identical rules no matter which
    tag spelling reaches them."""
    code = (lang or "en").split(",")[0].split("-")[0].lower() or "en"
    stop = _STOP_FOLDED.get(code, _STOP_FOLDED["en"])
    out = set()
    for w in _WORD_RE.findall(_normalize(s)):
        if w in stop:
            continue
        out.add(stem(w, code))
    return sorted(out)


def trigram_tokens(s: str) -> List[str]:
    """trigram tokenizer for regexp candidates (tok/tok.go:321-344)."""
    out = set()
    for i in range(len(s) - 2):
        out.add(s[i : i + 3])
    return sorted(out)


# --- implementations ------------------------------------------------------

def _tok_term(v: TypedValue) -> List[str]:
    return term_tokens(str(convert(v, TypeID.STRING).value))


def _tok_exact(v: TypedValue) -> List[str]:
    return [str(convert(v, TypeID.STRING).value)]


def _tok_fulltext(v: TypedValue) -> List[str]:
    return fulltext_tokens(str(convert(v, TypeID.STRING).value))


def _tok_int(v: TypedValue) -> List[int]:
    return [int(convert(v, TypeID.INT).value)]


def _tok_float(v: TypedValue) -> List[int]:
    # The reference indexes floats by int(float) buckets (tok/tok.go float
    # tokenizer encodes the int64 of the value); lossy ⇒ exact re-check.
    return [int(convert(v, TypeID.FLOAT).value)]


def _tok_bool(v: TypedValue) -> List[int]:
    return [1 if convert(v, TypeID.BOOL).value else 0]


def _tok_year(v: TypedValue) -> List[int]:
    return [convert(v, TypeID.DATETIME).value.year]


def _tok_month(v: TypedValue) -> List[int]:
    d = convert(v, TypeID.DATETIME).value
    return [d.year * 16 + d.month]


def _tok_day(v: TypedValue) -> List[int]:
    d = convert(v, TypeID.DATETIME).value
    return [(d.year * 16 + d.month) * 64 + d.day]


def _tok_hour(v: TypedValue) -> List[int]:
    d = convert(v, TypeID.DATETIME).value
    return [((d.year * 16 + d.month) * 64 + d.day) * 32 + d.hour]


def _tok_trigram(v: TypedValue) -> List[str]:
    return trigram_tokens(str(convert(v, TypeID.STRING).value))


def _tok_geo(v: TypedValue) -> List[int]:
    from dgraph_tpu_torch.models import geo as _geo

    return _geo.index_cells(convert(v, TypeID.GEO).value)


_register(Tokenizer("term", TypeID.STRING, 0x1, False, True, _tok_term))
_register(Tokenizer("exact", TypeID.STRING, 0x2, True, False, _tok_exact))
_register(Tokenizer("fulltext", TypeID.STRING, 0x8, False, True, _tok_fulltext))
_register(Tokenizer("int", TypeID.INT, 0x6, True, False, _tok_int))
_register(Tokenizer("float", TypeID.FLOAT, 0x7, True, True, _tok_float))
_register(Tokenizer("bool", TypeID.BOOL, 0x9, False, False, _tok_bool))
_register(Tokenizer("year", TypeID.DATETIME, 0x4, True, True, _tok_year))
_register(Tokenizer("month", TypeID.DATETIME, 0x41, True, True, _tok_month))
_register(Tokenizer("day", TypeID.DATETIME, 0x42, True, True, _tok_day))
_register(Tokenizer("hour", TypeID.DATETIME, 0x43, True, True, _tok_hour))
_register(Tokenizer("trigram", TypeID.STRING, 0xA, False, True, _tok_trigram))
_register(Tokenizer("geo", TypeID.GEO, 0x5, False, True, _tok_geo))
# alias: "datetime" index directive defaults to year granularity
_register(Tokenizer("datetime", TypeID.DATETIME, 0x4, True, True, _tok_year))


def tokens_for_value(tokenizer: str, v: TypedValue) -> List[Any]:
    return get_tokenizer(tokenizer).fn(v)


def tokens_for_value_lang(tokenizer: str, v: TypedValue, lang: str) -> List[Any]:
    """Index-build tokenization with the VALUE's own language: fulltext
    values analyze under their lang tag's stopwords + stemmer (the
    reference's per-language bleve analyzers, tok/fts.go:46-142); every
    other tokenizer is language-blind.  Query-side tokens use the
    function's @lang tag (functions.py), so both sides reduce alike."""
    t = get_tokenizer(tokenizer)
    if t.name == "fulltext" and lang:
        return fulltext_tokens(str(convert(v, TypeID.STRING).value), lang)
    return t.fn(v)
