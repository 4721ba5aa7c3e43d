"""Tokenizers feeding the secondary indexes.

Equivalent of the reference's tok/ package (tok/tok.go:32-344): each
tokenizer turns a typed value into index tokens; an index arena maps
token → posting list of uids.  Identifier bytes mirror the reference so
on-disk/token-table layouts are comparable for parity checking.

Tokens here are *host-side* objects with a total order (the reference
encodes sortable bytes; we keep typed python/numpy keys and sort the token
table) — the device only ever sees token-row indexes, so inequality
functions become contiguous row ranges (ops.range_rows).
"""

from dgraph_tpu_torch.tok.tok import (  # noqa: F401
    Tokenizer,
    get_tokenizer,
    has_tokenizer,
    registered,
    tokens_for_value,
    tokens_for_value_lang,
    term_tokens,
    fulltext_tokens,
    trigram_tokens,
)
