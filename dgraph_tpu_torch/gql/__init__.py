"""GraphQL± query language frontend.

Equivalent of the reference's gql/ + lex/ packages: parses query strings
into the AST the engine consumes.  The reference uses a Rob-Pike-style
state-function lexer (lex/lexer.go:113) feeding a hand-written parser
(gql/parser.go:481); here a regex tokenizer feeds a recursive-descent
parser — the language accepted is the same (queries, filters, functions,
variables, facets, fragments, mutations, schema blocks).
"""

from dgraph_tpu_torch.gql.ast import (  # noqa: F401
    FacetsSpec,
    FilterTree,
    Function,
    GraphQuery,
    MathTree,
    Mutation,
    ParsedResult,
    SchemaRequest,
    VarRef,
)
from dgraph_tpu_torch.gql.parser import ParseError, parse  # noqa: F401
