"""RDF N-Quad parsing (equivalent of the reference's rdf/ package)."""

from dgraph_tpu_torch.rdf.parse import NQuad, ParseError, parse_line, parse_nquads  # noqa: F401
