"""Debug tool: print every posting of a persisted store as an N-Quad
line (the port of ``dgraph_tpu/cli/posting_iterator.py``; the
reference's is cmd/postingiterator/main.go).

    python -m dgraph_tpu_torch.cli.posting_iterator --p DIR [--pred NAME]

It recovers the ``DurableStore`` in ``--p`` (default ``p``) and prints
the lines ``/admin/export`` writes, in the same order; ``--pred`` keeps
the lines of one predicate.  It touches no device."""

from __future__ import annotations

import argparse
import sys

from dgraph_tpu_torch.models.wal import DurableStore
from dgraph_tpu_torch.serve.export import iter_rdf_lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="posting-iterator", description=__doc__)
    p.add_argument("--p", dest="postings_dir", default="p")
    p.add_argument("--pred", default="", help="only this predicate")
    ns = p.parse_args(argv)
    store = DurableStore(ns.postings_dir)
    try:
        for line in iter_rdf_lines(store):
            if ns.pred and f"<{ns.pred}>" not in line:
                continue
            print(line)
    finally:
        store.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
