"""CLI: ``python -m dgraph_tpu_torch.analysis [paths...]``.

Runs graftlint (AST rules) and the static lock-order pass over the
package (default: the ``dgraph_tpu_torch`` tree) and exits nonzero on
any non-baselined finding, lock-order cycle, or self-nesting on a
non-reentrant lock.  The shipped baseline is empty; ``--write-baseline``
exists for adopting the suite on a tree with standing debt, not for
silencing new findings.  ``--races`` runs the static thread-escape pass
instead, against the (empty) ``shared.json`` manifest.

``--programs`` runs the kernel contract registry (analysis/programs.py)
instead: site coverage, then each hand kernel's wrapper on the card
(``--device cuda``, the default: launches a call, the caller's stream,
no host sync, outputs equal to the plain version's) or its CPU half
(``--device cpu``: dtypes, shapes and values against the plain
versions).  Without a GPU ``--device cuda`` raises.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from dgraph_tpu_torch.analysis.framework import (
    apply_baseline,
    load_baseline,
    run_rules,
    write_baseline,
)
from dgraph_tpu_torch.analysis.lockorder import check_lock_order
from dgraph_tpu_torch.analysis.rules import ALL_RULES

_DEFAULT_EXCLUDE = ("dgraph_tpu_torch/analysis/",)  # the checker's own fixtures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dgraph_tpu_torch.analysis",
        description="graftcheck for the port: repo-native static "
                    "analysis (rule catalog: analysis/rules.py)",
    )
    ap.add_argument(
        "paths", nargs="*",
        help="files/dirs to check (default: the dgraph_tpu_torch package)",
    )
    ap.add_argument(
        "--baseline", default=None,
        help="JSON baseline of accepted finding fingerprints",
    )
    ap.add_argument(
        "--write-baseline", metavar="PATH", default=None,
        help="write current findings as the new baseline and exit 0",
    )
    ap.add_argument(
        "--lock-graph", action="store_true",
        help="print the full static lock-order graph",
    )
    ap.add_argument(
        "--no-lint", action="store_true", help="skip the AST rules"
    )
    ap.add_argument(
        "--no-locks", action="store_true", help="skip the lock-order pass"
    )
    ap.add_argument(
        "--programs", action="store_true",
        help="check the hand kernels' contracts (analysis/programs.py) "
             "instead of the lint/lock passes",
    )
    ap.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where --programs runs: cuda (default; raises without a "
             "GPU) or cpu (the dtype/shape/value half)",
    )
    ap.add_argument(
        "--races", action="store_true",
        help="run the static thread-escape pass (tier 3) instead of the "
             "lint/lock passes; exits nonzero on any finding not in the "
             "sanctioned-shared manifest",
    )
    ap.add_argument(
        "--shared-manifest", metavar="PATH", default=None,
        help="sanctioned-shared manifest for --races (default: "
             "analysis/shared.json)",
    )
    ap.add_argument(
        "--write-shared", metavar="PATH", default=None,
        help="write current escape findings as the sanctioned-shared "
             "manifest and exit 0 (adoption aid, not a silencer)",
    )
    ns = ap.parse_args(argv)

    if ns.programs:
        # runs alone: it imports torch and the kernels' wrappers, a
        # different beast from the AST passes
        from dgraph_tpu_torch.analysis.programs import run_check

        return run_check(device=ns.device)

    pkg_root = Path(__file__).resolve().parents[1]   # dgraph_tpu_torch/
    repo_root = pkg_root.parent
    roots = ns.paths or [str(pkg_root)]

    if ns.races or ns.write_shared:
        # tier 3 (static half) runs alone, like --programs: same AST
        # substrate as lint/locks but a different verdict and manifest
        from dgraph_tpu_torch.analysis.escape import check_escapes

        findings = check_escapes(
            roots, repo_root=str(repo_root), exclude=_DEFAULT_EXCLUDE
        )
        if ns.write_shared:
            write_baseline(ns.write_shared, findings)
            print(
                f"wrote {len(findings)} fingerprint(s) to {ns.write_shared}"
            )
            return 0
        manifest = ns.shared_manifest or str(
            Path(__file__).resolve().parent / "shared.json"
        )
        fresh = apply_baseline(findings, load_baseline(manifest))
        for f in fresh:
            print(f.render())
        n_base = len(findings) - len(fresh)
        if fresh:
            print(
                f"\nthread-escape: {len(fresh)} finding(s)"
                + (f" ({n_base} sanctioned)" if n_base else "")
            )
            return 1
        print(
            "thread-escape: clean"
            + (f" ({n_base} sanctioned)" if n_base else "")
        )
        return 0

    rc = 0
    if not ns.no_lint:
        findings = run_rules(
            roots, ALL_RULES, repo_root=str(repo_root),
            exclude=_DEFAULT_EXCLUDE,
        )
        if ns.write_baseline:
            write_baseline(ns.write_baseline, findings)
            print(
                f"wrote {len(findings)} fingerprint(s) to {ns.write_baseline}"
            )
            return 0
        fresh = apply_baseline(findings, load_baseline(ns.baseline))
        for f in fresh:
            print(f.render())
        n_base = len(findings) - len(fresh)
        if fresh:
            print(
                f"\ngraftlint: {len(fresh)} finding(s)"
                + (f" ({n_base} baselined)" if n_base else "")
            )
            rc = 1
        else:
            print(
                "graftlint: clean"
                + (f" ({n_base} baselined)" if n_base else "")
            )

    if not ns.no_locks:
        graph, problems = check_lock_order(
            roots, repo_root=str(repo_root), exclude=_DEFAULT_EXCLUDE
        )
        if ns.lock_graph:
            print(graph.render())
        for p in problems:
            print(p)
        if problems:
            rc = 1
        else:
            print(
                f"lock-order: cycle-free "
                f"({len(graph.classes)} lock classes, "
                f"{len(graph.edges)} edges)"
            )
    return rc


if __name__ == "__main__":
    sys.exit(main())
