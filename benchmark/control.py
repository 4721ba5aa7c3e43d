"""The control of the comparison: answers that break one guarantee of the
configuration, which ``compare`` has to find not correct.

The configurations state exact answers.  The control is the reference
put in the program's place with the step that would tempt a later
change: capacities planned at the pool's 99th percentile instead of its
worst query, so each hop keeps only its first that many edges (the plan's
padding is most of hop 2's lanes).  It answers every query of the pool
once, and the last batch's rows give the sample held whole, as in a run.

    python -m benchmark.control --workload <name> --seeds <n> [<n> ...]

Prints each seed's compared numbers; exits 0 when every seed's control
came out not correct.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from benchmark import compare, data, reference, spec

PERCENTILE = 99.0


def control_answers(csr: reference.Csr, pool, ref, percentile: float = PERCENTILE):
    """(counts int32, checksums int32, caps, per-query (set, lanes)
    getter) with each hop cut at the pool's ``percentile`` of its edges."""
    c1, c2, chk = ref
    cap1 = int(np.percentile(c1, percentile))
    cap2 = int(np.percentile(c2, percentile))
    counts = (c1 + c2).astype(np.int64)
    chks = chk.copy()
    for i in np.nonzero((c1 > cap1) | (c2 > cap2))[0]:
        n, k, _s = reference.two_hop_set(csr, pool[i], cap1, cap2)
        counts[i], chks[i] = n, k

    def whole(i: int):
        n, _k, got = reference.two_hop_set(csr, pool[i], cap1, cap2)
        return got, n - min(int(c1[i]), cap1)  # hop-2 edges kept

    return counts.astype(np.int32), chks, (cap1, cap2), whole


def run_control(cell, seed: int, device):
    """The control's checks for one seed at the cell's own sizes."""
    tr = cell.traffic
    inputs = data.build_inputs(cell.config, tr, seed, device, cell.root)
    csr = reference.build_csr(inputs.src, inputs.dst, inputs.n_nodes)
    ref = reference.answers(csr, inputs.pool)
    counts, chks, caps, whole = control_answers(csr, inputs.pool, ref)
    q = tr["batch"]
    done = [(np.arange(b, b + q), counts[b:b + q], chks[b:b + q])
            for b in range(0, len(inputs.pool), q)]
    last = len(inputs.pool) - q
    rng = data.run_rng(seed, 3)
    rows = set(rng.choice(q, size=min(tr["check_sets"], q), replace=False).tolist())
    rows.add(int(np.argmax(counts[last:])))
    sampled = [(last + r, *whole(last + r)) for r in sorted(rows)]
    checks, failed = compare.compare(csr, inputs.pool, ref, done, sampled)
    return checks, failed, caps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch

    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    cell = spec.load_cell(args.workload)
    all_failed = True
    for seed in args.seeds:
        t = time.perf_counter()
        checks, failed, caps = run_control(cell, seed, device)
        ok = compare.is_correct(checks)
        all_failed &= not ok
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": ok,
                          "failed": failed, "caps": caps, "device": device.type,
                          "seconds": time.perf_counter() - t, "checks": checks}),
              flush=True)
    return 0 if all_failed else 1


if __name__ == "__main__":
    sys.exit(main())
