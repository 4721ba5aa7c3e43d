"""Run one cell of the benchmark on its cards and print its result.

    python -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of stdout is one JSON object: ``correct``, ``attempted``
and ``failed`` (queries), ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit, which are also the last lines of stderr.  An earlier stdout line
(``info``) gives the card, its power limit, the peak device memory, the
counts of batches and queries and what the cell's driver adds.

The cell's traffic names its driver (``benchmark/drivers/<driver>.py``,
``benchmark/spec.py``), which gets the cell's ``chips`` cards,
``cuda:0`` up, and times the window.

Exits non-zero with no result when the driver is missing, when torch
sees no CUDA card or fewer cards than the cell asks for, when the
program is missing, or when JAX or the JAX package is loaded once the
result is built, just before it would be printed.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()  # set-up counts from the process's first line

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

# top-level module names that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "dgraph_tpu")


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name, compared whole, is one
    of ``FORBIDDEN``."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def result_line(cell, run, checks, failed, info, tracing: bool, devices) -> dict:
    """The result object (``checks`` last)."""
    import torch

    from benchmark import compare, spec, trace

    metrics = spec.read_metrics(cell.per_layer if tracing else cell.end_to_end,
                               run, cell.root)
    device = devices[0]
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                    else "cpu"),
           "count": len(devices), "memory_peak_bytes": info["memory_peak_bytes"]}
    out = {"correct": compare.is_correct(checks), "attempted": run.queries,
           "failed": failed, "metrics": metrics, "device": dev}
    if tracing and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": trace.top_ops(run.trace),
                            "idle_gaps": trace.idle_gaps(run.trace)}
    out["checks"] = checks
    return out


def report(cell, run, checks, failed, info, tracing: bool, devices) -> int:
    """Build the result, then print it unless a forbidden module is
    loaded by then (the metrics' readers are loaded while it is built):
    the info line, the checks on stderr, the result last.  Returns the
    exit code."""
    from benchmark import compare

    out = result_line(cell, run, checks, failed, info, tracing, devices)
    found = forbidden_modules(list(sys.modules))
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps({"info": info}), flush=True)
    print(f"benchmark: {cell.workload['name']} seed {info.get('seed')}: "
          f"{info['batches']} batches, {info['queries']} queries, failed {failed}",
          file=sys.stderr)
    compare.print_checks(checks)
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import spec

    cell = spec.load_cell(args.workload)
    try:
        driver = spec.driver(cell)
    except FileNotFoundError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2

    devices = [torch.device("cuda", i) for i in range(chips)]
    run, checks, failed, info = driver.run_cell(
        cell, args.seed, args.seconds, bool(args.trace), devices, _T_START)
    info.update(workload=args.workload, seed=args.seed, trace=args.trace,
                card=torch.cuda.get_device_name(devices[0]),
                cards=torch.cuda.device_count(), power=power_limit())
    return report(cell, run, checks, failed, info, bool(args.trace), devices)


if __name__ == "__main__":
    sys.exit(main())
