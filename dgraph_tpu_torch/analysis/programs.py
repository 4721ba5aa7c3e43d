"""The contract registry of the port's hand kernels.

The reference's device-program checker (``dgraph_tpu/analysis/
programs.py``) traces every jitted factory and holds its jaxpr to golden
fingerprints.  A torch wrapper over a hand kernel has no jaxpr; what a
caller relies on is the wrapper's contract, so that is what is
registered and checked, one :class:`KernelContract` per wrapper:

- **launches**: one call of the wrapper launches its kernel exactly
  ``launches`` times (read from ``CudaKernel.launches``,
  ``ops/_build.py``);
- **outputs**: the output's dtype and shape equal the plain version's
  on the same inputs, and so do its values;
- **stream**: the wrapper launches on the caller's current stream (a
  side stream the check creates), so a caller's stream ordering holds;
- **no host sync**: the call runs under
  ``torch.cuda.set_sync_debug_mode("error")``, where a synchronizing
  torch op raises.

The stream check records the stream handle each launch was given, and
keeps the default stream busy (``torch.cuda._sleep``) while the side
stream's event is awaited: the output is read after that event alone,
with the default stream still running, so work put on any other stream
would show as a wrong output or an idle default stream.

**Site coverage** replaces the reference's ``EXEMPT_SITES`` and
``covers``: every ``CudaKernel(...)`` construction in the package and
every ``extern "C"`` entry of ``csrc/*.cu`` must map to a contract by
(source, entry); :func:`uncovered_sites` names those that do not, and
a contract whose kernel no longer exists.

On the CPU (``device="cpu"``) the dtype, shape and value checks run
against the plain versions (a wrapper given CPU tensors runs its plain
version and launches nothing); the launch, stream and sync checks need
the card.  CLI: ``python -m dgraph_tpu_torch.analysis --programs
[--device cpu]``.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

PKG_ROOT = Path(__file__).resolve().parents[1]

# the default stream's busy wait while the side stream's event is
# awaited: ~30 ms at the H100's clock, far above one small launch
_SLEEP_CYCLES = 50_000_000


class ContractError(AssertionError):
    """A kernel wrapper broke its registered contract."""


@dataclass
class Instance:
    """One checked call: host inputs made from a seed, how the wrapper
    is called on their tensors, and how its plain version is."""

    key: str
    inputs: Tuple[np.ndarray, ...]
    call: Callable      # (module, *tensors) -> tensor, via the wrapper
    plain: Callable     # (module, *tensors) -> tensor, the plain version


@dataclass
class KernelContract:
    kernel: str         # the CUDA kernel's name
    module: str         # the wrapper's module (holds ``KERNEL``)
    wrapper: str        # the wrapper's name in ``module``
    source: str         # csrc/<source>.cu
    entry: str          # its extern "C" entry point
    build: Callable[[], List[Instance]]
    launches: int = 1   # kernel launches per wrapper call


# -- instances ----------------------------------------------------------------

def _resident_fixture():
    """Tiny CSR in the ResidentArena storage layout (models/arena.py):
    offsets over eight rows, dst SENT-padded to ``_resident_cap``'s
    128-lane granule plus its slack tile, and eight rows padded with -1
    (the reference's ``_resident_fixture``)."""
    from dgraph_tpu_torch.models.arena import _resident_cap
    from dgraph_tpu_torch.ops import sets

    degs = np.array([3, 0, 5, 2, 1, 0, 4, 2], np.int64)
    off = np.zeros(9, np.int32)
    off[1:] = np.cumsum(degs).astype(np.int32)
    n_edges = int(off[-1])
    dst = np.full(_resident_cap(n_edges), sets.SENT, np.int32)
    dst[:n_edges] = np.arange(100, 100 + n_edges, dtype=np.int32)
    rows = sets.pad_rows(np.array([0, 2, 3, 6], np.int64), 8).astype(np.int32)
    return off, dst, rows


def _gather_instances() -> List[Instance]:
    """The reference's ``_gather_inst`` shapes: eight rows at the bucketed
    capacities of raw caps 32, 10 and 5 (the last two truncate the 17
    live edges)."""
    from dgraph_tpu_torch.ops import sets

    off, dst, rows = _resident_fixture()
    out = []
    for raw in (32, 10, 5):
        cap = sets.bucket(raw)
        out.append(Instance(
            f"R8xC{cap}", (off, dst, rows),
            lambda m, o, d, r, cap=cap: m.gather_packed(o, d, r, cap),
            lambda m, o, d, r, cap=cap: m.gather_packed_plain(o, d, r, cap),
        ))
    return out


def _slotmap_inputs(rng, q: int, pcap: int):
    """q grouped prefixes, the layout the inline expansion hands the
    kernel: up to pcap/2 productive rows (chunk counts 1..5, strictly
    ascending chunk starts with gaps 0..2), then a zero tail."""
    cs = np.zeros((q, pcap), np.int32)
    cd = np.zeros((q, pcap), np.int32)
    for i in range(q):
        n = int(rng.integers(0, pcap // 2 + 1))
        d = rng.integers(1, 6, size=n)
        cs[i, :n] = np.cumsum(rng.integers(0, 3, size=n)) + np.cumsum(d) - d
        cd[i, :n] = d
    return cs, cd


def _slotmap_instances() -> List[Instance]:
    """The reference's ``_slotmap_inst``: 128 prefix rows, the chunk
    capacity rounded to the kernel's 128-slot granule (raw 128 and 250),
    at Q 1 (the inline route) and Q 200 (a batched 2-hop chunk); the
    prefixes drawn from a seed so the map is not all -1."""
    rng = np.random.default_rng(21)
    out = []
    for q, raw in ((1, 128), (1, 250), (200, 250)):
        capc = ((raw + 127) >> 7) << 7
        cs, cd = _slotmap_inputs(rng, q, 128)
        out.append(Instance(
            f"Q{q}xP128xC{capc}", (cs, cd),
            lambda m, a, b, capc=capc: m.slotmap(a, b, capc),
            lambda m, a, b, capc=capc: m.slotmap_plain(a, b, capc),
        ))
    return out


def _intersect_instances() -> List[Instance]:
    """The reference's ``_b_pallas_intersect`` matrices, 2-D through the
    ``intersect_pallas`` twin (K2xL64, K4xL64), and the K4 matrix three
    times over as a batch (B3xK4xL64)."""
    from dgraph_tpu_torch.ops import sets

    m2 = np.stack([sets.pad_to(np.arange(0, 20, 2), 64),
                   sets.pad_to(np.arange(0, 30, 3), 64)])
    m4 = np.stack([sets.pad_to(np.arange(0, 24, k), 64) for k in (2, 3, 4, 6)])
    b3 = np.stack([m4, m4[::-1].copy(), np.stack([m4[0]] * 4)])
    twin = (lambda m, x: m.intersect_kernel(x))
    plain = (lambda m, x: m.intersect_plain(x))
    return [
        Instance("K2xL64", (m2,), twin, plain),
        Instance("K4xL64", (m4,), twin, plain),
        Instance("B3xK4xL64", (b3,), lambda m, x: m.intersect_batch(x), plain),
    ]


def _granule_instances() -> List[Instance]:
    """A 37-row table gathered by a 1-D, a 2-D and a 3-D index drawn
    from [-3, 45): negative entries fill, entries past the table clamp
    to its last row; fills SENT (the inline expansions'), 0 and -1."""
    from dgraph_tpu_torch.ops import sets

    rng = np.random.default_rng(25)
    table = rng.integers(-(1 << 31), 1 << 31, size=(37, 8)).astype(np.int32)
    out = []
    for shape, fill in (((300,), sets.SENT), ((4, 129), 0), ((2, 3, 50), -1)):
        idx = rng.integers(-3, 45, size=shape).astype(np.int32)
        key = "x".join(map(str, shape))
        out.append(Instance(
            f"N37xI{key}xF{fill}", (table, idx),
            lambda m, t, i, fill=fill: m.gather_granules(t, i, fill),
            lambda m, t, i, fill=fill: m.gather_granules_plain(t, i, fill),
        ))
    return out


CONTRACTS: Tuple[KernelContract, ...] = (
    KernelContract("gather_fused", "dgraph_tpu_torch.ops.gather",
                   "gather_packed", "gather", "gather_packed",
                   _gather_instances),
    KernelContract("slotmap_tiles", "dgraph_tpu_torch.ops.slotmap",
                   "slotmap", "slotmap", "slotmap", _slotmap_instances),
    KernelContract("intersect_tiles", "dgraph_tpu_torch.ops.kway",
                   "intersect_batch", "intersect", "intersect",
                   _intersect_instances),
    KernelContract("granule_gather", "dgraph_tpu_torch.ops.granules",
                   "gather_granules", "granules", "gather_granules",
                   _granule_instances),
)


# -- site coverage -----------------------------------------------------------

_EXTERN_RE = re.compile(r'extern\s+"C"\s+[\w\s\*]*?\b(\w+)\s*\(')


def kernel_constructions(pkg_root: Path = PKG_ROOT) -> List[Tuple[str, str, str]]:
    """(site, source, entry) of every ``CudaKernel("<source>",
    "<entry>", ...)`` construction in the package's Python files (the
    analysis package excluded)."""
    out = []
    for f in sorted(pkg_root.rglob("*.py")):
        rel = f.relative_to(pkg_root.parent).as_posix()
        if "/analysis/" in rel:
            continue
        tree = ast.parse(f.read_text(encoding="utf-8"))
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name != "CudaKernel":
                continue
            consts = [a.value for a in node.args[:2]
                      if isinstance(a, ast.Constant) and isinstance(a.value, str)]
            src, entry = (consts + ["?", "?"])[:2]
            out.append((f"{rel}:{node.lineno}", src, entry))
    return out


def extern_entries(pkg_root: Path = PKG_ROOT) -> List[Tuple[str, str, str]]:
    """(site, source, entry) of every ``extern "C"`` function of
    ``csrc/*.cu``."""
    out = []
    for f in sorted((pkg_root / "csrc").glob("*.cu")):
        text = f.read_text(encoding="utf-8")
        for m in _EXTERN_RE.finditer(text):
            line = text.count("\n", 0, m.start()) + 1
            rel = f.relative_to(pkg_root.parent).as_posix()
            out.append((f"{rel}:{line}", f.stem, m.group(1)))
    return out


def uncovered_sites(
    pkg_root: Path = PKG_ROOT,
    contracts: Sequence[KernelContract] = CONTRACTS,
) -> List[str]:
    """Every kernel construction or C entry no contract covers, and every
    contract whose construction or entry is missing; [] when covered."""
    covered = {(c.source, c.entry) for c in contracts}
    cons = kernel_constructions(pkg_root)
    ents = extern_entries(pkg_root)
    out = [f"{site}: CudaKernel({src!r}, {entry!r}) has no KernelContract"
           for site, src, entry in cons if (src, entry) not in covered]
    out += [f"{site}: extern \"C\" {entry} ({src}.cu) has no KernelContract"
            for site, src, entry in ents if (src, entry) not in covered]
    have_cons = {(s, e) for _site, s, e in cons}
    have_ents = {(s, e) for _site, s, e in ents}
    for c in contracts:
        if (c.source, c.entry) not in have_cons:
            out.append(f"contract {c.kernel}: no CudaKernel({c.source!r}, "
                       f"{c.entry!r}) in the package")
        if (c.source, c.entry) not in have_ents:
            out.append(f"contract {c.kernel}: no extern \"C\" {c.entry} in "
                       f"csrc/{c.source}.cu")
    return out


# -- the checks ---------------------------------------------------------------

def _module(c: KernelContract):
    import importlib

    return importlib.import_module(c.module)


def _max_abs(a, b) -> int:
    if a.numel() == 0:
        return 0
    return int((a.to("cpu").long() - b.to("cpu").long()).abs().max())


def _check_outputs(c: KernelContract, inst: Instance, out, ref) -> int:
    if out.dtype != ref.dtype or tuple(out.shape) != tuple(ref.shape):
        raise ContractError(
            f"{c.kernel} {inst.key}: output {out.dtype} {tuple(out.shape)} "
            f"!= plain version's {ref.dtype} {tuple(ref.shape)}")
    err = _max_abs(out, ref)
    if err != 0:
        raise ContractError(
            f"{c.kernel} {inst.key}: output differs from the plain version "
            f"(max abs {err})")
    return err


def check_cpu(c: KernelContract) -> List[dict]:
    """The CPU half: the wrapper on CPU tensors (its plain version) has
    the plain version's dtype, shape and values, and launches nothing."""
    import torch

    m = _module(c)
    rows = []
    for inst in c.build():
        ts = [torch.from_numpy(x.copy()) for x in inst.inputs]
        before = m.KERNEL.launches
        out = inst.call(m, *ts)
        ref = inst.plain(m, *[torch.from_numpy(x.copy()) for x in inst.inputs])
        err = _check_outputs(c, inst, out, ref)
        if m.KERNEL.launches != before:
            raise ContractError(f"{c.kernel} {inst.key}: a CPU call launched "
                                "the kernel")
        rows.append(dict(kernel=c.kernel, wrapper=c.wrapper, instance=inst.key,
                         device="cpu",
                         dtype=str(out.dtype).replace("torch.", ""),
                         shape=list(out.shape), max_abs_err=err))
    return rows


def check_cuda(c: KernelContract, device: str = "cuda") -> List[dict]:
    """The card half: per instance, one call of the wrapper on a side
    stream under sync-debug mode "error", with the default stream kept
    busy; then launches, streams, overlap and the output against the
    plain version, read after the side stream's event."""
    import torch

    m = _module(c)
    dev = torch.device(device)
    kernel = m.KERNEL
    rows = []
    for inst in c.build():
        ts = [torch.from_numpy(x.copy()).to(dev) for x in inst.inputs]
        side = torch.cuda.Stream(device=dev)
        default = torch.cuda.default_stream(dev)
        # warm, on the side stream: the library's load, the first launch,
        # and the caching allocator's blocks for this stream (a
        # cudaMalloc during the checked call would wait for the default
        # stream's sleep: a device allocation serializes the streams)
        side.wait_stream(default)
        with torch.cuda.stream(side):
            inst.call(m, *ts)
        torch.cuda.synchronize(dev)
        streams: List[int] = []
        orig_launch = kernel.launch

        def spy(*args, _orig=orig_launch):
            streams.append(int(args[-1]))
            return _orig(*args)

        sleep = getattr(torch.cuda, "_sleep", None)
        kernel.launch = spy
        try:
            if sleep is not None:
                with torch.cuda.stream(default):
                    sleep(_SLEEP_CYCLES)
            before = kernel.launches
            prev = torch.cuda.get_sync_debug_mode()
            with torch.cuda.stream(side):
                torch.cuda.set_sync_debug_mode("error")
                try:
                    out = inst.call(m, *ts)
                    done = torch.cuda.Event()
                    done.record(side)
                except RuntimeError as e:
                    raise ContractError(
                        f"{c.kernel} {inst.key}: host sync in the wrapper "
                        f"under sync-debug mode: {e}") from e
                finally:
                    torch.cuda.set_sync_debug_mode(prev)
            launches = kernel.launches - before
        finally:
            kernel.launch = orig_launch
        done.synchronize()
        overlap = (not default.query()) if sleep is not None else None
        got = out.to("cpu")  # waits for the default stream's sleep too
        ref = inst.plain(m, *[torch.from_numpy(x.copy()) for x in inst.inputs])
        torch.cuda.synchronize(dev)
        if launches != c.launches:
            raise ContractError(f"{c.kernel} {inst.key}: {launches} launches "
                                f"a call, contract says {c.launches}")
        if not streams or any(s != side.cuda_stream for s in streams):
            raise ContractError(f"{c.kernel} {inst.key}: launched on stream(s) "
                                f"{streams}, not the caller's {side.cuda_stream}")
        if overlap is False:
            raise ContractError(f"{c.kernel} {inst.key}: the side stream's "
                                "event waited for the default stream")
        err = _check_outputs(c, inst, got, ref)
        rows.append(dict(kernel=c.kernel, wrapper=c.wrapper, instance=inst.key,
                         device="cuda",
                         launches=launches, syncs=0, stream="caller",
                         default_busy=overlap,
                         dtype=str(got.dtype).replace("torch.", ""),
                         shape=list(got.shape), max_abs_err=err))
    return rows


def check_all(device: str = "cuda",
              contracts: Sequence[KernelContract] = CONTRACTS) -> List[dict]:
    """Coverage, then every contract on ``device`` ("cuda" or "cpu").
    Raises :class:`ContractError` on the first violation, RuntimeError
    for "cuda" where no GPU exists."""
    missing = uncovered_sites(contracts=contracts)
    if missing:
        raise ContractError("kernel sites without a contract:\n  "
                            + "\n  ".join(missing))
    if device == "cpu":
        return [r for c in contracts for r in check_cpu(c)]
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the kernel contracts' launch, "
                           "stream and sync checks run on the card (use "
                           "--device cpu for the CPU half)")
    return [r for c in contracts for r in check_cuda(c, device)]


def summarize(rows: Sequence[dict]) -> Dict[str, dict]:
    """Per kernel: instances, launches a call, syncs seen, stream and
    the greatest difference from the plain version."""
    out: Dict[str, dict] = {}
    for r in rows:
        s = out.setdefault(r["kernel"], dict(
            wrapper=r["wrapper"], instances=0, launches_per_call=set(),
            syncs=0, stream=set(), max_abs_err=0))
        s["instances"] += 1
        if "launches" in r:
            s["launches_per_call"].add(r["launches"])
            s["stream"].add(r["stream"])
            s["syncs"] += r["syncs"]
        s["max_abs_err"] = max(s["max_abs_err"], r["max_abs_err"])
    for s in out.values():
        lp = sorted(s["launches_per_call"])
        s["launches_per_call"] = lp[0] if len(lp) == 1 else (lp or None)
        st = sorted(s["stream"])
        s["stream"] = st[0] if len(st) == 1 else (st or None)
    return out


def run_check(device: str = "cuda") -> int:
    """CLI body: one line per instance and per kernel; 0 when every
    contract holds, 1 on a violation."""
    import json

    try:
        rows = check_all(device)
    except ContractError as e:
        print(f"kernel-contracts: FAILED: {e}")
        return 1
    for r in rows:
        print(json.dumps(r))
    for name, s in summarize(rows).items():
        print(json.dumps(dict(kernel=name, **s)))
    print(f"kernel-contracts: {len(rows)} instance(s) of {len(CONTRACTS)} "
          f"contract(s) hold on {device}")
    return 0
