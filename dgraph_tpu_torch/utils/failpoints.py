"""Named failpoints: deterministic fault injection for chaos tests (copy
of ``dgraph_tpu/utils/failpoints.py``).

Code sites call ``fail.point("engine.hop")`` — a dict probe that is a
near-no-op while nothing is armed — and tests (or the
``DGRAPH_TPU_FAILPOINTS`` env var) arm actions against those names:

    DGRAPH_TPU_FAILPOINTS="sched.flush=error(p=0.5,n=3);engine.hop=delay(ms=200)"
    DGRAPH_TPU_FAILPOINT_SEED=42

Actions:

- ``error(p=, n=, ms=)`` — raise :class:`FailpointError` (an ``OSError``
  subclass); optional ``ms`` sleeps first.
- ``delay(ms=, p=, n=)`` — sleep without failing.
- ``crash(ms=, p=, n=, after=)`` — ``os._exit`` the process, no cleanup.
- ``hang(ms=, p=, n=, after=)`` — sleep ``ms`` at the site: a wedged
  dispatch, not a slow one (functionally a delay).
- ``xla_oom(p=, n=, ms=, after=)`` — raise an out-of-memory error.  The
  reference raises an XLA ``RESOURCE_EXHAUSTED``; the port raises
  ``torch.cuda.OutOfMemoryError``, what the CUDA caching allocator
  raises on a real one.

``p`` is the trigger probability (default 1.0), ``n`` caps how many
times the action fires (default unlimited), ``after`` skips the first
N matching probes.  ``chip`` (error/xla_oom only) attributes the
injected fault to ONE mesh chip: the raised message carries ``chip=N``,
which the elastic mesh fault domain (mesh/fault.py, through
``devguard.chip_of``) reads to evict that chip and re-shard onto the
survivors — ``device.mesh=error(p=1,n=1,chip=3)`` kills chip 3 once.
Without ``chip`` the same site is a whole-plane fault: the level re-plans
unsharded.  All probability draws come from ONE seeded RNG
(``DGRAPH_TPU_FAILPOINT_SEED``, default 0), so a chaos run replays
bit-identically.  Triggers are counted per site in
``dgraph_failpoints_fired_total{site=...}`` and via :meth:`hits`.

Instrumented sites of the port: the cohort scheduler's flush
(``sched.flush``), the engine's per-level hop dispatch (``engine.hop``
— the cancellation-checkpoint seam; arm ``delay(ms=...)`` to stretch
it), the segment seam between hops of the fused hop loops
(``segment.seam``, sched/segments.py), and the device guard's
(utils/devguard.py): inside the guarded closures ``device.hop`` (a
per-level expansion), ``device.chain`` (a staged chain segment),
``device.multi_hop`` (a multi-hop segment) and ``device.spgemm`` (a
k-way step or a tile chain segment), where ``hang`` and ``xla_oom``
drive the watchdog and the OOM retry, and ``devguard.probe`` (the
re-admission probe); the mesh's (mesh/): ``device.mesh`` (inside every
mesh dispatch: a one-hop sharded expansion or a multi-hop segment),
``mesh.warm`` (a staged rejoin's warm, before its cutover) and
``mesh.chip.probe`` (a chip guard's re-admission probe).
"""

from __future__ import annotations

import os
import random
import re
import threading
import time
from typing import Dict, Optional


class FailpointError(OSError):
    """An injected fault.  OSError on purpose: resilience code must not
    be able to tell an injected failure from a real network one."""


_ACTION_RE = re.compile(r"^(error|delay|crash|hang|xla_oom)\s*(?:\((.*)\))?$")


def _oom_error(site: str) -> BaseException:
    """An injected device OOM, raised as the class the CUDA caching
    allocator raises (``torch.cuda.OutOfMemoryError``)."""
    import torch

    return torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 1.00 GiB "
        f"(failpoint {site!r} injected)"
    )


class _Action:
    __slots__ = ("kind", "p", "n", "ms", "after", "chip")

    def __init__(
        self,
        kind: str,
        p: float = 1.0,
        n: int = -1,
        ms: float = 0.0,
        after: int = 0,
        chip: int = -1,
    ):
        self.kind = kind
        self.p = p
        self.n = n          # remaining fires; -1 = unlimited
        self.ms = ms
        self.after = after  # remaining probes to let through untouched
        self.chip = chip    # -1 = un-attributed (whole-plane) fault

    @classmethod
    def parse(cls, spec: str) -> "_Action":
        m = _ACTION_RE.match(spec.strip())
        if not m:
            raise ValueError(f"bad failpoint action {spec!r}")
        kind, args = m.group(1), m.group(2) or ""
        kw: Dict[str, float] = {}
        for part in args.split(","):
            part = part.strip()
            if not part:
                continue
            k, _, v = part.partition("=")
            k = k.strip()
            if k not in ("p", "n", "ms", "after", "chip"):
                raise ValueError(f"bad failpoint param {k!r} in {spec!r}")
            kw[k] = float(v)
        chip = int(kw.get("chip", -1))
        if chip >= 0 and kind not in ("error", "xla_oom"):
            raise ValueError(
                f"chip= only attributes error/xla_oom, not {kind!r}"
            )
        return cls(
            kind,
            p=float(kw.get("p", 1.0)),
            n=int(kw.get("n", -1)),
            ms=float(kw.get("ms", 0.0)),
            after=int(kw.get("after", 0)),
            chip=chip,
        )


class Failpoints:
    """The registry.  One process-global instance (``fail``) is the
    normal entry point; tests may build private ones."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._armed: Dict[str, _Action] = {}
        self._hits: Dict[str, int] = {}
        self._rng = random.Random(seed)

    # -- configuration ------------------------------------------------------

    def seed(self, s: int) -> None:
        with self._lock:
            self._rng = random.Random(s)

    def arm(self, site: str, action: str) -> None:
        act = _Action.parse(action)
        with self._lock:
            self._armed[site] = act

    def disarm(self, site: str) -> None:
        with self._lock:
            self._armed.pop(site, None)

    def reset(self, seed: int = 0) -> None:
        """Disarm everything and reseed — test teardown."""
        with self._lock:
            self._armed.clear()
            self._hits.clear()
            self._rng = random.Random(seed)

    def configure(self, spec: str, seed: Optional[int] = None) -> None:
        """``site=action;site2=action`` (the env-var grammar)."""
        if seed is not None:
            self.seed(seed)
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            site, _, action = part.partition("=")
            if not action:
                raise ValueError(f"bad failpoint entry {part!r} (want site=action)")
            self.arm(site.strip(), action)

    # -- the probe ----------------------------------------------------------

    def point(self, site: str) -> None:
        """Fire the armed action for ``site``, if any.  The disarmed fast
        path is one dict-emptiness check — safe on every hot path."""
        if not self._armed:
            return
        with self._lock:
            act = self._armed.get(site)
            if act is None:
                return
            if act.n == 0:
                return
            if act.after > 0:
                act.after -= 1
                return
            if act.p < 1.0 and self._rng.random() >= act.p:
                return
            if act.n > 0:
                act.n -= 1
            self._hits[site] = self._hits.get(site, 0) + 1
            kind, ms, chip = act.kind, act.ms, act.chip
        from dgraph_tpu_torch.utils.metrics import FAILPOINTS_FIRED

        FAILPOINTS_FIRED.add(site)
        if ms > 0:
            time.sleep(ms / 1000.0)
        if kind == "crash":
            import sys

            print(f"# failpoint crash: {site}", file=sys.stderr, flush=True)
            os._exit(86)
        tag = f" (chip={chip})" if chip >= 0 else ""
        if kind == "error":
            raise FailpointError(
                f"failpoint {site!r} injected error{tag}"
            )
        if kind == "xla_oom":
            raise _oom_error(site + tag)

    def hits(self, site: str) -> int:
        with self._lock:
            return self._hits.get(site, 0)


fail = Failpoints(seed=int(os.environ.get("DGRAPH_TPU_FAILPOINT_SEED", "0")))

_env_spec = os.environ.get("DGRAPH_TPU_FAILPOINTS", "")
if _env_spec:
    fail.configure(_env_spec)
