"""Planner pinning for the port's tests: one fixture that makes every
route decision of both packages' planners a function of the test alone.

Both planners (``dgraph_tpu.query.planner`` and
``dgraph_tpu_torch.query.planner``) keep process-wide state: the live
rate table that ``note_outcome`` refines from measured latencies, the
decision ring and the counts.  Under ``pytest -n N --dist loadfile`` a
worker runs many files one after the other, so without a reset a test's
routes would depend on how fast earlier files ran in the same worker.
``pinned_planner`` resets both planners, turns online refinement off
(``_EWMA_ALPHA`` 0 in both modules) and installs the same named
calibration (``pinned_calibration``: the shipped priors, tagged
``source="pinned"``) in both, before each
test; after it, both planners are reset to a fresh process's state.

A file uses it with
``pytestmark = pytest.mark.usefixtures("pinned_planner")`` and
``from torch_pins import pinned_planner  # noqa: F401``.

The same fixture pins the two other kinds of process-wide state the
port's serving path keeps: the device guards (``utils/devguard.py`` in
both packages: a sick latch left behind by one test would make every
later device route in the same worker raise) and the failpoints.  Before
and after each test it resets both packages' guards and disarms both
packages' failpoints; after it, it checks that no subscription notifier
(``dgraph-subs``) or device-guard probe loop started during the test
outlives it (a server a test forgot to stop).  The mesh fault domain's
state is all in those guards: its plane guard (``mesh``) and per-chip
guards (``mesh.chip<i>``) are dropped with the rest, their probe loops
(the staged rejoin runs on them) are among the threads checked, and its
placement plan lives on the server's arena manager, in memory unless
``DGRAPH_TPU_MESH_PLAN`` names a file, which the fixture unsets.

This lives beside ``tests/torch_cases.py``, not in it: that module is
loaded by ``chip_smoke.py`` on the card, where no JAX is installed, and
``tests/test_torch_isolation.py`` holds it free of any reference
import.  Where JAX is not installed (the card's machine) the fixture
pins the port's planner alone.

Before each test the fixture also points the port's RWLock and
hand-off instrumentation at the suite's armed witness
(``tests/torch_witness.py``).
"""

import pytest
from torch_witness import cover_port

PINNED_SOURCE = "pinned"


def pinned_calibration(calibrate_module):
    """The named calibration of ``calibrate_module`` (either package's
    ``utils.calibrate``): its priors, tagged ``source="pinned"``."""
    from dataclasses import replace

    return replace(
        calibrate_module.PRIORS, source=PINNED_SOURCE, backend="cpu"
    )


def _planners():
    """(planner, calibrate) module pairs: the port's, and the
    reference's where JAX is installed (the card's machine has none, and
    ``tests/test_torch_cuda.py`` runs there alone)."""
    import importlib
    import importlib.util

    names = [("dgraph_tpu_torch.query.planner", "dgraph_tpu_torch.utils.calibrate")]
    if importlib.util.find_spec("jax") is not None:
        names.insert(0, ("dgraph_tpu.query.planner", "dgraph_tpu.utils.calibrate"))
    return tuple(
        (importlib.import_module(p), importlib.import_module(c)) for p, c in names
    )


def pin_both_planners() -> None:
    """Reset both planners and install the named calibration in each."""
    for planner, cal in _planners():
        planner._reset_for_tests()
        planner.install_calibration(pinned_calibration(cal))


def reset_both_planners() -> None:
    for planner, _cal in _planners():
        planner._reset_for_tests()


def _guard_modules():
    """(devguard, failpoints) module pairs: the port's, and the
    reference's where JAX is installed."""
    import importlib
    import importlib.util

    pkgs = ["dgraph_tpu_torch"]
    if importlib.util.find_spec("jax") is not None:
        pkgs.insert(0, "dgraph_tpu")
    return tuple(
        (importlib.import_module(f"{p}.utils.devguard"),
         importlib.import_module(f"{p}.utils.failpoints"))
        for p in pkgs
    )


def reset_guards() -> None:
    """Both packages: fresh device guards, every failpoint disarmed."""
    for guard, fp in _guard_modules():
        fp.fail.reset()
        guard.reset_for_tests()


# threads that must not outlive the server or guard that started them:
# the notifier, and the probe loops of the device guard, the mesh plane
# guard and every mesh chip guard (``dgraph-devguard-mesh.chip<i>``)
_OWNED_THREADS = ("dgraph-subs", "dgraph-devguard-device", "dgraph-devguard-mesh")
_OWNED_PREFIXES = ("dgraph-devguard-mesh.chip",)


def _owned(name: str) -> bool:
    return name in _OWNED_THREADS or (
        name.startswith(_OWNED_PREFIXES) and not name.endswith("-worker")
    )


def _owned_threads() -> set:
    import threading

    return {t for t in threading.enumerate() if _owned(t.name)}


def check_no_leaked_threads(before: set, wait_s: float = 5.0) -> None:
    """Fail when a notifier or probe-loop thread started after
    ``before`` is still alive ``wait_s`` later."""
    import time

    deadline = time.monotonic() + wait_s
    while True:
        left = [t for t in _owned_threads() - before if t.is_alive()]
        if not left or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert not left, f"threads outlived their owner: {[t.name for t in left]}"


@pytest.fixture
def pinned_planner(monkeypatch):
    # the suite's witness covers the port's RWLock and hand-offs too
    # (tests/torch_witness.py)
    cover_port()
    planners = _planners()
    # the reference prices a device its device guard holds sick out of
    # every route (its ``_device_factor``), and the port raises on one:
    # start from healthy guards and no armed failpoint, whatever an
    # earlier file in this worker left behind
    reset_guards()
    monkeypatch.delenv("DGRAPH_TPU_MESH_PLAN", raising=False)
    threads = _owned_threads()
    for planner, _cal in planners:
        monkeypatch.setattr(planner, "_EWMA_ALPHA", 0.0)
    pin_both_planners()
    yield
    reset_both_planners()
    reset_guards()
    check_no_leaked_threads(threads)
