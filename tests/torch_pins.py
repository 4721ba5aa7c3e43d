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

This lives beside ``tests/torch_cases.py``, not in it: that module is
loaded by ``chip_smoke.py`` on the card, where no JAX is installed, and
``tests/test_torch_isolation.py`` holds it free of any reference
import.  Where JAX is not installed (the card's machine) the fixture
pins the port's planner alone.
"""

import pytest

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


@pytest.fixture
def pinned_planner(monkeypatch):
    planners = _planners()
    if len(planners) == 2:
        # the reference prices a device its device guard holds sick out
        # of every route (its ``_device_factor``): start from healthy
        # guards, whatever an earlier file in this worker left behind
        import importlib

        importlib.import_module("dgraph_tpu.utils.devguard").reset_for_tests()
    for planner, _cal in planners:
        monkeypatch.setattr(planner, "_EWMA_ALPHA", 0.0)
    pin_both_planners()
    yield
    reset_both_planners()
