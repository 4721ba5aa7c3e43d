"""The port's part of the suite's lock-order and lockset witness.

``tests/conftest.py`` arms the reference's witness
(``dgraph_tpu.analysis.witness.arm``) for the whole run.  Its arm wraps
the lock constructors of every module whose name starts with
``dgraph_tpu`` — the port's too — and its race pass instruments every
such class that declares ``__race_fields__``, the port's nine among
them.  What it does not know are the port's own RWLock and the port's
hand-off points: ``dgraph_tpu_torch.obs.ledger.activate`` / ``finish``
and ``dgraph_tpu_torch.sched.cohort.SchedRequest.complete`` / ``fail``.
Without those hand-offs the pooled ledger's owner changes would read as
races.  :func:`cover_port` applies the port's RWLock and hand-off
instrumentation (``dgraph_tpu_torch.analysis.witness``) to the armed
witness, through its ``note_acquire`` / ``note_release`` /
``reset_fields`` methods; ``tests/torch_pins.py``'s ``pinned_planner``
fixture, which every port test file uses, calls it before each test.

Idempotent and cheap.  Where JAX is not installed (the card's machine)
or no witness is armed (``DGRAPH_TPU_WITNESS=0``, ``--noconftest``) the
instrumentation reports to nothing.
"""

import importlib.util


def cover_port() -> None:
    """Point the port's RWLock and hand-off instrumentation at the
    reference's armed witness."""
    if importlib.util.find_spec("jax") is None:
        return
    from dgraph_tpu.analysis import witness as ref
    from dgraph_tpu_torch.analysis import witness as port

    port.instrument_rwlock(ref.current)
    if ref.races_enabled():
        port.instrument_handoffs(ref.current)
