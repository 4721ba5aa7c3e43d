"""Mesh serving plane: one server driving every chip of a mesh (the
PyTorch counterpart of ``dgraph_tpu.mesh``).

``parallel/mesh.py`` holds the sharded steps — row sharding, the packed
cross-chip reassembly.  This package makes them a serving backend:

- :mod:`dgraph_tpu_torch.mesh.plan` — ``MeshPlan``: predicate→shard
  placement (which chip holds a predicate's shard 0), persisted and
  rebalance-aware, so co-resident predicates do not all pile their
  heaviest row shard on one chip.
- :mod:`dgraph_tpu_torch.mesh.programs` — the multi-hop mesh program
  whose frontier exchange stays on the devices between hops.
- :mod:`dgraph_tpu_torch.mesh.executor` — ``MeshExecutor``: the
  engine-facing entry points (one-hop expand, fused multi-hop) behind
  the planner-priced ``route: mesh``, bracketed by the ``"mesh"`` device
  guard and charged to the request's ledger.
- :mod:`dgraph_tpu_torch.mesh.fault` — ``MeshFaultDomain``: chip loss as
  a capacity event — per-chip guards, epoch-fenced re-sharding onto the
  survivors, drain-and-resume of in-flight segmented queries, and the
  warm-then-cutover rejoin of healed chips.

A mesh's chips may be distinct cards or virtual chips of one card
(``make_mesh(devices=[cuda:0] * 4)``): the code path is the same.
``DGRAPH_TPU_MESH`` (serve/server.py ``_auto_mesh``): "0"/"off" never,
"1"/"auto"/unset on when more than one card is visible, "force" always
(a 1-wide mesh over ``cuda:0`` on one card).
``DGRAPH_TPU_MESH_ELASTIC=0`` keeps the mesh but latches the whole plane
on any fault.
"""

from dgraph_tpu_torch.mesh.executor import MeshExecutor
from dgraph_tpu_torch.mesh.fault import MeshFaultDomain
from dgraph_tpu_torch.mesh.plan import MeshPlan

__all__ = ["MeshExecutor", "MeshFaultDomain", "MeshPlan"]
