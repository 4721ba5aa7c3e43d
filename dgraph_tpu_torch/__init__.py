"""dgraph_tpu_torch — the PyTorch/CUDA port of dgraph_tpu.

The same GraphQL± engine over the same host posting store, with the
device tier rebuilt on PyTorch tensors and hand-written CUDA kernels for
NVIDIA Hopper.  Module paths mirror ``dgraph_tpu`` so each piece has a
named counterpart:

- ``ops``     sorted-set ops on int32 uid tensors, the inline-head
              expansions, and the kernels: the resident-CSR gather
              (``csrc/gather.cu``), the grouped slot-map
              (``csrc/slotmap.cu``) and the k-way intersection
              (``csrc/intersect.cu``).
- ``models``  host posting store, schema, value types and the
              device-resident CSR arenas with their inline layouts.
- ``bench2hop``  the batched 2-hop pipeline with on-device dedup
              (``python -m dgraph_tpu_torch.bench2hop``).
- ``gql``, ``rdf``, ``tok``  query parser, N-Quad parser, tokenizers
              (host copies).
- ``query``   level-batched traversal engine and JSON encoding.
- ``sched``   the cohort scheduler (concurrent reads in cohorts, their
              same-predicate hops merged into one launch), segment seams
              and multi-tenant QoS.
- ``cache``, ``ivm``  the result and hop caches, keyed by per-predicate
              store versions.
- ``obs``     the flight recorder (sampled spans with the device wait of
              each hop, the trace ring, slow queries), the per-request
              ledger and the device snapshot.
- ``serve``   mutations and the HTTP ``/query`` surface.
- ``cli``     ``python -m dgraph_tpu_torch.cli.server``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see ``device.py``).  The package imports neither ``jax`` nor anything
of ``dgraph_tpu``.
"""

__version__ = "0.1.0"
