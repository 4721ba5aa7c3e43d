"""Cluster layer of the port (copy of ``dgraph_tpu/cluster/``):
predicate sharding, membership, UID leasing, consensus.

The restructuring of upstream Dgraph's group/ + worker/groups.go +
worker/lease.go + worker/draft.go: predicates shard to groups (hosts); a
single metadata group (group 0) owns membership and the UID lease;
replication is a Raft log per group feeding each replica's store.  A
clustered server's engine reads a ``ClusterStore`` (``service.py``) and
builds its device arenas from that store's per-predicate snapshot
copies, so cluster reads run the same gather and intersect kernels as a
single node's.  Raft frames travel over HTTP(S) or, with
``raft_transport="grpc"``, over the gRPC Worker plane; ``https://``
peers are verified under ``transport.PeerAuth``.
"""

from dgraph_tpu_torch.cluster.groups import GroupConfig, fingerprint64
from dgraph_tpu_torch.cluster.lease import LeaseManager

__all__ = ["GroupConfig", "fingerprint64", "LeaseManager"]
