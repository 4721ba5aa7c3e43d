"""Mesh sharding and multi-device execution (the PyTorch counterpart of
``dgraph_tpu.parallel``).

Arenas shard by uid range across the devices of a mesh — the
intra-predicate sharding upstream Dgraph lacks (SURVEY.md §5) — and
frontier expansion runs per shard with the combine done by copies to a
receiving device.  The devices may be distinct cards or virtual chips
of one card (``make_mesh(devices=[cuda:0] * 4)``); ``crossover`` models
when sharding pays.
"""

from dgraph_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    ShardedArena,
    batched_expand_frontiers,
    make_mesh,
    predicate_shard,
    seg_expand_packed_step,
    shard_arena_rows,
    shard_tiles,
    tile_expand_step,
    sharded_expand_segments,
    sharded_two_hop,
)
