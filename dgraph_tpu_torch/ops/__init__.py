"""Sorted-set ops over int32 uid tensors, the chunked and inline-head
expansions and the port's hand-written kernels (the PyTorch counterpart
of ``dgraph_tpu.ops``).  The slot-map kernel's wrapper lives in
``ops.slotmap`` (``slotmap``, ``slotmap_plain``, ``KERNEL``), the
intersect kernel's in ``ops.kway`` (its ``KERNEL`` counts launches),
exported here as ``kway_intersect_batch``.  The segmented order-by
(``gather_ranks``, ``segmented_sort_perm``) is plain torch ops.
``ops.batch`` holds the reference's batched set ops (``intersect_batch``
here is the rowwise pairwise intersection, as in the reference),
``expand_filter_compact``, the degree-classed hop plans
(``ClassedExpander``, ``classed_for_arena``), and ``expand_ascending``
and ``multi_hop``, which walk hops through the gather.
The tile join tier (``ops.spgemm``: blocked boolean tile products over
a predicate's adjacency, the mask chain and the triangle) is torch ops
on the card, as the reference leaves it to XLA."""

from dgraph_tpu_torch.ops.sets import (  # noqa: F401
    SENT,
    INLINE,
    CHUNK,
    GROUP_BIT,
    GROUP_MASK,
    bucket,
    bucket_fine,
    pad_to,
    pad_rows,
    sort_unique,
    sort_desc_free,
    compact,
    count_valid,
    member_mask,
    intersect,
    difference,
    union,
    intersect_many,
    union_many,
    mask_to_set,
    unique_dense,
    unique_rows_sorted,
    range_rows,
    rows_of,
    expand_csr,
    expand_chunked,
    skey_encode,
    skey_uid,
    frontier_rows,
    expand_inline,
    expand_inline_grouped,
    expand_inline_grouped_kernel,
    expand_inline_grouped_auto,
    expand_inline_seg,
)
from dgraph_tpu_torch.ops.gather import (  # noqa: F401
    gather_packed,
    gather_packed_plain,
)
from dgraph_tpu_torch.ops.kway import (  # noqa: F401
    KMAX,
    intersect_batch as kway_intersect_batch,
    intersect_kernel,
    intersect_plain,
)
from dgraph_tpu_torch.ops.order import (  # noqa: F401
    gather_ranks,
    segmented_sort_perm,
)
from dgraph_tpu_torch.ops.batch import (  # noqa: F401
    ClassedExpander,
    classed_for_arena,
    difference_batch,
    expand_ascending,
    expand_filter_compact,
    expand_filter_compact_batch,
    intersect_batch,
    member_mask_batch,
    multi_hop,
    sort_unique_batch,
    union_many_batch,
)
from dgraph_tpu_torch.ops.spgemm import (  # noqa: F401
    PredTiles,
    apply_tile_delta,
    build_tiles,
    count_tile_blocks,
    est_tile_bytes,
    expand_counts,
    expand_mask,
    expand_mask_batch,
    intersect_masks,
    intersect_stack,
    intersect_stack_batch,
    mask_lanes,
    mask_to_uids,
    run_mask_chain,
    tile_budget,
    tile_size,
    triangle_mask,
    triangle_mask_batch,
    uids_to_mask,
)


def bind_kernels(device) -> None:
    """Build (one ``nvcc`` per source, all started together) and bind
    every hand-written kernel before the first guarded dispatch on
    ``device``: a first-use build inside the device guard's watchdog
    (utils/devguard.py) would be timed as a hang.  A no-op off CUDA.
    ``ArenaManager`` calls it when it is built for a CUDA device."""
    import torch

    if torch.device(device).type != "cuda":
        return
    from dgraph_tpu_torch.ops import _build, gather, kway, slotmap

    kernels = (gather.KERNEL, kway.KERNEL, slotmap.KERNEL)
    _build.build(k.source for k in kernels)
    for k in kernels:
        k._bind()
