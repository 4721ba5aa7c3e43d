"""Sorted-set ops over int32 uid tensors, the inline-head expansions and
the port's hand-written kernels (the PyTorch counterpart of
``dgraph_tpu.ops``, for the subset the 2-hop query path and the batched
2-hop pipeline call, and the k-way intersection of the join path).  The
slot-map kernel's wrapper lives in ``ops.slotmap`` (``slotmap``,
``slotmap_plain``, ``KERNEL``), the intersect kernel's in ``ops.kway``
(its ``KERNEL`` counts launches).  The segmented order-by
(``gather_ranks``, ``segmented_sort_perm``) is plain torch ops.
``expand_ascending`` and ``multi_hop`` (``ops.batch``) walk hops through
the gather; the reference's batched set ops of ``ops.batch`` are not
ported, and ``intersect_batch`` here is the k-way intersect wrapper."""

from dgraph_tpu_torch.ops.sets import (  # noqa: F401
    SENT,
    INLINE,
    GROUP_BIT,
    GROUP_MASK,
    bucket,
    bucket_fine,
    pad_to,
    pad_rows,
    sort_unique,
    count_valid,
    member_mask,
    intersect,
    difference,
    union,
    intersect_many,
    union_many,
    rows_of,
    expand_csr,
    skey_encode,
    skey_uid,
    frontier_rows,
    expand_inline,
    expand_inline_grouped,
    expand_inline_grouped_kernel,
)
from dgraph_tpu_torch.ops.gather import (  # noqa: F401
    gather_packed,
    gather_packed_plain,
)
from dgraph_tpu_torch.ops.kway import (  # noqa: F401
    KMAX,
    intersect_batch,
    intersect_kernel,
    intersect_plain,
)
from dgraph_tpu_torch.ops.order import (  # noqa: F401
    gather_ranks,
    segmented_sort_perm,
)
from dgraph_tpu_torch.ops.batch import (  # noqa: F401
    expand_ascending,
    multi_hop,
)
