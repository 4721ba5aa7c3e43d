"""Sorted-set ops over int32 uid tensors and the resident-CSR gather
kernel (the PyTorch counterpart of ``dgraph_tpu.ops``, for the subset
the 2-hop query path calls)."""

from dgraph_tpu_torch.ops.sets import (  # noqa: F401
    SENT,
    bucket,
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
)
from dgraph_tpu_torch.ops.gather import (  # noqa: F401
    gather_packed,
    gather_packed_plain,
)
