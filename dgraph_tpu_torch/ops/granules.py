"""The 32-byte granule gather: the CUDA kernel's wrapper and its plain
PyTorch version.

``gather_granules(table, idx, fill)`` gathers rows of 8 int32 lanes (32
bytes) by index: ``out[k] = table[min(idx[k], N - 1)]``, and ``fill`` in
all 8 lanes where ``idx[k] < 0``.  It is the metap gather of the inline
expansions (``ops.sets._inline_gather``, ``fill = SENT``) and their
overflow-chunk gather (``fill = SENT``).

Replaces no TPU kernel: the reference leaves these gathers to XLA.  On
the card PyTorch's index gather launches one thread block per index,
two of whose threads move a 32-byte row, so its rate is set by resident
blocks and load latency, not by bytes.  Bound: bytes, 4 B of index read
and 32 B written per row, plus 32 B read per row that is not filled; its
floor on an H100 is that over 3.35 TB/s.  The kernel (csrc/granules.cu)
is one launch: two threads a row, one 16-byte load each, many rows a
block, a grid of the blocks the card holds resident.

On a CUDA tensor :func:`gather_granules` launches the kernel or raises;
the plain version runs only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from dgraph_tpu_torch.ops._build import CudaKernel

KERNEL = CudaKernel(
    "granules", "gather_granules",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
)

LANES = 8  # int32 lanes of a row: 32 bytes
# table rows index int32 in the kernel, and fill is one int32
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _check(table: torch.Tensor, idx: torch.Tensor, fill: int) -> None:
    if (table.dtype != torch.int32 or table.dim() != 2
            or table.shape[1] != LANES or not table.is_contiguous()):
        raise ValueError("gather_granules: table must be a contiguous "
                         f"int32[N, {LANES}] tensor")
    if idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError("gather_granules: idx must be a contiguous int32 tensor")
    if table.device != idx.device:
        raise ValueError("gather_granules: table and idx must share a device")
    if not 0 < table.shape[0] <= _I32_MAX:
        raise ValueError(f"gather_granules: need 0 < N < 2^31 table rows, "
                         f"got {table.shape[0]}")
    if not _I32_MIN <= fill <= _I32_MAX:
        raise ValueError(f"gather_granules: fill {fill} is not an int32")


def gather_granules_plain(table: torch.Tensor, idx: torch.Tensor,
                          fill: int) -> torch.Tensor:
    """The kernel's function in torch ops: PyTorch's index gather over
    the clamped index, then ``fill`` where the index is negative."""
    rows = table[torch.where(idx >= 0, idx, 0).clamp(0, table.shape[0] - 1)]
    return torch.where(idx[..., None] >= 0, rows, fill)


def gather_granules(table: torch.Tensor, idx: torch.Tensor,
                    fill: int) -> torch.Tensor:
    """Rows of ``table`` by ``idx``, int32[*idx.shape, 8].

    Args:
      table: int32[N, 8], N > 0.
      idx:   int32[...] row indices; negative = ``fill``, at or past N =
             row N - 1.
      fill:  the int32 written to all 8 lanes of a negative index's row.
    """
    _check(table, idx, fill)
    if idx.device.type == "cpu":
        return gather_granules_plain(table, idx, fill)
    if idx.device.type != "cuda":
        raise ValueError(f"gather_granules: no kernel for device {idx.device}")
    if table.data_ptr() % 16:
        raise ValueError("gather_granules: table must be 16-byte aligned")
    out = torch.empty(idx.shape + (LANES,), dtype=torch.int32, device=idx.device)
    if idx.numel() == 0:
        return out
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    KERNEL.launch(table.data_ptr(), int(table.shape[0]), idx.data_ptr(),
                  int(idx.numel()), int(fill), out.data_ptr(), stream)
    return out
