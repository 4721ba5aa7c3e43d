"""Resident-CSR frontier gather: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``gather_pallas_packed`` (dgraph_tpu/ops/
pallas_gather.py, ``_kernel``): the hop primitive of the device-resident
tier, walking a ResidentArena's (offsets, dst) buffers directly.  The
output is the engine's packed layout ``concat([out, seg])`` (int32[2·cap]),
byte-identical to ``expand_csr`` on the same inputs.

Bound: memory.  The function must move 4·B + 8·(live rows) +
4·min(total, cap) + 8·cap bytes (the frontier, two offsets per live row,
each placed target once, the packed output once), so its floor on an
H100 is that over 3.35 TB/s.  On a CUDA tensor :func:`gather_packed`
makes one allocation (the output with the kernel's scratch behind it)
and one cooperative launch of ``csrc/gather.cu``, which computes the
degrees, their int32 cumsum and the expansion itself; no torch op, no
memset and no host sync.  TMA bulk copies of long spans are later work.

On a CUDA tensor :func:`gather_packed` launches the kernel or raises; the
plain version runs only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from dgraph_tpu_torch.ops._build import CudaKernel
from dgraph_tpu_torch.ops.sets import SENT

KERNEL = CudaKernel(
    "gather", "gather_packed",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
)

_MAX_CAP = 1 << 30  # 2·cap must index an int32 output in the kernel
_MAX_B = 1 << 30    # the kernel indexes rows and its scratch in int32
# scratch words behind the output: a block-local degree cumsum and a span
# start per row, then one sum per block (csrc/gather.cu kMaxGrid blocks)
MAX_GRID = 2048


def _prolog(offsets: torch.Tensor, rows: torch.Tensor):
    """The plain version's O(B) frontier math: per-row degree, inclusive
    degree cumsum, span start (all int32).  The kernel computes the same
    inside its launch."""
    valid = rows >= 0
    r = torch.where(valid, rows, 0)
    lo = offsets[r]
    deg = torch.where(valid, offsets[r + 1] - lo, 0)
    cum = torch.cumsum(deg, 0, dtype=torch.int32)
    sstart = torch.where(valid, lo, 0)
    return deg, cum, sstart


def _check(offsets, dst, rows, cap: int) -> None:
    for name, t in (("offsets", offsets), ("dst", dst), ("rows", rows)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"gather: {name} must be a contiguous 1-D int32 tensor")
        if t.device != offsets.device:
            raise ValueError("gather: offsets, dst and rows must share a device")
    if rows.shape[0] == 0 or offsets.shape[0] == 0:
        raise ValueError("gather: rows and offsets must be non-empty")
    if not 0 < cap < _MAX_CAP:
        raise ValueError(f"gather: cap must be in (0, 2^30), got {cap}")


def gather_packed_plain(
    offsets: torch.Tensor, dst: torch.Tensor, rows: torch.Tensor, cap: int
) -> torch.Tensor:
    """The kernel's arithmetic in torch ops: per output slot, the owning
    row by ``searchsorted`` over the degree cumsum, then one gather."""
    dev = offsets.device
    if dst.shape[0] == 0:
        return torch.cat([
            torch.full((cap,), SENT, dtype=torch.int32, device=dev),
            torch.full((cap,), -1, dtype=torch.int32, device=dev),
        ])
    deg, cum, sstart = _prolog(offsets, rows)
    i = torch.arange(cap, dtype=torch.int32, device=dev)
    j = torch.searchsorted(cum, i, right=True, out_int32=True).clamp(
        max=rows.shape[0] - 1
    )
    edge = sstart[j] + i - (cum[j] - deg[j])
    ok = i < cum[-1]
    out = torch.where(ok, dst[edge.clamp(0, dst.shape[0] - 1)], SENT)
    return torch.cat([out, torch.where(ok, j, -1)])


def gather_packed(
    offsets: torch.Tensor, dst: torch.Tensor, rows: torch.Tensor, cap: int
) -> torch.Tensor:
    """Packed frontier expansion ``concat([out, seg])``, int32[2·cap].

    Args:
      offsets: int32[Sb+1] CSR row offsets (padding rows degree 0).
      dst:     int32 packed target uids (a ResidentArena buffer).
      rows:    int32[B] arena row indices, negative = skip.
      cap:     output capacity (bucketed total degree).
    """
    _check(offsets, dst, rows, cap)
    if offsets.device.type == "cpu":
        return gather_packed_plain(offsets, dst, rows, cap)
    if offsets.device.type != "cuda":
        raise ValueError(f"gather: no kernel for device {offsets.device}")
    b = int(rows.shape[0])
    if b >= _MAX_B:
        raise ValueError(f"gather: the kernel takes B < 2^30, got {b}")
    buf = torch.empty(2 * cap + 2 * b + MAX_GRID, dtype=torch.int32,
                      device=offsets.device)
    stream = torch.cuda.current_stream(offsets.device).cuda_stream
    KERNEL.launch(
        offsets.data_ptr(), dst.data_ptr(), rows.data_ptr(), b, int(cap),
        buf.data_ptr(), buf.numel(), stream,
    )
    return buf[: 2 * cap]
