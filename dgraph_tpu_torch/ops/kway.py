"""k-way sorted-set intersection: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``intersect_pallas`` (dgraph_tpu/ops/
pallas_intersect.py, ``_kernel``): the rows of a sorted-unique,
``SENT``-padded int32 matrix intersect to the entries of row 0 present
in every other row, ascending, ``SENT``-padded to the row width.  It is
the device route of ``query.joinplan.kway_intersect`` (the reference's
``spgemm.intersect_stack``): the engine's ``@filter`` AND, term ``eq``
over several tokens, ``allofterms`` / ``alloftext`` and the trigram AND
of ``regexp``.

Bound: memory.  The function must read each row's valid (non-``SENT``)
entries once and write the ``L`` output lanes once: 4·(Σ valid + B·L)
bytes over 3.35 TB/s on an H100.  The padding need not be read (a row's
end is a log-L search away).  The kernel (csrc/intersect.cu) is one
launch after one memset of its scratch: each block takes a tile of row
0, copies the range of each other row its candidates can meet into
shared memory (those that fit; it searches the others in device memory),
looks the candidates up there, writes SENT over its own output lanes,
and places its survivors after a decoupled look-back over the earlier
tiles' counts; no sort.

On a CUDA tensor :func:`intersect_batch` launches the kernel or raises;
the plain version runs only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from dgraph_tpu_torch.ops._build import CudaKernel
from dgraph_tpu_torch.ops.sets import SENT

KMAX = 8  # intersect_pallas's static lane budget (its twin checks it)

KERNEL = CudaKernel(
    "intersect", "intersect",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p],
)

TILE = 1024          # row-0 lanes per tile: csrc/intersect.cu's kTile
_MAX_L = 1 << 30     # lanes index int32 in the kernel
_MAX_BLOCKS = (1 << 31) - 1  # the kernel's grid: B · ceil(L / TILE) blocks on x


def _check(mat: torch.Tensor) -> None:
    if mat.dtype != torch.int32 or mat.dim() != 3 or not mat.is_contiguous():
        raise ValueError("intersect: mat must be a contiguous 3-D int32 tensor")
    b, k, length = mat.shape
    if b < 1 or k < 1 or not 0 < length < _MAX_L:
        raise ValueError(f"intersect: need B >= 1, K >= 1 and 0 < L < 2^30, "
                         f"got {tuple(mat.shape)}")


def intersect_plain(mat: torch.Tensor) -> torch.Tensor:
    """The reference's arithmetic in torch ops, ``[K, L] → [L]`` or
    ``[B, K, L] → [B, L]``: membership of row 0 in each other row by one
    batched ``searchsorted``, ``where``, then one sort."""
    a0 = mat[..., 0, :]
    keep = a0 != SENT
    if mat.shape[-2] > 1:
        rows = mat[..., 1:, :]
        probe = a0.unsqueeze(-2).expand(rows.shape).contiguous()
        pos = torch.searchsorted(rows.contiguous(), probe, out_int32=True)
        pos = pos.clamp(max=mat.shape[-1] - 1).to(torch.int64)
        keep = keep & (rows.gather(-1, pos) == probe).all(-2)
    return torch.sort(torch.where(keep, a0, SENT), dim=-1).values


def intersect_batch(mat: torch.Tensor) -> torch.Tensor:
    """B independent k-way intersections, int32[B, K, L] → int32[B, L];
    any B >= 1 and K >= 1 (on the card, B · ceil(L / 1024) < 2^31)."""
    _check(mat)
    if mat.device.type == "cpu":
        return intersect_plain(mat)
    if mat.device.type != "cuda":
        raise ValueError(f"intersect: no kernel for device {mat.device}")
    b, k, length = mat.shape
    ntiles = -(-length // TILE)
    if b * ntiles > _MAX_BLOCKS:
        raise ValueError(f"intersect: B · ceil(L / {TILE}) must be < 2^31 "
                         f"blocks, got {tuple(mat.shape)}")
    # a status word per tile of each batch row, then a tile counter per row
    scratch = torch.empty(b * (ntiles + 1), dtype=torch.int64, device=mat.device)
    out = torch.empty((b, length), dtype=torch.int32, device=mat.device)
    stream = torch.cuda.current_stream(mat.device).cuda_stream
    KERNEL.launch(
        mat.data_ptr(), int(b), int(k), int(length), scratch.data_ptr(),
        scratch.numel(), out.data_ptr(), stream,
    )
    return out


def intersect_kernel(mat: torch.Tensor) -> torch.Tensor:
    """The twin of ``intersect_pallas``: the K rows of an int32[K, L]
    matrix, K <= KMAX, intersected to int32[L]."""
    if mat.dim() != 2:
        raise ValueError("intersect_kernel: mat must be 2-D [K, L]")
    k = mat.shape[0]
    if not 1 <= k <= KMAX:
        raise ValueError(f"k={k} exceeds the {KMAX}-lane kernel budget")
    return intersect_batch(mat.unsqueeze(0))[0]
