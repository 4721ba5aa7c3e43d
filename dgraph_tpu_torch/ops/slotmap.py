"""Grouped overflow slot-map: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces the TPU kernel ``slotmap_pallas`` (dgraph_tpu/ops/
pallas_slotmap.py, ``_kernel``): for each query of a batch, slot ``i`` of
the overflow-chunk output maps to ``cs[j] + (i - cstart[j])`` for the row
``j`` that owns it (``cstart`` the exclusive cumsum of ``cd``), and to -1
at or beyond the query's total; the map truncates at ``capc``.  It is the
slot-map of ``ops.sets.expand_inline_grouped_kernel``, run twice per
batch by the 2-hop pipeline (``bench2hop.py``).

Bound: memory.  The function reads cs and cd once and writes the map
once, 4·Q·(2·pcap + capc) bytes; its floor on an H100 is that over
3.35 TB/s.  The kernel (csrc/slotmap.cu) is one launch with no scratch:
one block per query walks its rows in shared-memory tiles (cp.async,
double-buffered), scans each tile in place and writes the slots the
tile's rows own, so each input entry is read once and each slot written
once.

On a CUDA tensor :func:`slotmap` launches the kernel or raises; the plain
version runs only for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from dgraph_tpu_torch.ops._build import CudaKernel

KERNEL = CudaKernel(
    "slotmap", "slotmap",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p],
)

_MAX_Q = (1 << 31) - 1  # one block per query on the grid's x axis
_MAX_CAP = 1 << 30      # rows and slots index int32 in the kernel


def _check(cs: torch.Tensor, cd: torch.Tensor, capc: int) -> None:
    for name, t in (("cs", cs), ("cd", cd)):
        if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"slotmap: {name} must be a contiguous 2-D int32 tensor")
    if cs.shape != cd.shape or cs.device != cd.device:
        raise ValueError("slotmap: cs and cd must share a shape and a device")
    q, pcap = cs.shape
    if not 0 < q <= _MAX_Q or not 0 < pcap < _MAX_CAP:
        raise ValueError(f"slotmap: need 0 < Q < 2^31 and 0 < pcap < 2^30, "
                         f"got {tuple(cs.shape)}")
    if not 0 < capc < _MAX_CAP:
        raise ValueError(f"slotmap: capc must be in (0, 2^30), got {capc}")


def slotmap_plain(cs: torch.Tensor, cd: torch.Tensor, capc: int) -> torch.Tensor:
    """The kernel's arithmetic in torch ops: per slot, the owning row by
    ``searchsorted`` over the inclusive cumsum of ``cd``."""
    q, pcap = cs.shape
    ccum = torch.cumsum(cd, 1, dtype=torch.int32)
    i = torch.arange(capc, dtype=torch.int32, device=cs.device).expand(q, capc)
    j = torch.searchsorted(ccum, i.contiguous(), right=True, out_int32=True)
    j = j.clamp(max=pcap - 1).to(torch.int64)
    cid = cs.gather(1, j) + i - (ccum.gather(1, j) - cd.gather(1, j))
    return torch.where(i < ccum[:, -1:], cid, -1)


def slotmap(cs: torch.Tensor, cd: torch.Tensor, capc: int) -> torch.Tensor:
    """Batched grouped slot-map, int32[Q, capc].

    Args:
      cs: int32[Q, pcap] first overflow chunk of each prefix row.
      cd: int32[Q, pcap] overflow chunk count of each prefix row (>= 0).
      capc: output capacity (overflow chunks per query).
    """
    _check(cs, cd, capc)
    if cs.device.type == "cpu":
        return slotmap_plain(cs, cd, capc)
    if cs.device.type != "cuda":
        raise ValueError(f"slotmap: no kernel for device {cs.device}")
    q, pcap = cs.shape
    out = torch.empty((q, capc), dtype=torch.int32, device=cs.device)
    stream = torch.cuda.current_stream(cs.device).cuda_stream
    KERNEL.launch(cs.data_ptr(), cd.data_ptr(), int(q), int(pcap), int(capc),
                  out.data_ptr(), stream)
    return out
