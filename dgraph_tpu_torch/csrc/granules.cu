// Granule gather for Hopper (sm_90a): rows of 32 bytes by index.
//
//   out[k] = fill in all 8 lanes                  where idx[k] < 0 (the table is not read);
//   out[k] = table[min(idx[k], n_table - 1)]      otherwise,
// for table int32[n_table, 8] and idx int32[n], out int32[n, 8].  It is the
// metap gather (ops/sets.py _inline_gather) and the overflow-chunk gather of
// the inline expansions (ops/granules.py gather_granules).
//
// Replaces no Pallas kernel: the reference leaves these gathers to XLA.  It
// was added because PyTorch's index gather along dim 0
// (vectorized_gather_kernel) launches one thread block per index, and a
// 32-byte row keeps only 2 of its threads busy: the card then has only a few
// thousand 16-byte loads in flight, and the rate is set by how many blocks
// are resident and by the latency of two dependent loads (the index, then the
// row), not by bytes.  On an H100 it moved ~1.7-2.2 G rows/s on the batched
// 2-hop's hop 2: 70.7 ms for the 1024-root cell's 117,440,512 rows (3.76 GB
// written) against a bytes bound of 1.30 ms.
//
// Bound: bytes.  4 B of index read and 32 B written per row, plus 32 B read
// per row that is not filled; at 3.35 TB/s.  This kernel takes 1.70 ms at
// that shape (76 % of the bound) and 0.070 ms against 0.0625 at the 200-query
// cell's 3,276,800 rows (chip_smoke.py's granule_timing; H100 80GB HBM3, 700
// W).  ptxas (sm_90a): 32 registers, no shared memory, no spills.
//
// Design.  Many rows per block, two threads per row, each moving one 16-byte
// int4: a warp writes 16 rows, 512 contiguous bytes, so stores coalesce.  A
// thread takes kUnroll int4s of a tile, a block's width apart: it loads all
// their indices, then all their table halves through the read-only path
// (ld.global.nc.v4, skipped for filled rows), then stores them, so each
// thread keeps kUnroll loads in flight.  The grid is the number of blocks the
// card holds resident at once (the occupancy calculator times the SMs), or
// fewer for a short gather, and walks the tiles in a grid-stride loop: tens
// of thousands of loads in flight whatever the row count.  Offsets are 64-bit
// (hop 2's output of the 1024-root cell is 3.76 GB).  One launch on the
// caller's stream, no allocation, no synchronisation.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;                  // int4s a thread per tile, a block apart
constexpr int kTile = kThreads * kUnroll;   // int4s (half rows) a block per tile

__global__ void __launch_bounds__(kThreads)
granule_gather(const int4* __restrict__ table, int n_table,
               const int32_t* __restrict__ idx, long long halves, int32_t fill,
               int4* __restrict__ out) {
  const int4 filled = make_int4(fill, fill, fill, fill);
  const int half = threadIdx.x & 1;  // kThreads and kTile are even: h & 1 for every h
  const long long step = static_cast<long long>(gridDim.x) * kTile;
  for (long long base = static_cast<long long>(blockIdx.x) * kTile + threadIdx.x;
       base < halves; base += step) {
    int32_t r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long h = base + u * kThreads;
      r[u] = h < halves ? __ldg(idx + (h >> 1)) : -1;
    }
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      v[u] = filled;
      if (r[u] >= 0) {
        v[u] = __ldg(table + 2 * static_cast<long long>(min(r[u], n_table - 1)) + half);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long h = base + u * kThreads;
      if (h < halves) out[h] = v[u];
    }
  }
}

}  // namespace

// table: int32[n_table, 8], 16-byte aligned; idx: int32[rows]; out:
// int32[rows, 8]; stream: cudaStream_t.  One launch on the stream; returns
// cudaGetLastError() after it.
extern "C" int gather_granules(const void* table, int n_table, const void* idx,
                               long long rows, int fill, void* out, void* stream) {
  if (n_table <= 0 || rows <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // the blocks the card holds resident at once, asked once
  static const int resident = [] {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, granule_gather, kThreads, 0);
    return std::max(1, sms * per_sm);
  }();
  const long long halves = 2 * rows;
  const long long tiles = (halves + kTile - 1) / kTile;
  const int grid = static_cast<int>(std::min<long long>(tiles, resident));
  granule_gather<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(table), n_table, static_cast<const int32_t*>(idx), halves,
      static_cast<int32_t>(fill), static_cast<int4*>(out));
  return static_cast<int>(cudaGetLastError());
}
