// Grouped overflow slot-map for Hopper (sm_90a).
//
// Replaces the TPU kernel slotmap_pallas (dgraph_tpu/ops/pallas_slotmap.py,
// _kernel).  For each query q of a batch, with ccum the inclusive cumsum of
// cd[q, :pcap] and total = ccum[pcap - 1]:
//   out[q, i] = cs[q, j] + (i - (ccum[j] - cd[q, j]))   for i < total, where
//               row j owns slot i (the first row with ccum[j] > i);
//   out[q, i] = -1                                     for i >= total.
// The output silently truncates at capc.  It is the slot -> overflow-chunk
// map of the grouped inline expansion (ops/sets.py
// expand_inline_grouped_kernel).
//
// Bound: memory.  The function reads cs and cd once and writes out once,
// 4*Q*(2*pcap + capc) bytes; at the 2-hop pipeline's hop-2 shape (Q 200,
// pcap 16,384, capc 16,384) about 39 MB, ~12 us at 3.35 TB/s.
//
// Design.  The TPU kernel runs one query per sequential grid step in VMEM
// and leans on two facts of grouped frontiers (chunk starts strictly
// increasing over the productive prefix, cs - cstart non-decreasing) to
// replace the owner search by a prefix max plus a window max.  Here each
// query is one block (grid = Q) that carries its running total through a
// loop over tiles of kTile rows, so nothing crosses blocks: one launch, no
// scratch in device memory.  Per tile:
//   - stage: cd and cs of the next tile are copied into shared memory with
//     cp.async (16 bytes a copy where the row is 16-byte aligned) while this
//     tile is worked on (two buffers);
//   - scan: a block-wide inclusive scan of the tile's cd, in place (each
//     thread kPer rows, warp shuffles, one shared row of warp sums);
//   - emit: the tile's rows own the slots [carry, carry + tile total) of
//     [0, capc).  Each thread takes kRun consecutive slots, finds the owner
//     of the first by an upper-bound binary search of the scanned tile in
//     shared memory and walks forward to the owners of the rest (one
//     search per kRun slots, not one per slot), writes them into shared
//     memory, and the block stores each round of kThreads * kRun slots
//     coalesced.  Zero-cd rows never own a slot wherever they sit,
//     so the map is exact for any cd >= 0 in any row order (the ungrouped
//     layout sends such rows).
// Once the carry reaches capc the rest of the query cannot change the
// output and the block stops reading; -1 then fills [total, capc).  Each
// input entry is read from device memory at most once and each output slot
// written once.  kTile = 4096 rows take 64 KB of dynamic shared memory and
// the emit's round 16 KB of static, so two blocks fit on an SM and the
// pipeline's 200 queries are all resident at once on the 132 SMs.

#include <cstdint>
#include <cuda_runtime.h>

#include "device.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4096;             // rows of a query per tile
constexpr int kPer = kTile / kThreads;  // rows per thread in the scan: two int4
constexpr int kRun = 8;                 // consecutive slots per thread in the emit
constexpr int kSmemBytes = 2 * 2 * kTile * static_cast<int>(sizeof(int32_t));

__global__ void __launch_bounds__(kThreads, 2)
slotmap_tiles(const int32_t* __restrict__ cs, const int32_t* __restrict__ cd,
              int pcap, int capc, int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t smem[];  // [buffer][cd, cs][kTile]
  __shared__ int32_t warp_sums[kWarps];
  __shared__ int32_t obuf[kThreads * kRun];  // one round of the emit's output
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t q = blockIdx.x;
  const int32_t* cdq = cd + q * pcap;
  const int32_t* csq = cs + q * pcap;
  int32_t* o = out + q * capc;
  const int ntiles = (pcap + kTile - 1) / kTile;

  dgt::stage(smem, cdq, min(kTile, pcap), cdq);
  dgt::stage(smem + kTile, csq, min(kTile, pcap), csq);
  dgt::cp_async_commit();
  long long carry = 0;  // slots owned by the rows of earlier tiles
  for (int t = 0; t < ntiles && carry < capc; ++t) {
    int32_t* tcd = smem + (t & 1) * 2 * kTile;
    int32_t* tcs = tcd + kTile;
    const int n = min(kTile, pcap - t * kTile);
    if (t + 1 < ntiles) {
      int32_t* next = smem + ((t + 1) & 1) * 2 * kTile;
      const int nb = (t + 1) * kTile;
      const int nn = min(kTile, pcap - nb);
      dgt::stage(next, cdq + nb, nn, cdq + nb);
      dgt::stage(next + kTile, csq + nb, nn, csq + nb);
    }
    dgt::cp_async_commit();  // empty on the last tile: the wait below stays uniform
    dgt::cp_async_wait<1>();
    __syncthreads();

    // inclusive scan of tcd[0, n) in place; rows past n count 0
    const int r0 = threadIdx.x * kPer;
    int32_t v[kPer];
#pragma unroll
    for (int h = 0; h < kPer; h += 4) {
      const int4 x = *reinterpret_cast<const int4*>(tcd + r0 + h);
      v[h] = x.x;
      v[h + 1] = x.y;
      v[h + 2] = x.z;
      v[h + 3] = x.w;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (r0 + u >= n) v[u] = 0;
      if (u > 0) v[u] += v[u - 1];
    }
    const int32_t tsum = v[kPer - 1];
    const int32_t x = dgt::warp_inclusive_scan(tsum, lane);
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {
      const int32_t w = dgt::warp_inclusive_scan(lane < kWarps ? warp_sums[lane] : 0, lane);
      if (lane < kWarps) warp_sums[lane] = w;
    }
    __syncthreads();
    const int32_t off = x - tsum + (warp > 0 ? warp_sums[warp - 1] : 0);
#pragma unroll
    for (int h = 0; h < kPer; h += 4) {
      *reinterpret_cast<int4*>(tcd + r0 + h) =
          make_int4(v[h] + off, v[h + 1] + off, v[h + 2] + off, v[h + 3] + off);
    }
    const long long total = warp_sums[kWarps - 1];
    __syncthreads();

    // emit the slots this tile's rows own, local slot r belonging to the
    // first row j with tcd[j] > r and starting at tcd[j - 1] (0 for j = 0):
    // in rounds of kThreads * kRun slots, each thread takes kRun in a row,
    // searches for the owner of the first and walks to the rest, into
    // shared memory; then one coalesced store of the round
    const int tot = static_cast<int>(min(total, capc - carry));
    for (int rb = 0; rb < tot; rb += kThreads * kRun) {
      const int s0 = rb + threadIdx.x * kRun;
      if (s0 < tot) {
        int j = 0, hi = n - 1;
        while (j < hi) {
          const int mid = (j + hi) >> 1;
          if (tcd[mid] > s0) hi = mid; else j = mid + 1;
        }
        const int send = min(s0 + kRun, tot);
        for (int r = s0; r < send; ++r) {
          while (tcd[j] <= r) ++j;
          obuf[r - rb] = tcs[j] + (r - (j > 0 ? tcd[j - 1] : 0));
        }
      }
      __syncthreads();
      const int m = min(kThreads * kRun, tot - rb);
      for (int i = threadIdx.x; i < m; i += kThreads) o[carry + rb + i] = obuf[i];
      __syncthreads();
    }
    carry += total;
    __syncthreads();  // this buffer is restaged two tiles on
  }
  dgt::cp_async_wait<0>();  // a stop at capc leaves the next tile's copy in flight
  for (long long i = min(carry, static_cast<long long>(capc)) + threadIdx.x; i < capc;
       i += kThreads) {
    o[i] = -1;
  }
}

}  // namespace

// cs, cd: int32[q, pcap]; out: int32[q, capc]; stream: cudaStream_t.
// One launch on the stream; returns cudaGetLastError() after it.
extern "C" int slotmap(const void* cs, const void* cd, int q, int pcap, int capc,
                       void* out, void* stream) {
  if (q <= 0 || pcap <= 0 || capc <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB a block's dynamic shared memory must be asked for, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      slotmap_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  slotmap_tiles<<<q, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cs), static_cast<const int32_t*>(cd), pcap, capc,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
