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
// Design.  The TPU kernel runs one query per sequential grid step in VMEM
// and leans on two facts of grouped frontiers (chunk starts strictly
// increasing over the productive prefix, cs - cstart non-decreasing) to
// replace the owner search by a prefix max plus a 128x128 window max per
// block.  CUDA blocks run in no order and share nothing, so the port is two
// launches behind one entry point, both on the caller's stream:
//   (a) slotmap_scan: one block per query; 1024 threads walk cd[q] in tiles
//       of 1024 (coalesced loads), each tile a block-wide inclusive scan
//       (warp shuffles, then one shared row of warp sums) plus a carried
//       running total; writes the scratch ccum[q].
//   (b) slotmap_map: grid (ceil(capc / 256), Q), one thread per output
//       slot: an upper-bound binary search over ccum[q] finds the owner, so
//       zero-cd rows never own a slot wherever they sit, and truncation at
//       capc is the grid bound.  Nothing depends on the order of cs: the
//       map is exact for any cd >= 0, grouped or not.
//
// Bound.  Memory: the function reads cs and cd once and writes out once,
// 4*Q*(2*pcap + capc) bytes; the kernel adds the scratch round trip
// (ccum written by (a), read by (b)'s searches: 8*Q*pcap more, at most,
// since the searched rows stay in the 50 MB L2 at the pipeline's shapes).
// At the 2-hop pipeline's hop-2 shape (Q 200, pcap 16,384, capc 16,384)
// the function's bound is about 39 MB over 3.35 TB/s, ~12 us.  Fusing (a)
// into (b) with a decoupled look-back scan, and a warp-cooperative search,
// are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kScanThreads = 1024;  // 32 warps: one warp scans the warp sums
constexpr int kMapThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int32_t warp_inclusive_scan(int32_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

__global__ void __launch_bounds__(kScanThreads)
slotmap_scan(const int32_t* __restrict__ cd, int pcap,
             int32_t* __restrict__ ccum) {
  __shared__ int32_t warp_sums[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = static_cast<size_t>(blockIdx.x) * pcap;
  int32_t carry = 0;
  for (int base = 0; base < pcap; base += kScanThreads) {
    const int idx = base + threadIdx.x;
    int32_t v = idx < pcap ? cd[row + idx] : 0;
    v = warp_inclusive_scan(v, lane);
    if (lane == 31) warp_sums[warp] = v;
    __syncthreads();
    if (warp == 0) warp_sums[lane] = warp_inclusive_scan(warp_sums[lane], lane);
    __syncthreads();
    if (warp > 0) v += warp_sums[warp - 1];
    if (idx < pcap) ccum[row + idx] = carry + v;
    carry += warp_sums[kScanThreads / 32 - 1];  // this tile's total
    __syncthreads();  // warp_sums is rewritten by the next tile
  }
}

__global__ void __launch_bounds__(kMapThreads)
slotmap_map(const int32_t* __restrict__ cs, const int32_t* __restrict__ cd,
            const int32_t* __restrict__ ccum, int pcap, int capc,
            int32_t* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * kMapThreads + threadIdx.x;
  if (i >= capc) return;
  const size_t q = blockIdx.y;
  const int32_t* c = ccum + q * pcap;
  int32_t v = -1;
  if (i < c[pcap - 1]) {
    int lo = 0, hi = pcap - 1;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (c[mid] > i) hi = mid; else lo = mid + 1;
    }
    const size_t k = q * pcap + lo;
    v = cs[k] + (static_cast<int32_t>(i) - (c[lo] - cd[k]));
  }
  out[q * capc + i] = v;
}

}  // namespace

// cs, cd: int32[q, pcap]; ccum: int32[q, pcap] scratch; out: int32[q, capc];
// stream: cudaStream_t.  Returns cudaGetLastError() after the launches.
extern "C" int slotmap(const void* cs, const void* cd, void* ccum, int q,
                       int pcap, int capc, void* out, void* stream) {
  if (q <= 0 || q > 65535 || pcap <= 0 || capc <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  slotmap_scan<<<q, kScanThreads, 0, s>>>(static_cast<const int32_t*>(cd),
                                          pcap, static_cast<int32_t*>(ccum));
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((capc + kMapThreads - 1) / kMapThreads, q);
  slotmap_map<<<grid, kMapThreads, 0, s>>>(
      static_cast<const int32_t*>(cs), static_cast<const int32_t*>(cd),
      static_cast<const int32_t*>(ccum), pcap, capc,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
