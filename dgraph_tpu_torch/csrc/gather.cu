// Resident-CSR frontier gather for Hopper (sm_90a): the whole call in one
// cooperative launch.
//
// Replaces the TPU kernel gather_pallas / gather_pallas_packed
// (dgraph_tpu/ops/pallas_gather.py, _kernel at :48).  Same contract as
// expand_csr: each frontier row rows[j] >= 0 copies its posting span
// dst[offsets[r] : offsets[r+1]] to its exclusive-cumsum slot and tags it
// seg = j; zero-degree and skipped rows own no slot; slots >= total hold
// SENT / -1; the output silently truncates at cap; the degrees sum in
// int32.  The result is packed: out[0:cap] = targets, out[cap:2cap] = seg.
//
// Bound: memory.  The function must read the frontier (4*B bytes), two
// offsets per live row (8 per live row), each target it places once (4 *
// min(total, cap)) and write the packed output once (8*cap): at the main
// path's largest shape as chip_smoke.py times it (B 65,536, cap 524,288,
// 345,060 targets) 6.2 MB, 0.0018 ms at 3.35 TB/s.
//
// What bounded the first design.  Its wrapper ran the O(B)
// frontier math as about nine torch ops before the launch (degrees, an
// int32 cumsum, span starts: a launch and a host enqueue each, three
// allocations, cum and sstart written by one op and read back by the
// next), and its kernel gave every output slot its own binary search over
// cum in device memory: 16 dependent L2 loads at B 65,536.  The call took
// 0.23 ms of CUDA events around a 0.008 ms kernel.
//
// This design: the wrapper allocates once (output and scratch together)
// and launches once.  A persistent grid of G blocks, all resident at once
// (cudaLaunchCooperativeKernel, G from the occupancy calculator), runs two
// phases split by one grid barrier:
//   1. degrees and their scan.  Block b takes the rows [b*span,
//      (b+1)*span); each thread loads kRows consecutive rows, then their
//      offsets, all loads independent; the block scans the degrees and
//      writes each row's block-local inclusive cumsum and span start to
//      the scratch, and its sum to bsum[b].
//   2. expansion over output slots, balanced over slots as before (one
//      10^6-edge row still spreads over the whole card): tiles of kTile
//      slots, grid-stride.  Every block first scans bsum[0, G) in shared
//      memory: the row ranges' prefixes and the total.  A tile past total
//      is a plain SENT / -1 fill.  Otherwise warp 0 finds the row that
//      owns the tile's first slot, by a binary search of the prefixes in
//      shared memory and a 33-way warp search of one range's cumsum (two
//      rounds of loads for a range of up to 1,089 rows); the block stages
//      the next kWin rows' global cumsum and span starts in shared
//      memory; each thread finds the row of each of its kSlots slots by a
//      binary search there, issues their target loads together and
//      stores coalesced.  Where kWin rows end before the tile does
//      (zero-degree or skipped rows) it stages the next kWin.
// No thread reads past a live span.  A decoupled look-back (as in
// csrc/intersect.cu) would scan without the barrier, but needs its status
// words zeroed by a memset; a grid that is all resident needs nothing.
// TMA bulk copies of long spans are later work.
//
// ptxas (sm_90a): gather_fused 32 registers, 10,280 bytes of static shared
// memory, no spills (chip_smoke.py's build line).

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "device.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;                 // rows per thread per pass of phase 1
constexpr int kTile = 1024;              // output slots per tile of phase 2
constexpr int kSlots = kTile / kThreads;
constexpr int kWin = kThreads;           // rows staged at once in phase 2
constexpr int kMaxGrid = 2048;           // block sums scanned in shared memory
constexpr int32_t kSent = 0x7fffffff;

// Inclusive scan of v over the block; *all = the block's sum.  Every
// thread calls it; red holds kWarps entries.
__device__ __forceinline__ int32_t block_scan(int32_t v, int32_t* red, int32_t* all) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int32_t x = dgt::warp_inclusive_scan(v, lane);
  if (lane == 31) red[warp] = x;
  __syncthreads();
  int32_t before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += red[w];
    sum += red[w];
  }
  __syncthreads();  // red is free for the next call
  *all = sum;
  return x + before;
}

__global__ void __launch_bounds__(kThreads)
gather_fused(const int32_t* __restrict__ offsets, const int32_t* __restrict__ dst,
             const int32_t* __restrict__ rows, int nrows, int cap, int span,
             int32_t* __restrict__ out,    // [2 * cap]
             int32_t* __restrict__ cum,    // [nrows] block-local inclusive cumsum
             int32_t* __restrict__ sst,    // [nrows] span starts
             int32_t* __restrict__ bsum) { // [gridDim.x]
  __shared__ int32_t s_pre[kMaxGrid];  // inclusive prefix of the block sums
  __shared__ int32_t s_cum[kWin + 1];  // staged global inclusive cumsum; [0] the row before
  __shared__ int32_t s_st[kWin];       // staged span starts
  __shared__ int32_t s_red[kWarps];
  __shared__ int s_row;
  const int G = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // -- phase 1: degrees, their block-local scan, the block sums ------------
  {
    const int r0 = min(static_cast<long long>(blockIdx.x) * span, static_cast<long long>(nrows));
    const int r1 = min(r0 + span, nrows);
    int32_t carry = 0;
    for (int base = r0; base < r1; base += kThreads * kRows) {
      const int first = base + static_cast<int>(threadIdx.x) * kRows;
      int32_t row[kRows], lo[kRows], deg[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) row[u] = first + u < r1 ? rows[first + u] : -1;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        lo[u] = row[u] >= 0 ? offsets[row[u]] : 0;
        deg[u] = row[u] >= 0 ? offsets[row[u] + 1] - lo[u] : 0;
      }
      int32_t sum = 0;
#pragma unroll
      for (int u = 0; u < kRows; ++u) sum += deg[u];
      int32_t chunk;
      int32_t run = carry + block_scan(sum, s_red, &chunk) - sum;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        run += deg[u];
        if (first + u < r1) {
          cum[first + u] = run;
          sst[first + u] = lo[u];
        }
      }
      carry += chunk;
    }
    if (threadIdx.x == 0) bsum[blockIdx.x] = carry;
  }
  cg::this_grid().sync();

  // -- phase 2: every block scans the block sums, then expands its tiles ---
  {
    const int per = (G + kThreads - 1) / kThreads;
    const int i0 = min(static_cast<int>(threadIdx.x) * per, G), i1 = min(i0 + per, G);
    int32_t sum = 0;
    for (int i = i0; i < i1; ++i) {
      s_pre[i] = __ldcg(bsum + i);
      sum += s_pre[i];
    }
    int32_t all;
    int32_t run = block_scan(sum, s_red, &all) - sum;
    for (int i = i0; i < i1; ++i) {
      run += s_pre[i];
      s_pre[i] = run;
    }
    __syncthreads();
  }
  const int32_t total = s_pre[G - 1];
  // a row's global inclusive cumsum: its range's prefix plus its local one
  const auto global_cum = [&](int r) {
    const int rr = r / span;
    return __ldcg(cum + r) + (rr ? s_pre[rr - 1] : 0);
  };
  const int ntiles = (cap + kTile - 1) / kTile;
  for (int t = blockIdx.x; t < ntiles; t += G) {
    const int a = t * kTile;
    const int end = min(a + kTile, cap);
    const int e = total > a ? min(end, total) : a;  // slots [a, e) hold targets
    for (int i = e + threadIdx.x; i < end; i += kThreads) {
      out[i] = kSent;
      out[cap + i] = -1;
    }
    if (e == a) continue;  // the same for the whole block
    if (warp == 0) {
      // the row range that holds slot a: the first prefix above a
      int lo = 0, hi = G - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_pre[mid] > a) hi = mid; else lo = mid + 1;
      }
      const int32_t x = a - (lo ? s_pre[lo - 1] : 0);
      const int r0 = lo * span;
      const auto load = [cum](int p) { return __ldcg(cum + p); };
      const int j = dgt::warp_bound(load, r0, min(r0 + span, nrows), x, true, lane);
      if (lane == 0) s_row = j;
    }
    __syncthreads();
    int j = s_row;  // every slot in [cur, e) belongs to a row >= j
    for (int cur = a; cur < e; j += kWin) {
      {
        const int r = j + threadIdx.x;
        s_cum[threadIdx.x + 1] = r < nrows ? global_cum(r) : INT_MAX;
        s_st[threadIdx.x] = r < nrows ? __ldcg(sst + r) : 0;
        if (threadIdx.x == 0) s_cum[0] = j > 0 ? global_cum(j - 1) : 0;
      }
      __syncthreads();
      const int covered = min(e, s_cum[kWin]);  // the staged rows end there
      int src[kSlots], seg[kSlots];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int i = cur + q * kThreads + threadIdx.x;
        seg[q] = -1;
        src[q] = 0;
        if (i < covered) {
          int lo = 0, hi = kWin - 1;  // the first staged row whose cumsum passes i
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (s_cum[mid + 1] > i) hi = mid; else lo = mid + 1;
          }
          src[q] = s_st[lo] + (i - s_cum[lo]);
          seg[q] = j + lo;
        }
      }
      int32_t v[kSlots];
#pragma unroll
      for (int q = 0; q < kSlots; ++q) v[q] = seg[q] >= 0 ? dst[src[q]] : 0;
#pragma unroll
      for (int q = 0; q < kSlots; ++q) {
        const int i = cur + q * kThreads + threadIdx.x;
        if (seg[q] >= 0) {
          out[i] = v[q];
          out[cap + i] = seg[q];
        }
      }
      cur = covered;
      __syncthreads();  // s_cum and s_st are restaged next
    }
  }
}

struct Grid {
  cudaError_t err;
  int blocks;  // resident at once on the whole card
};

Grid resident_blocks() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_fused, kThreads, 0);
  }
  return {e, per_sm * sms};
}

}  // namespace

// offsets: int32[Sb+1]; dst: int32 packed targets; rows: int32[nrows];
// buf: int32[words], words >= 2*cap + 2*nrows + 2048: the packed output
// [0, 2*cap), then the kernel's scratch; stream: cudaStream_t.  One
// cooperative launch on the stream; returns its error.
extern "C" int gather_packed(const void* offsets, const void* dst, const void* rows,
                             int nrows, int cap, void* buf, long long words,
                             void* stream) {
  if (nrows <= 0 || nrows >= (1 << 30) || cap <= 0 || cap >= (1 << 30) ||
      words < 2LL * cap + 2LL * nrows + kMaxGrid) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const Grid grid = resident_blocks();  // one card per process
  if (grid.err != cudaSuccess) return static_cast<int>(grid.err);
  const int want = std::max((nrows + kThreads * kRows - 1) / (kThreads * kRows),
                            (cap + kTile - 1) / kTile);
  int g = std::min(std::min(grid.blocks, kMaxGrid), want);
  int span = (nrows + g - 1) / g;
  int32_t* out = static_cast<int32_t*>(buf);
  int32_t* cum = out + 2LL * cap;
  int32_t* sst = cum + nrows;
  int32_t* bsum = sst + nrows;
  const int32_t* off = static_cast<const int32_t*>(offsets);
  const int32_t* d = static_cast<const int32_t*>(dst);
  const int32_t* r = static_cast<const int32_t*>(rows);
  void* args[] = {&off, &d, &r, &nrows, &cap, &span, &out, &cum, &sst, &bsum};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(gather_fused), dim3(g), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) {
    cudaGetLastError();  // clear it: the next call starts clean
    return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}
