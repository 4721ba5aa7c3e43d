// k-way sorted-set intersection for Hopper (sm_90a).
//
// Replaces the TPU kernel intersect_pallas (dgraph_tpu/ops/
// pallas_intersect.py, _kernel).  For each batch row b of an int32
// [B, K, L] matrix whose K rows are sorted-unique sets padded with SENT
// (int32 max):
//   out[b, :n] = the entries of row 0 present in every other row, in
//                row 0's (ascending) order;
//   out[b, n:] = SENT.
// That is the reference's intersect_many / spgemm.intersect_stack, byte
// for byte.  K is a runtime argument with no upper bound.
//
// Bound: memory.  The function must read each row's valid entries once (a
// row's SENT tail is a search away, not a read) and write the B*L output
// lanes once, 4*(sum of valid + B*L) bytes; at the served shape (K 3,
// L 2^21, 2,426,095 valid) 18.1 MB, about 0.0054 ms at 3.35 TB/s.
//
// Design.  The TPU kernel compares each 128-lane block of row 0 against
// every whole row in VMEM (a [128 x L] equality tile, quadratic in L) and
// sorts once afterwards.  The sets are sorted, so here a tile's candidates
// meet only one range of each other row, and survivors keep row 0's order:
// no compare tile and no sort.  One launch, B * ntiles blocks on the
// grid's x axis (block x serves batch row x / ntiles, so B has no bound of
// its own: the y axis would stop at 65,535), single pass with a decoupled
// look-back (Merrill & Garland) over the tiles of kTile lanes of each
// batch row's row 0.  Each block:
//   - takes the next tile id of its batch row from an atomic counter, not
//     from blockIdx, so every tile it looks back at is already running;
//   - if the tile's first lane is SENT (every later lane is SENT too) it
//     writes SENT over its output lanes, publishes a count of 0 and stops.
//     At the served shape that is nine tiles in ten;
//   - else, for the other rows in groups of kGroup: one warp per bound
//     finds, by a 33-way search (about five dependent loads in a row of
//     2^21), the range of each row of the group that lies within the
//     tile's candidates' span [first, last] (both are sorted), all the
//     group's searches at once.  The ranges that fit in a 64 KB shared
//     buffer are copied in by cp.async, all in one round trip; the others
//     (a sparse row 0 against a dense row: staging them would read far
//     more than the candidates need) are searched in device memory while
//     the copies fly.  Every candidate is then looked up in every row by
//     binary lifting, all kGroup * kPer searches of a thread stepping
//     together with unconditional loads, so a step's loads are
//     independent.  It stops after the first group that leaves no
//     survivor;
//   - counts its survivors (per-thread popc, a block scan), writes SENT over
//     its own output lanes [tile*kTile, (tile+1)*kTile), fences, and only
//     then publishes its count; one warp looks back at its predecessors,
//     128 loaded at once, for the survivors before it, publishes its
//     inclusive prefix, and the block scatters its survivors to that
//     prefix plus their rank.
// Why this is exact: survivors of tile t land below (t+1)*kTile, so only in
// lanes of tiles <= t; each of those wrote its SENT before it published,
// and tile t scatters only after its look-back has seen those publications
// (release/acquire at device scope, chained through the inclusive
// prefixes).  Every lane is written SENT once, then by at most one survivor:
// no race, no separate fill.  The tile status words and counters are zeroed
// by one memset on the same stream before the launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 1024;             // lanes of row 0 per tile
constexpr int kPer = kTile / kThreads;  // candidates per thread: one int4
constexpr int kGroup = 4;               // rows j taken together
// the staging buffer (64 KB and a pad): a group's ranges, in row order, as
// many as fit, each with room for its alignment shift and kept 16-byte
// aligned; the rest are searched in device memory
constexpr int kBuf = 16384 + 4 * kGroup;
constexpr int kSmemBytes = kBuf * static_cast<int>(sizeof(int32_t));
constexpr int32_t kSent = 0x7fffffff;
// A tile's status word: the flag in the high 32 bits, a count in the low 32.
constexpr unsigned long long kAggregate = 1ull << 32;  // the tile's own survivors
constexpr unsigned long long kPrefix = 2ull << 32;     // survivors of tiles 0..t

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Marks in `found` (bit r * kPer + u) each candidate c[u] present in
// seg[r][0, m[r]) (ascending) for the rows r with m[r] > 0.  Binary
// lifting with clamped, unconditional loads, all kGroup * kPer searches
// stepping together so that the loads of one step are independent.
__device__ __forceinline__ unsigned find_all(const int32_t* const (&seg)[kGroup],
                                             const int (&m)[kGroup],
                                             const int32_t (&c)[kPer]) {
  int top = 0;
#pragma unroll
  for (int r = 0; r < kGroup; ++r) top = max(top, m[r]);
  int pos[kGroup][kPer] = {};
  for (int step = top > 0 ? 1 << (31 - __clz(top)) : 0; step > 0; step >>= 1) {
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        const int q = pos[r][u] + step;
        const int32_t v = seg[r][max(min(q, m[r]), 1) - 1];
        if (q <= m[r] && v < c[u]) pos[r][u] = q;
      }
    }
  }
  unsigned found = 0;
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int q = min(pos[r][u], max(m[r] - 1, 0));
      if (pos[r][u] < m[r] && seg[r][q] == c[u]) found |= 1u << (r * kPer + u);
    }
  }
  return found;
}

__global__ void __launch_bounds__(kThreads)
intersect_tiles(const int32_t* __restrict__ mat, int k, int L, int ntiles,
                unsigned long long* __restrict__ status,   // [B, ntiles]
                unsigned long long* __restrict__ counter,  // [B]
                int32_t* __restrict__ out) {
  extern __shared__ __align__(16) int32_t buf[];  // one group's staged ranges
  __shared__ __align__(16) int32_t cand[kTile];
  __shared__ int32_t red[kWarps];
  __shared__ int s_range[2 * kGroup];
  __shared__ int s_tile, s_excl;
  __shared__ int32_t s_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t b = blockIdx.x / ntiles;  // the batch row: ntiles blocks each
  if (threadIdx.x == 0) s_tile = static_cast<int>(atomicAdd(counter + b, 1ull));
  __syncthreads();
  const int tile = s_tile;
  const int lo = tile * kTile;
  const int n = min(kTile, L - lo);
  const int32_t* rows = mat + b * k * static_cast<size_t>(L);
  int32_t* o = out + b * static_cast<size_t>(L);
  unsigned long long* st = status + b * static_cast<size_t>(ntiles);

  if (rows[lo] == kSent) {
    for (int i = threadIdx.x; i < n; i += kThreads) o[lo + i] = kSent;
    // no survivors; publishing that keeps every look-back finite even
    // for a row 0 that breaks the sorted contract
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) st_release(st + tile, kAggregate);
    return;
  }
  for (int i = threadIdx.x; i < kTile; i += kThreads) cand[i] = i < n ? rows[lo + i] : kSent;
  __syncthreads();
  const int4 c4 = *reinterpret_cast<const int4*>(cand + threadIdx.x * kPer);
  const int32_t c[kPer] = {c4.x, c4.y, c4.z, c4.w};
  unsigned alive = 0;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = threadIdx.x * kPer + u;
    alive |= static_cast<unsigned>(c[u] != kSent) << u;
    if (c[u] != kSent && (i + 1 == kTile || cand[i + 1] == kSent)) s_last = c[u];
  }
  __syncthreads();
  const int32_t first = cand[0], last = s_last;  // the tile's valid candidates span [first, last]

  for (int g = 1; g < k; g += kGroup) {
    const int gn = min(kGroup, k - g);
    // warp 2r finds where row g + r could hold `first`, warp 2r + 1 where
    // it ends past `last`: the range of each row the tile can meet
    if (warp < 2 * gn) {
      const int32_t* row = rows + static_cast<size_t>(g + (warp >> 1)) * L;
      const auto load = [row](int p) { return row[p]; };
      const int x = (warp & 1) ? dgt::warp_bound(load, 0, L, last, true, lane)
                               : dgt::warp_bound(load, 0, L, first, false, lane);
      if (lane == 0) s_range[warp] = x;
    }
    __syncthreads();
    // stage the ranges that fit, all in one round trip; search the others
    // in device memory meanwhile
    const int32_t* seg[kGroup];
    int m[kGroup];
    const int32_t* deep[kGroup];
    int dm[kGroup];
    bool any_deep = false;
    int off = 0;
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const int beg = r < gn ? s_range[2 * r] : 0;
      const int len = r < gn ? s_range[2 * r + 1] - beg : 0;
      const int32_t* src = rows + static_cast<size_t>(g + r) * L + beg;
      const int room = (len + 7) & ~3;  // the entries and the shift, 16-byte aligned
      const bool staged = r < gn && off + room <= kBuf;
      seg[r] = buf;
      m[r] = 0;
      deep[r] = rows;
      dm[r] = 0;
      if (staged) {
        seg[r] = buf + off + dgt::stage(buf + off, src, len, mat);
        m[r] = len;
        off += room;
      } else if (r < gn) {
        deep[r] = src;
        dm[r] = len;
        any_deep = true;
      }
    }
    dgt::cp_async_commit();
    unsigned found = any_deep ? find_all(deep, dm, c) : 0;
    dgt::cp_async_wait<0>();
    __syncthreads();
    found |= find_all(seg, m, c);
    // a candidate survives the group when every row of it holds it
    for (int r = 0; r < gn; ++r) alive &= found >> (r * kPer);
    if (!__syncthreads_or(alive)) break;  // also: the buffer is restaged next group
  }

  // survivors: rank within the tile by a block scan of per-thread counts
  const int32_t cnt = __popc(alive);
  const int32_t x = dgt::warp_inclusive_scan(cnt, lane);
  if (lane == 31) red[warp] = x;
  __syncthreads();
  int32_t rank = x - cnt, agg = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) rank += red[w];
    agg += red[w];
  }
  // SENT over this tile's own lanes, visible before the tile publishes
  for (int i = threadIdx.x; i < n; i += kThreads) o[lo + i] = kSent;
  __threadfence();
  __syncthreads();
  if (warp == 0) {
    int32_t excl = 0;
    if (tile == 0) {
      if (lane == 0) st_release(st, kPrefix | static_cast<uint32_t>(agg));
    } else {
      if (lane == 0) st_release(st + tile, kAggregate | static_cast<uint32_t>(agg));
      // look back over the predecessors, 128 loaded at once: 4 windows
      // of 32, newest first, each waited on until none is unpublished
      for (int p = tile - 1; p >= 0; p -= 4 * 32) {
        unsigned long long w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int idx = p - 32 * i - lane;
          w[i] = idx >= 0 ? ld_acquire(st + idx) : kPrefix;
        }
        bool done = false;
#pragma unroll
        for (int i = 0; i < 4 && !done; ++i) {
          const int idx = p - 32 * i - lane;
          while (__any_sync(dgt::kFull, (w[i] >> 32) == 0)) {
            w[i] = idx >= 0 ? ld_acquire(st + idx) : kPrefix;
          }
          const unsigned pm = __ballot_sync(dgt::kFull, (w[i] >> 32) == 2);
          const int stop = pm ? __ffs(pm) - 1 : 31;  // lanes 0..stop count
          excl += __reduce_add_sync(
              dgt::kFull, lane <= stop ? static_cast<int32_t>(w[i] & 0xffffffffu) : 0);
          done = pm != 0;
        }
        if (done) break;
      }
      if (lane == 0) st_release(st + tile, kPrefix | static_cast<uint32_t>(excl + agg));
    }
    __threadfence();
    if (lane == 0) s_excl = excl;
  }
  __syncthreads();
  int32_t* dst = o + s_excl + rank;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    if ((alive >> u) & 1) *dst++ = c[u];
  }
}

}  // namespace

// mat: int32[b, k, L]; scratch: int64[words], words >= b * (ceil(L / 1024)
// + 1) (tile status words, then one tile counter per batch row); out:
// int32[b, L]; stream: cudaStream_t.  One memset of the scratch and one
// launch on the stream; returns the first error.
extern "C" int intersect(const void* mat, int b, int k, int L, void* scratch,
                         long long words, void* out, void* stream) {
  if (b <= 0 || k <= 0 || L <= 0 || L >= (1 << 30)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ntiles = (L + kTile - 1) / kTile;
  const long long blocks = static_cast<long long>(b) * ntiles;  // the grid's x
  const long long need = static_cast<long long>(b) * (ntiles + 1);
  if (blocks > 0x7fffffffLL || words < need) return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB a block's dynamic shared memory must be asked for, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      intersect_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  cudaError_t e = cudaMemsetAsync(status, 0, need * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  intersect_tiles<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes, s>>>(
      static_cast<const int32_t*>(mat), k, L, ntiles, status,
      status + static_cast<size_t>(b) * ntiles, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
