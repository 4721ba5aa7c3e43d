// Device helpers shared by the port's kernels (sm_90a): a warp scan, a
// warp-wide search of a sorted run, and cp.async staging of a run of
// int32 entries into shared memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dgt {

constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int32_t warp_inclusive_scan(int32_t v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// The first index p in [lo, hi) whose entry load(p) is > x (upper) or >= x
// (lower), hi if none; the entries ascend over [lo, hi).  The whole warp
// calls it: each round its 32 lanes probe 32 points that cut the range
// into 33 parts, so a range of n entries takes about log33(n) dependent
// loads.
template <typename Load>
__device__ int warp_bound(Load load, int lo, int hi, int32_t x, bool upper, int lane) {
  while (hi - lo > 32) {
    const int p = lo + static_cast<int>(static_cast<long long>(hi - lo) * (lane + 1) / 33);
    const int32_t v = load(p);
    const unsigned m = __ballot_sync(kFull, upper ? v > x : v >= x);
    if (m == 0) {
      lo = __shfl_sync(kFull, p, 31) + 1;
    } else {
      const int l0 = __ffs(m) - 1;
      const int below = __shfl_sync(kFull, p, l0 > 0 ? l0 - 1 : 0);
      hi = __shfl_sync(kFull, p, l0);
      if (l0 > 0) lo = below + 1;
    }
  }
  const int p = lo + lane;
  const bool hit = p >= hi || (upper ? load(p) > x : load(p) >= x);
  const unsigned m = __ballot_sync(kFull, hit);
  return m ? lo + __ffs(m) - 1 : hi;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The whole block issues (does not wait for) the copy of src[0, n) into
// dst, shared memory aligned to 16 bytes with room for n + 3 entries.  The
// copy starts h <= 3 entries early when that makes its source 16-byte
// aligned without reading below `floor`, so that it moves 16 bytes a copy
// (4 bytes a copy otherwise, and for the ragged tail).  Returns h: src[i]
// lands in dst[h + i].
__device__ __forceinline__ int stage(int32_t* dst, const int32_t* src, int n,
                                     const int32_t* floor) {
  int h = static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
  if (src - h < floor) h = 0;
  const int32_t* a = src - h;
  const int m = n + h;
  int i0 = 0;
  if ((reinterpret_cast<uintptr_t>(a) & 15) == 0) {
    const int m4 = m >> 2;
    for (int i = threadIdx.x; i < m4; i += blockDim.x) cp_async16(dst + 4 * i, a + 4 * i);
    i0 = 4 * m4;
  }
  for (int i = i0 + threadIdx.x; i < m; i += blockDim.x) cp_async4(dst + i, a + i);
  return h;
}

}  // namespace dgt
