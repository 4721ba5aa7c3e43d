// Resident-CSR frontier gather for Hopper (sm_90a).
//
// Replaces the TPU kernel gather_pallas / gather_pallas_packed
// (dgraph_tpu/ops/pallas_gather.py, _kernel).  Same contract as
// expand_csr: each frontier row rows[j] >= 0 copies its posting span
// dst[offsets[r] : offsets[r+1]] to its exclusive-cumsum slot and tags
// it seg = j; slots >= total hold SENT / -1; the output silently
// truncates at cap.  The result is written packed: out[0:cap] = targets,
// out[cap:2cap] = seg.
//
// Design.  The TPU kernel walks rows in grid order and lets row j+1
// overwrite row j's tail tile; CUDA blocks run in no order, so this
// kernel runs over OUTPUT SLOTS instead: thread i binary-searches the
// inclusive degree cumsum for the first row j with cum[j] > i (the
// owning productive row: zero-degree and skipped rows never match) and
// copies one uid.  Work is balanced under degree skew (one 10^6-edge row
// spreads over thousands of blocks), and no thread reads past a live
// span, so the resident layout's slack is kept only for layout parity.
//
// Bound.  Memory: the call moves about 4*total + 8*cap + 16*B bytes
// (each gathered uid read once, two int32 written per output slot, the
// O(B) frontier and prolog arrays), and that over the H100's 3.35 TB/s
// is the least time it can take.  The binary search re-reads cum, which
// stays in L2.  Tuning (a warp-cooperative row search, TMA or wgmma-era
// bulk copies of long spans, fusing the torch prolog) is later work.
//
// total is not passed in: the kernel reads it from cum[nrows - 1] on the
// device, so the wrapper needs no device-to-host sync.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int32_t SENT = 0x7fffffff;

__global__ void gather_packed_kernel(const int32_t* __restrict__ cum,
                                     const int32_t* __restrict__ sstart,
                                     const int32_t* __restrict__ dst,
                                     int nrows, int cap,
                                     int32_t* __restrict__ out) {
  const int total = cum[nrows - 1];
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < cap; i += stride) {
    int32_t v = SENT;
    int32_t s = -1;
    if (i < total) {
      int lo = 0, hi = nrows - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cum[mid] > i) hi = mid; else lo = mid + 1;
      }
      const int start = lo ? cum[lo - 1] : 0;
      v = dst[sstart[lo] + (i - start)];
      s = lo;
    }
    out[i] = v;
    out[cap + i] = s;
  }
}

}  // namespace

// cum, sstart: int32[nrows] (inclusive degree cumsum, span start per row)
// dst: int32 packed targets; out: int32[2*cap]; stream: cudaStream_t.
extern "C" int gather_packed(const void* cum, const void* sstart,
                             const void* dst, int nrows, int cap, void* out,
                             void* stream) {
  if (nrows <= 0 || cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kThreads = 256;
  const long long want = (static_cast<long long>(cap) + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < (1 << 20) ? want : (1 << 20));
  gather_packed_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cum), static_cast<const int32_t*>(sstart),
      static_cast<const int32_t*>(dst), nrows, cap,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
