// RG-LRU linear-recurrence scan h_t = a_t * h_{t-1} + b_t over (B, S, W),
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rglru_scan.py::rglru_scan
// (_rglru_kernel; the wrapper is at :47).  This is an elementwise scan:
// each of the B x W lanes is an independent first-order recurrence, with
// h0 as the carry into the first step (the TPU wrapper folds it into b_0,
// which is the same arithmetic).
//
// What bounds it on the card: bytes.  Each element is read twice (a, b)
// and written once (h) in fp32 for two operations, far below the ridge,
// so the floor is 12 B x B x S x W / 3.35 TB/s.  What the design does
// about it:
//  * one thread per lane (b, w), neighbouring threads on neighbouring w,
//    so every load and store of a time step is one coalesced 128-byte
//    line per warp; the loop over S runs in the thread (the TPU grid's
//    sequential axis);
//  * the dependent loop must not wait on each load: the thread prefetches
//    the next TB time steps of a and b into registers while it steps
//    through the current TB (a double buffer in registers), so 2 x TB
//    independent loads per thread are in flight;
//  * the step is h = a * h + b rounded as a product then a sum
//    (__fmul_rn, __fadd_rn, no fused multiply-add), the arithmetic of
//    the plain version, so the two agree bit for bit;
//  * any S and W: the tail of S is predicated, lanes past W return.
// At B = 4, W = 2560 there are only 10,240 lanes (320 warps), so the
// card is far from full; splitting S across CTAs with a second fix-up
// pass is left for a later version.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;  // one warp per CTA: more CTAs to spread over SMs
constexpr int TB = 32;       // time steps per prefetched batch

__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ hs,
                  float* __restrict__ hT, int S, int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  const int bb = blockIdx.y;
  if (w >= W) return;
  const size_t base = static_cast<size_t>(bb) * S * W + w;
  float h = h0[static_cast<size_t>(bb) * W + w];
  float ca[TB], cb[TB], na[TB], nb[TB];
#pragma unroll
  for (int j = 0; j < TB; ++j) {
    const bool ok = j < S;
    ca[j] = ok ? __ldg(a + base + static_cast<size_t>(j) * W) : 0.f;
    cb[j] = ok ? __ldg(b + base + static_cast<size_t>(j) * W) : 0.f;
  }
  for (int t0 = 0; t0 < S; t0 += TB) {
#pragma unroll
    for (int j = 0; j < TB; ++j) {  // prefetch the next batch
      const int t = t0 + TB + j;
      const bool ok = t < S;
      na[j] = ok ? __ldg(a + base + static_cast<size_t>(t) * W) : 0.f;
      nb[j] = ok ? __ldg(b + base + static_cast<size_t>(t) * W) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < TB; ++j) {
      const int t = t0 + j;
      if (t < S) {
        h = __fadd_rn(__fmul_rn(ca[j], h), cb[j]);
        hs[base + static_cast<size_t>(t) * W] = h;
      }
    }
#pragma unroll
    for (int j = 0; j < TB; ++j) {
      ca[j] = na[j];
      cb[j] = nb[j];
    }
  }
  hT[static_cast<size_t>(bb) * W + w] = h;
}

}  // namespace

// a, b, hs (B,S,W) and h0, hT (B,W): fp32, contiguous.  Any S >= 1, W >= 1.
// Returns the launch's cudaError_t.
extern "C" int rglru_scan_launch(const void* a, const void* b, const void* h0,
                                 void* hs, void* hT, int B, int S, int W,
                                 void* stream) {
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(hs),
      static_cast<float*>(hT), S, W);
  return static_cast<int>(cudaGetLastError());
}
