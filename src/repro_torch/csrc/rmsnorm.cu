// Fused row RMSNorm, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::rmsnorm (_rms_kernel;
// its pallas_call is at :36).
//
// What bounds it on the card: bytes.  Each row is read once and written
// once with about three operations per element, far below the H100's
// ~295 FLOP/byte ridge, so the floor is (x + out + scale bytes) / 3.35 TB/s.
// At decode shapes (8 rows) it is one short launch whose cost is the
// launch itself; the plain version is seven to eight launches.
//
// What the design does about it:
//  * one row per warp when D <= 1024 (the q/k norms run on head_dim-wide
//    rows: 16 to 256 elements), one row per CTA of 256 threads above it
//    (d_model rows of 2048 to 6144), so every row is reduced on chip and
//    no partial sums go to device memory;
//  * 16-byte loads and stores (8 bf16 or 4 fp32 values a thread);
//  * the arithmetic of the TPU kernel and of modules.rmsnorm: the mean of
//    the fp32 squares, rsqrtf(mean + eps), the product with the fp32 scale,
//    one rounding to x's dtype.  The row is read twice (sum of squares,
//    then scale); the second read hits L1/L2, so device memory sees it once.

#include "common.cuh"

namespace {

using repro::Chunk;

constexpr int THREADS = 256;
constexpr int WARP_ROW_MAX_D = 1024;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void store_chunk(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_chunk(__nv_bfloat16* dst,
                                            const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// TPR threads (a warp, or the whole CTA) normalize one row.  ``red`` is
// shared scratch of THREADS / 32 floats, used when TPR > 32.
template <typename T, int TPR>
__device__ __forceinline__ void norm_row(const T* __restrict__ x,
                                         const float* __restrict__ scale,
                                         T* __restrict__ out, int D, float eps,
                                         int lane, float* red) {
  constexpr int CE = Chunk<T>::N;
  const int n_chunks = D / CE;
  float ss = 0.f;
  for (int c = lane; c < n_chunks; c += TPR) {
    float f[CE];
    repro::load_chunk(x + static_cast<size_t>(c) * CE, f);
#pragma unroll
    for (int e = 0; e < CE; ++e) ss = fmaf(f[e], f[e], ss);
  }
  ss = warp_sum(ss);
  if constexpr (TPR > 32) {
    if (lane % 32 == 0) red[lane / 32] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < TPR / 32; ++w) ss += red[w];
  }
  const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
  for (int c = lane; c < n_chunks; c += TPR) {
    float f[CE], s[CE];
    repro::load_chunk(x + static_cast<size_t>(c) * CE, f);
#pragma unroll
    for (int e = 0; e < CE; e += 4) repro::load_chunk(scale + c * CE + e, s + e);
#pragma unroll
    for (int e = 0; e < CE; ++e) f[e] = f[e] * inv * s[e];
    store_chunk(out + static_cast<size_t>(c) * CE, f);
  }
}

// D <= WARP_ROW_MAX_D: grid ceil(N / 8), one warp per row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_warp_rows(const T* __restrict__ x, const float* __restrict__ scale,
                  T* __restrict__ out, int N, int D, float eps) {
  const int row = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  if (row >= N) return;
  const size_t off = static_cast<size_t>(row) * D;
  norm_row<T, 32>(x + off, scale, out + off, D, eps, threadIdx.x % 32,
                  nullptr);
}

// D > WARP_ROW_MAX_D: grid N, one CTA per row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rmsnorm_cta_rows(const T* __restrict__ x, const float* __restrict__ scale,
                 T* __restrict__ out, int D, float eps) {
  __shared__ float red[THREADS / 32];
  const size_t off = static_cast<size_t>(blockIdx.x) * D;
  norm_row<T, THREADS>(x + off, scale, out + off, D, eps, threadIdx.x, red);
}

template <typename T>
int launch(const void* x, const void* scale, void* out, int N, int D,
           float eps, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(scale);
  T* op = static_cast<T*>(out);
  if (D <= WARP_ROW_MAX_D) {
    const int rows = THREADS / 32;
    rmsnorm_warp_rows<T><<<(N + rows - 1) / rows, THREADS, 0, stream>>>(
        xp, sp, op, N, D, eps);
  } else {
    rmsnorm_cta_rows<T><<<N, THREADS, 0, stream>>>(xp, sp, op, D, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out (N, D) row-major in x's dtype; scale (D,) fp32.  D a multiple of
// 8 (bf16) or 4 (fp32), rows 16-byte aligned.  Returns the launch's
// cudaError_t.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int N, int D, float eps, int is_bf16,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch<__nv_bfloat16>(x, scale, out, N, D, eps, s);
  return launch<float>(x, scale, out, N, D, eps, s);
}
