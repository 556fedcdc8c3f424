// Row RMSNorm, alone, fused with the residual add before it, or over two
// row sets with their own scales in one launch; hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rmsnorm.py::rmsnorm (_rms_kernel;
// its pallas_call is at :36).
//
// What bounds it on the card: at the served decode shapes (4 to 128 rows),
// the launch and one device-memory round trip; at prefill shapes, bytes.
// Each row is read once and written once with about three operations per
// element, far below the H100's ~295 FLOP/byte ridge, so the bytes floor
// is (x + out + scale bytes) / 3.35 TB/s (add x's second operand and the
// sum for the fused add).
//
// What the design does about it:
//  * one pass: each thread loads its share of the row (at most 8 chunks of
//    16 bytes) into registers together with the matching scale values, so
//    a launch waits on one device-memory round trip, not on a reduction
//    followed by a second read;
//  * fewer launches: the fused entry point takes the residual stream x and
//    the branch output d, writes s = x + d rounded to x's dtype exactly as
//    a separate add would (fp32 sum, one rounding), and normalizes s; the
//    pair entry point normalizes two row sets (a layer's q and k heads) of
//    one width with two scales;
//  * a row group of tpr threads (a power of two, 1 to 256) per row, chosen
//    from D alone, so every entry point reduces a row of a given width in
//    the same order: the fused and pair launches give the same bits as
//    the plain one on the same row;
//  * 16-byte loads and stores (8 bf16 or 4 fp32 values a thread);
//  * the arithmetic of the TPU kernel and of modules.rmsnorm: the mean of
//    the fp32 squares, rsqrtf(mean + eps), the product with the fp32 scale,
//    one rounding to x's dtype.

#include "common.cuh"

namespace {

using repro::Chunk;

constexpr int THREADS = 256;
constexpr int MAX_NC = 8;  // chunks of 16 bytes a thread holds

// One row set: n rows of x (and, fused, of d) normalized by scale into
// out; fused, sum receives x + d.
struct Rows {
  const void* x;
  const void* d;
  const float* scale;
  void* out;
  void* sum;
  int n;
};

// 16 bytes of T kept as loaded
using Raw = uint4;

__device__ __forceinline__ void widen(const Raw& r, float* f, float) {
  f[0] = __uint_as_float(r.x);
  f[1] = __uint_as_float(r.y);
  f[2] = __uint_as_float(r.z);
  f[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void widen(const Raw& r, float* f, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ Raw narrow(const float* f, float) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                    __float_as_uint(f[2]), __float_as_uint(f[3]));
}

__device__ __forceinline__ Raw narrow(const float* f, __nv_bfloat16) {
  Raw r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return r;
}

// Grid: ctas_a CTAs for row set a, then b's.  A CTA of THREADS threads
// holds THREADS / tpr rows; the thread at lane l of a row group takes the
// chunks l, l + tpr, ... (at most NC of them).
template <typename T, int NC, bool ADD>
__global__ void __launch_bounds__(THREADS)
rmsnorm_rows(Rows a, Rows b, int ctas_a, int D, int tpr, float eps) {
  constexpr int CE = Chunk<T>::N;
  __shared__ float red[THREADS / 32];
  const bool first = blockIdx.x < ctas_a;
  const Rows rs = first ? a : b;
  const int blk = first ? blockIdx.x : blockIdx.x - ctas_a;
  const int row = blk * (THREADS / tpr) + threadIdx.x / tpr;
  const int lane = threadIdx.x % tpr;
  const int n_chunks = D / CE;
  const bool valid = row < rs.n;
  const size_t off = static_cast<size_t>(row) * D;

  // every load of the row and of its scale is issued before any use
  Raw xv[NC], dv[NC];
  float4 sv[NC][CE / 4];
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + j * tpr;
    if (valid && c < n_chunks) {
      xv[j] = *reinterpret_cast<const Raw*>(static_cast<const T*>(rs.x) +
                                            off + c * CE);
      if constexpr (ADD)
        dv[j] = *reinterpret_cast<const Raw*>(static_cast<const T*>(rs.d) +
                                              off + c * CE);
#pragma unroll
      for (int q = 0; q < CE / 4; ++q)
        sv[j][q] = *reinterpret_cast<const float4*>(rs.scale + c * CE + 4 * q);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + j * tpr;
    if (valid && c < n_chunks) {
      float f[CE];
      widen(xv[j], f, T());
      if constexpr (ADD) {
        float g[CE];
        widen(dv[j], g, T());
#pragma unroll
        for (int e = 0; e < CE; ++e) f[e] += g[e];
        xv[j] = narrow(f, T());   // s rounded as the separate add rounds it
        *reinterpret_cast<Raw*>(static_cast<T*>(rs.sum) + off + c * CE) =
            xv[j];
        widen(xv[j], f, T());
      }
#pragma unroll
      for (int e = 0; e < CE; ++e) ss = fmaf(f[e], f[e], ss);
    }
  }
  for (int o = min(tpr, 32) / 2; o > 0; o >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (tpr > 32) {
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = ss;
    __syncthreads();
    const int w0 = (threadIdx.x / tpr) * (tpr / 32);
    ss = 0.f;
    for (int w = 0; w < tpr / 32; ++w) ss += red[w0 + w];
  }
  const float inv = rsqrtf(ss / static_cast<float>(D) + eps);
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    const int c = lane + j * tpr;
    if (valid && c < n_chunks) {
      float f[CE];
      widen(xv[j], f, T());
      const float* s = reinterpret_cast<const float*>(sv[j]);
#pragma unroll
      for (int e = 0; e < CE; ++e) f[e] = f[e] * inv * s[e];
      *reinterpret_cast<Raw*>(static_cast<T*>(rs.out) + off + c * CE) =
          narrow(f, T());
    }
  }
}

// threads a row (tpr) and chunks a thread (nc) for a row of n_chunks
// 16-byte chunks: a thread a chunk up to THREADS threads, then the fewest
// of 1, 2, 3, 4, 6 or 8 chunks a thread that hold the row (registers a
// thread, and so the CTAs an SM keeps in flight, follow nc)
void row_plan(int n_chunks, int* tpr, int* nc) {
  int t = 1;
  while (t < THREADS && t < n_chunks) t *= 2;
  const int need = (n_chunks + t - 1) / t;
  *tpr = t;
  *nc = need <= 4 ? need : need <= 6 ? 6 : need <= 8 ? 8 : need;
}

template <typename T, int NC, bool ADD>
void start(Rows a, Rows b, int ctas_a, int ctas, int D, int tpr, float eps,
           cudaStream_t stream) {
  rmsnorm_rows<T, NC, ADD><<<ctas, THREADS, 0, stream>>>(a, b, ctas_a, D,
                                                         tpr, eps);
}

template <typename T, bool ADD>
int launch(Rows a, Rows b, int D, float eps, cudaStream_t stream) {
  int tpr, nc;
  row_plan(D / Chunk<T>::N, &tpr, &nc);
  if (nc > MAX_NC) return static_cast<int>(cudaErrorInvalidValue);
  const int rpc = THREADS / tpr;
  const int ctas_a = (a.n + rpc - 1) / rpc;
  const int ctas = ctas_a + (b.n + rpc - 1) / rpc;
  if (ctas == 0) return 0;
  switch (nc) {
    case 1: start<T, 1, ADD>(a, b, ctas_a, ctas, D, tpr, eps, stream); break;
    case 2: start<T, 2, ADD>(a, b, ctas_a, ctas, D, tpr, eps, stream); break;
    case 3: start<T, 3, ADD>(a, b, ctas_a, ctas, D, tpr, eps, stream); break;
    case 4: start<T, 4, ADD>(a, b, ctas_a, ctas, D, tpr, eps, stream); break;
    case 6: start<T, 6, ADD>(a, b, ctas_a, ctas, D, tpr, eps, stream); break;
    default: start<T, 8, ADD>(a, b, ctas_a, ctas, D, tpr, eps, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(Rows a, Rows b, int D, float eps, int is_bf16, int add,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return add ? launch<__nv_bfloat16, true>(a, b, D, eps, s)
               : launch<__nv_bfloat16, false>(a, b, D, eps, s);
  return add ? launch<float, true>(a, b, D, eps, s)
             : launch<float, false>(a, b, D, eps, s);
}

}  // namespace

// x, out (N, D) row-major in x's dtype; scale (D,) fp32.  D a multiple of
// 8 (bf16) or 4 (fp32), at most 8 x 256 such chunks; rows 16-byte
// aligned.  Returns the launch's cudaError_t.
extern "C" int rmsnorm_launch(const void* x, const void* scale, void* out,
                              int N, int D, float eps, int is_bf16,
                              void* stream) {
  const Rows a{x, nullptr, static_cast<const float*>(scale), out, nullptr, N};
  const Rows none{nullptr, nullptr, nullptr, nullptr, nullptr, 0};
  return dispatch(a, none, D, eps, is_bf16, 0, stream);
}

// sum = x + d (rounded to the dtype) and out = rmsnorm(sum), all (N, D)
// in one dtype; the rest as rmsnorm_launch.
extern "C" int add_rmsnorm_launch(const void* x, const void* d,
                                  const void* scale, void* sum, void* out,
                                  int N, int D, float eps, int is_bf16,
                                  void* stream) {
  const Rows a{x, d, static_cast<const float*>(scale), out, sum, N};
  const Rows none{nullptr, nullptr, nullptr, nullptr, nullptr, 0};
  return dispatch(a, none, D, eps, is_bf16, 1, stream);
}

// Two row sets of one width in one launch (a layer's q and k heads):
// x1 (N1, D) by scale1 into out1 and x2 (N2, D) by scale2 into out2.
extern "C" int qk_rmsnorm_launch(const void* x1, const void* scale1,
                                 void* out1, int N1, const void* x2,
                                 const void* scale2, void* out2, int N2,
                                 int D, float eps, int is_bf16,
                                 void* stream) {
  const Rows a{x1, nullptr, static_cast<const float*>(scale1), out1, nullptr,
               N1};
  const Rows b{x2, nullptr, static_cast<const float*>(scale2), out2, nullptr,
               N2};
  return dispatch(a, b, D, eps, is_bf16, 0, stream);
}
