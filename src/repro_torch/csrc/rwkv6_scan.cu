// RWKV-6 wkv scan (chunked linear attention with a per-channel,
// data-dependent decay), hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan.py::rwkv6_scan
// (_rwkv_kernel; the wrapper is at :73).  Per (batch, head), with
// K = V = head_dim, la the inclusive cumsum of the log-decay lw over a
// chunk and la_prev = la - lw:
//   o_t  = (r_t exp(la_prev_t)) S                       (inter-chunk)
//        + sum_{s<t} (sum_K r_t k_s exp(la_prev_t - la_s)) v_s   (intra)
//        + (r_t . u k_t) v_t                              (current-token bonus)
//   S'   = diag(exp(la_L)) S + sum_s (k_s exp(la_L - la_s))^T v_s
//
// What bounds it on the card: operations.  The recurrence does about
// 7 K V fp32 operations per token and head against 14 to 20 bytes per
// token, head and channel, so at K = V = 64 it sits above the fp32
// CUDA-core ridge; the chunked form does more (the (L, L, K) intra-chunk
// product with one exp per term) in exchange for parallel work inside a
// chunk.  What the design does about it:
//  * one CTA per (b, h) walks the chunks in order (the TPU grid's
//    sequential chunk axis becomes a loop); the (K, V) fp32 state (16 KB at
//    64 x 64) stays in shared memory from S0 to S_T and never goes to
//    device memory in between;
//  * a chunk's r, k, lw, v rows are staged in shared memory as fp32 (r, k,
//    v arrive as fp32 or bf16), with an odd row stride so that the column
//    reads of the (L, L) product hit 32 distinct banks;
//  * the log-space rule of the reference: every exponent is <= 0.  The
//    intra-chunk exponent la_prev_t - la_s is evaluated only for s < t,
//    where it is a sum of log-decays; the masked entries are never
//    computed, so nothing overflows;
//  * any S: the last chunk runs with its n < L valid rows (no divisor
//    rule; decode calls it with S = 1, one row).
// Simple fp32 on the CUDA cores; tensor cores and a split of the chunk
// product across CTAs are left for a later version.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int L = 32;  // chunk length (the TPU kernel's default chunk)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Grid (B * H).  r, k (B,S,H,K) and v (B,S,H,V) of type T; lw (B,S,H,K),
// u (H,K), s0 (B,H,K,V) fp32; o (B,S,H,V), s_out (B,H,K,V) fp32.
template <typename T>
__global__ void __launch_bounds__(THREADS)
rwkv6_scan_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ lw,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ o, float* __restrict__ s_out, int S,
                  int H, int K, int V) {
  extern __shared__ __align__(16) float smem[];
  const int P = K | 1;  // odd row stride of the (L, K) tiles
  float* st = smem;          // K x V state
  float* rs = st + K * V;    // L x P  r, then r * exp(la_prev)
  float* ks = rs + L * P;    // L x P  k, then k * exp(la_L - la)
  float* la = ks + L * P;    // L x P  lw, then its inclusive cumsum
  float* lp = la + L * P;    // L x P  la_prev = la - lw
  float* vs = lp + L * P;    // L x V
  float* A = vs + L * V;     // L x L  intra-chunk weights, bonus on the diagonal
  float* us = A + L * L;     // K

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x;
  const size_t state = static_cast<size_t>(blockIdx.x) * K * V;

  for (int i = tid; i < K * V; i += THREADS) st[i] = s0[state + i];
  for (int i = tid; i < K; i += THREADS) us[i] = u[h * K + i];

  for (int c0 = 0; c0 < S; c0 += L) {
    const int n = min(L, S - c0);
    const size_t row0 = (static_cast<size_t>(b) * S + c0) * H + h;
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < n * K; i += THREADS) {
      const int t = i / K, c = i % K;
      const size_t g = (row0 + static_cast<size_t>(t) * H) * K + c;
      rs[t * P + c] = to_float(r[g]);
      ks[t * P + c] = to_float(k[g]);
      la[t * P + c] = lw[g];
    }
    for (int i = tid; i < n * V; i += THREADS) {
      const int t = i / V, c = i % V;
      vs[t * V + c] = to_float(v[(row0 + static_cast<size_t>(t) * H) * V + c]);
    }
    __syncthreads();
    for (int c = tid; c < K; c += THREADS) {  // cumsum down each channel
      float run = 0.f;
      for (int t = 0; t < n; ++t) {
        const float w = la[t * P + c];
        run += w;
        la[t * P + c] = run;
        lp[t * P + c] = run - w;
      }
    }
    __syncthreads();
    for (int i = tid; i < n * n; i += THREADS) {
      const int t = i / n, s = i % n;
      float acc = 0.f;
      if (s < t) {
        for (int c = 0; c < K; ++c)
          acc += rs[t * P + c] * ks[s * P + c] *
                 expf(lp[t * P + c] - la[s * P + c]);
      } else if (s == t) {
        for (int c = 0; c < K; ++c) acc += rs[t * P + c] * us[c] * ks[t * P + c];
      }
      A[t * L + s] = acc;
    }
    __syncthreads();
    for (int i = tid; i < n * K; i += THREADS) {
      const int t = i / K, c = i % K;
      rs[t * P + c] *= expf(lp[t * P + c]);
      ks[t * P + c] *= expf(la[(n - 1) * P + c] - la[t * P + c]);
    }
    __syncthreads();
    for (int i = tid; i < n * V; i += THREADS) {
      const int t = i / V, c = i % V;
      float acc = 0.f;
      for (int kk = 0; kk < K; ++kk) acc += rs[t * P + kk] * st[kk * V + c];
      for (int s = 0; s <= t; ++s) acc += A[t * L + s] * vs[s * V + c];
      o[(row0 + static_cast<size_t>(t) * H) * V + c] = acc;
    }
    __syncthreads();
    for (int i = tid; i < K * V; i += THREADS) {
      const int kk = i / V, c = i % V;
      float acc = expf(la[(n - 1) * P + kk]) * st[i];
      for (int s = 0; s < n; ++s) acc += ks[s * P + kk] * vs[s * V + c];
      st[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < K * V; i += THREADS) s_out[state + i] = st[i];
}

template <typename T>
int launch(const void* r, const void* k, const void* v, const void* lw,
           const void* u, const void* s0, void* o, void* s_out, int B, int S,
           int H, int K, int V, cudaStream_t stream) {
  const int P = K | 1;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(K) * V + 4 * L * P + L * V +
                       L * L + K);
  auto kernel = rwkv6_scan_kernel<T>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B * H, THREADS, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lw),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(o), static_cast<float*>(s_out), S, H, K, V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k (B,S,H,K), v (B,S,H,V): fp32 or bf16 (is_bf16); lw (B,S,H,K),
// u (H,K), s0 (B,H,K,V), o (B,S,H,V), s_out (B,H,K,V): fp32, contiguous.
// Any S >= 1; K, V <= 64.  Returns the launch's cudaError_t.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* lw, const void* u,
                                 const void* s0, void* o, void* s_out, int B,
                                 int S, int H, int K, int V, int is_bf16,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch<__nv_bfloat16>(r, k, v, lw, u, s0, o, s_out, B, S, H, K, V,
                                 s);
  }
  return launch<float>(r, k, v, lw, u, s0, o, s_out, B, S, H, K, V, s);
}
