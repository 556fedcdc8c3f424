// Single-query GQA decode attention over a KV cache, split over the
// cache's slots (flash-decoding): the kernels shared by the paged
// (paged_decode_attention.cu) and the contiguous (decode_attention.cu)
// caches.  A Layout names where a slot lives and how far a sequence is
// valid:
//
//   __device__ int last(int b) const;              // slots 0..last(b) valid
//   __device__ size_t row(int b, int slot) const;  // cache row of the slot
//
// where a cache row holds the Kv*hd values of one slot.  See the two .cu
// files for what bounds the kernels and what the design does about it.
#pragma once

#include "common.cuh"

namespace repro {
namespace decode {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TS = 32;  // slots per tile: one per lane in the softmax

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Grid (B, Kv, NS).  CTA (b, kvh, split) attends tiles
// [split*tps, (split+1)*tps) of sequence b's slots 0..layout.last(b) and
// writes its partial (acc, m, l) for the G query rows of kv head kvh.
template <typename T, typename Layout>
__global__ void __launch_bounds__(THREADS)
decode_partial(const T* __restrict__ q, const T* __restrict__ k_cache,
               const T* __restrict__ v_cache, const Layout layout,
               float* __restrict__ part_acc, float* __restrict__ part_m,
               float* __restrict__ part_l, int Kv, int G, int hd, int tps,
               float scale, float softcap) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int split = blockIdx.z;
  const int NS = gridDim.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  float* q_s = smem;              // G x hd
  float* p_s = q_s + G * hd;      // G x TS scores, then probabilities
  float* acc_s = p_s + G * TS;    // G x hd
  float* m_s = acc_s + G * hd;    // G running max
  float* l_s = m_s + G;           // G running sum
  float* c_s = l_s + G;           // G correction of this tile
  // two buffers of TS K rows and TS V rows, in the cache's own dtype
  T* kv_s = reinterpret_cast<T*>(
      smem + ((2 * G * hd + G * TS + 3 * G + 3) & ~3));

  constexpr int CE = Chunk<T>::N;
  const int cpr = hd / CE;  // 16-byte chunks per row
  const int H = Kv * G;
  const int last = layout.last(b);  // slots 0..last are valid

  const T* qb = q + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * hd;
  for (int c = tid; c < G * cpr; c += THREADS) {
    float f[CE];
    load_chunk(qb + static_cast<size_t>(c) * CE, f);
#pragma unroll
    for (int e = 0; e < CE; ++e) q_s[c * CE + e] = f[e];
  }
  for (int i = tid; i < G * hd; i += THREADS) acc_s[i] = 0.f;
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // stage tile `tile` into buffer `buf`: cp.async for live slots, zeros
  // for slots past `last` (never read; zero keeps 0 * v finite)
  auto stage = [&](int tile, int buf) {
    T* kb = kv_s + static_cast<size_t>(buf) * 2 * TS * hd;
    T* vb = kb + TS * hd;
    for (int c = tid; c < TS * cpr; c += THREADS) {
      const int t = c / cpr;
      const int ch = c - t * cpr;
      const int slot = tile * TS + t;
      T* kd = kb + t * hd + ch * CE;
      T* vd = vb + t * hd + ch * CE;
      if (slot <= last) {
        const size_t off =
            (layout.row(b, slot) * Kv + kvh) * static_cast<size_t>(hd) +
            static_cast<size_t>(ch) * CE;
        cp_async16(kd, k_cache + off);
        cp_async16(vd, v_cache + off);
      } else {
        *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
  };

  const int n_tiles = last / TS + 1;
  const int t_begin = split * tps;
  const int t_end = min(n_tiles, t_begin + tps);
  if (t_begin < t_end) stage(t_begin, 0);
  for (int tile = t_begin; tile < t_end; ++tile) {
    const int buf = (tile - t_begin) & 1;
    if (tile + 1 < t_end) {
      stage(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kb = kv_s + static_cast<size_t>(buf) * 2 * TS * hd;
    const T* vb = kb + TS * hd;

    // scores: warp per slot, lanes across head_dim
    for (int t = warp; t < TS; t += WARPS) {
      const bool live = tile * TS + t <= last;
      const T* kr = kb + t * hd;
      for (int g = 0; g < G; ++g) {
        float a = 0.f;
        for (int d = lane; d < hd; d += 32) {
          a = fmaf(q_s[g * hd + d], to_float(kr[d]), a);
        }
        a = warp_sum(a) * scale;
        if (softcap > 0.f) a = softcap * tanhf(a / softcap);
        if (lane == 0) p_s[g * TS + t] = live ? a : NEG_INF;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += WARPS) {  // online softmax, lane = slot
      const float s = p_s[g * TS + lane];
      const float m_prev = m_s[g];
      const float mx = warp_max(fmaxf(m_prev, s));
      const float e = expf(s - mx);
      const float sum = warp_sum(e);
      p_s[g * TS + lane] = e;
      if (lane == 0) {
        const float corr = expf(m_prev - mx);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = mx;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * hd; i += THREADS) {
      const int g = i / hd;
      const int d = i - g * hd;
      const float* pr = p_s + g * TS;
      float a = acc_s[i] * c_s[g];
#pragma unroll 8
      for (int t = 0; t < TS; ++t) a = fmaf(pr[t], to_float(vb[t * hd + d]), a);
      acc_s[i] = a;
    }
    __syncthreads();  // the buffer is refilled two tiles on
  }

  const size_t pidx = (static_cast<size_t>(b) * Kv + kvh) * NS + split;
  for (int i = tid; i < G * hd; i += THREADS) {
    part_acc[pidx * G * hd + i] = acc_s[i];
  }
  if (tid < G) {
    part_m[pidx * G + tid] = m_s[tid];
    part_l[pidx * G + tid] = l_s[tid];
  }
}

// Grid (B, Kv): merge the NS partials of each (sequence, kv head).  Empty
// splits carry m = NEG_INF and weigh exactly 0.
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_merge(const float* __restrict__ part_acc,
                   const float* __restrict__ part_m,
                   const float* __restrict__ part_l, T* __restrict__ out,
                   int Kv, int G, int hd, int NS) {
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const size_t p0 = (static_cast<size_t>(b) * Kv + kvh) * NS;
  T* ob = out + (static_cast<size_t>(b) * Kv * G + static_cast<size_t>(kvh) * G) * hd;
  for (int i = threadIdx.x; i < G * hd; i += THREADS) {
    const int g = i / hd;
    float mg = NEG_INF;
    for (int s = 0; s < NS; ++s) mg = fmaxf(mg, part_m[(p0 + s) * G + g]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < NS; ++s) {
      const float w = expf(part_m[(p0 + s) * G + g] - mg);
      l = fmaf(part_l[(p0 + s) * G + g], w, l);
      a = fmaf(part_acc[(p0 + s) * G * hd + i], w, a);
    }
    ob[i] = from_float<T>(a / fmaxf(l, 1e-37f));
  }
}

// Launch the partial kernel on grid (B, Kv, NS) and the merge on (B, Kv).
// scratch holds B*Kv*NS*G*(hd+2) floats.  Returns the cudaError_t.
template <typename T, typename Layout>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const Layout& layout, void* out, void* scratch, int B, int Kv,
           int G, int hd, int NS, int tps, float scale, float softcap,
           cudaStream_t stream) {
  const size_t head = (2 * static_cast<size_t>(G) * hd + G * TS + 3 * G + 3) & ~size_t(3);
  const size_t smem = sizeof(float) * head + sizeof(T) * 4 * TS * hd;
  auto partial = decode_partial<T, Layout>;
  cudaError_t err = allow_smem(partial, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n_part = static_cast<size_t>(B) * Kv * NS * G;
  float* part_acc = static_cast<float*>(scratch);
  float* part_m = part_acc + n_part * hd;
  float* part_l = part_m + n_part;
  partial<<<dim3(B, Kv, NS), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_cache),
      static_cast<const T*>(v_cache), layout, part_acc, part_m, part_l, Kv, G,
      hd, tps, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_merge<T><<<dim3(B, Kv), THREADS, 0, stream>>>(
      part_acc, part_m, part_l, static_cast<T*>(out), Kv, G, hd, NS);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode
}  // namespace repro
