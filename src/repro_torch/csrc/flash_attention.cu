// Forward flash attention, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_fa_kernel; its pallas_call is at :115).
//
// What bounds it on the card: at the serving prefill's shapes (one prompt
// of a few hundred tokens, hd 128) the bytes (q, k, v read once, o written
// once) and the FLOPs (4*S*S*H*hd, about half of it under a causal mask)
// give floors of the same order, a few microseconds each in bf16; fp32
// inputs must stay off the bf16 tensor cores, so for them the fp32 FMA
// rate (67 TFLOP/s) bounds it.
//
// What the design does about it:
//  * one CTA per (b, h, q-tile); the q tile stays on chip while the CTA
//    loops over kv tiles staged in shared memory once each, so q is read
//    once and k/v once per q-tile, with 16-byte coalesced loads;
//  * bf16 with hd <= 128 (the serving path): the products run on the
//    tensor cores (mma.sync m16n8k16, fp32 accumulate); see
//    flash_mma_kernel;
//  * fp32, or hd > 128: the products run on the fp32 cores with register
//    tiling: each of the 256 threads owns a (BQ/16) x (BK/16) block of
//    scores and a (BQ/16) x (HD/16) block of the output accumulator, kept
//    in registers across kv tiles, so every value read from shared memory
//    feeds 4 to 16 multiply-adds; padded rows keep the reads free of bank
//    conflicts;
//  * kv tiles wholly outside the causal / sliding-window band are skipped,
//    as _fa_kernel does with pl.when, so a causal prefill does about half
//    the work;
//  * any S: rows and keys past S are masked at the ragged edge (the TPU
//    version needs S divisible by its blocks; prompt lengths vary);
//  * the online fp32 softmax of the TPU kernel, normalized by
//    max(l, 1e-37), in the reference's pre-expanded (B,S,H,hd) layout.
// Still simple: no wgmma, no TMA, no pipelining of the tile loads.

#include <type_traits>

#include "common.cuh"

namespace {

using repro::Chunk;
using repro::NEG_INF;

constexpr int THREADS = 256;  // a 16 x 16 grid of threads
constexpr int WARPS = THREADS / 32;

template <typename T, int HD, int BQ, int BK>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int H,
             float scale, float softcap, int causal, int window) {
  constexpr int RS = HD + 1;   // padded q/k row stride
  constexpr int PS = BK + 1;   // padded score row stride
  constexpr int RM = BQ / 16;  // rows per thread: ty + 16*i
  constexpr int CN = BK / 16;  // score columns per thread: tx + 16*j
  constexpr int DN = HD / 16;  // output columns per thread: tx + 16*j
  constexpr int CE = Chunk<T>::N;
  constexpr int CPR = HD / CE;  // 16-byte chunks per row

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;              // BQ x RS
  float* k_s = q_s + BQ * RS;     // BK x RS
  float* v_s = k_s + BK * RS;     // BK x HD
  float* p_s = v_s + BK * HD;     // BQ x PS scores, then probabilities
  float* m_s = p_s + BQ * PS;     // BQ running max
  float* l_s = m_s + BQ;          // BQ running sum
  float* c_s = l_s + BQ;          // BQ correction of this tile

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const size_t rs = static_cast<size_t>(H) * HD;  // stride between positions
  const size_t base = static_cast<size_t>(b) * S * rs + static_cast<size_t>(h) * HD;
  const int q0 = qt * BQ;

  for (int c = tid; c < BQ * CPR; c += THREADS) {
    const int i = c / CPR;
    const int ch = c - i * CPR;
    float f[CE];
    if (q0 + i < S) {
      repro::load_chunk(q + base + (q0 + i) * rs + ch * CE, f);
    } else {
#pragma unroll
      for (int e = 0; e < CE; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < CE; ++e) q_s[i * RS + ch * CE + e] = f[e];
  }
  for (int i = tid; i < BQ; i += THREADS) {
    m_s[i] = NEG_INF;
    l_s[i] = 0.f;
  }
  float acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[i][j] = 0.f;

  // the band of kv tiles that can hold a valid key for some row of this tile
  const int q_last = min(q0 + BQ, S) - 1;
  int kt_end = (S + BK - 1) / BK;
  if (causal) kt_end = min(kt_end, q_last / BK + 1);
  int kt_begin = 0;
  if (window > 0) kt_begin = max(0, q0 - window + 1) / BK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    for (int c = tid; c < BK * CPR; c += THREADS) {
      const int j = c / CPR;
      const int ch = c - j * CPR;
      float fk[CE], fv[CE];
      if (k0 + j < S) {
        const size_t off = base + (k0 + j) * rs + ch * CE;
        repro::load_chunk(k + off, fk);
        repro::load_chunk(v + off, fv);
      } else {
#pragma unroll
        for (int e = 0; e < CE; ++e) fk[e] = fv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < CE; ++e) {
        k_s[j * RS + ch * CE + e] = fk[e];
        v_s[j * HD + ch * CE + e] = fv[e];
      }
    }
    __syncthreads();

    // scores: this thread's RM x CN block
    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = q_s[(ty + 16 * i) * RS + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = k_s[(tx + 16 * j) * RS + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int qi = q0 + ty + 16 * i;
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < S && (!causal || kj <= qi) &&
                        (window <= 0 || qi - kj < window);
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        p_s[(ty + 16 * i) * PS + tx + 16 * j] = ok ? x : NEG_INF;
      }
    }
    __syncthreads();

    const int warp = tid / 32;
    const int lane = tid % 32;
    for (int r = warp; r < BQ; r += WARPS) {  // online softmax, a warp a row
      float* pr = p_s + r * PS;
      const float m_prev = m_s[r];
      float mx = m_prev;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, pr[c]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
      for (int c = lane; c < BK; c += 32) {
        const float e = expf(pr[c] - mx);
        pr[c] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(m_prev - mx);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = mx;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + p @ v on this thread's RM x DN block
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RM], vv[DN];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = p_s[(ty + 16 * i) * PS + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) vv[j] = v_s[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();  // the next tile overwrites k_s, v_s and p_s
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= S) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-37f);
    T* orow = out + base + (q0 + r) * rs;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      orow[tx + 16 * j] = repro::from_float<T>(acc[i][j] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs with hd <= 128 run on the tensor cores: mma.sync m16n8k16,
// bf16 operands, fp32 accumulators.  4 warps, each owning 16 rows of a
// 64-row q tile; scores, probabilities and the output stay in registers
// (the accumulator layout of q.k^T is the operand layout of p.v, so p is
// rounded to bf16 and fed on without a trip through shared memory).
// ---------------------------------------------------------------------------
constexpr int MMA_THREADS = 128;
constexpr int MB = 64;  // q rows and kv rows per tile

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two values as one bf16x2 register, ``lo`` in the low half
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ unsigned pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ unsigned ld2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

template <int HD>
__global__ void __launch_bounds__(MMA_THREADS)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out, int S, int H, float scale,
                 float softcap, int causal, int window) {
  using bf16 = __nv_bfloat16;
  constexpr int RS = HD + 8;      // padded row: fragment loads conflict-free
  constexpr int KSTEPS = HD / 16;  // k-steps of q.k^T
  constexpr int NT_S = MB / 8;     // 8-key column tiles of the scores
  constexpr int NT_O = HD / 8;     // 8-wide column tiles of the output
  constexpr int CPR = HD / 8;      // 16-byte chunks per row

  extern __shared__ __align__(16) float smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // MB x RS
  bf16* k_s = q_s + MB * RS;                  // MB x RS
  bf16* v_s = k_s + MB * RS;                  // MB x RS

  const int qt = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;  // fragment row group
  const int tig = lane % 4;  // thread in group
  const size_t rs = static_cast<size_t>(H) * HD;
  const size_t base = static_cast<size_t>(b) * S * rs + static_cast<size_t>(h) * HD;
  const int q0 = qt * MB;

  // positions p0 .. p0+MB-1 of src into a tile; zeros past S
  auto stage = [&](bf16* dst, const bf16* src, int p0) {
    for (int c = tid; c < MB * CPR; c += MMA_THREADS) {
      const int r = c / CPR;
      const int ch = c - r * CPR;
      bf16* d = dst + r * RS + ch * 8;
      if (p0 + r < S) {
        repro::cp_async16(d, src + base + (p0 + r) * rs + ch * 8);
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
      }
    }
  };
  stage(q_s, q, q0);
  repro::cp_async_commit();
  repro::cp_async_wait<0>();
  __syncthreads();

  const int r0 = warp * 16 + gid;  // this thread's rows: r0 and r0 + 8
  unsigned qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const bf16* p = q_s + r0 * RS + kk * 16 + tig * 2;
    qf[kk][0] = ld2(p);
    qf[kk][1] = ld2(p + 8 * RS);
    qf[kk][2] = ld2(p + 8);
    qf[kk][3] = ld2(p + 8 * RS + 8);
  }
  float o[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int qi[2] = {q0 + r0, q0 + r0 + 8};

  const int q_last = min(q0 + MB, S) - 1;
  int kt_end = (S + MB - 1) / MB;
  if (causal) kt_end = min(kt_end, q_last / MB + 1);
  int kt_begin = 0;
  if (window > 0) kt_begin = max(0, q0 - window + 1) / MB;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * MB;
    __syncthreads();  // every warp is done with the previous k/v tile
    stage(k_s, k, k0);
    stage(v_s, v, k0);
    repro::cp_async_commit();
    repro::cp_async_wait<0>();
    __syncthreads();

    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const bf16* kr = k_s + (j * 8 + gid) * RS + tig * 2;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        mma_bf16(s[j], qf[kk], ld2(kr + kk * 16), ld2(kr + kk * 16 + 8));
      }
    }
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const int kj = k0 + j * 8 + tig * 2 + (e & 1);
        const bool ok = kj < S && (!causal || kj <= qi[r]) &&
                        (window <= 0 || qi[r] - kj < window);
        float x = s[j][e] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[j][e] = ok ? x : NEG_INF;
        mx[r] = fmaxf(mx[r], s[j][e]);
      }
    }
    float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row lives on the 4 threads of a group
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = expf(m_r[r] - mx[r]);
      m_r[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - mx[e / 2]);
        sum[e / 2] += s[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + sum[r];
#pragma unroll
    for (int j = 0; j < NT_O; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
#pragma unroll
    for (int kk = 0; kk < MB / 16; ++kk) {
      const unsigned pa[4] = {pack2(s[2 * kk][0], s[2 * kk][1]),
                              pack2(s[2 * kk][2], s[2 * kk][3]),
                              pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* vr = v_s + (kk * 16 + tig * 2) * RS + gid;
#pragma unroll
      for (int j = 0; j < NT_O; ++j) {
        const bf16* vp = vr + j * 8;
        mma_bf16(o[j], pa, pack2(vp[0], vp[RS]),
                 pack2(vp[8 * RS], vp[9 * RS]));
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    inv[r] = 1.f / fmaxf(l_r[r], 1e-37f);
  }
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int col = j * 8 + tig * 2;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qi[r] < S) {
        *reinterpret_cast<unsigned*>(out + base + qi[r] * rs + col) =
            pack2(o[j][2 * r] * inv[r], o[j][2 * r + 1] * inv[r]);
      }
    }
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out, int B,
               int S, int H, float scale, float softcap, int causal,
               int window, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * 3 * MB * (HD + 8);
  auto kernel = flash_mma_kernel<HD>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + MB - 1) / MB, H, B);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      S, H, scale, softcap, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int H, float scale, float softcap, int causal, int window,
           cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16> && HD <= 128) {
    return launch_mma<HD>(q, k, v, out, B, S, H, scale, softcap, causal,
                          window, stream);
  } else {
    // 64 x 64 tiles fit shared memory up to hd 128; wider heads take 32 x 32
    constexpr int BQ = HD <= 128 ? 64 : 32;
    constexpr int BK = BQ;
    const size_t smem = sizeof(float) *
                        (static_cast<size_t>(BQ + BK) * (HD + 1) +
                         static_cast<size_t>(BK) * HD +
                         static_cast<size_t>(BQ) * (BK + 1) + 3 * BQ);
    auto kernel = flash_kernel<T, HD, BQ, BK>;
    cudaError_t err = repro::allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((S + BQ - 1) / BQ, H, B);
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<T*>(out), S, H, scale, softcap,
        causal, window);
    return static_cast<int>(cudaGetLastError());
  }
}

// head_dim is a template argument (registers are sized by it): every
// multiple of 16 up to 256 has its instantiation
template <typename T, int HD = 16>
int launch_for_hd(int hd, const void* q, const void* k, const void* v,
                  void* out, int B, int S, int H, float scale, float softcap,
                  int causal, int window, cudaStream_t stream) {
  if (hd == HD) {
    return launch<T, HD>(q, k, v, out, B, S, H, scale, softcap, causal,
                         window, stream);
  }
  if constexpr (HD < 256) {
    return launch_for_hd<T, HD + 16>(hd, q, k, v, out, B, S, H, scale,
                                     softcap, causal, window, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, out (B,S,H,hd), k/v pre-expanded to H heads; hd a multiple of
// 16, at most 256.  softcap <= 0 and window <= 0 mean none.  Returns the
// launch's cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int hd, float scale,
                                      float softcap, int causal, int window,
                                      int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return launch_for_hd<__nv_bfloat16>(hd, q, k, v, out, B, S, H, scale,
                                        softcap, causal, window, s);
  }
  return launch_for_hd<float>(hd, q, k, v, out, B, S, H, scale, softcap,
                              causal, window, s);
}
