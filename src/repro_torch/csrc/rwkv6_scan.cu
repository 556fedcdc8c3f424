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
// Two kernels, chosen per call by ops.rwkv6_plan:
//
// rwkv6_step_kernel (S = 1, a decode step): o = r (S + (u k) v^T) and
// S' = diag(exp(lw)) S + k v^T.  Bound: bytes, the fp32 state read and
// written once (16 KB each per head at K = V = 64).  The V columns are
// independent, so CTAs of 128 threads take 16 columns of one (b, h):
// 1,024 CTAs at B = 8, H = 32 keep the whole state read in flight at
// once, in 16-byte loads.  No chunk staging, no cumsum, no (L, L) product.
//
// rwkv6_chunk_kernel (S > 1): one CTA per (b, h) walks chunks of L = 32
// tokens in order, the (K, V) state in shared memory.  Bound: operations.
// The chunk's three products, q_int S, A V and k_dec^T V, and the
// off-diagonal block of A run on the tensor cores (mma.sync m16n8k8
// TF32) with every fp32 operand split into a TF32 hi and lo part
// (3xTF32: lo hi + hi lo + hi hi), so that the products keep fp32
// accuracy: a decay-scaled operand rounded to TF32 or bf16 would not hold
// the 2e-3 tolerance against the stepwise recurrence.  bf16 v is exact in
// TF32 and is not split.  The log-space rule of the reference holds: every
// exponent is <= 0, and each is a sum of log-decays over just the tokens
// it spans, never a difference of two cumsums (which cancels at strong
// decays).  A chunk is two sub-chunks of 16; for t in the later one and s
// in the earlier one, exp(la_prev_t - la_s) = exp(la_prev_t - la_15)
// exp(la_15 - la_s), both factors <= 1, so that block of A is a
// (16 x K) x (K x 16) product of decay-scaled r and k.  In the two
// diagonal 16 x 16 blocks, for s < t, it is the product of the step
// decays exp(lw) of the tokens between them, as the stepwise recurrence
// takes it; the masked entries are never evaluated.  The next chunk's
// inputs are copied with cp.async while the current one computes.
//
// Any S >= 1, K, V <= 64 (zero-padded to 64 in shared memory); the last
// chunk runs with its n < L valid rows, the others padded with lw = 0 and
// r = k = v = 0, which leaves every sum unchanged.

#include "common.cuh"

namespace {

constexpr int L = 32;       // chunk length (the TPU kernel's default chunk)
constexpr int SUB = 16;     // sub-chunk: the MMA's 16 rows
constexpr int KP = 64;      // K and V padded
constexpr int THREADS = 256;
constexpr int PR = KP + 4;  // row stride of the (L, K) tiles
constexpr int PT = KP + 8;  // row stride of k_dec (read transposed), v, S
constexpr int PA = L + 4;   // row stride of A

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 3xTF32 operands: x = hi + lo exactly, hi x with its low 13 mantissa
// bits cleared (a TF32 value), lo the fp32 rest, of which the MMA reads
// the top 10 mantissa bits (an error of 2^-20 |x| at most)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// m16n8k8 fragments (g = lane / 4, q = lane % 4), split into hi and lo.
// A (16 x 8) at (r0, c0) of a row-major tile p of row stride ld, or of
// its transpose; B (8 x 8) at (k0, n0) of a row-major (k, n) tile, or of
// one stored as (n, k).  An EXACT B holds TF32 values already (bf16
// inputs): its lo part is zero and is neither formed nor multiplied.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split4(FragA& f, float a0, float a1, float a2,
                                       float a3) {
  split_tf32(a0, f.hi[0], f.lo[0]);
  split_tf32(a1, f.hi[1], f.lo[1]);
  split_tf32(a2, f.hi[2], f.lo[2]);
  split_tf32(a3, f.hi[3], f.lo[3]);
}

__device__ __forceinline__ void frag_a(FragA& f, const float* p, int ld,
                                       int r0, int c0, int g, int q) {
  split4(f, p[(r0 + g) * ld + c0 + q], p[(r0 + g + 8) * ld + c0 + q],
         p[(r0 + g) * ld + c0 + q + 4], p[(r0 + g + 8) * ld + c0 + q + 4]);
}

__device__ __forceinline__ void frag_a_t(FragA& f, const float* p, int ld,
                                         int r0, int c0, int g, int q) {
  split4(f, p[(c0 + q) * ld + r0 + g], p[(c0 + q) * ld + r0 + g + 8],
         p[(c0 + q + 4) * ld + r0 + g], p[(c0 + q + 4) * ld + r0 + g + 8]);
}

template <bool EXACT>
__device__ __forceinline__ void split2(FragB& f, float b0, float b1) {
  if constexpr (EXACT) {
    f.hi[0] = __float_as_uint(b0);
    f.hi[1] = __float_as_uint(b1);
  } else {
    split_tf32(b0, f.hi[0], f.lo[0]);
    split_tf32(b1, f.hi[1], f.lo[1]);
  }
}

template <bool EXACT = false>
__device__ __forceinline__ void frag_b(FragB& f, const float* p, int ld,
                                       int k0, int n0, int g, int q) {
  split2<EXACT>(f, p[(k0 + q) * ld + n0 + g], p[(k0 + q + 4) * ld + n0 + g]);
}

__device__ __forceinline__ void frag_b_t(FragB& f, const float* p, int ld,
                                         int k0, int n0, int g, int q) {
  split2<false>(f, p[(n0 + g) * ld + k0 + q], p[(n0 + g) * ld + k0 + q + 4]);
}

// d += a b: lo hi, hi lo (unless b is EXACT), hi hi
template <bool EXACT = false>
__device__ __forceinline__ void mma3(float* d, const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  if constexpr (!EXACT) mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

template <typename T>
struct Smem {
  float r[L * PR], k[L * PR];         // the chunk's r and k, fp32
  float w[L * PR];                    // lw, then the step decays exp(lw)
  float qi[L * PR];                   // r exp(la_prev)
  float kd[L * PT];                   // k exp(la_L - la)
  float qt[SUB * PR];                 // rows 16..31: r exp(la_prev - la_15)
  float kt[SUB * PR];                 // rows 0..15: k exp(la_15 - la)
  float v[L * PT];                    // the chunk's v
  float st[KP * PT];                  // the state (K x V)
  float A[L * PA];                    // intra-chunk weights, bonus diagonal
  float seg[4 * KP];                  // lw summed over 8 rows, per channel
  float laL[KP], u[KP];
  // the next chunk's r, k, v as loaded (rows of K or V values) and lw
  alignas(16) T sr[L * KP], sk[L * KP], sv[L * KP];
  alignas(16) float slw[L * KP];
};

// The 16-byte pieces of one chunk's inputs, row by row: a row's r, k, lw
// and v pieces in order.  Thread tid copies pieces tid, tid + THREADS, ...
// with cp.async (zero fill past the last token) and later widens the
// same pieces into the fp32 tiles, so a thread touches only staging
// bytes it wrote itself.
struct Pieces {
  int rk, lw, v;   // pieces a row of r (and of k), of lw, of v
  float inv_row;   // 1 / pieces a row
  __device__ int row() const { return 2 * rk + lw + v; }
  // row t, the piece's array (0 r, 1 k, 2 lw, 3 v) and index in its row
  __device__ void locate(int p, int& t, int& arr, int& i) const {
    t = static_cast<int>((p + 0.5f) * inv_row);
    i = p - t * row();
    arr = 0;
    if (i >= rk) { i -= rk; arr = 1; }
    if (arr == 1 && i >= rk) { i -= rk; arr = 2; }
    if (arr == 2 && i >= lw) { i -= lw; arr = 3; }
  }
};

template <typename T>
__device__ __forceinline__ void stage(Smem<T>& sm, const Pieces& pc,
                                      const T* r, const T* k, const T* v,
                                      const float* lw, int b, int S, int H,
                                      int h, int K, int V, int c0, int tid) {
  constexpr int E = 16 / sizeof(T);   // T values a piece
  const int n = min(L, S - c0);
  const size_t row0 = (static_cast<size_t>(b) * S + c0) * H + h;
  for (int p = tid; p < L * pc.row(); p += THREADS) {
    int t, arr, i;
    pc.locate(p, t, arr, i);
    const size_t g = row0 + static_cast<size_t>(min(t, n - 1)) * H;
    const void* src;
    void* dst;
    if (arr < 2) {
      src = (arr ? k : r) + g * K + i * E;
      dst = (arr ? sm.sk : sm.sr) + t * K + i * E;
    } else if (arr == 2) {
      src = lw + g * K + i * 4;
      dst = sm.slw + t * K + i * 4;
    } else {
      src = v + g * V + i * E;
      dst = sm.sv + t * V + i * E;
    }
    repro::cp_async16_zfill(dst, src, t < n);
  }
  repro::cp_async_commit();
}

// Widen this thread's staged pieces into the fp32 tiles (after its copies
// have landed)
template <typename T>
__device__ __forceinline__ void unstage(Smem<T>& sm, const Pieces& pc, int K,
                                        int V, int tid) {
  constexpr int E = 16 / sizeof(T);
  for (int p = tid; p < L * pc.row(); p += THREADS) {
    int t, arr, i;
    pc.locate(p, t, arr, i);
    if (arr == 2) {
      *reinterpret_cast<float4*>(sm.w + t * PR + 4 * i) =
          *reinterpret_cast<const float4*>(sm.slw + t * K + 4 * i);
      continue;
    }
    float f[E];
    float* d;
    if (arr < 2) {
      repro::load_chunk((arr ? sm.sk : sm.sr) + t * K + i * E, f);
      d = (arr ? sm.k : sm.r) + t * PR + i * E;
    } else {
      repro::load_chunk(sm.sv + t * V + i * E, f);
      d = sm.v + t * PT + i * E;
    }
#pragma unroll
    for (int e = 0; e < E; e += 4)
      *reinterpret_cast<float4*>(d + e) =
          make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
  }
}

// The same tiles loaded directly, element by element: widths whose rows
// are not 16-byte pieces
template <typename T>
__device__ __forceinline__ void load_direct(Smem<T>& sm, const T* r,
                                            const T* k, const T* v,
                                            const float* lw, int b, int S,
                                            int H, int h, int K, int V,
                                            int c0, int tid) {
  const int n = min(L, S - c0);
  for (int i = tid; i < L * KP; i += THREADS) {
    const int t = i / KP, c = i % KP;
    const size_t row = (static_cast<size_t>(b) * S + c0 + t) * H + h;
    const bool ok = t < n && c < K;
    sm.r[t * PR + c] = ok ? to_float(r[row * K + c]) : 0.f;
    sm.k[t * PR + c] = ok ? to_float(k[row * K + c]) : 0.f;
    sm.w[t * PR + c] = ok ? lw[row * K + c] : 0.f;
    sm.v[t * PT + c] = t < n && c < V ? to_float(v[row * V + c]) : 0.f;
  }
}

// The decays of one chunk, in two steps split by a barrier.  Thread
// (seg, c), seg = tid / 64, takes rows 8 seg .. 8 seg + 7 of channel c
// (a warp: a row of 32 channels at a time).  First each thread sums its
// lw; then, from the four segment sums, every decay is the exp of a sum
// over just the tokens it spans: q_int = r exp(la_prev), k_dec =
// k exp(la_L - la), the off-diagonal block's operands (rows 16..31:
// r exp(la_prev - la_15); rows 0..15: k exp(la_15 - la)), the step
// decays exp(lw) (channels < K; the padding keeps lw = 0) and la_L.
template <typename T>
__device__ __forceinline__ void segment_sums(Smem<T>& sm, int tid) {
  const int c = tid % KP, seg = tid / KP;
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) tot += sm.w[(8 * seg + i) * PR + c];
  sm.seg[seg * KP + c] = tot;
}

template <typename T>
__device__ __forceinline__ void decays(Smem<T>& sm, int tid, int K) {
  const int c = tid % KP, seg = tid / KP;
  float sums[4], before = 0.f, after = 0.f;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    sums[s] = sm.seg[s * KP + c];
    if (s < seg) before += sums[s];
    if (s > seg) after += sums[s];
  }
  // the other segment of the same sub-chunk: rows 16..31 count from row
  // 16 (segment 3 adds segment 2), rows 0..15 up to row 15 (segment 0
  // adds segment 1)
  const float in_sub = seg == 3 ? sums[2] : seg == 0 ? sums[1] : 0.f;
  float lw[8], pre[8], suf[8];
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    lw[i] = sm.w[(8 * seg + i) * PR + c];
    pre[i] = run;                     // this segment's rows before i
    run += lw[i];
  }
  run = 0.f;
#pragma unroll
  for (int i = 7; i >= 0; --i) {
    suf[i] = run;                     // this segment's rows after i
    run += lw[i];
  }
  if (seg == 3) sm.laL[c] = before + sums[3];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = 8 * seg + i;
    const float kv = sm.k[t * PR + c], rv = sm.r[t * PR + c];
    sm.kd[t * PT + c] = kv * __expf(after + suf[i]);
    sm.qi[t * PR + c] = rv * __expf(before + pre[i]);
    if (t >= SUB)
      sm.qt[(t - SUB) * PR + c] =
          rv * __expf((seg == 3 ? in_sub : 0.f) + pre[i]);
    else
      sm.kt[t * PR + c] = kv * __expf((seg == 0 ? in_sub : 0.f) + suf[i]);
    if (c < K) sm.w[t * PR + c] = __expf(lw[i]);
  }
}

// The two diagonal 16 x 16 blocks of A.  For s < t in one sub-chunk,
// exp(la_prev_t - la_s) is the product of the step decays of the tokens
// s + 1 .. t - 1, built up as s walks down from t - 1, the same products
// the stepwise recurrence takes.  Warp w takes rows 4w..4w+3, lane =
// 8 j + channel group (8 channels each); each lane keeps its partial sum
// for every s, and the groups are summed by shuffles at the end.  Then
// the bonus r . (u k) on the diagonal and zeros above it.
template <typename T>
__device__ __forceinline__ void diag_blocks(Smem<T>& sm, int warp, int lane) {
  const int j = lane / 8, cg = lane % 8, t = 4 * warp + j;
  const int s0 = (t / SUB) * SUB, dmax = 4 * warp + 3 - s0;  // uniform
  float rv[8], p[8], kv[8], wv[8], part[SUB];
  const float4* r4 = reinterpret_cast<const float4*>(sm.r + t * PR + 8 * cg);
  *reinterpret_cast<float4*>(rv) = r4[0];
  *reinterpret_cast<float4*>(rv + 4) = r4[1];
  {   // part[0]: the bonus
    const float4* k4 = reinterpret_cast<const float4*>(sm.k + t * PR + 8 * cg);
    const float4* u4 = reinterpret_cast<const float4*>(sm.u + 8 * cg);
    *reinterpret_cast<float4*>(kv) = k4[0];
    *reinterpret_cast<float4*>(kv + 4) = k4[1];
    *reinterpret_cast<float4*>(wv) = u4[0];
    *reinterpret_cast<float4*>(wv + 4) = u4[1];
    part[0] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) part[0] += rv[e] * (wv[e] * kv[e]);
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) p[e] = 1.f;
#pragma unroll
  for (int d = 1; d < SUB; ++d) {   // s = t - d
    part[d] = 0.f;
    if (d > dmax) continue;          // uniform across the warp
    const int s = max(t - d, s0);
    const float4* k4 = reinterpret_cast<const float4*>(sm.k + s * PR + 8 * cg);
    const float4* w4 = reinterpret_cast<const float4*>(sm.w + s * PR + 8 * cg);
    *reinterpret_cast<float4*>(kv) = k4[0];
    *reinterpret_cast<float4*>(kv + 4) = k4[1];
    *reinterpret_cast<float4*>(wv) = w4[0];
    *reinterpret_cast<float4*>(wv + 4) = w4[1];
    float x = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      x += rv[e] * kv[e] * p[e];
      p[e] *= wv[e];
    }
    part[d] = t - d >= s0 ? x : 0.f;
  }
#pragma unroll
  for (int d = 0; d < SUB; ++d) {
    if (d > dmax) continue;
    part[d] += __shfl_xor_sync(0xffffffffu, part[d], 1);
    part[d] += __shfl_xor_sync(0xffffffffu, part[d], 2);
    part[d] += __shfl_xor_sync(0xffffffffu, part[d], 4);
    if (d % 8 == cg && t - d >= s0) sm.A[t * PA + t - d] = part[d];
  }
  for (int s = t + 1 + cg; s < s0 + SUB; s += 8) sm.A[t * PA + s] = 0.f;
}

// Grid (B * H).  Warp w takes the 16 x 8 tiles 2w, 2w + 1 of o (L x V;
// rows 16 (w / 4) ..) and 4w .. 4w + 3 of S (rows 16 (w / 2) ..), so that
// each A fragment serves all of them.  ``staged``: rows of r, k, lw and v
// are 16-byte pieces, copied by cp.async one chunk ahead; else loaded
// directly.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
rwkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ lw,
                   const float* __restrict__ u, const float* __restrict__ s0,
                   float* __restrict__ o, float* __restrict__ s_out, int S,
                   int H, int K, int V, int staged) {
  constexpr bool EXACT_V = sizeof(T) == 2;     // bf16 v is TF32-exact
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int nc = (S + L - 1) / L;
  const size_t kv = static_cast<size_t>(K) * V;
  Pieces pc{K * static_cast<int>(sizeof(T)) / 16, K / 4,
            V * static_cast<int>(sizeof(T)) / 16, 0.f};
  pc.inv_row = 1.f / pc.row();

  // the state, and zeros in every tile's padding (columns past K or V)
  for (int i = tid; i < KP * KP; i += THREADS) {
    const int kk = i / KP, c = i % KP;
    sm.st[kk * PT + c] = kk < K && c < V ? s0[bh * kv + kk * V + c] : 0.f;
  }
  for (int c = tid; c < KP; c += THREADS) sm.u[c] = c < K ? u[h * K + c] : 0.f;
  if (staged) {
    for (int i = tid; i < L * PR; i += THREADS) sm.r[i] = sm.k[i] = sm.w[i] = 0.f;
    for (int i = tid; i < L * PT; i += THREADS) sm.v[i] = 0.f;
    __syncthreads();   // the zeros before any thread's first unstage
    stage(sm, pc, r, k, v, lw, b, S, H, h, K, V, 0, tid);
  }
  const int mo = warp / 4, ms = warp / 2;      // the warp's row blocks
  for (int ci = 0; ci < nc; ++ci) {
    const int c0 = ci * L, n = min(L, S - c0);
    if (staged) {
      repro::cp_async_wait<0>();
      unstage(sm, pc, K, V, tid);
      if (ci + 1 < nc)
        stage(sm, pc, r, k, v, lw, b, S, H, h, K, V, c0 + L, tid);
    } else {
      load_direct(sm, r, k, v, lw, b, S, H, h, K, V, c0, tid);
    }
    __syncthreads();
    segment_sums(sm, tid);
    __syncthreads();
    decays(sm, tid, K);
    __syncthreads();

    // the diagonal blocks of A, its off-diagonal block (warps 0 and 1,
    // even and odd k-steps in two sums) and o = q_int S (even and odd
    // k-steps apart, so that four MMA chains interleave)
    diag_blocks(sm, warp, lane);
    if (warp < 2) {
      float d[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KP / 8; ++ks) {
        FragA a;
        FragB bb;
        frag_a(a, sm.qt, PR, 0, 8 * ks, g, q);
        frag_b_t(bb, sm.kt, PR, 8 * ks, 8 * warp, g, q);
        mma3(d[ks % 2], a, bb);
      }
      const int s = 8 * warp + 2 * q;
      sm.A[(SUB + g) * PA + s] = d[0][0] + d[1][0];
      sm.A[(SUB + g) * PA + s + 1] = d[0][1] + d[1][1];
      sm.A[(SUB + g + 8) * PA + s] = d[0][2] + d[1][2];
      sm.A[(SUB + g + 8) * PA + s + 1] = d[0][3] + d[1][3];
    }
    float acc[2][2][4] = {};
#pragma unroll
    for (int ks = 0; ks < KP / 8; ++ks) {
      FragA a;
      frag_a(a, sm.qi, PR, SUB * mo, 8 * ks, g, q);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB bb;
        frag_b(bb, sm.st, PT, 8 * ks, 8 * ((2 * warp + j) % 8), g, q);
        mma3(acc[j][ks % 2], a, bb);
      }
    }
    __syncthreads();

    // o += A V (s <= t only), then the store
    for (int ks = 0; ks < 2 * (mo + 1); ++ks) {
      FragA a;
      frag_a(a, sm.A, PA, SUB * mo, 8 * ks, g, q);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        FragB bb;
        frag_b<EXACT_V>(bb, sm.v, PT, 8 * ks, 8 * ((2 * warp + j) % 8), g, q);
        mma3<EXACT_V>(acc[j][ks % 2], a, bb);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = 8 * ((2 * warp + j) % 8) + 2 * q;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = SUB * mo + g + 8 * (e / 2), cc = col + e % 2;
        if (t < n && cc < V)
          o[((static_cast<size_t>(b) * S + c0 + t) * H + h) * V + cc] =
              acc[j][0][e] + acc[j][1][e];
      }
    }
    // S' = diag(exp(la_L)) S + k_dec^T V on the warp's tiles of S
    const int row = SUB * ms + g;
    const float d0 = __expf(sm.laL[row]), d1 = __expf(sm.laL[row + 8]);
    float d[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * ((4 * warp + j) % 8) + 2 * q;
      d[j][0] = d0 * sm.st[row * PT + col];
      d[j][1] = d0 * sm.st[row * PT + col + 1];
      d[j][2] = d1 * sm.st[(row + 8) * PT + col];
      d[j][3] = d1 * sm.st[(row + 8) * PT + col + 1];
    }
#pragma unroll
    for (int ks = 0; ks < L / 8; ++ks) {
      FragA a;
      frag_a_t(a, sm.kd, PT, SUB * ms, 8 * ks, g, q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragB bb;
        frag_b<EXACT_V>(bb, sm.v, PT, 8 * ks, 8 * ((4 * warp + j) % 8), g, q);
        mma3<EXACT_V>(d[j], a, bb);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = 8 * ((4 * warp + j) % 8) + 2 * q;
      sm.st[row * PT + col] = d[j][0];
      sm.st[row * PT + col + 1] = d[j][1];
      sm.st[(row + 8) * PT + col] = d[j][2];
      sm.st[(row + 8) * PT + col + 1] = d[j][3];
    }
    __syncthreads();
  }
  for (int i = tid; i < K * V; i += THREADS)
    s_out[bh * kv + i] = sm.st[(i / V) * PT + i % V];
}

// S = 1.  Grid (ceil(V / 16), B * H), 128 threads: thread (kg, cg) takes
// columns 4 cg .. 4 cg + 3 of the CTA's 16 and rows kg and kg + 32.
constexpr int STEP_COLS = 16;
constexpr int STEP_THREADS = 128;
constexpr int STEP_ROWS = STEP_THREADS / 4;   // row groups
constexpr int STEP_WARPS = STEP_THREADS / 32;

template <typename T, bool VEC>
__global__ void __launch_bounds__(STEP_THREADS)
rwkv6_step_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ lw,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ o, float* __restrict__ s_out, int H,
                  int K, int V) {
  constexpr int NR = KP / STEP_ROWS;
  __shared__ float part[STEP_WARPS][STEP_COLS];
  __shared__ float du_part[STEP_WARPS];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int cg = tid % 4, kg = tid / 4;
  const int bh = blockIdx.y, h = bh % H;
  const int j0 = blockIdx.x * STEP_COLS + 4 * cg;
  const size_t kv = static_cast<size_t>(K) * V;
  const float* st = s0 + bh * kv;
  float* out = s_out + bh * kv;
  const T* rp = r + static_cast<size_t>(bh) * K;
  const T* kp = k + static_cast<size_t>(bh) * K;
  const float* wp = lw + static_cast<size_t>(bh) * K;

  // every load first: the state rows, r, k, lw, v and the bonus terms
  float sv[NR][4], rr[NR], kk[NR], ww[NR], vv[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    vv[e] = j0 + e < V ? to_float(v[static_cast<size_t>(bh) * V + j0 + e])
                       : 0.f;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int row = kg + STEP_ROWS * i;
    const bool ok = row < K;
    rr[i] = ok ? to_float(rp[row]) : 0.f;
    kk[i] = ok ? to_float(kp[row]) : 0.f;
    ww[i] = ok ? wp[row] : 0.f;
    if (VEC && ok && j0 < V) {
      const float4 s4 =
          *reinterpret_cast<const float4*>(st + static_cast<size_t>(row) * V + j0);
      sv[i][0] = s4.x;
      sv[i][1] = s4.y;
      sv[i][2] = s4.z;
      sv[i][3] = s4.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sv[i][e] = ok && j0 + e < V ? st[static_cast<size_t>(row) * V + j0 + e]
                                    : 0.f;
    }
  }
  float du = tid < K ? to_float(rp[tid]) * (u[h * K + tid] * to_float(kp[tid]))
                     : 0.f;

  float op[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int row = kg + STEP_ROWS * i;
    const float dec = expf(ww[i]);
    float ns[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      op[e] += rr[i] * sv[i][e];
      ns[e] = dec * sv[i][e] + kk[i] * vv[e];
    }
    if (row >= K || j0 >= V) continue;
    if (VEC) {
      *reinterpret_cast<float4*>(out + static_cast<size_t>(row) * V + j0) =
          make_float4(ns[0], ns[1], ns[2], ns[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + e < V) out[static_cast<size_t>(row) * V + j0 + e] = ns[e];
    }
  }
  // sum the row groups (kg = lane / 4 within a warp), then the warps
#pragma unroll
  for (int off = 4; off < 32; off *= 2) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      op[e] += __shfl_xor_sync(0xffffffffu, op[e], off);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    du += __shfl_xor_sync(0xffffffffu, du, off);
  if (lane < 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) part[warp][4 * lane + e] = op[e];
  }
  if (lane == 0) du_part[warp] = du;
  __syncthreads();
  const int j = blockIdx.x * STEP_COLS + tid;
  if (tid < STEP_COLS && j < V) {
    float acc = 0.f, dsum = 0.f;
#pragma unroll
    for (int w = 0; w < STEP_WARPS; ++w) {
      acc += part[w][tid];
      dsum += du_part[w];
    }
    o[static_cast<size_t>(bh) * V + j] =
        acc + dsum * to_float(v[static_cast<size_t>(bh) * V + j]);
  }
}

template <typename T>
int launch(int design, const void* r_, const void* k_, const void* v_,
           const void* lw_, const void* u_, const void* s0_, void* o_,
           void* s_out_, int B, int S, int H, int K, int V,
           cudaStream_t stream) {
  const T* r = static_cast<const T*>(r_);
  const T* k = static_cast<const T*>(k_);
  const T* v = static_cast<const T*>(v_);
  const float* lw = static_cast<const float*>(lw_);
  const float* u = static_cast<const float*>(u_);
  const float* s0 = static_cast<const float*>(s0_);
  float* o = static_cast<float*>(o_);
  float* s_out = static_cast<float*>(s_out_);
  if (K > KP || V > KP || S < 1 || (design == 0) != (S == 1) ||
      (design != 0 && design != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (design == 0) {
    const dim3 grid((V + STEP_COLS - 1) / STEP_COLS, B * H);
    if (V % 4 == 0)
      rwkv6_step_kernel<T, true><<<grid, STEP_THREADS, 0, stream>>>(
          r, k, v, lw, u, s0, o, s_out, H, K, V);
    else
      rwkv6_step_kernel<T, false><<<grid, STEP_THREADS, 0, stream>>>(
          r, k, v, lw, u, s0, o, s_out, H, K, V);
    return static_cast<int>(cudaGetLastError());
  }
  auto kernel = rwkv6_chunk_kernel<T>;
  const size_t smem = sizeof(Smem<T>);
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int staged = (K * sizeof(T)) % 16 == 0 && K % 4 == 0 &&
                     (V * sizeof(T)) % 16 == 0;
  kernel<<<B * H, THREADS, smem, stream>>>(r, k, v, lw, u, s0, o, s_out, S, H,
                                           K, V, staged);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r, k (B,S,H,K), v (B,S,H,V): fp32 or bf16 (is_bf16); lw (B,S,H,K),
// u (H,K), s0 (B,H,K,V), o (B,S,H,V), s_out (B,H,K,V): fp32, contiguous.
// design 0: the step kernel (S = 1); 1: the chunk kernel (S > 1).
// K, V <= 64.  Returns the launch's cudaError_t.
extern "C" int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                                 const void* lw, const void* u,
                                 const void* s0, void* o, void* s_out, int B,
                                 int S, int H, int K, int V, int is_bf16,
                                 int design, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(design, r, k, v, lw, u, s0, o, s_out, B, S,
                                 H, K, V, s);
  return launch<float>(design, r, k, v, lw, u, s0, o, s_out, B, S, H, K, V,
                       s);
}

// Dynamic shared memory of a chunk-kernel CTA, in bytes.
extern "C" int rwkv6_chunk_smem(int is_bf16) {
  return static_cast<int>(is_bf16 ? sizeof(Smem<__nv_bfloat16>)
                                  : sizeof(Smem<float>));
}
