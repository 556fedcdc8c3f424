// Forward flash attention, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (_fa_kernel; its pallas_call is at :115).
//
// What bounds it on the card: at the serving prefill's shapes (one prompt
// of a few hundred tokens, hd 128) the bytes (q, k, v read once, o written
// once) and the FLOPs (4*S*S*H*hd, about half of it under a causal mask)
// give floors of the same order, a few microseconds each in bf16; at
// recurrentgemma's local layers (S 2100, hd 256, window 2048) the FLOPs,
// 4*B*H*hd*|band| at 989 TFLOP/s.  fp32 inputs must stay off the bf16
// tensor cores, so for them the fp32 FMA rate (67 TFLOP/s) bounds it.
//
// bf16, every hd (a multiple of 16 up to 256): flash_wgmma_kernel, built
// from Hopper's warpgroup MMA and its tensor memory accelerator:
//  * one CTA per (b, h, 128-row q tile), three warpgroups: a producer whose
//    one thread issues TMA loads (cp.async.bulk.tensor) of the q tile once
//    and of 64-key K and V tiles into a ring of 2 or 3 stages, completion
//    signalled on mbarriers; two consumer warpgroups of 64 q rows each.
//    setmaxnreg gives the consumers 240 registers a thread, the producer 24;
//  * tiles are 128-byte swizzled in shared memory, boxes of 64 columns; hd
//    is padded to HP, a multiple of 64, by TMA's zero fill past hd, and
//    rows past S are zero-filled the same way (the score mask stays);
//  * S = Q K^T runs on wgmma m64n64k16 with Q and K (K-major) read from
//    shared memory; O += P V on wgmma m64n{HP}k16 with P from registers
//    (the accumulator layout of S is the A layout of P) and V MN-major
//    through the transpose bit;
//  * P is split into hi = bf16(P) and lo = bf16(P - hi), two P V products
//    against the same V tile: P keeps about 16 bits, as the fp32 P of the
//    reference nearly does, for 1.5x the MMA work;
//  * the online fp32 softmax of the TPU kernel, normalized by
//    max(l, 1e-37); the softcap from one exp and one reciprocal
//    (softcap_fast: tanhf and a division per score made softcapped
//    attention ALU-bound); kv tiles wholly outside the causal /
//    sliding-window band are skipped, as _fa_kernel does with pl.when; q
//    tiles run last to first, so the longest causal rows start first.
// fp32 (the parity runs): flash_kernel on the fp32 cores with register
// tiling, each of 256 threads owning a block of scores and of the output
// accumulator, padded shared rows free of bank conflicts.
// Both: any S (rows and keys past S are masked at the ragged edge; the TPU
// version needs S divisible by its blocks), in the reference's
// pre-expanded (B,S,H,hd) layout.

#include "common.cuh"
#include "wgmma.cuh"

namespace {

using repro::Chunk;
using repro::mbar_arrive;
using repro::mbar_arrive_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::NEG_INF;
using repro::smem_u32;
using repro::split2;

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
// bf16: warp-specialized wgmma kernel fed by TMA
// ---------------------------------------------------------------------------
constexpr int WG = 128;          // threads of a warpgroup
constexpr int NC = 2;            // consumer warpgroups, 64 q rows each
constexpr int BM = 64 * NC;      // q rows of a CTA
constexpr int BN = 64;           // keys of a kv tile
constexpr int BOX = 64 * 64 * 2; // one 64-row x 64-column bf16 box, bytes

// one (64 columns, 1 head, 64 rows, 1 sequence) box of a (B,S,H,hd)
// tensor into shared memory, completion counted on ``bar``
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int h,
                                         int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(h), "r"(row),
      "r"(b), "r"(bar)
      : "memory");
}

// two values as one bf16x2 register, ``lo`` in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared memory of the wgmma kernel (from a 1024-byte aligned base): the
// q tile, the K and V rings, each of 64-row x 64-column swizzled boxes,
// then the mbarriers.
template <int HP>
struct Smem {
  static constexpr int NB = HP / 64;                 // boxes across hd
  static constexpr int STAGES = HP <= 192 ? 3 : 2;
  static constexpr int Q = 0;                        // [NC][NB] boxes
  static constexpr int K = Q + NC * NB * BOX;        // [STAGES][NB]
  static constexpr int V = K + STAGES * NB * BOX;    // [STAGES][NB]
  static constexpr int BARS = V + STAGES * NB * BOX; // q, full[], empty[]
  static constexpr int BYTES = BARS + 8 * (1 + 2 * STAGES);
};

// SPLIT (grids too small to fill the card): a CTA takes 64 q rows, and
// its two consumer warpgroups take alternate kv tiles of them, merging
// their (m, l, O) through shared memory at the end: the longest causal
// row's chain of tiles is halved.
template <int HP, bool SPLIT>
__global__ void __launch_bounds__(WG * (NC + 1), 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   __nv_bfloat16* __restrict__ out, int S, int H, int hd,
                   float scale, float softcap, int causal, int window) {
  using L = Smem<HP>;
  constexpr int NB = L::NB;
  constexpr int STAGES = L::STAGES;
  constexpr int ROWS = SPLIT ? 64 : BM;   // q rows of a CTA
  constexpr int QB = SPLIT ? 1 : NC;      // 64-row q boxes of a CTA
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_bar = base + L::BARS;
  const uint32_t full_bar = q_bar + 8;
  const uint32_t empty_bar = full_bar + 8 * STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * ROWS;
  const int wg = threadIdx.x / WG;

  // the band of kv tiles that can hold a valid key for some row of the tile
  const int q_last = min(q0 + ROWS, S) - 1;
  int kt_end = (S + BN - 1) / BN;
  if (causal) kt_end = min(kt_end, q_last / BN + 1);
  int kt_begin = 0;
  if (window > 0) kt_begin = max(0, q0 - window + 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      // lane 0 of each consumer warp that reads the stage
      mbar_init(empty_bar + 8 * s, SPLIT ? 4 : NC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_bar, QB * NB * BOX);
      for (int c = 0; c < QB; ++c)
        for (int j = 0; j < NB; ++j)
          tma_load(base + L::Q + (c * NB + j) * BOX, &q_map, q_bar, 64 * j,
                   h, q0 + 64 * c, b);
      for (int kt = kt_begin; kt < kt_end; ++kt) {
        const int i = kt - kt_begin;
        const int s = i % STAGES;
        mbar_wait(empty_bar + 8 * s, ((i / STAGES) & 1) ^ 1);
        const uint32_t fb = full_bar + 8 * s;
        mbar_arrive_expect_tx(fb, 2 * NB * BOX);
        for (int j = 0; j < NB; ++j) {
          tma_load(base + L::K + (s * NB + j) * BOX, &k_map, fb, 64 * j, h,
                   kt * BN, b);
          tma_load(base + L::V + (s * NB + j) * BOX, &v_map, fb, 64 * j, h,
                   kt * BN, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int ci = wg - 1;
    const int tid = threadIdx.x % WG;
    const int warp = tid / 32;
    const int lane = tid % 32;
    const int gid = lane / 4;
    const int tig = lane % 4;
    const int r_lo = q0 + (SPLIT ? 0 : 64 * ci);  // the warpgroup's rows
    const int qi[2] = {r_lo + 16 * warp + gid, r_lo + 16 * warp + gid + 8};
    constexpr float LOG2E = 1.4426950408889634f;

    float o[HP / 2];
#pragma unroll
    for (int e = 0; e < HP / 2; ++e) o[e] = 0.f;
    float m_r[2] = {NEG_INF, NEG_INF};
    float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums
    const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

    const uint32_t q_tile = base + L::Q + (SPLIT ? 0 : ci * NB * BOX);
    mbar_wait(q_bar, 0);
    for (int kt = kt_begin + (SPLIT ? ci : 0); kt < kt_end;
         kt += (SPLIT ? 2 : 1)) {
      const int i = kt - kt_begin;
      const int s = i % STAGES;
      const int k0 = kt * BN;
      mbar_wait(full_bar + 8 * s, (i / STAGES) & 1);
      const uint32_t k_tile = base + L::K + s * NB * BOX;
      const uint32_t v_tile = base + L::V + s * NB * BOX;

      // S = Q K^T over HP/16 k-steps: 32 bytes along a swizzled 128-byte
      // row per step, the next box every 4
      float sc[BN / 2];
      repro::wgmma::fence_operand(sc);
      repro::wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < HP / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
        repro::wgmma::MMA<BN>::ss(
            sc, repro::wgmma::desc_sw128(q_tile + off, 16, 1024),
            repro::wgmma::desc_sw128(k_tile + off, 16, 1024), kk > 0);
      }
      repro::wgmma::commit();
      repro::wgmma::wait<0>();
      repro::wgmma::fence_operand(sc);

      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int r = (e / 2) % 2;
        const int kj = k0 + 8 * (e / 4) + 2 * tig + (e % 2);
        const bool ok = kj < S && (!causal || kj <= qi[r]) &&
                        (window <= 0 || qi[r] - kj < window);
        float x = sc[e] * scale;
        if (softcap > 0.f) x = repro::softcap_fast(x, softcap, inv_cap);
        sc[e] = ok ? x : NEG_INF;
        mx[r] = fmaxf(mx[r], sc[e]);
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {  // a row lives on the 4 threads of a group
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        corr[r] = exp2f((m_r[r] - mx[r]) * LOG2E);
        m_r[r] = mx[r];
      }
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) {
        const int r = (e / 2) % 2;
        sc[e] = exp2f((sc[e] - mx[r]) * LOG2E);
        sum[r] += sc[e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + sum[r];
#pragma unroll
      for (int e = 0; e < HP / 2; ++e) o[e] *= corr[(e / 2) % 2];

      // O += (P_hi + P_lo) V, 16 keys a step: 16 rows of 128 bytes
      uint32_t p_hi[BN / 16][4], p_lo[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int a = 0; a < 4; ++a)
          split2(sc[8 * kk + 2 * a], sc[8 * kk + 2 * a + 1], p_hi[kk][a],
                 p_lo[kk][a]);
      repro::wgmma::fence_operand(o);
      repro::wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t vd =
            repro::wgmma::desc_sw128(v_tile + kk * 16 * 128, BN * 128, 1024);
        repro::wgmma::MMA<HP>::rs(o, p_hi[kk], vd);
        repro::wgmma::MMA<HP>::rs(o, p_lo[kk], vd);
      }
      repro::wgmma::commit();
      repro::wgmma::wait<0>();
      repro::wgmma::fence_operand(o);
      if (lane == 0) mbar_arrive(empty_bar + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    }
    if constexpr (SPLIT) {
      // warpgroup 1 hands its (m, l, O) to warpgroup 0 through the ring,
      // free once both are done with their tiles; thread t of one holds
      // the rows and columns that thread t of the other holds
      float* xo = reinterpret_cast<float*>(
          smem_raw + (base - smem_u32(smem_raw)) + L::K);
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      if (ci == 1) {
#pragma unroll
        for (int e = 0; e < HP / 2; ++e) xo[e * WG + tid] = o[e];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          xo[(HP / 2 + r) * WG + tid] = m_r[r];
          xo[(HP / 2 + 2 + r) * WG + tid] = l_r[r];
        }
      }
      asm volatile("bar.sync 1, 256;\n" ::: "memory");
      if (ci == 1) return;
      float w0[2], w1[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m1 = xo[(HP / 2 + r) * WG + tid];
        const float mx = fmaxf(m_r[r], m1);
        w0[r] = exp2f((m_r[r] - mx) * LOG2E);
        w1[r] = exp2f((m1 - mx) * LOG2E);
        l_r[r] = l_r[r] * w0[r] + xo[(HP / 2 + 2 + r) * WG + tid] * w1[r];
      }
#pragma unroll
      for (int e = 0; e < HP / 2; ++e)
        o[e] = o[e] * w0[(e / 2) % 2] + xo[e * WG + tid] * w1[(e / 2) % 2];
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) inv[r] = 1.f / fmaxf(l_r[r], 1e-37f);
    const size_t rs = static_cast<size_t>(H) * hd;
    const size_t bh = static_cast<size_t>(b) * S * rs + static_cast<size_t>(h) * hd;
#pragma unroll
    for (int j = 0; j < HP / 8; ++j) {
      const int col = 8 * j + 2 * tig;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (qi[r] < S && col < hd) {
          *reinterpret_cast<uint32_t*>(out + bh + qi[r] * rs + col) =
              pack2(o[4 * j + 2 * r] * inv[r], o[4 * j + 2 * r + 1] * inv[r]);
        }
      }
    }
  }
}

// a (B,S,H,hd) bf16 tensor as 64-column x 64-row boxes, 128-byte swizzled,
// zeros past hd and past S
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int hd) {
  repro::EncodeTiled encode = repro::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(H) * hd * 2,
                                 static_cast<cuuint64_t>(S) * H * hd * 2};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HP>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int B, int S, int H, int hd, float scale, float softcap,
                 int causal, int window, cudaStream_t stream) {
  CUtensorMap maps[3];
  if (!make_map(&maps[0], q, B, S, H, hd) ||
      !make_map(&maps[1], k, B, S, H, hd) ||
      !make_map(&maps[2], v, B, S, H, hd)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 128-row CTAs unless they leave SMs idle: then 64-row CTAs whose two
  // consumer warpgroups split the kv tiles
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const bool split =
      static_cast<long long>((S + BM - 1) / BM) * H * B < sms;
  const size_t smem = Smem<HP>::BYTES + 1024;  // room to align the base
  auto kernel = split ? flash_wgmma_kernel<HP, true>
                      : flash_wgmma_kernel<HP, false>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = split ? 64 : BM;
  const dim3 grid((S + rows - 1) / rows, H, B);
  kernel<<<grid, WG * (NC + 1), smem, stream>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(out), S, H, hd,
      scale, softcap, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// fp32: head_dim is a template argument of flash_kernel (registers are
// sized by it): every multiple of 16 up to 256 has its instantiation
template <int HD = 16>
int launch_fp32(int hd, const void* q, const void* k, const void* v,
                void* out, int B, int S, int H, float scale, float softcap,
                int causal, int window, cudaStream_t stream) {
  if (hd == HD) {
    // 64 x 64 tiles fit shared memory up to hd 128; wider heads take 32 x 32
    constexpr int BQ = HD <= 128 ? 64 : 32;
    constexpr int BK = BQ;
    const size_t smem = sizeof(float) *
                        (static_cast<size_t>(BQ + BK) * (HD + 1) +
                         static_cast<size_t>(BK) * HD +
                         static_cast<size_t>(BQ) * (BK + 1) + 3 * BQ);
    auto kernel = flash_kernel<float, HD, BQ, BK>;
    cudaError_t err = repro::allow_smem(kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((S + BQ - 1) / BQ, H, B);
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), S, H, scale,
        softcap, causal, window);
    return static_cast<int>(cudaGetLastError());
  }
  if constexpr (HD < 256) {
    return launch_fp32<HD + 16>(hd, q, k, v, out, B, S, H, scale, softcap,
                                causal, window, stream);
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
  if (!is_bf16) {
    return launch_fp32(hd, q, k, v, out, B, S, H, scale, softcap, causal,
                       window, s);
  }
  if (hd % 16 || hd < 16 || hd > 256) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // hd padded to the next multiple of 64 (TMA fills the pad with zeros)
  switch ((hd + 63) / 64) {
    case 1:
      return launch_wgmma<64>(q, k, v, out, B, S, H, hd, scale, softcap,
                              causal, window, s);
    case 2:
      return launch_wgmma<128>(q, k, v, out, B, S, H, hd, scale, softcap,
                               causal, window, s);
    case 3:
      return launch_wgmma<192>(q, k, v, out, B, S, H, hd, scale, softcap,
                               causal, window, s);
    default:
      return launch_wgmma<256>(q, k, v, out, B, S, H, hd, scale, softcap,
                               causal, window, s);
  }
}
