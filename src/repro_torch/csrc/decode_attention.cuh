// Single-query GQA decode attention over a KV cache, split over the
// cache's slots (flash-decoding): the kernels shared by the paged
// (paged_decode_attention.cu) and the contiguous (decode_attention.cu)
// caches.  A Layout names where a slot lives and how far a sequence is
// valid:
//
//   __device__ int last(int b) const;              // slots 0..last(b) valid
//   __device__ size_t row(int b, int slot) const;  // cache row of the slot
//   __device__ bool owned(int b, int slot) const;  // its page is attended
//
// where a cache row holds the Kv*hd values of one slot.  A slot is live
// when it is <= last(b) and owned: a slot that is not is never loaded (no
// copy is issued for it), its score is masked and its probability is
// exactly 0, so a split, a CTA or a whole sequence with no live slot
// keeps m = NEG_INF, l = 0, acc = 0.
//
// Partials (the TPU kernel's ``partials=True``, for a striped pool whose
// stripes merge across devices): instead of the normalized output the
// launch writes the merged online-softmax state (acc (B,Kv,G,hd), m, l
// (B,Kv,G)) in fp32, after the splits' merge and before the division by
// l.
//
// What bounds them on the card: bytes.  A step reads the K/V slots
// 0..last(b) of every sequence once, with G multiply-adds per element
// read, far below the H100's ~295 FLOP/byte ridge.
//
// bf16 (the served path): decode_mma_kernel.  Grid (NS, B, Kv x ceil(G/16)),
// NS CTAs of one (sequence, kv head, group of up to 16 query heads) forming
// a thread-block cluster.  Each CTA streams its range of 64-slot tiles
// through a 3-stage ring in shared memory, every stage filled at once:
// one bulk copy (cp.async.bulk) per slot row of K and of V, gathered
// through the layout, completion counted on the stage's mbarrier.  Each
// of the 128 threads issues one copy a tile, not 2*hd/8 16-byte ones:
// the rate at which copies are issued is a warp's, so all four warps
// issue.  The q rows come first, the same way.
// The group's query heads are the M rows of mma.sync m16n8k16 (padded to
// 16; the padding costs tensor-core rows, which a bytes-bound kernel has
// to spare): each of the 4 warps takes 16 slots of a tile, q K^T from
// ldmatrix fragments of q and K (exact bf16 products, fp32 sums), an
// online fp32 softmax on the accumulators, and P V with P in registers,
// split into hi = bf16(P) and lo = bf16(P - hi) so that P keeps about 16
// bits, against V fragments from ldmatrix.trans.  Each K/V element staged
// feeds every query head of the group.  The partials (m, l, acc) of the
// NS x 4 warps are merged in the kernel through distributed shared memory,
// so there is no second launch and no scratch tensor.
//
// fp32 (the parity runs): decode_partial on the fp32 cores, a warp per
// slot in the scores, 32-slot tiles double-buffered with cp.async, and
// decode_merge, a second kernel, over partials in a scratch tensor.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace repro {
namespace decode {

constexpr int THREADS = 128;

// where the partials go: acc == nullptr means the normalized output
struct Partials {
  float* acc;  // (B, Kv, G, hd)
  float* m;    // (B, Kv, G)
  float* l;    // (B, Kv, G)
};
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
  // for the others (never loaded; zero keeps 0 * v finite)
  auto stage = [&](int tile, int buf) {
    T* kb = kv_s + static_cast<size_t>(buf) * 2 * TS * hd;
    T* vb = kb + TS * hd;
    for (int c = tid; c < TS * cpr; c += THREADS) {
      const int t = c / cpr;
      const int ch = c - t * cpr;
      const int slot = tile * TS + t;
      T* kd = kb + t * hd + ch * CE;
      T* vd = vb + t * hd + ch * CE;
      if (slot <= last && layout.owned(b, slot)) {
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
      const int slot = tile * TS + t;
      const bool live = slot <= last && layout.owned(b, slot);
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

    const int my_slot = tile * TS + lane;
    const bool my_live = my_slot <= last && layout.owned(b, my_slot);
    for (int g = warp; g < G; g += WARPS) {  // online softmax, lane = slot
      const float s = p_s[g * TS + lane];
      const float m_prev = m_s[g];
      const float mx = warp_max(fmaxf(m_prev, s));
      const float e = my_live ? expf(s - mx) : 0.f;
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
// splits carry m = NEG_INF and weigh exactly 0.  With ``parts.acc`` set
// the merged state is written unnormalized, in fp32, instead of out.
template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_merge(const float* __restrict__ part_acc,
                   const float* __restrict__ part_m,
                   const float* __restrict__ part_l, T* __restrict__ out,
                   const Partials parts, int Kv, int G, int hd, int NS) {
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
    if (parts.acc) {
      const size_t o = (static_cast<size_t>(b) * Kv + kvh) * G * hd + i;
      parts.acc[o] = a;
      if (i - g * hd == 0) {
        parts.m[o / hd] = mg;
        parts.l[o / hd] = l;
      }
    } else {
      ob[i] = from_float<T>(a / fmaxf(l, 1e-37f));
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores, the merge through a thread-block cluster
// ---------------------------------------------------------------------------
constexpr int MMA_TS = 64;      // slots of a stage: 16 for each warp
constexpr int MMA_STAGES = 3;   // ring depth: stages of bulk copies
constexpr int MAX_CLUSTER = 8;  // CTAs of a cluster, the most splits

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p))));
}

// Shared memory of decode_mma_kernel, in bytes: the q rows, the K/V ring
// (rows padded by 8 values so that ldmatrix is free of bank conflicts),
// the merge's small arrays and the mbarriers; after the loop the ring
// holds the warps' partials (rows padded by 4 floats), read by the cluster.
template <int HP>
struct MmaSmem {
  static constexpr int RS = HP + 8;                        // row stride
  static constexpr int PS = HP + 4;                        // partial row stride
  static constexpr int Q = 0;                              // 16 x RS bf16
  static constexpr int RING = Q + 16 * RS * 2;             // [STAGES][K|V][TS][RS]
  static constexpr int RING_BYTES = MMA_STAGES * 2 * MMA_TS * RS * 2;
  // after the loop the ring holds the warps' partials; warp 0's acc
  // becomes the CTA's, which the cluster reads
  static constexpr int PART_M = RING;                      // [4][16] fp32
  static constexpr int PART_L = PART_M + 4 * 16 * 4;       // [4][16]
  static constexpr int PART_ACC = PART_L + 4 * 16 * 4;     // [4][16][PS]
  static constexpr int CTA_M = RING + RING_BYTES;          // [16]
  static constexpr int CTA_L = CTA_M + 16 * 4;             // [16]
  static constexpr int W4 = CTA_L + 16 * 4;                // [16][4]
  static constexpr int RM = W4 + 16 * 4 * 4;               // [MAX_CLUSTER][16]
  static constexpr int RL = RM + MAX_CLUSTER * 16 * 4;     // [MAX_CLUSTER][16]
  static constexpr int WTS = RL + MAX_CLUSTER * 16 * 4;    // [16][MAX_CLUSTER]
  static constexpr int INV = WTS + 16 * MAX_CLUSTER * 4;   // [16]
  static constexpr int BARS = INV + 16 * 4;                // q, full[STAGES]
  static constexpr int BYTES = BARS + 8 * (1 + MMA_STAGES);
  static_assert(PART_ACC + 4 * 16 * PS * 4 <= RING + RING_BYTES,
                "partials fit the ring");
};

// Grid (NS, B, Kv * MG), cluster (NS, 1, 1), MG = ceil(G / 16).  CTA
// (split, b, kvh * MG + mg) attends 64-slot tiles [split*tps, (split+1)*tps)
// of sequence b's slots 0..layout.last(b) for query heads 16mg.. of kv
// head kvh; the cluster merges the splits and writes out.
template <int HP, typename Layout>
__global__ void __launch_bounds__(THREADS)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k_cache,
                  const __nv_bfloat16* __restrict__ v_cache,
                  const Layout layout, __nv_bfloat16* __restrict__ out,
                  const Partials parts, int Kv, int G, int hd, int tps,
                  float scale, float softcap) {
  using bf16 = __nv_bfloat16;
  using L = MmaSmem<HP>;
  constexpr int RS = L::RS;
  constexpr int PS = L::PS;
  extern __shared__ __align__(16) float smem[];  // as decode_partial's
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem);
  bf16* q_s = reinterpret_cast<bf16*>(sm + L::Q);
  bf16* ring = reinterpret_cast<bf16*>(sm + L::RING);
  float* part_m = reinterpret_cast<float*>(sm + L::PART_M);
  float* part_l = reinterpret_cast<float*>(sm + L::PART_L);
  float* part_acc = reinterpret_cast<float*>(sm + L::PART_ACC);
  float* cta_m = reinterpret_cast<float*>(sm + L::CTA_M);
  float* cta_l = reinterpret_cast<float*>(sm + L::CTA_L);
  float* w4 = reinterpret_cast<float*>(sm + L::W4);
  float* rm = reinterpret_cast<float*>(sm + L::RM);
  float* rl = reinterpret_cast<float*>(sm + L::RL);
  float* wts = reinterpret_cast<float*>(sm + L::WTS);
  float* inv = reinterpret_cast<float*>(sm + L::INV);

  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x;  // = the CTA's rank in its cluster
  const int NS = gridDim.x;
  const int b = blockIdx.y;
  const int MG = (G + 15) / 16;
  const int kvh = blockIdx.z / MG;
  const int g0 = (blockIdx.z % MG) * 16;
  const int rows = min(16, G - g0);  // query heads of this CTA
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int H = Kv * G;
  const int cpr = hd / 8;  // 16-byte chunks of a row
  const int last = layout.last(b);
  constexpr float LOG2E = 1.4426950408889634f;
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

  const uint32_t q_bar = smem_u32(sm + L::BARS);
  const uint32_t full_bar = q_bar + 8;  // one per ring stage
  if (tid == 0) {
    mbar_init(q_bar, 16);
    for (int s = 0; s < MMA_STAGES; ++s) mbar_init(full_bar + 8 * s, THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the ring's columns past hd are zeroed and never loaded
  if (cpr < HP / 8) {
    for (int c = tid; c < MMA_STAGES * 2 * MMA_TS * (HP / 8 - cpr);
         c += THREADS) {
      const int r = c / (HP / 8 - cpr);
      const int ch = cpr + c - r * (HP / 8 - cpr);
      *reinterpret_cast<uint4*>(ring + r * RS + ch * 8) =
          make_uint4(0, 0, 0, 0);
    }
  }
  __syncthreads();  // the mbarriers and the zeroed columns
  // q first: thread r < 16 copies query head g0 + r's row (or zeroes it
  // past the group), and zeroes its columns past hd
  const bf16* qb = q + (static_cast<size_t>(b) * H + kvh * G + g0) * hd;
  if (tid < 16) {
    for (int ch = (tid < rows ? cpr : 0); ch < RS / 8; ++ch)
      *reinterpret_cast<uint4*>(q_s + tid * RS + ch * 8) =
          make_uint4(0, 0, 0, 0);
    if (tid < rows) {
      mbar_arrive_expect_tx(q_bar, hd * 2);
      bulk_copy(q_s + tid * RS, qb + tid * hd, hd * 2, q_bar);
    } else {
      mbar_arrive(q_bar);
    }
  }
  // stage tile `tile` into ring slot `buf`: thread t copies one row with
  // one bulk copy, the K row of slot tile*64 + t for t < 64, the V row of
  // slot tile*64 + t - 64 above (the copies of all four warps keep more
  // requests in flight than fewer issuing warps); for a slot that is not
  // live it zeroes a V row instead (masked; zero keeps 0 * v finite; a K
  // row's score is masked whatever it holds)
  auto stage = [&](int tile, int buf) {
    const int t = tid % MMA_TS;
    const bool is_v = tid >= MMA_TS;
    bf16* dst = ring + (static_cast<size_t>(buf * 2 + is_v) * MMA_TS + t) * RS;
    const uint32_t bar = full_bar + 8 * buf;
    const int slot = tile * MMA_TS + t;
    if (slot <= last && layout.owned(b, slot)) {
      const size_t off =
          (layout.row(b, slot) * Kv + kvh) * static_cast<size_t>(hd);
      mbar_arrive_expect_tx(bar, hd * 2);
      bulk_copy(dst, (is_v ? v_cache : k_cache) + off, hd * 2, bar);
    } else {
      if (is_v)
        for (int ch = 0; ch < cpr; ++ch)
          *reinterpret_cast<uint4*>(dst + ch * 8) = make_uint4(0, 0, 0, 0);
      mbar_arrive(bar);
    }
  };

  float acc[HP / 8][4];
#pragma unroll
  for (int j = 0; j < HP / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.f, 0.f};  // this thread's share of the row sums

  const int n_tiles = last / MMA_TS + 1;
  const int t_begin = split * tps;
  const int t_end = min(n_tiles, t_begin + tps);
  // every stage of the ring is filled at once: a split of up to
  // MMA_STAGES tiles (the usual decode step) has all its loads in flight
  // from the start
#pragma unroll
  for (int s = 0; s < MMA_STAGES; ++s)
    if (t_begin + s < t_end) stage(t_begin + s, s);
  mbar_wait(q_bar, 0);

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int i = tile - t_begin;
    mbar_wait(full_bar + 8 * (i % MMA_STAGES), (i / MMA_STAGES) & 1);
    const bf16* kb = ring + static_cast<size_t>(i % MMA_STAGES) * 2 * MMA_TS * RS;
    const bf16* vb = kb + MMA_TS * RS;
    const int s0 = 16 * warp;  // this warp's 16 slots of the tile

    // scores (16 heads x 16 slots) = q K^T over HP/16 k-steps
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < HP / 16; ++kk) {
      uint32_t a[4], kf[4];
      ldmatrix_x4(a, q_s + (lane & 15) * RS + 16 * kk + (lane >> 4) * 8);
      ldmatrix_x4(kf, kb + (s0 + (lane & 7) + ((lane >> 4) << 3)) * RS +
                          16 * kk + ((lane >> 3) & 1) * 8);
      mma_bf16(sc[0], a, kf[0], kf[1]);
      mma_bf16(sc[1], a, kf[2], kf[3]);
    }
    float mx[2] = {m_r[0], m_r[1]};
    bool live[2][2];  // this thread's slots: j, and e & 1
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int slot = tile * MMA_TS + s0 + 8 * j + 2 * tig + c;
        live[j][c] = slot <= last && layout.owned(b, slot);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale;
        if (softcap > 0.f) x = softcap_fast(x, softcap, inv_cap);
        sc[j][e] = live[j][e & 1] ? x : NEG_INF;
        mx[e / 2] = fmaxf(mx[e / 2], sc[j][e]);
      }
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
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = live[j][e & 1] ? exp2f((sc[j][e] - mx[e / 2]) * LOG2E)
                                  : 0.f;
        sum[e / 2] += sc[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + sum[r];
#pragma unroll
    for (int j = 0; j < HP / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // acc += (P_hi + P_lo) V: one k-step of the warp's 16 slots
    uint32_t ph[4], pl[4];
    split2(sc[0][0], sc[0][1], ph[0], pl[0]);
    split2(sc[0][2], sc[0][3], ph[1], pl[1]);
    split2(sc[1][0], sc[1][1], ph[2], pl[2]);
    split2(sc[1][2], sc[1][3], ph[3], pl[3]);
#pragma unroll
    for (int j2 = 0; j2 < HP / 16; ++j2) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, vb + (s0 + (lane & 15)) * RS + 16 * j2 +
                                (lane >> 4) * 8);
      mma_bf16(acc[2 * j2], ph, vf[0], vf[1]);
      mma_bf16(acc[2 * j2], pl, vf[0], vf[1]);
      mma_bf16(acc[2 * j2 + 1], ph, vf[2], vf[3]);
      mma_bf16(acc[2 * j2 + 1], pl, vf[2], vf[3]);
    }
    if (tile + MMA_STAGES < t_end) {  // refill the slot every warp is done with
      __syncthreads();
      fence_proxy_async();
      stage(tile + MMA_STAGES, i % MMA_STAGES);
    }
  }
  __syncthreads();  // the ring becomes the partials

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
  if (tig == 0) {
    part_m[warp * 16 + gid] = m_r[0];
    part_m[warp * 16 + gid + 8] = m_r[1];
    part_l[warp * 16 + gid] = l_r[0];
    part_l[warp * 16 + gid + 8] = l_r[1];
  }
  float* pa = part_acc + warp * 16 * PS;
#pragma unroll
  for (int j = 0; j < HP / 8; ++j) {
    const int col = 8 * j + 2 * tig;
    *reinterpret_cast<float2*>(pa + gid * PS + col) =
        make_float2(acc[j][0], acc[j][1]);
    *reinterpret_cast<float2*>(pa + (gid + 8) * PS + col) =
        make_float2(acc[j][2], acc[j][3]);
  }
  __syncthreads();

  // the CTA's partial: its 4 warps' merged into warp 0's slot.  Weights
  // exp(m - max m); a warp or a split with no live slot has m = NEG_INF
  // and weighs exactly 0 beside one that has one.
  if (tid < 16) {
    float mc = NEG_INF;
#pragma unroll
    for (int w = 0; w < 4; ++w) mc = fmaxf(mc, part_m[w * 16 + tid]);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float wt = exp2f((part_m[w * 16 + tid] - mc) * LOG2E);
      w4[tid * 4 + w] = wt;
      l = fmaf(part_l[w * 16 + tid], wt, l);
    }
    cta_m[tid] = mc;
    cta_l[tid] = l;
  }
  __syncthreads();
  for (int e = tid; e < rows * HP; e += THREADS) {
    const int g = e / HP;
    const int x = g * PS + e - g * HP;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) a = fmaf(part_acc[w * 16 * PS + x], w4[g * 4 + w], a);
    part_acc[x] = a;
  }
  cluster.sync();  // every split's partial is written

  // the cluster's merge: the splits' (m, l) copied in, weights per head,
  // then this CTA's share of the outputs from every split's acc
  if (tid < NS * 16) {
    rm[tid] = cluster.map_shared_rank(cta_m, tid / 16)[tid % 16];
    rl[tid] = cluster.map_shared_rank(cta_l, tid / 16)[tid % 16];
  }
  __syncthreads();
  if (tid < rows) {
    float mg = NEG_INF;
    for (int r = 0; r < NS; ++r) mg = fmaxf(mg, rm[r * 16 + tid]);
    float l = 0.f;
    for (int r = 0; r < NS; ++r) {
      const float wt = exp2f((rm[r * 16 + tid] - mg) * LOG2E);
      wts[tid * MAX_CLUSTER + r] = wt;
      l = fmaf(rl[r * 16 + tid], wt, l);
    }
    inv[tid] = 1.f / fmaxf(l, 1e-37f);
    if (parts.acc && split == 0) {
      const size_t r = static_cast<size_t>(b) * H + kvh * G + g0 + tid;
      parts.m[r] = mg;
      parts.l[r] = l;
    }
  }
  __syncthreads();
  const float* racc[MAX_CLUSTER];
#pragma unroll
  for (int r = 0; r < MAX_CLUSTER; ++r)
    racc[r] = cluster.map_shared_rank(part_acc, r < NS ? r : 0);
  bf16* ob = out + (static_cast<size_t>(b) * H + kvh * G + g0) * hd;
  for (int e = split * THREADS + tid; e < rows * hd; e += NS * THREADS) {
    const int g = e / hd;
    const int d = e - g * hd;
    float a = 0.f;
#pragma unroll
    for (int r = 0; r < MAX_CLUSTER; ++r)
      if (r < NS) a = fmaf(racc[r][g * PS + d], wts[g * MAX_CLUSTER + r], a);
    if (parts.acc)
      parts.acc[(static_cast<size_t>(b) * H + kvh * G + g0) * hd + e] = a;
    else
      ob[e] = __float2bfloat16_rn(a * inv[g]);
  }
  cluster.sync();  // no CTA leaves while its partial may still be read
}

// bf16: one launch on grid (NS, B, Kv * ceil(G/16)) in clusters of NS.
template <int HP, typename Layout>
int launch_mma_hp(const void* q, const void* k_cache, const void* v_cache,
                  const Layout& layout, void* out, const Partials& parts,
                  int B, int Kv, int G, int hd, int NS, int tps, float scale,
                  float softcap, cudaStream_t stream) {
  if (NS < 1 || NS > MAX_CLUSTER) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = decode_mma_kernel<HP, Layout>;
  const size_t smem = MmaSmem<HP>::BYTES;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NS, B, Kv * ((G + 15) / 16));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel,
                           static_cast<const __nv_bfloat16*>(q),
                           static_cast<const __nv_bfloat16*>(k_cache),
                           static_cast<const __nv_bfloat16*>(v_cache), layout,
                           static_cast<__nv_bfloat16*>(out), parts, Kv, G, hd,
                           tps, scale, softcap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Launch the bf16 kernel (hd padded to a multiple of 64, scratch unused)
// or, for fp32, the partial kernel on grid (B, Kv, NS) and the merge on
// (B, Kv), scratch holding B*Kv*NS*G*(hd+2) floats.  With ``parts.acc``
// set, out is unused and the partials are written.  Returns the
// cudaError_t.
template <typename T, typename Layout>
int launch(const void* q, const void* k_cache, const void* v_cache,
           const Layout& layout, void* out, const Partials& parts,
           void* scratch, int B, int Kv, int G, int hd, int NS, int tps,
           float scale, float softcap, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    switch ((hd + 63) / 64) {
      case 1:
        return launch_mma_hp<64>(q, k_cache, v_cache, layout, out, parts, B,
                                  Kv, G, hd, NS, tps, scale, softcap, stream);
      case 2:
        return launch_mma_hp<128>(q, k_cache, v_cache, layout, out, parts, B,
                                  Kv, G, hd, NS, tps, scale, softcap, stream);
      case 3:
        return launch_mma_hp<192>(q, k_cache, v_cache, layout, out, parts, B,
                                  Kv, G, hd, NS, tps, scale, softcap, stream);
      default:
        return launch_mma_hp<256>(q, k_cache, v_cache, layout, out, parts, B,
                                  Kv, G, hd, NS, tps, scale, softcap, stream);
    }
  } else {
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
        part_acc, part_m, part_l, static_cast<T*>(out), parts, Kv, G, hd, NS);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace decode
}  // namespace repro
