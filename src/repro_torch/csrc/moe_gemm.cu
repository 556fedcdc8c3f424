// Grouped GEMM of the MoE expert FFNs, hand-written for Hopper (sm_90a):
// out[e] = x[e] @ w[e] for x (E,C,D), w (E,D,F), out (E,C,F), with an fp32
// accumulator.
//
// Replaces the TPU kernel repro/kernels/moe_gemm.py::moe_gemm (_mm_kernel;
// its pallas_call is at :56).
//
// What bounds it on the card depends on C, the expert capacity, and so
// does the design.  ops.moe_plan picks the path, the tile and the K split
// of every launch; the launcher takes the plan as it is.
//
//  * Prefill at C above 64 (moe_wgmma_kernel): operations, 2*E*C*D*F FLOPs
//    over 989 TFLOP/s in bf16, at grok's C = 1280; at C = 160 the bytes of
//    w come close.  The earlier design ran mma.sync on 64 x 128 tiles fed by
//    cp.async copies that its own threads issued, and reached about 226
//    TFLOP/s, less still with its operands in L2: the MMA issue rate, not
//    memory, bounded it.  Now a warp-specialised wgmma GEMM: one producer
//    thread keeps TMA loads in flight into a ring of 4 to 7 stages on
//    mbarriers; 2 or 3 consumer warpgroups, 64 rows of C each (a row tile
//    of 128 or 192 rows, the one that pads C least, so that C = 160 is one
//    tile and each w tile is read once), run m64nBNk16 with x K-major and w
//    MN-major (the transpose bit), both 128-byte swizzled boxes of 64
//    columns.  3-D tensor maps over (D, C, E) and (F, D, E) zero-fill the
//    rows past C and the columns past D and F, so ragged edges need no
//    masking on load.  setmaxnreg gives the consumers 240 (or 160)
//    registers, the producer 24.  The C tile is fastest in the grid, so
//    the CTAs that share a w tile run together and read it from device
//    memory about once.  The accumulators go straight to the output,
//    masked past C and F.
//  * Decode and any C up to 64 (moe_stream_kernel): bytes.  Every weight
//    is read once, E*D*F*2 bytes over 3.35 TB/s, for 2*C FLOPs per weight.
//    The earlier design staged a 64-row x tile for 8 rows (7/8 of its MMAs
//    multiplied zeros), kept 16 KB of w in flight a CTA, and left a
//    part-empty last wave (decode down: 384 CTAs, each 32768 deep): about
//    84% of the bytes rate.  Now the operands are swapped, out^T = w^T x^T:
//    F is the MMA's M (two 64-column w boxes a stage, MN-major through the
//    transpose bit) and C its N (8, 16, 32 or 64: one x box of N rows a
//    stage, K-major, rows past C zero-filled).  Each CTA streams w through
//    a ring of 4 to 6 stages, 64 to 96 KB of w, and two CTAs share an SM,
//    so up to 192 KB are in flight an SM.  Where the grid would leave SMs
//    idle in its last wave, or its CTAs are so deep that the last ones
//    drain alone for long, K is split across the CTAs of a thread-block
//    cluster (at most 8); they sum their fp32 partials through
//    distributed shared memory in rank order, so one launch writes the
//    output, with no scratch, no atomics and the same bits on every run.
//  * Every other operand pair (fp32 x fp32, fp32 x bf16, bf16 x fp32) and
//    bf16 with D or F not a multiple of 8 (TMA needs 16-byte row strides)
//    (moe_gemm_simt): both operands widened to fp32 as they are staged, as
//    _mm_kernel does, on the fp32 cores, each of 256 threads owning a
//    4 x 4 block of a 64 x 64 tile in registers.  The bf16 served paths
//    never take it; the fp32 parity runs do.
// The output is written once, in fp32 or bf16 (the TPU kernel writes x's
// dtype; the MoE FFN asks for fp32 between its GEMMs, as the reference's
// einsums keep it).  A persistent variant of the wgmma kernel (one CTA an
// SM walking the tiles, its producer filling the next tile's stages
// during the epilogue) was tried and was no faster: 1% faster at the
// dense prefill's up GEMM, up to 3% slower at the other prefill shapes;
// the hardware's dynamic assignment of CTAs to SMs balances uneven tiles.

#include <cooperative_groups.h>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
using repro::mbar_arrive;
using repro::mbar_arrive_expect_tx;
using repro::mbar_init;
using repro::mbar_wait;
using repro::smem_u32;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

constexpr int WG = 128;              // threads of a warpgroup
constexpr int BK = 64;               // depth of a stage: a 128-byte bf16 row
constexpr int BOX = 64 * 64 * 2;     // a 64-row x 64-column bf16 box, bytes
constexpr int SMEM_MAX = 232448;     // dynamic shared memory a CTA may take

// a (c0, c1, c2) box of a 3-D tensor map into shared memory, completion
// counted on ``bar``
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b) {
  if constexpr (std::is_same<T, float>::value) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
}

// ---------------------------------------------------------------------------
// prefill: warp-specialised wgmma fed by TMA
// ---------------------------------------------------------------------------
// Shared memory (from a 1024-byte aligned base): STAGES stages of NCW x
// boxes (64 rows of C x 64 of D each) and BN/64 w boxes (64 rows of D x 64
// columns of F each), then the full and empty mbarriers.
template <int NCW, int BN>
struct WgSmem {
  static constexpr int STAGE = (NCW + BN / 64) * BOX;
  static constexpr int STAGES = (SMEM_MAX - 1024 - 256) / STAGE;
  static_assert(STAGES >= 4, "the ring must hold at least 4 stages");
  static constexpr int BARS = STAGES * STAGE;
  static constexpr int BYTES = BARS + 16 * STAGES + 1024;  // + alignment
};

// Grid (ceil(C / (64 NCW)), ceil(F / BN), E); NCW + 1 warpgroups.
template <int NCW, int BN, typename TO>
__global__ void __launch_bounds__(WG * (NCW + 1), 1)
moe_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap w_map,
                 TO* __restrict__ out, int C, int D, int F) {
  using L = WgSmem<NCW, BN>;
  constexpr int STAGES = L::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full_bar = base + L::BARS;
  const uint32_t empty_bar = full_bar + 8 * STAGES;
  const int c0 = blockIdx.x * 64 * NCW;
  const int f0 = blockIdx.y * BN;
  const int e = blockIdx.z;
  const int n_k = (D + BK - 1) / BK;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, NCW * 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < n_k; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(empty_bar + 8 * s, ((kt / STAGES) & 1) ^ 1);
        const uint32_t fb = full_bar + 8 * s;
        const uint32_t st = base + s * L::STAGE;
        mbar_arrive_expect_tx(fb, L::STAGE);
        for (int i = 0; i < NCW; ++i)
          tma_load3(st + i * BOX, &x_map, fb, kt * BK, c0 + 64 * i, e);
        for (int j = 0; j < BN / 64; ++j)
          tma_load3(st + (NCW + j) * BOX, &w_map, fb, f0 + 64 * j, kt * BK, e);
      }
    }
  } else {
    if constexpr (NCW == 2) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n" ::: "memory");
    }
    const int ci = wg - 1;
    const int tid = threadIdx.x % WG;
    const int warp = tid / 32;
    const int lane = tid % 32;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    for (int kt = 0; kt < n_k; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full_bar + 8 * s, (kt / STAGES) & 1);
      const uint32_t xa = base + s * L::STAGE + ci * BOX;
      const uint32_t wb = base + s * L::STAGE + NCW * BOX;
      repro::wgmma::fence_operand(acc);
      repro::wgmma::fence();
      // 16 of depth a step: 32 bytes along x's swizzled rows, 16 rows of w
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        repro::wgmma::MMA<BN>::template ss<0, 1>(
            acc, repro::wgmma::desc_sw128(xa + kk * 32, 16, 1024),
            repro::wgmma::desc_sw128(wb + kk * 16 * 128, BOX, 1024), 1);
      }
      repro::wgmma::commit();
      // stage kt-1's products are done: hand its buffers back
      repro::wgmma::wait<1>();
      repro::wgmma::fence_operand(acc);
      if (kt > 0 && lane == 0) mbar_arrive(empty_bar + 8 * ((kt - 1) % STAGES));
    }
    repro::wgmma::wait<0>();
    repro::wgmma::fence_operand(acc);

    // acc[4j + 2h + i] is row 16 warp + g + 8h, column 8j + 2t + i
    const int g = lane / 4;
    const int t = lane % 4;
    TO* oe = out + static_cast<size_t>(e) * C * F;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = c0 + 64 * ci + 16 * warp + g + 8 * h;
      if (row >= C) continue;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = f0 + 8 * j + 2 * t;  // F % 8 == 0: col + 1 < F too
        if (col < F) {
          store_pair(oe + static_cast<size_t>(row) * F + col, acc[4 * j + 2 * h],
                     acc[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// decode: w streamed through TMA, out^T = w^T x^T, K split over a cluster
// ---------------------------------------------------------------------------
constexpr int ST_COLS = 128;  // columns of F a CTA: two 64-row MMA tiles

// Shared memory: STAGES stages of two w boxes (64 rows of D x 64 columns
// of F) and one x box (N rows of C x 64 of D), then the mbarriers; after
// the loop the ring holds the CTA's fp32 partial (128 x N).  At most
// ~110 KB, so that two CTAs share an SM.
template <int N>
struct StSmem {
  static constexpr int STAGE = 2 * BOX + N * 128;
  static constexpr int STAGES = (110 * 1024) / STAGE;
  static_assert(STAGES >= 4 && 128 * N * 4 <= STAGES * STAGE, "ring");
  static constexpr int BARS = STAGES * STAGE;
  static constexpr int BYTES = BARS + 16 * STAGES + 1024;  // + alignment
};

// Grid (S, ceil(F / 128), E) in clusters of (S, 1, 1): split s of S takes
// the k-steps [s kps, (s+1) kps) of 64; C <= N.  One consumer warpgroup
// and one producer warp.
template <int N, typename TO>
__global__ void __launch_bounds__(WG + 32, 2)
moe_stream_kernel(const __grid_constant__ CUtensorMap x_map,
                  const __grid_constant__ CUtensorMap w_map,
                  TO* __restrict__ out, int C, int D, int F, int kps) {
  using L = StSmem<N>;
  constexpr int STAGES = L::STAGES;
  constexpr int NA = N / 2;  // accumulators of a 64 x N tile, a thread
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full_bar = base + L::BARS;
  const uint32_t empty_bar = full_bar + 8 * STAGES;
  const int split = blockIdx.x;  // = the CTA's rank in its cluster
  const int S = gridDim.x;
  const int f0 = blockIdx.y * ST_COLS;
  const int e = blockIdx.z;
  const int k_begin = split * kps;
  const int n = min((D + BK - 1) / BK, k_begin + kps) - k_begin;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 4);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[2][NA];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[m][i] = 0.f;

  if (warp == 4) {
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        const int s = i % STAGES;
        const int k0 = (k_begin + i) * BK;
        mbar_wait(empty_bar + 8 * s, ((i / STAGES) & 1) ^ 1);
        const uint32_t fb = full_bar + 8 * s;
        const uint32_t st = base + s * L::STAGE;
        mbar_arrive_expect_tx(fb, L::STAGE);
        tma_load3(st, &w_map, fb, f0, k0, e);
        tma_load3(st + BOX, &w_map, fb, f0 + 64, k0, e);
        tma_load3(st + 2 * BOX, &x_map, fb, k0, 0, e);
      }
    }
  } else {
    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES;
      mbar_wait(full_bar + 8 * s, (i / STAGES) & 1);
      const uint32_t st = base + s * L::STAGE;
#pragma unroll
      for (int m = 0; m < 2; ++m) repro::wgmma::fence_operand(acc[m]);
      repro::wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t xd =
            repro::wgmma::desc_sw128(st + 2 * BOX + kk * 32, 16, 1024);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          repro::wgmma::MMA<N>::template ss<1, 0>(
              acc[m],
              repro::wgmma::desc_sw128(st + m * BOX + kk * 16 * 128, BOX, 1024),
              xd, 1);
        }
      }
      repro::wgmma::commit();
      repro::wgmma::wait<1>();
#pragma unroll
      for (int m = 0; m < 2; ++m) repro::wgmma::fence_operand(acc[m]);
      if (i > 0 && lane == 0) mbar_arrive(empty_bar + 8 * ((i - 1) % STAGES));
    }
    repro::wgmma::wait<0>();
#pragma unroll
    for (int m = 0; m < 2; ++m) repro::wgmma::fence_operand(acc[m]);
  }

  // acc[m][4j + 2h + i] of thread (warp, g = lane/4, t = lane%4) is
  // out^T row (column of F) f0 + 64m + 16 warp + g + 8h, column (row of C)
  // 8j + 2t + i
  TO* oe = out + static_cast<size_t>(e) * C * F;
  auto put = [&](int m, int a, int thread, float v) {
    const int w_ = thread / 32, g = (thread % 32) / 4, t = thread % 4;
    const int f = f0 + 64 * m + 16 * w_ + g + 8 * ((a % 4) / 2);
    const int c = 8 * (a / 4) + 2 * t + a % 2;
    if (c < C && f < F) {
      oe[static_cast<size_t>(c) * F + f] = repro::from_float<TO>(v);
    }
  };
  if (S == 1) {
    if (warp < 4) {
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int a = 0; a < NA; ++a) put(m, a, threadIdx.x, acc[m][a]);
    }
    return;
  }
  // the partials in thread order, then each rank sums its share of the
  // elements over the ranks in order 0..S-1
  float* part = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)));
  if (warp < 4) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int a = 0; a < NA; ++a) part[(m * NA + a) * WG + threadIdx.x] = acc[m][a];
  }
  cluster.sync();  // every split's partial is written
  constexpr int TOTAL = 2 * NA * WG;
  const int share = (TOTAL + S - 1) / S;
  const int hi = min(TOTAL, (split + 1) * share);
  for (int idx = split * share + threadIdx.x; idx < hi; idx += WG + 32) {
    float v = 0.f;
    for (int r = 0; r < S; ++r) v += cluster.map_shared_rank(part, r)[idx];
    const int q = idx / WG;
    put(q / NA, q % NA, idx % WG, v);
  }
  cluster.sync();  // no CTA leaves while its partial may still be read
}

// ---------------------------------------------------------------------------
// any other operand pair: widened to fp32 on the fp32 cores
// ---------------------------------------------------------------------------
constexpr int SIMT_THREADS = 256;  // a 16 x 16 grid of threads
constexpr int SM = 64;             // rows per tile
constexpr int SN = 64;             // columns per tile
constexpr int SK = 16;             // depth per step

// Grid (ceil(C/SM), ceil(F/SN), E).
template <typename TX, typename TW, typename TO>
__global__ void __launch_bounds__(SIMT_THREADS)
moe_gemm_simt(const TX* __restrict__ x, const TW* __restrict__ w,
              TO* __restrict__ out, int C, int D, int F) {
  __shared__ float a_s[SM][SK + 1];
  __shared__ float b_s[SK][SN];
  const int c0 = blockIdx.x * SM;
  const int f0 = blockIdx.y * SN;
  const int e = blockIdx.z;
  const TX* xe = x + static_cast<size_t>(e) * C * D;
  const TW* we = w + static_cast<size_t>(e) * D * F;
  TO* oe = out + static_cast<size_t>(e) * C * F;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;

  float acc[4][4] = {};
  for (int k0 = 0; k0 < D; k0 += SK) {
    for (int i = tid; i < SM * SK; i += SIMT_THREADS) {
      const int r = i / SK;
      const int k = i - r * SK;
      const int gr = c0 + r;
      const int gk = k0 + k;
      a_s[r][k] = (gr < C && gk < D)
                      ? to_float(xe[static_cast<size_t>(gr) * D + gk])
                      : 0.f;
    }
    for (int i = tid; i < SK * SN; i += SIMT_THREADS) {
      const int k = i / SN;
      const int n = i - k * SN;
      const int gk = k0 + k;
      const int gf = f0 + n;
      b_s[k][n] = (gk < D && gf < F)
                      ? to_float(we[static_cast<size_t>(gk) * F + gf])
                      : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = b_s[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = c0 + ty + 16 * i;
    if (row >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = f0 + tx + 16 * j;
      if (col < F) {
        oe[static_cast<size_t>(row) * F + col] = repro::from_float<TO>(acc[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------
// a bf16 (d0, d1, d2) row-major tensor (d0 innermost) as (box0, box1, 1)
// boxes, 128-byte swizzled, zeros past every edge
bool make_map(CUtensorMap* map, const void* ptr, int d0, int d1, int d2,
              int box0, int box1) {
  repro::EncodeTiled encode = repro::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d0) * 2,
                                 static_cast<cuuint64_t>(d0) * d1 * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box0),
                             static_cast<cuuint32_t>(box1), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NCW, int BN, typename TO>
int launch_wgmma(const void* x, const void* w, void* out, int E, int C, int D,
                 int F, cudaStream_t stream) {
  CUtensorMap maps[2];
  if (!make_map(&maps[0], x, D, C, E, 64, 64) ||
      !make_map(&maps[1], w, F, D, E, 64, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = moe_wgmma_kernel<NCW, BN, TO>;
  const size_t smem = WgSmem<NCW, BN>::BYTES;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + 64 * NCW - 1) / (64 * NCW), (F + BN - 1) / BN, E);
  kernel<<<grid, WG * (NCW + 1), smem, stream>>>(maps[0], maps[1],
                                                  static_cast<TO*>(out), C, D,
                                                  F);
  return static_cast<int>(cudaGetLastError());
}

template <int N, typename TO>
int launch_stream(const void* x, const void* w, void* out, int E, int C,
                  int D, int F, int S, int kps, cudaStream_t stream) {
  CUtensorMap maps[2];
  if (!make_map(&maps[0], x, D, C, E, 64, N) ||
      !make_map(&maps[1], w, F, D, E, 64, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = moe_stream_kernel<N, TO>;
  const size_t smem = StSmem<N>::BYTES;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, (F + ST_COLS - 1) / ST_COLS, E);
  cfg.blockDim = dim3(WG + 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, maps[0], maps[1],
                           static_cast<TO*>(out), C, D, F, kps);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW, typename TO>
int launch_simt(const void* x, const void* w, void* out, int E, int C, int D,
                int F, cudaStream_t stream) {
  const dim3 grid((C + SM - 1) / SM, (F + SN - 1) / SN, E);
  moe_gemm_simt<TX, TW, TO><<<grid, SIMT_THREADS, 0, stream>>>(
      static_cast<const TX*>(x), static_cast<const TW*>(w),
      static_cast<TO*>(out), C, D, F);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TW>
int launch_simt_out(const void* x, const void* w, void* out, int E, int C,
                    int D, int F, int out_bf16, cudaStream_t stream) {
  if (out_bf16) return launch_simt<TX, TW, bf16>(x, w, out, E, C, D, F, stream);
  return launch_simt<TX, TW, float>(x, w, out, E, C, D, F, stream);
}

template <typename TO>
int launch_tc(const void* x, const void* w, void* out, int E, int C, int D,
              int F, int regime, int rows, int cols, int S, int kps,
              cudaStream_t s) {
  if (regime == 1 && rows == 128 && cols == 256)
    return launch_wgmma<2, 256, TO>(x, w, out, E, C, D, F, s);
  if (regime == 1 && rows == 128 && cols == 128)
    return launch_wgmma<2, 128, TO>(x, w, out, E, C, D, F, s);
  if (regime == 1 && rows == 192 && cols == 128)
    return launch_wgmma<3, 128, TO>(x, w, out, E, C, D, F, s);
  const int n_k = (D + BK - 1) / BK;
  if (regime != 2 || cols != ST_COLS || C > rows || S < 1 || S > 8 ||
      kps < 1 || (S - 1) * kps >= n_k) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (rows) {
    case 8:
      return launch_stream<8, TO>(x, w, out, E, C, D, F, S, kps, s);
    case 16:
      return launch_stream<16, TO>(x, w, out, E, C, D, F, S, kps, s);
    case 32:
      return launch_stream<32, TO>(x, w, out, E, C, D, F, S, kps, s);
    case 64:
      return launch_stream<64, TO>(x, w, out, E, C, D, F, S, kps, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (E,C,D), w (E,D,F), out (E,C,F), each row-major in its own dtype (bf16
// when its flag is set, else fp32); 16-byte aligned base pointers.  The
// plan (ops.moe_plan): regime 0 runs moe_gemm_simt (any operands); 1
// moe_wgmma_kernel with row tiles of ``rows`` (128 or 192) and ``cols``
// (256 or 128) columns of F; 2 moe_stream_kernel with N = ``rows`` (8, 16,
// 32 or 64, at least C), 128 columns and K split S ways, ``kps`` 64-deep
// steps a split.  Regimes 1 and 2 take bf16 x and w with D and F multiples
// of 8.  Returns the launch's cudaError_t.
extern "C" int moe_gemm_launch(const void* x, const void* w, void* out, int E,
                               int C, int D, int F, int x_bf16, int w_bf16,
                               int out_bf16, int regime, int rows, int cols,
                               int S, int kps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (regime != 0) {
    if (!x_bf16 || !w_bf16 || D % 8 || F % 8 || D < 1) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (out_bf16)
      return launch_tc<bf16>(x, w, out, E, C, D, F, regime, rows, cols, S, kps, s);
    return launch_tc<float>(x, w, out, E, C, D, F, regime, rows, cols, S, kps, s);
  }
  if (x_bf16 && w_bf16)
    return launch_simt_out<bf16, bf16>(x, w, out, E, C, D, F, out_bf16, s);
  if (x_bf16) return launch_simt_out<bf16, float>(x, w, out, E, C, D, F, out_bf16, s);
  if (w_bf16) return launch_simt_out<float, bf16>(x, w, out, E, C, D, F, out_bf16, s);
  return launch_simt_out<float, float>(x, w, out, E, C, D, F, out_bf16, s);
}

// Dynamic shared memory of a CTA of the plan's kernel, bytes (0: simt,
// whose tiles are static; -1: no such kernel).
extern "C" int moe_gemm_smem(int regime, int rows, int cols) {
  if (regime == 0) return 0;
  if (regime == 1 && rows == 128 && cols == 256) return WgSmem<2, 256>::BYTES;
  if (regime == 1 && rows == 128 && cols == 128) return WgSmem<2, 128>::BYTES;
  if (regime == 1 && rows == 192 && cols == 128) return WgSmem<3, 128>::BYTES;
  if (regime != 2 || cols != ST_COLS) return -1;
  switch (rows) {
    case 8: return StSmem<8>::BYTES;
    case 16: return StSmem<16>::BYTES;
    case 32: return StSmem<32>::BYTES;
    case 64: return StSmem<64>::BYTES;
    default: return -1;
  }
}
