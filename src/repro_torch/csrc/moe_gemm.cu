// Grouped GEMM of the MoE expert FFNs, hand-written for Hopper (sm_90a):
// out[e] = x[e] @ w[e] for x (E,C,D), w (E,D,F), out (E,C,F), with an fp32
// accumulator.
//
// Replaces the TPU kernel repro/kernels/moe_gemm.py::moe_gemm (_mm_kernel;
// its pallas_call is at :56).
//
// What bounds it on the card: it depends on C, the expert capacity.
//  * Prefill (C in the hundreds to thousands): operations.  2*E*C*D*F
//    FLOPs over 989 TFLOP/s in bf16; the weights are read once per C tile
//    but from L2 (see the grid order below).
//  * Decode (C = 8, the capacity floor): bytes.  Every expert's weights
//    are read once, E*D*F*2 bytes over 3.35 TB/s, for 16 FLOPs per weight.
//
// What the design does about it:
//  * one CTA per (C tile, F tile, expert), looping over D, with the C tile
//    index fastest in the grid: the CTAs that share a tile of w run at the
//    same time, so it comes from device memory about once and from L2 for
//    the other C tiles, while x of one expert (C x D) stays in L2;
//  * bf16 x bf16 runs on the tensor cores: mma.sync m16n8k16 with fp32
//    accumulators, 64 x 128 x 32 tiles, 4 warps of 32 x 64 each, operands
//    staged with cp.async through a 3-deep ring of shared-memory tiles and
//    read with ldmatrix (the w tile transposed on the way, since w is
//    stored D-major); padded rows keep ldmatrix free of bank conflicts;
//  * every other operand pair (fp32 x fp32, fp32 x bf16, bf16 x fp32)
//    widens both operands to fp32 as they are staged, as _mm_kernel does,
//    and runs on the fp32 cores, each of 256 threads owning a 4 x 4 block
//    of a 64 x 64 tile in registers;
//  * any C, D and F: tiles past the edges are zero-filled on load and
//    masked on store (the TPU wrapper shrinks its blocks to divisors
//    instead); 16-byte copies when D and F are multiples of 8, element
//    loads otherwise;
//  * the output is written once, in fp32 or bf16 (the MoE FFN keeps fp32
//    between its GEMMs, as the reference's einsums do).
// Still simple: no wgmma, no TMA, no warp specialisation.

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b, bool pair,
                                       bool second) {
  if (pair) {
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<float2*>(p) = make_float2(a, b);
    } else {
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
    }
  } else {
    p[0] = repro::from_float<T>(a);
    if (second) p[1] = repro::from_float<T>(b);
  }
}

// ---------------------------------------------------------------------------
// bf16 x bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr int MMA_THREADS = 128;
constexpr int BM = 64;         // rows of x (capacity slots) per tile
constexpr int BN = 128;        // columns of w per tile
constexpr int BK = 32;         // depth per stage
constexpr int STAGES = 3;
constexpr int AS = BK + 8;     // padded row of the x tile, in bf16
constexpr int BS = BN + 8;     // padded row of the w tile, in bf16

__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// the same, each matrix transposed
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Copy rows [r0, r0+R) x columns [col0, col0+W) of the row-major
// (rows, cols) matrix src into dst (row stride ld), zero past the edges.
// vec: cols is a multiple of 8, so every 8-column chunk is wholly in or out
// and 16-byte aligned.
template <int R, int W, int NT>
__device__ __forceinline__ void stage_tile(bf16* dst, int ld, const bf16* src,
                                           int rows, int cols, int r0,
                                           int col0, bool vec, int tid) {
  constexpr int CPR = W / 8;
  for (int c = tid; c < R * CPR; c += NT) {
    const int r = c / CPR;
    const int ch = c - r * CPR;
    const int gr = r0 + r;
    const int gk = col0 + ch * 8;
    bf16* d = dst + r * ld + ch * 8;
    const bf16* s = src + static_cast<size_t>(gr) * cols + gk;
    if (vec && gr < rows && gk < cols) {
      repro::cp_async16(d, s);
    } else if (gr >= rows || gk >= cols) {
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        d[e] = gk + e < cols ? s[e] : __float2bfloat16_rn(0.f);
      }
    }
  }
}

// Grid (ceil(C/BM), ceil(F/BN), E).
template <typename TO>
__global__ void __launch_bounds__(MMA_THREADS)
moe_gemm_mma(const bf16* __restrict__ x, const bf16* __restrict__ w,
             TO* __restrict__ out, int C, int D, int F, int vec) {
  extern __shared__ __align__(16) float smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);  // STAGES x BM x AS
  bf16* b_s = a_s + STAGES * BM * AS;         // STAGES x BK x BS

  const int c0 = blockIdx.x * BM;
  const int f0 = blockIdx.y * BN;
  const int e = blockIdx.z;
  const bf16* xe = x + static_cast<size_t>(e) * C * D;
  const bf16* we = w + static_cast<size_t>(e) * D * F;
  TO* oe = out + static_cast<size_t>(e) * C * F;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wm = (warp / 2) * 32;  // this warp's 32 rows ...
  const int wn = (warp % 2) * 64;  // ... and 64 columns of the tile
  const int n_k = (D + BK - 1) / BK;

  // x tile: rows c0.., depth k0..; w tile: depth k0.., columns f0.. (w is
  // (D, F) row-major, so its tile is staged as D rows of F columns)
  auto stage = [&](int kt, int buf) {
    stage_tile<BM, BK, MMA_THREADS>(a_s + buf * BM * AS, AS, xe, C, D, c0,
                                    kt * BK, vec, tid);
    stage_tile<BK, BN, MMA_THREADS>(b_s + buf * BK * BS, BS, we, D, F,
                                    kt * BK, f0, vec, tid);
    repro::cp_async_commit();
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      acc[mi][ni][0] = acc[mi][ni][1] = acc[mi][ni][2] = acc[mi][ni][3] = 0.f;
    }
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_k) {
      stage(s, s);
    } else {
      repro::cp_async_commit();  // keep the group count uniform
    }
  }
  for (int kt = 0; kt < n_k; ++kt) {
    repro::cp_async_wait<STAGES - 2>();  // tile kt has landed
    __syncthreads();  // ... for every thread; tile kt-1 is consumed
    const int nk = kt + STAGES - 1;
    if (nk < n_k) {
      stage(nk, nk % STAGES);
    } else {
      repro::cp_async_commit();
    }
    const bf16* as = a_s + (kt % STAGES) * BM * AS;
    const bf16* bs = b_s + (kt % STAGES) * BK * BS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      unsigned af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        ldsm_x4(af[mi], as + (wm + mi * 16 + lane % 16) * AS + kk +
                            (lane / 16) * 8);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ni += 2) {
        unsigned bfr[4];  // b0, b1 of column tiles ni and ni + 1
        ldsm_x4_t(bfr, bs + (kk + lane % 16) * BS + wn + ni * 8 +
                           (lane / 16) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][ni], af[mi], bfr[0], bfr[1]);
          mma_bf16(acc[mi][ni + 1], af[mi], bfr[2], bfr[3]);
        }
      }
    }
  }
  repro::cp_async_wait<0>();

  const int gid = lane / 4;
  const int tig = lane % 4;
  const bool even_f = (F % 2) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = c0 + wm + mi * 16 + gid + 8 * h;
      if (row >= C) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int col = f0 + wn + ni * 8 + tig * 2;
        if (col >= F) continue;
        store2(oe + static_cast<size_t>(row) * F + col, acc[mi][ni][2 * h],
               acc[mi][ni][2 * h + 1], even_f, col + 1 < F);
      }
    }
  }
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

template <typename TO>
int launch_mma(const void* x, const void* w, void* out, int E, int C, int D,
               int F, cudaStream_t stream) {
  const size_t smem =
      sizeof(bf16) * STAGES * (static_cast<size_t>(BM) * AS + BK * BS);
  auto kernel = moe_gemm_mma<TO>;
  cudaError_t err = repro::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + BM - 1) / BM, (F + BN - 1) / BN, E);
  kernel<<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<TO*>(out), C, D, F, (D % 8 == 0 && F % 8 == 0) ? 1 : 0);
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

}  // namespace

// x (E,C,D), w (E,D,F), out (E,C,F), each row-major in its own dtype (bf16
// when its flag is set, else fp32); 16-byte aligned base pointers.
// Returns the launch's cudaError_t.
extern "C" int moe_gemm_launch(const void* x, const void* w, void* out, int E,
                               int C, int D, int F, int x_bf16, int w_bf16,
                               int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16 && w_bf16) {
    if (out_bf16) return launch_mma<bf16>(x, w, out, E, C, D, F, s);
    return launch_mma<float>(x, w, out, E, C, D, F, s);
  }
  if (x_bf16) return launch_simt_out<bf16, float>(x, w, out, E, C, D, F, out_bf16, s);
  if (w_bf16) return launch_simt_out<float, bf16>(x, w, out, E, C, D, F, out_bf16, s);
  return launch_simt_out<float, float>(x, w, out, E, C, D, F, out_bf16, s);
}
