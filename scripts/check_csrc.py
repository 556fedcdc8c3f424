#!/usr/bin/env python
"""Check the port's CUDA sources for C++ errors without nvcc.

Each ``src/repro_torch/csrc/*.cu`` is compiled with ``g++ -fsyntax-only``
after two rewrites (inline PTX statements become no-ops, ``<<<...>>>``
launch configurations are dropped so that a launch reads as a call) and
against a prelude of stubs for the device built-ins the kernels use.
CUDA's own host headers (``cuda_runtime_api.h``, ``cuda.h``) supply the
runtime types.  It catches what C++ itself refuses (undeclared names,
type and template errors, conflicting declarations), not what only
ptxas or the card can (PTX, registers, shared memory).

    python scripts/check_csrc.py --cuda-include DIR

where DIR holds ``cuda_runtime_api.h`` (a CUDA toolkit's ``include``).
Exit status 1 if any source fails.
"""
import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"

PRELUDE = r"""
#pragma once
#include <cstdint>
#include <cstddef>
#include <cmath>
#include <algorithm>
#include <type_traits>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __restrict__
#define __grid_constant__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)
#define STUB_ASM(...) ((void)0)
#include "vector_types.h"
#include "vector_functions.h"
#include "driver_types.h"
#include "cuda_runtime_api.h"
#include "cuda.h"
extern dim3 threadIdx, blockIdx, gridDim, blockDim;
inline void __syncthreads() {}
inline void __trap() {}
inline void __syncwarp(unsigned = 0xffffffffu) {}
inline float __shfl_xor_sync(unsigned, float x, int) { return x; }
inline float __shfl_up_sync(unsigned, float x, int) { return x; }
inline float __shfl_down_sync(unsigned, float x, int) { return x; }
inline float __uint_as_float(unsigned x) { return float(x); }
inline unsigned __float_as_uint(float x) { return unsigned(x); }
inline size_t __cvta_generic_to_shared(const void*) { return 0; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
template <class T> T __ldg(const T* p) { return *p; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float rsqrtf(float a) { return 1 / sqrtf(a); }
inline float __fdividef(float a, float b) { return a / b; }
inline float __expf(float a) { return expf(a); }
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat16 __float2bfloat16_rn(float) { return {}; }
inline __nv_bfloat16 __float2bfloat16(float) { return {}; }
inline float __bfloat162float(__nv_bfloat16) { return 0; }
inline __nv_bfloat162 __floats2bfloat162_rn(float, float) { return {}; }
inline float2 __bfloat1622float2(__nv_bfloat162) { return {}; }
template <class... K, class... A>
cudaError_t launch_ex_stub(const cudaLaunchConfig_t*, void (*f)(K...),
                           A&&... a) { f(a...); return cudaSuccess; }
#define cudaLaunchKernelEx launch_ex_stub
template <class K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
namespace cooperative_groups {
struct cluster_group {
  void sync() {}
  template <class T> T* map_shared_rank(T* p, unsigned) { return p; }
};
inline cluster_group this_cluster() { return {}; }
}
"""
# headers the prelude stands in for
STUBBED = ("cuda_bf16.h", "cooperative_groups.h", "cuda_runtime.h")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cuda-include", required=True, type=Path)
    args = ap.parse_args()
    failed = 0
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        (tmp / "prelude.h").write_text(PRELUDE)
        stubs = tmp / "stubs"
        stubs.mkdir()
        for name in STUBBED:
            (stubs / name).write_text("#pragma once\n")
        src = tmp / "src"
        src.mkdir()
        for path in sorted(CSRC.iterdir()):
            text = re.sub(r"\basm( volatile)?\(", "STUB_ASM(",
                          path.read_text())
            text = re.sub(r"<<<.*?>>>", "", text, flags=re.S)
            (src / path.name).write_text(text)
        for path in sorted(src.glob("*.cu")):
            res = subprocess.run(
                ["g++", "-std=c++17", "-fsyntax-only", "-w", "-include",
                 str(tmp / "prelude.h"), f"-I{stubs}",
                 f"-I{args.cuda_include}", f"-I{src}", "-x", "c++",
                 str(path)], capture_output=True, text=True)
            errors = [l for l in res.stderr.splitlines() if "error" in l]
            print(f"{path.name}: {'ok' if not res.returncode else 'FAILED'}")
            for line in errors[:20]:
                print("  " + line.replace(str(src) + "/", ""))
            failed += res.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
