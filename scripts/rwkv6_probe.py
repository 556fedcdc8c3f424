"""Probe of the port's rwkv6_scan kernel on the card: where its time goes.

    python3 scripts/rwkv6_probe.py [--phases] [--out chiprun_out/rwkv6_probe.json]

Run from the root of a checkout: it times that checkout's kernel, so
running it from an unpacked older tree times the older kernel.  At the
rwkv6-1.6b dense prefill's shape (B=8, S=512, H=32, K=V=64, bf16 r/k/v),
at a decode step (S=1), at a ragged S=77 and at S=2048 it prints the
kernel's device time with the L2 flushed before each launch, beside its
bounds: the bytes, the fp32 cores (the recurrence's operations) and, at
S > 1, the units the chunk kernel uses (3xTF32 tensor cores, the SFU's
exps; ``chip_smoke.rwkv6_unit_bound``), each held against the plain
version (``RWKV_TOL``) on the reference's decays and on strong ones.

``--phases`` also builds a copy of ``csrc/rwkv6_scan.cu`` into
``build/probe/`` in which thread 0 of the chunk kernel's first CTA reads
``clock64()`` at every barrier, and prints the cycles a chunk spends
between barriers: loading (the cp.async copies of the next chunk and the
widening of this one), the segment sums of the log-decays, the decays,
the diagonal and off-diagonal blocks of A with q_int S, and A V with the
state update.  The first CTA shares its SM with a second one, so the
cycles are those of two CTAs interleaved.

Needs one CUDA card; imports nothing of JAX.
"""
import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

B, H, K = 8, 32, 64
PHASES = ("load", "segment sums", "decays", "A and q_int S",
          "A V and the state")


def bounds(S):
    r = torch.empty(B, S, H, K, dtype=torch.bfloat16, device="meta")
    out = dict(fp32_bound=cs.bound(*cs.rwkv6_bytes_flops(r, r),
                                   torch.float32))
    if S > 1:
        out["unit_bound"] = cs.rwkv6_unit_bound(B, S, H, K, K)
    return out


def phases(build, ops, gen):
    """Cycles a chunk spends between the chunk kernel's barriers."""
    src = (build.CSRC / "rwkv6_scan.cu").read_text()
    a = src.index("rwkv6_chunk_kernel(const T* __restrict__ r")
    b = src.index("// S = 1.  Grid")
    loop = src.index("  for (int ci = 0; ci < nc; ++ci) {", a)
    body = (src[a:loop] + "  long long t0_ = clock64(); int ph_ = 0;\n"
            + src[loop:b].replace("__syncthreads();",
                                  "__syncthreads(); STAMP();"))
    stamp = (
        "__device__ unsigned long long g_cycles[8];\n"
        "#define STAMP() do { if (threadIdx.x == 0 && blockIdx.x == 0) {"
        " const long long t_ = clock64(); g_cycles[ph_] += t_ - t0_;"
        " t0_ = t_; } ph_ = (ph_ + 1) % 5; } while (0)\n")
    text = (src[:a].replace('#include "common.cuh"',
                            '#include "common.cuh"\n' + stamp)
            + body + src[b:]
            + '\nextern "C" int cycles_read(unsigned long long* out) {\n'
              "  return (int)cudaMemcpyFromSymbol(out, g_cycles, "
              "sizeof(g_cycles));\n}\n"
              'extern "C" int cycles_clear() {\n'
              "  unsigned long long z[8] = {0};\n"
              "  return (int)cudaMemcpyToSymbol(g_cycles, z, sizeof(z));\n}\n")
    out = ROOT / "build" / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "rwkv6_phases.cu").write_text(text)
    lib_path = out / "librwkv6_phases.so"
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS,
                          f"-I{build.CSRC}", "-o", str(lib_path),
                          str(out / "rwkv6_phases.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        cs.fail(f"building the instrumented copy failed:\n{res.stdout}")
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.rwkv6_scan_launch
    fn.argtypes = ops._SIGNATURES["rwkv6_scan"]
    fn.restype = ctypes.c_int
    rows = []
    for S in (512, 77):
        r, k, v, lw, u, S0 = cs.rwkv6_inputs(B, S, H, K, torch.bfloat16, gen)
        o = torch.empty(B, S, H, K, device="cuda")
        sT = torch.empty_like(S0)
        lib.cycles_clear()
        err = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), lw.data_ptr(),
                 u.data_ptr(), S0.data_ptr(), o.data_ptr(), sT.data_ptr(),
                 B, S, H, K, K, 1, 1, torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 8)()
        lib.cycles_read(buf)
        nc = -(-S // 32)
        per = {name: buf[i] / nc for i, name in enumerate(PHASES)}
        rows.append(dict(S=S, launch_error=err, cycles_per_chunk=per))
        print(f"phases S={S}: cycles a chunk (CTA 0, sharing its SM) "
              + ", ".join(f"{n} {c:.0f}" for n, c in per.items()),
              flush=True)
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/rwkv6_probe.json")
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    from repro_torch.kernels import build, ops, ref
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for S in (512, 1, 77, 2048):
        errs = []
        for strong in (False, True):
            x = cs.rwkv6_inputs(B, S, H, K, torch.bfloat16, gen, strong)
            o, sT = ops.rwkv6_scan(*x)
            o_p, sT_p = ref.rwkv6_scan(*x)
            errs.append(max(cs.max_err(o, o_p), cs.max_err(sT, sT_p)))
        ms = [cs.time_ms(lambda: ops.rwkv6_scan(*x)) for _ in range(2)]
        r = dict(S=S, ms=ms, max_abs_err=errs, **bounds(S))
        plan = getattr(ops, "rwkv6_plan", None)
        if plan is not None:
            r["plan"] = plan(B, S, H, K, K)._asdict()
        rows.append(r)
        print(f"rwkv6_scan B={B} S={S} H={H} K=V={K} bf16: kernel "
              + " / ".join(f"{t:.4f}" for t in ms) + " ms; max abs err "
              f"{errs[0]:.3g}, strong decays {errs[1]:.3g} (tol "
              f"{cs.RWKV_TOL}); bounds "
              + ", ".join(f"{k} {v[0]:.4f} ms ({v[1]})"
                          for k, v in bounds(S).items())
              + (f"; plan {r['plan']}" if "plan" in r else ""), flush=True)
        if not max(errs) <= cs.RWKV_TOL:
            cs.fail(f"rwkv6_scan S={S}: max abs err {max(errs)}")
    if args.phases:
        rows.append(dict(phases=phases(build, ops, gen)))
    out = ROOT / args.out
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(dict(gpu=cs.gpu_info(), rows=rows), indent=2))
    print(cs.gpu_info())


if __name__ == "__main__":
    main()
