"""Probe of the port's moe_gemm kernel on the card: what bounds each regime.

    python3 scripts/moe_gemm_probe.py [--sweep] [--out chiprun_out/moe_gemm_probe.json]

Run from the root of a checkout: it times that checkout's kernel, so
running it from an unpacked older tree times the older kernel.  For each
of grok-1's six grouped GEMMs (``chip_smoke.MOE_SHAPES``, bf16 x bf16 ->
fp32) it prints the kernel's and ``torch.bmm``'s device times with the L2
flushed before each launch, their achieved bytes and FLOP rates, and the
bound.  Three controls tell the candidate causes apart:

* in L2: a GEMM whose operands stay in the 50 MB L2 cache, timed warm:
  if the kernel's FLOP rate there is no higher than at the prefill
  shapes, the tensor-core issue rate, not device memory, bounds prefill;
* grid tail: decode down at E = 8 and E = 11 experts (the same shape per
  expert): if the bytes rate rises with the grid, a part-empty last wave
  bounds it;
* row tiles: the paged prefill at C = 160 and C = 128: if C = 160 costs
  more than 160/128 of C = 128, the row tiles past C are paid for.

``--sweep`` also times, at each of the six shapes, the plans that
``ops.moe_plan`` could have chosen instead of its own (the other tiles of
the wgmma kernel; K splits 1, 2, 4 and 8 of the stream kernel), each held
to the output of the chosen plan and timed twice, in forward and then
backward order.

Needs one CUDA card; imports nothing of JAX.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def rates(E, C, D, F, ms):
    nbytes = 2 * (E * C * D + E * D * F) + 4 * E * C * F
    flops = 2 * E * C * D * F
    return dict(gb_s=nbytes / ms / 1e6, tflop_s=flops / ms / 1e9,
                bound_ms=cs.bound(nbytes, flops, torch.bfloat16)[0])


def alternatives(ops, E, C, D, F, sms):
    """The plans the kernels take at this shape besides the chosen one."""
    chosen = ops.moe_plan(E, C, D, F, sms, True, True)
    n_k = -(-D // ops.MOE_BK)
    out = []
    if chosen.regime == "stream":
        for split in (1, 2, 4, 8):
            kps = -(-n_k // split)
            if -(-n_k // kps) == split:
                out.append(chosen._replace(split=split, kps=kps,
                                           grid=(split,) + chosen.grid[1:]))
    else:
        for rows, cols in ((128, 256), (128, 128), (192, 128)):
            out.append(chosen._replace(rows=rows, cols=cols, grid=(
                -(-C // rows), -(-F // cols), E)))
    return chosen, [p for p in out if p != chosen]


def sweep(ops, what, E, C, D, F, sms, gen):
    bf, f32 = torch.bfloat16, torch.float32
    x = torch.randn(E, C, D, generator=gen, device="cuda").to(bf)
    w = torch.randn(E, D, F, generator=gen, device="cuda").to(bf)
    chosen, alts = alternatives(ops, E, C, D, F, sms)
    want = ops.moe_gemm(x, w, out_dtype=f32)

    def run(p, out):
        ops._moe_launch(x, w, out, p)

    plans = [chosen] + alts
    out = torch.empty_like(want)
    errs, times = [], {i: [] for i in range(len(plans))}
    for p in plans:
        run(p, out)
        errs.append(float((out - want).abs().max()))
    # forward, then backward: the first plan timed tends to run slow
    for i in list(range(len(plans))) + list(reversed(range(len(plans)))):
        times[i].append(cs.time_ms(lambda: run(plans[i], out), iters=10))
    res = []
    for i, p in enumerate(plans):
        res.append(dict(plan=p._asdict(), ms=times[i], max_abs_diff=errs[i]))
        print(f"sweep {what} {(E, C, D, F)} {p.regime} {p.rows}x{p.cols} "
              f"split {p.split} grid {p.grid}: "
              + " / ".join(f"{t:.4f}" for t in times[i])
              + f" ms, max |diff| vs the chosen plan {errs[i]:.3g}"
              + (" (chosen)" if p == chosen else ""), flush=True)
    del x, w, want
    torch.cuda.empty_cache()
    return dict(name=f"sweep {what}", shape=[E, C, D, F], plans=res)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/moe_gemm_probe.json")
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    from repro_torch.kernels import build, ops
    build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf = torch.float32, torch.bfloat16
    rows = []

    def probe(what, E, C, D, F, flush=True):
        x = torch.randn(E, C, D, generator=gen, device="cuda").to(bf)
        w = torch.randn(E, D, F, generator=gen, device="cuda").to(bf)
        fb = (64 << 20) if flush else 1
        ms = cs.time_ms(lambda: ops.moe_gemm(x, w, out_dtype=f32), iters=10,
                        flush_bytes=fb)
        lib = cs.time_ms(lambda: torch.bmm(x, w), iters=10, flush_bytes=fb)
        r = dict(name=what, shape=[E, C, D, F], ms=ms, bmm_ms=lib,
                 flushed=flush, **rates(E, C, D, F, ms))
        plan = getattr(ops, "moe_plan", None)
        if plan is not None:
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            r["plan"] = plan(E, C, D, F, sms, True, True)._asdict()
        r["bmm"] = rates(E, C, D, F, lib)
        rows.append(r)
        print(f"{what} {(E, C, D, F)}: kernel {ms:.4f} ms "
              f"({r['gb_s']:.0f} GB/s, {r['tflop_s']:.1f} TFLOP/s), bmm "
              f"{lib:.4f} ms ({r['bmm']['gb_s']:.0f} GB/s, "
              f"{r['bmm']['tflop_s']:.1f} TFLOP/s), bound "
              f"{r['bound_ms']:.4f} ms" + (f", plan {r['plan']}"
                                            if "plan" in r else ""),
              flush=True)
        del x, w
        torch.cuda.empty_cache()

    for what, E, C, D, F in cs.MOE_SHAPES:
        probe(what, E, C, D, F)
    if args.sweep:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for what, E, C, D, F in cs.MOE_SHAPES:
            rows.append(sweep(ops, what, E, C, D, F, sms, gen))
    probe("in L2 (warm)", 1, 1024, 1024, 8192, flush=False)
    probe("grid tail: decode down, E=11", 11, 8, 32768, 6144)
    probe("row tiles: paged prefill up, C=128", 8, 128, 6144, 32768)
    out = ROOT / args.out
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(dict(gpu=cs.gpu_info(), rows=rows), indent=2))
    print(cs.gpu_info())


if __name__ == "__main__":
    main()
