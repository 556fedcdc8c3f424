"""Probe of the host's share of a host-bound decode step on the card.

    python3 scripts/host_probe.py [--out chiprun_out/host_probe.json]

Run from the root of a checkout: it measures that checkout's code, so
running it from an unpacked older tree measures the older code.  At
qwen3-1.7b's published widths (28 layers, random weights from seed 0,
bf16 activations, impl=pallas) it enqueues paged decode steps of 8
sequences at position 520 and reports:

* the host time to enqueue one step (five rounds of ten steps, the card
  drained after each round), beside the card's time for it;
* from ``torch.profiler`` over three steps: the kernels launched a step
  and the mean host time of ``cudaLaunchKernel``;
* the host time of one call of each norm wrapper at a decode step's
  shapes (2,000 calls, not drained in between), beside a PyTorch add,
  so that the wrappers' own cost per layer can be set against the
  launches they save.

Needs one CUDA card; imports nothing of JAX.
"""
import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

B, PAGE, PAGES_A_ROW, POS = 8, 16, 36, 520


def per_call_us(fn, n=2000):
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/host_probe.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import build, ops
    from repro_torch.models import lm
    build.build_all()
    cfg, params = cs.full_width_params("qwen3-1.7b")
    pools = lm.init_paged_caches(cfg, B * PAGES_A_ROW + 1, PAGE, "cuda")
    table = (torch.arange(B * PAGES_A_ROW, device="cuda").reshape(
        B, PAGES_A_ROW) + 1).to(torch.int32)
    pos = torch.full((B,), POS, dtype=torch.int32, device="cuda")
    tok = torch.ones((B, 1), dtype=torch.int32, device="cuda")

    def step():
        lm.decode_step_paged(params, cfg, tok, pools, table, pos)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    host_ms, drained_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(10):
            step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host_ms.append((t1 - t0) / 10 * 1e3)
        drained_ms.append((time.perf_counter() - t0) / 10 * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    launch = [e for e in events if e.key == "cudaLaunchKernel"]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 3
    res = dict(host_ms=host_ms, drained_ms=drained_ms, device_ms=device_ms,
               kernels_a_step=sum(e.count for e in kernels) / 3,
               launch_host_us=(launch[0].cpu_time_total / launch[0].count
                               if launch else None))
    print(f"qwen3-1.7b paged decode step, batch {B}: host enqueue "
          + ", ".join(f"{t:.2f}" for t in host_ms) + " ms (drained "
          + ", ".join(f"{t:.2f}" for t in drained_ms)
          + f" ms); card {device_ms:.3f} ms in "
          f"{res['kernels_a_step']:.0f} kernels; cudaLaunchKernel "
          + (f"{res['launch_host_us']:.2f}" if launch else "not seen")
          + " us of host time each", flush=True)

    bf = torch.bfloat16
    x, d = (torch.randn(B, cfg.d_model, device="cuda").to(bf)
            for _ in range(2))
    scale = torch.randn(cfg.d_model, device="cuda")
    q = torch.randn(B, 1, cfg.n_heads, cfg.head_dim, device="cuda").to(bf)
    k = torch.randn(B, 1, cfg.n_kv_heads, cfg.head_dim,
                    device="cuda").to(bf)
    qs = torch.randn(cfg.head_dim, device="cuda")
    cases = {"x + d": lambda: x + d,
             "rmsnorm": lambda: ops.rmsnorm(x, scale),
             "rmsnorm of q, then of k": lambda: (ops.rmsnorm(q, qs),
                                                 ops.rmsnorm(k, qs))}
    if hasattr(ops, "add_rmsnorm"):
        cases["add_rmsnorm"] = lambda: ops.add_rmsnorm(x, d, scale)
        cases["qk_rmsnorm"] = lambda: ops.qk_rmsnorm(q, k, qs, qs)
    res["wrapper_host_us"] = {}
    for name, fn in cases.items():
        us = per_call_us(fn)
        res["wrapper_host_us"][name] = us
        print(f"host time of one call, {name}: {us:.2f} us", flush=True)
    out = ROOT / args.out
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(dict(gpu=cs.gpu_info(), **res), indent=2))
    print(cs.gpu_info())


if __name__ == "__main__":
    main()
