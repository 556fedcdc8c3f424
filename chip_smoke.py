"""GPU smoke run of the PyTorch/CUDA port: builds the kernels, holds each
against its plain PyTorch version, serves qwen3-1.7b at full width through
the paged engine, rwkv6-1.6b and recurrentgemma-2b at full width through
the dense engine, and grok-1-314b at full width with its depth cut to
four layers through both engines, and checks each served path at a cut
depth against the port's plain path.

    python3 chip_smoke.py

Needs one CUDA card with 80 GB (the kernels target Hopper, sm_90a; grok's
four layers hold 42.6 GB of bf16 parameters) and the CUDA toolkit;
imports nothing of JAX.  Every phase prints one line of results; any
failure exits non-zero.  The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

preceded by the kernels' JSON line and the card's name and power limit.
The full record of the run is also written to chiprun_out/chip_smoke.json.
"""
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # abs, on O(1) inputs
PEAK_BW = 3.35e12                                   # H100 SXM HBM3, B/s
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense FLOP/s
SEED = 0
DEVICE = "cuda"
# times of the earlier designs of the redesigned kernels (the fp32-core
# and mma.sync flash, the scalar decode body with a separate merge launch,
# the mma.sync moe_gemm, the two-read rmsnorm, the fp32-core rwkv6_scan),
# as PERF.md section 6 records them from this script on an NVIDIA H100
# 80GB HBM3 at 700 W; printed beside this run's times
EARLIER_MS = {
    "rwkv6_scan S=512": 0.7343,
    "rwkv6_scan S=1": 0.0160,
    "rmsnorm (8, 6144)": 0.0082,
    "rmsnorm (8, 2048)": 0.0064,
    "rmsnorm (4, 2560)": 0.0072,
    "rmsnorm (128, 128)": 0.0064,
    "rmsnorm (4096, 6144)": 0.0424,
    "moe_gemm dense prefill up": 9.112,
    "moe_gemm dense prefill down": 9.608,
    "moe_gemm paged prefill up": 2.951,
    "moe_gemm paged prefill down": 3.319,
    "moe_gemm decode up": 1.1397,
    "moe_gemm decode down": 1.1317,
    "flash (1, 512, 16, 128)": 0.0441,
    "flash (1, 512, 48, 128) softcap 30": 0.0963,
    "flash (8, 512, 48, 128) softcap 30": 0.4896,
    "flash (4, 2100, 10, 256) window 2048": 7.079,
    "decode_attention B=8 H=48 pos 575 softcap 30": 0.0781,
    "paged B=8 H=16 pos 575": 0.0345,
    "paged B=8 H=48 pos 575 softcap 30": 0.0786,
}


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def gpu_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def time_ms(fn, iters=20, flush_bytes=64 << 20):
    """Mean device time of ``fn`` in ms: CUDA events around each call, with
    the 50 MB L2 cache flushed before it (the engine's caller finds the
    cache cold: every other layer's weights pass through it in between)
    and the card held busy for about a millisecond first, so that the
    host's time to enqueue ``fn`` is not counted as device time."""
    scratch = torch.empty(flush_bytes, dtype=torch.uint8, device=DEVICE)
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        scratch.zero_()
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.mean(times))


def max_err(a, b):
    """max |a - b|; inf where either side holds a NaN or an inf, so that
    every ``not err <= tol`` below fails a kernel that writes one."""
    d = (a.float() - b.float()).abs()
    return float(d.max()) if bool(torch.isfinite(d).all()) else float("inf")


def within(err, limit):
    """Elementwise err <= limit everywhere (False on NaN)."""
    return bool((err <= limit).all())


# ---------------------------------------------------------------------------
# phase 2 — kernels against their plain versions
# ---------------------------------------------------------------------------
def paged_inputs(B, H, Kv, hd, ps, nmax, pos, dtype, gen):
    """q, pages with a garbage null page 0, a shuffled block table (pages
    1..B*nmax, each sequence its own), pos."""
    P = 1 + B * nmax
    q = torch.randn(B, H, hd, generator=gen, device=DEVICE).to(dtype)
    kp = torch.randn(P, ps, Kv, hd, generator=gen, device=DEVICE).to(dtype)
    vp = torch.randn(P, ps, Kv, hd, generator=gen, device=DEVICE).to(dtype)
    perm = torch.randperm(B * nmax, generator=gen, device=DEVICE) + 1
    bt = perm.reshape(B, nmax).to(torch.int32)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=DEVICE)
    return q, kp, vp, bt, pos


def paged_bytes_flops(q, kp, bt, pos):
    B, H, hd = q.shape
    ps, Kv = kp.shape[1], kp.shape[2]
    e = q.element_size()
    live = int((pos.long() + 1).sum())                 # slots this run reads
    pages = int((pos.long() // ps + 1).sum())          # table entries read
    nbytes = 2 * q.numel() * e + 2 * live * Kv * hd * e + 4 * pages + 4 * B
    flops = 4 * live * (H // Kv) * Kv * hd             # q.k and p.v
    return nbytes, flops


def flash_bytes_flops(q, causal, window=None):
    B, S, H, hd = q.shape
    i = np.arange(S)[:, None]
    j = np.arange(S)[None, :]
    ok = np.ones((S, S), bool)
    if causal:
        ok &= j <= i
    if window is not None:
        ok &= (i - j) < window
    return 4 * q.numel() * q.element_size(), 4 * B * H * hd * int(ok.sum())


def bound(nbytes, flops, dtype):
    t_b, t_f = nbytes / PEAK_BW, flops / PEAK_FLOPS[dtype]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def check_paged(ops, ref):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    lines, worst = [], {}
    B, H, Kv, hd, ps = 8, 16, 8, 128, 16
    nmax = 576 // ps
    ragged = [575, 0, 17, 300, 16, 15, 511, 255]
    cases = [("main", torch.bfloat16, [575] * B),
             ("main", torch.float32, [575] * B),
             ("ragged", torch.bfloat16, ragged),
             ("ragged", torch.float32, ragged),
             ("pos0", torch.float32, [0] * B)]
    for name, dtype, pos in cases:
        q, kp, vp, bt, p = paged_inputs(B, H, Kv, hd, ps, nmax, pos, dtype,
                                        gen)
        err = max_err(ops.paged_decode_attention(q, kp, vp, bt, p),
                      ref.paged_decode_attention(q, kp, vp, bt, p))
        worst[(name, dtype)] = err
        if not err <= TOL[dtype]:
            fail(f"paged decode {name} {dtype}: max abs err {err}")
    # null-page poisoning: rows past pos name page 0, which is poisoned
    q, kp, vp, bt, p = paged_inputs(B, H, Kv, hd, ps, nmax, ragged,
                                    torch.float32, gen)
    for b, last in enumerate(ragged):
        bt[b, last // ps + 1:] = 0
    o1 = ops.paged_decode_attention(q, kp, vp, bt, p)
    kp[0], vp[0] = 1e6, -1e6
    o2 = ops.paged_decode_attention(q, kp, vp, bt, p)
    if not torch.equal(o1, o2) or not max_err(
            o1, ref.paged_decode_attention(q, kp, vp, bt, p)) <= 1e-4:
        fail("paged decode reads the poisoned null page")
    # an inactive engine slot: all-null row, pos 0 — reads page 0 slot 0
    bt0 = torch.zeros_like(bt)
    p0 = torch.zeros_like(p)
    if not max_err(ops.paged_decode_attention(q, kp, vp, bt0, p0),
                   ref.paged_decode_attention(q, kp, vp, bt0, p0)) <= 1e-4:
        fail("paged decode on all-null rows")
    # GQA group sizes and head dims: G up to 16 fills the bf16 kernel's 16
    # tensor-core rows, hd 256 its widest tiles
    for G in (1, 2, 4, 6, 8, 12, 16):
        for hd_ in (16, 64, 128, 256):
            for dtype in (torch.float32, torch.bfloat16):
                q, kp, vp, bt, p = paged_inputs(3, 2 * G, 2, hd_, 16, 5,
                                                [79, 0, 33], dtype, gen)
                err = max_err(ops.paged_decode_attention(q, kp, vp, bt, p),
                              ref.paged_decode_attention(q, kp, vp, bt, p))
                if not err <= TOL[dtype]:
                    fail(f"paged decode G={G} hd={hd_} {dtype}: err {err}")
    # grok's shapes and attention softcap
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, bt, p = paged_inputs(B, 48, Kv, hd, ps, nmax, ragged,
                                        dtype, gen)
        err = max_err(
            ops.paged_decode_attention(q, kp, vp, bt, p, softcap=30.0),
            ref.paged_decode_attention(q, kp, vp, bt, p, softcap=30.0))
        if not err <= TOL[dtype]:
            fail(f"paged decode H=48 softcap 30 {dtype}: err {err}")
    lines.append("null-page poisoning exact; G in {1,2,4,6,8,12,16} x hd "
                 "in {16,64,128,256} x {fp32,bf16} and grok's H=48 Kv=8 "
                 "with softcap 30 x {fp32,bf16} within tolerance")
    # time at the main path's shapes and type (bf16, every pos 575)
    q, kp, vp, bt, p = paged_inputs(B, H, Kv, hd, ps, nmax, [575] * B,
                                    torch.bfloat16, gen)
    ms = time_ms(lambda: ops.paged_decode_attention(q, kp, vp, bt, p))
    plain_ms = time_ms(lambda: ref.paged_decode_attention(q, kp, vp, bt, p))
    nbytes, flops = paged_bytes_flops(q, kp, bt, p)
    b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
    # grok's paged decode: H=48, softcap 30
    q, kp, vp, bt, p = paged_inputs(B, 48, Kv, hd, ps, nmax, [575] * B,
                                    torch.bfloat16, gen)
    g_ms = time_ms(lambda: ops.paged_decode_attention(q, kp, vp, bt, p,
                                                      softcap=30.0))
    g_plain = time_ms(lambda: ref.paged_decode_attention(q, kp, vp, bt, p,
                                                         softcap=30.0))
    g_bound = bound(*paged_bytes_flops(q, kp, bt, p), torch.bfloat16)
    rec = dict(name="paged_decode_attention", route="cuda",
               source="src/repro_torch/csrc/paged_decode_attention.cu",
               replaces="src/repro/kernels/decode_attention.py:189",
               max_abs_err=worst[("main", torch.bfloat16)], ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None,
               shapes=[dict(shape="B=8 H=16 Kv=8 hd=128 pos 575", ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms,
                            earlier_ms=EARLIER_MS["paged B=8 H=16 pos 575"]),
                       dict(shape="B=8 H=48 Kv=8 hd=128 pos 575 softcap 30",
                            ms=g_ms, plain_ms=g_plain,
                            bound_ms=g_bound[0], earlier_ms=EARLIER_MS[
                                "paged B=8 H=48 pos 575 softcap 30"])])
    lines.append(f"paged_decode_attention at grok's B=8 H=48 pos 575 "
                 f"softcap 30 bf16: kernel {g_ms:.4f} ms (earlier design "
                 f"{EARLIER_MS['paged B=8 H=48 pos 575 softcap 30']} ms), "
                 f"plain {g_plain:.4f} ms, bound {g_bound[0]:.4f} ms "
                 f"({g_bound[1]}), no library call")
    errs = ", ".join(f"{n} {str(d)[6:]} {e:.3g}" for (n, d), e in worst.items())
    lines.insert(0, f"paged_decode_attention B={B} H={H} Kv={Kv} hd={hd} "
                    f"ps={ps} pos<=575: max abs err [{errs}] (tol fp32 "
                    f"{TOL[torch.float32]}, bf16 {TOL[torch.bfloat16]}); "
                    f"kernel {ms:.4f} ms (earlier design "
                    f"{EARLIER_MS['paged B=8 H=16 pos 575']} ms), plain "
                    f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                    f"{nbytes / 1e6:.2f} MB), no library call")
    return rec, lines


def check_flash(ops, ref):
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    shape = (1, 512, 16, 128)
    worst = {}

    def qkv(shape, dtype):
        return [torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
                for _ in range(3)]

    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = qkv(shape, dtype)
        err = max_err(ops.flash_attention(q, k, v, causal=True),
                      ref.flash_attention(q, k, v, causal=True))
        worst[dtype] = err
        if not err <= TOL[dtype]:
            fail(f"flash {dtype}: max abs err {err}")
    # masks and ragged lengths (S not a multiple of the 64-row tiles), on
    # both the wgmma (bf16) and the fp32-core paths
    for S in (77, 200):
        for kw in (dict(causal=True), dict(causal=False),
                   dict(causal=True, window=48),
                   dict(causal=True, softcap=30.0)):
            for hd in (16, 64, 128, 256):
                for dtype in (torch.float32, torch.bfloat16):
                    q, k, v = qkv((2, S, 3, hd), dtype)
                    err = max_err(ops.flash_attention(q, k, v, **kw),
                                  ref.flash_attention(q, k, v, **kw))
                    if not err <= TOL[dtype]:
                        fail(f"flash S={S} hd={hd} {dtype} {kw}: max abs "
                             f"err {err}")
    # the wgmma kernel's edges (bf16): S around its 64-key and 128-row
    # tiles and past a window, every padding of hd to its 64-column boxes,
    # a window of 40 that starts in the middle of a tile, softcap 30
    for S in (63, 64, 65, 129):
        for kw in (dict(causal=True), dict(causal=False),
                   dict(causal=True, window=40),
                   dict(causal=True, softcap=30.0)):
            for hd in (16, 64, 128, 192, 256):
                q, k, v = qkv((2, S, 3, hd), torch.bfloat16)
                err = max_err(ops.flash_attention(q, k, v, **kw),
                              ref.flash_attention(q, k, v, **kw))
                if not err <= TOL[torch.bfloat16]:
                    fail(f"flash S={S} hd={hd} bf16 {kw}: max abs err {err}")
    # grids large enough for 128-row CTAs (the cases above run 64-row CTAs
    # whose two consumer warpgroups split the kv tiles)
    for hd in (16, 64, 128, 192, 256):
        for kw in (dict(causal=True), dict(causal=True, window=40),
                   dict(causal=False, softcap=30.0)):
            q, k, v = qkv((2, 300, 40, hd), torch.bfloat16)
            err = max_err(ops.flash_attention(q, k, v, **kw),
                          ref.flash_attention(q, k, v, **kw))
            if not err <= TOL[torch.bfloat16]:
                fail(f"flash (2, 300, 40, {hd}) bf16 {kw}: max abs err {err}")
    for hd in (16, 64, 128, 192, 256):
        for kw in (dict(causal=True), dict(causal=True, window=1000)):
            q, k, v = qkv((1, 2100, 2, hd), torch.bfloat16)
            err = max_err(ops.flash_attention(q, k, v, **kw),
                          ref.flash_attention(q, k, v, **kw))
            if not err <= TOL[torch.bfloat16]:
                fail(f"flash S=2100 hd={hd} bf16 {kw}: max abs err {err}")
    # grok's prefill: H=48, hd 128, attention softcap 30
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = qkv((1, 512, 48, 128), dtype)
        kw = dict(causal=True, softcap=30.0)
        err = max_err(ops.flash_attention(q, k, v, **kw),
                      ref.flash_attention(q, k, v, **kw))
        if not err <= TOL[dtype]:
            fail(f"flash H=48 softcap 30 {dtype}: max abs err {err}")
    q, k, v = qkv(shape, torch.bfloat16)
    ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: ref.flash_attention(q, k, v, causal=True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    nbytes, flops = flash_bytes_flops(q, causal=True)
    b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
    shapes = [dict(shape=list(shape), softcap=None, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, library_ms=lib_ms,
                   earlier_ms=EARLIER_MS["flash (1, 512, 16, 128)"])]
    # grok's prefills: one paged prompt and the dense batch of 8, with
    # softcap 30 (no SDPA backend takes a softcap)
    for gshape in ((1, 512, 48, 128), (8, 512, 48, 128)):
        q, k, v = qkv(gshape, torch.bfloat16)
        kw = dict(causal=True, softcap=30.0)
        shapes.append(dict(
            shape=list(gshape), softcap=30.0,
            ms=time_ms(lambda: ops.flash_attention(q, k, v, **kw)),
            plain_ms=time_ms(lambda: ref.flash_attention(q, k, v, **kw)),
            bound_ms=bound(*flash_bytes_flops(q, causal=True),
                           torch.bfloat16)[0], library_ms=None,
            earlier_ms=EARLIER_MS[f"flash {gshape} softcap 30"]))
    rec = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:93",
               max_abs_err=worst[torch.bfloat16], ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
               shapes=shapes)
    line = (f"flash_attention B=1 S=512 H=16 hd=128 causal: max abs err "
            f"bf16 {worst[torch.bfloat16]:.3g}, fp32 "
            f"{worst[torch.float32]:.3g}; S in {{77,200}} x causal/bidir/"
            f"window/softcap x hd in {{16,64,128,256}} x {{fp32,bf16}}, bf16 "
            f"S in {{63,64,65,129}} x causal/bidir/window 40/softcap x hd in "
            f"{{16,64,128,192,256}}, bf16 S=2100 causal and window 1000 and "
            f"(2, 300, 40, hd) causal/window 40/bidir softcap x the same hd, "
            f"and grok's H=48 with softcap 30 x {{fp32,bf16}} "
            f"within tolerance; kernel {ms:.4f} ms (earlier design "
            f"{shapes[0]['earlier_ms']} ms), plain {plain_ms:.4f} ms, SDPA "
            f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    lines = [line] + [
        f"flash_attention at grok's {tuple(r['shape'])} causal softcap 30 "
        f"bf16: kernel {r['ms']:.4f} ms (earlier design {r['earlier_ms']} "
        f"ms), plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, "
        f"no library call (SDPA takes no softcap)" for r in shapes[1:]]
    return rec, lines


def check_flash_local(ops, ref):
    """The flash kernel at recurrentgemma's local layers (hd 256, window
    2048 over a 2100-token prompt): checked against the plain version on
    the whole batch and timed.

    Outputs here average over ~2000 keys and are ~0.03, so the O(1)
    tolerance would hide a wrong window.  In fp32 the check is 1e-4 abs,
    a few percent of a typical output.  In bf16 both sides compute in
    fp32 and round the output once, so they may differ by one bf16 unit
    in the last place: |kernel - plain| <= 2**-7 |plain| + 1e-4."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    kw = dict(causal=True, window=2048)
    shape = (4, 2100, 10, 256)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = [torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
                   for _ in range(3)]
        o = ops.flash_attention(q, k, v, **kw).float()
        o_p = ref.flash_attention(q, k, v, **kw).float()
        err = (o - o_p).abs()
        errs[dtype] = float(err.max())
        limit = TOL[torch.float32] + (2.0 ** -7 * o_p.abs()
                                      if dtype == torch.bfloat16 else 0.0)
        if not within(err, limit):
            fail(f"flash hd 256 window 2048 {dtype}: max abs err "
                 f"{errs[dtype]} (typical |out| {float(o_p.abs().mean())})")
        del o, o_p, err
    ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
    nbytes, flops = flash_bytes_flops(q, causal=True, window=2048)
    b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
    # the library yardstick: SDPA with the band as an explicit mask
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    i = torch.arange(shape[1], device=DEVICE)
    band = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < 2048)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        lib_ms, lib_note = time_ms(lambda: sdpa(qt, kt, vt,
                                                attn_mask=band)), None
    except RuntimeError as e:      # no SDPA backend takes the shape
        lib_ms, lib_note = None, str(e).splitlines()[0]
    return dict(shape=list(shape), window=2048,
                max_abs_err=errs[torch.bfloat16],
                max_abs_err_fp32=errs[torch.float32], ms=ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms, library_note=lib_note,
                earlier_ms=EARLIER_MS["flash (4, 2100, 10, 256) window 2048"])


def rwkv6_inputs(B, S, H, K, dtype, gen, strong=False):
    """r, k, v in ``dtype``; log-decay lw = -exp(N(0,1) - 1), bonus u and
    a nonzero S0 in fp32 (the reference kernel test's distributions).
    ``strong``: lw = -exp(N(0,1) + 2), decays of e^-7 a step and far
    below, where a factorization of the intra-chunk decay with a positive
    exponent would overflow."""
    r, k, v = (torch.randn(B, S, H, K, generator=gen, device=DEVICE).to(dtype)
               for _ in range(3))
    lw = -torch.exp(torch.randn(B, S, H, K, generator=gen, device=DEVICE)
                    + (2.0 if strong else -1.0))
    u = 0.1 * torch.randn(H, K, generator=gen, device=DEVICE)
    S0 = torch.randn(B, H, K, K, generator=gen, device=DEVICE)
    return r, k, v, lw, u, S0


def rwkv6_bytes_flops(r, v):
    """Each input read once (r, k, v in their dtype; lw, u, S0 fp32), o and
    S_T written once in fp32.  Operations per token and head, a
    multiply-add counted as 2: r S (2 K V), the state update
    exp(lw) S + k v^T (3 K V), exp(lw) (K), and the bonus term
    (r . (u k)) v (3 K + 2 V)."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    e = r.element_size()
    nbytes = (2 * B * S * H * K * e + B * S * H * V * e + 4 * B * S * H * K
              + 4 * H * K + 2 * 4 * B * H * K * V + 4 * B * S * H * V)
    return nbytes, B * S * H * (5 * K * V + 4 * K + 2 * V)


TF32_FLOPS = 495e12          # H100 SXM dense TF32 tensor-core FLOP/s
SFU_EXP = 132 * 16 * 1.98e9  # exp2 a second: 16 a clock an SM at 1.98 GHz


def rwkv6_unit_bound(B, S, H, K, V, bf16=True):
    """The chunk kernel's own work at S > 1 over the rates of the units
    it uses (ms, and which bounds): per chunk of 32 and head, the
    tensor-core products as multiply-adds, q_int S (32 K V) and the
    off-diagonal block of A (16 x 16 x K) three times (3xTF32), A V
    (16 x 16 + 16 x 32 rows and columns, times V) and k_dec^T V (K 32 V)
    twice where v is bf16 (TF32-exact, not split) and three times in
    fp32, over the TF32 rate; and the exps, one an element of q_int,
    k_dec, the off-diagonal block's operands and the step decays (4 x
    32 K) and the chunk's decay (K), over the SFU's exp rate."""
    chunks = B * H * -(-S // 32)
    split_v = 2 if bf16 else 3
    macs = (3 * (32 * K * V + 16 * 16 * K)
            + split_v * ((16 * 16 + 16 * 32) * V + K * 32 * V))
    t_tc = chunks * 2 * macs / TF32_FLOPS
    t_sfu = chunks * (4 * 32 * K + K) / SFU_EXP
    return max(t_tc, t_sfu) * 1e3, ("TF32 tensor cores" if t_tc >= t_sfu
                                    else "SFU exps")


# tolerance of rwkv6_scan against its plain version, abs on o and S_T: the
# kernel computes the chunked log-space algorithm, the plain version steps
# the recurrence; both read the same r/k/v values and compute in fp32, so
# one tolerance holds for both dtypes.  It is the reference's own for its
# chunked kernel against the stepwise oracle (tests/test_kernels.py:85).
RWKV_TOL = 2e-3
# rglru_scan rounds each step as the plain version does (a product, then a
# sum), so the two agree bit for bit; 1e-5 is the reference's tolerance
# (tests/test_kernels.py:69).
RGLRU_TOL = 1e-5


def check_rwkv6(ops, ref):
    """Every S the served paths and the kernels' edges give (a decode
    step, the chunk kernel's ragged last chunk, one or two chunks), both
    dtypes, the reference's decays and the strong ones, within RWKV_TOL;
    then the times at S = 512 (a dense prefill) and S = 1."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    B, H, K = 8, 32, 64
    worst = {}
    for S in (512, 1, 77, 509, 2, 17):
        for dtype in (torch.bfloat16, torch.float32):
            for strong in (False, True):
                x = rwkv6_inputs(B, S, H, K, dtype, gen, strong)
                o, sT = ops.rwkv6_scan(*x)
                o_p, sT_p = ref.rwkv6_scan(*x)
                err = max(max_err(o, o_p), max_err(sT, sT_p))
                worst[(S, dtype, strong)] = err
                if not err <= RWKV_TOL:
                    fail(f"rwkv6_scan S={S} {dtype} strong decay {strong}: "
                         f"max abs err {err}")
    # narrow heads: rows of 16-byte pieces (K=V=40) and not (20 in bf16)
    for K_ in (40, 20):
        for S in (77, 1):
            for dtype in (torch.bfloat16, torch.float32):
                x = rwkv6_inputs(2, S, 3, K_, dtype, gen)
                o, sT = ops.rwkv6_scan(*x)
                o_p, sT_p = ref.rwkv6_scan(*x)
                err = max(max_err(o, o_p), max_err(sT, sT_p))
                if not err <= RWKV_TOL:
                    fail(f"rwkv6_scan K=V={K_} S={S} {dtype}: max abs err "
                         f"{err}")
    x = rwkv6_inputs(B, 512, H, K, torch.bfloat16, gen)
    ms = time_ms(lambda: ops.rwkv6_scan(*x))
    plain_ms = time_ms(lambda: ref.rwkv6_scan(*x), iters=5)
    nbytes, flops = rwkv6_bytes_flops(x[0], x[2])
    b_ms, b_by = bound(nbytes, flops, torch.float32)
    u_ms, u_by = rwkv6_unit_bound(B, 512, H, K, K)
    x1 = rwkv6_inputs(B, 1, H, K, torch.bfloat16, gen)   # a decode step
    ms1 = time_ms(lambda: ops.rwkv6_scan(*x1))
    plain1 = time_ms(lambda: ref.rwkv6_scan(*x1))
    b1_ms, b1_by = bound(*rwkv6_bytes_flops(x1[0], x1[2]), torch.float32)
    plans = {S: ops.rwkv6_plan(B, S, H, K, K)._asdict() for S in (512, 1)}
    rec = dict(name="rwkv6_scan", route="cuda",
               source="src/repro_torch/csrc/rwkv6_scan.cu",
               replaces="src/repro/kernels/rwkv6_scan.py:73",
               max_abs_err=worst[(512, torch.bfloat16, False)], ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None,
               shapes=[dict(S=512, plan=plans[512], ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, unit_bound_ms=u_ms,
                            unit_bound_by=u_by,
                            earlier_ms=EARLIER_MS["rwkv6_scan S=512"]),
                       dict(S=1, plan=plans[1], ms=ms1, plain_ms=plain1,
                            bound_ms=b1_ms, bound_by=b1_by,
                            earlier_ms=EARLIER_MS["rwkv6_scan S=1"])])
    errs = ", ".join(f"S={S} {str(d)[6:]}{' strong' if st else ''} {e:.3g}"
                     for (S, d, st), e in worst.items())
    line = (f"rwkv6_scan B={B} H={H} K=V={K}, nonzero S0, decays "
            f"-exp(N(0,1) - 1) and strong -exp(N(0,1) + 2): max abs err on o "
            f"and S_T [{errs}] (tol {RWKV_TOL}), K=V in {{40, 20}} at S in "
            f"{{77, 1}} x {{bf16, fp32}} within it; at S=512 bf16 "
            f"[{plans[512]['design']}] kernel "
            f"{ms:.4f} ms (earlier design {EARLIER_MS['rwkv6_scan S=512']} "
            f"ms), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"fp32 cores), the chunk kernel's units {u_ms:.4f} ms ({u_by}); "
            f"at S=1 (a decode step) [{plans[1]['design']}] kernel "
            f"{ms1:.4f} ms (earlier design {EARLIER_MS['rwkv6_scan S=1']} "
            f"ms), plain {plain1:.4f} ms, bound {b1_ms:.5f} ms ({b1_by})")
    return rec, [line]


def check_rglru(ops, ref):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 4)

    def inputs(B, S, W):
        a = torch.sigmoid(torch.randn(B, S, W, generator=gen,
                                      device=DEVICE)) * 0.2 + 0.79
        b = 0.1 * torch.randn(B, S, W, generator=gen, device=DEVICE)
        h0 = torch.randn(B, W, generator=gen, device=DEVICE)
        return a, b, h0

    worst = {}
    for shape in ((4, 2100, 2560), (3, 77, 1000), (2, 1, 2560)):
        x = inputs(*shape)
        hs, hT = ops.rglru_scan(*x)
        hs_p, hT_p = ref.rglru_scan(*x)
        err = max(max_err(hs, hs_p), max_err(hT, hT_p))
        worst[shape] = err
        if not err <= RGLRU_TOL:
            fail(f"rglru_scan {shape}: max abs err {err}")
    x = inputs(4, 2100, 2560)
    ms = time_ms(lambda: ops.rglru_scan(*x))
    plain_ms = time_ms(lambda: ref.rglru_scan(*x), iters=5)
    n = x[0].numel()
    nbytes = 4 * (2 * n + n + 2 * x[2].numel())
    b_ms, b_by = bound(nbytes, 2 * n, torch.float32)
    rec = dict(name="rglru_scan", route="cuda",
               source="src/repro_torch/csrc/rglru_scan.cu",
               replaces="src/repro/kernels/rglru_scan.py:47",
               max_abs_err=worst[(4, 2100, 2560)], ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None)
    errs = ", ".join(f"{s} {e:.3g}" for s, e in worst.items())
    line = (f"rglru_scan fp32 (B,S,W) in [{errs}] max abs err on hs and hT "
            f"(tol {RGLRU_TOL}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}) at (4, 2100, 2560)")
    return rec, [line]


# moe_gemm against its plain version, max |kernel - plain| over max |plain|
# (the reference's measure, tests/test_kernels.py:97-99).  Where the output
# is rounded to bf16 the bound is the reference's 3e-2, and for fp32 x fp32
# its 1e-5.  Where a bf16 operand meets an fp32 output (every GEMM of the
# MoE path) both sides sum exact products in fp32 and differ in summation
# order only; the tensor cores' accumulation (bf16 x bf16) drifts by up to
# 4.4e-5 of max |plain| at D = 32768 on an H100, so the bound is 1e-4.
# Every fp32-output case also holds a control, the plain version with its
# operands and output rounded to bf16: it must miss the bound, so that a
# kernel that rounds where the plain version does not would fail.
def moe_tol(xt, wt, ot):
    if ot == torch.bfloat16:
        return 3e-2
    return 1e-5 if xt == wt == torch.float32 else 1e-4


# grok-1's GEMMs at 4 layers: (name, E, C, D, F); D=6144, F=32768 is an
# up/gate projection, D=32768, F=6144 its down projection
MOE_SHAPES = [("dense prefill up", 4, 1280, 6144, 32768),
              ("dense prefill down", 4, 1280, 32768, 6144),
              ("paged prefill up", 8, 160, 6144, 32768),
              ("paged prefill down", 8, 160, 32768, 6144),
              ("decode up", 8, 8, 6144, 32768),
              ("decode down", 8, 8, 32768, 6144)]
# edge and operand-type cases, (E, C, D, F), x, w and out dtypes: ragged
# C, D and F (the fp32-core path when D or F is not a multiple of 8),
# fp32, and mixed both ways (the phase 4 decode GEMM is fp32 x bf16); then
# bf16 x bf16 at the edges of the tensor-core paths (ops.moe_plan): C
# ragged against the row tile on both sides of the stream/wgmma threshold
# (24, 72, 200), D and F multiples of 8 but not of 64 (TMA's zero fill),
# E = 1, a decode-shaped K split that is uneven (D not a multiple of split
# x 64), and the bf16 output of both paths
MOE_CASES = [((2, 70, 100, 90),) + (torch.bfloat16,) * 3,
             ((3, 77, 200, 300), torch.bfloat16, torch.bfloat16,
              torch.float32),
             ((3, 77, 200, 300),) + (torch.float32,) * 3,
             ((8, 8, 6144, 32768), torch.float32, torch.bfloat16,
              torch.float32),
             ((2, 40, 96, 136), torch.bfloat16, torch.float32,
              torch.float32)] + [
    (shape, torch.bfloat16, torch.bfloat16, ot) for shape, ot in (
        ((2, 24, 512, 264), torch.float32),
        ((2, 72, 256, 136), torch.float32),
        ((2, 200, 512, 264), torch.float32),
        ((2, 130, 264, 520), torch.float32),
        ((1, 8, 6144, 1032), torch.float32),
        ((8, 8, 4104, 1032), torch.float32),
        ((2, 200, 512, 264), torch.bfloat16),
        ((1, 8, 6144, 1032), torch.bfloat16))]


def moe_smem(build, regime, rows, cols):
    """Dynamic shared memory of a CTA of moe_gemm's ``regime`` kernel at
    that tile, from the library itself."""
    from repro_torch.kernels import ops
    fn = build.library("moe_gemm").moe_gemm_smem
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(ops.MOE_REGIMES[regime], rows, cols)


def rwkv6_smem(build, bf16):
    """Dynamic shared memory of a CTA of rwkv6_scan's chunk kernel for
    bf16 or fp32 r/k/v, from the library itself."""
    fn = build.library("rwkv6_scan").rwkv6_chunk_smem
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(int(bf16))


def check_moe_gemm(ops, ref):
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 7)
    bf, f32 = torch.bfloat16, torch.float32

    def inputs(E, C, D, F, xt, wt):
        return (torch.randn(E, C, D, generator=gen, device=DEVICE).to(xt),
                torch.randn(E, D, F, generator=gen, device=DEVICE).to(wt))

    def check(what, x, w, out_dtype):
        """(abs err, rel err, the control's rel err or None); fails past
        moe_tol, or where the control does not."""
        o = ops.moe_gemm(x, w, out_dtype=out_dtype)
        o_p = ref.moe_gemm(x, w, out_dtype)
        scale = float(o_p.float().abs().max())
        err = max_err(o, o_p)
        tol = moe_tol(x.dtype, w.dtype, out_dtype)
        if not err / scale <= tol:
            fail(f"moe_gemm {what}: rel err {err / scale} > {tol}")
        ctl = None
        if out_dtype == f32:
            low = (o_p.to(bf) if x.dtype == w.dtype == bf else
                   ref.moe_gemm(x.to(bf), w.to(bf), bf))
            ctl = max_err(low, o_p) / scale
            if not ctl > tol:
                fail(f"moe_gemm {what}: the bf16 control's rel err {ctl} is "
                     f"within {tol}, so the check cannot see a bf16 rounding")
        return err, err / scale, ctl

    def name(shape, xt, wt, ot):
        return f"{shape} {str(xt)[6:]}x{str(wt)[6:]}->{str(ot)[6:]}"

    sms = torch.cuda.get_device_properties(DEVICE).multi_processor_count

    def plan(E, C, D, F, xt, wt):
        p = ops.moe_plan(E, C, D, F, sms, xt == bf, wt == bf)
        return (f"{p.regime} {p.rows}x{p.cols}"
                + (f" split {p.split}" if p.regime == "stream" else ""))

    cases = {}
    for shape, xt, wt, ot in MOE_CASES:
        x, w = inputs(*shape, xt, wt)
        key = f"{name(shape, xt, wt, ot)} [{plan(*shape, xt, wt)}]"
        cases[key] = check(key, x, w, ot)
        del x, w
    shapes = []
    for what, E, C, D, F in MOE_SHAPES:
        x, w = inputs(E, C, D, F, bf, bf)
        err, rel, ctl = check(f"{what} bf16", x, w, f32)
        ms = time_ms(lambda: ops.moe_gemm(x, w, out_dtype=f32), iters=10)
        plain_ms = time_ms(lambda: ref.moe_gemm(x, w, f32), iters=5)
        lib_ms = time_ms(lambda: torch.bmm(x, w), iters=10)
        nbytes = 2 * (x.numel() + w.numel()) + 4 * E * C * F
        b_ms, b_by = bound(nbytes, 2 * E * C * D * F, bf)
        shapes.append(dict(name=what, shape=[E, C, D, F],
                           plan=plan(E, C, D, F, bf, bf),
                           earlier_ms=EARLIER_MS[f"moe_gemm {what}"],
                           max_abs_err=err,
                           max_rel_err=rel, control_rel_err=ctl, ms=ms,
                           plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=b_ms, bound_by=b_by))
        del x, w
        torch.cuda.empty_cache()
    main = shapes[4]              # decode up: the most launches
    rec = dict(name="moe_gemm", route="cuda",
               source="src/repro_torch/csrc/moe_gemm.cu",
               replaces="src/repro/kernels/moe_gemm.py:39",
               max_abs_err=main["max_abs_err"],
               max_rel_err=main["max_rel_err"], ms=main["ms"],
               plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
               bound_by=main["bound_by"], library_ms=main["library_ms"],
               shapes=shapes, cases=cases)
    lines = ["moe_gemm rel err (max |diff| / max |plain|; bound 3e-2 for bf16 "
             "output, 1e-5 fp32 x fp32, 1e-4 otherwise; [bf16 control]) "
             "edge/type cases "
             + ", ".join(f"{k} {r:.3g}" + (f" [{c:.3g}]" if c else "")
                         for k, (_, r, c) in cases.items())]
    lines += [f"moe_gemm {r['name']} {tuple(r['shape'])} bf16 -> fp32 "
              f"[{r['plan']}]: rel "
              f"err {r['max_rel_err']:.3g} (abs {r['max_abs_err']:.3g}, bf16 "
              f"control {r['control_rel_err']:.3g}); kernel {r['ms']:.4f} ms "
              f"(earlier design {r['earlier_ms']} ms), plain "
              f"{r['plain_ms']:.4f} ms, bmm {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
              for r in shapes]
    return rec, lines


def check_decode(ops, ref):
    """decode_attention at grok's dense decode (B=8, H=48, Kv=8, hd 128,
    T=576).  Both sides compute in fp32 from the same inputs: within 2e-5
    (the reference's fp32 tolerance, tests/test_kernels.py:56), and in
    bf16 within that plus the one output rounding in which they may part,
    2**-7 |plain|."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 8)
    B, H, Kv, hd, T = 8, 48, 8, 128, 576
    tol = 2e-5

    def inputs(dtype, shape=(B, H, Kv, hd, T)):
        b, h, kv, d, t = shape
        return tuple(torch.randn(sh, generator=gen, device=DEVICE).to(dtype)
                     for sh in ((b, h, d), (b, t, kv, d), (b, t, kv, d)))

    worst = {}
    cases = [((B, H, Kv, hd, T), pos, cap) for pos in (0, 300, 575)
             for cap in (30.0, None)]
    cases += [((3, 2 * G, 2, d, 77), 60, None) for G in (1, 4, 6, 8, 12, 16)
              for d in (16, 64, 256)]
    for shape, pos, cap in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = inputs(dtype, shape)
            o = ops.decode_attention(q, k, v, pos, softcap=cap).float()
            o_p = ref.decode_attention(q, k, v, pos, softcap=cap).float()
            err = (o - o_p).abs()
            limit = tol + (2.0 ** -7 * o_p.abs()
                           if dtype == torch.bfloat16 else 0.0)
            if not within(err, limit):
                fail(f"decode_attention {shape} pos {pos} softcap {cap} "
                     f"{dtype}: max abs err {float(err.max())}")
            if shape[0] == B:
                worst[(pos, cap, dtype)] = float(err.max())
    q, k, v = inputs(torch.bfloat16)
    pos = T - 1
    ms = time_ms(lambda: ops.decode_attention(q, k, v, pos, softcap=30.0))
    plain_ms = time_ms(lambda: ref.decode_attention(q, k, v, pos,
                                                    softcap=30.0))
    qt = q[:, :, None]
    kt, vt = (t[:, :pos + 1].transpose(1, 2) for t in (k, v))
    lib_ms = time_ms(lambda: sdpa(qt, kt, vt, enable_gqa=True))
    e = q.element_size()
    nbytes = 2 * q.numel() * e + 2 * B * (pos + 1) * Kv * hd * e
    b_ms, b_by = bound(nbytes, 4 * B * H * (pos + 1) * hd, torch.bfloat16)
    # longer caches, beside SDPA: grok's batch at pos 4095, and one
    # sequence of qwen3's heads at pos 32767 (8 kv heads, so 8 clusters)
    shapes = []
    for b_, h_, t_, cap_ in ((8, 48, 4096, 30.0), (1, 16, 32768, None)):
        q2, k2, v2 = inputs(torch.bfloat16, (b_, h_, Kv, hd, t_))
        p_ = t_ - 1
        qt2 = q2[:, :, None]
        kt2, vt2 = (t[:, :p_ + 1].transpose(1, 2) for t in (k2, v2))
        nb = 2 * q2.numel() * e + 2 * b_ * (p_ + 1) * Kv * hd * e
        shapes.append(dict(
            shape=f"B={b_} H={h_} Kv={Kv} hd={hd} pos {p_}"
                  + (" softcap 30" if cap_ else ""),
            ms=time_ms(lambda: ops.decode_attention(q2, k2, v2, p_,
                                                    softcap=cap_)),
            library_ms=time_ms(lambda: sdpa(qt2, kt2, vt2,
                                            enable_gqa=True)),
            bound_ms=bound(nb, 4 * b_ * h_ * (p_ + 1) * hd,
                           torch.bfloat16)[0]))
        del q2, k2, v2, kt2, vt2
    rec = dict(name="decode_attention", route="cuda",
               source="src/repro_torch/csrc/decode_attention.cu",
               replaces="src/repro/kernels/decode_attention.py:75",
               max_abs_err=worst[(575, 30.0, torch.bfloat16)], ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib_ms, shapes=shapes)
    errs = ", ".join(f"pos {p} cap {c} {str(d)[6:]} {x:.3g}"
                     for (p, c, d), x in worst.items())
    line = (f"decode_attention B={B} H={H} Kv={Kv} hd={hd} T={T}: max abs "
            f"err [{errs}] (tol fp32 {tol}, bf16 {tol} + 2**-7 |plain|); "
            f"G in {{1,4,6,8,12,16}} x hd in {{16,64,256}} at T=77 within "
            f"tolerance; kernel {ms:.4f} ms (earlier design "
            f"{EARLIER_MS['decode_attention B=8 H=48 pos 575 softcap 30']} "
            f"ms), plain {plain_ms:.4f} ms, SDPA (enable_gqa, slots 0..pos) "
            f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) at pos 575, "
            f"softcap 30, bf16")
    lines = [line] + [f"decode_attention at {r['shape']} bf16: kernel "
                      f"{r['ms']:.4f} ms, SDPA {r['library_ms']:.4f} ms, "
                      f"bound {r['bound_ms']:.4f} ms" for r in shapes]
    return rec, lines


# rmsnorm rows on the served paths: (rows, D) — decode rows of d_model
# (grok 6144, qwen3 2048, recurrentgemma 2560), qwen3's q-norm rows of one
# decode step (8 x 16 heads of 128), and grok's dense prefill (8 x 512)
RMS_SHAPES = [(8, 6144), (8, 2048), (4, 2560), (128, 128), (4096, 6144)]
# qwen3's q and k rows of one layer (16 and 8 heads of 128): a decode step
# of 8 sequences and a 512-token prefill
QK_SHAPES = [((8, 1, 16, 128), (8, 1, 8, 128)),
             ((1, 512, 16, 128), (1, 512, 8, 128))]


def check_rmsnorm(ops, ref):
    """Both sides compute in fp32 and round once: fp32 within 2e-5 (the
    reference's), bf16 within 2e-5 + one bf16 rounding, 2**-7 |plain|.
    The fused entry points against the unfused kernel path, bit for bit:
    ``add_rmsnorm(x, d)`` against ``x + d`` then ``rmsnorm`` at every
    shape and dtype, ``qk_rmsnorm`` against two ``rmsnorm`` launches at
    qwen3's q and k shapes.  Times beside a launch floor: one PyTorch
    elementwise kernel on one element through the same ``time_ms``."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    worst, exact = {}, []
    for N, D in RMS_SHAPES + [(3, 64), (5, 16), (2, 8192)]:
        scale = torch.randn(D, generator=gen, device=DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(N, D, generator=gen, device=DEVICE).to(dtype)
            d = torch.randn(N, D, generator=gen, device=DEVICE).to(dtype)
            o = ops.rmsnorm(x, scale).float()
            o_p = ref.rmsnorm(x, scale).float()
            err = (o - o_p).abs()
            limit = 2e-5 + (2.0 ** -7 * o_p.abs()
                            if dtype == torch.bfloat16 else 0.0)
            if not within(err, limit):
                fail(f"rmsnorm ({N}, {D}) {dtype}: max abs err "
                     f"{float(err.max())}")
            worst[(N, D, dtype)] = float(err.max())
            s_k, o_k = ops.add_rmsnorm(x, d, scale)
            s_u = x + d
            if not (torch.equal(s_k, s_u)
                    and torch.equal(o_k, ops.rmsnorm(s_u, scale))):
                fail(f"add_rmsnorm ({N}, {D}) {dtype}: not the bits of x + d "
                     f"followed by rmsnorm")
            exact.append(f"({N},{D}) {str(dtype)[6:]}")
    for qs, ks in QK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(qs, generator=gen, device=DEVICE).to(dtype)
            k = torch.randn(ks, generator=gen, device=DEVICE).to(dtype)
            sq, sk = (torch.randn(qs[-1], generator=gen, device=DEVICE)
                      for _ in range(2))
            qo, ko = ops.qk_rmsnorm(q, k, sq, sk)
            if not (torch.equal(qo, ops.rmsnorm(q, sq))
                    and torch.equal(ko, ops.rmsnorm(k, sk))):
                fail(f"qk_rmsnorm {qs} {ks} {dtype}: not the bits of two "
                     f"rmsnorm launches")
    one = torch.zeros(1, device=DEVICE)
    floor_ms = time_ms(lambda: one.add_(1.0))
    times = []
    for N, D in RMS_SHAPES:
        scale = torch.randn(D, generator=gen, device=DEVICE)
        x = torch.randn(N, D, generator=gen, device=DEVICE).to(torch.bfloat16)
        d = torch.randn(N, D, generator=gen, device=DEVICE).to(torch.bfloat16)
        w = scale.to(x.dtype)
        b_ms, b_by = bound(2 * 2 * N * D + 4 * D, 3 * N * D, torch.bfloat16)
        times.append(dict(
            shape=[N, D], ms=time_ms(lambda: ops.rmsnorm(x, scale)),
            plain_ms=time_ms(lambda: ref.rmsnorm(x, scale)),
            library_ms=time_ms(lambda: F.rms_norm(x, (D,), w, 1e-6)),
            bound_ms=b_ms, bound_by=b_by, floor_ms=floor_ms,
            earlier_ms=EARLIER_MS[f"rmsnorm {(N, D)}"],
            add_ms=time_ms(lambda: ops.add_rmsnorm(x, d, scale)),
            add_plain_ms=time_ms(lambda: ref.add_rmsnorm(x, d, scale)),
            add_bound_ms=bound(4 * 2 * N * D + 4 * D, 4 * N * D,
                               torch.bfloat16)[0]))
    q, k = (torch.randn(sh, generator=gen, device=DEVICE).to(torch.bfloat16)
            for sh in QK_SHAPES[0])
    sq, sk = (torch.randn(128, generator=gen, device=DEVICE) for _ in range(2))
    qk_ms = time_ms(lambda: ops.qk_rmsnorm(q, k, sq, sk))
    main = times[0]               # a grok decode step's norm
    rec = dict(name="rmsnorm", route="cuda",
               source="src/repro_torch/csrc/rmsnorm.cu",
               replaces="src/repro/kernels/rmsnorm.py:27",
               max_abs_err=worst[(8, 6144, torch.bfloat16)], ms=main["ms"],
               plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
               bound_by=main["bound_by"], library_ms=main["library_ms"],
               shapes=times, launch_floor_ms=floor_ms,
               qk_decode_ms=qk_ms)
    errs = ", ".join(f"({n},{d}) {str(t)[6:]} {e:.3g}"
                     for (n, d, t), e in worst.items())
    lines = [f"rmsnorm max abs err [{errs}] (tol fp32 2e-5, bf16 2e-5 + "
             f"2**-7 |plain|); add_rmsnorm bit-identical to x + d then "
             f"rmsnorm at [{', '.join(exact)}]; qk_rmsnorm bit-identical to "
             f"two rmsnorm launches at {QK_SHAPES} x {{fp32,bf16}}; launch "
             f"floor (one elementwise kernel on one element) "
             f"{floor_ms:.4f} ms"]
    lines += [f"rmsnorm {tuple(t['shape'])} bf16: kernel {t['ms']:.4f} ms "
              f"(earlier design {t['earlier_ms']} ms; launch floor "
              f"{floor_ms:.4f}), plain {t['plain_ms']:.4f} ms, F.rms_norm "
              f"{t['library_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}); add_rmsnorm {t['add_ms']:.4f} ms, plain "
              f"{t['add_plain_ms']:.4f} ms, bound {t['add_bound_ms']:.5f} ms"
              for t in times]
    lines.append(f"qk_rmsnorm at qwen3's decode q {QK_SHAPES[0][0]} and k "
                 f"{QK_SHAPES[0][1]} bf16: {qk_ms:.4f} ms (one launch for "
                 f"two norms)")
    return rec, lines


# ---------------------------------------------------------------------------
# phase 3 — serve at full width through the kernels
# ---------------------------------------------------------------------------
# the phase 3 traffic: the paged engine's, and the dense engine's per config
PAGED_RUN = dict(requests=16, prompt_len=512, gen=64, batch=8, page_size=16,
                 window=8)
DENSE_RUNS = {
    "rwkv6-1.6b": dict(requests=16, batch=8, prompt_len=512, gen=64),
    "recurrentgemma-2b": dict(requests=8, batch=4, prompt_len=2100, gen=32),
    "grok-1-314b": dict(requests=16, batch=8, prompt_len=512, gen=64),
}
GROK_DEPTH = 4     # 4 x 9.84 GB of layers + 3.2 GB of embedding and head


def expected_launches(cfg, prefills, steps, prefill_tokens, decode_tokens,
                      paged):
    """Each kernel's launches in ``prefills`` prefills of
    ``prefill_tokens`` tokens each and ``steps`` decode steps over
    ``decode_tokens`` sequences under impl=pallas: flash in every
    attention prefill, paged or dense decode attention in every global
    layer's decode step (local layers decode plain, as in the reference),
    the scans where their layers run, three (gated) or two grouped GEMMs
    per expert group of every MoE layer, and every norm of every pass: the
    norms after a residual add (every ln2, every ln1 but the first, the
    final norm) fused with it in ``add_rmsnorm``, a layer's q and k norms
    in one ``qk_rmsnorm``, the rest (the first ln1, post-norms)
    ``rmsnorm``."""
    from repro_torch.models import moe
    kinds = cfg.layer_kinds
    n_glob, n_attn = kinds.count("attn"), kinds.count("attn") + kinds.count(
        "local")
    passes = prefills + steps
    gemms = 0
    if cfg.moe is not None:
        def groups(T):
            return moe._group_count(cfg.moe.n_experts, moe.capacity(cfg, T),
                                    cfg.d_model)
        gemms = ((3 if cfg.gated_ffn else 2) * (len(kinds) - cfg.first_k_dense)
                 * (groups(prefill_tokens) * prefills
                    + groups(decode_tokens) * steps))
    return {"flash_attention": n_attn * prefills,
            "paged_decode_attention": n_glob * steps if paged else 0,
            "rwkv6_scan": kinds.count("rwkv6") * passes,
            "rglru_scan": kinds.count("rglru") * prefills,
            "moe_gemm": gemms,
            "decode_attention": 0 if paged else n_glob * steps,
            "rmsnorm": (1 + 2 * cfg.post_norm * len(kinds)) * passes,
            "add_rmsnorm": 2 * len(kinds) * passes,
            "qk_rmsnorm": cfg.qk_norm * n_attn * passes}


def _launches(ops):
    return {fn.__name__: fn.launches for fn in ops.WRAPPERS}


def _peak_gb():
    return torch.cuda.max_memory_allocated() / 1e9


def serve_paged(ops, cfg, params):
    """The paged engine at ``cfg``'s widths with PAGED_RUN's traffic,
    warm.  Checks every request's tokens, the finite logits of one more
    decode step, and each kernel's launches; profiles one fused window."""
    from repro_torch.launch.serve import make_prompts
    from repro_torch.serving.engine import PagedEngine

    run = PAGED_RUN
    n_req, plen, gen_len, batch, ps = (run[k] for k in (
        "requests", "prompt_len", "gen", "batch", "page_size"))
    n_params = sum(t.numel() for t in _leaves(params))
    max_len = plen + gen_len
    eng = PagedEngine(cfg, params, max_batch=batch, page_size=ps,
                      n_pages=batch * (-(-max_len // ps)) + 1,
                      max_len=max_len, fused=True, max_window=run["window"],
                      device=DEVICE)
    eng.warmup_windows()
    prompts = make_prompts(n_req, plen, cfg.vocab_size, SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                     # counts of the main path only
    t0 = time.time()
    for i, p in enumerate(prompts):
        eng.submit(p, gen_len, rid=f"req{i}")
    fin = eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = _launches(ops)
    peak_gb = _peak_gb()
    m = eng.metrics()
    if len(fin) != n_req or any(len(r.tokens) != gen_len for r in fin):
        fail(f"{cfg.name}: not every request finished with its tokens")
    if any(not (0 <= t < cfg.vocab_size) for r in fin for t in r.tokens):
        fail(f"{cfg.name}: token ids out of range (NaN logits?)")
    decode_steps = eng.decode_steps
    prefills = m["model_passes"] - decode_steps
    want = expected_launches(cfg, prefills, decode_steps, plen, batch, True)
    if launches != want:
        fail(f"{cfg.name} paged: launches {launches} != expected {want} for "
             f"{prefills} prefills and {decode_steps} decode steps")
    # a finite logit check on one decode step of the served pools
    logits, _ = _one_step_logits(eng)
    if not torch.isfinite(logits).all():
        fail(f"{cfg.name}: non-finite logits after serving")
    prefill_ms = _mean_prefill_ms(eng, prompts[0])
    prof = _profile_window(eng, prompts)
    L = cfg.n_layers
    stats = dict(arch=cfg.name, n_layers=L, d_model=cfg.d_model,
                 n_params=n_params, requests=n_req, prompt_len=plen,
                 gen=gen_len, max_batch=batch, page_size=ps,
                 wall_s=wall, tok_per_s=m["tokens_out"] / wall,
                 decode_step_ms=m["decode_step_s"] * 1e3,
                 prefill_ms=prefill_ms, prefills=prefills,
                 decode_steps=decode_steps, windows=m["windows"],
                 preemptions=m["preemptions"], h2d_syncs=m["h2d_syncs"],
                 d2h_syncs=m["d2h_syncs"], launches=launches,
                 peak_gb=peak_gb, profile=prof)
    line = (f"serve {cfg.name} paged ({L} layers, d_model {cfg.d_model}, "
            f"{n_params / 1e9:.3f} B params, bf16 activations, impl=pallas): "
            f"{n_req} requests x {gen_len} tokens in {wall:.2f} s, "
            f"{stats['tok_per_s']:.1f} tok/s, decode step "
            f"{stats['decode_step_ms']:.3f} ms, prefill {prefill_ms:.3f} ms; "
            f"{prefills} prefills, {decode_steps} decode steps, "
            f"{m['windows']} windows; peak memory {peak_gb:.2f} GB; launches "
            f"{launches}; profiled "
            f"{prof['steps']}-step window: {prof['wall_ms']:.3f} ms wall, "
            f"device busy {prof['busy_share']:.3f}, "
            f"{prof['launches_per_step']:.0f} device launches per step, "
            f"top {prof['top']}")
    del eng
    torch.cuda.empty_cache()
    return stats, launches, line


def serve_dense(ops, cfg, params):
    """``run_dense`` at ``cfg``'s widths with its DENSE_RUNS traffic, bf16
    activations, impl=pallas.  Checks every request's tokens, the finite
    logits of a profiled prefill and decode step, and each kernel's
    launches (the warmup prefill and decode step included)."""
    from repro_torch.launch.serve import build_parser, run_dense

    arch = cfg.name
    run = DENSE_RUNS[arch]
    args = build_parser().parse_args(
        [f"--{k.replace('_', '-')}={v}" for k, v in run.items()]
        + [f"--seed={SEED}"])
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                     # counts of this path only
    out, st = run_dense(args, cfg, params=params, device=DEVICE)
    torch.cuda.synchronize()
    launches = _launches(ops)
    peak_gb = _peak_gb()
    if sorted(out) != list(range(args.requests)) or any(
            len(t) != args.gen for t in out.values()):
        fail(f"{arch}: not every request got its {args.gen} tokens")
    if any(not (0 <= t < cfg.vocab_size) for ts in out.values() for t in ts):
        fail(f"{arch}: token ids out of range (NaN logits?)")
    # +1 each: the warmup prefill and decode step before the clock
    prefills, steps = st["prefills"] + 1, st["decode_steps"] + 1
    want = expected_launches(cfg, prefills, steps,
                             args.batch * args.prompt_len, args.batch, False)
    if launches != want:
        fail(f"{arch}: launches {launches} != expected {want} for "
             f"{prefills} prefills and {steps} decode steps")
    # argmax of NaN logits is still an in-range id: check the logits of a
    # prefill and of the fourth decode step after it at the same depth
    prof, logits = _profile_dense(cfg, params, args)
    if not all(bool(torch.isfinite(l).all()) for l in logits):
        fail(f"{arch}: non-finite logits from the dense engine")
    stats = dict(arch=arch, n_layers=cfg.n_layers, d_model=cfg.d_model,
                 n_params=n_params, **run, wall_s=st["seconds"],
                 tok_per_s=st["tokens"] / st["seconds"],
                 decode_step_ms=st["step_s"] * 1e3,
                 prefill_ms=st["prefill_s"] * 1e3, prefills=prefills,
                 decode_steps=steps, launches=launches, peak_gb=peak_gb,
                 profile=prof)
    line = (f"serve {arch} dense ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {n_params / 1e9:.3f} B params, bf16 "
            f"activations, impl=pallas): {args.requests} requests x "
            f"{args.gen} tokens, batch {args.batch}, prompt "
            f"{args.prompt_len}, in {st['seconds']:.2f} s, "
            f"{stats['tok_per_s']:.1f} tok/s, decode step "
            f"{stats['decode_step_ms']:.3f} ms, prefill (batch of "
            f"{args.batch}) {stats['prefill_ms']:.3f} ms; peak memory "
            f"{peak_gb:.2f} GB; launches "
            f"{launches} (incl. warmup); profiled decode step "
            f"{prof['decode']['wall_ms'] / prof['decode']['steps']:.3f} ms "
            f"wall, device busy "
            f"{prof['decode']['busy_share']:.3f}, "
            f"{prof['decode']['launches_per_step']:.0f} launches, top "
            f"{prof['decode']['top']}; profiled prefill "
            f"{prof['prefill']['wall_ms']:.3f} ms wall, device busy "
            f"{prof['prefill']['busy_share']:.3f}, top "
            f"{prof['prefill']['top']}")
    torch.cuda.empty_cache()
    return stats, launches, line


def full_width_params(arch, depth=None):
    """(cfg with impl=pallas, random parameters from SEED) at the config's
    published widths; ``depth`` cuts the layers."""
    from repro_torch.configs import get_config
    from repro_torch.weights import init_params
    cfg = get_config(arch).replace(impl="pallas")
    if depth is not None:
        cfg = cfg.replace(n_layers=depth)
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    return cfg, init_params(cfg, g, DEVICE)


def _profile(fn):
    """Run ``fn`` under torch.profiler; ``fn`` returns the number of
    model steps it ran.  Returns the wall time, the device busy share
    (kernel time over wall time), device launches per step and the
    kernels that take most of the device time (ms per step)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        k = max(fn(), 1)
        torch.cuda.synchronize()
        wall = time.time() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = {e.key: e.self_device_time_total for e in kernels}
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:4]
    return dict(steps=k, wall_ms=wall * 1e3,
                busy_share=sum(dev_us.values()) / 1e6 / wall,
                launches_per_step=sum(e.count for e in kernels) / k,
                top=[(name[:48], round(us / 1e3 / k, 4)) for name, us in top])


def _profile_dense(cfg, params, args):
    """One batched prefill of the first batch's prompts and four decode
    steps of the dense engine, each profiled on its own.  Returns the
    profiles and the logits of the prefill and of the last step."""
    from repro_torch import steps
    from repro_torch.launch.serve import make_prompts
    prefill = steps.make_prefill_step(cfg, args.prompt_len + args.gen)
    serve = steps.make_serve_step(cfg)
    prompts = make_prompts(args.batch, args.prompt_len, cfg.vocab_size, SEED)
    tok = torch.tensor(np.stack(prompts), device=DEVICE)
    state = {}

    def run_prefill():
        state["prefill"], state["caches"] = prefill(params, tok)
        return 1

    def run_decode(n=4):
        t = state["prefill"].argmax(-1).to(torch.int32)
        for i in range(n):
            t, state["decode"], state["caches"] = serve(
                params, t, state["caches"], args.prompt_len + i)
        return n

    prof = dict(prefill=_profile(run_prefill), decode=_profile(run_decode))
    return prof, (state["prefill"], state["decode"])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _one_step_logits(eng):
    from repro_torch.models import lm
    return lm.decode_step_paged(eng.params, eng.cfg, eng.d_tokens, eng.pools,
                                eng.d_block, eng.d_pos)


def _profile_window(eng, prompts):
    """One fused window with every slot decoding, under torch.profiler."""
    for i, p in enumerate(prompts[:eng.max_batch]):
        eng.submit(p, PAGED_RUN["gen"], rid=f"prof{i}")
    while eng.sched.waiting:         # the prefills and first windows
        eng.step()
    steps0 = eng.decode_steps

    def one_window():
        eng.step()                   # one pure decode window
        return eng.decode_steps - steps0

    return _profile(one_window)


def _mean_prefill_ms(eng, prompt, n=5):
    """Device-synchronized host time of one full-width prompt prefill
    through the engine's prefill step (null block row: writes masked)."""
    from repro_torch import steps
    from repro_torch.serving.paged_kv import NULL_PAGE
    prefill = steps.make_paged_prefill_step(eng.cfg)
    tok = torch.tensor(prompt[None], device=DEVICE)
    row = torch.full((eng.nmax,), NULL_PAGE, dtype=torch.int32,
                     device=DEVICE)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.time()
        prefill(eng.params, tok, eng.pools, row)
        torch.cuda.synchronize()
        times.append(time.time() - t0)
    return float(np.mean(times[1:])) * 1e3


# ---------------------------------------------------------------------------
# phase 4 — engine parity against the port's dense path (plain attention)
# ---------------------------------------------------------------------------
def engine_parity():
    from repro_torch import steps
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.serving.engine import PagedEngine
    from repro_torch.serving.paged_kv import NULL_PAGE
    from repro_torch.weights import init_params

    depth, full = 4, get_config("qwen3-1.7b")
    cfg = full.replace(n_layers=depth,
                                           activation_dtype="float32",
                                           impl="pallas")
    ref_cfg = cfg.replace(impl="ref")
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    params = init_params(cfg, g, DEVICE)
    n_req, plen, gen_len, ps = 4, 512, 16, 16
    prompts = make_prompts(n_req, plen, cfg.vocab_size, SEED + 2)
    max_len = plen + gen_len
    eng = PagedEngine(cfg, params, max_batch=n_req, page_size=ps,
                      n_pages=n_req * (-(-max_len // ps)) + 1,
                      max_len=max_len, fused=True, max_window=8,
                      device=DEVICE)
    # first-token logits: the engine's prefill step (flash kernel) against
    # the dense prefill with the plain attention
    pre_k = steps.make_paged_prefill_step(cfg)
    pre_r = steps.make_prefill_step(ref_cfg, max_len=max_len)
    serve_r = steps.make_serve_step(ref_cfg)
    row = torch.full((eng.nmax,), NULL_PAGE, dtype=torch.int32,
                     device=DEVICE)
    logit_err = 0.0
    oracle, margins = {}, {}
    for i, p in enumerate(prompts):
        tok = torch.tensor(p[None], device=DEVICE)
        lk, _ = pre_k(params, tok, eng.pools, row)
        lr, caches = pre_r(params, tok)
        logit_err = max(logit_err, max_err(lk, lr))
        toks, mg = [], []
        logits = lr
        for j in range(gen_len):
            top2 = logits[0, 0].topk(2).values
            mg.append(float(top2[0] - top2[1]))
            nxt = logits.argmax(-1).to(torch.int32)
            toks.append(int(nxt[0, 0]))
            if j < gen_len - 1:
                nxt, logits, caches = serve_r(params, nxt, caches, plen + j)
        oracle[f"r{i}"], margins[f"r{i}"] = toks, mg
    if not logit_err <= 1e-3:
        fail(f"first-token logits differ by {logit_err} > 1e-3")
    for p in prompts:
        eng.submit(p, gen_len)
    fin = eng.run()
    ties = []
    for r in fin:
        want = oracle[r.rid]
        for j, (a, b) in enumerate(zip(r.tokens, want)):
            if a != b:
                ties.append((r.rid, j, margins[r.rid][j]))
                if not margins[r.rid][j] < 1e-4:
                    fail(f"{r.rid} step {j}: engine token {a} != oracle {b} "
                         f"with top-2 margin {margins[r.rid][j]}")
                break
    line = (f"parity {full.name} full width, depth cut {full.n_layers} -> {depth} "
            f"layers, "
            f"fp32: engine (kernels) vs dense path (impl=ref) on {n_req} "
            f"prompts x {gen_len} tokens: first-token logits max abs err "
            f"{logit_err:.3g} (atol 1e-3); greedy tokens "
            + ("identical" if not ties else f"differ only at near-ties {ties}"))
    del eng, params
    torch.cuda.empty_cache()
    return dict(depth=depth, logit_err=logit_err, near_ties=ties), line


# full width with the depth cut, fp32: each family's kernel path
# (impl=pallas) against the port's plain path (impl=ref).  First-token
# logits: the scans differ only in summation order (rwkv6: chunked vs
# stepwise) or not at all (rglru), flash vs the full-scores attention and
# the grouped GEMM vs fp32 einsum in the order of 1e-6 relative; the tied
# 256000-row head of recurrentgemma gives logits of magnitude ~100, so its
# tolerance is scaled up.  Greedy tokens must match, except at a near-tie:
# a step where the plain path's top-2 margin is below twice the tolerance,
# or (MoE) a row that routed a token within ROUTER_TIE of a flip at that
# step or before it, where a rounding difference can send the token to
# another expert; a near-tie in a row's prefill likewise exempts that
# row's first-token logits.  grok's parity runs on the bf16 weights served
# in phase 3, under fp32 activations.
DENSE_PARITY = {
    "rwkv6-1.6b": dict(depth=4, batch=4, prompt_len=512, gen=16, tol=1e-3),
    "recurrentgemma-2b": dict(depth=6, batch=2, prompt_len=2100, gen=16,
                              tol=1e-2),
    "grok-1-314b": dict(depth=GROK_DEPTH, batch=2, prompt_len=64, gen=16,
                        tol=1e-3),
}
ROUTER_TIE = 1e-5


def _row_gaps(cfg, log, rows):
    """Per row of one model call, the smallest router gap
    (``moe.router_gap``) over the call's MoE layers, from the ``log`` of
    ``moe.record_router_gaps`` (each layer routes the rows' tokens in
    order).  A layer whose capacity is below its token count can drop
    tokens, and which token keeps a slot depends on the other rows'
    routing: every row of such a layer gets the layer's minimum.  inf for
    every row without MoE.  Fails unless every MoE layer recorded its gaps,
    and on a NaN gap (a NaN hidden state)."""
    from repro_torch.models import moe
    out = torch.full((rows,), float("inf"))
    if cfg.moe is None:
        return out.tolist()
    n_moe = len(cfg.layer_kinds) - cfg.first_k_dense
    if len(log) != n_moe:
        fail(f"{cfg.name}: {len(log)} routing calls recorded, not {n_moe}")
    for g in log:
        g = g.float().cpu()
        if bool(torch.isnan(g).any()):
            fail(f"{cfg.name}: a router gap is NaN (a NaN hidden state)")
        per_row = g.reshape(rows, -1).min(1).values
        if moe.capacity(cfg, g.numel()) < g.numel():
            per_row = per_row.min().expand(rows)
        out = torch.minimum(out, per_row)
    return out.tolist()


def _greedy(cfg, params, tok0, plen, gen_len):
    """The dense path of ``cfg``: greedy tokens (gen_len lists of B ids),
    the top-2 logit margin at each step, the router gaps of the call that
    made each step's logits (gen_len lists of B, ``_row_gaps``; the
    prefill's at step 0) and the first-token logits."""
    from repro_torch import steps
    from repro_torch.models import moe
    B = tok0.shape[0]
    prefill = steps.make_prefill_step(cfg, plen + gen_len)
    serve = steps.make_serve_step(cfg)
    with moe.record_router_gaps() as log:
        logits, caches = prefill(params, tok0)
    first, gaps = logits, [_row_gaps(cfg, log, B)]
    toks, mg = [], []
    for j in range(gen_len):
        top2 = logits[:, 0].topk(2).values
        mg.append((top2[:, 0] - top2[:, 1]).tolist())
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok[:, 0].tolist())
        if j < gen_len - 1:
            with moe.record_router_gaps() as log:
                tok, logits, caches = serve(params, tok, caches, plen + j)
            gaps.append(_row_gaps(cfg, log, B))
    return toks, mg, gaps, first


def _first_logits(first, prefill_gaps, tol, what):
    """Each row's first-token logits, kernel path against plain path,
    within ``tol``.  A row is exempt only where its prefill routed a token
    within ROUTER_TIE of a flip, and never on a non-finite logit.  Returns
    the largest error and the exempt rows."""
    errs, exempt = [], []
    for b, gap in enumerate(prefill_gaps):
        err = max_err(first["pallas"][b], first["ref"][b])
        errs.append(err)
        if not err <= tol:
            if err == float("inf") or not gap < ROUTER_TIE:
                fail(f"{what} row {b}: first-token logits differ by {err} > "
                     f"{tol} (smallest router gap of its prefill {gap})")
            exempt.append(b)
    return max(errs), exempt


def _token_flips(seqs, margins, tol, gaps, what):
    """(row, step, margin, router gap) of each row's first differing
    token.  Fails unless the plain path's top-2 logit margin at that step
    is below 2 tol, or the row routed a token within ROUTER_TIE of a flip
    at that step or before it (``gaps``: per step and row, the smaller of
    both paths' gaps).  An earlier near-tie changes what the row caches,
    so it can flip a later token of that row; another row's cannot."""
    flips = []
    for b in range(len(seqs["pallas"][0])):
        for j in range(len(seqs["pallas"])):
            if seqs["pallas"][j][b] != seqs["ref"][j][b]:
                m = margins[j][b]
                gap = min(g[b] for g in gaps[:j + 1])
                flips.append((b, j, m, gap))
                if not (m < 2 * tol or gap < ROUTER_TIE):
                    fail(f"{what} row {b} step {j}: kernel-path token "
                         f"{seqs['pallas'][j][b]} != plain "
                         f"{seqs['ref'][j][b]} with top-2 margin {m} and "
                         f"smallest router gap {gap}")
                break
    return flips


def dense_parity(arch, params=None):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.weights import init_params

    run = DENSE_PARITY[arch]
    full = get_config(arch)
    cfg = full.replace(n_layers=run["depth"], activation_dtype="float32",
                       impl="pallas")
    if params is None:
        g = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
        params = init_params(cfg, g, DEVICE)
    plen, gen_len = run["prompt_len"], run["gen"]
    tok0 = torch.tensor(np.stack(make_prompts(
        run["batch"], plen, cfg.vocab_size, SEED + 6)), device=DEVICE)
    seqs, margins, gaps, first = {}, {}, {}, {}
    for impl in ("pallas", "ref"):
        seqs[impl], margins[impl], gaps[impl], first[impl] = _greedy(
            cfg.replace(impl=impl), params, tok0, plen, gen_len)
    gaps = [[min(x, y) for x, y in zip(ra, rb)]
            for ra, rb in zip(gaps["pallas"], gaps["ref"])]
    logit_err, exempt = _first_logits(first, gaps[0], run["tol"], arch)
    ties = _token_flips(seqs, margins["ref"], run["tol"], gaps, arch)
    gap = min(min(g) for g in gaps)
    line = (f"parity {arch} dense, full width, depth cut {full.n_layers} -> "
            f"{run['depth']} layers, fp32 activations: kernel path "
            f"(impl=pallas) vs plain path (impl=ref) on {run['batch']} "
            f"prompts of {plen} x {gen_len} tokens: first-token logits max "
            f"abs err {logit_err:.3g} (atol {run['tol']}"
            + (f"; rows {exempt} exempt at a router near-tie" if exempt
               else "") + "); greedy tokens "
            + ("identical" if not ties else f"differ only at near-ties {ties}")
            + (f"; smallest top-{cfg.moe.top_k}/top-{cfg.moe.top_k + 1} "
               f"router gap {gap:.3g}" if cfg.moe else ""))
    return dict(depth=run["depth"], logit_err=logit_err, exempt_rows=exempt,
                near_ties=ties, router_gap=gap), line


def paged_parity(arch, params):
    """The paged engine under impl=pallas against the same engine under
    impl=ref, on DENSE_PARITY's prompts one request per slot.  First-token
    logits and the prefill's router gaps from each path's paged prefill
    step.  A token flip is exempt at a near-tie of the plain dense path's
    logits at batch 1 (where the capacity matches the paged prefill's), or
    of the routing: the prefill's, or that of the same batch-1 replay's
    decode steps (the engine's decode batch of two cannot drop a token,
    C >= 8, so each row routes as it does alone)."""
    from repro_torch import steps
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import lm, moe
    from repro_torch.serving.engine import PagedEngine
    from repro_torch.serving.paged_kv import NULL_PAGE

    run = DENSE_PARITY[arch]
    full = get_config(arch)
    cfg = full.replace(n_layers=run["depth"], activation_dtype="float32")
    n_req, plen, gen_len, ps = run["batch"], run["prompt_len"], run["gen"], 16
    max_len = plen + gen_len
    n_pages = n_req * (-(-max_len // ps)) + 1
    prompts = make_prompts(n_req, plen, cfg.vocab_size, SEED + 7)
    pools = lm.init_paged_caches(cfg, n_pages, ps, DEVICE)
    row = torch.full((-(-max_len // ps),), NULL_PAGE, dtype=torch.int32,
                     device=DEVICE)
    toks, first = {}, {}
    pre_gaps = [float("inf")] * n_req
    for impl in ("pallas", "ref"):
        c = cfg.replace(impl=impl)
        pre = steps.make_paged_prefill_step(c)
        outs = []
        for b, p in enumerate(prompts):
            with moe.record_router_gaps() as log:
                outs.append(pre(params, torch.tensor(p[None], device=DEVICE),
                                pools, row)[0])
            pre_gaps[b] = min(pre_gaps[b], _row_gaps(c, log, 1)[0])
        first[impl] = torch.cat(outs)
        eng = PagedEngine(c, params, max_batch=n_req, page_size=ps,
                          n_pages=n_pages, max_len=max_len, fused=True,
                          max_window=PAGED_RUN["window"], device=DEVICE)
        for i, p in enumerate(prompts):
            eng.submit(p, gen_len, rid=f"r{i}")
        fin = {r.rid: r.tokens for r in eng.run()}
        toks[impl] = [[fin[f"r{b}"][j] for b in range(n_req)]
                      for j in range(gen_len)]
        del eng
    logit_err, exempt = _first_logits(first, pre_gaps, run["tol"],
                                      f"{arch} paged")
    margins = [[float("inf")] * n_req for _ in range(gen_len)]
    gaps = [pre_gaps] + [[float("inf")] * n_req for _ in range(gen_len - 1)]
    if toks["pallas"] != toks["ref"]:     # the replay only where needed
        c = cfg.replace(impl="ref")
        for b, p in enumerate(prompts):
            _, mg, gp, _ = _greedy(c, params,
                                   torch.tensor(p[None], device=DEVICE),
                                   plen, gen_len)
            for j in range(gen_len):
                margins[j][b] = mg[j][0]
                gaps[j][b] = min(gaps[j][b], gp[j][0])
    ties = _token_flips(toks, margins, run["tol"], gaps, f"{arch} paged")
    gap = min(min(g) for g in gaps)
    line = (f"parity {arch} paged engine, full width, depth cut "
            f"{full.n_layers} -> {run['depth']} layers, fp32 activations: "
            f"kernel path (impl=pallas) vs plain path (impl=ref) on {n_req} "
            f"prompts of {plen} x {gen_len} tokens: first-token logits max "
            f"abs err {logit_err:.3g} (atol {run['tol']}"
            + (f"; rows {exempt} exempt at a router near-tie" if exempt
               else "") + "); greedy tokens "
            + ("identical" if not ties else f"differ only at near-ties {ties}")
            + f"; smallest prefill router gap {min(pre_gaps):.3g}")
    return dict(depth=run["depth"], logit_err=logit_err, exempt_rows=exempt,
                near_ties=ties, router_gap=gap), line


def moe_layer_parity(ops, cfg, params):
    """The MoE FFN of ``cfg``'s first layer at bf16 activations, the served
    dtype, so that its grouped GEMMs take the kernel's tensor-core path:
    impl=pallas against impl=ref at the dense prefill's T = 8 x 512 (two
    expert groups of four) and at a decode step's T = 8.  Both sides route
    the same tokens alike and compute the GEMMs in fp32, apart in
    summation order only (phase 2 holds that to 1e-4 of max |plain|).
    Both round h to bf16, where those differences move some entries by
    one bf16 unit, and the down projection carries the steps into the
    fp32 outputs, which are rounded to bf16 once more.  The bound is
    2**-7 |plain| + 2e-3 max |plain|; the line gives the largest share of
    it that an output uses.  A wrong tile or expert offset moves outputs
    by their own size."""
    from repro_torch.models import moe
    p = params["segments"][0][0][0]["moe"]
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 10)
    res = {}
    for B, S in ((8, 512), (8, 1)):
        x = torch.randn(B, S, cfg.d_model, generator=gen,
                        device=DEVICE).to(torch.bfloat16)
        n0 = ops.moe_gemm.launches
        o = moe.apply(p, cfg.replace(impl="pallas"), x)[0].float()
        n = ops.moe_gemm.launches - n0
        o_p = moe.apply(p, cfg.replace(impl="ref"), x)[0].float()
        groups = moe._group_count(cfg.moe.n_experts,
                                  moe.capacity(cfg, B * S), cfg.d_model)
        if n != 3 * groups:
            fail(f"moe layer T={B * S}: {n} moe_gemm launches, not "
                 f"{3 * groups}")
        err = (o - o_p).abs()
        scale = float(o_p.abs().max())
        limit = 2.0 ** -7 * o_p.abs() + 2e-3 * scale
        if not within(err, limit):
            fail(f"moe layer bf16 T={B * S}: max abs err {float(err.max())} "
                 f"(max |plain| {scale})")
        res[f"T={B * S}"] = dict(max_abs_err=float(err.max()),
                                 max_plain=scale,
                                 share=float((err / limit).max()))
        del x, o, o_p, err, limit
    line = (f"parity {cfg.name} MoE layer, bf16 activations (tensor-core "
            f"GEMMs), kernel path vs plain path: "
            + ", ".join(f"{k} max abs err {r['max_abs_err']:.3g} (max |plain| "
                        f"{r['max_plain']:.3g}, at most {r['share']:.3g} of "
                        f"the bound)" for k, r in res.items())
            + " (tol 2**-7 |plain| + 2e-3 max |plain|)")
    return res, line


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import build, ops, ref
    except ImportError as e:
        fail(f"cannot import the port from {ROOT / 'src'}: {e}")
    info = gpu_info()
    print(f"[setup] torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"{info}")
    t0 = time.time()
    build.build_all()
    build.check_device(torch.device("cuda"))
    build_s = time.time() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[setup] kernels built from {build.CSRC.relative_to(ROOT)} in "
          f"{build_s:.2f} s (nvcc, sm_90a); TF32 off")
    ptxas = {name: build.ptxas_report(name) for name in build.KERNELS}
    for name in ("flash_attention", "decode_attention",
                 "paged_decode_attention", "moe_gemm", "rmsnorm",
                 "rwkv6_scan"):
        print(f"[setup] ptxas {name}: " + "; ".join(
            f"{r['kernel']} {r.get('registers')} registers, "
            f"{r['spill_stores']}/{r['spill_loads']} B spilled, "
            f"{r.get('static_smem')} B static shared"
            for r in ptxas[name]))
    print("[setup] moe_gemm dynamic shared memory a CTA: " + ", ".join(
        f"{reg} {rows}x{cols} {moe_smem(build, reg, rows, cols)} B"
        for reg, rows, cols in (("wgmma", 128, 256), ("wgmma", 128, 128),
                                ("wgmma", 192, 128), ("stream", 8, 128),
                                ("stream", 16, 128), ("stream", 32, 128),
                                ("stream", 64, 128))))
    print("[setup] rwkv6_scan chunk kernel dynamic shared memory a CTA: "
          + ", ".join(f"{dt} {rwkv6_smem(build, dt == 'bf16')} B"
                      for dt in ("bf16", "fp32")))

    recs, lines = {}, []
    for check in (check_paged, check_flash, check_rwkv6, check_rglru,
                  check_moe_gemm, check_decode, check_rmsnorm):
        rec, ls = check(ops, ref)
        recs[rec["name"]] = rec
        lines += ls
    flash_local = check_flash_local(ops, ref)
    lines.append(f"flash_attention at recurrentgemma's local layers "
                 f"(B=4, S=2100, H=10, hd 256, window 2048): "
                 f"max abs err fp32 {flash_local['max_abs_err_fp32']:.3g} "
                 f"(tol {TOL[torch.float32]}), bf16 "
                 f"{flash_local['max_abs_err']:.3g} (tol 2**-7 |plain| + "
                 f"{TOL[torch.float32]}); bf16 kernel "
                 f"{flash_local['ms']:.4f} ms (earlier design "
                 f"{flash_local['earlier_ms']} ms), bound "
                 f"{flash_local['bound_ms']:.4f} ms "
                 f"({flash_local['bound_by']}), "
                 f"SDPA with the band mask "
                 + (f"{flash_local['library_ms']:.4f} ms"
                    if flash_local["library_ms"] is not None
                    else f"refused: {flash_local['library_note']}"))
    for line in lines:
        print(f"[kernels] {line}")

    # each served path with the counts set to 0 just before it; a kernel's
    # launches are the sum over the paths
    serve_stats, path_launches, parity = {}, {}, {}

    def served(key, result):
        serve_stats[key], path_launches[key], line = result
        print(f"[serve] {line}")

    cfg, params = full_width_params("qwen3-1.7b")
    served("qwen3-1.7b paged", serve_paged(ops, cfg, params))
    del params
    for arch in ("rwkv6-1.6b", "recurrentgemma-2b"):
        cfg, params = full_width_params(arch)
        served(f"{arch} dense", serve_dense(ops, cfg, params))
        del params
    torch.cuda.empty_cache()
    parity["qwen3-1.7b paged"], line = engine_parity()
    print(f"[parity] {line}")
    for arch in ("rwkv6-1.6b", "recurrentgemma-2b"):
        parity[f"{arch} dense"], line = dense_parity(arch)
        print(f"[parity] {line}")
    # grok-1 at its published widths, cut to GROK_DEPTH layers: one set of
    # bf16 parameters for both engines and for the parity runs
    torch.cuda.empty_cache()
    cfg, params = full_width_params("grok-1-314b", GROK_DEPTH)
    print(f"[serve] grok-1-314b at {GROK_DEPTH} layers: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB of parameters on "
          f"the card")
    served("grok-1-314b dense", serve_dense(ops, cfg, params))
    served("grok-1-314b paged", serve_paged(ops, cfg, params))
    parity["grok-1-314b dense"], line = dense_parity("grok-1-314b", params)
    print(f"[parity] {line}")
    parity["grok-1-314b paged"], line = paged_parity("grok-1-314b", params)
    print(f"[parity] {line}")
    parity["grok-1-314b moe layer bf16"], line = moe_layer_parity(
        ops, cfg, params)
    print(f"[parity] {line}")
    del params
    torch.cuda.empty_cache()

    for name, rec in recs.items():
        rec["launches"] = sum(l[w] for l in path_launches.values()
                              for w, k in ops.KERNEL_OF.items() if k == name)
        if rec["launches"] == 0:
            fail(f"{name} never launched on a served path")
    for fn in ops.WRAPPERS:
        if not any(l[fn.__name__] for l in path_launches.values()):
            fail(f"{fn.__name__} never launched on a served path")
    kernels = {"kernels": [{k: v for k, v in recs[fn.__name__].items()
                            if k not in ("shapes", "cases")}
                           for fn in ops.KERNELS]}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        dict(gpu=info, torch=torch.__version__, build_s=build_s, ptxas=ptxas,
             seconds=time.time() - t0,
             kernels=[recs[fn.__name__] for fn in ops.KERNELS],
             flash_local=flash_local,
             path_launches=path_launches, serve=serve_stats, parity=parity),
        indent=2))
    print(f"[done] {time.time() - t0:.1f} s after the build started")
    print(json.dumps(kernels))
    print(gpu_info())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
