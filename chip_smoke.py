"""GPU smoke run of the PyTorch/CUDA port: builds the kernels, holds each
against its plain PyTorch version, serves qwen3-1.7b at full width through
the paged engine and rwkv6-1.6b and recurrentgemma-2b at full width
through the dense engine, and checks each served path at a cut depth
against the port's plain path.

    python3 chip_smoke.py

Needs one CUDA card (the kernels target Hopper, sm_90a) and the CUDA
toolkit; imports nothing of JAX.  Every phase prints one line of results;
any failure exits non-zero.  The last line of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

preceded by the kernels' JSON line and the card's name and power limit.
The full record of the run is also written to chiprun_out/chip_smoke.json.
"""
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
    return float((a.float() - b.float()).abs().max())


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
        if err > TOL[dtype]:
            fail(f"paged decode {name} {dtype}: max abs err {err}")
    # null-page poisoning: rows past pos name page 0, which is poisoned
    q, kp, vp, bt, p = paged_inputs(B, H, Kv, hd, ps, nmax, ragged,
                                    torch.float32, gen)
    for b, last in enumerate(ragged):
        bt[b, last // ps + 1:] = 0
    o1 = ops.paged_decode_attention(q, kp, vp, bt, p)
    kp[0], vp[0] = 1e6, -1e6
    o2 = ops.paged_decode_attention(q, kp, vp, bt, p)
    if not torch.equal(o1, o2) or max_err(
            o1, ref.paged_decode_attention(q, kp, vp, bt, p)) > 1e-4:
        fail("paged decode reads the poisoned null page")
    # an inactive engine slot: all-null row, pos 0 — reads page 0 slot 0
    bt0 = torch.zeros_like(bt)
    p0 = torch.zeros_like(p)
    if max_err(ops.paged_decode_attention(q, kp, vp, bt0, p0),
               ref.paged_decode_attention(q, kp, vp, bt0, p0)) > 1e-4:
        fail("paged decode on all-null rows")
    # GQA group sizes and head dims
    for G in (1, 2, 4, 8):
        for hd_ in (16, 64, 128):
            for dtype in (torch.float32, torch.bfloat16):
                q, kp, vp, bt, p = paged_inputs(3, 2 * G, 2, hd_, 16, 5,
                                                [79, 0, 33], dtype, gen)
                err = max_err(ops.paged_decode_attention(q, kp, vp, bt, p),
                              ref.paged_decode_attention(q, kp, vp, bt, p))
                if err > TOL[dtype]:
                    fail(f"paged decode G={G} hd={hd_} {dtype}: err {err}")
    lines.append("null-page poisoning exact; G in {1,2,4,8} x hd in "
                 "{16,64,128} x {fp32,bf16} within tolerance")
    # time at the main path's shapes and type (bf16, every pos 575)
    q, kp, vp, bt, p = paged_inputs(B, H, Kv, hd, ps, nmax, [575] * B,
                                    torch.bfloat16, gen)
    ms = time_ms(lambda: ops.paged_decode_attention(q, kp, vp, bt, p))
    plain_ms = time_ms(lambda: ref.paged_decode_attention(q, kp, vp, bt, p))
    nbytes, flops = paged_bytes_flops(q, kp, bt, p)
    b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
    rec = dict(name="paged_decode_attention", route="cuda",
               source="src/repro_torch/csrc/paged_decode_attention.cu",
               replaces="src/repro/kernels/decode_attention.py:189",
               max_abs_err=worst[("main", torch.bfloat16)], ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None)
    errs = ", ".join(f"{n} {str(d)[6:]} {e:.3g}" for (n, d), e in worst.items())
    lines.insert(0, f"paged_decode_attention B={B} H={H} Kv={Kv} hd={hd} "
                    f"ps={ps} pos<=575: max abs err [{errs}] (tol fp32 "
                    f"{TOL[torch.float32]}, bf16 {TOL[torch.bfloat16]}); "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                    f"{b_ms:.4f} ms ({b_by}, {nbytes / 1e6:.2f} MB)")
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
        if err > TOL[dtype]:
            fail(f"flash {dtype}: max abs err {err}")
    # masks and ragged lengths (S not a multiple of the 64-row tiles), on
    # both the tensor-core (bf16, hd <= 128) and the fp32-core paths
    for S in (77, 200):
        for kw in (dict(causal=True), dict(causal=False),
                   dict(causal=True, window=48),
                   dict(causal=True, softcap=30.0)):
            for hd in (16, 64, 128, 256):
                for dtype in (torch.float32, torch.bfloat16):
                    q, k, v = qkv((2, S, 3, hd), dtype)
                    err = max_err(ops.flash_attention(q, k, v, **kw),
                                  ref.flash_attention(q, k, v, **kw))
                    if err > TOL[dtype]:
                        fail(f"flash S={S} hd={hd} {dtype} {kw}: max abs "
                             f"err {err}")
    q, k, v = qkv(shape, torch.bfloat16)
    ms = time_ms(lambda: ops.flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(lambda: ref.flash_attention(q, k, v, causal=True))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib_ms = time_ms(lambda: sdpa(qt, kt, vt, is_causal=True))
    nbytes, flops = flash_bytes_flops(q, causal=True)
    b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
    rec = dict(name="flash_attention", route="cuda",
               source="src/repro_torch/csrc/flash_attention.cu",
               replaces="src/repro/kernels/flash_attention.py:93",
               max_abs_err=worst[torch.bfloat16], ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    line = (f"flash_attention B=1 S=512 H=16 hd=128 causal: max abs err "
            f"bf16 {worst[torch.bfloat16]:.3g}, fp32 "
            f"{worst[torch.float32]:.3g}; S in {{77,200}} x causal/bidir/"
            f"window/softcap x hd in {{16,64,128,256}} x {{fp32,bf16}} within "
            f"tolerance; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
    return rec, [line]


def check_flash_local(ops, ref):
    """The flash kernel at recurrentgemma's local layers (hd 256, so the
    fp32-core path even in bf16; window 2048 over a 2100-token prompt):
    checked against the plain version on the whole batch and timed.

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
        if bool((err > limit).any()):
            fail(f"flash hd 256 window 2048 {dtype}: max abs err "
                 f"{errs[dtype]} (typical |out| {float(o_p.abs().mean())})")
        del o, o_p, err
    ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
    nbytes, flops = flash_bytes_flops(q, causal=True, window=2048)
    b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
    return dict(shape=list(shape), window=2048,
                max_abs_err=errs[torch.bfloat16],
                max_abs_err_fp32=errs[torch.float32], ms=ms, bound_ms=b_ms,
                bound_by=b_by)


def rwkv6_inputs(B, S, H, K, dtype, gen):
    """r, k, v in ``dtype``; log-decay lw = -exp(N(0,1) - 1), bonus u and
    a nonzero S0 in fp32 (the reference kernel test's distributions)."""
    r, k, v = (torch.randn(B, S, H, K, generator=gen, device=DEVICE).to(dtype)
               for _ in range(3))
    lw = -torch.exp(torch.randn(B, S, H, K, generator=gen, device=DEVICE)
                    - 1.0)
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
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 3)
    B, H, K = 8, 32, 64
    worst = {}
    for S in (512, 1, 77, 509):
        for dtype in (torch.bfloat16, torch.float32):
            x = rwkv6_inputs(B, S, H, K, dtype, gen)
            o, sT = ops.rwkv6_scan(*x)
            o_p, sT_p = ref.rwkv6_scan(*x)
            err = max(max_err(o, o_p), max_err(sT, sT_p))
            worst[(S, dtype)] = err
            if err > RWKV_TOL:
                fail(f"rwkv6_scan S={S} {dtype}: max abs err {err}")
    x = rwkv6_inputs(B, 512, H, K, torch.bfloat16, gen)
    ms = time_ms(lambda: ops.rwkv6_scan(*x))
    plain_ms = time_ms(lambda: ref.rwkv6_scan(*x), iters=5)
    nbytes, flops = rwkv6_bytes_flops(x[0], x[2])
    b_ms, b_by = bound(nbytes, flops, torch.float32)
    rec = dict(name="rwkv6_scan", route="cuda",
               source="src/repro_torch/csrc/rwkv6_scan.cu",
               replaces="src/repro/kernels/rwkv6_scan.py:73",
               max_abs_err=worst[(512, torch.bfloat16)], ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=None)
    errs = ", ".join(f"S={S} {str(d)[6:]} {e:.3g}"
                     for (S, d), e in worst.items())
    line = (f"rwkv6_scan B={B} H={H} K=V={K}, nonzero S0: max abs err on o "
            f"and S_T [{errs}] (tol {RWKV_TOL}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}) at S=512 bf16")
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
        if err > RGLRU_TOL:
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


# ---------------------------------------------------------------------------
# phase 3 — serve at full width through the kernels
# ---------------------------------------------------------------------------
def serve_full_width(ops):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.serving.engine import PagedEngine
    from repro_torch.weights import init_params

    cfg = get_config("qwen3-1.7b").replace(impl="pallas")
    n_req, plen, gen_len, batch, ps = 16, 512, 64, 8, 16
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = init_params(cfg, g, DEVICE)
    n_params = sum(t.numel() for t in _leaves(params))
    max_len = plen + gen_len
    eng = PagedEngine(cfg, params, max_batch=batch, page_size=ps,
                      n_pages=batch * (-(-max_len // ps)) + 1,
                      max_len=max_len, fused=True, max_window=8,
                      device=DEVICE)
    eng.warmup_windows()
    prompts = make_prompts(n_req, plen, cfg.vocab_size, SEED)
    torch.cuda.synchronize()
    ops.reset_launches()                     # counts of the main path only
    t0 = time.time()
    for i, p in enumerate(prompts):
        eng.submit(p, gen_len, rid=f"req{i}")
    fin = eng.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    m = eng.metrics()
    if len(fin) != n_req or any(len(r.tokens) != gen_len for r in fin):
        fail("not every request finished with its tokens")
    if any(not (0 <= t < cfg.vocab_size) for r in fin for t in r.tokens):
        fail("token ids out of range (NaN logits?)")
    decode_steps = eng.decode_steps
    prefills = m["model_passes"] - decode_steps
    L = cfg.n_layers
    if launches["flash_attention"] != prefills * L:
        fail(f"flash launches {launches['flash_attention']} != "
             f"{prefills} prefills x {L} layers")
    if launches["paged_decode_attention"] != decode_steps * L:
        fail(f"paged decode launches {launches['paged_decode_attention']} "
             f"!= {decode_steps} decode steps x {L} layers")
    if launches["rwkv6_scan"] or launches["rglru_scan"]:
        fail(f"a recurrent scan launched on an attention-only path: "
             f"{launches}")
    # a finite logit check on one decode step of the served pools
    logits, _ = _one_step_logits(eng)
    if not torch.isfinite(logits).all():
        fail("non-finite logits after serving")
    prefill_ms = _mean_prefill_ms(eng, prompts[0])
    prof = _profile_window(eng, prompts)
    stats = dict(arch=cfg.name, n_layers=L, d_model=cfg.d_model,
                 n_params=n_params, requests=n_req, prompt_len=plen,
                 gen=gen_len, max_batch=batch, page_size=ps,
                 wall_s=wall, tok_per_s=m["tokens_out"] / wall,
                 decode_step_ms=m["decode_step_s"] * 1e3,
                 prefill_ms=prefill_ms, prefills=prefills,
                 decode_steps=decode_steps, windows=m["windows"],
                 preemptions=m["preemptions"], h2d_syncs=m["h2d_syncs"],
                 d2h_syncs=m["d2h_syncs"], launches=launches,
                 profile=prof)
    line = (f"serve {cfg.name} ({L} layers, d_model {cfg.d_model}, "
            f"{n_params / 1e9:.3f} B params, bf16 activations, impl=pallas): "
            f"{n_req} requests x {gen_len} tokens in {wall:.2f} s, "
            f"{stats['tok_per_s']:.1f} tok/s, decode step "
            f"{stats['decode_step_ms']:.3f} ms, prefill {prefill_ms:.3f} ms; "
            f"{prefills} prefills, {decode_steps} decode steps, "
            f"{m['windows']} windows; launches {launches}; profiled "
            f"{prof['steps']}-step window: {prof['wall_ms']:.3f} ms wall, "
            f"device busy {prof['busy_share']:.3f}, "
            f"{prof['launches_per_step']:.0f} device launches per step, "
            f"top {prof['top']}")
    del eng, params
    torch.cuda.empty_cache()
    return stats, launches, line


# the recurrent families at full width through the dense engine: the
# kernel of each layer kind, and the number of layers of that kind
DENSE_RUNS = {
    "rwkv6-1.6b": dict(requests=16, batch=8, prompt_len=512, gen=64),
    "recurrentgemma-2b": dict(requests=8, batch=4, prompt_len=2100, gen=32),
}


def serve_dense_full_width(ops, arch):
    """``run_dense`` at the config's published widths and depth, random
    fp32 weights from the seed, bf16 activations, impl=pallas.  Checks
    every request's tokens and that each scan kernel ran in every layer
    of its kind: rwkv6_scan in every prefill and decode step, rglru_scan
    and flash in every prefill (RG-LRU and local-attention decode steps
    are plain, as in the reference)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_parser, run_dense
    from repro_torch.weights import init_params

    cfg = get_config(arch).replace(impl="pallas")
    run = DENSE_RUNS[arch]
    args = build_parser().parse_args(
        [f"--{k.replace('_', '-')}={v}" for k, v in run.items()]
        + [f"--seed={SEED}"])
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    params = init_params(cfg, g, DEVICE)
    n_params = sum(t.numel() for t in _leaves(params))
    torch.cuda.synchronize()
    ops.reset_launches()                     # counts of this path only
    out, st = run_dense(args, cfg, params=params, device=DEVICE)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in ops.KERNELS}
    if sorted(out) != list(range(args.requests)) or any(
            len(t) != args.gen for t in out.values()):
        fail(f"{arch}: not every request got its {args.gen} tokens")
    if any(not (0 <= t < cfg.vocab_size) for ts in out.values() for t in ts):
        fail(f"{arch}: token ids out of range (NaN logits?)")
    # +1 each: the warmup prefill and decode step before the clock
    prefills, steps = st["prefills"] + 1, st["decode_steps"] + 1
    kinds = cfg.layer_kinds
    want = {"rwkv6_scan": kinds.count("rwkv6") * (prefills + steps),
            "rglru_scan": kinds.count("rglru") * prefills,
            "flash_attention": kinds.count("local") * prefills,
            "paged_decode_attention": 0}
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
                 decode_steps=steps, launches=launches, profile=prof)
    line = (f"serve {arch} dense ({cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {n_params / 1e9:.3f} B params, bf16 "
            f"activations, impl=pallas): {args.requests} requests x "
            f"{args.gen} tokens, batch {args.batch}, prompt "
            f"{args.prompt_len}, in {st['seconds']:.2f} s, "
            f"{stats['tok_per_s']:.1f} tok/s, decode step "
            f"{stats['decode_step_ms']:.3f} ms, prefill (batch of "
            f"{args.batch}) {stats['prefill_ms']:.3f} ms; launches "
            f"{launches} (incl. warmup); profiled decode step "
            f"{prof['decode']['wall_ms'] / prof['decode']['steps']:.3f} ms "
            f"wall, device busy "
            f"{prof['decode']['busy_share']:.3f}, "
            f"{prof['decode']['launches_per_step']:.0f} launches, top "
            f"{prof['decode']['top']}; profiled prefill "
            f"{prof['prefill']['wall_ms']:.3f} ms wall, device busy "
            f"{prof['prefill']['busy_share']:.3f}, top "
            f"{prof['prefill']['top']}")
    del params
    torch.cuda.empty_cache()
    return stats, launches, line


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
        eng.submit(p, 64, rid=f"prof{i}")
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
    if logit_err > 1e-3:
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
                if margins[r.rid][j] >= 1e-4:
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


# full width with the depth cut, fp32: each recurrent family's kernel path
# (impl=pallas) against the port's plain path (impl=ref).  First-token
# logits: the scans differ only in summation order (rwkv6: chunked vs
# stepwise) or not at all (rglru), and flash vs the full-scores attention
# in fp32 in the order of 1e-6 relative; the tied 256000-row head of
# recurrentgemma gives logits of magnitude ~100, so its tolerance is
# scaled up.  Greedy tokens must match, except at a near-tie: a step
# where the plain path's top-2 margin is below twice the tolerance.
DENSE_PARITY = {
    "rwkv6-1.6b": dict(depth=4, batch=4, prompt_len=512, gen=16, tol=1e-3),
    "recurrentgemma-2b": dict(depth=6, batch=2, prompt_len=2100, gen=16,
                              tol=1e-2),
}


def dense_parity(arch):
    from repro_torch import steps
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.weights import init_params

    run = DENSE_PARITY[arch]
    full = get_config(arch)
    cfg = full.replace(n_layers=run["depth"], activation_dtype="float32",
                       impl="pallas")
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 6)
    params = init_params(cfg, g, DEVICE)
    plen, gen_len = run["prompt_len"], run["gen"]
    tok0 = torch.tensor(np.stack(make_prompts(
        run["batch"], plen, cfg.vocab_size, SEED + 6)), device=DEVICE)
    seqs, margins, first = {}, {}, {}
    for impl in ("pallas", "ref"):
        c = cfg.replace(impl=impl)
        prefill = steps.make_prefill_step(c, plen + gen_len)
        serve = steps.make_serve_step(c)
        logits, caches = prefill(params, tok0)
        first[impl] = logits
        toks, mg = [], []
        for j in range(gen_len):
            top2 = logits[:, 0].topk(2).values
            mg.append((top2[:, 0] - top2[:, 1]).tolist())
            tok = logits.argmax(-1).to(torch.int32)
            toks.append(tok[:, 0].tolist())
            if j < gen_len - 1:
                tok, logits, caches = serve(params, tok, caches, plen + j)
        seqs[impl], margins[impl] = toks, mg
        del caches
    logit_err = max_err(first["pallas"], first["ref"])
    if logit_err > run["tol"]:
        fail(f"{arch}: first-token logits differ by {logit_err} > "
             f"{run['tol']}")
    ties = []
    for b in range(run["batch"]):
        for j in range(gen_len):
            if seqs["pallas"][j][b] != seqs["ref"][j][b]:
                m = margins["ref"][j][b]
                ties.append((b, j, m))
                if m >= 2 * run["tol"]:
                    fail(f"{arch} row {b} step {j}: kernel-path token "
                         f"{seqs['pallas'][j][b]} != plain {seqs['ref'][j][b]}"
                         f" with top-2 margin {m}")
                break
    line = (f"parity {arch} full width, depth cut {full.n_layers} -> "
            f"{run['depth']} layers, fp32: kernel path (impl=pallas) vs plain "
            f"path (impl=ref) on {run['batch']} prompts of {plen} x "
            f"{gen_len} tokens: first-token logits max abs err "
            f"{logit_err:.3g} (atol {run['tol']}); greedy tokens "
            + ("identical" if not ties else f"differ only at near-ties {ties}"))
    del params
    torch.cuda.empty_cache()
    return dict(depth=run["depth"], logit_err=logit_err, near_ties=ties), line


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

    recs, lines = {}, []
    for check in (check_paged, check_flash, check_rwkv6, check_rglru):
        rec, ls = check(ops, ref)
        recs[rec["name"]] = rec
        lines += ls
    flash_local = check_flash_local(ops, ref)
    lines.append(f"flash_attention at recurrentgemma's local layers "
                 f"(B=4, S=2100, H=10, hd 256, window 2048, fp32-core path): "
                 f"max abs err fp32 {flash_local['max_abs_err_fp32']:.3g} "
                 f"(tol {TOL[torch.float32]}), bf16 "
                 f"{flash_local['max_abs_err']:.3g} (tol 2**-7 |plain| + "
                 f"{TOL[torch.float32]}); bf16 kernel "
                 f"{flash_local['ms']:.4f} ms, bound "
                 f"{flash_local['bound_ms']:.4f} ms ({flash_local['bound_by']})")
    for line in lines:
        print(f"[kernels] {line}")

    # each served path with the counts set to 0 just before it; a kernel's
    # launches are the sum over the paths
    serve_stats, path_launches = {}, {}
    stats, launches, line = serve_full_width(ops)
    serve_stats["qwen3-1.7b"], path_launches["qwen3-1.7b"] = stats, launches
    print(f"[serve] {line}")
    for arch in DENSE_RUNS:
        stats, launches, line = serve_dense_full_width(ops, arch)
        serve_stats[arch], path_launches[arch] = stats, launches
        print(f"[serve] {line}")
    parity = {}
    parity["qwen3-1.7b"], line = engine_parity()
    print(f"[parity] {line}")
    for arch in DENSE_PARITY:
        parity[arch], line = dense_parity(arch)
        print(f"[parity] {line}")

    for name, rec in recs.items():
        rec["launches"] = sum(l[name] for l in path_launches.values())
        if rec["launches"] == 0:
            fail(f"{name} never launched on a served path")
    kernels = {"kernels": [recs[fn.__name__] for fn in ops.KERNELS]}
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        dict(gpu=info, torch=torch.__version__, build_s=build_s,
             kernels=kernels["kernels"], flash_local=flash_local,
             path_launches=path_launches, serve=serve_stats, parity=parity),
        indent=2))
    print(json.dumps(kernels))
    print(gpu_info())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
