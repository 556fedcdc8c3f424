"""GPU smoke run of the PyTorch/CUDA port: builds the kernels, holds each
against its plain PyTorch version (the paged decode kernel also in its
masked partials mode, per stripe of a striped pool), serves qwen3-1.7b at
full width through the paged engine (plain; on a pool striped over four
nodes, with the pools on one device and then on a 1x4 mesh of stripes,
and through the serve CLI on that mesh; with the prefix cache,
speculative decoding and chunked prefill on, beside the same traffic with
them off; and under the pinned chaos fault plan on a pool striped over
three nodes, untraced and with the flight recorder on), rwkv6-1.6b and
recurrentgemma-2b at full width through the dense engine,
grok-1-314b at full width with its depth cut to four layers through both
engines, DeepSeek-V3 (five layers: three dense, two MoE) and gemma2-27b
(6 of its 46 layers) at full width through the dense engine, qwen3-14b
(20 of 40 layers) and minitron-8b (16 of 32) at full width through the
paged engine, qwen2-vl-7b (four
layers) through ``lm.prefill`` and ``lm.decode_step`` with embeddings at
3-D M-RoPE positions, and hubert-xlarge through ``lm.forward``, and
checks each served path at a cut depth against the port's plain path
(the paged engine's features each alone and all three for qwen3, the
chaos plan with the features off and on, and the striped pools on a 1x2
and a 2x2 mesh; for grok, all three against the plain engine without
them; DeepSeek at one dense and one MoE layer, gemma2 at two local and
two global layers, qwen3-14b and minitron-8b at four layers through the
paged engine, qwen2-vl-7b and hubert-xlarge on the served weights).  It
also reports whether a 1-token prefill chunk writes the KV of a longer
suffix pass bit for bit.  Phase 2 also holds the weight product
(``modules.matmul`` of two bf16 operands: cuBLAS's bf16 GEMM with fp32
accumulation) against the promoted fp32 product at every bf16 weight
shape of gemma2-27b, grok-1 and DeepSeek-V3 at phase 3's rows, its
backward (2-D, the tied head, grouped) against the promoted product's
autograd, and ``moe.local_moe`` and ``_local_moe_ep`` on the card
against the CPU, bit for bit, on inputs whose every product before the
combine is exact; phase 3 runs
DeepSeek-V3's dense prefill and decode steps twice (logits equal bit for
bit) and fails if gemma2-27b's decode steps convert a weight to
another dtype.  Its last phase (5, "paper") runs the paper's
own modules on the card: the §X-B memory server (a 4 GiB store, one
controller against four stripes on a 1x4 mesh), the §X-A neuron
simulation at N = 32,768 with one-step parity against the CPU, the
§X-B prefix-sharing example at qwen3-1.7b's widths, the §V-A lattice
all-reduce on a 2x4 mesh and qwen3-1.7b's blocks as a 4-stage pipeline,
each against its plain version, then the paper's tables.  Phase 6
("train") runs the training path: three ``make_train_step`` steps of
qwen3-1.7b at full width cut to 2 layers on the card against the same
steps on the CPU (fp32 moments, and int8 ones at a vocabulary cut to
16,384), the served model's loss under
impl="pallas" against impl="blocked" with the kernels' launches (and a
train step under impl="pallas", which must raise: the kernels have no
backward), and ``train_loop.run`` at full width (4 of its 28 layers,
B=4, S=2048, 6 steps) with a checkpoint at step 3, the restart from it
(steps 3 to 5 must repeat), and again with int8 moments (its final
checkpoint must restore bit for bit), reporting step time, tokens/s,
peak memory, a profiled step and the checkpoint times.  Phase 7
("mesh") trains on device meshes whose positions all share the one
card: the mesh trainer at 2 layers on a 2x2 and a 1x2 mesh against the
one-device trainer (fp32 and int8 moments), ``train_loop.run`` at full
width, 4 layers, on a 2x2 mesh (6 steps, a checkpoint at step 3) with its step
time, peak memory, a profiled step and each position's bytes on the
wire beside ``core/costs.comm_events``, the step-3 checkpoint restored
onto a 1x4 and a 4x1 mesh bit for bit and one more step on the 1x4
mesh, ``compressed_all_reduce`` over a 4x1 mesh's data
axis against its plain version, and the train CLI in a process of its
own on a 2x2 mesh and under ``--layout auto``.
Phase 8 ("dense-mesh") serves on device meshes whose positions share the
card: each family's dense engine (qwen3-1.7b on 1x2, 2x2 and 1x4, grok-1
under expert-TP and EP, DeepSeek-V3, gemma2-27b past its window,
recurrentgemma-2b, rwkv6-1.6b) at fp32 and cut depth against the
one-device dense engine; qwen3-1.7b at 28 layers on 1x4 and 2x2 and
grok-1 at four layers on 1x2 (expert-TP and EP), bf16, full width, with
their decode step, prefill, tok/s, peak memory, a profiled step and each
position's bytes on the wire beside ``core/costs.comm_events``; the mesh
trainer for grok-1 (expert-TP, EP, and a data axis against the same mesh
on the CPU), DeepSeek-V3, recurrentgemma-2b and rwkv6-1.6b against one
device; the pipeline's backward on four streams against the stages run
in order; and the serve CLI's dense engine on a 1x2 mesh in a process of
its own.  Phase 9 ("dryrun") holds the dry run (``launch/dryrun.py``, on
a mesh of meta positions) against the card: phase 7's full-width trainer
predicted at its config, batch and 2x2 mesh (the wire bytes of each
collective site equal to the measured step's, the placed parameters and
moments equal to the predicted arguments less the batch shards, the
peak and the step time beside the prediction and the H100 roofline),
and a qwen3-1.7b prefill and decode step on a 1x4 mesh under
impl="pallas" (each kernel's dry calls equal to its launches).  Phase
10 ("cards") runs only where two or more cards are visible (on one card
it prints one line saying so): the mesh trainer with one position a
card, qwen3-1.7b at 2 layers on a 1x2 mesh, grok-1 at phase 8's trainer
widths on a 2x1 mesh (its experts' gathers cross the cards) and, with
four cards, qwen3-1.7b on a 2x2 mesh, each against the same mesh on one
card; then phase 7's full-width trainer on a 2x2 mesh with one position
a card, each card's peak beside the dry run's arguments + temp of a
position, its wire at every site equal to the prediction.

    python3 chip_smoke.py
    python3 chip_smoke.py --only-train     # the build and phase 6 alone
    python3 chip_smoke.py --only-mesh      # the build and phase 7 alone
    python3 chip_smoke.py --only-dense-mesh  # the build and phase 8 alone
    python3 chip_smoke.py --only-dryrun    # phase 7's trainer and phase 9
    python3 chip_smoke.py --only-cards     # the build and phase 10 alone

Needs one CUDA card with 80 GB (the kernels target Hopper, sm_90a;
DeepSeek's five layers hold 53.3 GB of bf16 parameters), the CUDA
toolkit, and about 45 GB of disk for phase 6's and 7's checkpoints
(temporary directories, removed at the end); imports
nothing of JAX.  Every phase
prints one line of results; any failure exits non-zero.  The last line
of standard output is

    {"ok": true, "device": {"platform": "gpu", "kind": "<name>", "count": 1}}

preceded by the kernels' JSON line and the card's name and power limit.
The full record of the run is also written to chiprun_out/chip_smoke.json,
the traced chaos run's Chrome trace to chiprun_out/chaos_trace.json,
the striped serve CLI's output to chiprun_out/serve_cli_striped.txt,
the mesh train CLI's to chiprun_out/mesh_train_cli.txt and the dense
mesh serve CLI's to chiprun_out/serve_cli_dense_mesh.txt.
"""
import contextlib
import ctypes
import dataclasses
import json
import re
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


def _sync():
    """Wait for every visible card (a mesh may hold work on each)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def _reset_peak():
    """Reset every visible card's peak (``_peak_gb``)."""
    for i in range(torch.cuda.device_count()):
        torch.cuda.reset_peak_memory_stats(i)


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
        _sync()
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
    for G in (1, 2, 4, 5, 6, 7, 8, 12, 16):
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
    lines.append("null-page poisoning exact; G in {1,2,4,5,6,7,8,12,16} x hd "
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


def striped_inputs(B, H, Kv, hd, ps, nmax, pos, dtype, gen, n_stripes):
    """One pool cut into ``n_stripes`` stripes of L rows, as the engine
    cuts it: q, pages (n_stripes * L rows), a block table of distinct
    rows none of which is a stripe's local row 0 (those hold NaN: only an
    unowned entry's safe index names them), sequence 1's pages all on
    stripe 0 (it owns nothing on the others), pos.  Returns them and L."""
    L = B * nmax // n_stripes + nmax + 1
    P = n_stripes * L
    q = torch.randn(B, H, hd, generator=gen, device=DEVICE).to(dtype)
    kp = torch.randn(P, ps, Kv, hd, generator=gen, device=DEVICE).to(dtype)
    vp = torch.randn(P, ps, Kv, hd, generator=gen, device=DEVICE).to(dtype)
    kp[::L] = float("nan")
    vp[::L] = float("nan")
    rows = torch.tensor([r for r in range(P) if r % L], device=DEVICE)
    perm = torch.randperm(rows.numel(), generator=gen, device=DEVICE)
    bt = rows[perm[:B * nmax]].reshape(B, nmax).to(torch.int32)
    bt[1] = torch.arange(1, nmax + 1, device=DEVICE)
    pos = torch.as_tensor(pos, dtype=torch.int32, device=DEVICE)
    return q, kp, vp, bt, pos, L


def stripe_view(kp, vp, bt, j, L):
    """Stripe j's pages, its safe local table (unowned entries name local
    row 0) and its ownership mask, as the striped decode passes them."""
    local = bt - j * L
    mine = (local >= 0) & (local < L)
    safe = torch.where(mine, local, 0).to(torch.int32)
    return (kp[j * L:(j + 1) * L], vp[j * L:(j + 1) * L], safe,
            mine.to(torch.int32))


def merge_partials(parts, dtype):
    """The striped decode's merge of the stripes' (acc, m, l)."""
    m_g = torch.stack([m for _, m, _ in parts]).amax(0)
    l_g = sum(l * torch.exp(m - m_g) for _, m, l in parts)
    acc_g = sum(a * torch.exp(m - m_g)[..., None] for a, m, _ in parts)
    B, Kv, G, hd = acc_g.shape
    return (acc_g / torch.clamp(l_g, min=1e-37)[..., None]).reshape(
        B, Kv * G, hd).to(dtype)


def masked_bytes_flops(q, kp, bt, pos, mine, n_out):
    """Bytes and operations of one masked partials launch: each owned
    live slot's K and V rows, q, the table, the mask and pos read once,
    ``n_out`` fp32 partials written once."""
    B, H, hd = q.shape
    ps, Kv = kp.shape[1], kp.shape[2]
    e = q.element_size()
    T = bt.shape[1] * ps
    live = (torch.arange(T, device=q.device)[None, :] <= pos.long()[:, None]) \
        & mine.bool().repeat_interleave(ps, dim=1)
    slots = int(live.sum())
    nbytes = (q.numel() * e + 2 * slots * Kv * hd * e + 8 * bt.numel()
              + 4 * B + 4 * n_out)
    return nbytes, 4 * slots * H * hd


def check_paged_masked(ops, ref):
    """The paged kernel's masked partials mode against its plain version
    at qwen3's decode (B=8, H=16, Kv=8, hd 128, ps 16) and grok's (H=48,
    softcap 30), bf16 and fp32, on masks of 2 and 4 stripes: per stripe
    acc, m and l each within the kernel's tolerance, with a sequence that
    owns no page on a stripe (m = NEG_INF, l = 0, acc = 0), pos on page
    boundaries and NaN in every unowned entry's local row 0; the merged
    stripes against the unstriped kernel.  Times a 4-stripe mask's
    stripe-0 launch at qwen3's shape, every pos 575, beside its bound (the
    owned pages' bytes, q and the partials over 3.35 TB/s); no library
    call takes a page mask."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 20)
    B, Kv, hd, ps = 8, 8, 128, 16
    nmax = 576 // ps
    ragged = [575, 0, 15, 16, 31, 300, 511, 32]   # page boundaries
    worst = {}
    for H, cap in ((16, None), (48, 30.0)):
        for dtype in (torch.bfloat16, torch.float32):
            for n in (2, 4):
                q, kp, vp, bt, pos, L = striped_inputs(
                    B, H, Kv, hd, ps, nmax, ragged, dtype, gen, n)
                parts = []
                for j in range(n):
                    kj, vj, safe, mine = stripe_view(kp, vp, bt, j, L)
                    got = ops.paged_decode_attention(
                        q, kj, vj, safe, pos, softcap=cap, page_mask=mine,
                        partials=True)
                    want = ref.paged_decode_attention(
                        q, kj, vj, safe, pos, softcap=cap, page_mask=mine,
                        partials=True)
                    for name, a, b in zip(("acc", "m", "l"), got, want):
                        err = max_err(a, b)
                        key = (H, str(dtype)[6:], name)
                        worst[key] = max(worst.get(key, 0.0), err)
                        if not err <= TOL[dtype]:
                            fail(f"paged decode masked partials H={H} "
                                 f"{dtype} {n} stripes, stripe {j}: {name} "
                                 f"max abs err {err}")
                    if j and not (bool((got[1][1] == ref.NEG_INF).all())
                                  and bool((got[2][1] == 0).all())
                                  and bool((got[0][1] == 0).all())):
                        fail(f"paged decode masked partials: a sequence "
                             f"with no page on stripe {j} did not give m = "
                             f"NEG_INF, l = 0, acc = 0")
                    parts.append(got)
                err = max_err(merge_partials(parts, dtype),
                              ops.paged_decode_attention(q, kp, vp, bt, pos,
                                                         softcap=cap))
                key = (H, str(dtype)[6:], f"merged {n}")
                worst[key] = err
                if not err <= TOL[dtype]:
                    fail(f"paged decode: {n} stripes merged vs the unstriped "
                         f"kernel H={H} {dtype}: max abs err {err}")
    # time: qwen3's shape, bf16, every pos 575, stripe 0 of 4
    q, kp, vp, bt, pos, L = striped_inputs(B, 16, Kv, hd, ps, nmax,
                                           [575] * B, torch.bfloat16, gen, 4)
    kj, vj, safe, mine = stripe_view(kp, vp, bt, 0, L)

    def kern():
        return ops.paged_decode_attention(q, kj, vj, safe, pos,
                                          page_mask=mine, partials=True)

    def plain():
        return ref.paged_decode_attention(q, kj, vj, safe, pos,
                                          page_mask=mine, partials=True)

    ms, plain_ms = time_ms(kern), time_ms(plain)
    nbytes, flops = masked_bytes_flops(q, kj, safe, pos, mine,
                                       B * 16 * (hd + 2))
    b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
    rec = dict(shape="masked partials, stripe 0 of 4, B=8 H=16 Kv=8 hd=128 "
               "pos 575", ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=None,
               owned_slots=int(flops // (4 * 16 * hd)),
               max_abs_err={" ".join(map(str, k)): v
                            for k, v in worst.items()})
    errs = ", ".join(f"H={h} {d} {n} {e:.3g}" for (h, d, n), e in
                     worst.items())
    line = (f"paged_decode_attention page_mask + partials (2 and 4 stripes, "
            f"an empty stripe, pos on page boundaries, NaN in unowned local "
            f"row 0): max abs err [{errs}] (tol fp32 {TOL[torch.float32]}, "
            f"bf16 {TOL[torch.bfloat16]}); stripe 0 of 4 at B=8 H=16 pos "
            f"575 bf16 ({rec['owned_slots']} owned slots): kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"({b_by}, {nbytes / 1e6:.3f} MB), no library call (SDPA takes "
            f"no page mask)")
    return rec, line


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


# the flash kernel at this slice's prefills: gemma2-27b's dense batch (H=32,
# hd 128, scale 1/12, softcap 50; its local layers with the 4096 window,
# its global layers causal) and hubert-xlarge's (H=16, hd 80,
# bidirectional, no softcap)
GEMMA_SCALE = (4608 // 32) ** -0.5
FAMILY_FLASH = [
    ("gemma2-27b local", (4, 4200, 32, 128),
     dict(causal=True, window=4096, scale=GEMMA_SCALE, softcap=50.0)),
    ("gemma2-27b global", (4, 4200, 32, 128),
     dict(causal=True, scale=GEMMA_SCALE, softcap=50.0)),
    ("hubert-xlarge", (4, 1024, 16, 80), dict(causal=False)),
]


# the paged decode of the paged engine's new families (B=8, PAGED_RUN's
# last slot 575): qwen3-14b's 40 query heads over 8 kv heads (G=5, which
# the bf16 kernel pads to 16 tensor-core rows) and minitron-8b's 32 over 8
FAMILY_PAGED = [("qwen3-14b", 40, 8), ("minitron-8b", 32, 8)]
# qwen2-vl-7b's dense decode: 28 query heads over 4 kv heads (G=7) at the
# last slot of its phase 3 run (prompt 512, gen 16)
VL_DECODE = (2, 28, 4, 128, 528)


def check_families(ops, ref):
    """This slice's shapes and modes against the plain versions, timed:
    the flash kernel at FAMILY_FLASH (window, softcap 50 and scale 1/12
    in one launch; hd 80, which pads to 128 columns), the paged decode
    kernel at FAMILY_PAGED (every pos 575, and ragged), decode_attention
    at gemma2's dense decode (B=4, H=32, Kv=16, softcap 50, scale 1/12,
    pos 4231) and at qwen2-vl's (VL_DECODE), and rmsnorm on MLA's latent
    rows (the first 512 columns of each 576-wide row: the wrapper refuses
    the strided view, and the model hands it a contiguous copy).
    Tolerances as check_flash_local (flash), check_paged (paged) and
    check_decode (decode): in bf16 both sides round the output once,
    |kernel - plain| <= 2**-7 |plain| + the fp32 tolerance.  Returns
    ({kernel: [shape records]}, lines)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 11)
    out = {"flash_attention": [], "decode_attention": [], "rmsnorm": [],
           "paged_decode_attention": []}
    lines = []
    ragged = [575, 0, 17, 300, 16, 15, 511, 255]
    for what, H, Kv in FAMILY_PAGED:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            for name, pos in (("ragged", ragged), ("main", [575] * 8)):
                q, kp, vp, bt, p = paged_inputs(8, H, Kv, 128, 16, 36, pos,
                                                dtype, gen)
                err = max_err(ops.paged_decode_attention(q, kp, vp, bt, p),
                              ref.paged_decode_attention(q, kp, vp, bt, p))
                errs[(name, dtype)] = err
                if not err <= TOL[dtype]:
                    fail(f"paged decode {what} H={H} Kv={Kv} {name} {dtype}: "
                         f"max abs err {err}")
        ms = time_ms(lambda: ops.paged_decode_attention(q, kp, vp, bt, p))
        plain_ms = time_ms(lambda: ref.paged_decode_attention(q, kp, vp, bt,
                                                              p))
        b_ms, b_by = bound(*paged_bytes_flops(q, kp, bt, p), torch.bfloat16)
        out["paged_decode_attention"].append(dict(
            shape=f"B=8 H={H} Kv={Kv} hd=128 pos 575 ({what})",
            max_abs_err=errs[("main", torch.bfloat16)], ms=ms,
            plain_ms=plain_ms, library_ms=None, bound_ms=b_ms,
            bound_by=b_by))
        lines.append(
            f"paged_decode_attention at {what}'s B=8 H={H} Kv={Kv} hd=128: "
            f"max abs err " + ", ".join(f"{n} {str(d)[6:]} {x:.3g}"
                                        for (n, d), x in errs.items())
            + f" (tol fp32 {TOL[torch.float32]}, bf16 "
            f"{TOL[torch.bfloat16]}); bf16 kernel {ms:.4f} ms at pos 575, "
            f"plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), no "
            f"library call")
        del q, kp, vp
    for what, shape, kw in FAMILY_FLASH:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = [torch.randn(shape, generator=gen,
                                   device=DEVICE).to(dtype)
                       for _ in range(3)]
            o = ops.flash_attention(q, k, v, **kw).float()
            o_p = ref.flash_attention(q, k, v, **kw).float()
            err = (o - o_p).abs()
            errs[dtype] = float(err.max())
            limit = TOL[torch.float32] + (
                2.0 ** -7 * o_p.abs() if dtype == torch.bfloat16 else 0.0)
            if not within(err, limit):
                fail(f"flash {what} {shape} {kw} {dtype}: max abs err "
                     f"{errs[dtype]} (typical |out| "
                     f"{float(o_p.abs().mean())})")
            del o, o_p, err
            if dtype == torch.float32:
                del q, k, v
                torch.cuda.empty_cache()
        ms = time_ms(lambda: ops.flash_attention(q, k, v, **kw), iters=10)
        plain_ms = time_ms(lambda: ref.flash_attention(q, k, v, **kw),
                           iters=3)
        b_ms, b_by = bound(*flash_bytes_flops(q, kw["causal"],
                                              kw.get("window")),
                           torch.bfloat16)
        lib_ms = None
        if kw.get("softcap") is None and kw.get("window") is None:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = time_ms(lambda: sdpa(qt, kt, vt,
                                          is_causal=kw["causal"]), iters=10)
            del qt, kt, vt
        out["flash_attention"].append(dict(
            name=what, shape=list(shape), window=kw.get("window"),
            softcap=kw.get("softcap"), scale=kw.get("scale"),
            causal=kw["causal"], max_abs_err=errs[torch.bfloat16],
            max_abs_err_fp32=errs[torch.float32], ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
        lines.append(
            f"flash_attention at {what} {shape} {kw}: max abs err fp32 "
            f"{errs[torch.float32]:.3g} (tol {TOL[torch.float32]}), bf16 "
            f"{errs[torch.bfloat16]:.3g} (tol 2**-7 |plain| + "
            f"{TOL[torch.float32]}); bf16 kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            + (f"SDPA {lib_ms:.4f} ms" if lib_ms is not None else
               "no library call (SDPA takes no softcap)"))
        del q, k, v
        torch.cuda.empty_cache()
    # gemma2's dense decode of a global layer: the cache of prompt 4200 +
    # gen 32, read at its last slot
    B, H, Kv, hd, T = 4, 32, 16, 128, 4232
    pos, tol = T - 1, 2e-5
    dkw = dict(scale=GEMMA_SCALE, softcap=50.0)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(B, H, hd, generator=gen, device=DEVICE).to(dtype)
        k, v = (torch.randn(B, T, Kv, hd, generator=gen,
                            device=DEVICE).to(dtype) for _ in range(2))
        for p_ in (0, 4095, pos):
            o = ops.decode_attention(q, k, v, p_, **dkw).float()
            o_p = ref.decode_attention(q, k, v, p_, **dkw).float()
            err = (o - o_p).abs()
            limit = tol + (2.0 ** -7 * o_p.abs()
                           if dtype == torch.bfloat16 else 0.0)
            if not within(err, limit):
                fail(f"decode_attention gemma2 pos {p_} {dtype}: max abs "
                     f"err {float(err.max())}")
            errs[(p_, dtype)] = float(err.max())
    e = q.element_size()
    nb = 2 * q.numel() * e + 2 * B * (pos + 1) * Kv * hd * e
    b_ms, b_by = bound(nb, 4 * B * H * (pos + 1) * hd, torch.bfloat16)
    ms = time_ms(lambda: ops.decode_attention(q, k, v, pos, **dkw))
    plain_ms = time_ms(lambda: ref.decode_attention(q, k, v, pos, **dkw))
    out["decode_attention"].append(dict(
        shape=f"B={B} H={H} Kv={Kv} hd={hd} pos {pos} softcap 50 scale 1/12",
        max_abs_err=errs[(pos, torch.bfloat16)], ms=ms, plain_ms=plain_ms,
        library_ms=None, bound_ms=b_ms, bound_by=b_by))
    lines.append(
        f"decode_attention at gemma2's B={B} H={H} Kv={Kv} hd={hd} T={T}, "
        f"softcap 50, scale 1/12: max abs err "
        + ", ".join(f"pos {p_} {str(d)[6:]} {x:.3g}"
                    for (p_, d), x in errs.items())
        + f" (tol fp32 {tol}, bf16 {tol} + 2**-7 |plain|); bf16 kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
        f"({b_by}), no library call (SDPA takes no softcap)")
    del q, k, v
    # qwen2-vl's dense decode (G=7), beside SDPA
    B, H, Kv, hd, T = VL_DECODE
    pos = T - 1
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(B, H, hd, generator=gen, device=DEVICE).to(dtype)
        k, v = (torch.randn(B, T, Kv, hd, generator=gen,
                            device=DEVICE).to(dtype) for _ in range(2))
        for p_ in (0, 511, pos):
            o = ops.decode_attention(q, k, v, p_).float()
            o_p = ref.decode_attention(q, k, v, p_).float()
            err = (o - o_p).abs()
            limit = tol + (2.0 ** -7 * o_p.abs()
                           if dtype == torch.bfloat16 else 0.0)
            if not within(err, limit):
                fail(f"decode_attention qwen2-vl pos {p_} {dtype}: max abs "
                     f"err {float(err.max())}")
            errs[(p_, dtype)] = float(err.max())
    e = q.element_size()
    nb = 2 * q.numel() * e + 2 * B * (pos + 1) * Kv * hd * e
    b_ms, b_by = bound(nb, 4 * B * H * (pos + 1) * hd, torch.bfloat16)
    ms = time_ms(lambda: ops.decode_attention(q, k, v, pos))
    plain_ms = time_ms(lambda: ref.decode_attention(q, k, v, pos))
    qt = q[:, :, None]
    kt, vt = (t[:, :pos + 1].transpose(1, 2) for t in (k, v))
    lib_ms = time_ms(lambda: sdpa(qt, kt, vt, enable_gqa=True))
    out["decode_attention"].append(dict(
        shape=f"B={B} H={H} Kv={Kv} hd={hd} pos {pos} (qwen2-vl-7b)",
        max_abs_err=errs[(pos, torch.bfloat16)], ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by))
    lines.append(
        f"decode_attention at qwen2-vl's B={B} H={H} Kv={Kv} hd={hd} T={T}: "
        f"max abs err " + ", ".join(f"pos {p_} {str(d)[6:]} {x:.3g}"
                                    for (p_, d), x in errs.items())
        + f" (tol fp32 {tol}, bf16 {tol} + 2**-7 |plain|); bf16 kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA (enable_gqa) "
        f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    del q, k, v, kt, vt
    # MLA's kv_a_norm: a decode step of 8 and the dense prefill of 8 x 512
    for N in (8, 4096):
        scale = torch.randn(512, generator=gen, device=DEVICE)
        lat = torch.randn(N, 576, generator=gen,
                          device=DEVICE).to(torch.bfloat16)
        row = lat[:, :512]
        try:
            ops.rmsnorm(row, scale)
            fail("rmsnorm took a strided row")
        except ValueError:
            pass
        o = ops.rmsnorm(row.contiguous(), scale).float()
        o_p = ref.rmsnorm(row, scale).float()
        err = (o - o_p).abs()
        if not within(err, 2e-5 + 2.0 ** -7 * o_p.abs()):
            fail(f"rmsnorm MLA latent ({N}, 512 of 576): max abs err "
                 f"{float(err.max())}")
        ms = time_ms(lambda: ops.rmsnorm(row.contiguous(), scale))
        b_ms, b_by = bound(2 * 2 * N * 512 + 4 * 512, 3 * N * 512,
                           torch.bfloat16)
        out["rmsnorm"].append(dict(
            shape=[N, 512], strided_from=576, max_abs_err=float(err.max()),
            ms=ms, plain_ms=time_ms(lambda: ref.rmsnorm(row, scale)),
            bound_ms=b_ms, bound_by=b_by))
        lines.append(
            f"rmsnorm at MLA's latent rows ({N}, 512 of 576) bf16: the "
            f"wrapper refuses the strided view; on the contiguous copy max "
            f"abs err {float(err.max()):.3g} (tol 2e-5 + 2**-7 |plain|), "
            f"copy and kernel {ms:.4f} ms, plain (strided) "
            f"{out['rmsnorm'][-1]['plain_ms']:.4f} ms, bound {b_ms:.5f} ms")
    torch.cuda.empty_cache()
    return out, lines


# the three configs whose parameters are bf16: their products take the
# tensor cores (``modules.matmul`` -> ``product.Product``, cuBLAS's bf16 x
# bf16 -> fp32 GEMM) on the card; every other config's are fp32 x bf16 or
# fp32 and keep the promotion, as the reference does
PRODUCT_ARCHS = ("gemma2-27b", "grok-1-314b", "deepseek-v3-671b")


def _named_leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _named_leaves(v, path)
    else:
        yield path.lstrip("/"), tree


def product_shapes():
    """(arch, weight names, K, N, tied, row counts): each 2-D bf16 weight
    shape of the three bf16-parameter configs at phase 3's cuts, once,
    at phase 3's decode and prefill rows (the head's prefill is the last
    row of each prompt); the router's product (fp32 in the reference
    too) and the embedding's gather aside, the tied table as the head it
    is, (D, V) read transposed in place."""
    from repro_torch.configs import get_config
    from repro_torch.weights import init_params
    out = []
    for arch in PRODUCT_ARCHS:
        cfg = get_config(arch).replace(**CUTS[arch])
        run = DENSE_RUNS[arch]
        B, BS = run["batch"], run["batch"] * run["prompt_len"]
        tied = cfg.tie_embeddings and cfg.embed_inputs
        shapes = {}
        for name, t in _named_leaves(init_params(cfg, None, "meta")):
            leaf = name.rsplit("/", 1)[-1]
            if t.ndim != 2 or t.dtype != torch.bfloat16 or "router" in leaf \
                    or (leaf == "embed_table" and not tied):
                continue
            head = leaf in ("embed_table", "head_w")
            K, N = t.shape[::-1] if leaf == "embed_table" else t.shape
            key = (K, N, leaf == "embed_table", (B, B) if head else (B, BS))
            shapes.setdefault(key, []).append(leaf)
        out += [(arch, sorted(set(names)), K, N, t, rows)
                for (K, N, t, rows), names in shapes.items()]
    return out


def _bf16_units(got, want, slack):
    """How far |got - want| exceeds ``slack``, in bf16 units in the last
    place at the larger of the two (normal numbers): two bf16 roundings
    of fp32 values ``slack`` apart differ by at most slack + one unit."""
    v = torch.maximum(got.float().abs(), want.float().abs()).clamp_min(
        2.0 ** -126)
    unit = torch.ldexp(torch.ones_like(v), torch.frexp(v).exponent - 8)
    return ((got.float() - want.float()).abs() - slack).clamp_min(0) / unit


def check_product():
    """``modules.matmul`` on two bf16 operands (the tensor cores, fp32
    accumulation) against the promoted product it replaced, at every
    shape ``product_shapes`` lists: the fp32 output within the bound on
    two fp32 summation orders of the same K products, 2 K 2**-24 (|x| @
    |w|) elementwise; the bf16 output within one bf16 unit beyond that
    bound (where the sum cancels, the order moves the bf16 rounding by
    the fp32 difference itself).  Times: the
    route's fp32 product, the promotion (both operands converted, then an
    fp32 GEMM on the CUDA cores: TF32 is off), and the bound (the bf16
    operands read once, the fp32 output written once; 2 M K N at the
    bf16 rate)."""
    from repro_torch.models import modules as nn
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    recs, lines = [], []
    for arch, names, K, N, tied, rows in product_shapes():
        w = torch.randn(N if tied else K, K if tied else N, generator=gen,
                        device=DEVICE).mul_(K ** -0.5).bfloat16()
        if tied:
            w = w.T
        for M in sorted(set(rows)):
            x = torch.randn(M, K, generator=gen, device=DEVICE).bfloat16()
            got32 = nn.matmul(x, w, torch.float32)
            want32 = x.float() @ w.float()
            lim = (x.float().abs() @ w.float().abs()).mul_(
                2 * K * 2.0 ** -24)
            ratio = float(((got32 - want32).abs() / lim.clamp_min(
                2.0 ** -126)).max())
            ok32 = within((got32 - want32).abs(), lim)
            err32 = max_err(got32, want32)
            del got32
            units = float(_bf16_units(nn.matmul(x, w), want32.bfloat16(),
                                      lim).max())
            del want32, lim
            ms = time_ms(lambda: nn.matmul(x, w, torch.float32))
            plain_ms = time_ms(lambda: x.float() @ w.float(), iters=5)
            b_ms, by = bound(2 * M * K + 2 * K * N + 4 * M * N,
                             2 * M * K * N, torch.bfloat16)
            rec = dict(arch=arch, weights=names, M=M, K=K, N=N, tied=tied,
                       max_abs_err_fp32=err32, err_over_bound=ratio,
                       bf16_units_past_bound=units, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=by)
            recs.append(rec)
            lines.append(
                f"product {arch} {'/'.join(names)} ({M}x{K})@({K}x{N})"
                f"{' tied, read transposed' if tied else ''}: fp32 err "
                f"{err32:.3g} ({ratio:.3g} of its order bound), bf16 "
                f"{units:.3g} units past it; route {ms:.4f} ms, promoted "
                f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by})")
            if not (ok32 and units <= 1.0):
                fail(lines[-1])
            del x
        del w
    torch.cuda.empty_cache()
    for rec, line in check_product_grads():
        recs.append(rec)
        lines.append(line)
    return recs, lines


def _grads(fn, x, w, g):
    """fn(x, w) and the gradients of x and w under the cotangent g."""
    x, w = x.detach().requires_grad_(), w.detach().requires_grad_()
    y = fn(x, w)
    y.backward(g)
    return y.detach(), x.grad, w.grad


def check_product_grads():
    """``Product``'s forward and backward on the card against autograd
    of the promoted product on the same inputs, one case a kind of
    product: 2-D (gemma2's w_gate, prefill rows, x of shape (1, M, K)),
    the tied head (gemma2's (V, D) table, read transposed in place) and
    grouped (grok's expert up-projections through ``moe._grouped`` under
    impl="blocked", the trainer's; its bf16 output through
    ``modules.matmul``), each with a bf16 and an fp32 output and so a
    bf16 and an fp32 cotangent.  Gates as ``check_product``'s: every
    fp32 value within the order bound of its sum (K products for y, N
    for dx, M for dw), every bf16 one within one bf16 unit beyond it.
    Yields (record, line)."""
    from repro_torch.configs import get_config
    from repro_torch.models import modules as nn, moe
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 1)
    blocked = get_config("grok-1-314b").replace(impl="blocked")

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=DEVICE).mul_(
            scale).bfloat16()

    def mm(a, b):
        return (torch.bmm if b.ndim == 3 else torch.matmul)(a, b)

    cases = (
        ("2-D gemma2 w_gate", rand(1, 4096, 4608),
         rand(4608, 36864, scale=4608 ** -0.5), lambda w: w,
         lambda od: lambda x, w: nn.matmul(x, w, od)),
        ("tied head gemma2 embed_table", rand(1, 512, 4608),
         rand(256000, 4608, scale=4608 ** -0.5), lambda t: t.T,
         lambda od: lambda x, t: nn.matmul(x, t.T, od)),
        ("grouped grok e_up", rand(8, 256, 6144),
         rand(8, 6144, 32768, scale=6144 ** -0.5), lambda w: w,
         lambda od: ((lambda x, w: moe._grouped(blocked, x, w))
                     if od == torch.float32
                     else (lambda x, w: nn.matmul(x, w)))),
    )
    for kind, x, leaf, as_w, route in cases:
        for od in (torch.bfloat16, torch.float32):
            fn = route(od)
            w = as_w(leaf)
            M, K, N = x.shape[-2], x.shape[-1], w.shape[-1]
            g = torch.randn(*x.shape[:-1], N, generator=gen,
                            device=DEVICE).to(od)
            got = _grads(fn, x, leaf, g)
            want = _grads(lambda a, b: mm(a.float(), as_w(b).float()).to(
                od), x, leaf, g)
            xa, wa, ga = x.float().abs(), w.float().abs(), g.float().abs()
            xs = xa.reshape(-1, K) if w.ndim == 2 else xa
            gs = ga.reshape(-1, N) if w.ndim == 2 else ga
            rows = xs.shape[-2]
            lims = (mm(xa, wa).mul_(2 * K * 2.0 ** -24),
                    mm(ga, wa.transpose(-1, -2)).mul_(2 * N * 2.0 ** -24),
                    mm(xs.transpose(-1, -2), gs).mul_(
                        2 * rows * 2.0 ** -24))
            del xa, wa, ga, xs, gs
            worst = []
            for name, a, b, lim in zip(("y", "dx", "dw"), got, want, lims):
                if name == "dw":
                    a, b = as_w(a), as_w(b)
                if a.dtype == torch.float32:
                    worst.append((name, float(((a - b).abs() / lim.clamp_min(
                        2.0 ** -126)).max()), "of its order bound",
                        within((a - b).abs(), lim)))
                else:
                    u = float(_bf16_units(a, b, lim).max())
                    worst.append((name, u, "bf16 units past its bound",
                                  u <= 1.0))
            del got, want, lims
            ms = time_ms(lambda: _grads(fn, x, leaf, g), iters=5)
            plain_ms = time_ms(lambda: _grads(
                lambda a, b: mm(a.float(), as_w(b).float()).to(od), x, leaf,
                g), iters=3)
            rec = dict(kind=kind, x=list(x.shape), w=list(w.shape), M=M,
                       out=str(od).split(".")[-1],
                       errors={n: v for n, v, _, _ in worst},
                       ms=ms, plain_ms=plain_ms)
            line = (f"product backward {kind}: x {tuple(x.shape)} @ w "
                    f"{tuple(w.shape)}, {rec['out']} output and cotangent: "
                    + ", ".join(f"{n} {v:.3g} {what}"
                                for n, v, what, _ in worst)
                    + f"; forward and backward {ms:.3f} ms, promoted "
                    f"{plain_ms:.3f} ms")
            if not all(ok for *_, ok in worst):
                fail(line)
            yield rec, line
            del g
        del x, leaf
        torch.cuda.empty_cache()


# the attention einsums of ``check_einsum`` (``attention._einsum32`` ->
# ``product.einsum32``: two bf16 operands as one bf16 x bf16 -> fp32
# tensor-core GEMM) at the served and trained shapes: (what, equation,
# the operands' shapes, each a slice of its first ``S`` rows along axis 1
# where the caller slices one).  The trainer's block pair: qwen3-1.7b at
# phase 6's B=4, S=2048, 512 x 1024 blocks, 16 heads of 128; DeepSeek's
# MLA prefill at phase 3's batch 8 x 512 (one 512 block, q/k 192, v
# padded to 192); its absorbed decode (kv_b's w_uk and w_uv views, the
# latent scores over phase 3's 576 slots); one 128-token suffix chunk
# of qwen3-1.7b over its 36 pages of 16 (8 kv heads, groups of 2)
TRAIN_PAIR = (4, 2048, 16, 128, 512, 1024)
MLA_PREFILL = (8, 512, 128, 192)
MLA_DECODE = (8, 576)
SUFFIX_CHUNK = (128, 576, 8, 2, 128)
# gemma2-27b's softcapped split-T decode partial: a 2-position model
# group's time block of its 4,232 slots (phase 3's prompt + gen), all
# valid
GEMMA_PARTIAL = dict(B=4, H=32, Kv=16, hd=128, Tl=2116, softcap=50.0)


def einsum_cases(gen):
    """Yields (what, equation, a, b, trained): bf16 operands on the card
    laid out as the path holds them (the trainer's blocks slices of the
    sequence, MLA's w_uk / w_uv strided views of kv_b)."""
    from repro_torch.configs import get_config
    from repro_torch.models import mla

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device=DEVICE).bfloat16()
    B, S, H, hd, bq, bkv = TRAIN_PAIR
    q, k, v = (rand(B, S, H, hd) for _ in range(3))
    yield ("qwen3-1.7b trainer block, scores", "bqhd,bthd->bhqt",
           q[:, :bq], k[:, :bkv], True)
    yield ("qwen3-1.7b trainer block, P.V", "bhqt,bthd->bhqd",
           rand(B, H, bq, bkv), v[:, :bkv], True)
    del q, k, v
    B, S, H, d = MLA_PREFILL
    q, k = rand(B, S, H, d), rand(B, S, H, d)
    yield ("DeepSeek-V3 MLA prefill, scores", "bqhd,bthd->bhqt", q, k, False)
    del q
    yield ("DeepSeek-V3 MLA prefill, P.V", "bhqt,bthd->bhqd",
           rand(B, H, S, S), k, False)
    del k
    cfg = get_config("deepseek-v3-671b")
    m, H = cfg.mla, cfg.n_heads
    B, T = MLA_DECODE
    kv_b = rand(m.kv_lora_rank, H * (m.qk_nope_head_dim + m.v_head_dim))
    w_uk, w_uv = mla._kv_b_split({"kv_b": kv_b}, cfg)
    ckv = rand(B, T, m.kv_lora_rank)
    yield ("DeepSeek-V3 decode, absorb q (w_uk view)", "bhd,lhd->bhl",
           rand(B, H, m.qk_nope_head_dim), w_uk, False)
    yield ("DeepSeek-V3 decode, latent scores", "bhl,btl->bht",
           rand(B, H, m.kv_lora_rank), ckv, False)
    yield ("DeepSeek-V3 decode, rope scores", "bhd,btd->bht",
           rand(B, H, m.qk_rope_head_dim), rand(B, T, m.qk_rope_head_dim),
           False)
    yield ("DeepSeek-V3 decode, P.latent", "bht,btl->bhl",
           rand(B, H, T), ckv, False)
    yield ("DeepSeek-V3 decode, out (w_uv view)", "bhl,lhv->bhv",
           rand(B, H, m.kv_lora_rank), w_uv, False)
    del kv_b, ckv, w_uk, w_uv
    W, T, Kv, G, hd = SUFFIX_CHUNK
    kp, vp = rand(1, T, Kv, hd), rand(1, T, Kv, hd)
    yield ("qwen3-1.7b suffix chunk, scores", "bwkgd,btkd->bkgwt",
           rand(1, W, Kv * G, hd).reshape(1, W, Kv, G, hd), kp, False)
    yield ("qwen3-1.7b suffix chunk, P.V", "bkgwt,btkd->bwkgd",
           rand(1, Kv, G, W, T), vp, False)


def _einsum_bound(eq, a, b):
    """The bound on two fp32 sums of ``eq``'s K exact products in
    different orders, 2 K 2**-24 (|a| . |b|) elementwise, and K."""
    ins, out = eq.split("->")
    ia, ib = ins.split(",")
    size = dict(zip(ia, a.shape))
    K = int(np.prod([size[c] for c in ia if c in ib and c not in out]))
    return torch.einsum(eq, a.float().abs(), b.float().abs()).mul_(
        2 * K * 2.0 ** -24), K


def _einsum_grads(fn, a, b, g):
    """fn(a, b), and the gradients of a and b under the cotangent g."""
    a, b = a.detach().requires_grad_(), b.detach().requires_grad_()
    y = fn(a, b)
    y.backward(g)
    return y.detach(), a.grad, b.grad


def check_einsum():
    """The attention's einsum (``attention._einsum32``) on two bf16
    operands (the tensor cores, fp32 accumulation) against the promoted
    einsum it replaced, at every case of ``einsum_cases``: the fp32
    output within the bound on two fp32 summation orders of the same K
    products, 2 K 2**-24 (|a| . |b|).  At the trainer's block pair also
    forward and backward under the fp32 cotangent the attention gives
    it, against the promoted einsum's autograd: each bf16 gradient
    within one bf16 unit beyond the order bound of its sum.  Then
    gemma2-27b's softcapped split-T decode partial (``_decode_partial``)
    against itself with the einsums promoted (``_check_decode_partial``).
    Times: the route, the promotion (both operands converted, then the
    einsum on the CUDA cores: TF32 is off), and the bound (the bf16
    operands read once, the fp32 output written once; 2 K a product at
    the bf16 rate).  Returns (records, lines)."""
    from repro_torch.models import attention
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 5)
    recs, lines = [], [f"attention einsums on {gpu_info()}"]
    for what, eq, a, b, trained in einsum_cases(gen):
        got = attention._einsum32(eq, a, b)
        want = torch.einsum(eq, a.float(), b.float())
        lim, K = _einsum_bound(eq, a, b)
        ok = got.dtype == torch.float32 and within((got - want).abs(), lim)
        ratio = float(((got - want).abs() / lim.clamp_min(2.0 ** -126))
                      .max())
        err = max_err(got, want)
        n_out = got.numel()
        del got, want, lim
        ms = time_ms(lambda: attention._einsum32(eq, a, b))
        plain_ms = time_ms(lambda: torch.einsum(eq, a.float(), b.float()),
                           iters=5)
        b_ms, by = bound(2 * a.numel() + 2 * b.numel() + 4 * n_out,
                         2 * n_out * K, torch.bfloat16)
        rec = dict(what=what, eq=eq, a=list(a.shape), b=list(b.shape),
                   K=K, max_abs_err=err, err_over_bound=ratio, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=by)
        line = (f"einsum {what} {eq} {tuple(a.shape)} x {tuple(b.shape)}: "
                f"fp32 err {err:.3g} ({ratio:.3g} of its order bound); "
                f"route {ms:.4f} ms, promoted {plain_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({by})")
        if not ok:
            fail(line)
        if trained:
            line += "; " + _check_einsum_grads(rec, eq, a, b, gen)
        recs.append(rec)
        lines.append(line)
        del a, b
        torch.cuda.empty_cache()
    rec, line = _check_decode_partial(gen)
    recs.append(rec)
    lines.append(line)
    torch.cuda.empty_cache()
    return recs, lines


def _check_einsum_grads(rec, eq, a, b, gen):
    """Forward and backward of the trainer's einsum under an fp32
    cotangent, the route against the promoted einsum's autograd: da =
    einsum(out, b -> a), db = einsum(a, out -> b), each bf16 within one
    bf16 unit beyond the order bound of its fp32 sum.  Fills ``rec``;
    returns the line's part."""
    from repro_torch.models import attention
    ins, out = eq.split("->")
    ia, ib = ins.split(",")
    size = dict(zip(ia, a.shape)) | dict(zip(ib, b.shape))
    g = torch.randn([size[c] for c in out], generator=gen, device=DEVICE)
    got = _einsum_grads(lambda x, w: attention._einsum32(eq, x, w), a, b, g)
    want = _einsum_grads(lambda x, w: torch.einsum(eq, x.float(),
                                                   w.float()), a, b, g)
    units = {}
    for name, x, y, (e2, l, r) in (
            ("da", got[1], want[1], (f"{out},{ib}->{ia}", g, b)),
            ("db", got[2], want[2], (f"{ia},{out}->{ib}", a, g))):
        lim, _ = _einsum_bound(e2, l, r)
        units[name] = float(_bf16_units(x, y, lim).max())
        del lim
    del got, want
    ms = time_ms(lambda: _einsum_grads(
        lambda x, w: attention._einsum32(eq, x, w), a, b, g), iters=5)
    plain_ms = time_ms(lambda: _einsum_grads(
        lambda x, w: torch.einsum(eq, x.float(), w.float()), a, b, g),
        iters=3)
    rec.update(grad_bf16_units_past_bound=units, grad_ms=ms,
               grad_plain_ms=plain_ms)
    part = (f"forward and backward (fp32 cotangent) {ms:.3f} ms, promoted "
            f"{plain_ms:.3f} ms, gradients " + ", ".join(
                f"{n} {u:.3g}" for n, u in units.items())
            + " bf16 units past their order bounds")
    if not all(u <= 1.0 for u in units.values()):
        fail(part)
    return part


def _check_decode_partial(gen):
    """gemma2-27b's split-T decode partial (``attention._decode_partial``,
    softcap 50, scale 1/12, 32 query heads on 16 kv heads) on the route
    against itself with ``product.einsum32`` swapped for the promotion.
    Each side rounds its probabilities p = exp(s - m) <= 1 to bf16 before
    P.V, so a p one rounding apart may round to the next bf16 value:
    m within the scores' order bound (and a few fp32 roundings after the
    sum); l = sum p within 2 that bound + (2 Tl + 4) 2**-24 of itself;
    acc within that relative bound of sum p |v|, plus one bf16 unit of
    every p (2**-7 p) times |v|.  Returns (record, line)."""
    from repro_torch.kernels import product
    from repro_torch.models import attention
    c = GEMMA_PARTIAL
    B, H, Kv, hd, Tl = c["B"], c["H"], c["Kv"], c["hd"], c["Tl"]
    G = H // Kv
    q = torch.randn(B, 1, H, hd, generator=gen, device=DEVICE).bfloat16()
    k, v = (torch.randn(B, Tl, Kv * hd, generator=gen, device=DEVICE
                        ).bfloat16() for _ in range(2))
    valid = torch.ones(Tl, dtype=torch.bool, device=DEVICE)
    kw = dict(scale=GEMMA_SCALE, softcap=c["softcap"], n_kv=Kv)

    def plain():
        route = product.einsum32
        product.einsum32 = lambda eq, a, b: torch.einsum(eq, a.float(),
                                                         b.float())
        try:
            return attention._decode_partial(q, k, v, valid, **kw)
        finally:
            product.einsum32 = route
    got = attention._decode_partial(q, k, v, valid, **kw)
    want = plain()
    qg, kk = q.float().reshape(B, Kv, G, hd), k.float().reshape(B, Tl, Kv,
                                                               hd)
    s = torch.einsum("bkgd,btkd->bkgt", qg, kk) * GEMMA_SCALE
    s_bound = (torch.einsum("bkgd,btkd->bkgt", qg.abs(), kk.abs())
               * (2 * hd * 2.0 ** -24 * GEMMA_SCALE)
               + 8 * 2.0 ** -24 * s.abs()).amax(-1)
    rel = 2 * s_bound + (2 * Tl + 4) * 2.0 ** -24
    pv = torch.einsum("bkgt,btkd->bkgd", torch.exp(
        torch.tanh(s / c["softcap"]) * c["softcap"] - want[0][..., None]),
        v.float().abs().reshape(B, Tl, Kv, hd))
    limits = (s_bound, rel * want[1], (rel[..., None] + 2.0 ** -7) * pv)
    del s, qg, kk
    errs = [max_err(x, y) for x, y in zip(got, want)]
    ratios = [float(((x - y).abs() / lim.clamp_min(2.0 ** -126)).max())
              for x, y, lim in zip(got, want, limits)]
    ok = all(within((x - y).abs(), lim)
             for x, y, lim in zip(got, want, limits))
    ms = time_ms(lambda: attention._decode_partial(q, k, v, valid, **kw))
    plain_ms = time_ms(plain, iters=5)
    n_out = B * H * (hd + 2)
    b_ms, by = bound(2 * (q.numel() + k.numel() + v.numel()) + 4 * n_out,
                     4 * B * H * Tl * hd, torch.bfloat16)
    rec = dict(what="gemma2-27b decode partial", shape=[B, H, Kv, hd, Tl],
               max_abs_err=dict(zip(("m", "l", "acc"), errs)),
               err_over_bound=dict(zip(("m", "l", "acc"), ratios)),
               ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by)
    line = (f"gemma2-27b softcapped decode partial (B={B}, H={H}, Kv={Kv}, "
            f"hd {hd}, {Tl} slots): m, l, acc within "
            + ", ".join(f"{r:.3g}" for r in ratios) + " of their bounds; "
            f"route {ms:.4f} ms, promoted {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({by})")
    if not ok:
        fail(line)
    return rec, line


# the experts' hidden width in ``check_combine``: the combine adds (T, D)
# rows and never sees it; the CPU run at grok's 32768 would take minutes
COMBINE_F = 128


def combine_inputs(cfg, T, gen):
    """Seeded tokens (T, D) bf16, router (D, E) fp32 and expert weights
    (E, D, F), (E, F, D) bf16 on the CPU whose every product before the
    MoE combine is exact, so that the card and the CPU give the combine
    the same bits and only its order of adds can tell them apart.  Token
    t holds 1 at dims ids[t] of 0..E-1 (its k experts, a router weight of
    30 there: logits 30 or 0, so the chosen scores are exactly 1.0 under
    sigmoid and 0.5 under softmax, and each weight exactly 1/k), 1 at
    dim E, and values of spread exponents above it; e_gate reads dim E
    times 32 (silu and gelu of 32 are 32), every column of e_up and
    e_down reads one row (one bf16 x bf16 product: exact in fp32).  The
    expert rows then hold bf16 products of spread magnitude, which the
    k weighted adds of a token round in an order-dependent way (in fp32
    the rounding reaches the output; grok's two adds commute)."""
    E, D, F, k = cfg.moe.n_experts, cfg.d_model, COMBINE_F, cfg.moe.top_k

    def spread(*shape):
        return (torch.randn(*shape, generator=gen) * torch.exp2(
            torch.randint(-6, 7, shape, generator=gen).float())).bfloat16()

    ids = torch.rand(T, E, generator=gen).topk(k, dim=-1).indices
    x = spread(T, D)
    x[:, :E + 1] = 0
    x.scatter_(1, ids, 1.0)
    x[:, E] = 1
    router = torch.zeros(D, E)
    router[torch.arange(E), torch.arange(E)] = 30.0
    e_gate = torch.zeros(E, D, F, dtype=torch.bfloat16)
    e_gate[:, E, :] = 32
    e_up = torch.zeros(E, D, F, dtype=torch.bfloat16).scatter_(
        1, torch.randint(E + 1, D, (E, 1, F), generator=gen),
        spread(E, 1, F))
    e_down = torch.zeros(E, F, D, dtype=torch.bfloat16).scatter_(
        1, torch.randint(0, F, (E, 1, D), generator=gen), spread(E, 1, D))
    return x, router, e_gate, e_up, e_down


def check_combine():
    """The MoE combine through the path the engines run, ``moe.local_moe``
    (one expert group: ``moe.combine``; several: ``moe.add_group``) and
    EP's ``moe._local_moe_ep`` (the second of two halves of the
    experts), at grok-1's and DeepSeek-V3's d_model, experts and top-k
    and phase 3's decode and prefill token counts, on ``combine_inputs``
    (the hidden width cut to COMBINE_F): on the card twice under
    impl="pallas" (the served path, ``moe_gemm``) and once under
    impl="blocked" (the trainer's, ``modules.matmul``), and once on the
    CPU, where every add runs in order; all four equal bit for bit, with
    bf16 tokens and weights (the engines') and with fp32 ones (the fp32
    sum unrounded in the output).  Times the card's bf16 ``local_moe``
    beside one ``index_add_`` of its weighted rows, the unordered
    combine it replaced."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    recs, lines = [], []
    for arch in ("grok-1-314b", "deepseek-v3-671b"):
        base = get_config(arch)
        base = base.replace(moe=dataclasses.replace(base.moe,
                                                 d_ff_expert=COMBINE_F))
        E, D, k = base.moe.n_experts, base.d_model, base.moe.top_k
        run = DENSE_RUNS[arch]
        for T in (run["batch"], run["batch"] * run["prompt_len"]):
            C = moe.capacity(base, T)
            n_g = moe._group_count(E, C, D)
            inputs = combine_inputs(base, T, torch.Generator().manual_seed(
                SEED))
            on = {(d, dt): [t.to(d) if t.dtype == torch.float32 else
                            t.to(d, dt) for t in inputs]
                  for d in (DEVICE, "cpu")
                  for dt in (torch.bfloat16, torch.float32)}
            for ep in (False, True):
                def run_on(dev, impl, dt=torch.bfloat16):
                    cfg = base.replace(impl=impl)
                    x, router, e_gate, e_up, e_down = on[dev, dt]
                    if not ep:
                        return moe.local_moe(cfg, x, router, e_gate, e_up,
                                             e_down)[0]
                    h = slice(E // 2, E)
                    return moe._local_moe_ep(cfg, x, router, e_gate[h],
                                             e_up[h], e_down[h], 1)[0]
                equal = live = True
                for dt in (torch.bfloat16, torch.float32):
                    outs = [run_on(DEVICE, "pallas", dt),
                            run_on(DEVICE, "pallas", dt),
                            run_on(DEVICE, "blocked", dt)]
                    cpu = run_on("cpu", "blocked", dt)
                    equal &= all(torch.equal(o.cpu(), cpu) for o in outs)
                    live &= bool(torch.isfinite(cpu).all()) and \
                        bool((cpu != 0).any())
                    del outs, cpu
                ms = time_ms(lambda: run_on(DEVICE, "pallas"))
                rows = torch.randn(E * C, D, device=DEVICE)
                st = torch.randint(0, T + 1, (E * C,), device=DEVICE)
                plain_ms = time_ms(lambda: torch.zeros(
                    (T + 1, D), device=DEVICE).index_add_(0, st, rows))
                del rows, st
                name = "_local_moe_ep (experts E/2..E)" if ep \
                    else "local_moe"
                rec = dict(arch=arch, path=name, T=T, C=C,
                           groups=1 if ep else n_g, top_k=k, equal=equal,
                           ms=ms, index_add_ms=plain_ms)
                recs.append(rec)
                lines.append(
                    f"MoE combine {arch} {name} T={T} top-{k} ({E} experts "
                    f"x C={C}, {rec['groups']} group"
                    f"{'s' * (rec['groups'] > 1)}, hidden {COMBINE_F}), bf16 "
                    f"and fp32: card twice (pallas), once (blocked) and CPU "
                    f"{'equal bit for bit' if equal else 'DIFFER'}; "
                    f"{ms:.4f} ms (one unordered index_add_ of its "
                    f"{E * C} rows {plain_ms:.4f} ms)")
                if not (equal and live):
                    fail(lines[-1] + ("" if live else "; output zero or "
                                      "not finite"))
            del on, inputs
    torch.cuda.empty_cache()
    return recs, lines


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
# up/gate projection, D=32768, F=6144 its down projection; then
# DeepSeek-V3's: a decode step of 8 (C=8, all 256 experts in one launch)
# and one expert group of 16 of the dense engine's prefill of 8 x 512
# tokens (C=160, 16 groups)
MOE_SHAPES = [("dense prefill up", 4, 1280, 6144, 32768),
              ("dense prefill down", 4, 1280, 32768, 6144),
              ("paged prefill up", 8, 160, 6144, 32768),
              ("paged prefill down", 8, 160, 32768, 6144),
              ("decode up", 8, 8, 6144, 32768),
              ("decode down", 8, 8, 32768, 6144),
              ("deepseek decode up", 256, 8, 7168, 2048),
              ("deepseek decode down", 256, 8, 2048, 7168),
              ("deepseek prefill up", 16, 160, 7168, 2048),
              ("deepseek prefill down", 16, 160, 2048, 7168)]
# edge and operand-type cases, (E, C, D, F), x, w and out dtypes: ragged
# C, D and F (the fp32-core path when D or F is not a multiple of 8),
# fp32, and mixed both ways (the phase 4 decode GEMMs of grok and
# DeepSeek are fp32 x bf16); then
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
             ((256, 8, 7168, 2048), torch.float32, torch.bfloat16,
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
                           earlier_ms=EARLIER_MS.get(f"moe_gemm {what}"),
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
              f"control {r['control_rel_err']:.3g}); kernel {r['ms']:.4f} ms"
              + (f" (earlier design {r['earlier_ms']} ms)"
                 if r["earlier_ms"] else "") + ", plain "
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
    cases += [((3, 2 * G, 2, d, 77), 60, None)
              for G in (1, 4, 5, 6, 7, 8, 12, 16) for d in (16, 64, 256)]
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
            f"G in {{1,4,5,6,7,8,12,16}} x hd in {{16,64,256}} at T=77 within "
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
# decode step (8 x 16 heads of 128), and grok's dense prefill (8 x 512);
# then DeepSeek's decode rows (7168) and MLA's q-latent norm over its
# dense prefill of 8 x 512 (1536), and gemma2's decode rows (4608)
RMS_SHAPES = [(8, 6144), (8, 2048), (4, 2560), (128, 128), (4096, 6144),
              (8, 7168), (4096, 1536), (4, 4608)]
# the paged engine's suffix-body widths on qwen3: verify windows (4, 16),
# a prefix hit's 64-token suffix, a 128-token prefill chunk
SUFFIX_WIDTHS = (4, 16, 64, 128)
# qwen3's q and k rows of one layer (16 and 8 heads of 128): a decode step
# of 8 sequences, a 512-token prefill and each suffix-body width
QK_SHAPES = [((8, 1, 16, 128), (8, 1, 8, 128)),
             ((1, 512, 16, 128), (1, 512, 8, 128))] + [
    ((1, w, 16, 128), (1, w, 8, 128)) for w in SUFFIX_WIDTHS]


def check_rmsnorm(ops, ref):
    """Both sides compute in fp32 and round once: fp32 within 2e-5 (the
    reference's), bf16 within 2e-5 + one bf16 rounding, 2**-7 |plain|.
    The fused entry points against the unfused kernel path, bit for bit:
    ``add_rmsnorm(x, d)`` against ``x + d`` then ``rmsnorm`` at every
    shape and dtype, ``qk_rmsnorm`` against two ``rmsnorm`` launches at
    qwen3's q and k shapes (and against the plain version, as above).
    Times beside a launch floor: one PyTorch
    elementwise kernel on one element through the same ``time_ms``."""
    import torch.nn.functional as F
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 9)
    worst, exact = {}, []
    for N, D in RMS_SHAPES + [(w, 2048) for w in SUFFIX_WIDTHS] + [
            (3, 64), (5, 16), (2, 8192)]:
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
            for o, x, sc in ((qo, q, sq), (ko, k, sk)):
                o_p = ref.rmsnorm(x, sc).float()
                err = (o.float() - o_p).abs()
                limit = 2e-5 + (2.0 ** -7 * o_p.abs()
                                if dtype == torch.bfloat16 else 0.0)
                if not within(err, limit):
                    fail(f"qk_rmsnorm {tuple(x.shape)} {dtype}: max abs err "
                         f"{float(err.max())} against the plain rmsnorm")
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
            earlier_ms=EARLIER_MS.get(f"rmsnorm {(N, D)}"),
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
             f"two rmsnorm launches, and within the rmsnorm tolerance of "
             f"the plain version, at {QK_SHAPES} x {{fp32,bf16}}; launch "
             f"floor (one elementwise kernel on one element) "
             f"{floor_ms:.4f} ms"]
    lines += [f"rmsnorm {tuple(t['shape'])} bf16: kernel {t['ms']:.4f} ms "
              + (f"(earlier design {t['earlier_ms']} ms; launch floor "
                 if t["earlier_ms"] else "(launch floor ")
              + f"{floor_ms:.4f}), plain {t['plain_ms']:.4f} ms, F.rms_norm "
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
    "deepseek-v3-671b": dict(requests=16, batch=8, prompt_len=512, gen=64),
    # prompts past the 4096 window: the local layers' rings wrap
    "gemma2-27b": dict(requests=8, batch=4, prompt_len=4200, gen=32),
}
GROK_DEPTH = 4     # 4 x 9.84 GB of layers + 3.2 GB of embedding and head
# the depth cuts of phase 3 (every width as published): grok-1's
# GROK_DEPTH layers, DeepSeek-V3's 3 dense layers and 2 MoE layers (3 x
# 1.16 + 2 x 23.0 GB of layers, 3.7 GB of embedding and head) without the
# MTP module (a training loss, about 23 GB), gemma2-27b's first 6 of 46
# layers (its serve at every layer took 45 s on an H100, at 24 layers
# 23.8 s, at 12 12.1 s: the cuts give phases 7 and 8 their time), qwen3-14b
# at 20 of 40 and minitron-8b at 16 of 32 layers (the script ran past its
# 1,200 s limit on one host at 40 and 32), qwen2-vl-7b's first 4 layers
CUTS = {"grok-1-314b": dict(n_layers=GROK_DEPTH),
        "deepseek-v3-671b": dict(n_layers=5, mtp_depth=0),
        "gemma2-27b": dict(n_layers=6),
        "qwen3-14b": dict(n_layers=20),
        "minitron-8b": dict(n_layers=16),
        "qwen2-vl-7b": dict(n_layers=4)}
# qwen2-vl-7b's run: one prefill of (batch, prompt) embeddings, then decode
# steps; hubert-xlarge's: one forward of (batch, frames) embeddings
EMBED_RUNS = {"qwen2-vl-7b": dict(batch=2, prompt_len=512, gen=16),
              "hubert-xlarge": dict(batch=4, prompt_len=1024)}


def expected_launches(cfg, prefills, steps, prefill_tokens, decode_tokens,
                      paged, suffix_passes=0):
    """Each kernel's launches in ``prefills`` prefills of
    ``prefill_tokens`` tokens each, ``steps`` decode steps over
    ``decode_tokens`` sequences and ``suffix_passes`` passes of the paged
    engine's suffix body (prefix-hit suffixes, prefill chunks, verify
    windows) under impl=pallas: flash in every attention prefill, paged
    or dense decode attention in every global layer's decode step (local
    layers decode plain, as in the reference; the suffix body attends
    plain, as in the reference), the scans where their layers run, three
    (gated) or two grouped GEMMs per expert group of every MoE layer, and
    every norm of every pass: the norms after a residual add (every ln2,
    every ln1 but the first, the final norm) fused with it in
    ``add_rmsnorm``, a layer's q and k norms in one ``qk_rmsnorm``, the
    rest (the first ln1, post-norms) ``rmsnorm``.  A MoE layer's group
    count follows from a pass's width, which the engine's counters do not
    give for suffix passes: no launch-checked run serves MoE with them."""
    from repro_torch.models import moe
    kinds = cfg.layer_kinds
    n_glob, n_attn = kinds.count("attn"), kinds.count("attn") + kinds.count(
        "local")
    n_mla = kinds.count("mla")         # each: a q-latent and a kv-latent norm
    passes = prefills + steps + suffix_passes
    gemms = 0
    if cfg.moe is not None:
        if suffix_passes:
            fail(f"{cfg.name}: MoE launches of suffix passes not derivable")

        def groups(T):
            return moe._group_count(cfg.moe.n_experts, moe.capacity(cfg, T),
                                    cfg.d_model)
        gemms = ((3 if cfg.gated_ffn else 2) * (len(kinds) - cfg.first_k_dense)
                 * (groups(prefill_tokens) * prefills
                    + groups(decode_tokens) * steps))
    return {"flash_attention": n_attn * prefills,
            "paged_decode_attention": n_glob * steps if paged else 0,
            "rwkv6_scan": kinds.count("rwkv6") * (prefills + steps),
            "rglru_scan": kinds.count("rglru") * prefills,
            "moe_gemm": gemms,
            "decode_attention": 0 if paged else n_glob * steps,
            "rmsnorm": (1 + 2 * cfg.post_norm * len(kinds) + 2 * n_mla)
                       * passes,
            "add_rmsnorm": 2 * len(kinds) * passes,
            "qk_rmsnorm": cfg.qk_norm * n_attn * passes}


def engine_passes(eng):
    """(cache-miss prefills, decode steps of the fused scans, suffix
    passes) from the paged engine's own counters: every model pass is
    one of the three.  A suffix pass is a chunk, a verify (a decode step
    of the engine's) or, with chunking off, a prefix hit's suffix."""
    m = eng.metrics()
    verifies = m.get("spec_verifies", 0)
    scan_steps = eng.decode_steps - verifies
    suffix = m.get("chunk_dispatches", 0) + verifies + (
        0 if eng.sched.chunked else m.get("prefix_hits", 0))
    prefills = m["model_passes"] - scan_steps - suffix
    return prefills, scan_steps, suffix


def _launches(ops):
    return {fn.__name__: fn.launches for fn in ops.WRAPPERS}


def _peak_gb():
    """The largest peak of a visible card since ``_reset_peak`` (GB);
    ``_card_peaks`` gives each card's."""
    return max(torch.cuda.max_memory_allocated(i)
               for i in range(torch.cuda.device_count())) / 1e9


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
    _sync()
    _reset_peak()
    ops.reset_launches()                     # counts of the main path only
    t0 = time.time()
    for i, p in enumerate(prompts):
        eng.submit(p, gen_len, rid=f"req{i}")
    fin = eng.run()
    _sync()
    wall = time.time() - t0
    launches = _launches(ops)
    peak_gb = _peak_gb()
    m = eng.metrics()
    if len(fin) != n_req or any(len(r.tokens) != gen_len for r in fin):
        fail(f"{cfg.name}: not every request finished with its tokens")
    if any(not (0 <= t < cfg.vocab_size) for r in fin for t in r.tokens):
        fail(f"{cfg.name}: token ids out of range (NaN logits?)")
    decode_steps = eng.decode_steps
    prefills, scan_steps, suffix = engine_passes(eng)
    want = expected_launches(cfg, prefills, scan_steps, plen, batch, True,
                             suffix)
    if launches != want:
        fail(f"{cfg.name} paged: launches {launches} != expected {want} for "
             f"{prefills} prefills and {decode_steps} decode steps")
    # a finite logit check on one decode step of the served pools
    logits = _one_step_logits(eng)
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
                 peak_gb=peak_gb, profile=prof,
                 tokens={r.rid: list(r.tokens) for r in fin})
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


# the phase 3 run of the paged engine's prefix cache, speculative decoding
# and chunked prefill: PAGED_RUN's traffic on prompts of two groups of 8
# that share a leading 456 tokens (the match ends mid-page: each hit
# copies a page), each prompt's last 56 tokens a per-prompt 4-token motif
FEATURE_RUN = dict(shared=456, motif=4, groups=2, chunk_tokens=128)
FEATURES = dict(prefix_cache=True, spec_decode=True, spec_k="auto",
                chunked_prefill=True)


def feature_prompts(vocab, seed, groups, per_group, plen, shared, motif):
    """``tests/conftest.py``'s ``seeded_prompts`` constructions with numpy
    from ``seed``: each group's prompts share a leading ``shared``
    tokens, and the rest of each prompt tiles its own ``motif``-token
    pattern (n-gram drafting fodder)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(groups):
        base = rng.integers(2, vocab, shared, dtype=np.int32)
        for _ in range(per_group):
            pat = rng.integers(2, vocab, motif, dtype=np.int32)
            tail = np.tile(pat, -(-(plen - shared) // motif))[:plen - shared]
            out.append(np.concatenate([base, tail]))
    return out


def serve_leaders_first(eng, prompts, gen_len, leaders, rid="req",
                        cap=None):
    """Submit the ``leaders`` (the first prompt of each shared prefix),
    step until their prefills are done (their prompts are then in the
    prefix cache), then submit the rest and run to the end: a shared
    system prompt's later users find it cached.  ``cap`` caps every
    window at that many scheduler steps.  Returns the finished
    requests."""
    for i in leaders:
        eng.submit(prompts[i], gen_len, rid=f"{rid}{i}")
    while eng.sched.waiting or eng.sched.prefilling:
        eng.step(cap)
    for i, p in enumerate(prompts):
        if i not in leaders:
            eng.submit(p, gen_len, rid=f"{rid}{i}")
    if cap is None:
        return eng.run()
    while eng.sched.waiting or eng.sched.prefilling or eng.sched.running:
        eng.step(cap)
    return eng.sched.finished


def _ttft_ms(eng, plen, n=3):
    """Time to first token on an idle engine, device-synchronized: a
    miss (a prompt on a prefix nothing shares yet) and then a hit
    (another prompt on that prefix), each generating one token, ``n``
    times.  Returns (miss ms, hit ms)."""
    run = FEATURE_RUN
    miss, hit = [], []
    for j in range(n):
        pair = feature_prompts(eng.cfg.vocab_size, SEED + 100 + j, 1, 2,
                               plen, run["shared"], run["motif"])
        for p, out, tag in zip(pair, (miss, hit), "ab"):
            _sync()
            t0 = time.time()
            eng.submit(p, 1, rid=f"ttft{j}{tag}")
            eng.run()
            _sync()
            out.append((time.time() - t0) * 1e3)
    return miss, hit


def _suffix_profile(eng, prompt):
    """One 128-token chunk pass (positions 384..511, its attention
    einsums' device time attributed) and one 16-wide verify window, each
    under torch.profiler, against null rows (their
    writes land on the null page), and the plain suffix attention of one
    layer at the chunk's shapes timed alone (``time_ms``)."""
    from repro_torch.models import attention
    from repro_torch.serving.paged_kv import NULL_PAGE
    cfg = eng.cfg
    row = torch.full((eng.nmax,), NULL_PAGE, dtype=torch.int32,
                     device=DEVICE)
    tok = torch.tensor(prompt[None], device=DEVICE)

    def chunk():
        eng._chunk(eng.params, tok[:, 384:512], eng.pools, row, 384, 128)
        return 1

    def verify():
        eng._verify(eng.params, tok[:, :16], eng.pools, row, 500, 16)
        return 1

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    q = torch.randn(1, 128, cfg.n_heads, cfg.head_dim, generator=g,
                    device=DEVICE).to(torch.bfloat16)
    pool = eng.pools[0][0][0]
    attn_ms = time_ms(lambda: attention.attend_prefill_paged(
        q, pool, row, 384, scale=cfg.head_dim ** -0.5,
        softcap=cfg.attn_softcap, n_kv=cfg.n_kv_heads))
    return dict(chunk=_profile(chunk, einsums=True), verify=_profile(verify),
                attn_ms_layer=attn_ms, attn_ms_pass=attn_ms * cfg.n_layers)


def serve_paged_features(ops, cfg, params):
    """The paged engine at ``cfg``'s widths with the prefix cache,
    speculative decoding (adaptive K, device proposer) and chunked
    prefill (128-token chunks) on, then the same engine with all three
    off, each warm on PAGED_RUN's traffic over FEATURE_RUN's prompts.
    Checks every request's tokens, the finite logits of a decode step
    and of a verify window, that each feature engaged (prefix hits >= 14,
    verifies >= 1, chunk passes >= 16) and each kernel's launches against
    the engine's own pass counters.  Returns, per run, (stats, launches,
    line)."""
    from repro_torch.models import lm
    from repro_torch.serving.engine import PagedEngine
    from repro_torch.serving.paged_kv import NULL_PAGE

    run, fr = PAGED_RUN, FEATURE_RUN
    n_req, plen, gen_len, batch, ps = (run[k] for k in (
        "requests", "prompt_len", "gen", "batch", "page_size"))
    per_group = n_req // fr["groups"]
    prompts = feature_prompts(cfg.vocab_size, SEED + 11, fr["groups"],
                              per_group, plen, fr["shared"], fr["motif"])
    leaders = list(range(0, n_req, per_group))
    max_len = plen + gen_len
    out, toks = [], {}
    for on in (True, False):
        kw = dict(FEATURES, chunk_tokens=fr["chunk_tokens"]) if on else {}
        eng = PagedEngine(cfg, params, max_batch=batch, page_size=ps,
                          n_pages=batch * (-(-max_len // ps)) + 1,
                          max_len=max_len, fused=True,
                          max_window=run["window"], device=DEVICE, **kw)
        # warm: every window and verify width, a prefill and, with the
        # cache on, a miss and a hit; then a cold tree and zero counters
        eng.warmup_windows()
        eng.submit(prompts[0], 2, rid="warm")
        eng.run()
        eng.warmup_prefix(plen, fr["shared"])
        eng.reset_metrics()
        if eng.cache is not None:
            eng.cache.clear()
        _sync()
        _reset_peak()
        ops.reset_launches()                 # counts of this run only
        t0 = time.time()
        fin = serve_leaders_first(eng, prompts, gen_len, leaders)
        _sync()
        wall = time.time() - t0
        launches = _launches(ops)
        peak_gb = _peak_gb()
        m = eng.metrics()
        what = f"{cfg.name} paged, features {'on' if on else 'off'}"
        if len(fin) != n_req or any(len(r.tokens) != gen_len for r in fin):
            fail(f"{what}: not every request finished with its tokens")
        if any(not (0 <= t < cfg.vocab_size) for r in fin for t in r.tokens):
            fail(f"{what}: token ids out of range (NaN logits?)")
        toks[on] = {r.rid: list(r.tokens) for r in fin}
        prefills, scan_steps, suffix = engine_passes(eng)
        want = expected_launches(cfg, prefills, scan_steps, plen, batch,
                                 True, suffix)
        if launches != want:
            fail(f"{what}: launches {launches} != expected {want} for "
                 f"{prefills} prefills, {scan_steps} decode steps and "
                 f"suffix passes {suffix}")
        if on and not (m["prefix_hits"] >= n_req - len(leaders)
                       and m["spec_verifies"] >= 1
                       and m["chunk_dispatches"] >= n_req):
            fail(f"{what}: a feature did not engage: prefix hits "
                 f"{m['prefix_hits']}, verifies {m['spec_verifies']}, "
                 f"chunk passes {m['chunk_dispatches']}")
        logits = _one_step_logits(eng)
        finite = bool(torch.isfinite(logits).all())
        if on:
            null_row = torch.full((eng.nmax,), NULL_PAGE, dtype=torch.int32,
                                  device=DEVICE)
            vl = lm.verify_window_paged(
                eng.params, cfg, torch.tensor(prompts[0][None, :16],
                                              device=DEVICE),
                eng.pools, null_row, plen, 16)[0]
            finite = finite and bool(torch.isfinite(vl).all())
        if not finite:
            fail(f"{what}: non-finite logits after serving")
        miss, hit = _ttft_ms(eng, plen)
        prof = _suffix_profile(eng, prompts[0]) if on else None
        stats = dict(arch=cfg.name, features=on, requests=n_req,
                     prompt_len=plen, gen=gen_len, max_batch=batch,
                     page_size=ps, shared_prefix=fr["shared"],
                     chunk_tokens=fr["chunk_tokens"] if on else None,
                     wall_s=wall, tok_per_s=m["tokens_out"] / wall,
                     decode_step_ms=m["decode_step_s"] * 1e3,
                     ttft_miss_ms=miss, ttft_hit_ms=hit,
                     prefills=prefills, decode_steps=scan_steps,
                     suffix_passes=suffix, windows=m["windows"],
                     model_passes=m["model_passes"],
                     dispatches_per_token=m["dispatches_per_token"],
                     h2d_syncs=m["h2d_syncs"], d2h_syncs=m["d2h_syncs"],
                     preemptions=m["preemptions"], launches=launches,
                     peak_gb=peak_gb, profile=prof,
                     **{k: m.get(k) for k in (
                         "prefix_hits", "cow_copies", "bytes_deduped",
                         "spec_verifies", "spec_drafted", "spec_accepted",
                         "spec_rollbacks", "accept_rate", "spec_k_mean",
                         "spec_verify_s", "chunk_dispatches",
                         "chunk_tasks")})
        line = (f"serve {what} ({cfg.n_layers} layers, bf16 activations, "
                f"impl=pallas; {n_req} requests of {plen} + {gen_len} "
                f"tokens, two groups sharing {fr['shared']} tokens, "
                f"4-token motif tails, leaders first"
                + (f", chunks of {fr['chunk_tokens']}, spec_k auto"
                   if on else "") + f"): {wall:.2f} s, "
                f"{stats['tok_per_s']:.1f} tok/s, decode step "
                f"{stats['decode_step_ms']:.3f} ms, time to first token "
                f"miss {np.mean(miss):.3f} ms {[round(x, 3) for x in miss]}"
                f", hit {np.mean(hit):.3f} ms {[round(x, 3) for x in hit]}; "
                f"{prefills} prefills, {scan_steps} decode steps, suffix "
                f"passes {suffix}; prefix hits {m.get('prefix_hits')}, COW "
                f"copies {m.get('cow_copies')}, verifies "
                f"{m.get('spec_verifies')}, accept rate "
                f"{m.get('accept_rate')}, mean K {m.get('spec_k_mean')}, "
                f"chunk passes {m.get('chunk_dispatches')}; "
                f"{m['dispatches_per_token']:.4f} passes per token; syncs "
                f"{m['h2d_syncs']} h2d + {m['d2h_syncs']} d2h; peak memory "
                f"{peak_gb:.2f} GB; launches {launches}")
        if on:
            c, v = prof["chunk"], prof["verify"]
            line += (f"; profiled 128-token chunk pass {c['wall_ms']:.3f} ms "
                     f"wall, device busy {c['busy_share']:.3f}, "
                     f"{c['launches_per_step']:.0f} launches, attention "
                     f"einsums {c['einsum_ms']:.3f} ms of device time "
                     f"({c['einsum_share']:.3f}), top {c['top']}"
                     f"; 16-wide verify {v['wall_ms']:.3f} ms wall, busy "
                     f"{v['busy_share']:.3f}, top {v['top']}; plain suffix "
                     f"attention at the chunk's shapes "
                     f"{prof['attn_ms_layer']:.4f} ms a layer, "
                     f"{prof['attn_ms_pass']:.3f} ms a pass")
        out.append((stats, launches, line))
        del eng
        torch.cuda.empty_cache()
    same = sum(toks[True][r] == toks[False][r] for r in toks[False])
    out[0][0]["same_tokens_as_off"] = same / n_req
    out[0] = (out[0][0], out[0][1], out[0][2]
              + f"; {same} of {n_req} requests' tokens equal the "
              f"features-off run's (not gated: bf16 through another "
              f"attention path may flip a near-tie)")
    return out


# the phase 3 chaos run: PAGED_RUN's traffic (features off) on a pool
# striped over 3 nodes on the host, 435 pages: the 8 x 36 pages of a full
# batch's worst-case demand fit with one node down (434 x 2/3 = 289), and
# 435 divides by 3.  The plan is tests/test_serving_fuzz.py's pinned
# chaos plan (_chaos_plan), copied: a transient-rejection burst, a
# straggler window, two node failures with their re-joins, on the
# scheduler's step clock from arming.  Admission budget 4.0 decode steps:
# at 3 nodes the reference's TPU-priced 512-token prefill costs 2.02
# decode steps (1.09 at 1 node), over the default 2.0, which admits a
# prompt only when no request runs (batch 1: 1,024 steps on the CPU
# rehearsal against 139 at 4.0); 4.0 keeps the fault-free run's pattern
# of one admission a step
CHAOS_RUN = dict(n_nodes=3, n_pages=435, prefill_budget=4.0)
CHAOS_EVENTS = ((2, "transient", -1, 2), (3, "slow", 2, 1, 4, 4.0),
                (4, "fail", 1), (10, "join", 1), (14, "fail", 2),
                (20, "join", 2))
OUT = ROOT / "chiprun_out"


def chaos_plan():
    from repro_torch.serving.faults import FaultEvent, FaultPlan
    return FaultPlan([FaultEvent(*e) for e in CHAOS_EVENTS])


def chaos_gates(eng, fin, n_req, gen_len, what, exact):
    """The chaos run's gates: every planned failure detected and re-joined
    (``exact``: exactly the plan's two; else at least two, a straggler
    eviction counting as one more failure and re-join), a live request
    recovered, a transient rejection, no stale page served, nothing
    shed, every request finished with its tokens, pages and requests
    conserved."""
    m = eng.metrics()
    nf, nj = m["node_failures"], m["node_joins"]
    if not ((nf == nj == 2) if exact else (nf == nj >= 2)):
        fail(f"{what}: {nf} node failures, {nj} re-joins")
    if not (m["requests_recovered"] >= 1 and m["transient_rejections"] >= 1):
        fail(f"{what}: {m['requests_recovered']} requests recovered, "
             f"{m['transient_rejections']} transient rejections")
    if m["quarantined_served"] != 0 or m["requests_shed"] != 0:
        fail(f"{what}: {m['quarantined_served']} stale pages served, "
             f"{m['requests_shed']} requests shed")
    if len(fin) != n_req or any(len(r.tokens) != gen_len for r in fin):
        fail(f"{what}: not every request finished with its tokens")
    if not (eng.alloc.check_conservation()
            and eng.sched.conserved(eng._n_submitted)):
        fail(f"{what}: pages or requests not conserved")
    return m


def serve_paged_chaos(ops, cfg, params, base):
    """The paged engine at ``cfg``'s widths, features off, with PAGED_RUN's
    traffic on CHAOS_RUN's 3-node pool under the pinned plan, armed after
    the warmup and the reset as the serve CLI arms it, four times in the
    order untraced, traced (the flight recorder on), traced, untraced, so
    that the tracing overhead is read across the host's drift.  The first
    traced run's Chrome trace is written to chiprun_out/.  Checks, on
    every run, ``chaos_gates``, each kernel's launches against the
    engine's pass counters (recovery prefills included) and the first
    run's tokens; on the traced runs a valid trace and recorded spans.
    ``base`` is serve_paged's fault-free run of the same traffic.
    Returns, per run, (stats, launches, line)."""
    from repro_torch.launch.serve import make_prompts
    from repro_torch.serving.engine import PagedEngine
    from repro_torch.serving.telemetry import validate_chrome_trace

    run = PAGED_RUN
    n_req, plen, gen_len, batch, ps = (run[k] for k in (
        "requests", "prompt_len", "gen", "batch", "page_size"))
    prompts = make_prompts(n_req, plen, cfg.vocab_size, SEED)
    OUT.mkdir(exist_ok=True)
    path = OUT / "chaos_trace.json"
    out, first = [], None
    for n, trace in enumerate((False, True, True, False)):
        eng = PagedEngine(cfg, params, max_batch=batch, page_size=ps,
                          n_pages=CHAOS_RUN["n_pages"],
                          max_len=plen + gen_len,
                          n_nodes=CHAOS_RUN["n_nodes"],
                          prefill_budget=CHAOS_RUN["prefill_budget"],
                          fused=True, max_window=run["window"], trace=trace,
                          device=DEVICE)
        if trace:
            eng.tracer.dump_dir = str(OUT)
        eng.warmup_windows()
        eng.submit(prompts[0], 2, rid="warm")
        eng.run()
        eng.reset_metrics()
        eng.install_faults(chaos_plan())     # plan step 0: the first step
        _sync()
        _reset_peak()
        ops.reset_launches()                 # counts of this run only
        t0 = time.time()
        for i, p in enumerate(prompts):
            eng.submit(p, gen_len, rid=f"req{i}")
        fin = eng.run()
        _sync()
        wall = time.time() - t0
        launches = _launches(ops)
        peak_gb = _peak_gb()
        what = (f"{cfg.name} paged chaos" + (", traced" if trace else "")
                + (f" (run {n + 1} of 4)" if n else ""))
        m = chaos_gates(eng, fin, n_req, gen_len, what, exact=True)
        if any(not (0 <= t < cfg.vocab_size) for r in fin for t in r.tokens):
            fail(f"{what}: token ids out of range (NaN logits?)")
        toks = {r.rid: list(r.tokens) for r in fin}
        first = first or toks
        if toks != first:
            fail(f"{what}: tokens differ from the first chaos run's")
        prefills, scan_steps, suffix = engine_passes(eng)
        want = expected_launches(cfg, prefills, scan_steps, plen, batch,
                                 True, suffix)
        if launches != want:
            fail(f"{what}: launches {launches} != expected {want} for "
                 f"{prefills} prefills (recoveries included) and "
                 f"{scan_steps} decode steps")
        step_ms = m["decode_step_s"] * 1e3
        stats = dict(arch=cfg.name, trace=trace, order=n + 1,
                     requests=n_req, prompt_len=plen, gen=gen_len,
                     max_batch=batch, page_size=ps, **CHAOS_RUN,
                     events=CHAOS_EVENTS, wall_s=wall,
                     tok_per_s=m["tokens_out"] / wall,
                     decode_step_ms=step_ms, prefills=prefills,
                     decode_steps=scan_steps, windows=m["windows"],
                     steps=m["steps"], preemptions=m["preemptions"],
                     h2d_syncs=m["h2d_syncs"], d2h_syncs=m["d2h_syncs"],
                     launches=launches, peak_gb=peak_gb,
                     **{k: m[k] for k in (
                         "node_failures", "node_joins", "pages_quarantined",
                         "requests_recovered", "tokens_recomputed",
                         "transient_rejections", "requests_shed",
                         "quarantined_served", "recovery_steps_p50",
                         "recovery_steps_p99")})
        if n:
            line = (f"serve {what}: {wall:.2f} s, {stats['tok_per_s']:.1f} "
                    f"tok/s, decode step {step_ms:.3f} ms; gates and "
                    f"counters as run 1, tokens identical; launches "
                    f"{launches}")
        else:
            line = (
                f"serve {what} ({cfg.n_layers} layers, bf16 activations, "
                f"impl=pallas; PAGED_RUN's traffic, pool of "
                f"{CHAOS_RUN['n_pages']} pages striped over "
                f"{CHAOS_RUN['n_nodes']} nodes, admission budget "
                f"{CHAOS_RUN['prefill_budget']} decode steps, the pinned "
                f"plan): {wall:.2f} s, {stats['tok_per_s']:.1f} tok/s "
                f"(fault-free {base['tok_per_s']:.1f}), decode step "
                f"{step_ms:.3f} ms (fault-free {base['decode_step_ms']:.3f}"
                f"); {m['node_failures']} node failures / "
                f"{m['node_joins']} re-joins, {m['pages_quarantined']} "
                f"pages quarantined, {m['requests_recovered']} requests "
                f"recovered ({m['tokens_recomputed']} tokens recomputed), "
                f"{m['transient_rejections']} transient rejections, "
                f"{m['requests_shed']} shed, {m['quarantined_served']} "
                f"stale reads; recovery p50 {m['recovery_steps_p50']:.2f} / "
                f"p99 {m['recovery_steps_p99']:.2f} steps (x this run's "
                f"decode step: {m['recovery_steps_p50'] * step_ms:.1f} / "
                f"{m['recovery_steps_p99'] * step_ms:.1f} ms); {prefills} "
                f"prefills ({prefills - n_req} recoveries), {scan_steps} "
                f"decode steps, {m['windows']} windows, "
                f"{m['preemptions']} preemptions; peak memory "
                f"{peak_gb:.2f} GB (fault-free {base['peak_gb']:.2f}); "
                f"launches {launches}")
        if trace:
            eng.tracer.finalize(eng.sched.step_idx)
            if eng.tracer.recorded <= 0:
                fail(f"{what}: no span recorded")
            doc = eng.tracer.chrome_trace()
            if n == 1:
                eng.tracer.write_chrome(str(path))
                doc = json.loads(path.read_text())
            problems = validate_chrome_trace(doc)
            if problems:
                fail(f"{what}: the Chrome trace does not validate: "
                     f"{problems[:3]}")
            stats.update(spans_recorded=eng.tracer.recorded,
                         spans_dropped=eng.tracer.dropped,
                         samples=len(eng.tracer.samples),
                         model_error=eng.tracer.model_error_report())
            if n == 2:
                stats.update(tracer_cost_us=tracer_cost_us(eng))
        out.append((stats, launches, line))
        del eng
        torch.cuda.empty_cache()
    rates = [st["tok_per_s"] for st, _, _ in out]
    ratio = (rates[1] + rates[2]) / (rates[0] + rates[3])
    st = out[1][0]
    cost = out[2][0]["tracer_cost_us"]
    n_disp = sum(int(r["count"]) for r in st["model_error"].values())
    per_run_ms = (n_disp * cost["dispatch"] + (st["spans_recorded"] - n_disp)
                  * cost["lifecycle"] + st["samples"] * cost["sample"]) / 1e3
    st.update(traced_over_untraced=ratio, trace_file=str(path.relative_to(
        ROOT)), tracer_cost_us=cost, tracer_ms_per_run=per_run_ms)
    report = st["model_error"]
    out[1] = (st, out[1][1], out[1][2] + (
        f"; tokens identical to the untraced runs; tok/s untraced, traced, "
        f"traced, untraced {', '.join(f'{r:.1f}' for r in rates)}: traced "
        f"/ untraced {ratio:.4f}; the tracer's own host time, timed "
        f"apart: {cost['dispatch']:.2f} us a dispatch span (untraced "
        f"{cost['untraced']:.3f} us), {cost['lifecycle']:.2f} us a "
        f"lifecycle span, {cost['sample']:.2f} us an occupancy sample: "
        f"{per_run_ms:.3f} ms a run, {per_run_ms / 10 / st['wall_s']:.4f}% "
        f"of its wall; {st['spans_recorded']} spans recorded, "
        f"{st['spans_dropped']} dropped; trace {st['trace_file']} valid; "
        f"per-phase model error, measured on the card (host wall time of "
        f"each span) vs predicted by the reference's TPU v5e-class cost "
        f"model: " + ", ".join(
            f"{ph} x{int(r['count'])} measured {r['measured_s']:.4f} s vs "
            f"predicted {r['predicted_s']:.4f} s"
            for ph, r in sorted(report.items()))))
    return out


def tracer_cost_us(eng, n=2000):
    """Host microseconds of the tracer's own work, timed on this host
    apart from any device work: a dispatch span around an empty body
    with its memoized prediction (and the same with the tracer off), a
    lifecycle transition, and an occupancy sample of the engine's
    allocator.  Recorded into the engine's tracer after its trace was
    checked."""
    tr, step = eng.tracer, eng.sched.step_idx

    def per_call(fn):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    def span():
        with eng._span("scan", lambda: eng._predict_scan(8), k=8, slots=8):
            pass

    def event():
        tr.request_event("cost", "queued", step)
        tr.request_event("cost", "running", step)

    res = dict(dispatch=per_call(span),
               lifecycle=per_call(event) / 2,
               sample=per_call(lambda: tr.counter_sample(
                   step, eng.alloc.occupancy_by_node())))
    eng.tracer = None
    res["untraced"] = per_call(span)
    eng.tracer = tr
    return res


# the phase 3 striped runs: PAGED_RUN's traffic on a pool striped over 4
# nodes, 292 pages (serve_paged's 289 rounded up to divide by 4), first
# with the pools on one device (the stripe host-side only, as --model
# without a mesh) and then on a 1x4 mesh, every layer's pools in 4
# stripes (on a one-card host all four on that card): the same admission
# prices and allocator, so the same schedule, and only the device
# placement and the decode attention differ.  Admission budget 4.0
# decode steps: at 4 nodes the reference's TPU-priced 512-token prefill
# costs 2.38 decode steps (1.09 at 1 node), over the default 2.0, which
# admits a prompt only when no request runs; at 4.0 one prompt is
# admitted a step, as in serve_paged's run
STRIPED_RUN = dict(data=1, model=4, prefill_budget=4.0)
# bf16 near-tie of two full-width runs: the two tokens' logits (the
# kernels' dense path, teacher-forced to the first difference) within
# this many bf16 units (2**-7 of the larger logit's magnitude)
BF16_TIE_UNITS = 4


def _bf16_ties(cfg, params, prompts, base, got, what, mesh=None,
               rules=None):
    """(rid, step, logit gap) of each request's first token that differs
    between two bf16 runs.  Fails unless the dense kernel path (on
    ``mesh`` under ``rules``, with ``params`` placed there), fed the
    prompt and the tokens both runs agree on, gives the two tokens logits
    within BF16_TIE_UNITS bf16 units of each other."""
    from repro_torch import steps
    from repro_torch.parallel.sharding import use_sharding
    ties = []
    for rid, want in base.items():
        have = got[rid]
        j = next((j for j, (a, b) in enumerate(zip(want, have)) if a != b),
                 None)
        if j is None:
            continue
        i = int(rid[3:])
        seq = np.concatenate([prompts[i], np.asarray(want[:j], np.int32)])
        with use_sharding(mesh, rules):
            logits, _ = steps.make_prefill_step(cfg, len(seq) + 1,
                                                mesh=mesh)(
                params, torch.tensor(seq[None], device=DEVICE))
        la, lb = float(logits[0, 0, want[j]]), float(logits[0, 0, have[j]])
        tol = BF16_TIE_UNITS * 2.0 ** -7 * max(abs(la), abs(lb), 1.0)
        ties.append((rid, j, abs(la - lb)))
        if not abs(la - lb) <= tol:
            fail(f"{what} {rid} step {j}: token {have[j]} != {want[j]} with "
                 f"logits {lb} vs {la} (gap {abs(la - lb)} > {tol})")
    return ties


def serve_paged_striped(ops, cfg, params, meshes=None):
    """The paged engine at ``cfg``'s widths with PAGED_RUN's traffic on
    STRIPED_RUN's pool, warm: the pools on one device, then striped over
    the 1x4 mesh (``meshes``: the runs' meshes, None for the pools on one
    device; the first is the base).  Checks every request's tokens (each
    later run's against the base's, near-tie rule ``_bf16_ties``), the
    same schedule, each kernel's launches (paged decode once per stripe
    on a mesh: 4 times the one-device run's, every one in the masked
    mode, and as many on each card of the mesh) and the finite logits of
    one more decode step (whether they equal the base's bit for bit);
    reports tok/s, decode step, peak memory (each card's), syncs, the
    distinct cards and a profiled window.  Returns, per run, (stats,
    launches, line)."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import make_prompts
    from repro_torch.serving.engine import PagedEngine

    run = PAGED_RUN
    n_req, plen, gen_len, batch, ps = (run[k] for k in (
        "requests", "prompt_len", "gen", "batch", "page_size"))
    M = STRIPED_RUN["model"]
    max_len = plen + gen_len
    n_pages = batch * (-(-max_len // ps)) + 1
    n_pages += -n_pages % M
    prompts = make_prompts(n_req, plen, cfg.vocab_size, SEED)
    out, base, base_logits = [], None, None
    for mesh in meshes or (None, make_test_mesh(STRIPED_RUN["data"], M)):
        eng = PagedEngine(cfg, params, max_batch=batch, page_size=ps,
                          n_pages=n_pages, max_len=max_len, n_nodes=M,
                          fused=True, max_window=run["window"],
                          prefill_budget=STRIPED_RUN["prefill_budget"],
                          mesh=mesh, device=DEVICE)
        eng.warmup_windows()
        _sync()
        _reset_peak()
        ops.reset_launches()                 # counts of this run only
        by0 = dict(ops.paged_decode_attention.by_card)
        t0 = time.time()
        for i, p in enumerate(prompts):
            eng.submit(p, gen_len, rid=f"req{i}")
        fin = eng.run()
        _sync()
        wall = time.time() - t0
        launches = _launches(ops)
        masked = ops.paged_decode_attention.masked_launches
        by_card = {c: n - by0.get(c, 0) for c, n in
                   ops.paged_decode_attention.by_card.items()
                   if n - by0.get(c, 0)}
        peak_gb = _peak_gb()
        card_peaks = _card_peaks(mesh) if mesh is not None else [peak_gb]
        m = eng.metrics()
        cards = 1 if mesh is None else mesh.distinct_devices
        what = (f"{cfg.name} paged, {M} nodes, "
                + ("pools on one device" if mesh is None else
                   f"pools striped on a {STRIPED_RUN['data']}x{M} mesh on "
                   f"{cards} card(s)"))
        if len(fin) != n_req or any(len(r.tokens) != gen_len for r in fin):
            fail(f"{what}: not every request finished with its tokens")
        if any(not (0 <= t < cfg.vocab_size) for r in fin for t in r.tokens):
            fail(f"{what}: token ids out of range (NaN logits?)")
        prefills, scan_steps, suffix = engine_passes(eng)
        want = expected_launches(cfg, prefills, scan_steps, plen, batch, True,
                                 suffix)
        stripes = 1 if mesh is None else M
        want["paged_decode_attention"] *= stripes
        if launches != want:
            fail(f"{what}: launches {launches} != expected {want}")
        paged = launches["paged_decode_attention"]
        if masked != (0 if mesh is None else paged):
            fail(f"{what}: {masked} of {paged} paged decode launches masked")
        if sorted(by_card.values()) != [paged // cards] * cards:
            fail(f"{what}: paged decode launches by card {by_card}, not "
                 f"{paged // cards} on each of {cards}")
        toks = {r.rid: list(r.tokens) for r in fin}
        ties = []
        if base is not None:
            if (prefills, scan_steps, m["windows"]) != (
                    base["prefills"], base["decode_steps"], base["windows"]):
                fail(f"{what}: {prefills} prefills, {scan_steps} decode "
                     f"steps, {m['windows']} windows; on one device "
                     f"{base['prefills']}, {base['decode_steps']}, "
                     f"{base['windows']}")
            times = stripes // base["stripes"]
            if paged != times * base["launches"]["paged_decode_attention"]:
                fail(f"{what}: {paged} paged decode launches, not {times} x "
                     f"{base['launches']['paged_decode_attention']}")
            if (m["h2d_syncs"], m["d2h_syncs"]) != (base["h2d_syncs"],
                                                    base["d2h_syncs"]):
                fail(f"{what}: syncs {m['h2d_syncs']} h2d + "
                     f"{m['d2h_syncs']} d2h, on one device "
                     f"{base['h2d_syncs']} + {base['d2h_syncs']}")
            ties = _bf16_ties(cfg, params, prompts, base["tokens"], toks,
                              what)
        logits = _one_step_logits(eng).cpu()
        if not torch.isfinite(logits).all():
            fail(f"{what}: non-finite logits after serving")
        same = None if base_logits is None else \
            torch.equal(logits, base_logits)
        diff = None if base_logits is None else max_err(logits, base_logits)
        prof = _profile_window(eng, prompts)
        pool = eng.pools[0][0][0]
        devs = [str(t.device) for t in (pool.k if mesh is not None
                                         else (pool.k,))]
        stats = dict(arch=cfg.name, n_nodes=M,
                     mesh=None if mesh is None else dict(mesh.shape),
                     stripes=stripes, stripe_devices=devs,
                     distinct_cards=len(set(devs)), n_pages=n_pages,
                     prefill_budget=STRIPED_RUN["prefill_budget"],
                     requests=n_req, prompt_len=plen, gen=gen_len,
                     max_batch=batch, page_size=ps, wall_s=wall,
                     tok_per_s=m["tokens_out"] / wall,
                     decode_step_ms=m["decode_step_s"] * 1e3,
                     prefills=prefills, decode_steps=scan_steps,
                     windows=m["windows"], preemptions=m["preemptions"],
                     h2d_syncs=m["h2d_syncs"], d2h_syncs=m["d2h_syncs"],
                     launches=launches, masked_launches=masked,
                     paged_by_card=by_card, card_peaks_gb=card_peaks,
                     peak_gb=peak_gb, profile=prof, near_ties=ties,
                     tokens=toks, logits_bit_equal=same,
                     logits_max_abs_diff=diff)
        line = (f"serve {what} ({n_pages} pages on "
                f"{sorted(set(devs))}, {len(set(devs))} distinct card(s); "
                f"admission budget {STRIPED_RUN['prefill_budget']}): "
                f"{n_req} requests x {gen_len} tokens in {wall:.2f} s, "
                f"{stats['tok_per_s']:.1f} tok/s, decode step "
                f"{stats['decode_step_ms']:.3f} ms; {prefills} prefills, "
                f"{scan_steps} decode steps, {m['windows']} windows; syncs "
                f"{m['h2d_syncs']} h2d + {m['d2h_syncs']} d2h; peak memory "
                f"{peak_gb:.2f} GB"
                + (f" (each card {', '.join(f'{g:.2f}' for g in card_peaks)})"
                   if cards > 1 else "")
                + f"; launches {launches}, {masked} masked; paged decode "
                f"launches by card {by_card}")
        if base is not None:
            stats["step_ratio"] = (stats["decode_step_ms"]
                                   / base["decode_step_ms"])
            stats["peak_delta_gb"] = peak_gb - base["peak_gb"]
            line += (f"; decode step {stats['step_ratio']:.3f}x, peak "
                     f"{stats['peak_delta_gb']:+.3f} GB against the "
                     f"{base_what}; paged decode {paged} = {times} x "
                     f"{base['launches']['paged_decode_attention']}; schedule "
                     f"and syncs equal; tokens "
                     + ("equal" if not ties else f"equal but at near-ties "
                        f"{ties}")
                     + "; one more step's logits "
                     + ("bit-equal" if same else f"differ by at most "
                        f"{diff:.3g}"))
        line += (f"; profiled {prof['steps']}-step window: "
                 f"{prof['wall_ms']:.3f} ms wall, device busy "
                 f"{prof['busy_share']:.3f}, "
                 f"{prof['launches_per_step']:.0f} device launches per step, "
                 f"top {prof['top']}")
        out.append((stats, launches, line))
        if base is None:
            base, base_logits = stats, logits
            base_what = what.split(", ", 2)[-1]
        del eng
        torch.cuda.empty_cache()
    return out


def serve_cli_striped(cards=1):
    """The serve CLI at qwen3-1.7b's full width on a 1x4 mesh
    (``--engine paged --devices 4 --model 4``, PAGED_RUN's traffic and
    STRIPED_RUN's budget) in a process of its own: it must serve every
    request and report 4 stripes on ``cards`` distinct cards (its
    positions go round-robin over the visible cards).  Its output goes
    to chiprun_out/serve_cli_striped.txt."""
    import os
    run = PAGED_RUN
    argv = ["--arch", "qwen3-1.7b", "--engine", "paged", "--devices", "4",
            "--model", "4", "--requests", str(run["requests"]),
            "--prompt-len", str(run["prompt_len"]), "--gen", str(run["gen"]),
            "--batch", str(run["batch"]), "--page-size",
            str(run["page_size"]), "--window", str(run["window"]),
            "--prefill-budget", str(STRIPED_RUN["prefill_budget"])]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"]
                       + argv, capture_output=True, text=True, timeout=600,
                       cwd=ROOT, env=env)
    OUT.mkdir(exist_ok=True)
    (OUT / "serve_cli_striped.txt").write_text(r.stdout + r.stderr)
    served = [x for x in r.stdout.splitlines()
              if x.startswith("[paged] cuda")]
    n_tok = run["requests"] * run["gen"]
    if r.returncode or not served or \
            f"served {run['requests']} requests, {n_tok} tokens" \
            not in served[0] or "each pool in 4 stripes" not in r.stdout \
            or f"({cards} distinct device(s) in the mesh)" not in r.stdout:
        fail(f"serve CLI {' '.join(argv)}: exit {r.returncode}; "
             f"{r.stderr[-2000:]}")
    stripes = [x for x in r.stdout.splitlines() if "stripes over" in x][0]
    line = (f"serve CLI {' '.join(argv)}: exit 0 in {time.time() - t0:.1f} "
            f"s; {served[0]}; {stripes}")
    return dict(argv=argv, served=served[0], stripes=stripes), line


def one_token_chunk(cfg, params):
    """The KV of one 513-token prompt written by 128-token chunks, the
    last a 1-token chunk at position 512, against one suffix pass over
    the whole prompt (a recovery's re-prefill with chunking on can end
    in such a chunk): the max abs difference and whether they are
    bit-equal, at the 1-token chunk's position and at the others, and
    between the two final logits.  A report, not a gate."""
    from repro_torch.models import lm
    ps, chunk, n = 16, 128, 4 * 128 + 1
    nmax = -(-n // ps)
    row = torch.arange(1, nmax + 1, dtype=torch.int32, device=DEVICE)
    toks = np.random.default_rng(SEED + 14).integers(
        2, cfg.vocab_size, n, dtype=np.int32)

    def padded(s, k):
        w = 1 << max(k - 1, 0).bit_length()
        t = np.zeros((1, w), np.int32)
        t[0, :k] = toks[s:s + k]
        return torch.tensor(t, device=DEVICE)

    one = lm.init_paged_caches(cfg, nmax + 1, ps, DEVICE)
    l_one, one = lm.prefill_suffix_paged(params, cfg, padded(0, n), one,
                                         row, 0, n)
    many = lm.init_paged_caches(cfg, nmax + 1, ps, DEVICE)
    for s in range(0, n, chunk):
        k = min(chunk, n - s)
        l_many, many = lm.chunk_prefill_paged(params, cfg, padded(s, k),
                                              many, row, s, k)
    pos = torch.arange(n, device=DEVICE)
    pages, slots = row[pos // ps].long(), pos % ps
    last, rest, equal = 0.0, 0.0, [True, True]
    for a, b in zip(_leaves(one), _leaves(many)):
        ra, rb = a[pages, slots].float(), b[pages, slots].float()
        d = (ra - rb).abs().reshape(n, -1).max(-1).values
        last, rest = max(last, float(d[-1])), max(rest, float(d[:-1].max()))
        equal[0] &= bool(torch.equal(ra[-1], rb[-1]))
        equal[1] &= bool(torch.equal(ra[:-1], rb[:-1]))
    res = dict(prompt=n, chunk=chunk, kv_err_1token=last,
               kv_bitequal_1token=equal[0], kv_err_rest=rest,
               kv_bitequal_rest=equal[1],
               logit_err=max_err(l_one, l_many),
               logits_bitequal=bool(torch.equal(l_one, l_many)),
               same_argmax=bool(torch.equal(l_one.argmax(-1),
                                            l_many.argmax(-1))))
    line = (f"1-token chunk, {cfg.name} ({cfg.n_layers} layers, "
            f"{cfg.activation_dtype}): a {n}-token prompt's KV by "
            f"{chunk}-token chunks ending in a 1-token chunk vs one suffix "
            f"pass: the 1-token chunk's KV max abs diff {last:.3g} "
            f"(bit-equal {equal[0]}), the other positions' {rest:.3g} "
            f"(bit-equal {equal[1]}); final logits max abs diff "
            f"{res['logit_err']:.3g} (bit-equal {res['logits_bitequal']}, "
            f"same argmax {res['same_argmax']}); a report, not a gate")
    del one, many
    return res, line


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
    _sync()
    _reset_peak()
    ops.reset_launches()                     # counts of this path only
    out, st = run_dense(args, cfg, params=params, device=DEVICE)
    _sync()
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
    conv = prof["decode"]["weight_conversions"]
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
            f"{prof['decode']['top']}, conversions of a weight in 4 steps "
            f"{conv or 0}"
            + (f", of kv_b's w_uk / w_uv views or the latent cache "
               f"{prof['decode']['latent_conversions'] or 0}"
               if cfg.mla is not None else "")
            + f"; profiled prefill "
            f"{prof['prefill']['wall_ms']:.3f} ms wall, device busy "
            f"{prof['prefill']['busy_share']:.3f}, attention einsums "
            f"{prof['prefill']['einsum_ms']:.3f} ms of device time "
            f"({prof['prefill']['einsum_share']:.3f}), top "
            f"{prof['prefill']['top']}")
    torch.cuda.empty_cache()
    return stats, launches, line


def dense_repeat(cfg, params):
    """The dense engine's prefill and four decode steps at ``cfg``'s
    DENSE_RUNS batch, run twice in this process: every step's logits
    equal bit for bit (the MoE combine adds each token's experts in a
    fixed order)."""
    from repro_torch.launch.serve import build_parser
    run = DENSE_RUNS[cfg.name]
    args = build_parser().parse_args(
        [f"--{k.replace('_', '-')}={v}" for k, v in run.items()]
        + [f"--seed={SEED}"])
    diff, same = repeat_logits(cfg, params, args)
    line = (f"{cfg.name} dense ({cfg.n_layers} layers), one prefill of "
            f"{args.batch} x "
            f"{args.prompt_len} and 4 decode steps run twice: max |a - b| "
            f"over every step's logits {diff:.3g}, tokens "
            f"{'equal' if same else 'DIFFER'}")
    if diff != 0 or not same:
        fail(line)
    return dict(max_abs_diff=diff, tokens_equal=same), line


def full_width_params(arch):
    """(cfg with impl=pallas, random parameters from SEED) at the config's
    published widths, with the fields CUTS sets for ``arch``."""
    from repro_torch.configs import get_config
    from repro_torch.weights import init_params
    cfg = get_config(arch).replace(impl="pallas", **CUTS.get(arch, {}))
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    return cfg, init_params(cfg, g, DEVICE)


def cut_params(big, params, cfg):
    """``params`` of config ``big`` cut to ``cfg``'s layers, sharing the
    tensors: each layer of ``cfg`` takes the next unused layer of ``big``
    with its kind and FFN (dense or MoE).  Once the caller drops ``big``'s
    tree, the unused layers are freed."""
    from repro_torch.models import lm
    pool = {}
    for kind, p, _, (si, _, _) in lm._layers(big, params, None):
        pool.setdefault((kind, lm.make_segments(big)[si].is_moe),
                        []).append(p)
    segs = [[[pool[kind, seg.is_moe].pop(0) for kind in seg.kinds]
             for _ in range(seg.n_cycles)] for seg in lm.make_segments(cfg)]
    return {**params, "segments": segs}


def vl_positions(B, S, device):
    """Text-like 3-D M-RoPE ids for a (B, S) prompt: S/8 text tokens, a
    square grid of image patches at one temporal id (height and width ids
    from the grid), then text again from the next id on."""
    n_text = S // 8
    side = int(np.sqrt(S // 2))
    hh, ww = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    pos = np.zeros((3, S), np.int64)
    pos[:, :n_text] = np.arange(n_text)
    img = slice(n_text, n_text + side * side)
    pos[0, img] = n_text
    pos[1, img] = n_text + hh.reshape(-1)
    pos[2, img] = n_text + ww.reshape(-1)
    rest = S - img.stop
    pos[:, img.stop:] = n_text + side + np.arange(rest)
    return torch.tensor(pos, dtype=torch.int32, device=device)[:, None] \
        .expand(3, B, S).contiguous()


def _synced_ms(fn, n):
    """Device-synchronized host time of ``fn`` in ms, the mean of ``n``
    calls after one unclocked call."""
    fn()
    _sync()
    t0 = time.time()
    for _ in range(n):
        fn()
    _sync()
    return (time.time() - t0) / n * 1e3


def serve_embeddings(ops, cfg, params):
    """qwen2-vl-7b through ``lm.prefill`` and ``lm.decode_step``, the
    entry points that take embeddings: one prefill of EMBED_RUNS' (batch,
    prompt) random embeddings at text-like 3-D positions, then ``gen``
    decode steps of random embeddings (every plane at the step's
    position, as the reference's ``decode_step`` gives them), bf16
    activations, impl=pallas.  Checks the logits' shapes and finiteness
    and each kernel's launches; times the prefill and a decode step and
    profiles four decode steps."""
    from repro_torch.models import lm
    run = EMBED_RUNS[cfg.name]
    B, S, gen_len = run["batch"], run["prompt_len"], run["gen"]
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 12)
    x = torch.randn(B, S, cfg.d_model, generator=g, device=DEVICE)
    e = torch.randn(gen_len, B, 1, cfg.d_model, generator=g, device=DEVICE)
    pos = vl_positions(B, S, DEVICE)
    max_len = S + gen_len
    n_params = sum(t.numel() for t in _leaves(params))
    _sync()
    _reset_peak()
    ops.reset_launches()                     # counts of this path only
    t0 = time.time()
    logits, caches = lm.prefill(params, cfg, x, max_len=max_len,
                                positions=pos)
    outs = [logits]
    _sync()
    t1 = time.time()
    for i in range(gen_len):
        logits, caches = lm.decode_step(params, cfg, e[i], caches, S + i)
        outs.append(logits)
    _sync()
    t2 = time.time()
    launches = _launches(ops)
    peak_gb = _peak_gb()
    want = expected_launches(cfg, 1, gen_len, B * S, B, False)
    if launches != want:
        fail(f"{cfg.name}: launches {launches} != expected {want}")
    if any(tuple(l.shape) != (B, 1, cfg.vocab_size)
           or not bool(torch.isfinite(l).all()) for l in outs):
        fail(f"{cfg.name}: logits not finite or not (B, 1, V)")
    prefill_ms = _synced_ms(lambda: lm.prefill(params, cfg, x,
                                               max_len=max_len,
                                               positions=pos), 3)

    def decode4():
        c = caches
        for i in range(4):
            c = lm.decode_step(params, cfg, e[i], c, S + gen_len - 4 + i)[1]
        return 4

    prof = _profile(decode4)
    stats = dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
                 n_params=n_params, **run, first_prefill_s=t1 - t0,
                 decode_step_ms=(t2 - t1) / gen_len * 1e3,
                 prefill_ms=prefill_ms, launches=launches, peak_gb=peak_gb,
                 profile=prof)
    line = (f"serve {cfg.name} through lm.prefill / lm.decode_step "
            f"({cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{n_params / 1e9:.3f} B params, bf16 activations, impl=pallas): "
            f"one prefill of ({B}, {S}) embeddings at 3-D M-RoPE positions "
            f"{prefill_ms:.3f} ms, {gen_len} decode steps of embeddings, "
            f"{stats['decode_step_ms']:.3f} ms a step; peak memory "
            f"{peak_gb:.2f} GB; launches {launches}; profiled 4 decode "
            f"steps: {prof['wall_ms'] / 4:.3f} ms wall a step, device busy "
            f"{prof['busy_share']:.3f}, "
            f"{prof['launches_per_step']:.0f} launches a step, top "
            f"{prof['top']}")
    del caches, outs
    torch.cuda.empty_cache()
    return stats, launches, line


def serve_encoder(ops, cfg, params):
    """hubert-xlarge through ``lm.forward``: one bidirectional forward of
    EMBED_RUNS' (batch, frames) random frame embeddings, the final norm
    and the head over every frame, bf16 activations, impl=pallas.  Checks
    the logits' shape and finiteness and each kernel's launches; times
    and profiles the forward."""
    from repro_torch.models import lm
    run = EMBED_RUNS[cfg.name]
    B, S = run["batch"], run["prompt_len"]
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 13)
    x = torch.randn(B, S, cfg.d_model, generator=g, device=DEVICE)
    n_params = sum(t.numel() for t in _leaves(params))

    def frames():
        h, pending, _ = lm.forward(params, cfg, x)
        return lm.head_logits(params, cfg,
                              lm.final_norm(params, cfg, h, pending))

    _sync()
    _reset_peak()
    ops.reset_launches()                     # counts of this path only
    logits = frames()
    _sync()
    launches = _launches(ops)
    peak_gb = _peak_gb()
    want = expected_launches(cfg, 1, 0, B * S, B, False)
    if launches != want:
        fail(f"{cfg.name}: launches {launches} != expected {want}")
    if tuple(logits.shape) != (B, S, cfg.vocab_size) \
            or not bool(torch.isfinite(logits).all()):
        fail(f"{cfg.name}: logits not finite or not (B, S, V)")
    del logits
    fwd_ms = _synced_ms(frames, 3)

    def one_forward():
        frames()
        return 1

    prof = _profile(one_forward)
    stats = dict(arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
                 n_params=n_params, **run, forward_ms=fwd_ms,
                 launches=launches, peak_gb=peak_gb, profile=prof)
    line = (f"serve {cfg.name} through lm.forward ({cfg.n_layers} layers, "
            f"d_model {cfg.d_model}, {n_params / 1e9:.3f} B params, bf16 "
            f"activations, impl=pallas): one bidirectional forward of "
            f"({B}, {S}) frame embeddings and the head over every frame "
            f"{fwd_ms:.3f} ms; peak memory {peak_gb:.2f} GB; launches "
            f"{launches}; profiled: {prof['wall_ms']:.3f} ms wall, device "
            f"busy {prof['busy_share']:.3f}, top {prof['top']}")
    torch.cuda.empty_cache()
    return stats, launches, line


EINSUM_SPAN = "attention einsum"
RECOMPUTE_SPAN = "remat recompute"


class _EinsumSpans:
    """Within the block, every call of the attention's einsum
    (``attention._einsum32``, which MLA calls too) runs inside a
    ``record_function`` span named EINSUM_SPAN and every recompute of a
    checkpointed cycle (``remat._Frame._recompute``) inside one named
    RECOMPUTE_SPAN, so that a profile can attribute device time to the
    einsums (``_einsum_device_us``)."""

    def __enter__(self):
        from torch.profiler import record_function
        from repro_torch.models import attention, remat
        self.undo = [(attention, "_einsum32", attention._einsum32),
                     (remat._Frame, "_recompute", remat._Frame._recompute)]

        def spanned(name, fn):
            def call(*args):
                with record_function(name):
                    return fn(*args)
            return call
        attention._einsum32 = spanned(EINSUM_SPAN, attention._einsum32)
        remat._Frame._recompute = spanned(RECOMPUTE_SPAN,
                                          remat._Frame._recompute)
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self.undo:
            setattr(obj, name, fn)


def _einsum_device_us(events):
    """(device us, host events counted) of the attention einsums in a
    profile taken inside ``_EinsumSpans``: every EINSUM_SPAN (the
    forward's and the recomputes'), and every backward node whose
    forward op ran in one (the autograd engine's ``evaluate_function``
    event carries that op's thread and sequence number) less the
    recomputes it triggered, which hold spans of their own."""
    spans = [e for e in events if e.name == EINSUM_SPAN]
    fwd, marks = set(), (EINSUM_SPAN, RECOMPUTE_SPAN)
    for e in spans:
        todo = list(e.cpu_children)
        while todo:
            c = todo.pop()
            if c.sequence_nr >= 0:
                fwd.add((c.thread, c.sequence_nr))
            todo += c.cpu_children
    nodes = [e for e in events
             if e.name.startswith("autograd::engine::evaluate_function")
             and (e.fwd_thread, e.sequence_nr) in fwd]

    def kernel_us(e):
        """The kernels launched under ``e``, less a recompute's and the
        spans' own device-side ranges (the profiler records each span on
        the device too, as a range around its kernels)."""
        us, todo = 0.0, [e]
        while todo:
            c = todo.pop()
            us += sum(k.duration for k in c.kernels if k.name not in marks)
            todo += [d for d in c.cpu_children if d.name != RECOMPUTE_SPAN]
        return us
    return (sum(kernel_us(e) for e in spans + nodes),
            len(spans) + len(nodes))


def _profile(fn, cpu=True, einsums=False):
    """Run ``fn`` under torch.profiler; ``fn`` returns the number of
    model steps it ran.  Returns the wall time, the device busy share
    (kernel time over wall time), device launches per step and the
    kernels that take most of the device time (ms per step).  With
    ``cpu=False`` the host's ops are not traced (only the device's
    kernels are read either way).  With ``einsums`` also the attention
    einsums' device time a step (forward, recompute and backward,
    ``_einsum_device_us``) and its share of the device time."""
    from torch.profiler import ProfilerActivity, profile
    _sync()
    spans = _EinsumSpans() if einsums else contextlib.nullcontext()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof, spans:
        t0 = time.time()
        k = max(fn(), 1)
        _sync()
        wall = time.time() - t0
    # the device's kernels; a span of ``_EinsumSpans`` is recorded on the
    # device too, as a range around its kernels, and is not one
    marks = (EINSUM_SPAN, RECOMPUTE_SPAN)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in marks]
    dev_us = {e.key: e.self_device_time_total for e in kernels}
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:4]
    cards = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and e.name not in marks:
            c = cards.setdefault(e.device_index, [0.0, 0])
            c[0] += e.self_device_time_total
            c[1] += 1
    out = dict(steps=k, wall_ms=wall * 1e3,
               busy_share=sum(dev_us.values()) / 1e6 / wall,
               launches_per_step=sum(e.count for e in kernels) / k,
               top=[(name[:48], round(us / 1e3 / k, 4)) for name, us in top],
               by_card={i: dict(busy_share=us / 1e6 / wall,
                                launches_per_step=n / k)
                        for i, (us, n) in sorted(cards.items())})
    if einsums:
        ein_us, n = _einsum_device_us(prof.events())
        # the spans' device-side ranges (first kernel to last, gaps
        # included), beside the kernels' time: a check, no gate
        ranges = sum(e.self_device_time_total for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.key == EINSUM_SPAN)
        out.update(einsum_ms=ein_us / 1e3 / k, einsum_events=n,
                   einsum_share=ein_us / max(sum(dev_us.values()), 1e-9),
                   einsum_span_ranges_ms=ranges / 1e3 / k)
    return out


def _dense_steps(cfg, params, args):
    """One batch of the dense engine, as closures: ``run_prefill()`` (a
    batched prefill of the first batch's prompts) and ``run_decode(n,
    start)`` (n greedy steps from position prompt_len + start); the
    prefill's logits in ``state["prefill"]``, each step's appended to
    ``state["steps"]`` and the last in ``state["decode"]``."""
    from repro_torch import steps
    from repro_torch.launch.serve import make_prompts
    prefill = steps.make_prefill_step(cfg, args.prompt_len + args.gen)
    serve = steps.make_serve_step(cfg)
    prompts = make_prompts(args.batch, args.prompt_len, cfg.vocab_size, SEED)
    tok = torch.tensor(np.stack(prompts), device=DEVICE)
    state = {"steps": []}

    def run_prefill():
        state["prefill"], state["caches"] = prefill(params, tok)
        state["tok"] = state["prefill"].argmax(-1).to(torch.int32)
        return 1

    def run_decode(n=4, start=0):
        for i in range(n):
            state["tok"], state["decode"], state["caches"] = serve(
                params, state["tok"], state["caches"],
                args.prompt_len + start + i)
            state["steps"].append(state["decode"])
        return n

    return run_prefill, run_decode, state


def weight_conversions(params, fn, extra=()):
    """{input shape: count} of the dtype conversions (``aten::_to_copy``)
    that ``fn`` makes of a tensor shaped as a parameter of two or more
    dims (or its transpose), or as one of the ``extra`` shapes, read from
    a profile of the host's ops with their input shapes (one op a
    conversion kernel)."""
    from torch.profiler import ProfilerActivity, profile
    shapes = {s for t in _leaves(params) if t.ndim >= 2
              for s in (tuple(t.shape), tuple(t.shape)[::-1])}
    shapes |= {tuple(s) for s in extra}
    _sync()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        fn()
        _sync()
    return {str(tuple(e.input_shapes[0])): e.count
            for e in prof.key_averages(group_by_input_shape=True)
            if e.key == "aten::_to_copy" and e.input_shapes
            and tuple(e.input_shapes[0]) in shapes}


def latent_shapes(cfg, batch, max_len):
    """The shapes of MLA's absorbed decode operands that are not
    parameters: ``kv_b``'s ``w_uk`` and ``w_uv`` views (kv_lora, H,
    nope / v) and the latent cache and its rope keys (B, T, kv_lora /
    rope); none for another family."""
    m = cfg.mla
    if m is None:
        return {}
    return {str(s): s for s in (
        (m.kv_lora_rank, cfg.n_heads, m.qk_nope_head_dim),
        (m.kv_lora_rank, cfg.n_heads, m.v_head_dim),
        (batch, max_len, m.kv_lora_rank),
        (batch, max_len, m.qk_rope_head_dim))}


def _profile_dense(cfg, params, args):
    """One batched prefill of the first batch's prompts (its attention
    einsums' device time attributed) and four decode steps of the dense
    engine, each profiled on its own, then four more steps with the
    host's ops and their shapes recorded for ``weight_conversions`` (and,
    for MLA, ``latent_conversions``: those of ``latent_shapes``).
    Returns the profiles (with the conversions) and the logits of the
    prefill and of the fourth step."""
    run_prefill, run_decode, state = _dense_steps(cfg, params, args)
    prof = dict(prefill=_profile(run_prefill, einsums=True),
                decode=_profile(run_decode))
    logits = (state["prefill"], state["decode"])
    latent = latent_shapes(cfg, args.batch, args.prompt_len + args.gen)
    conv = weight_conversions(params, lambda: run_decode(4, start=4),
                              latent.values())
    prof["decode"]["weight_conversions"] = conv
    prof["decode"]["latent_conversions"] = {k: n for k, n in conv.items()
                                            if k in latent}
    return prof, logits


def repeat_logits(cfg, params, args, n=4):
    """The largest |a - b| between two runs of the dense engine's prefill
    and ``n`` decode steps on the same prompts, over every step's
    logits, and whether the tokens agree."""
    runs = []
    for _ in range(2):
        run_prefill, run_decode, state = _dense_steps(cfg, params, args)
        run_prefill()
        run_decode(n)
        runs.append([state["prefill"]] + state["steps"])
    diff = max(max_err(a, b) for a, b in zip(*runs))
    same = all(torch.equal(a.argmax(-1), b.argmax(-1))
               for a, b in zip(*runs))
    return diff, same


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
    """The logits of one more decode step on the engine's pools (only the
    logits: a caller that kept the pools it returns would hold them past
    the engine, into the next run's peak memory)."""
    from repro_torch.models import lm
    return lm.decode_step_paged(eng.params, eng.cfg, eng.d_tokens, eng.pools,
                                eng.d_block, eng.d_pos)[0]


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
        _sync()
        t0 = time.time()
        prefill(eng.params, tok, eng.pools, row)
        _sync()
        times.append(time.time() - t0)
    return float(np.mean(times[1:])) * 1e3


# ---------------------------------------------------------------------------
# phase 4 — engine parity against the port's dense path (plain attention)
# ---------------------------------------------------------------------------
def _plain_oracle(ref_cfg, params, prompts, gen_len):
    """The dense plain path's greedy tokens, the top-2 logit margin at
    each step and the first-token logits, per prompt (keyed ``r{i}``)."""
    from repro_torch import steps
    plen = len(prompts[0])
    pre_r = steps.make_prefill_step(ref_cfg, max_len=plen + gen_len)
    serve_r = steps.make_serve_step(ref_cfg)
    oracle, margins, first = {}, {}, {}
    for i, p in enumerate(prompts):
        logits, caches = pre_r(params, torch.tensor(p[None], device=DEVICE))
        first[f"r{i}"] = logits
        toks, mg = [], []
        for j in range(gen_len):
            top2 = logits[0, 0].topk(2).values
            mg.append(float(top2[0] - top2[1]))
            nxt = logits.argmax(-1).to(torch.int32)
            toks.append(int(nxt[0, 0]))
            if j < gen_len - 1:
                nxt, logits, caches = serve_r(params, nxt, caches, plen + j)
        oracle[f"r{i}"], margins[f"r{i}"] = toks, mg
    return oracle, margins, first


def _near_ties(fin, oracle, margins, what):
    """(rid, step, margin) of each request's first token that differs
    from the oracle's.  Fails unless the oracle's top-2 margin there is
    below 1e-4 (a near-tie)."""
    ties = []
    for r in fin:
        want = oracle[r.rid]
        if len(r.tokens) != len(want):
            fail(f"{what} {r.rid}: {len(r.tokens)} tokens, not {len(want)}")
        for j, (a, b) in enumerate(zip(r.tokens, want)):
            if a != b:
                ties.append((r.rid, j, margins[r.rid][j]))
                if not margins[r.rid][j] < 1e-4:
                    fail(f"{what} {r.rid} step {j}: engine token {a} != "
                         f"oracle {b} with top-2 margin {margins[r.rid][j]}")
                break
    return ties


def _parity_model(seed):
    """qwen3-1.7b at full width cut to 4 layers, fp32 activations,
    impl=pallas, with random parameters from ``seed``."""
    from repro_torch.configs import get_config
    from repro_torch.weights import init_params
    full = get_config("qwen3-1.7b")
    cfg = full.replace(n_layers=4, activation_dtype="float32",
                       impl="pallas")
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    return full, cfg, init_params(cfg, g, DEVICE)


def engine_parity():
    from repro_torch import steps
    from repro_torch.launch.serve import make_prompts
    from repro_torch.serving.engine import PagedEngine
    from repro_torch.serving.paged_kv import NULL_PAGE

    full, cfg, params = _parity_model(SEED + 2)
    depth = cfg.n_layers
    n_req, plen, gen_len, ps = 4, 512, 16, 16
    prompts = make_prompts(n_req, plen, cfg.vocab_size, SEED + 2)
    max_len = plen + gen_len
    eng = PagedEngine(cfg, params, max_batch=n_req, page_size=ps,
                      n_pages=n_req * (-(-max_len // ps)) + 1,
                      max_len=max_len, fused=True, max_window=8,
                      device=DEVICE)
    # first-token logits: the engine's prefill step (flash kernel) against
    # the dense prefill with the plain attention
    oracle, margins, first = _plain_oracle(cfg.replace(impl="ref"), params,
                                           prompts, gen_len)
    pre_k = steps.make_paged_prefill_step(cfg)
    row = torch.full((eng.nmax,), NULL_PAGE, dtype=torch.int32,
                     device=DEVICE)
    logit_err = 0.0
    for i, p in enumerate(prompts):
        lk, _ = pre_k(params, torch.tensor(p[None], device=DEVICE),
                      eng.pools, row)
        logit_err = max(logit_err, max_err(lk, first[f"r{i}"]))
    if not logit_err <= 1e-3:
        fail(f"first-token logits differ by {logit_err} > 1e-3")
    for p in prompts:
        eng.submit(p, gen_len)
    ties = _near_ties(eng.run(), oracle, margins, "engine parity")
    line = (f"parity {full.name} full width, depth cut {full.n_layers} -> "
            f"{depth} layers, fp32: engine (kernels) vs dense path "
            f"(impl=ref) on {n_req} prompts x {gen_len} tokens: first-token "
            f"logits max abs err {logit_err:.3g} (atol 1e-3); greedy tokens "
            + ("identical" if not ties else f"differ only at near-ties {ties}"))
    del eng, params
    torch.cuda.empty_cache()
    return dict(depth=depth, logit_err=logit_err, near_ties=ties), line


# phase 4's runs of the paged engine's features: each alone and all three
FEATURE_PARITY = (("prefix cache", dict(prefix_cache=True)),
                  ("spec decode", dict(spec_decode=True, spec_k="auto")),
                  ("chunked prefill", dict(chunked_prefill=True,
                                           chunk_tokens=128)),
                  ("all three", dict(FEATURES, chunk_tokens=128)))


# rounds of feature_parity's prompt construction, the oracle tokens each
# prompt carries, and the one of them that is wrong in the copy
ANSWER_ROUNDS, ANSWER_TOKENS, ANSWER_WRONG = 4, 10, 3


def _engaged(m, kw, n_hits, n_chunks, mixed=False):
    """The features of ``kw`` engaged: at least ``n_hits`` prefix hits,
    one verify (with ``mixed``, both an accepted and a rejected draft)
    and ``n_chunks`` chunk passes."""
    return ((not kw.get("prefix_cache") or m["prefix_hits"] >= n_hits)
            and (not kw.get("spec_decode") or (
                m["spec_verifies"] >= 1 and (not mixed or (
                    1 <= m["spec_accepted"] < m["spec_drafted"]))))
            and (not kw.get("chunked_prefill")
                 or m["chunk_dispatches"] >= n_chunks))


def with_answer(prompt, shared, answer, vocab):
    """``prompt`` with ``answer`` copied in right after its ``shared``
    prefix, behind the two tokens the prompt ends with: a prompt that
    quotes what the model goes on to say (prompt-lookup drafting's
    traffic).  The n-gram of the history's end then matches first inside
    the copy, and the draft is the model's own continuation, except at
    the copy's token ANSWER_WRONG, which is another id: a verify that
    drafts across it accepts the tokens before it and rejects the rest."""
    quote = list(answer)
    t = quote[ANSWER_WRONG]
    quote[ANSWER_WRONG] = t + 1 if t + 1 < vocab else 2
    out = np.array(prompt)
    out[shared:shared + 2 + len(quote)] = list(prompt[-2:]) + quote
    return out


def answer_prompts(ref_cfg, params, prompts, shared, gen_len):
    """Each prompt carrying its first ANSWER_TOKENS greedy tokens
    (``with_answer``), to a fixed point: the copy changes the context, so
    the oracle runs again on the new prompts, at most ANSWER_ROUNDS
    times.  Returns the prompts, the plain oracle's tokens and margins on
    them, and the rounds taken."""
    for rounds in range(1, ANSWER_ROUNDS + 1):
        oracle, margins, _ = _plain_oracle(ref_cfg, params, prompts, gen_len)
        nxt = [with_answer(p, shared, oracle[f"r{i}"][:ANSWER_TOKENS],
                           ref_cfg.vocab_size)
               for i, p in enumerate(prompts)]
        if all(np.array_equal(a, b) for a, b in zip(nxt, prompts)):
            return prompts, oracle, margins, rounds
        prompts = nxt
    oracle, margins, _ = _plain_oracle(ref_cfg, params, prompts, gen_len)
    return prompts, oracle, margins, ANSWER_ROUNDS


def feature_parity_inputs():
    """The model and prompts of phase 4's feature and chaos parity:
    qwen3-1.7b at full width, 4 layers, fp32, and 4 prompts that share a
    456-token prefix and end in motif tails, each quoting the model's own
    continuation with one token wrong (``answer_prompts``), with the
    plain oracle's tokens and margins on them."""
    full, cfg, params = _parity_model(SEED + 12)
    n_req, gen_len = 4, 16
    fr = FEATURE_RUN
    prompts = feature_prompts(cfg.vocab_size, SEED + 12, 1, n_req,
                              PAGED_RUN["prompt_len"], fr["shared"],
                              fr["motif"])
    prompts, oracle, margins, rounds = answer_prompts(
        cfg.replace(impl="ref"), params, prompts, fr["shared"], gen_len)
    return dict(full=full, cfg=cfg, params=params, prompts=prompts,
                oracle=oracle, margins=margins, rounds=rounds,
                gen=gen_len)


def feature_parity(inp):
    """The paged engine (kernels) with each of the prefix cache,
    speculative decoding and chunked prefill alone and with all three,
    on ``feature_parity_inputs``' prompts (the first served first),
    against the port's dense plain path with the near-tie rule: every
    run with speculation must both accept and reject a draft."""
    from repro_torch.serving.engine import PagedEngine

    full, cfg, params, prompts, oracle, margins, rounds, gen_len = (
        inp[k] for k in ("full", "cfg", "params", "prompts", "oracle",
                         "margins", "rounds", "gen"))
    n_req, ps = len(prompts), 16
    plen = PAGED_RUN["prompt_len"]
    fr = FEATURE_RUN
    max_len = plen + gen_len
    res, parts = {}, []
    for name, kw in FEATURE_PARITY:
        eng = PagedEngine(cfg, params, max_batch=n_req, page_size=ps,
                          n_pages=n_req * (-(-max_len // ps)) + 1,
                          max_len=max_len, fused=True, max_window=8,
                          device=DEVICE, **kw)
        fin = serve_leaders_first(eng, prompts, gen_len, [0], rid="r")
        m = eng.metrics()
        if not _engaged(m, kw, n_req - 1, n_req, mixed=True):
            fail(f"feature parity {name}: a feature did not engage: "
                 f"{m.get('prefix_hits')} prefix hits, "
                 f"{m.get('spec_verifies')} verifies with "
                 f"{m.get('spec_accepted')} drafts accepted, "
                 f"{m.get('chunk_dispatches')} chunk passes")
        ties = _near_ties(fin, oracle, margins, f"feature parity {name}")
        res[name] = dict(near_ties=ties, **{k: m.get(k) for k in (
            "prefix_hits", "cow_copies", "spec_verifies", "spec_drafted",
            "spec_accepted", "spec_rollbacks", "accept_rate", "spec_k_mean",
            "chunk_dispatches", "model_passes")})
        parts.append(f"{name}: "
                     + ("identical" if not ties else f"near-ties {ties}")
                     + f" (hits {m.get('prefix_hits')}, verifies "
                     f"{m.get('spec_verifies')}, drafts accepted "
                     f"{m.get('spec_accepted')} of {m.get('spec_drafted')}, "
                     f"accept rate {m.get('accept_rate')}, rollbacks "
                     f"{m.get('spec_rollbacks')}, chunk passes "
                     f"{m.get('chunk_dispatches')})")
        del eng
    line = (f"parity {full.name} paged engine features, full width, depth "
            f"cut {full.n_layers} -> {cfg.n_layers} layers, fp32: engine "
            f"(kernels, plain suffix attention) vs dense path (impl=ref) on "
            f"{n_req} prompts sharing {fr['shared']} of {plen} tokens, each "
            f"quoting its first {ANSWER_TOKENS} greedy tokens with token "
            f"{ANSWER_WRONG} wrong (fixed point in {rounds} rounds), x "
            f"{gen_len} tokens, greedy tokens: "
            + "; ".join(parts))
    torch.cuda.empty_cache()
    return dict(runs=res, answer_rounds=rounds), line


# phase 4's chaos parity: 32 tokens, so that every run outlasts the plan's
# last re-join (step 20), and windows capped at 4 scheduler steps, so
# that the watchdog ticks inside every planned outage whatever the
# speculation accepts (it may then also evict the straggler: a third
# failure and re-join)
CHAOS_PARITY = dict(gen=32, cap=4)


def chaos_parity(inp):
    """The paged engine (kernels) on ``feature_parity_inputs``' model and
    prompts, on a pool striped over 3 nodes under the pinned plan, with
    the features off and with all three on (the first prompt served
    first), against the port's dense plain path with the near-tie rule;
    ``chaos_gates`` (not exact) on each run."""
    from repro_torch.serving.engine import PagedEngine

    full, cfg, params, prompts = (inp[k] for k in ("full", "cfg", "params",
                                                   "prompts"))
    gen_len, cap = CHAOS_PARITY["gen"], CHAOS_PARITY["cap"]
    n_req, ps, plen = len(prompts), 16, PAGED_RUN["prompt_len"]
    oracle, margins, _ = _plain_oracle(cfg.replace(impl="ref"), params,
                                       prompts, gen_len)
    max_len = plen + gen_len
    n_pages = n_req * (-(-max_len // ps)) + 1
    n_pages += -n_pages % CHAOS_RUN["n_nodes"]
    res, parts = {}, []
    for name, kw in (("features off", {}),
                     ("all three", dict(FEATURES, chunk_tokens=128))):
        eng = PagedEngine(cfg, params, max_batch=n_req, page_size=ps,
                          n_pages=n_pages, max_len=max_len,
                          n_nodes=CHAOS_RUN["n_nodes"], fused=True,
                          max_window=8, fault_plan=chaos_plan(),
                          device=DEVICE, **kw)
        fin = serve_leaders_first(eng, prompts, gen_len, [0], rid="r",
                                  cap=cap)
        what = f"chaos parity {name}"
        m = chaos_gates(eng, fin, n_req, gen_len, what, exact=False)
        if not _engaged(m, kw, 1, n_req):
            fail(f"{what}: a feature did not engage: "
                 f"{m.get('prefix_hits')} prefix hits, "
                 f"{m.get('spec_verifies')} verifies, "
                 f"{m.get('chunk_dispatches')} chunk passes")
        ties = _near_ties(fin, oracle, margins, what)
        res[name] = dict(near_ties=ties, **{k: m.get(k) for k in (
            "node_failures", "node_joins", "pages_quarantined",
            "requests_recovered", "tokens_recomputed",
            "transient_rejections", "recovery_steps_p99", "prefix_hits",
            "spec_verifies", "spec_accepted", "chunk_dispatches",
            "model_passes")})
        parts.append(f"{name}: "
                     + ("identical" if not ties else f"near-ties {ties}")
                     + f" ({m['node_failures']} failures / "
                     f"{m['node_joins']} re-joins, "
                     f"{m['requests_recovered']} recovered, "
                     f"{m['tokens_recomputed']} tokens recomputed, "
                     f"{m['transient_rejections']} transient rejections; "
                     f"hits {m.get('prefix_hits')}, verifies "
                     f"{m.get('spec_verifies')}, drafts accepted "
                     f"{m.get('spec_accepted')}, chunk passes "
                     f"{m.get('chunk_dispatches')})")
        del eng
    line = (f"parity {full.name} paged engine under the pinned fault plan, "
            f"full width, depth cut {full.n_layers} -> {cfg.n_layers} "
            f"layers, fp32, pool of {n_pages} pages over "
            f"{CHAOS_RUN['n_nodes']} nodes, windows capped at {cap}: engine "
            f"(kernels) vs dense path (impl=ref) on {n_req} prompts x "
            f"{gen_len} tokens, greedy tokens: " + "; ".join(parts))
    torch.cuda.empty_cache()
    return res, line


# phase 4's striped parity: the reference's mesh rung (1x2 and 2x2, the
# prefix cache's COW copies on striped pools, and a pool that forces a
# preemption), at full width with the depth cut, fp32, 32 tokens (a
# request's pages then grow past its admission's 33)
STRIPED_PARITY = dict(layouts=((1, 2), (2, 2)), gen=32)


def striped_parity(inp):
    """The paged engine (kernels) on a 1x2 and a 2x2 mesh, on
    ``feature_parity_inputs``' model and prompts, against the port's
    dense plain path (impl=ref, no mesh) with the near-tie rule: with the
    prefix cache on (the first prompt served first; the others hit its
    456-token prefix mid-page, so each hit copies a page across the
    stripes), and on a pool of 68 pages with budget 0.0 (two 512-token
    prompts are admitted with 33 pages each; at position 528 both need a
    34th, one page is free, so one is preempted and recomputed).  Gates
    conservation, no page left in use after the preemption run, and the
    features' engagement."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.serving.engine import PagedEngine

    full, cfg, params, prompts = (inp[k] for k in ("full", "cfg", "params",
                                                   "prompts"))
    gen_len = STRIPED_PARITY["gen"]
    oracle, margins, _ = _plain_oracle(cfg.replace(impl="ref"), params,
                                       prompts, gen_len)
    n_req, ps, plen = len(prompts), 16, PAGED_RUN["prompt_len"]
    max_len = plen + gen_len
    full_pool = n_req * (-(-max_len // ps)) + 1
    admitted = -(-(plen + 1) // ps)
    runs = (("prefix cache", dict(n_pages=full_pool + full_pool % 2,
                                  prefix_cache=True)),
            ("forced preemption", dict(n_pages=2 * admitted + 2,
                                       prefill_budget=0.0)))
    res, parts = {}, []
    for d, mm in STRIPED_PARITY["layouts"]:
        for name, kw in runs:
            eng = PagedEngine(cfg, params, max_batch=n_req, page_size=ps,
                              max_len=max_len, fused=True, max_window=8,
                              mesh=make_test_mesh(d, mm), device=DEVICE,
                              **kw)
            what = f"striped parity {d}x{mm} {name}"
            if kw.get("prefix_cache"):
                fin = serve_leaders_first(eng, prompts, gen_len, [0],
                                          rid="r")
            else:
                for i, p in enumerate(prompts):
                    eng.submit(p, gen_len, rid=f"r{i}")
                fin = eng.run()
            m = eng.metrics()
            if kw.get("prefix_cache") and not (
                    m["prefix_hits"] >= n_req - 1 and m["cow_copies"] >= 1):
                fail(f"{what}: {m['prefix_hits']} prefix hits, "
                     f"{m['cow_copies']} COW copies")
            if not kw.get("prefix_cache") and not (
                    m["preemptions"] >= 1 and eng.alloc.pages_in_use == 0):
                fail(f"{what}: {m['preemptions']} preemptions, "
                     f"{eng.alloc.pages_in_use} pages left in use")
            if not eng.alloc.check_conservation():
                fail(f"{what}: the allocator lost pages")
            ties = _near_ties(fin, oracle, margins, what)
            res[f"{d}x{mm} {name}"] = dict(near_ties=ties, **{
                k: m.get(k) for k in ("prefix_hits", "cow_copies",
                                      "preemptions", "h2d_syncs",
                                      "d2h_syncs", "model_passes")})
            parts.append(f"{d}x{mm} {name}: "
                         + ("identical" if not ties else f"near-ties {ties}")
                         + f" (hits {m.get('prefix_hits')}, COW "
                         f"{m.get('cow_copies')}, preemptions "
                         f"{m['preemptions']})")
            del eng
    line = (f"parity {full.name} paged engine on striped pools, full width, "
            f"depth cut {full.n_layers} -> {cfg.n_layers} layers, fp32: "
            f"engine (kernels, masked partials per stripe) vs dense path "
            f"(impl=ref, no mesh) on {n_req} prompts x {gen_len} tokens, "
            f"greedy tokens: " + "; ".join(parts))
    torch.cuda.empty_cache()
    return res, line


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
PARITY = {
    "rwkv6-1.6b": dict(cut=dict(n_layers=4), batch=4, prompt_len=512,
                       gen=16, tol=1e-3),
    "recurrentgemma-2b": dict(cut=dict(n_layers=6), batch=2,
                              prompt_len=2100, gen=16, tol=1e-2),
    "grok-1-314b": dict(cut=dict(n_layers=GROK_DEPTH), batch=2,
                        prompt_len=64, gen=16, tol=1e-3),
    # one dense layer and one MoE layer of the phase 3 weights
    "deepseek-v3-671b": dict(cut=dict(n_layers=2, first_k_dense=1,
                                      mtp_depth=0),
                             batch=2, prompt_len=64, gen=16, tol=1e-3),
    # two (local, global) cycles of the phase 3 weights; prompts past the
    # window
    "gemma2-27b": dict(cut=dict(n_layers=4), batch=2, prompt_len=4200,
                       gen=16, tol=1e-2),
    # the paged engine's new families: four layers of the phase 3 weights,
    # PAGED_RUN's prompt length
    "qwen3-14b": dict(cut=dict(n_layers=4), batch=2, prompt_len=512, gen=16,
                      tol=1e-3),
    "minitron-8b": dict(cut=dict(n_layers=4), batch=2, prompt_len=512,
                        gen=16, tol=1e-3),
}


def parity_cfg(arch):
    """The config of ``arch``'s parity run: PARITY's cut, fp32
    activations, impl=pallas."""
    from repro_torch.configs import get_config
    return get_config(arch).replace(activation_dtype="float32",
                                    impl="pallas", **PARITY[arch]["cut"])


def _cut_text(arch, cfg):
    """'depth cut L -> l layers' and PARITY's other cut fields."""
    from repro_torch.configs import get_config
    extra = {k: v for k, v in PARITY[arch]["cut"].items() if k != "n_layers"}
    return (f"depth cut {get_config(arch).n_layers} -> {cfg.n_layers} layers"
            + (f" ({extra})" if extra else ""))
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
    from repro_torch.launch.serve import make_prompts
    from repro_torch.weights import init_params

    run = PARITY[arch]
    cfg = parity_cfg(arch)
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
    line = (f"parity {arch} dense, full width, {_cut_text(arch, cfg)}, "
            f"fp32 activations: kernel path "
            f"(impl=pallas) vs plain path (impl=ref) on {run['batch']} "
            f"prompts of {plen} x {gen_len} tokens: first-token logits max "
            f"abs err {logit_err:.3g} (atol {run['tol']}"
            + (f"; rows {exempt} exempt at a router near-tie" if exempt
               else "") + "); greedy tokens "
            + ("identical" if not ties else f"differ only at near-ties {ties}")
            + (f"; smallest top-{cfg.moe.top_k}/top-{cfg.moe.top_k + 1} "
               f"router gap {gap:.3g}" if cfg.moe else ""))
    return dict(depth=cfg.n_layers, logit_err=logit_err,
                exempt_rows=exempt, near_ties=ties, router_gap=gap), line


EMBED_PARITY_TOL = 1e-3


def embed_parity(cfg, params):
    """The embedding-input families at fp32 activations, on the phase 3
    weights: the kernel path (impl=pallas) against the plain path
    (impl=ref) on the same inputs.  qwen2-vl-7b: a (2, 512) prefill at
    text-like 3-D positions and 4 decode steps, each step's logits;
    hubert-xlarge: a (2, 1024) forward, every frame's logits.  Within
    EMBED_PARITY_TOL abs."""
    from repro_torch.models import lm
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 14)
    B, S = (2, 512) if cfg.supports_decode else (2, 1024)
    x = torch.randn(B, S, cfg.d_model, generator=g, device=DEVICE)
    e = torch.randn(4, B, 1, cfg.d_model, generator=g, device=DEVICE)
    pos = vl_positions(B, S, DEVICE) if cfg.mrope_sections else None
    logits = {}
    for impl in ("pallas", "ref"):
        c = cfg.replace(activation_dtype="float32", impl=impl)
        if cfg.supports_decode:
            l0, caches = lm.prefill(params, c, x, max_len=S + 4,
                                    positions=pos)
            seq = [l0]
            for i in range(4):
                l0, caches = lm.decode_step(params, c, e[i], caches, S + i)
                seq.append(l0)
            logits[impl] = torch.cat(seq, 1)
            del caches
        else:
            h, pending, _ = lm.forward(params, c, x)
            logits[impl] = lm.head_logits(params, c,
                                          lm.final_norm(params, c, h,
                                                        pending))
    err = max_err(logits["pallas"], logits["ref"])
    if not err <= EMBED_PARITY_TOL:
        fail(f"{cfg.name} parity: logits differ by {err} > "
             f"{EMBED_PARITY_TOL}")
    what = (f"a ({B}, {S}) prefill at 3-D M-RoPE positions and 4 decode "
            f"steps" if cfg.supports_decode else
            f"a bidirectional ({B}, {S}) forward, every frame")
    line = (f"parity {cfg.name}, full width, {cfg.n_layers} layers, fp32 "
            f"activations: kernel path (impl=pallas) vs plain path "
            f"(impl=ref) on {what}: logits max abs err {err:.3g} (atol "
            f"{EMBED_PARITY_TOL})")
    return dict(n_layers=cfg.n_layers, logit_err=err), line


def paged_parity(arch, params, features=False):
    """The paged engine under impl=pallas against the same engine under
    impl=ref, on PARITY's prompts one request per slot; with
    ``features``, the impl=pallas engine with the prefix cache,
    speculative decoding and chunked prefill (chunks of two pages) on
    against the impl=ref engine with all three off, over prompts that
    share a prefix ending mid-page and end in motif tails, the first
    served first.  There the capacity factor is raised to n_experts /
    top_k, so that no token can drop at any width (C >= T): the suffix
    body, its scatter, the COW copy and the chunk and verify scheduling
    then compute the function of the plain engine's full prefill and
    decode steps, up to the order of the arithmetic.  First-token logits
    and the prefill's router gaps from each path's paged prefill step.
    A token flip is exempt at a near-tie of the plain dense path's
    logits at batch 1 (where the capacity matches the paged prefill's),
    or of the routing: the prefill's, or that of the same batch-1
    replay's decode steps (the engine's decode batch of two cannot drop
    a token, C >= 8, so each row routes as it does alone)."""
    from repro_torch import steps
    from repro_torch.launch.serve import make_prompts
    from repro_torch.models import lm, moe
    from repro_torch.serving.engine import PagedEngine
    from repro_torch.serving.paged_kv import NULL_PAGE

    run = PARITY[arch]
    cfg = parity_cfg(arch)
    n_req, plen, gen_len, ps = run["batch"], run["prompt_len"], run["gen"], 16
    max_len = plen + gen_len
    n_pages = n_req * (-(-max_len // ps)) + 1
    if features:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
        prompts = feature_prompts(cfg.vocab_size, SEED + 7, 1, n_req, plen,
                                  plen * 5 // 8, FEATURE_RUN["motif"])
        kws = {"pallas": dict(FEATURES, chunk_tokens=2 * ps), "ref": {}}
    else:
        prompts = make_prompts(n_req, plen, cfg.vocab_size, SEED + 7)
        kws = {"pallas": {}, "ref": {}}
    pools = lm.init_paged_caches(cfg, n_pages, ps, DEVICE)
    row = torch.full((-(-max_len // ps),), NULL_PAGE, dtype=torch.int32,
                     device=DEVICE)
    toks, first, engaged = {}, {}, {}
    pre_gaps = [float("inf")] * n_req
    for impl, kw in kws.items():
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
                          max_window=PAGED_RUN["window"], device=DEVICE,
                          **kw)
        fin = {r.rid: r.tokens
               for r in serve_leaders_first(eng, prompts, gen_len,
                                            [0] if features else [],
                                            rid="r")}
        m = eng.metrics()
        if kw and not _engaged(m, kw, n_req - 1, n_req):
            fail(f"{arch} paged parity, {impl}: a feature did not engage: "
                 f"{m.get('prefix_hits')} prefix hits, "
                 f"{m.get('spec_verifies')} verifies, "
                 f"{m.get('chunk_dispatches')} chunk passes")
        engaged[impl] = {k: m.get(k) for k in (
            "prefix_hits", "spec_verifies", "accept_rate",
            "chunk_dispatches")}
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
    line = (f"parity {arch} paged engine, full width, "
            f"{_cut_text(arch, cfg)}, fp32 activations"
            + (f", capacity factor {cfg.moe.capacity_factor}: kernel path "
               f"(impl=pallas) with prefix cache, spec decode and chunked "
               f"prefill (engaged: {engaged['pallas']}) vs plain path "
               f"(impl=ref) without them" if features else
               ": kernel path (impl=pallas) vs plain path (impl=ref)")
            + f" on {n_req} "
            f"prompts of {plen} x {gen_len} tokens: first-token logits max "
            f"abs err {logit_err:.3g} (atol {run['tol']}"
            + (f"; rows {exempt} exempt at a router near-tie" if exempt
               else "") + "); greedy tokens "
            + ("identical" if not ties else f"differ only at near-ties {ties}")
            + (f"; smallest prefill router gap {min(pre_gaps):.3g}"
               if cfg.moe else ""))
    return dict(depth=cfg.n_layers, logit_err=logit_err,
                exempt_rows=exempt, near_ties=ties, router_gap=gap,
                engaged=engaged), line


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


# ---------------------------------------------------------------------------
# phase 5 — the paper's own modules and case studies on the card
# ---------------------------------------------------------------------------
# sizes of an H100: a 4 GiB store (2**30 fp32 words) written and read in
# batches of 2**22 addresses, half of each batch drawn from a pool of
# 2**19 (duplicates on purpose); the §X-A network at N = 32,768 (its
# dense fp32 table 4 GiB) for 1,000 steps of 1 ms; the lattice
# all-reduce on a 2x4 (pod, data) mesh, 2**26 words a position; the
# stage pipeline: qwen3-1.7b's 28 blocks as 4 stages of 7, 8
# microbatches of (1, 512)
STORE_RUN = dict(size=1 << 30, batch=1 << 22, batches=4, stripes=4)
NEURON_RUN = dict(neurons=32_768, steps=1000, parity=(0, 1, 10, 100, 999),
                  physiological=8192)
NEURON_ULPS = 4              # fp32 units of the update's largest term
# The reference's network does not scale its weights with N: each spike
# adds 0.02 mV on average to every neuron, so above about 10,000 neurons
# the recurrent drive outgrows the noise and the network saturates (the
# reference itself, on the CPU over 400 steps: 7.75 Hz at N = 8,192, 354
# Hz at 12,288).  N = 32,768 is held to at most one spike a step; the
# same model at N = 8,192 to a cortical firing rate.
NEURON_BAND_HZ = (1.0, 100.0)
SHARED_RUN = dict(requests=3, prompt_len=512, shared=456, motif=4, gen=32)
LATTICE_RUN = dict(mesh=(2, 4), words=1 << 26)
# normal values: each position's sum within 16 fp32 units of the sum of
# the magnitudes (the two summation orders' error bound for 8 terms)
LATTICE_UNITS = 16
PIPE_RUN = dict(stages=4, micro=8, seq=512)
# pipeline against one full-batch forward: cuBLAS picks its GEMMs by the
# row count, so bf16 activations differ after 28 layers; max |diff|
# within this share of max |full|
PIPE_FULL_TOL = 2.0 ** -4


def _examples():
    path = str(ROOT / "examples")
    if path not in sys.path:
        sys.path.insert(0, path)


def paper_store(devices=DEVICE, keep=False):
    """The §X-B comparison on the card: one SingleController and one
    StripedStore on a 1x4 mesh (4 stripes of 1 GiB on the one card, or
    one on each of ``devices``), each written STORE_RUN's batches and
    read them back, timed; ``keep``: the record keeps the stripes
    (``words``)."""
    from repro_torch.core.memory_server import (SingleController,
                                                StripedStore,
                                                stripe_slab_index)
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.sharding import use_sharding
    run = STORE_RUN
    size, B, n = run["size"], run["batch"], run["stripes"]
    rows = size // n
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 31)
    batches = []
    for _ in range(run["batches"]):
        pool = torch.randint(0, size, (B // 8,), generator=g, device=DEVICE)
        addr = torch.cat([
            torch.randint(0, size, (B - B // 2,), generator=g,
                          device=DEVICE),
            pool[torch.randint(0, B // 8, (B // 2,), generator=g,
                               device=DEVICE)]])
        # values in [1, 2): an untouched word (0) never passes for one
        batches.append((addr, torch.rand(B, generator=g, device=DEVICE)
                        + 1.0))
    # the plain reference: a stable sort keeps each address's writes in
    # order, so the last of each run of equal addresses is its last write
    A = torch.cat([a for a, _ in batches])
    V = torch.cat([v for _, v in batches])
    order = torch.argsort(A, stable=True)
    As = A[order]
    last = torch.ones_like(As, dtype=torch.bool)
    last[:-1] = As[1:] != As[:-1]
    want_addr, want_val = As[last], V[order[last]]
    dup = A.numel() - want_addr.numel()
    del A, V, order, As, last
    mesh = make_test_mesh(1, n, devices=devices)
    stores = {"single": SingleController(size, device=DEVICE)}
    with use_sharding(mesh):
        stores["striped"] = StripedStore(size)
    striped = stores["striped"]
    placed = [(s.data_ptr(), s.device) for s in striped.stripes]
    rates, reads = {}, {}
    for name, st in stores.items():
        st.write(*batches[0])              # warm (rewritten below)
        st.read(batches[0][0])
        _sync()
        t0 = time.perf_counter()
        for a, v in batches:
            st.write(a, v)
        _sync()
        t_w = time.perf_counter() - t0
        t0 = time.perf_counter()
        reads[name] = [st.read(a) for a, _ in batches]
        _sync()
        t_r = time.perf_counter() - t0
        total = run["batches"] * B
        rates[name] = dict(writes_m_per_s=total / t_w / 1e6,
                           reads_m_per_s=total / t_r / 1e6,
                           write_s=t_w, read_s=t_r)
    single = stores["single"]
    for a, b in zip(reads["single"], reads["striped"]):
        if not torch.equal(a, b):
            fail("store: the single controller and the striped store "
                 "read different words")
    for name, st in stores.items():
        if not torch.equal(st.read(want_addr), want_val):
            fail(f"store {name}: a written address does not read its last "
                 f"written value")
    # bit for bit everywhere: stripe j holds the words j, j + n, ...
    for j, stripe in enumerate(striped.stripes):
        if not torch.equal(single.slab.view(rows, n)[:, j],
                           stripe.to(single.slab.device)):
            fail(f"store: stripe {j} differs from the single controller's "
                 f"words")
    nonzero = [int(torch.count_nonzero(single.slab)),
               sum(int(torch.count_nonzero(s)) for s in striped.stripes)]
    if nonzero != [want_addr.numel()] * 2:
        fail(f"store: {nonzero} words are set, {want_addr.numel()} were "
             f"written: an untouched address does not read 0")
    # (a tensor made on "cuda" lives on "cuda:0")
    devs = [torch.empty(0, device=d).device for d in mesh.axis_devices("model")]
    if [(s.data_ptr(), s.device) for s in striped.stripes] != placed \
            or [s.device for s in striped.stripes] != list(devs) \
            or any(s.numel() != rows for s in striped.stripes):
        fail("store: a write moved a stripe off its position")
    slab_row = stripe_slab_index(want_addr, n, size)
    for j, stripe in enumerate(striped.stripes):
        mine = (want_addr % n) == j
        if not torch.equal(stripe[(slab_row[mine] - j * rows).to(
                stripe.device)].to(DEVICE),
                           want_val[mine]):
            fail(f"store: stripe {j} does not hold the rows "
                 f"stripe_slab_index gives it")
    stats = dict(size_words=size, batch=B, batches=run["batches"],
                 stripes=n, duplicates=dup, distinct=want_addr.numel(),
                 **{f"{k} {m}": v for k, r in rates.items()
                    for m, v in r.items()})
    line = (f"memory server, {size} fp32 words ({size * 4 / 2 ** 30:g} GiB), "
            f"{run['batches']} "
            f"batches of {B} addresses ({dup} duplicated writes, last "
            f"wins): single controller {rates['single']['writes_m_per_s']:.1f}"
            f" M writes/s, {rates['single']['reads_m_per_s']:.1f} M reads/s;"
            f" striped on a 1x{n} mesh ({n} stripes of "
            f"{rows * 4 / 2 ** 30:g} GiB on {mesh.distinct_devices} "
            f"card(s)) {rates['striped']['writes_m_per_s']:.1f} M writes/s, "
            f"{rates['striped']['reads_m_per_s']:.1f} M reads/s; stores "
            f"equal bit for bit, last writes read back, untouched words 0, "
            f"stripes in place")
    if keep:
        stats["words"] = list(striped.stripes)
    del stores, single, striped, reads, batches
    torch.cuda.empty_cache()
    return stats, line


def paper_neurons():
    """§X-A at N = 32,768 for 1,000 steps, through the example's
    ``simulate``; the CUDA step against the plain step on the CPU from
    the same state and noise at NEURON_RUN's steps."""
    _examples()
    import torch_neuron_sim as sim
    run = NEURON_RUN
    N, steps = run["neurons"], run["steps"]
    _sync()
    t0 = time.perf_counter()
    res = sim.simulate(N, steps, seed=SEED, device=DEVICE,
                       keep=run["parity"])
    _sync()
    wall = time.perf_counter() - t0
    total = res["total_spikes"]
    Wv = res["Wv"].cpu()
    params = [p.cpu() for p in res["params"]]
    _, _, c, d = params
    worst = 0.0
    for t in run["parity"]:
        (v, u), noise = res["kept"][t]
        (gv, gu), gfired = sim.step((v, u), noise, res["Wv"], res["params"])
        v, u, noise = v.cpu(), u.cpu(), noise.cpu()
        (pv, pu), pfired = sim.step((v, u), noise, Wv, params)
        if not torch.equal(gfired.cpu(), pfired) or not torch.equal(
                gv.cpu() >= 30.0, pv >= 30.0):
            fail(f"neurons step {t}: the CUDA step fires other neurons than "
                 f"the plain step")
        vr = torch.where(pfired, c, v)
        ur = torch.where(pfired, u + d, u)
        I = 5.0 * noise + Wv @ pfired.float()
        scale = torch.stack([0.04 * vr * vr, (5.0 * vr).abs(),
                             torch.full_like(vr, 140.0), ur.abs(),
                             I.abs()]).amax(0).double()
        unit = torch.finfo(torch.float32).eps * scale
        for got, want in ((gv, pv), (gu, pu)):
            units = float(((got.cpu().double() - want.double()).abs()
                           / unit).max())
            worst = max(worst, units)
            if not units <= NEURON_ULPS:
                fail(f"neurons step {t}: CUDA and plain states differ by "
                     f"{units:.2f} fp32 units (tol {NEURON_ULPS})")
    rate = res["rate_hz"]
    if not 0.0 < rate <= 1000.0:
        fail(f"neurons: {rate:.2f} Hz a neuron, not within one spike a "
             f"1 ms step")
    del res, Wv
    torch.cuda.empty_cache()
    n_phys = run["physiological"]
    t0 = time.perf_counter()
    phys = sim.simulate(n_phys, steps, seed=SEED, device=DEVICE)
    _sync()
    wall_phys = time.perf_counter() - t0
    lo, hi = NEURON_BAND_HZ
    if not lo <= phys["rate_hz"] <= hi:
        fail(f"neurons at N={n_phys}: {phys['rate_hz']:.2f} Hz a neuron, "
             f"outside {lo}-{hi} Hz")
    stats = dict(neurons=N, steps=steps, total_spikes=total, rate_hz=rate,
                 wall_s=wall, parity_steps=list(run["parity"]),
                 worst_units=worst, table_gb=N * N * 4 / 1e9,
                 physiological=dict(neurons=n_phys,
                                    total_spikes=phys["total_spikes"],
                                    rate_hz=phys["rate_hz"],
                                    wall_s=wall_phys))
    line = (f"neuron simulation (§X-A), N={N} (dense fp32 table "
            f"{N * N * 4 / 2 ** 30:g} GiB), {steps} steps of 1 ms: "
            f"{total} spikes, {rate:.2f} Hz a neuron ("
            f"{'saturated: the reference' if rate > hi else 'the reference'}"
            f"'s unscaled weights), {wall:.3f} s wall with the "
            f"draws; one-step parity with the CPU at steps "
            f"{list(run['parity'])}: same spikes, states within "
            f"{worst:.2f} fp32 units (tol {NEURON_ULPS}); N={n_phys}: "
            f"{phys['total_spikes']} spikes, {phys['rate_hz']:.2f} Hz (band "
            f"{lo}-{hi}), {wall_phys:.3f} s")
    del phys
    return stats, line


def paper_shared(ops, cfg, params):
    """§X-B part 2 at full width: the example's ``serve_shared`` with the
    prefix cache off, then on, over three requests that share a 456-token
    system prompt (motif tails).  Tokens equal on and off, or bf16
    near-ties; the launch counts show both attention kernels ran."""
    _examples()
    import torch_shared_memory as shm
    run = SHARED_RUN
    plen, gen = run["prompt_len"], run["gen"]
    prompts = feature_prompts(cfg.vocab_size, SEED + 21, 1,
                              run["requests"], plen, run["shared"],
                              run["motif"])
    ps = PAGED_RUN["page_size"]
    n_pages = run["requests"] * (-(-(plen + gen) // ps)) + 8
    ops.reset_launches()
    (eng_off, off), (eng_on, on) = shm.serve_shared(
        cfg, params, prompts, gen, page_size=ps, n_pages=n_pages,
        device=DEVICE)
    _sync()
    launches = _launches(ops)
    for what, toks in (("off", off), ("on", on)):
        if len(toks) != run["requests"] or any(
                len(t) != gen or not all(0 <= x < cfg.vocab_size for x in t)
                for t in toks.values()):
            fail(f"shared memory part 2, cache {what}: not every request "
                 f"finished with valid tokens")
    req = lambda toks: {f"req{k[1:]}": v for k, v in toks.items()}  # noqa
    ties = _bf16_ties(cfg, params, prompts, req(off), req(on),
                      "shared memory part 2")
    if not launches["paged_decode_attention"] or not \
            launches["flash_attention"]:
        fail(f"shared memory part 2: launches {launches}")
    m_on, m_off = eng_on.metrics(), eng_off.metrics()
    if not m_on["prefix_hits"]:
        fail("shared memory part 2: the prefix cache never hit")
    keys = ("prefill_tokens", "prefix_hit_rate", "cow_copies",
            "shared_pages", "bytes_deduped")
    stats = dict(on={k: m_on[k] for k in keys},
                 off_prefill_tokens=m_off["prefill_tokens"],
                 tokens_equal=on == off, ties=ties, launches=launches)
    line = (f"shared memory part 2 (§X-B), {cfg.name} paged at full width, "
            f"{run['requests']} requests of {plen} tokens sharing a "
            f"{run['shared']}-token system prompt, {gen} tokens each: "
            f"tokens {'identical' if on == off else 'equal but for bf16 '}"
            f"{'' if on == off else f'near-ties {ties}'} with the prefix "
            f"cache on and off; prefill tokens {m_on['prefill_tokens']} (off "
            f"{m_off['prefill_tokens']}), hit rate "
            f"{m_on['prefix_hit_rate']:.3f}, {m_on['cow_copies']} COW "
            f"copies, {m_on['shared_pages']} shared pages, "
            f"{m_on['bytes_deduped']} bytes deduplicated; launches "
            f"{launches}")
    del eng_on, eng_off
    torch.cuda.empty_cache()
    return stats, launches, line


def _lattice_run(shape, parts, stats, devices=DEVICE):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.lattice import lattice_all_reduce
    from repro_torch.parallel.sharding import use_sharding
    with use_sharding(make_mesh(shape, ("pod", "data"), devices)):
        return lattice_all_reduce(parts, ("data",), "pod", stats=stats)


def paper_lattice():
    """The §V-A all-reduce on a 2x4 (pod, data) mesh of 8 positions on
    the one card, 2**26 fp32 words a position: small integers equal to
    the plain sum over the positions bit for bit, normal values within
    LATTICE_UNITS fp32 units of the sum of magnitudes; its ms and the
    bytes of each phase; then the same on one pod (1x4), for §II-A's
    P2 and P4."""
    from repro_torch.parallel.lattice import dcn_bytes_saved
    pods, fast = LATTICE_RUN["mesh"]
    n_pos, words = pods * fast, LATTICE_RUN["words"]
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 41)
    ints = [torch.randint(-1024, 1024, (words,), generator=g,
                          device=DEVICE).float() for _ in range(n_pos)]
    plain = ints[0].clone()
    for p in ints[1:]:
        plain += p
    stats = {}
    outs = _lattice_run((pods, fast), ints, stats)
    for i, o in enumerate(outs):
        if not torch.equal(o, plain):
            fail(f"lattice all-reduce: position {i} differs from the plain "
                 f"sum of small integers")
    del outs, ints, plain
    normal = [torch.randn(words, generator=g, device=DEVICE)
              for _ in range(n_pos)]
    plain, mag = normal[0].clone(), normal[0].abs()
    for p in normal[1:]:
        plain += p
        mag += p.abs()
    outs = _lattice_run((pods, fast), normal, {})
    eps = torch.finfo(torch.float32).eps
    worst = max(float(((o - plain).abs() / (eps * mag)).max()) for o in outs)
    if not worst <= LATTICE_UNITS:
        fail(f"lattice all-reduce: normal values {worst:.2f} fp32 units of "
             f"the magnitudes from the plain sum (tol {LATTICE_UNITS})")
    del outs, plain, mag
    ms = _synced_ms(lambda: _lattice_run((pods, fast), normal, {}), 3)
    flat_ms = _synced_ms(lambda: torch.stack(normal).sum(0), 3)
    one_pod = {}
    ms_one = _synced_ms(lambda: _lattice_run((1, fast), normal[:fast],
                                             one_pod), 3)
    nbytes = words * 4
    model = dcn_bytes_saved(nbytes, fast, pods)
    if stats["all_reduce"] != model["lattice_dcn_bytes"]:
        fail(f"lattice all-reduce: {stats['all_reduce']} bytes over the pod "
             f"axis, the model says {model['lattice_dcn_bytes']}")
    del normal
    torch.cuda.empty_cache()
    res = dict(mesh=[pods, fast], words=words, ms=ms, flat_sum_ms=flat_ms,
               one_pod_ms=ms_one, bytes=stats, one_pod_bytes=one_pod,
               dcn_model=model, worst_units=worst)
    line = (f"lattice all-reduce (§V-A), {pods}x{fast} (pod, data) mesh, 8 "
            f"positions on the one card, {words} fp32 words a position: "
            f"{ms:.3f} ms (one pod, 1x{fast}: {ms_one:.3f} ms; a flat "
            f"torch.stack(...).sum over the 8: {flat_ms:.3f} ms); bytes a "
            f"position receives: reduce-scatter {stats['reduce_scatter']}, "
            f"all-reduce over pods {stats['all_reduce']} (the flat "
            f"all-reduce's {model['flat_dcn_bytes']:.0f}, "
            f"{model['saving_factor']:.0f}x), all-gather "
            f"{stats['all_gather']}; integers equal to the plain sum bit for "
            f"bit, normal values within {worst:.2f} fp32 units (tol "
            f"{LATTICE_UNITS})")
    return res, line


def paper_pipeline(ops, cfg, params, devices=DEVICE):
    """qwen3-1.7b's 28 blocks as 4 stages of 7 on a ("stage",) mesh of 4
    positions on the one card (a stream each), 8 microbatches of (1,
    512): equal bit for bit to the same stages run in order over the
    same microbatches, within PIPE_FULL_TOL of one full-batch forward;
    its ms, the bubble measured on the positions' streams and
    ``bubble_fraction``; the stages on ``devices`` (one card, or a card
    each).  Returns (stats, launches, line)."""
    from repro_torch.core.paradigms import streaming_pipeline
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import blocks, lm
    from repro_torch.parallel.pipeline import bubble_fraction, pipeline_apply
    from repro_torch.parallel.sharding import use_sharding
    run = PIPE_RUN
    n_st, n_mb, S = run["stages"], run["micro"], run["seq"]
    layers = [(kind, p) for kind, p, _, _ in lm._layers(cfg, params, None)]
    per = len(layers) // n_st
    stage_params = [layers[s * per:(s + 1) * per] for s in range(n_st)]

    def stage_fn(layers, x):
        angles = lm._angles(cfg, lm.default_positions(
            cfg, x.shape[0], x.shape[1], x.device))
        pending = None
        for kind, p in layers:
            x, pending, _, _ = blocks.apply(p, cfg, kind, x, pending,
                                            angles=angles)
        return x + pending          # the complete activation, handed on

    g = torch.Generator(device=DEVICE).manual_seed(SEED + 51)
    tokens = torch.randint(2, cfg.vocab_size, (n_mb, S), generator=g,
                           device=DEVICE)
    mesh = make_mesh((n_st,), ("stage",), devices)
    with torch.no_grad():
        x = lm.embed_tokens(params, cfg, tokens)
        ops.reset_launches()
        with use_sharding(mesh):
            pipe = pipeline_apply(stage_fn, stage_params, x, n_micro=n_mb)
        _sync()
        launches = _launches(ops)
        fns = [lambda h, sp=sp: stage_fn(sp, h) for sp in stage_params]
        seq = streaming_pipeline(fns, x, microbatches=n_mb)
        full = streaming_pipeline(fns, x)
        if not torch.equal(pipe, seq):
            fail("pipeline: not bit-identical to the same stages run in "
                 "order over the same microbatches")
        # the stages at the full batch are the model's own forward: a
        # stage that dropped its pending branch would differ here
        fx, fpending, _ = lm.forward(params, cfg, tokens)
        if not torch.equal(full, fx + fpending):
            fail("pipeline: the stages at the full batch differ from "
                 "lm.forward")
        del fx, fpending
        if not bool(torch.isfinite(pipe).all()):
            fail("pipeline: non-finite activations")
        scale = float(full.float().abs().max())
        err = float((pipe.float() - full.float()).abs().max())
        if not err <= PIPE_FULL_TOL * scale:
            fail(f"pipeline: {err} from the full-batch forward (tol "
                 f"{PIPE_FULL_TOL} x {scale})")
        mean_rel = float((pipe.float() - full.float()).abs().mean()
                         / full.float().abs().mean())
        # per layer of a microbatch: flash and the q/k norms once, ln1 and
        # ln2 fused with the residual add, but a stage's first ln1 (no
        # branch pending) a plain rmsnorm
        calls = n_st * n_mb
        want = dict.fromkeys(launches, 0)
        want.update(flash_attention=calls * per, qk_rmsnorm=calls * per,
                    rmsnorm=calls, add_rmsnorm=calls * (2 * per - 1))
        if launches != want:
            fail(f"pipeline: launches {launches} != expected {want}")
        # the bubble, on the positions' own streams: each stage call's
        # device time between events recorded on the stream it runs on,
        # from an origin event on each card (recorded together on idle
        # cards: events of two cards cannot be subtracted)
        log = []

        def timed(layers, x):
            s = torch.cuda.current_stream()
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record(s)
            y = stage_fn(layers, x)
            b.record(s)
            log.append((s.cuda_stream, s.device, a, b))
            return y

        times = []
        cards = sorted({torch.empty(0, device=d).device
                        for d in mesh.devices}, key=lambda d: d.index)
        for _ in range(3):
            log.clear()
            _sync()
            origin = {}
            for d in cards:
                origin[d] = torch.cuda.Event(enable_timing=True)
                origin[d].record(torch.cuda.current_stream(d))
            t0 = time.time()
            with use_sharding(mesh):
                pipe_out = pipeline_apply(timed, stage_params, x,
                                          n_micro=n_mb)
            _sync()
            times.append((time.time() - t0) * 1e3)
        if not torch.equal(pipe_out, pipe):
            fail("pipeline: a timed run differs from the first")
        del pipe_out
        spans = [(st, origin[d].elapsed_time(a), origin[d].elapsed_time(b))
                 for st, d, a, b in log]
        span = max(e for _, _, e in spans) - min(s for _, s, _ in spans)
        busy = {}
        for st, s, e in spans:
            busy[st] = busy.get(st, 0.0) + (e - s)
        bubble = 1.0 - sum(busy.values()) / (len(busy) * span)
        seq_ms = _synced_ms(lambda: streaming_pipeline(
            fns, x, microbatches=n_mb), 2)
        full_ms = _synced_ms(lambda: streaming_pipeline(fns, x), 2)
    stats = dict(stages=n_st, layers_per_stage=per, micro=n_mb, seq=S,
                 ms=times, span_ms=span, busy_ms=sorted(busy.values()),
                 measured_bubble=bubble,
                 bubble_fraction=bubble_fraction(n_st, n_mb),
                 in_order_ms=seq_ms, full_batch_ms=full_ms,
                 max_err_full=err, scale=scale, mean_rel_full=mean_rel,
                 launches=launches, cards=len(cards), out=pipe.cpu())
    line = (f"stage pipeline, {cfg.name}'s {len(layers)} blocks as {n_st} "
            f"stages of {per} on a (stage,) mesh of {n_st} positions on "
            f"{len(cards)} card(s) (a stream each), {n_mb} microbatches of "
            f"(1, {S}), "
            f"bf16 activations, impl=pallas: {np.median(times):.3f} ms "
            f"(runs {', '.join(f'{t:.3f}' for t in times)}; the same stages "
            f"in order {seq_ms:.3f} ms, one full batch {full_ms:.3f} ms); "
            f"measured bubble {bubble:.3f} over a {span:.3f} ms span (busy "
            f"{', '.join(f'{b:.3f}' for b in sorted(busy.values()))} ms a "
            f"position), bubble_fraction({n_st}, {n_mb}) "
            f"{bubble_fraction(n_st, n_mb):.4f}; bit-identical to the "
            f"stages in order; full batch max |diff| {err:.4g} of max "
            f"{scale:.4g} (tol {PIPE_FULL_TOL} x max), mean {mean_rel:.3g}; "
            f"launches {launches}")
    return stats, launches, line


def paper_tables(lattice):
    """The paper's tables as the reference's modules compute them, from
    the port's host copies: not the card's numbers.  §II-A's checks take
    the lattice run's bytes a position (1 pod against 2)."""
    _examples()
    import torch_neuron_sim as sim
    from repro_torch.core import overlays, principles, ratio
    from repro_torch.core.memory_server import memory_per_task
    t3 = ratio.swallow_ec()
    lines = [
        f"Tab. III (ratio.swallow_ec; the paper's Swallow, not the card): "
        f"e/c {t3.ec}, E/C {t3.EC}, perf bound {t3.perf_bound()}, bound "
        f"{t3.bound}; " + "; ".join(
            f"{k} e/c {v['ec']} E/C {v['EC']}"
            for k, v in ratio.SWALLOW_TABLE_III.items() if k != "Swallow"),
        "Fig. 3 (memory_per_task, 64 kB nodes; the paper's model): " + ", ".join(
            f"{p} procs / {t} tasks {memory_per_task(p, t):g} kB"
            for p, t in ((480, 1), (480, 16), (480, 480), (960, 480))),
        "Fig. 4 (overlay_map; the paper's XS1 store): " + "; ".join(
            f"linked {e['linked']} -> overlay {e['overlay']} at "
            f"{e['runtime']}" for e in overlays.overlay_map()["entries"])
        + f"; {overlays.overlay_map()['n_overlays']} overlays, "
        f"{overlays.overlay_map()['resident_kwords']} kwords resident",
        "Fig. 11 (scaling_curve, 64 kB cores; the paper's model): " + ", ".join(
            f"{npc}/core -> {total:.0f} neurons"
            for npc, total in sim.scaling_curve())
        + f"; at N=100k {sim.max_neurons_per_core(100_000)} a core"]
    one, two = lattice["one_pod_bytes"], lattice["bytes"]
    arg = lattice["words"] * 4
    checks = principles.check_scale_free(
        {"memory": {"argument_size_in_bytes": arg},
         "collectives": {"total_wire_bytes_per_device": sum(one.values())}},
        {"memory": {"argument_size_in_bytes": arg},
         "collectives": {"total_wire_bytes_per_device": sum(two.values())}})
    lines.append("§II-A (principles.check_scale_free on the lattice "
                 "all-reduce's bytes a position, 1 pod -> 2 pods): " + "; ".join(
                     f"{c.name}: {c.holds} ({c.evidence})" for c in checks))
    if not all(c.holds for c in checks):
        fail("§II-A: a scale-free property does not hold for the lattice "
             "all-reduce")
    return lines


def paper_phase(ops):
    """Phase 5: the paper's modules and case studies on the card.
    Returns (records, {path: launches}, lines)."""
    t0 = time.time()
    recs, launches, lines = {}, {}, []
    recs["store"], line = paper_store()
    lines.append(line)
    recs["neurons"], line = paper_neurons()
    lines.append(line)
    cfg, params = full_width_params("qwen3-1.7b")
    recs["shared"], launches["paper: shared memory part 2"], line = \
        paper_shared(ops, cfg, params)
    lines.append(line)
    recs["pipeline"], launches["paper: stage pipeline"], line = \
        paper_pipeline(ops, cfg, params)
    del recs["pipeline"]["out"]
    lines.append(line)
    del params
    torch.cuda.empty_cache()
    recs["lattice"], line = paper_lattice()
    lines.append(line)
    lines += paper_tables(recs["lattice"])
    recs["seconds"] = time.time() - t0
    lines.append(f"phase 5 took {recs['seconds']:.1f} s")
    return recs, launches, lines


# ---------------------------------------------------------------------------
# phase 6: the training path
# ---------------------------------------------------------------------------
TRAIN_ARCH = "qwen3-1.7b"
# the train step on the card against the plain CPU step: 2 layers (one
# scanned segment of 2 cycles) at full width, fp32 activations, a
# constant lr, weight decay 0.1; the int8 run at a vocabulary cut to
# int8_vocab (the layers' leaves keep their shapes and int8 layouts; the
# CPU's full-vocabulary int8 step took 40 s).  The random model's logits
# reach about 1,000 (its loss starts at 1,720): at the trainer's 3e-4
# three steps take the loss to 779, and steps 2 and 3 carry step 1's
# rounding differences on, so that a device's GEMM order alone flips int8
# codes (scripts/train_parity_witness.py holds the card against itself
# with another GEMM library, and against one-unit perturbed weights;
# PERF.md section 6).  At 1e-5 what the comparison sees is the devices'
# arithmetic
STEP_PARITY = dict(n_layers=2, batch=2, seq=256, steps=3, lr=1e-5,
                   int8_vocab=16384)
# tolerances of the parity (fp32 GEMMs, TF32 off, summed in another
# order on each device): the metrics within 1e-4 of their value; each
# fp32 moment leaf within 1e-3 of its largest entry (a moment is linear
# in the gradients, or in their squares).  A parameter moves by lr
# m/(sqrt(v) + eps), which is +-lr wherever the gradient is as small as
# its rounding error: there the two devices may part by up to 2 lr a
# step.  So each leaf may hold at most 1e-3 of its elements more than
# 1e-6 of its largest entry apart (a wrong decay or int8 layout moves
# every element of a leaf; a NaN fails).  int8 moments: the quantizer
# gives equal bits for equal inputs (checked alone), but a moment one
# rounding error apart can round to the next code, and each step carries
# the flipped code on; so after 3 steps codes within 3 on at most 1e-3
# of them, and each block's scale (its largest entry, which a flipped
# code may have set) within 3/127 of itself
STEP_TOL = dict(metric=1e-4, moment=1e-3, param_near=1e-6, param_share=1e-3,
                codes=1e-3)
LOSS_RUN = dict(batch=4, seq=1024)
# relative: 28x the gap read on an H100 (3.55e-7; the pallas and blocked
# losses are deterministic, every run read the same), far below the
# change that bf16 activations make against fp32 ones (also printed)
LOSS_TOL = 1e-5
# the trainers of phases 6 and 7 at full width, cut to TRAIN_DEPTH of
# qwen3-1.7b's 28 layers: at 28 the two phases took 262 and 248 s of a
# script that ran 960 to 1,120 s on an H100 host and past its 1,200 s
# limit on another (the steps are host-bound, and the checkpoints'
# writes and restores scale with the layers); at 8, 198 and 173 s of a
# 953 s run on an H100 host 1.4x slower in every phase (with phase 9)
TRAIN_DEPTH = 4
# the trainer: fp32 parameters, bf16 activations, remat; 6 steps with a
# checkpoint at step 3 (8 and 4 until phase 7 came: the cut, and the
# step-6 checkpoints that nothing reads not being written, give phase 7
# its time)
TRAIN_RUN = dict(batch=4, seq=2048, steps=6, warmup=2, ckpt_every=3,
                 peak_lr=3e-4)


def _trainer_cfg():
    """The config of the phase 6 and 7 trainers: TRAIN_ARCH at full
    width, TRAIN_DEPTH layers."""
    from repro_torch.configs import get_config
    return get_config(TRAIN_ARCH).replace(n_layers=TRAIN_DEPTH)


def _train_batches(cfg, batch, seq, n):
    from repro_torch.data import pipeline as data
    src = data.SyntheticLM(data.DataConfig(vocab_size=cfg.vocab_size,
                                           seq_len=seq, global_batch=batch,
                                           seed=SEED))
    return [src.batch(s) for s in range(n)]


def _on(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _ckpt_items(tree):
    from repro_torch.runtime import checkpoint as ckpt_lib
    return list(ckpt_lib._items(tree))


def _pair(a, b):
    """Two leaves as fp32 on one device: the card's when either lies
    there (the comparisons are exact, so the device does not change
    them, and a card reads a GB leaf many times faster than the host)."""
    dev = b.device if b.device.type != "cpu" else a.device
    return a.float().to(dev), b.float().to(dev)


def _leaf_err(a, b):
    """max |a - b| over a leaf, relative to max |a|."""
    a, b = _pair(a, b)
    d = (a - b).abs()
    if not bool(torch.isfinite(d).all()):
        return float("inf")
    return float(d.max()) / max(float(a.abs().max()), 1e-30)


def _moment_errs(mc, mg):
    """(worst relative error: of a leaf's largest entry for fp32
    moments, of each block's own scale for int8 ones; worst share of
    int8 codes off; worst code distance) between two moment lists (CPU,
    card)."""
    from repro_torch.optim import quant
    rel = share = dist = 0.0
    for a, b in zip(mc, mg):
        if isinstance(a, quant.QTensor):
            d = (a.q.int().cpu() - b.q.int().cpu()).abs()
            share = max(share, float((d > 0).float().mean()))
            dist = max(dist, float(d.max()))
            sa = a.scale.cpu()
            e = (sa - b.scale.cpu()).abs() / sa.clamp(min=1e-30)
            rel = max(rel, float(e.max()) if bool(torch.isfinite(e).all())
                      else float("inf"))
        else:
            rel = max(rel, _leaf_err(a, b))
    return rel, share, dist


def _param_errs(pc, pg, paths):
    """The worst leaf's share of elements more than STEP_TOL's
    param_near of the leaf's max apart (1 on a NaN), and the worst max
    |a - b|, each with its leaf's path."""
    share = (0.0, None)
    worst = (0.0, None)
    for path, a, b in zip(paths, pc, pg):
        a, b = _pair(a, b)
        d = (a - b).abs()
        if not bool(torch.isfinite(d).all()):
            return (1.0, path), (float("inf"), path)
        off = float((d > STEP_TOL["param_near"]
                     * float(a.abs().max())).float().mean())
        share = max(share, (off, path), key=lambda x: x[0])
        worst = max(worst, (float(d.max()), path), key=lambda x: x[0])
    return share, worst


def parity_cfg_for(state_dtype):
    """The parity's config: 2 layers, fp32 activations, the int8 run at
    a cut vocabulary."""
    from repro_torch.configs import get_config
    P = STEP_PARITY
    cfg = get_config(TRAIN_ARCH).replace(n_layers=P["n_layers"],
                                         activation_dtype="float32")
    if state_dtype == "int8":
        cfg = cfg.replace(vocab_size=P["int8_vocab"])
    assert cfg.impl == "blocked"
    return cfg


def parity_run(cfg, state_dtype, lr, params):
    """``STEP_PARITY['steps']`` steps of ``make_train_step`` from
    ``params`` (the device is theirs) on the synthetic batches.  Returns
    (reference-shaped parameter leaves, optimizer state, per-step
    metrics, seconds)."""
    from repro_torch import steps, weights
    from repro_torch.optim import adam
    P = STEP_PARITY
    dev = weights.tree_leaves(params)[0].device
    c = adam.AdamConfig(state_dtype=state_dtype, weight_decay=0.1)
    step = steps.make_train_step(cfg, c, lambda s: lr)
    o = adam.init(weights.to_reference(params, cfg), c)
    hist = []
    t0 = time.time()
    for b in _train_batches(cfg, P["batch"], P["seq"], P["steps"]):
        params, o, m = step(params, o, _on(b, dev))
        hist.append({k: float(v) for k, v in m.items()})
    return (weights.tree_leaves(weights.to_reference(params, cfg)), o, hist,
            time.time() - t0)


def parity_gaps(cfg, a, b):
    """What ``train_step_parity`` reads between two ``parity_run``
    results ``a`` (the plain side) and ``b``."""
    from repro_torch import weights
    (pa, oa, ha, _), (pb, ob, hb, _) = a, b
    paths = ["/".join(k) for k, _ in _ckpt_items(weights.to_reference(
        weights.init_params(cfg, device="meta"), cfg))]
    metric = max(abs(g[k] - h[k]) / max(abs(h[k]), 1e-30)
                 for h, g in zip(ha, hb) for k in ("loss", "grad_norm"))
    (share, share_at), (worst, worst_at) = _param_errs(pa, pb, paths)
    m_rel, m_share, m_dist = _moment_errs(oa.m, ob.m)
    v_rel, v_share, v_dist = _moment_errs(oa.v, ob.v)
    return dict(metric_rel_err=metric, param_share_off=share,
                param_share_leaf=share_at, param_max_abs=worst,
                param_max_leaf=worst_at, m_rel_err=m_rel, v_rel_err=v_rel,
                code_share_off=max(m_share, v_share),
                code_max_dist=max(m_dist, v_dist))


def train_step_parity(state_dtype, problems):
    """Three ``make_train_step`` steps of qwen3-1.7b at full width (the
    int8 run at a cut vocabulary), cut to 2 layers, on the card and on the
    CPU from the same weights and batches.  Returns (record, line)."""
    from repro_torch import weights
    from repro_torch.optim import adam, quant
    P = STEP_PARITY
    cfg = parity_cfg_for(state_dtype)
    cpu = weights.init_params(cfg, torch.Generator().manual_seed(SEED),
                              "cpu")
    on_cpu = parity_run(cfg, state_dtype, P["lr"], cpu)
    on_card = parity_run(cfg, state_dtype, P["lr"], weights._tree(
        lambda t: t.to(DEVICE), cpu))
    g = parity_gaps(cfg, on_cpu, on_card)
    rec = dict(state_dtype=state_dtype, vocab=cfg.vocab_size, lr=P["lr"],
               losses_cpu=[h["loss"] for h in on_cpu[2]],
               losses_card=[h["loss"] for h in on_card[2]],
               grad_norms_card=[h["grad_norm"] for h in on_card[2]],
               cpu_s=on_cpu[3], card_s=on_card[3], tol=STEP_TOL, **g)
    what = f"train step parity ({state_dtype} moments)"
    metric, share = g["metric_rel_err"], g["param_share_off"]
    m_rel, v_rel = g["m_rel_err"], g["v_rel_err"]
    if not metric <= STEP_TOL["metric"]:
        problems.append(f"{what}: loss / grad norm differ by {metric:.3g}")
    if not share <= STEP_TOL["param_share"]:
        problems.append(f"{what}: {share:.3g} of {g['param_share_leaf']} "
                        f"more than {STEP_TOL['param_near']} of its max "
                        f"apart")
    if state_dtype == "int8":
        if not (g["code_max_dist"] <= P["steps"]
                and g["code_share_off"] <= STEP_TOL["codes"]
                and max(m_rel, v_rel) <= P["steps"] / 127):
            problems.append(f"{what}: int8 codes {g['code_max_dist']} "
                            f"apart on {g['code_share_off']:.3g} of them, "
                            f"scales {max(m_rel, v_rel):.3g}")
        # the quantizer alone, on the same fp32 moments on both devices
        oc = on_cpu[1]
        same = all(
            torch.equal(a.q, b.q.cpu()) and torch.equal(a.scale,
                                                        b.scale.cpu())
            for x in (adam._decode(m) for m in oc.m + oc.v)
            for enc in (quant.quantize, quant.quantize_aligned)
            if enc is quant.quantize or quant.aligned_ok(x.shape)
            for a, b in [(enc(x, sqrt_encode=True), enc(x.to(DEVICE),
                                                         sqrt_encode=True))])
        rec["quantizer_bits_equal"] = same
        if not same:
            problems.append(f"{what}: the quantizer's codes or scales of "
                            "one input differ between the devices")
    elif not max(m_rel, v_rel) <= STEP_TOL["moment"]:
        problems.append(f"{what}: moments differ by "
                        f"{max(m_rel, v_rel):.3g}")
    line = (f"{what}: {TRAIN_ARCH} at 2 layers, vocabulary "
            f"{cfg.vocab_size}, B={P['batch']}, S={P['seq']}, 3 steps at lr "
            f"{P['lr']}, card against CPU: loss and grad norm within "
            f"{metric:.3g} (tol {STEP_TOL['metric']}); parameters: at most "
            f"{share:.3g} of a leaf ({g['param_share_leaf']}) more than "
            f"{STEP_TOL['param_near']} of its max apart (tol "
            f"{STEP_TOL['param_share']}), the largest gap "
            f"{g['param_max_abs']:.3g} ({g['param_max_leaf']}); "
            + (f"int8 codes {g['code_max_dist']:.0f} apart (tol "
               f"{P['steps']}) on {g['code_share_off']:.3g} of them (tol "
               f"{STEP_TOL['codes']}), block scales m {m_rel:.3g}, v "
               f"{v_rel:.3g} of themselves (tol {P['steps']}/127); the "
               f"quantizer on one input: equal bits "
               f"{rec['quantizer_bits_equal']}" if state_dtype == "int8"
               else f"moments m {m_rel:.3g}, v {v_rel:.3g} of a leaf's max "
               f"(tol {STEP_TOL['moment']})")
            + f"; losses {', '.join(f'{l:.5f}' for l in rec['losses_card'])}"
            f"; card {on_card[3]:.2f} s, CPU {on_cpu[3]:.2f} s")
    return rec, line


def pallas_loss(ops, problems):
    """The served model's loss under impl="pallas" against "blocked" at
    full width, under no_grad, with each kernel's launches; then a train
    step under impl="pallas" must raise.  Returns (record, launches,
    line)."""
    from repro_torch import steps, weights
    from repro_torch.models import lm
    from repro_torch.optim import adam
    cfg, params = full_width_params(TRAIN_ARCH)
    L = cfg.n_layers
    batch = _on(_train_batches(cfg, LOSS_RUN["batch"], LOSS_RUN["seq"],
                               1)[0], DEVICE)
    with torch.no_grad():
        ops.reset_launches()
        loss_p, _ = lm.loss_fn(params, cfg, batch)
        _sync()
        launches = _launches(ops)
        loss_b, _ = lm.loss_fn(params, cfg.replace(impl="blocked"), batch)
        # the scale of a bf16 rounding of every activation, for the tol
        loss_f, _ = lm.loss_fn(params, cfg.replace(
            impl="blocked", activation_dtype="float32"), batch)
    want = dict({fn.__name__: 0 for fn in ops.WRAPPERS},
                flash_attention=L, qk_rmsnorm=L, add_rmsnorm=2 * L - 1,
                rmsnorm=2)
    if launches != want:
        problems.append(f"pallas loss: launches {launches}, expected "
                        f"{want}")
    rel = abs(float(loss_p) - float(loss_b)) / abs(float(loss_b))
    rel_f = abs(float(loss_f) - float(loss_b)) / abs(float(loss_b))
    if not rel <= LOSS_TOL:
        problems.append(f"pallas loss {float(loss_p)} against blocked "
             f"{float(loss_b)}: {rel:.3g} apart (tol {LOSS_TOL})")
    small = cut_params(cfg, params, cfg.replace(n_layers=2))
    del params
    c = adam.AdamConfig()
    step = steps.make_train_step(cfg.replace(n_layers=2), c)
    refusal = "none"
    try:
        step(small, adam.init(weights.to_reference(
            small, cfg.replace(n_layers=2)), c), batch)
        problems.append("a train step under impl='pallas' did not raise")
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        refusal = str(e)
    del small
    torch.cuda.empty_cache()
    rec = dict(loss_pallas=float(loss_p), loss_blocked=float(loss_b),
               rel_err=rel, tol=LOSS_TOL, loss_fp32=float(loss_f),
               fp32_rel=rel_f, launches=launches, refusal=refusal)
    return rec, launches, (
        f"loss of {TRAIN_ARCH} (28 layers, bf16, B={LOSS_RUN['batch']}, "
        f"S={LOSS_RUN['seq']}) under impl=pallas {float(loss_p):.5f}, "
        f"blocked {float(loss_b):.5f}: {rel:.3g} apart (tol {LOSS_TOL}; "
        f"fp32 activations {float(loss_f):.5f}, {rel_f:.3g} from bf16); "
        f"flash_attention {launches['flash_attention']}, rmsnorm "
        f"{launches['rmsnorm']}, add_rmsnorm {launches['add_rmsnorm']}, "
        f"qk_rmsnorm {launches['qk_rmsnorm']} launches; a pallas train "
        f"step raises: {refusal[:60]}...")


class _Clock:
    """Wraps a function of a module and records the seconds of each
    call (the checkpoint's snapshot, disk write and restore)."""

    def __init__(self, mod, name):
        self.mod, self.name, self.fn = mod, name, getattr(mod, name)
        self.s = []

        def timed(*a, **kw):
            t0 = time.time()
            out = self.fn(*a, **kw)
            self.s.append(time.time() - t0)
            return out
        setattr(mod, name, timed)

    def undo(self):
        setattr(self.mod, self.name, self.fn)


def _train(cfg, ckpt_dir, state_dtype, ckpt_every, skip_final=False):
    """train_loop.run at TRAIN_RUN with its output captured (with
    ``skip_final`` the final step's checkpoint, which nothing reads, is
    not written).  Returns (result, peak GB, the printed log)."""
    import contextlib
    import io
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.runtime import train_loop
    R = TRAIN_RUN
    job = train_loop.TrainJobConfig(
        steps=R["steps"], log_every=1, ckpt_every=ckpt_every,
        ckpt_dir=ckpt_dir, peak_lr=R["peak_lr"], warmup=R["warmup"],
        seed=SEED)
    torch.cuda.empty_cache()
    _reset_peak()
    log = io.StringIO()
    from repro_torch.runtime import checkpoint as ckpt_lib
    skip = _SkipSave(ckpt_lib, skip={R["steps"]} if skip_final else ())
    try:
        with contextlib.redirect_stdout(log):
            out = train_loop.run(cfg.replace(opt_state_dtype=state_dtype),
                                 ShapeConfig("train", R["seq"], R["batch"],
                                             "train"),
                                 job=job, device=DEVICE)
    finally:
        skip.undo()
    return out, _peak_gb(), log.getvalue()


def _run_record(out, peak):
    hist = out["history"]
    times = [h["sec_per_step"] for h in hist
             if 2 <= h["step"] <= TRAIN_RUN["steps"] - 1]
    step_s = float(np.median(times))
    losses = [h["loss"] for h in hist]
    return dict(losses=losses, steps=[h["step"] for h in hist],
                step_s=step_s, step_times=times,
                tokens_per_s=TRAIN_RUN["batch"] * TRAIN_RUN["seq"] / step_s,
                peak_gb=peak)


def _profile_train_step(cfg, out, state_dtype):
    """One more train step of a run's final state, under torch.profiler
    (the step consumes the state)."""
    from repro_torch import steps
    c = steps.adam_config_for(cfg.replace(opt_state_dtype=state_dtype))
    step = steps.make_train_step(cfg, c, lambda s: TRAIN_RUN["peak_lr"])
    batch = _on(_train_batches(cfg, TRAIN_RUN["batch"], TRAIN_RUN["seq"],
                               1)[0], DEVICE)
    params, opt = out.pop("params"), out.pop("opt_state")

    def one():
        step(params, opt, batch)
        return 1
    return _profile(one, einsums=True)


def train_runs(problems):
    """The trainer at full width: fp32 moments with a checkpoint at step
    4, the restart from it, then int8 moments.  Returns (record, lines)."""
    import shutil
    import tempfile
    from repro_torch import steps, weights
    from repro_torch.runtime import checkpoint as ckpt_lib
    cfg = _trainer_cfg()
    assert (cfg.impl, cfg.remat, cfg.param_dtype, cfg.activation_dtype) \
        == ("blocked", True, "float32", "bfloat16")
    tmp = tempfile.mkdtemp(prefix="train_ckpt_")
    clocks = {n: _Clock(ckpt_lib, n) for n in ("_snapshot", "_write",
                                               "restore")}
    recs, lines = {}, []
    try:
        free_gb = shutil.disk_usage(tmp).free / 1e9
        lines.append(f"checkpoints in {tmp}: {free_gb:.1f} GB free")
        first, peak, _ = _train(cfg, tmp, "float32",
                                TRAIN_RUN["ckpt_every"], skip_final=True)
        recs["fp32"] = _run_record(first, peak)
        final = [t.detach().clone() for t in weights.tree_leaves(
            weights.to_reference(first["params"], cfg))]
        recs["fp32"]["profile"] = _profile_train_step(cfg, first, "float32")
        del first
        # the restart: the latest checkpoint is step 3's
        again, peak, _ = _train(cfg, tmp, "float32",
                                TRAIN_RUN["ckpt_every"], skip_final=True)
        rec = _run_record(again, peak)
        if rec["steps"] != list(range(TRAIN_RUN["ckpt_every"],
                                      TRAIN_RUN["steps"])):
            problems.append(f"the restart ran steps {rec['steps']}")
        first_losses = recs["fp32"]["losses"][TRAIN_RUN["ckpt_every"]:]
        loss_diff = max(abs(a - b) for a, b in zip(rec["losses"],
                                                   first_losses))
        param_diff = max(float((a - b).abs().max()) for a, b in zip(
            final, weights.tree_leaves(weights.to_reference(
                again["params"], cfg))))
        rec.update(loss_diff=loss_diff, param_diff=param_diff)
        recs["fp32 restart"] = rec
        if not (loss_diff <= 1e-6 * abs(first_losses[0])
                and param_diff <= 1e-6):
            problems.append(f"the restart from step 3 differs: losses by "
                            f"{loss_diff}, "
                 f"parameters by {param_diff}")
        del again, final
        shutil.rmtree(tmp)
        tmp = tempfile.mkdtemp(prefix="train_ckpt_")
        # one checkpoint, the final one, for the round trip
        third, peak, _ = _train(cfg, tmp, "int8", TRAIN_RUN["steps"])
        recs["int8"] = _run_record(third, peak)
        c = steps.adam_config_for(cfg.replace(opt_state_dtype="int8"))
        p_shape = steps.abstract_params(cfg)
        _, back = ckpt_lib.restore(tmp, {
            "params": p_shape,
            "opt": steps.abstract_opt_state(cfg, c, p_shape)},
            device=DEVICE)
        got = ckpt_lib._items({"params": weights.to_reference(
            third["params"], cfg), "opt": third["opt_state"]})
        for (path, a), (_, b) in zip(got, ckpt_lib._items(back)):
            if not torch.equal(a, b):
                problems.append(f"int8 checkpoint round trip: "
                                f"{'/'.join(path)} differs")
                break
        del back, got
        recs["int8"]["profile"] = _profile_train_step(cfg, third, "int8")
        del third
        torch.cuda.empty_cache()
    finally:
        for c_ in clocks.values():
            c_.undo()
        shutil.rmtree(tmp, ignore_errors=True)
    recs["checkpoint_s"] = {n: c_.s for n, c_ in clocks.items()}
    for name in ("fp32", "int8"):
        r = recs[name]
        if not all(np.isfinite(r["losses"])):
            problems.append(f"{name} trainer: a loss is not finite: "
                            f"{r['losses']}")
        if not r["losses"][-1] < r["losses"][1]:
            problems.append(f"{name} trainer: the last step's loss "
                            f"{r['losses'][-1]} is not "
                 f"below step 1's {r['losses'][1]}")
        pr = r["profile"]
        lines.append(
            f"{TRAIN_ARCH} trainer, {name} moments ({cfg.n_layers} layers, "
            f"fp32 params, "
            f"bf16 activations, remat, B={TRAIN_RUN['batch']}, "
            f"S={TRAIN_RUN['seq']}): step {r['step_s'] * 1e3:.1f} ms "
            f"(median of steps 2-{TRAIN_RUN['steps'] - 1}), "
            f"{r['tokens_per_s']:.0f} tokens/s, "
            f"peak {r['peak_gb']:.2f} GB; losses "
            + ", ".join(f"{l:.4f}" for l in r["losses"])
            + f"; a profiled step {pr['wall_ms']:.1f} ms, busy "
            f"{pr['busy_share']:.3f}, {pr['launches_per_step']:.0f} "
            f"launches, attention einsums {pr['einsum_ms']:.1f} ms of "
            f"device time ({pr['einsum_share']:.3f}; forward, recompute "
            f"and backward), top {pr['top']}")
    r = recs["fp32 restart"]
    ck = recs["checkpoint_s"]
    lines.append(
        f"restart from the step-3 checkpoint: steps 3-5 losses within "
        f"{r['loss_diff']:.3g}, final parameters within {r['param_diff']:.3g}"
        f" of the uninterrupted run; checkpoint snapshots "
        + ", ".join(f"{x:.2f}" for x in ck["_snapshot"]) + " s, disk writes "
        + ", ".join(f"{x:.2f}" for x in ck["_write"]) + " s, restores "
        + ", ".join(f"{x:.2f}" for x in ck["restore"]) + " s")
    return recs, lines


def train_phase(ops):
    """Phase 6: the training path.  Returns (records, {path: launches},
    lines)."""
    t0 = time.time()
    recs, launches, lines, problems = {}, {}, [], []
    clock = {}
    for sd in ("float32", "int8"):
        t1 = time.time()
        recs[f"step parity {sd}"], line = train_step_parity(sd, problems)
        clock[f"parity {sd}"] = time.time() - t1
        lines.append(line)
    t1 = time.time()
    recs["pallas loss"], launches["train: loss under impl=pallas"], line = \
        pallas_loss(ops, problems)
    clock["pallas loss"] = time.time() - t1
    lines.append(line)
    t1 = time.time()
    recs["trainer"], run_lines = train_runs(problems)
    clock["trainer"] = time.time() - t1
    lines += run_lines
    recs["seconds"] = time.time() - t0
    recs["section_s"] = clock
    lines.append(f"phase 6 took {recs['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in clock.items()) + ")")
    if problems:            # every gate of the phase is read before this
        for line in lines:
            print(f"[train] {line}")
        fail("phase 6: " + "; ".join(problems))
    return recs, launches, lines



# ---------------------------------------------------------------------------
# phase 7 — training on a device mesh (every position on the one card)
# ---------------------------------------------------------------------------
# the mesh trainer against the one-device trainer, both on the card: 2
# layers at full width, fp32 activations, B=4, S=256, 3 steps at lr 1e-5,
# fp32 and int8 moments, with phase 6's gates (STEP_TOL)
MESH_PARITY = dict(n_layers=2, batch=4, seq=256, steps=3, lr=1e-5,
                   meshes=((2, 2), (1, 2)))
# the trainer at full width on a 2x2 mesh: TRAIN_DEPTH layers, fp32
# parameters and moments, bf16 activations, remat; a checkpoint at step 3 (the step-6
# one is not written: nothing reads it)
MESH_RUN = dict(data=2, model=2, batch=4, seq=2048, steps=6, ckpt_every=3,
                warmup=2, peak_lr=3e-4)
ELASTIC_MESHES = ((1, 4), (4, 1))
# the step after the 1x4 restore against the 2x2 run's step 3: the same
# parameters and batch, bf16 TP sums over 4 positions instead of 2 (read
# 2.8e-5 relative on an H100); the control, the restored state on step
# 4's batch, must land beyond it, or the gate could not tell a wrong batch
ELASTIC_LOSS_TOL = 3e-4
COMPRESS_RUN = dict(words=1 << 26, data=4, rounds=8, tol=0.02)
# the tiny config's 16-wide attention blocks make long sequences slow:
# at the CLI's default 8 x 512 the two runs took 63.9 and 55.1 s on an
# H100
MESH_CLI = (["--tiny", "--devices", "4", "--data", "2", "--model", "2",
             "--steps", "3", "--seq", "64", "--batch", "4"],
            ["--tiny", "--devices", "4", "--layout", "auto", "--steps", "3",
             "--seq", "64", "--batch", "4"])


class _SkipSave:
    """Makes ``AsyncCheckpointer.save`` skip the given steps (a final
    checkpoint that nothing in the phase reads) and keeps the host
    snapshot that the save of step ``keep`` takes (to check a restore
    against without reading the file again)."""

    def __init__(self, ckpt_lib, skip=(), keep=None):
        self.cls, self.fn = ckpt_lib.AsyncCheckpointer, \
            ckpt_lib.AsyncCheckpointer.save
        self.kept = None
        outer = self

        def save(self_, step, state, extra_meta=None):
            if step in skip:
                return
            if step != keep:
                return outer.fn(self_, step, state, extra_meta)
            snap = ckpt_lib._snapshot

            def keeping(st):
                out = snap(st)
                outer.kept = out[0]
                return out
            ckpt_lib._snapshot = keeping
            try:
                outer.fn(self_, step, state, extra_meta)
            finally:
                ckpt_lib._snapshot = snap
        self.cls.save = save

    def undo(self):
        self.cls.save = self.fn


def _mesh_parity_cfg():
    from repro_torch.configs import get_config
    return get_config(TRAIN_ARCH).replace(
        n_layers=MESH_PARITY["n_layers"], activation_dtype="float32")


def _mesh_parity_run(cfg, state_dtype, mesh, rules=None, device=None,
                     init="device"):
    """MESH_PARITY's steps on ``mesh`` (None: one device, the card) under
    ``rules`` from the seeded weights, made on ``device`` (the CPU for a
    mesh of CPU positions), or with ``init="cpu"`` drawn on the CPU and
    moved there (the CPU's and the card's generators draw different
    numbers from one seed).  Returns (logical parameter leaves, logical
    moments (m, v), per-step metrics), on the run's first device."""
    from repro_torch import steps, weights
    from repro_torch.optim import adam, quant
    from repro_torch.parallel.sharding import gather, use_sharding
    P = MESH_PARITY
    device = device or DEVICE
    c = adam.AdamConfig(state_dtype=state_dtype, weight_decay=0.1)
    step = steps.make_train_step(cfg, c, lambda s: P["lr"])
    at = "cpu" if init == "cpu" else device
    params = weights.init_params(cfg, torch.Generator(at).manual_seed(
        SEED), at)
    params = weights._tree(lambda t: t.to(device), params)
    hist = []
    batches = _train_batches(cfg, P["batch"], P["seq"], P["steps"])
    with use_sharding(mesh, rules):
        if mesh is None:
            o = adam.init(weights.to_reference(params, cfg), c)
        else:
            params = weights.shard_params(params, cfg, mesh)
            o = adam.init(params, c)
        for b in batches:
            params, o, m = step(params, o, _on(b, device))
            hist.append({k: float(v) for k, v in m.items()})

    def logical(t):
        if isinstance(t, quant.QTensor):
            return t._replace(q=logical(t.q), scale=logical(t.scale))
        return t if isinstance(t, torch.Tensor) else gather(t)
    leaves = weights.tree_leaves(params if mesh is not None
                                 else weights.to_reference(params, cfg))
    return ([logical(t) for t in leaves], ([logical(t) for t in o.m],
                                           [logical(t) for t in o.v]), hist)


def mesh_parity(problems):
    """The mesh trainer at 2 layers on a 2x2 and a 1x2 mesh against the
    one-device trainer on the card, fp32 and int8 moments, phase 6's
    gates.  Returns (record, lines)."""
    from repro_torch import weights
    from repro_torch.launch.mesh import make_test_mesh
    P = MESH_PARITY
    cfg = _mesh_parity_cfg()
    paths = ["/".join(k) for k, _ in _ckpt_items(weights.to_reference(
        weights.init_params(cfg, device="meta"), cfg))]
    recs, lines = {}, []
    for sd in ("float32", "int8"):
        t0 = time.time()
        one = _mesh_parity_run(cfg, sd, None)
        for d, m in P["meshes"]:
            got = _mesh_parity_run(cfg, sd, make_test_mesh(d, m))
            metric = max(abs(g[k] - h[k]) / max(abs(h[k]), 1e-30)
                         for h, g in zip(one[2], got[2])
                         for k in ("loss", "grad_norm"))
            (share, share_at), (worst, worst_at) = _param_errs(
                one[0], got[0], paths)
            m_rel, m_share, m_dist = _moment_errs(one[1][0], got[1][0])
            v_rel, v_share, v_dist = _moment_errs(one[1][1], got[1][1])
            what = f"mesh parity {d}x{m} ({sd} moments)"
            rec = dict(metric_rel_err=metric, param_share_off=share,
                       param_share_leaf=share_at, param_max_abs=worst,
                       m_rel_err=m_rel, v_rel_err=v_rel,
                       code_share_off=max(m_share, v_share),
                       code_max_dist=max(m_dist, v_dist),
                       losses=[h["loss"] for h in got[2]],
                       losses_one=[h["loss"] for h in one[2]])
            recs[f"{d}x{m} {sd}"] = rec
            if not metric <= STEP_TOL["metric"]:
                problems.append(f"{what}: loss / grad norm {metric:.3g}")
            if not share <= STEP_TOL["param_share"]:
                problems.append(f"{what}: {share:.3g} of {share_at} more "
                                f"than {STEP_TOL['param_near']} apart")
            if sd == "int8":
                if not (rec["code_max_dist"] <= P["steps"]
                        and rec["code_share_off"] <= STEP_TOL["codes"]
                        and max(m_rel, v_rel) <= P["steps"] / 127):
                    problems.append(
                        f"{what}: int8 codes {rec['code_max_dist']} apart "
                        f"on {rec['code_share_off']:.3g}, scales "
                        f"{max(m_rel, v_rel):.3g}")
            elif not max(m_rel, v_rel) <= STEP_TOL["moment"]:
                problems.append(f"{what}: moments {max(m_rel, v_rel):.3g}")
            lines.append(
                f"{what}: {TRAIN_ARCH} at 2 layers, fp32, B={P['batch']}, "
                f"S={P['seq']}, 3 steps at lr {P['lr']}, against one device "
                f"on the card: loss and grad norm within {metric:.3g} (tol "
                f"{STEP_TOL['metric']}); parameters: at most {share:.3g} of "
                f"a leaf ({share_at}) more than {STEP_TOL['param_near']} of "
                f"its max apart, the largest gap {worst:.3g}; "
                + (f"int8 codes {rec['code_max_dist']:.0f} apart on "
                   f"{rec['code_share_off']:.3g} of them, block scales "
                   f"{max(m_rel, v_rel):.3g}" if sd == "int8" else
                   f"moments {max(m_rel, v_rel):.3g} of a leaf's max")
                + f"; losses {', '.join(f'{l:.5f}' for l in rec['losses'])}")
        recs[f"{sd} seconds"] = time.time() - t0
        del one
        torch.cuda.empty_cache()
    return recs, lines


def _mesh_wire(cfg, wire, n_pos):
    """Each position's bytes a step by collective, beside what
    ``core/costs.comm_events`` accounts for the layout."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import costs
    R = MESH_RUN
    per = {k: v / n_pos for k, v in sorted(wire.items())}
    tp = sum(v for k, v in per.items() if not k.startswith(
        ("zero", "grad norm", "int8")))
    events = {e.name: e.wire_bytes_per_device() for e in costs.comm_events(
        cfg, ShapeConfig("train", R["seq"], R["batch"], "train"),
        costs.Layout(data=R["data"], model=R["model"]))}
    return dict(per_position=per, tp_measured=tp,
                grad_measured=per.get("zero grad reduce_scatter", 0.0),
                param_measured=per.get("zero param all_gather", 0.0),
                comm_events=events)


def _cards_of(mesh):
    return sorted(set(mesh.devices), key=lambda d: d.index or 0)


def _reset_peaks(mesh):
    for d in _cards_of(mesh):
        torch.cuda.reset_peak_memory_stats(d)


def _card_peaks(mesh):
    """Each card's peak (GB) since ``_reset_peaks``, in card order."""
    return [torch.cuda.max_memory_allocated(d) / 1e9 for d in _cards_of(mesh)]


def mesh_trainer(ops, problems, tmp, mesh=None):
    """``train_loop.run`` at full width on a 2x2 mesh (MESH_RUN; ``mesh``,
    default every position on the visible cards round-robin) with a
    step-3 checkpoint, then one profiled step.  Returns (record, the
    kernels' launches over the run, the step-3 snapshot, line)."""
    import contextlib
    import io
    from repro_torch import steps
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.sharding import use_sharding
    from repro_torch.runtime import checkpoint as ckpt_lib, train_loop
    R = MESH_RUN
    cfg = _trainer_cfg()
    mesh = mesh or make_test_mesh(R["data"], R["model"])
    job = train_loop.TrainJobConfig(
        steps=R["steps"], log_every=1, ckpt_every=R["ckpt_every"],
        ckpt_dir=tmp, peak_lr=R["peak_lr"], warmup=R["warmup"], seed=SEED)
    torch.cuda.empty_cache()
    _reset_peaks(mesh)
    skip = _SkipSave(ckpt_lib, skip={R["steps"]}, keep=R["ckpt_every"])
    ops.reset_launches()
    log = io.StringIO()
    clocks = {n: _Clock(ckpt_lib, n) for n in ("_snapshot", "_write")}
    t1 = time.time()
    try:
        with contextlib.redirect_stdout(log):
            out = train_loop.run(cfg, ShapeConfig("train", R["seq"],
                                                  R["batch"], "train"),
                                 mesh=mesh, job=job)
    finally:
        skip.undo()
        for c_ in clocks.values():
            c_.undo()
    run_s = time.time() - t1
    _sync()
    launches = _launches(ops)
    peak = _peak_gb()
    card_peaks = _card_peaks(mesh)
    hist = out["history"]
    times = [h["sec_per_step"] for h in hist if 2 <= h["step"] <= 5]
    step_s = float(np.median(times))
    rec = dict(losses=[h["loss"] for h in hist], step_times=times,
               step_s=step_s, tokens_per_s=R["batch"] * R["seq"] / step_s,
               peak_gb=peak, card_peaks_gb=card_peaks,
               positions=len(mesh.devices),
               distinct_devices=mesh.distinct_devices, run_s=run_s,
               checkpoint_s={n: c_.s for n, c_ in clocks.items()})
    # one more step under the profiler, its bytes on the wire counted
    c = steps.adam_config_for(cfg)
    step = steps.make_train_step(cfg, c, lambda s: R["peak_lr"])
    batch = _on(_train_batches(cfg, R["batch"], R["seq"], 1)[0], DEVICE)
    params, opt = out.pop("params"), out.pop("opt_state")
    # for phase 9: the placed state (the step below consumes the moments)
    from repro_torch.launch.dryrun import position_bytes
    rec["state_bytes"] = sum(position_bytes((params, opt), p)
                             for p in range(len(mesh.devices)))
    rec["state_tensors"] = sum(
        len(l.shards) for l in _leaves((params, opt)) if hasattr(l, "shards"))
    col.WIRE.clear()

    def one():
        with use_sharding(mesh):
            step(params, opt, batch)
        return 1
    # the host's ops untraced: at 146k launches a step their events took
    # the profiler about a minute to sum on an H100 run
    t1 = time.time()
    rec["profile"] = _profile(one, cpu=False)
    rec["profile_s"] = time.time() - t1
    rec["wire"] = _mesh_wire(cfg, dict(col.WIRE), len(mesh.devices))
    rec["wire_sites"] = dict(col.WIRE)     # phase 9: the step's by site
    del params, opt, out, batch
    torch.cuda.empty_cache()
    losses = rec["losses"]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[1]:
        problems.append(f"mesh trainer: losses {losses}")
    w = rec["wire"]
    ev = w["comm_events"]
    ratios = dict(
        tp=w["tp_measured"] / ev.get("tp_sublayer_allreduce", float("nan")),
        grad=w["grad_measured"] / ev.get("grad_reduce_scatter",
                                         float("nan")),
        param=w["param_measured"] / ev.get("param_all_gather", float("nan")))
    rec["wire_ratios"] = ratios
    pr = rec["profile"]
    cards = mesh.distinct_devices
    line = (f"{TRAIN_ARCH} mesh trainer, 2x2 mesh on "
            + ("one card " if cards == 1 else f"{cards} cards ")
            + f"({cfg.n_layers} layers, fp32 params and moments, bf16 "
            f"activations, remat, "
            f"B={R['batch']}, S={R['seq']}): step {step_s * 1e3:.1f} ms "
            f"(median of steps 2-5), {rec['tokens_per_s']:.0f} tokens/s, "
            + (f"peak {peak:.2f} GB; losses " if cards == 1 else
               "peaks " + ", ".join(f"{g:.2f}" for g in card_peaks)
               + " GB; losses ")
            + ", ".join(f"{l:.4f}" for l in losses)
            + f"; a profiled step {pr['wall_ms']:.1f} ms, busy "
            f"{pr['busy_share']:.3f}, {pr['launches_per_step']:.0f} "
            f"launches, top {pr['top']}; wire bytes a position a step: "
            f"TP {w['tp_measured'] / 1e9:.3f} GB (comm_events "
            f"{ev.get('tp_sublayer_allreduce', 0) / 1e9:.3f}, x"
            f"{ratios['tp']:.3f}; by site "
            + ", ".join(f"{k} {v / 1e9:.4f}" for k, v in
                        w["per_position"].items() if not k.startswith(
                            ("zero", "grad norm", "int8")))
            + "), grad reduce-scatter "
            f"{w['grad_measured'] / 1e9:.3f} GB (x{ratios['grad']:.3f}), "
            f"param all-gather {w['param_measured'] / 1e9:.3f} GB "
            f"(x{ratios['param']:.3f}); kernel launches {launches}; the run "
            f"{run_s:.1f} s (step-3 snapshot "
            f"{rec['checkpoint_s']['_snapshot'][0]:.2f} s, write "
            f"{rec['checkpoint_s']['_write'][0]:.2f} s), the profiled step "
            f"{rec['profile_s']:.1f} s")
    return rec, launches, skip.kept, line


def elastic_restores(problems, tmp, kept, step3_loss):
    """The step-3 checkpoint restored onto each ELASTIC_MESHES mesh:
    every position's block equal to the saved array's, bit for bit; one
    more step on the first (1x4) with ``rebatch``'s batch.  Returns
    (record, line)."""
    from repro_torch import steps
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import adam
    from repro_torch.parallel.sharding import region, use_sharding
    from repro_torch.runtime import checkpoint as ckpt_lib, elastic
    R = MESH_RUN
    cfg = _trainer_cfg()
    c = steps.adam_config_for(cfg)
    rec = {}
    for d, m in ELASTIC_MESHES:
        mesh = make_test_mesh(d, m)
        torch.cuda.empty_cache()
        t0 = time.time()
        step, params, opt = elastic.restore_elastic(tmp, cfg, c, mesh)
        _sync()
        restore_s = time.time() - t0
        # each distinct block against the saved array's (copied to the
        # card), each replica against the first position holding it
        bad, blocks = [], 0
        for path, leaf in ckpt_lib._items({"params": params, "opt": opt}):
            want = torch.from_numpy(kept["/".join(path)])
            if leaf.ndim == 0:
                ok = torch.equal(leaf.cpu(), want)
            else:
                ok, first = True, {}
                for p, t in enumerate(leaf.shards):
                    blocks += 1
                    reg = region(leaf.shape, leaf.spec, mesh, p)
                    key = tuple((r.start, r.stop) for r in reg)
                    if key in first:
                        ok = ok and torch.equal(t, first[key])
                    else:
                        first[key] = t
                        ok = ok and torch.equal(t, want[reg].to(t.device))
            if not ok:
                bad.append("/".join(path))
        r = dict(step=step, restore_s=restore_s, blocks=blocks, bad=bad)
        if step != R["ckpt_every"] or bad:
            problems.append(f"elastic restore onto {d}x{m}: step {step}, "
                            f"{len(bad)} leaves differ ({bad[:3]})")
        if (d, m) == ELASTIC_MESHES[0]:
            per, accum = elastic.rebatch(R["batch"], R["data"], d)
            sched = lambda s: adam.warmup_cosine(
                s, peak_lr=R["peak_lr"], warmup=R["warmup"],
                total=R["steps"])
            stepf = steps.make_train_step(cfg, c, sched)
            batches = _train_batches(cfg, per, R["seq"], step + 2)
            with use_sharding(mesh):
                ctl, _ = steps.mesh_loss_and_grads(
                    cfg, params, _on(batches[step + 1], DEVICE))
                ctl = float(ctl["loss"])
                t0 = time.time()
                _, _, met = stepf(params, opt, _on(batches[step], DEVICE))
            _sync()
            rel = lambda x: abs(x - step3_loss) / abs(step3_loss)
            r.update(rebatch=(per, accum), loss=float(met["loss"]),
                     step_s=time.time() - t0, loss_2x2=step3_loss,
                     control_loss=ctl, gap=rel(float(met["loss"])),
                     control_gap=rel(ctl))
            if not r["gap"] <= ELASTIC_LOSS_TOL:
                problems.append(f"the step after the 1x4 restore: loss "
                                f"{r['loss']} against the 2x2 run's "
                                f"{step3_loss} ({r['gap']:.2e} relative)")
            if not r["control_gap"] > ELASTIC_LOSS_TOL:
                problems.append(f"the restored state on step {step + 1}'s "
                                f"batch: loss {ctl}, {r['control_gap']:.2e} "
                                f"from step 3's, within the gate")
        rec[f"{d}x{m}"] = r
        del params, opt
    a = rec["1x4"]
    line = (f"elastic restore of the 2x2 run's step-3 checkpoint: "
            + ", ".join(f"onto {k} in {r['restore_s']:.2f} s, {r['blocks']} "
                        f"blocks, {len(r['bad'])} leaves differing"
                        for k, r in rec.items())
            + f"; rebatch {a['rebatch']}; step 3 on 1x4 loss {a['loss']:.5f} "
            f"({a['step_s']:.2f} s) against the 2x2 run's {step3_loss:.5f} "
            f"({a['gap']:.2e} relative, gate {ELASTIC_LOSS_TOL:g}); the "
            f"control on step 4's batch {a['control_loss']:.5f} "
            f"({a['control_gap']:.2e})")
    return rec, line


def _compressed_plain(xs, es, n):
    """The compressed all-reduce of one group in one place: quantize each
    position's value, the mean of the dequantized chunks in group order,
    requantize, dequantize."""
    from repro_torch.optim import compress
    size = xs[0].numel()
    hats, errs = [], []
    for x, e in zip(xs, es):
        g = x.reshape(-1) + e.reshape(-1)
        q, s = compress._q8(g)
        hats.append(compress._dq8(q, s))
        errs.append(g - hats[-1])
    mean = hats[0]
    for h in hats[1:]:
        mean = mean + h
    mean = mean / n
    chunks = [compress._dq8(*compress._q8(c)) for c in mean.chunk(n)]
    return torch.cat(chunks)[:size], errs


def mesh_compress(problems):
    """``compressed_all_reduce`` over the data axis of a 4x1 mesh, a
    64 M-element fp32 gradient a position: against its plain version,
    8 error-feedback rounds, its bytes against ``wire_bytes``, its time
    beside the fp32 all-reduce's (``lattice_all_reduce`` over the same
    axis).  Returns (record, line)."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.optim import compress
    from repro_torch.parallel.lattice import lattice_all_reduce
    from repro_torch.parallel.sharding import use_sharding
    C = COMPRESS_RUN
    n, N = C["data"], C["words"]
    mesh = make_test_mesh(n, 1)
    gen = torch.Generator(DEVICE).manual_seed(SEED)
    xs = [torch.randn(N, generator=gen, device=DEVICE) for _ in range(n)]
    zeros = [torch.zeros(N, device=DEVICE) for _ in range(n)]
    with use_sharding(mesh):
        stats = {}
        out, errs = compress.compressed_all_reduce(xs, zeros, "data",
                                                   stats=stats)
        plain, perr = _compressed_plain(xs, zeros, n)
        err = max(max_err(o, plain) for o in out)
        err_e = max(max_err(a, b) for a, b in zip(errs, perr))
        mean = sum(xs) / n
        acc = torch.zeros(N, device=DEVICE)
        e = zeros
        for _ in range(C["rounds"]):
            red, e = compress.compressed_all_reduce(xs, e, "data")
            acc += red[0]
        rel = float((acc / C["rounds"] - mean).abs().max()
                    / mean.abs().max())
        del acc, e, red
        ms = time_ms(lambda: compress.compressed_all_reduce(
            xs, zeros, "data"), iters=5)
        lat = {}
        ms_fp32 = time_ms(lambda: lattice_all_reduce(
            xs, fast_axes=("data",), slow_axis="pod", stats=lat), iters=5)
    moved = sum(stats.values())
    want = compress.wire_bytes(N, n, "int8_ef")
    rec = dict(words=N, positions=n, max_abs_err=err, err_residual=err_e,
               ef_rel=rel, bytes=moved, wire_bytes=want, ms=ms,
               fp32_ms=ms_fp32, fp32_bytes=sum(lat.values()))
    if not (err <= 0 and err_e <= 0):
        problems.append(f"compressed all-reduce against plain: {err}, "
                        f"residual {err_e}")
    if not rel < C["tol"]:
        problems.append(f"compressed all-reduce error feedback: {rel}")
    if moved != want:
        problems.append(f"compressed all-reduce moved {moved} B, "
                        f"wire_bytes {want}")
    del xs, zeros, out, errs, plain, perr
    torch.cuda.empty_cache()
    return rec, (
        f"compressed all-reduce over a 4x1 mesh's data axis, 64 M fp32 a "
        f"position: against plain {err:.3g} (residual {err_e:.3g}), 8 "
        f"error-feedback rounds' mean {rel:.3g} of the true mean's max (tol "
        f"{C['tol']}); {moved} B a position = wire_bytes {want:.0f} "
        f"(fp32 all-reduce {rec['fp32_bytes']} B); {ms:.3f} ms, the fp32 "
        f"all-reduce {ms_fp32:.3f} ms (four positions on one card: the "
        f"transfers are device-local)")


def mesh_cli(problems):
    """The train CLI on a mesh in a process of its own, each of
    MESH_CLI's flag sets; output in chiprun_out/mesh_train_cli.txt."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    text, rec = [], []
    for argv in MESH_CLI:
        t0 = time.time()
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                           + argv, capture_output=True, text=True,
                           timeout=600, cwd=ROOT, env=env)
        text.append(f"$ train {' '.join(argv)}\n{r.stdout}{r.stderr}")
        final = [x for x in r.stdout.splitlines() if x.startswith("final:")]
        mesh = [x for x in r.stdout.splitlines() if x.startswith("mesh ")]
        rec.append(dict(argv=argv, rc=r.returncode, s=time.time() - t0,
                        mesh=mesh[0] if mesh else None))
        if r.returncode or not final or not mesh:
            problems.append(f"train CLI {' '.join(argv)}: exit "
                            f"{r.returncode}; {r.stderr[-800:]}")
    OUT.mkdir(exist_ok=True)
    (OUT / "mesh_train_cli.txt").write_text("\n".join(text))
    return rec, "train CLI in its own process: " + "; ".join(
        f"{' '.join(x['argv'])}: exit {x['rc']} in {x['s']:.1f} s "
        f"({x['mesh']})" for x in rec)


def mesh_phase(ops):
    """Phase 7: training on a device mesh, every position on the one
    card.  Returns (records, {path: launches}, lines)."""
    import shutil
    import tempfile
    t0 = time.time()
    recs, lines, problems = {}, [], []
    clock = {}

    def timed(name, fn, *args):
        t1 = time.time()
        out = fn(*args)
        clock[name] = time.time() - t1
        return out
    recs["parity"], ls = timed("parity", mesh_parity, problems)
    lines += ls
    tmp = tempfile.mkdtemp(prefix="mesh_ckpt_")
    try:
        recs["trainer"], launches, kept, line = timed(
            "trainer", mesh_trainer, ops, problems, tmp)
        lines.append(line)
        step3 = recs["trainer"]["losses"][MESH_RUN["ckpt_every"]]
        recs["elastic"], line = timed("elastic", elastic_restores, problems,
                                      tmp, kept, step3)
        lines.append(line)
        del kept
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    recs["compress"], line = timed("compress", mesh_compress, problems)
    lines.append(line)
    recs["cli"], line = timed("cli", mesh_cli, problems)
    lines.append(line)
    recs["seconds"] = time.time() - t0
    recs["section_s"] = clock
    lines.append(f"phase 7 took {recs['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in clock.items()) + ")")
    if problems:
        for line in lines:
            print(f"[mesh] {line}")
        fail("phase 7: " + "; ".join(problems))
    return recs, {"mesh train: qwen3-1.7b 2x2": launches}, lines


# ---------------------------------------------------------------------------
# phase 8 — the dense engine on a device mesh (every position on the one
# card), and the mesh trainer for every family
# ---------------------------------------------------------------------------
EP_RULES = {"expert": "model", "expert_ff": None}
# (a) each family's dense engine on meshes against the one-device dense
# engine on the card: published widths, depth cut, fp32 activations,
# impl=pallas; 2 prompts of 64 tokens (gemma2's 4100: past its window, the
# ring caches wrap) and 10 tokens each.  max_len 74 splits over 2
# positions (split-T) and not over 4 (every position keeps the whole
# cache, the global layers through the decode kernel).  Tokens must be
# identical (a row may flip only where the one-device top-2 margin is
# below 2 tol); logits within tol until the first flip.
DMESH_PARITY = dict(batch=2, prompt_len=64, gen=10, tol=1e-3)
DMESH_CASES = (
    ("qwen3-1.7b", dict(n_layers=2), ((1, 2), (2, 2), (1, 4)), (None,), 64),
    ("grok-1-314b", dict(n_layers=2), ((1, 2),), (None, EP_RULES), 64),
    ("deepseek-v3-671b", dict(n_layers=2, first_k_dense=1, mtp_depth=0),
     ((1, 2),), (None,), 64),
    ("gemma2-27b", dict(n_layers=2), ((1, 2),), (None,), 4100),
    ("recurrentgemma-2b", dict(n_layers=3), ((1, 2),), (None,), 64),
    ("rwkv6-1.6b", dict(n_layers=2), ((1, 2),), (None,), 64))
# (b) full width, bf16: qwen3-1.7b at 28 layers on 1x4 and 2x2, grok-1 at
# GROK_DEPTH layers on 1x2 under expert-TP and EP; tokens held to the
# one-device run under the bf16 near-tie rule (_bf16_ties)
DMESH_RUNS = {"qwen3-1.7b": dict(requests=4, batch=4, prompt_len=512, gen=16,
                                 meshes=((1, 4, None), (2, 2, None))),
              "grok-1-314b": dict(requests=4, batch=4, prompt_len=256,
                                  gen=16, meshes=((1, 2, None),
                                                  (1, 2, EP_RULES)))}
# (c) the mesh trainer's item-16 families, MESH_PARITY's steps (2 layers,
# fp32, B=4, S=256, 3 steps at lr 1e-5, fp32 moments) with phase 6's
# gates: on 1x2 against the one-device trainer on the card; grok on 2x1
# against the same mesh on the CPU (a data axis changes MoE's loss by
# design).  rwkv6 at its published widths, recurrentgemma at its
# published widths but a vocabulary of 32,768 (its 256,000 took 29.7 s of
# the phase's 197 s on an H100).  grok on the card at its published
# d_model, heads and 8 experts top-2, its experts' d_ff cut from 32,768
# to 4,096 and its vocabulary from 131,072 to 8,192: the card holds the
# one-device run's parameters and moments beside the mesh run (53.5 GB
# at its peak on an H100; an expert d_ff of 8,192 would need about 96);
# DeepSeek at cut widths (its 256 experts at full width do not train on
# one card).
# The CPU run of grok's 2x1 mesh at d_model 512 (TRAIN_CPU_CUT): the data
# axis's capacity and aux rules do not depend on the width, and at d_model
# 1024 that run took 36.5 s beside the card's
TRAIN_FAMILY_CUTS = {
    "grok-1-314b": dict(vocab_size=8192, moe=dict(d_ff_expert=4096)),
    "deepseek-v3-671b": dict(d_model=1024, n_heads=8, n_kv_heads=8,
                             head_dim=128, d_ff=2048, vocab_size=16384,
                             first_k_dense=1,
                             moe=dict(n_experts=16, top_k=4,
                                      d_ff_expert=512),
                             mla=dict(q_lora_rank=256, kv_lora_rank=128)),
    "recurrentgemma-2b": dict(vocab_size=32768), "rwkv6-1.6b": dict()}
TRAIN_CPU_CUT = dict(d_model=512, n_heads=8, n_kv_heads=4, head_dim=64,
                     d_ff=2048, vocab_size=8192,
                     moe=dict(n_experts=8, d_ff_expert=2048))
TRAIN_FAMILY_MESHES = (("grok-1-314b", (1, 2), None),
                       ("grok-1-314b", (1, 2), EP_RULES),
                       ("deepseek-v3-671b", (1, 2), None),
                       ("recurrentgemma-2b", (1, 2), None),
                       ("rwkv6-1.6b", (1, 2), None),
                       ("grok-1-314b", (2, 1), "cpu"))
ZERO_INIT = r"(conv_b|lru_(a|x)_gate_b|rwkv_mix_(x|base)|rwkv_ln_bias)$"
DMESH_CLI = ["--arch", "qwen3-1.7b", "--engine", "dense", "--model", "2",
             "--requests", "4", "--batch", "4", "--prompt-len", "128",
             "--gen", "16"]


def _dmesh_greedy(cfg, params, tok0, plen, gen_len, mesh=None):
    """The dense engine's greedy run: (tokens (gen_len lists of B ids),
    each step's logits on the host, the top-2 margins)."""
    from repro_torch import steps
    prefill = steps.make_prefill_step(cfg, plen + gen_len, mesh=mesh)
    serve = steps.make_serve_step(cfg, mesh=mesh)
    logits, caches = prefill(params, tok0)
    toks, lgs, mg = [], [], []
    for j in range(gen_len):
        top2 = logits[:, 0].topk(2).values
        mg.append((top2[:, 0] - top2[:, 1]).tolist())
        lgs.append(logits[:, 0].float().cpu())
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok[:, 0].tolist())
        if j < gen_len - 1:
            tok, logits, caches = serve(params, tok, caches, plen + j)
    return toks, lgs, mg


def dense_mesh_parity(ops, problems):
    """(a): every DMESH_CASES mesh against one device.  Returns (records,
    the kernels' launches over the mesh runs, lines)."""
    from repro_torch import weights
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import make_prompts
    from repro_torch.parallel.sharding import use_sharding
    P = DMESH_PARITY
    recs, lines = {}, []
    total = {fn.__name__: 0 for fn in ops.WRAPPERS}
    for arch, cut, meshes, rules_list, plen in DMESH_CASES:
        cfg = get_config(arch).replace(activation_dtype="float32",
                                       impl="pallas", **cut)
        params = weights.init_params(cfg, torch.Generator(
            device=DEVICE).manual_seed(SEED + 8), DEVICE)
        tok0 = torch.tensor(np.stack(make_prompts(
            P["batch"], plen, cfg.vocab_size, SEED + 8)), device=DEVICE)
        one = _dmesh_greedy(cfg, params, tok0, plen, P["gen"])
        for rules in rules_list:
            for shape in meshes:
                mesh = make_test_mesh(*shape)
                what = (f"{arch} {shape[0]}x{shape[1]}"
                        + (" EP" if rules else ""))
                ops.reset_launches()
                with use_sharding(mesh, rules):
                    placed = weights.shard_params(params, cfg, mesh)
                    got = _dmesh_greedy(cfg, placed, tok0, plen, P["gen"],
                                        mesh)
                _sync()
                for k, v in _launches(ops).items():
                    total[k] += v
                del placed
                seqs = {"pallas": got[0], "ref": one[0]}
                inf = [[float("inf")] * P["batch"] for _ in one[0]]
                flips = _token_flips(seqs, one[2], P["tol"], inf, what)
                upto = min([j for _, j, _, _ in flips] + [P["gen"]])
                err = max((max_err(a, b) for a, b in
                           zip(got[1][:upto + 1], one[1][:upto + 1])),
                          default=0.0)
                if not err <= P["tol"]:
                    problems.append(f"dense mesh {what}: logits {err:.3g} "
                                    f"> {P['tol']}")
                recs[what] = dict(logit_err=err, flips=flips,
                                  n_layers=cfg.n_layers, prompt_len=plen)
                lines.append(
                    f"dense mesh parity {what} ({cfg.n_layers} layers at "
                    f"published widths, fp32 activations, impl=pallas, "
                    f"{P['batch']} prompts of {plen} x {P['gen']} tokens): "
                    f"against one device on the card, logits max abs err "
                    f"{err:.3g} (tol {P['tol']}), greedy tokens "
                    + ("identical" if not flips else
                       f"differ only at near-ties {flips}"))
        del params
        torch.cuda.empty_cache()
    return recs, total, lines


def _dmesh_wire(cfg, run, mesh, steps_n, wire):
    """Each position's bytes a decode step by collective, beside
    ``core/costs.comm_events`` for the decode shape and layout."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core import costs
    n_pos = len(mesh.devices)
    per = {k: v / n_pos / steps_n for k, v in sorted(wire.items())}
    events = {e.name: e.wire_bytes_per_device() for e in costs.comm_events(
        cfg, ShapeConfig("serve", run["prompt_len"] + run["gen"],
                         run["batch"], "decode"),
        costs.Layout(data=mesh.shape["data"], model=mesh.shape["model"]))}
    return dict(per_position=per, measured=sum(per.values()),
                comm_events=events)


def _dmesh_profile(cfg, placed, mesh, rules, args, prompts, run):
    """A profiled prefill of the first batch and four profiled decode
    steps on ``mesh``, their bytes on the wire counted.  Returns (the
    profiles, ``_dmesh_wire``, whether the last logits are finite, those
    logits on the host)."""
    from repro_torch import steps
    from repro_torch.parallel import collectives as col
    from repro_torch.parallel.sharding import use_sharding
    with use_sharding(mesh, rules):
        prefill = steps.make_prefill_step(cfg, args.prompt_len + args.gen,
                                          mesh=mesh)
        serve = steps.make_serve_step(cfg, mesh=mesh)
        tok = torch.tensor(np.stack(prompts[:args.batch]), device=DEVICE)
        state = {}

        def run_prefill():
            state["l"], state["c"] = prefill(placed, tok)
            return 1

        def run_decode(n=4):
            t = state["l"].argmax(-1).to(torch.int32)
            for i in range(n):
                t, state["l"], state["c"] = serve(placed, t, state["c"],
                                                  args.prompt_len + i)
            return n
        prof = dict(prefill=_profile(run_prefill, cpu=False))
        col.WIRE.clear()
        prof["decode"] = _profile(run_decode, cpu=False)
        wire = _dmesh_wire(cfg, run, mesh, 4, dict(col.WIRE))
    last = state["l"].float().cpu()
    return prof, wire, bool(torch.isfinite(last).all()), last


def dense_mesh_serve(ops, problems):
    """(b): DMESH_RUNS through ``run_dense`` on each mesh, the one-device
    run's tokens beside them.  Returns (records, {path: launches},
    lines)."""
    from repro_torch import weights
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import build_parser, make_prompts, \
        run_dense
    from repro_torch.parallel.sharding import use_sharding
    recs, launches, lines = {}, {}, []
    for arch, run in DMESH_RUNS.items():
        args = build_parser().parse_args(
            [f"--{k.replace('_', '-')}={v}" for k, v in run.items()
             if k != "meshes"] + [f"--seed={SEED}"])
        cfg, params = full_width_params(arch)
        prompts = make_prompts(args.requests, args.prompt_len,
                               cfg.vocab_size, SEED)
        base, st1 = run_dense(args, cfg, params=params, device=DEVICE)
        base = {f"req{i}": t for i, t in base.items()}
        for d, m, rules in run["meshes"]:
            mesh = make_test_mesh(d, m)
            what = f"{arch} {d}x{m}" + (" EP" if rules else "")
            if params is None:           # consumed by the run before
                cfg, params = full_width_params(arch)
            keep = arch != "grok-1-314b"     # grok's copy does not fit
            with use_sharding(mesh, rules):
                placed = weights.shard_params(params, cfg, mesh,
                                              consume=not keep)
            if not keep:
                params = None
            torch.cuda.empty_cache()
            _sync()
            _reset_peak()
            ops.reset_launches()
            with use_sharding(mesh, rules):
                out, st = run_dense(args, cfg, params=placed, mesh=mesh,
                                    rules=rules)
            _sync()
            launches[f"dense mesh: {what}"] = _launches(ops)
            peak = _peak_gb()
            got = {f"req{i}": t for i, t in out.items()}
            if keep:
                ties = _bf16_ties(cfg, params, prompts, base, got, what)
            else:
                ties = _bf16_ties(cfg, placed, prompts, base, got, what,
                                  mesh=mesh, rules=rules)
            prof, wire, finite, _ = _dmesh_profile(cfg, placed, mesh, rules,
                                                   args, prompts, run)
            if not finite:
                problems.append(f"dense mesh {what}: non-finite logits")
            del placed
            torch.cuda.empty_cache()
            tp = wire["comm_events"].get("tp_sublayer_allreduce", 0.0)
            rec = dict(decode_step_ms=st["step_s"] * 1e3,
                       prefill_ms=st["prefill_s"] * 1e3,
                       tok_per_s=st["tokens"] / st["seconds"],
                       one_device_step_ms=st1["step_s"] * 1e3,
                       one_device_tok_per_s=st1["tokens"] / st1["seconds"],
                       peak_gb=peak, ties=ties, profile=prof, wire=wire,
                       launches=launches[f"dense mesh: {what}"])
            recs[what] = rec
            dp = prof["decode"]
            lines.append(
                f"dense mesh serve {what} on one card ({cfg.n_layers} "
                f"layers, bf16, impl=pallas, {args.requests} requests x "
                f"{args.gen} tokens, batch {args.batch}, prompt "
                f"{args.prompt_len}): decode step "
                f"{rec['decode_step_ms']:.3f} ms (one device "
                f"{rec['one_device_step_ms']:.3f}), prefill "
                f"{rec['prefill_ms']:.3f} ms, {rec['tok_per_s']:.1f} tok/s "
                f"(one device {rec['one_device_tok_per_s']:.1f}), peak "
                f"{peak:.2f} GB; tokens against one device: "
                + ("identical" if not ties else f"bf16 near-ties {ties}")
                + f"; profiled decode step {dp['wall_ms'] / 4:.3f} ms wall, "
                f"busy {dp['busy_share']:.3f}, "
                f"{dp['launches_per_step']:.0f} launches, top {dp['top']}; "
                f"wire a position a decode step "
                f"{wire['measured'] / 1e6:.4f} MB ("
                + ", ".join(f"{k} {v / 1e6:.4f}" for k, v in
                            wire["per_position"].items())
                + f"), comm_events tp_sublayer_allreduce {tp / 1e6:.4f} MB"
                + (f", moe_dispatch_combine "
                   f"{wire['comm_events']['moe_dispatch_combine'] / 1e6:.4f}"
                   f" MB" if "moe_dispatch_combine" in wire["comm_events"]
                   else "")
                + f"; launches {rec['launches']}")
        del params
        torch.cuda.empty_cache()
    return recs, launches, lines


def _family_train_cfg(arch, cpu=False):
    """``arch`` at MESH_PARITY's depth and TRAIN_FAMILY_CUTS' widths (with
    ``cpu``, TRAIN_CPU_CUT's), fp32, impl=blocked (the kernels have no
    backward)."""
    from repro_torch.configs import get_config
    cut = dict(TRAIN_CPU_CUT if cpu else TRAIN_FAMILY_CUTS[arch])
    cfg = get_config(arch)
    for k in ("moe", "mla"):
        if k in cut:
            cut[k] = dataclasses.replace(getattr(cfg, k), **cut[k])
    return cfg.replace(n_layers=MESH_PARITY["n_layers"],
                       activation_dtype="float32", param_dtype="float32",
                       impl="blocked", **cut)


def family_train(problems):
    """(c): TRAIN_FAMILY_MESHES' mesh trainer runs against one device on
    the card (or, "cpu", the same mesh on the CPU), phase 6's gates."""
    from repro_torch import weights
    from repro_torch.launch.mesh import make_test_mesh
    P = MESH_PARITY
    recs, lines = {}, []
    ones = {}
    for arch, shape, rules in TRAIN_FAMILY_MESHES:
        cfg = _family_train_cfg(arch, cpu=rules == "cpu")
        paths = ["/".join(k) for k, _ in _ckpt_items(weights.to_reference(
            weights.init_params(cfg, device="meta"), cfg))]
        t0 = time.time()
        if rules == "cpu":
            other = _mesh_parity_run(cfg, "float32",
                                     make_test_mesh(*shape, devices="cpu"),
                                     device="cpu")
            got = _mesh_parity_run(cfg, "float32", make_test_mesh(*shape),
                                   init="cpu")
            rules, against = None, "the same mesh on the CPU"
        else:
            if arch not in ones:
                ones[arch] = _mesh_parity_run(cfg, "float32", None)
            other, against = ones[arch], "one device on the card"
            got = _mesh_parity_run(cfg, "float32", make_test_mesh(*shape),
                                   rules=rules)
        metric = max(abs(g[k] - h[k]) / max(abs(h[k]), 1e-30)
                     for h, g in zip(other[2], got[2])
                     for k in ("loss", "grad_norm"))
        # a leaf that is zero at init is all update, lr m/(sqrt(v)+eps) a
        # step, whose sign an entry with a vanishing gradient takes from
        # rounding: it is held by the moments' gate instead
        keep = [i for i, p in enumerate(paths)
                if not re.search(ZERO_INIT, p)]
        (share, share_at), (worst, _) = _param_errs(
            [other[0][i] for i in keep], [got[0][i] for i in keep],
            [paths[i] for i in keep])
        m_rel = max(_moment_errs(other[1][i], got[1][i])[0] for i in (0, 1))
        what = (f"mesh trainer {arch} {shape[0]}x{shape[1]}"
                + (" EP" if rules else ""))
        if not metric <= STEP_TOL["metric"]:
            problems.append(f"{what}: loss / grad norm {metric:.3g}")
        if not share <= STEP_TOL["param_share"]:
            problems.append(f"{what}: {share:.3g} of {share_at} more than "
                            f"{STEP_TOL['param_near']} apart")
        if not m_rel <= STEP_TOL["moment"]:
            problems.append(f"{what}: moments {m_rel:.3g}")
        recs[what] = dict(metric_rel_err=metric, param_share_off=share,
                          param_share_leaf=share_at, param_max_abs=worst,
                          moment_rel_err=m_rel,
                          losses=[h["loss"] for h in got[2]],
                          seconds=time.time() - t0, d_model=cfg.d_model)
        lines.append(
            f"{what} (2 layers, d_model {cfg.d_model}, fp32, B={P['batch']},"
            f" S={P['seq']}, 3 steps at lr {P['lr']}) against {against}: "
            f"loss and grad norm within {metric:.3g} (tol "
            f"{STEP_TOL['metric']}); parameters at most {share:.3g} of a "
            f"leaf ({share_at}) more than {STEP_TOL['param_near']} of its "
            f"max apart, largest gap {worst:.3g}; moments {m_rel:.3g}; "
            f"losses {', '.join(f'{l:.5f}' for l in recs[what]['losses'])}")
        del got
        torch.cuda.empty_cache()
    return recs, lines


PIPE_GRAD = dict(stages=4, micro=8, batch=64, width=1024)


def pipeline_backward(problems, devices=None):
    """``pipeline_apply``'s backward on a 4-stage mesh on the one card
    (or on ``devices``; a CUDA stream a position, the gradients handed
    back through the sends) against autograd of the stages run in order:
    fp32, tanh stages of PIPE_GRAD's width.  The record keeps the
    pipeline's gradients (``grads``, on the host)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.pipeline import pipeline_apply
    from repro_torch.parallel.sharding import use_sharding
    P = PIPE_GRAD
    g = torch.Generator(device=DEVICE).manual_seed(SEED)
    w = (torch.randn(P["stages"], P["width"], P["width"], generator=g,
                     device=DEVICE) * P["width"] ** -0.5).requires_grad_()
    x = torch.randn(P["batch"], P["width"], generator=g, device=DEVICE,
                    requires_grad=True)
    c = torch.randn(P["batch"], P["width"], generator=g, device=DEVICE)

    def stage(q, t):
        return torch.tanh(t @ q)
    grads = {}
    for name in ("plain", "pipeline"):
        t0 = time.time()
        if name == "plain":
            y = x
            for s_ in range(P["stages"]):
                y = stage(w[s_], y)
        else:
            with use_sharding(make_mesh((P["stages"],), ("stage",),
                                        devices)):
                y = pipeline_apply(stage, [w[s_] for s_ in
                                           range(P["stages"])], x,
                                   n_micro=P["micro"])
        grads[name] = torch.autograd.grad((y * c).sum(), (w, x))
        _sync()
        grads[name + "_s"] = time.time() - t0
    err = max(max_err(a, b) / float(b.abs().max())
              for a, b in zip(grads["pipeline"], grads["plain"]))
    if not err <= 1e-5:
        problems.append(f"pipeline backward: gradients {err:.3g} of their "
                        "max from the plain run's")
    cards = len({str(torch.empty(0, device=d).device) for d in devices}) \
        if devices is not None else 1
    return dict(rel_err=err, s=grads["pipeline_s"],
                plain_s=grads["plain_s"],
                grads=[t.cpu() for t in grads["pipeline"]]), (
        f"pipeline backward, {P['stages']} stages x {P['micro']} "
        f"microbatches on {cards} card(s) (a stream a stage), fp32 tanh "
        f"stages "
        f"{P['batch']} x {P['width']}: gradients within {err:.3g} of their "
        f"max of the stages run in order (tol 1e-5); {grads['pipeline_s']:.3f}"
        f" s, in order {grads['plain_s']:.3f} s")


def dense_mesh_cli(problems, cards=1):
    """(d): the serve CLI's dense engine on a 1x2 mesh in a process of
    its own, its positions on ``cards`` distinct cards (round-robin over
    the visible cards); output in chiprun_out/serve_cli_dense_mesh.txt."""
    import os
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve"]
                       + DMESH_CLI, capture_output=True, text=True,
                       timeout=600, cwd=ROOT, env=env)
    s = time.time() - t0
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "serve_cli_dense_mesh.txt").write_text(
        f"$ serve {' '.join(DMESH_CLI)}\n{r.stdout}{r.stderr}")
    lines = r.stdout.splitlines()
    mesh = [x for x in lines if x.startswith("[dense] mesh")]
    served = [x for x in lines if "served" in x]
    # the positions must lie on the card, not fall back to the CPU
    if r.returncode or not mesh or "cuda" not in mesh[0] or not served \
            or f"on {cards} distinct device(s)" not in mesh[0]:
        problems.append(f"serve CLI {' '.join(DMESH_CLI)}: exit "
                        f"{r.returncode}; {r.stderr[-800:]}")
    return dict(rc=r.returncode, s=s, lines=mesh + served), (
        f"serve CLI {' '.join(DMESH_CLI)} in its own process: exit "
        f"{r.returncode} in {s:.1f} s; " + "; ".join(mesh + served))


def dense_mesh_phase(ops):
    """Phase 8: the dense engine on device meshes and the mesh trainer's
    item-16 families, every position on the one card.  Returns (records,
    {path: launches}, lines)."""
    t0 = time.time()
    recs, lines, problems, clock = {}, [], [], {}

    def timed(name, fn, *args):
        t1 = time.time()
        out = fn(*args)
        clock[name] = time.time() - t1
        return out
    recs["parity"], parity_launches, ls = timed("parity", dense_mesh_parity,
                                                ops, problems)
    lines += ls
    recs["serve"], launches, ls = timed("serve", dense_mesh_serve, ops,
                                        problems)
    lines += ls
    launches["dense mesh parity"] = parity_launches
    recs["train"], ls = timed("train", family_train, problems)
    lines += ls
    recs["pipeline"], line = timed("pipeline", pipeline_backward, problems)
    del recs["pipeline"]["grads"]
    lines.append(line)
    recs["cli"], line = timed("cli", dense_mesh_cli, problems)
    lines.append(line)
    phase = {fn.__name__: sum(l[fn.__name__] for l in launches.values())
             for fn in ops.WRAPPERS}
    kern = {}
    for w, n in phase.items():
        kern[ops.KERNEL_OF[w]] = kern.get(ops.KERNEL_OF[w], 0) + n
    recs["kernel_launches"] = kern
    for k in ("flash_attention", "moe_gemm", "rmsnorm", "rglru_scan",
              "rwkv6_scan", "decode_attention"):
        if not kern.get(k):
            problems.append(f"{k} never launched on the dense mesh paths")
    recs["seconds"] = time.time() - t0
    recs["section_s"] = clock
    lines.append(f"kernel launches on the dense mesh paths: {kern}")
    lines.append(f"phase 8 took {recs['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in clock.items()) + ")")
    if problems:
        for line in lines:
            print(f"[dense-mesh] {line}")
        fail("phase 8: " + "; ".join(problems))
    return recs, launches, lines


# ---------------------------------------------------------------------------
# phase 9 — the dry run (``launch/dryrun.py``) held against the card
# ---------------------------------------------------------------------------
# (b): qwen3-1.7b at full width under impl="pallas" on a 1x4 mesh: a
# prefill of 64 tokens into caches of 74 slots, which do not split over 4
# (every position keeps the whole cache: the decode kernel's path), and
# one decode step
DRY_SERVE = dict(arch="qwen3-1.7b", data=1, model=4, batch=4, prompt_len=64,
                 max_len=74)


def dry_trainer(trainer, problems):
    """(a): the dry run of phase 7's trainer (its config, B, S and 2x2
    mesh, on meta positions, every data group at full depth, sends as
    views: the positions share the one card) against the measured step:
    the wire bytes by site equal, the placed state equal to the
    positions' predicted arguments less their batch shards (within the
    allocator's 512 bytes a block), the peak and the step time beside
    the prediction and the H100 roofline; and a position's arguments +
    temp with received blocks (a card of its own), printed.  Returns
    (record, line)."""
    from repro_torch.analysis import roofline
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    R = MESH_RUN
    cfg = _trainer_cfg()
    shape = ShapeConfig("train", R["seq"], R["batch"], "train")
    mesh = make_test_mesh(R["data"], R["model"], devices="meta")
    n = len(mesh.devices)
    t1 = time.time()
    # every group at full depth: the whole mesh's peak, which one card
    # holding all the positions is held against (received blocks left
    # out: a send between positions that share a card is a view)
    pred = dryrun.dry_step(cfg, shape, mesh, symmetry=False, received=False)
    own = dryrun.dry_step(cfg, shape, mesh)["memory"]
    dry_s = time.time() - t1
    got, want = trainer["wire_sites"], pred["wire_bytes_by_site"]
    sites = sorted(set(got) | set(want))
    off = {k: (got.get(k, 0), want.get(k, 0)) for k in sites
           if got.get(k, 0) != want.get(k, 0)}
    if off or not sites:
        problems.append(f"dry run: wire bytes by site differ {off}")
    # the batch shard a position: tokens and labels int32, mask fp32
    batch_pos = R["batch"] // R["data"] * R["seq"] * 12
    state_pred = n * (pred["memory"]["argument_size_in_bytes"] - batch_pos)
    slack = 512 * trainer["state_tensors"]
    if not abs(trainer["state_bytes"] - state_pred) <= slack:
        problems.append(f"dry run: placed state {trainer['state_bytes']} B, "
                        f"predicted {state_pred} B")
    peak_pred = pred["memory"]["peak_bytes_mesh"]
    rl = roofline.analyze(cfg, shape, f"{R['data']}x{R['model']}", n,
                          R["model"], collectives=pred["collectives"],
                          cost_analysis=pred["cost_analysis"])
    t_model = rl.model_flops / (n * roofline.H100.peak_flops_bf16)
    rec = dict(predicted=pred, position=own, dry_s=dry_s, wire_sites=got,
               state_bytes=trainer["state_bytes"], state_predicted=state_pred,
               peak_bytes=trainer["peak_gb"] * 1e9, peak_predicted=peak_pred,
               peak_ratio=trainer["peak_gb"] * 1e9 / peak_pred,
               step_s=trainer["step_s"], roofline=rl.to_dict(),
               measured_fraction=rl.step_time_bound / trainer["step_s"],
               model_fraction=t_model / trainer["step_s"])
    line = (f"(a) {TRAIN_ARCH} trainer ({cfg.n_layers} layers, B="
            f"{R['batch']}, S={R['seq']}, {R['data']}x{R['model']}) dry run "
            f"in {dry_s:.1f} s ({pred['symmetry']}): wire by site "
            + ("equal at all " if not off else "DIFFERENT at ")
            + f"{len(sites)} sites ({sum(got.values()) / 1e9:.6f} GB a "
            f"step); placed state {trainer['state_bytes']} B, predicted "
            f"{state_pred} B ({n} x (argument_size_in_bytes "
            f"{pred['memory']['argument_size_in_bytes']} - batch shard "
            f"{batch_pos})); peak {rec['peak_bytes'] / 1e9:.3f} GB measured "
            f"(the run's max_memory_allocated), {peak_pred / 1e9:.3f} GB "
            f"predicted without received blocks (ratio "
            f"{rec['peak_ratio']:.3f}); a position on a card of its own: "
            f"arguments {own['argument_size_in_bytes'] / 1e9:.3f} + temp "
            f"{own['temp_size_in_bytes'] / 1e9:.3f} GB predicted with "
            f"received blocks (measured in phase 10, four cards); FLOPs "
            f"counted "
            f"{pred['cost_analysis']['flops']:.6g} (model "
            f"{rl.model_flops:.6g}); H100 roofline ({n} chips): compute "
            f"{rl.t_compute:.4f} s, memory {rl.t_memory:.4f} s, collective "
            f"{rl.t_collective:.4f} s, bound {rl.step_time_bound:.4f} s "
            f"({rl.dominant}); measured step {trainer['step_s']:.4f} s on "
            f"one card holding all {n} positions: measured roofline "
            f"fraction {rec['measured_fraction']:.4f} (bound / step), "
            f"model FLOPs {rec['model_fraction']:.4f}; {gpu_info()}")
    return rec, line


def dry_serve(ops, problems, mesh=None):
    """(b): the kernels' dry calls of a prefill and of a decode step on
    a meta 1x4 mesh (DRY_SERVE) against the launches of the same prefill
    and step on the card (or on ``mesh``: their sum over its cards).
    Returns (record, {path: launches}, line)."""
    from repro_torch import steps, weights
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.sharding import use_sharding
    D = DRY_SERVE
    cfg, params = full_width_params(D["arch"])
    mesh = mesh or make_test_mesh(D["data"], D["model"])
    with use_sharding(mesh):
        placed = weights.shard_params(params, cfg, mesh, consume=True)
    del params
    torch.cuda.empty_cache()
    _sync()
    _reset_peaks(mesh)
    tok = torch.tensor(np.random.default_rng(SEED).integers(
        2, cfg.vocab_size, (D["batch"], D["prompt_len"])), dtype=torch.int32,
        device=DEVICE)
    prefill = steps.make_prefill_step(cfg, D["max_len"], mesh=mesh)
    serve = steps.make_serve_step(cfg, mesh=mesh)
    with torch.no_grad(), use_sharding(mesh):
        ops.reset_launches()
        lg, caches = prefill(placed, tok)
        _sync()
        got = {"prefill": _launches(ops)}
        ops.reset_launches()
        _, lg, caches = serve(placed, lg.argmax(-1).to(torch.int32), caches,
                              D["prompt_len"])
        _sync()
        got["decode"] = _launches(ops)
    peaks = _card_peaks(mesh)
    finite = bool(torch.isfinite(lg).all())
    del placed, caches, lg
    torch.cuda.empty_cache()
    meta = make_test_mesh(D["data"], D["model"], devices="meta")
    t1 = time.time()
    dry = {"prefill": dryrun.dry_step(cfg, ShapeConfig(
               "prefill", D["prompt_len"], D["batch"], "prefill"), meta),
           "decode": dryrun.dry_step(cfg, ShapeConfig(
               "decode", D["max_len"], D["batch"], "decode"), meta)}
    want = {k: r["kernel_dry_calls"] for k, r in dry.items()}
    held = {k: r["memory"]["argument_size_in_bytes"]
            + r["memory"]["temp_size_in_bytes"] for k, r in dry.items()}
    dry_s = time.time() - t1
    for what in ("prefill", "decode"):
        if got[what] != want[what]:
            problems.append(f"dry run: {what} launches {got[what]}, dry "
                            f"calls {want[what]}")
    if not got["decode"]["decode_attention"]:
        problems.append("dry run: the decode step launched no "
                        "decode_attention")
    if not finite:
        problems.append("dry run: the decode step's logits are not finite")
    line = (f"(b) {D['arch']} (impl=pallas, {cfg.n_layers} layers, "
            f"{D['data']}x{D['model']}, B={D['batch']}, prompt "
            f"{D['prompt_len']}, caches of {D['max_len']} slots): launches "
            f"on the card = dry calls on the meta mesh for the prefill "
            f"{got['prefill']} and the decode step {got['decode']}"
            + ("" if got == want else f" (dry calls {want})")
            + f"; the dry runs {dry_s:.1f} s; on {mesh.distinct_devices} "
            f"card(s), each card's peak "
            + ", ".join(f"{g:.3f}" for g in peaks)
            + " GB beside a position's predicted arguments + temp "
            + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in held.items())
            + " (received blocks counted)")
    return dict(launches=got, dry_calls=want, dry_s=dry_s,
                card_peaks_gb=peaks, position_bytes=held), \
        {f"dry run check: {D['arch']} 1x4": {
            k: got["prefill"][k] + got["decode"][k] for k in got["decode"]}}, \
        line


def dryrun_phase(ops, trainer):
    """Phase 9: the dry run against phase 7's trainer (``trainer``, its
    record) and against a served prefill and decode step.  Returns
    (records, {path: launches}, lines)."""
    t0 = time.time()
    recs, lines, problems, clock = {}, [], [], {}
    t1 = time.time()
    recs["trainer"], line = dry_trainer(trainer, problems)
    clock["trainer"] = time.time() - t1
    lines.append(line)
    t1 = time.time()
    recs["serve"], launches, line = dry_serve(ops, problems)
    clock["serve"] = time.time() - t1
    lines.append(line)
    recs["seconds"] = time.time() - t0
    recs["section_s"] = clock
    lines.append(f"phase 9 took {recs['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in clock.items()) + ")")
    if problems:
        for line in lines:
            print(f"[dryrun] {line}")
        fail("phase 9: " + "; ".join(problems))
    return recs, launches, lines


# ---------------------------------------------------------------------------
# phase 10 — the mesh trainer with one position a card (two or more cards)
# ---------------------------------------------------------------------------
# (a) qwen3-1.7b at MESH_PARITY's 2 layers on a 1x2 mesh, and grok-1 at
# phase 8's trainer widths (TRAIN_FAMILY_CUTS) on a 2x1 mesh: its expert
# blocks stored over the data axis, so each MoE layer's gather (and its
# recompute's) crosses the cards; (b) with four cards, qwen3-1.7b's 2x2
# mesh.  Each against the same mesh trainer with every position on one
# card (a data axis changes the MoE's capacity and aux, so grok's 2x1 is
# not one device's trainer), fp32 moments, phase 7's gates.
CARD_PARITY = ((TRAIN_ARCH, (1, 2)), ("grok-1-314b", (2, 1)),
               (TRAIN_ARCH, (2, 2)))


def _card_mesh(shape, one=False):
    """A mesh of ``shape`` with one position a card (``one``: all on the
    first card)."""
    from repro_torch.launch.mesh import make_test_mesh
    n = shape[0] * shape[1]
    return make_test_mesh(*shape, devices=[
        f"cuda:{0 if one else i}" for i in range(n)])


def cards_parity(problems):
    """(a), (b): CARD_PARITY's mesh trainers with one position a card
    against the same on one card.  Returns (record, lines)."""
    from repro_torch import weights
    recs, lines = {}, []
    for arch, shape in CARD_PARITY:
        if shape[0] * shape[1] > torch.cuda.device_count():
            lines.append(f"{arch} {shape[0]}x{shape[1]}: not run, "
                         f"{torch.cuda.device_count()} cards")
            continue
        cfg = _mesh_parity_cfg() if arch == TRAIN_ARCH \
            else _family_train_cfg(arch)
        paths = ["/".join(k) for k, _ in _ckpt_items(weights.to_reference(
            weights.init_params(cfg, device="meta"), cfg))]
        t0 = time.time()
        one = _mesh_parity_run(cfg, "float32", _card_mesh(shape, one=True))
        mesh = _card_mesh(shape)
        _sync()
        _reset_peaks(mesh)
        got = _mesh_parity_run(cfg, "float32", mesh)
        peaks = _card_peaks(mesh)
        metric = max(abs(g[k] - h[k]) / max(abs(h[k]), 1e-30)
                     for h, g in zip(one[2], got[2])
                     for k in ("loss", "grad_norm"))
        (share, share_at), (worst, _) = _param_errs(one[0], got[0], paths)
        m_rel = max(_moment_errs(one[1][i], got[1][i])[0] for i in (0, 1))
        what = f"{arch} {shape[0]}x{shape[1]} on {mesh.distinct_devices} cards"
        if not metric <= STEP_TOL["metric"]:
            problems.append(f"{what}: loss / grad norm {metric:.3g}")
        if not share <= STEP_TOL["param_share"]:
            problems.append(f"{what}: {share:.3g} of {share_at} more than "
                            f"{STEP_TOL['param_near']} apart")
        if not m_rel <= STEP_TOL["moment"]:
            problems.append(f"{what}: moments {m_rel:.3g}")
        recs[what] = dict(metric_rel_err=metric, param_share_off=share,
                          param_share_leaf=share_at, param_max_abs=worst,
                          moment_rel_err=m_rel, card_peaks_gb=peaks,
                          losses=[h["loss"] for h in got[2]],
                          losses_one=[h["loss"] for h in one[2]],
                          seconds=time.time() - t0, d_model=cfg.d_model)
        lines.append(
            f"{'(b)' if shape == (2, 2) else '(a)'} {what} ({cfg.n_layers} "
            f"layers, d_model {cfg.d_model}, "
            f"fp32, B={MESH_PARITY['batch']}, S={MESH_PARITY['seq']}, 3 "
            f"steps at lr {MESH_PARITY['lr']}, remat) against the same "
            f"mesh on one card: "
            f"loss and grad norm within {metric:.3g} (tol "
            f"{STEP_TOL['metric']}); parameters at most {share:.3g} of a "
            f"leaf ({share_at}) more than {STEP_TOL['param_near']} of its "
            f"max apart, largest gap {worst:.3g}; moments {m_rel:.3g}; "
            f"card peaks {', '.join(f'{g:.3f}' for g in peaks)} GB; "
            f"losses {', '.join(f'{l:.5f}' for l in recs[what]['losses'])}")
        del got, one
        torch.cuda.empty_cache()
    return recs, lines


def cards_trainer(ops, problems):
    """(b), (c): phase 7's full-width 2x2 trainer with one position a
    card; each card's peak beside the dry run's arguments + temp of a
    position (received blocks counted: a send between two cards is a
    copy), the wire at every site equal to the prediction.  Returns
    (record, launches, lines)."""
    import shutil
    import tempfile
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    R = MESH_RUN
    tmp = tempfile.mkdtemp(prefix="cards_ckpt_")
    try:
        trainer, launches, kept, line = mesh_trainer(
            ops, problems, tmp, _card_mesh((R["data"], R["model"])))
        del kept
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lines = [f"(b) {line}"]
    cfg = _trainer_cfg()
    shape = ShapeConfig("train", R["seq"], R["batch"], "train")
    t1 = time.time()
    pred = dryrun.dry_step(cfg, shape, make_test_mesh(
        R["data"], R["model"], devices="meta"))
    dry_s = time.time() - t1
    got, want = trainer["wire_sites"], pred["wire_bytes_by_site"]
    sites = sorted(set(got) | set(want))
    off = {k: (got.get(k, 0), want.get(k, 0)) for k in sites
           if got.get(k, 0) != want.get(k, 0)}
    if off or not sites:
        problems.append(f"cards: wire bytes by site differ {off}")
    m = pred["memory"]
    held = m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
    peaks = trainer["card_peaks_gb"]
    rec = dict(trainer=trainer, predicted=pred, dry_s=dry_s,
               position_bytes=held,
               peak_ratios=[g * 1e9 / held for g in peaks])
    lines.append(
        f"(c) the dry run of (b) on a meta 2x2 ({dry_s:.1f} s, "
        f"{pred['symmetry']['temp']}): wire by site "
        + ("equal at all " if not off else "DIFFERENT at ")
        + f"{len(sites)} sites ({sum(got.values()) / 1e9:.6f} GB a step); "
        f"a position's arguments {m['argument_size_in_bytes'] / 1e9:.3f} + "
        f"temp {m['temp_size_in_bytes'] / 1e9:.3f} = {held / 1e9:.3f} GB "
        f"predicted (with received blocks; {m['temp_by_phase']}), each "
        f"card's peak " + ", ".join(
            f"{g:.3f} GB ({r:.3f})" for g, r in zip(peaks,
                                                    rec["peak_ratios"]))
        + f"; {gpu_info()}")
    return rec, {"cards: qwen3-1.7b 2x2 on 4 cards": launches}, lines

# (d) to (h), with four cards: the serving mesh, the paper's modules and
# the dry run with one position a card, each against the same mesh with
# every position on the first card (the same kernels and plans on
# identical cards: tokens identical, logits bit-equal, or the finding
# explained and the near-tie rule applied): (d) phase 8 (a)'s family
# parity; (e) phase 8 (b)'s full-width dense meshes and the dense-mesh
# serve CLI; (f) the striped pools (phase 3) and their serve CLI; (g)
# phase 5's store, lattice (on a 2x2 (pod, data) mesh) and pipeline and
# phase 8's pipeline backward, beside the peer-copy rate; (h) phase 9's
# served prefill and decode step
CARD_LATTICE = dict(mesh=(2, 2), words=1 << 26)
PEER_COPY_BYTES = 1 << 28


def _card_devices(n, one=False):
    """``n`` positions' devices: one a card, or (``one``) all on the
    first."""
    return [f"cuda:{0 if one else i}" for i in range(n)]


def _card_delta(ops, before):
    """Each kernel's launches by card since ``before``
    (``ops.launches_by_card()``)."""
    out = {}
    for k, cards in ops.launches_by_card().items():
        d = {c: n - before.get(k, {}).get(c, 0) for c, n in cards.items()}
        d = {c: n for c, n in d.items() if n}
        if d:
            out[k] = d
    return out


def _say(lines, line):
    """Keep ``line`` and print it now (a later failure keeps it)."""
    lines.append(line)
    print(f"[cards] {line}", flush=True)


def _ties_note(same, ties):
    return "identical" if same else f"differ only at near-ties {ties}"


def cards_dense_parity(ops, problems):
    """(d): DMESH_CASES' meshes with one position a card against the
    same meshes on the first card.  Returns (records, lines)."""
    from repro_torch import weights
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_prompts
    from repro_torch.parallel.sharding import use_sharding
    P = DMESH_PARITY
    recs, lines = {}, []
    for arch, cut, meshes, rules_list, plen in DMESH_CASES:
        cfg = get_config(arch).replace(activation_dtype="float32",
                                       impl="pallas", **cut)
        params = weights.init_params(cfg, torch.Generator(
            device=DEVICE).manual_seed(SEED + 8), DEVICE)
        tok0 = torch.tensor(np.stack(make_prompts(
            P["batch"], plen, cfg.vocab_size, SEED + 8)), device=DEVICE)
        for rules in rules_list:
            for shape in meshes:
                what = (f"{arch} {shape[0]}x{shape[1]}"
                        + (" EP" if rules else ""))
                runs = []
                for one in (True, False):
                    mesh = _card_mesh(shape, one)
                    before = ops.launches_by_card()
                    with use_sharding(mesh, rules):
                        placed = weights.shard_params(params, cfg, mesh)
                        runs.append(_dmesh_greedy(cfg, placed, tok0, plen,
                                                  P["gen"], mesh))
                    _sync()
                    del placed
                by_card = _card_delta(ops, before)
                again = None
                if not all(torch.equal(a, b) for a, b in zip(runs[1][1],
                                                             runs[0][1])):
                    # is the one card's run equal to itself?
                    mesh1 = _card_mesh(shape, one=True)
                    with use_sharding(mesh1, rules):
                        placed = weights.shard_params(params, cfg, mesh1)
                        rerun = _dmesh_greedy(cfg, placed, tok0, plen,
                                              P["gen"], mesh1)
                    del placed
                    again = max(max_err(a, b)
                                for a, b in zip(rerun[1], runs[0][1]))
                (base, got), flips = runs, []
                same = got[0] == base[0]
                if not same:
                    inf = [[float("inf")] * P["batch"] for _ in base[0]]
                    flips = _token_flips({"pallas": got[0], "ref": base[0]},
                                         base[2], P["tol"], inf,
                                         f"cards {what}")
                upto = min([j for _, j, _, _ in flips] + [P["gen"]])
                bit = all(torch.equal(a, b) for a, b in zip(got[1], base[1]))
                err = max((max_err(a, b) for a, b in
                           zip(got[1][:upto + 1], base[1][:upto + 1])),
                          default=0.0)
                if not err <= P["tol"]:
                    problems.append(f"cards {what}: logits {err:.3g} > "
                                    f"{P['tol']}")
                recs[what] = dict(tokens_equal=same, logits_bit_equal=bit,
                                  logit_err=err, flips=flips,
                                  one_card_rerun_err=again,
                                  by_card=by_card, n_layers=cfg.n_layers)
                _say(lines, 
                    f"(d) dense mesh parity {what} on {mesh.distinct_devices}"
                    f" cards ({cfg.n_layers} layers at published widths, "
                    f"fp32, impl=pallas, {P['batch']} prompts of {plen} x "
                    f"{P['gen']} tokens) against the same mesh on one card: "
                    f"tokens {_ties_note(same, flips)}, logits of every step "
                    + ("bit-equal" if bit else f"within {err:.3g} (tol "
                       f"{P['tol']}; the one-card run again against itself: "
                       + ("bit-equal" if again == 0 else
                          f"within {again:.3g}") + ")")
                    + f"; launches by card {by_card}")
        del params, tok0
        torch.cuda.empty_cache()
    return recs, lines


def cards_dense_serve(ops, problems):
    """(e): DMESH_RUNS' meshes through ``run_dense`` with one position a
    card against the same meshes on the first card: tokens, the logits
    of a profiled step, the launches and the wire by collective equal;
    each card's peak, launches and busy share; then the dense-mesh serve
    CLI on 1x2.  Returns (records, {path: launches}, lines)."""
    from repro_torch import weights
    from repro_torch.launch.serve import build_parser, make_prompts, \
        run_dense
    from repro_torch.parallel.sharding import use_sharding
    recs, launches, lines = {}, {}, []
    for arch, run in DMESH_RUNS.items():
        args = build_parser().parse_args(
            [f"--{k.replace('_', '-')}={v}" for k, v in run.items()
             if k != "meshes"] + [f"--seed={SEED}"])
        cfg, params = full_width_params(arch)
        prompts = make_prompts(args.requests, args.prompt_len,
                               cfg.vocab_size, SEED)
        keep = arch != "grok-1-314b"     # grok's copy does not fit
        for d, m, rules in run["meshes"]:
            what = f"{arch} {d}x{m}" + (" EP" if rules else "")
            res = {}
            for one in (True, False):
                mesh = _card_mesh((d, m), one)
                if params is None:           # consumed by the run before
                    cfg, params = full_width_params(arch)
                with use_sharding(mesh, rules):
                    placed = weights.shard_params(params, cfg, mesh,
                                                  consume=not keep)
                if not keep:
                    params = None
                torch.cuda.empty_cache()
                _sync()
                _reset_peaks(mesh)
                ops.reset_launches()
                before = ops.launches_by_card()
                with use_sharding(mesh, rules):
                    out, st = run_dense(args, cfg, params=placed, mesh=mesh,
                                        rules=rules)
                _sync()
                r = dict(tokens={f"req{i}": t for i, t in out.items()},
                         st=st, launches=_launches(ops),
                         by_card=_card_delta(ops, before),
                         peaks=_card_peaks(mesh))
                if not one:
                    base = res[True]["tokens"]
                    r["ties"] = [] if r["tokens"] == base else _bf16_ties(
                        cfg, placed, prompts, base, r["tokens"],
                        f"cards {what}", mesh=mesh, rules=rules)
                r["prof"], r["wire"], finite, r["logits"] = _dmesh_profile(
                    cfg, placed, mesh, rules, args, prompts, run)
                if not finite:
                    problems.append(f"cards {what}: non-finite logits")
                res[one] = r
                del placed
                torch.cuda.empty_cache()
            a, b = res[True], res[False]
            same = a["tokens"] == b["tokens"]
            bit = torch.equal(a["logits"], b["logits"])
            wire_eq = a["wire"]["per_position"] == b["wire"]["per_position"]
            if not wire_eq:
                problems.append(f"cards {what}: wire by collective "
                                f"{b['wire']['per_position']}, on one card "
                                f"{a['wire']['per_position']}")
            if a["launches"] != b["launches"]:
                problems.append(f"cards {what}: launches {b['launches']}, "
                                f"on one card {a['launches']}")
            st, st1 = b["st"], a["st"]
            launches[f"cards: dense mesh {what}"] = b["launches"]
            dp = b["prof"]["decode"]
            rec = dict(decode_step_ms=st["step_s"] * 1e3,
                       prefill_ms=st["prefill_s"] * 1e3,
                       tok_per_s=st["tokens"] / st["seconds"],
                       one_card_step_ms=st1["step_s"] * 1e3,
                       one_card_prefill_ms=st1["prefill_s"] * 1e3,
                       one_card_tok_per_s=st1["tokens"] / st1["seconds"],
                       card_peaks_gb=b["peaks"],
                       one_card_peak_gb=a["peaks"][0],
                       tokens_equal=same, ties=b["ties"],
                       logits_bit_equal=bit,
                       logits_max_abs_diff=max_err(a["logits"], b["logits"]),
                       wire=b["wire"], wire_equal=wire_eq,
                       launches=b["launches"], by_card=b["by_card"],
                       profile=b["prof"], one_card_profile=a["prof"])
            recs[what] = rec
            _say(lines, 
                f"(e) dense mesh serve {what} on {len(b['peaks'])} cards "
                f"({cfg.n_layers} layers, bf16, impl=pallas, "
                f"{args.requests} requests x {args.gen} tokens, batch "
                f"{args.batch}, prompt {args.prompt_len}): decode step "
                f"{rec['decode_step_ms']:.3f} ms (one card "
                f"{rec['one_card_step_ms']:.3f}), prefill "
                f"{rec['prefill_ms']:.3f} ms (one card "
                f"{rec['one_card_prefill_ms']:.3f}), {rec['tok_per_s']:.1f} "
                f"tok/s (one card {rec['one_card_tok_per_s']:.1f}); tokens "
                f"{_ties_note(same, b['ties'])}; a profiled decode step's "
                f"logits " + ("bit-equal" if bit else f"differ by at most "
                              f"{rec['logits_max_abs_diff']:.3g}")
                + f"; wire a position a decode step by collective "
                + ("equal to one card's" if wire_eq else "DIFFERENT")
                + f" ({b['wire']['measured'] / 1e6:.4f} MB); peaks "
                + ", ".join(f"{g:.2f}" for g in b["peaks"])
                + f" GB (one card {a['peaks'][0]:.2f}); profiled decode "
                f"step {dp['wall_ms'] / 4:.3f} ms wall, by card "
                + "; ".join(f"cuda:{c} busy {v['busy_share']:.3f}, "
                            f"{v['launches_per_step']:.0f} launches"
                            for c, v in dp["by_card"].items())
                + f"; kernel launches by card {b['by_card']}")
        del params
        torch.cuda.empty_cache()
    recs["cli"], line = dense_mesh_cli(problems, cards=2)
    _say(lines, f"(e) {line}")
    return recs, launches, lines


def cards_striped(ops, problems):
    """(f): qwen3-1.7b's paged engine with its pools striped over a 1x4
    mesh, one stripe a card, against the same mesh on the first card
    (``serve_paged_striped``'s gates), then the serve CLI on four
    cards.  Returns (records, {path: launches}, lines)."""
    M = STRIPED_RUN["model"]
    shape = (STRIPED_RUN["data"], M)
    cfg, params = full_width_params("qwen3-1.7b")
    runs = serve_paged_striped(ops, cfg, params, meshes=(
        _card_mesh(shape, one=True), _card_mesh(shape)))
    del params
    torch.cuda.empty_cache()
    recs = {"one card": runs[0][0], "cards": runs[1][0]}
    for r in recs.values():
        r.pop("tokens")
    lines = []
    for _, _, line in runs:
        _say(lines, f"(f) {line}")
    recs["cli"], line = serve_cli_striped(cards=M)
    _say(lines, f"(f) {line}")
    return recs, {"cards: qwen3-1.7b paged 1x4 mesh": runs[1][1]}, lines


def peer_copies(n):
    """Whether each card reaches each other's memory
    (``torch.cuda.can_device_access_peer``) and the rate of a
    PEER_COPY_BYTES copy between each pair (GB/s, the mean of 5 after
    one, host clock around a sync of every card)."""
    x = [torch.empty(PEER_COPY_BYTES, dtype=torch.uint8, device=f"cuda:{i}")
         for i in range(n)]
    peer, rate = {}, {}
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            peer[f"{i}->{j}"] = torch.cuda.can_device_access_peer(i, j)
            x[j].copy_(x[i])
            _sync()
            t0 = time.perf_counter()
            for _ in range(5):
                x[j].copy_(x[i])
            _sync()
            rate[f"{i}->{j}"] = 5 * PEER_COPY_BYTES / (
                time.perf_counter() - t0) / 1e9
    del x
    torch.cuda.empty_cache()
    return peer, rate


def cards_lattice(devices):
    """The lattice all-reduce on CARD_LATTICE's (pod, data) mesh, its
    positions on ``devices``: small integers equal to the plain sum bit
    for bit, normal values within LATTICE_UNITS fp32 units; returns
    (record, the normal values' results on the host)."""
    pods, fast = CARD_LATTICE["mesh"]
    n_pos, words = pods * fast, CARD_LATTICE["words"]
    g = torch.Generator(device=DEVICE).manual_seed(SEED + 41)
    ints = [torch.randint(-1024, 1024, (words,), generator=g,
                          device=DEVICE).float().to(d) for d in devices]
    plain = ints[0].to(DEVICE).clone()
    for p in ints[1:]:
        plain += p.to(DEVICE)
    stats = {}
    for i, o in enumerate(_lattice_run((pods, fast), ints, stats, devices)):
        if not torch.equal(o.to(DEVICE), plain):
            fail(f"lattice all-reduce on {devices}: position {i} differs "
                 f"from the plain sum of small integers")
    del ints, plain
    normal = [torch.randn(words, generator=g, device=DEVICE).to(d)
              for d in devices]
    plain = normal[0].to(DEVICE).clone()
    mag = plain.abs()
    for p in normal[1:]:
        plain += p.to(DEVICE)
        mag += p.to(DEVICE).abs()
    outs = _lattice_run((pods, fast), normal, {}, devices)
    eps = torch.finfo(torch.float32).eps
    worst = max(float(((o.to(DEVICE) - plain).abs() / (eps * mag)).max())
                for o in outs)
    if not worst <= LATTICE_UNITS:
        fail(f"lattice all-reduce on {devices}: {worst:.2f} fp32 units of "
             f"the magnitudes from the plain sum (tol {LATTICE_UNITS})")
    host = [o.cpu() for o in outs]
    del outs, plain, mag
    ms = _synced_ms(lambda: _lattice_run((pods, fast), normal, {}, devices),
                    3)
    del normal
    torch.cuda.empty_cache()
    return dict(ms=ms, bytes=stats, worst_units=worst), host


def cards_paper(ops, problems, n):
    """(g): phase 5's store, lattice and pipeline and phase 8's pipeline
    backward with one position a card, each against the same on the
    first card, beside the peer-copy rate.  Returns (records, {path:
    launches}, lines)."""
    recs, launches, lines = {}, {}, []
    peer, rate = peer_copies(n)
    recs["peer_access"], recs["peer_copy_gb_per_s"] = peer, rate
    _say(lines, f"(g) peer access (can_device_access_peer) {peer}; a "
                 f"{PEER_COPY_BYTES >> 20} MiB copy "
                 + ", ".join(f"{k} {v:.1f}" for k, v in rate.items())
                 + " GB/s")
    # the store: 4 stripes of 1 GiB, one a card
    st = {one: paper_store(_card_devices(STORE_RUN["stripes"], one), True)
          for one in (True, False)}
    same = all(torch.equal(a, b.to(a.device)) for a, b in zip(
        st[True][0]["words"], st[False][0]["words"]))
    if not same:
        problems.append("cards store: the stripes differ from one card's")
    for one in (True, False):
        del st[one][0]["words"]
    torch.cuda.empty_cache()
    recs["store"] = {"one card": st[True][0], "cards": st[False][0],
                     "stripes_equal": same}
    _say(lines, f"(g) {st[False][1]}; stripes "
                 + ("equal bit for bit to" if same else "DIFFERENT from")
                 + f" the same mesh on one card (one card: "
                 f"{st[True][0]['single writes_m_per_s']:.1f} / "
                 f"{st[True][0]['striped writes_m_per_s']:.1f} M writes/s)")
    # the lattice on a 2x2 (pod, data) mesh
    n_pos = CARD_LATTICE["mesh"][0] * CARD_LATTICE["mesh"][1]
    lat = {one: cards_lattice(_card_devices(n_pos, one))
           for one in (True, False)}
    same = all(torch.equal(a, b) for a, b in zip(lat[True][1],
                                                 lat[False][1]))
    if not same:
        problems.append("cards lattice: the sums differ from one card's")
    recs["lattice"] = {"one card": lat[True][0], "cards": lat[False][0],
                       "equal": same}
    c, o = lat[False][0], lat[True][0]
    moved = sum(c["bytes"].values())
    _say(lines, 
        f"(g) lattice all-reduce (§V-A), {CARD_LATTICE['mesh'][0]}x"
        f"{CARD_LATTICE['mesh'][1]} (pod, data) mesh, {CARD_LATTICE['words']}"
        f" fp32 words a position: on {n_pos} cards {c['ms']:.3f} ms, on one "
        f"card {o['ms']:.3f} ms; bytes a position receives {c['bytes']} "
        f"({moved / 1e6:.1f} MB, at the slowest pair's peer rate "
        f"{moved / min(rate.values()) / 1e6:.3f} ms); integers equal to the "
        f"plain sum bit for bit, normal values within "
        f"{c['worst_units']:.2f} fp32 units, and "
        + ("equal bit for bit to" if same else "DIFFERENT from")
        + " one card's")
    # the pipeline: qwen3-1.7b's blocks as 4 stages, one a card
    cfg, params = full_width_params("qwen3-1.7b")
    pipe = {}
    for one in (True, False):
        before = ops.launches_by_card()
        pipe[one] = paper_pipeline(ops, cfg, params,
                                   _card_devices(PIPE_RUN["stages"], one))
        pipe[one][0]["by_card"] = _card_delta(ops, before)
    del params
    torch.cuda.empty_cache()
    same = torch.equal(pipe[True][0].pop("out"), pipe[False][0].pop("out"))
    if not same:
        problems.append("cards pipeline: output differs from one card's")
    launches["cards: stage pipeline"] = pipe[False][1]
    p, q = pipe[False][0], pipe[True][0]
    recs["pipeline"] = {"one card": q, "cards": p, "equal": same}
    hand = (PIPE_RUN["stages"] - 1) * PIPE_RUN["micro"] * PIPE_RUN["seq"] \
        * cfg.d_model * 2
    _say(lines, 
        f"(g) {pipe[False][2]}; against the same on one card "
        + ("bit for bit" if same else "DIFFERENT")
        + f" (one card: {np.median(q['ms']):.3f} ms, measured bubble "
        f"{q['measured_bubble']:.3f}); {hand / 1e6:.1f} MB handed on "
        f"({hand / min(rate.values()) / 1e6:.3f} ms at the slowest pair's "
        f"peer rate); every launch of the section by card (its checks "
        f"included) {p['by_card']}")
    # phase 8's pipeline backward
    bw = {one: pipeline_backward(problems,
                                 _card_devices(PIPE_GRAD["stages"], one))
          for one in (True, False)}
    same = all(torch.equal(a, b) for a, b in zip(bw[True][0].pop("grads"),
                                                 bw[False][0].pop("grads")))
    if not same:
        problems.append("cards pipeline backward: gradients differ from "
                        "one card's")
    recs["pipeline_backward"] = {"one card": bw[True][0],
                                 "cards": bw[False][0], "equal": same}
    _say(lines, f"(g) {bw[False][1]}; gradients "
                 + ("equal bit for bit to" if same else "DIFFERENT from")
                 + f" one card's ({bw[True][0]['s']:.3f} s)")
    return recs, launches, lines


def cards_dry_serve(ops, problems):
    """(h): phase 9's served prefill and decode step on a 1x4 mesh with
    one position a card: the dry calls equal to the launches summed over
    the cards, each card's peak beside a position's arguments + temp."""
    D = DRY_SERVE
    before = ops.launches_by_card()
    rec, launches, line = dry_serve(ops, problems, _card_mesh(
        (D["data"], D["model"])))
    rec["by_card"] = _card_delta(ops, before)
    lines = []
    _say(lines, f"(h) {line.replace('(b) ', '', 1)}; launches by card "
         f"{rec['by_card']}")
    return rec, {"cards: " + k: v for k, v in launches.items()}, lines


def cards_phase(ops):
    """Phase 10: the mesh trainer with one position a card, where two or
    more cards are visible, and with four the serving mesh, the paper's
    modules and the dry run ((d) to (h)); on one card one line saying it
    did not run.  Returns (records, {path: launches}, lines)."""
    n = torch.cuda.device_count()
    lines = []

    def say(*new):
        for line in new:
            print(f"[cards] {line}", flush=True)
        lines.extend(new)
    if n < 2:
        say(f"phase 10 did not run: {n} card visible, and the mesh trainer "
            f"with one position a card needs two or more (run "
            f"`chip_smoke.py --only-cards` on a machine with four)")
        return {"ran": False, "cards": n}, {}, lines
    t0 = time.time()
    recs, problems, clock = {"ran": True, "cards": n}, [], {}
    first = ops.launches_by_card()
    t1 = time.time()
    recs["parity"], ls = cards_parity(problems)
    clock["parity"] = time.time() - t1
    say(*ls)
    launches = {}
    if n >= 4:
        t1 = time.time()
        recs["trainer"], launches, ls = cards_trainer(ops, problems)
        clock["trainer"] = time.time() - t1
        say(*ls)
        for name, fn, more in (
                ("dense parity", cards_dense_parity, ()),
                ("dense serve", cards_dense_serve, ()),
                ("striped", cards_striped, ()),
                ("paper", cards_paper, (n,)),
                ("dry serve", cards_dry_serve, ())):
            t1 = time.time()
            out = fn(ops, problems, *more)
            clock[name] = time.time() - t1
            recs[name] = out[0]
            if len(out) == 3:
                launches.update(out[1])
            lines.extend(out[-1])           # printed as they came
            say(f"{name}: {clock[name]:.1f} s")
        by_card = _card_delta(ops, first)
        recs["launches_by_card"] = by_card
        off0 = {k: sum(v for c, v in cards.items() if c not in (0, None))
                for k, cards in by_card.items()}
        say(f"kernel launches by card over phase 10: {by_card}")
        for fn in ops.KERNELS:
            if not off0.get(fn.__name__):
                problems.append(f"{fn.__name__} launched on no card but "
                                f"cuda:0")
    else:
        say(f"(b) to (h) not run: {n} cards (they need four)")
    recs["seconds"] = time.time() - t0
    recs["section_s"] = clock
    say(f"phase 10 took {recs['seconds']:.1f} s (" + ", ".join(
        f"{k} {v:.1f}" for k, v in clock.items()) + ")")
    if problems:
        fail("phase 10: " + "; ".join(problems))
    return recs, launches, lines


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

    if sys.argv[1:] == ["--only-train"]:      # phase 6 alone, no verdict
        train, launches, train_lines = train_phase(ops)
        for line in train_lines:
            print(f"[train] {line}")
        OUT.mkdir(exist_ok=True)
        (OUT / "chip_smoke_train.json").write_text(json.dumps(
            dict(gpu=info, train=train, launches=launches), indent=2))
        return
    if sys.argv[1:] == ["--only-mesh"]:       # phase 7 alone, no verdict
        mesh, launches, mesh_lines = mesh_phase(ops)
        for line in mesh_lines:
            print(f"[mesh] {line}")
        OUT.mkdir(exist_ok=True)
        (OUT / "chip_smoke_mesh.json").write_text(json.dumps(
            dict(gpu=info, mesh=mesh, launches=launches), indent=2,
            default=str))
        print(gpu_info())
        return
    if sys.argv[1:] == ["--only-dryrun"]:  # phase 7's trainer, phase 9
        import shutil
        import tempfile
        tmp = tempfile.mkdtemp(prefix="mesh_ckpt_")
        try:
            trainer = mesh_trainer(ops, [], tmp)[0]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        dry, launches, dry_lines = dryrun_phase(ops, trainer)
        for line in dry_lines:
            print(f"[dryrun] {line}")
        OUT.mkdir(exist_ok=True)
        (OUT / "chip_smoke_dryrun.json").write_text(json.dumps(
            dict(gpu=info, dryrun=dry, launches=launches), indent=2,
            default=str))
        return
    if sys.argv[1:] == ["--only-cards"]:  # phase 10 alone, no verdict
        cards, launches, _ = cards_phase(ops)
        OUT.mkdir(exist_ok=True)
        (OUT / "chip_smoke_cards.json").write_text(json.dumps(
            dict(gpu=info, cards=cards, launches=launches), indent=2,
            default=str))
        print(gpu_info())
        return
    if sys.argv[1:] == ["--only-dense-mesh"]:  # phase 8 alone, no verdict
        dmesh, launches, dmesh_lines = dense_mesh_phase(ops)
        for line in dmesh_lines:
            print(f"[dense-mesh] {line}")
        OUT.mkdir(exist_ok=True)
        (OUT / "chip_smoke_dense_mesh.json").write_text(json.dumps(
            dict(gpu=info, dense_mesh=dmesh, launches=launches), indent=2,
            default=str))
        print(gpu_info())
        return
    # the seconds of each part of phases 1 to 4, printed at the end
    laps, last = {}, [t0]

    def lap(name):
        now = time.time()
        laps[name] = now - last[0]
        last[0] = now
    lap("build")
    recs, lines = {}, []
    for check in (check_paged, check_flash, check_rwkv6, check_rglru,
                  check_moe_gemm, check_decode, check_rmsnorm):
        rec, ls = check(ops, ref)
        recs[rec["name"]] = rec
        lines += ls
    masked_rec, line = check_paged_masked(ops, ref)
    recs["paged_decode_attention"]["shapes"].append(masked_rec)
    lines.append(line)
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
    fam, fam_lines = check_families(ops, ref)
    for name, shapes in fam.items():
        recs[name]["shapes"] += shapes
    lines += fam_lines
    product, product_lines = check_product()
    lines += product_lines
    einsum, einsum_lines = check_einsum()
    lines += einsum_lines
    combine, combine_lines = check_combine()
    lines += combine_lines
    for line in lines:
        print(f"[kernels] {line}")
    lap("kernels")

    # each served path with the counts set to 0 just before it; a kernel's
    # launches are the sum over the paths
    serve_stats, path_launches, parity = {}, {}, {}

    def served(key, result):
        serve_stats[key], path_launches[key], line = result
        print(f"[serve] {line}")

    cfg, params = full_width_params("qwen3-1.7b")
    served("qwen3-1.7b paged", serve_paged(ops, cfg, params))
    one, striped = serve_paged_striped(ops, cfg, params)
    served("qwen3-1.7b paged, 4 nodes on one device", one)
    served("qwen3-1.7b paged, 1x4 mesh", striped)
    masked_rec["launches"] = striped[0]["masked_launches"]
    on, off = serve_paged_features(ops, cfg, params)
    served("qwen3-1.7b paged, prefix+spec+chunked", on)
    served("qwen3-1.7b paged, prefix+spec+chunked off", off)
    for n, res in enumerate(serve_paged_chaos(
            ops, cfg, params, serve_stats["qwen3-1.7b paged"])):
        served("qwen3-1.7b paged chaos" + ("", ", traced", ", traced 2",
                                           " 2")[n], res)
    parity["1-token chunk bf16"], line = one_token_chunk(cfg, params)
    print(f"[parity] {line}")
    del params
    torch.cuda.empty_cache()
    lap("qwen3-1.7b paged serving")
    serve_stats["qwen3-1.7b paged 1x4 mesh, serve CLI"], line = \
        serve_cli_striped()
    print(f"[serve] {line}")
    lap("serve CLI")
    for arch in ("rwkv6-1.6b", "recurrentgemma-2b"):
        cfg, params = full_width_params(arch)
        served(f"{arch} dense", serve_dense(ops, cfg, params))
        del params
    torch.cuda.empty_cache()
    lap("rwkv6, recurrentgemma serving")
    parity["qwen3-1.7b paged"], line = engine_parity()
    print(f"[parity] {line}")
    inp = feature_parity_inputs()
    parity["qwen3-1.7b paged features"], line = feature_parity(inp)
    print(f"[parity] {line}")
    parity["qwen3-1.7b paged chaos"], line = chaos_parity(inp)
    print(f"[parity] {line}")
    parity["qwen3-1.7b paged striped"], line = striped_parity(inp)
    print(f"[parity] {line}")
    parity["1-token chunk fp32"], line = one_token_chunk(inp["cfg"],
                                                         inp["params"])
    print(f"[parity] {line}")
    del inp
    torch.cuda.empty_cache()
    lap("qwen3-1.7b parity")
    for arch in ("rwkv6-1.6b", "recurrentgemma-2b"):
        parity[f"{arch} dense"], line = dense_parity(arch)
        print(f"[parity] {line}")
    lap("rwkv6, recurrentgemma parity")
    # grok-1 at its published widths, cut to GROK_DEPTH layers: one set of
    # bf16 parameters for both engines and for the parity runs
    torch.cuda.empty_cache()
    cfg, params = full_width_params("grok-1-314b")
    print(f"[serve] grok-1-314b at {cfg.n_layers} layers: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB of parameters on "
          f"the card")
    served("grok-1-314b dense", serve_dense(ops, cfg, params))
    served("grok-1-314b paged", serve_paged(ops, cfg, params))
    parity["grok-1-314b dense"], line = dense_parity("grok-1-314b", params)
    print(f"[parity] {line}")
    parity["grok-1-314b paged"], line = paged_parity("grok-1-314b", params)
    print(f"[parity] {line}")
    parity["grok-1-314b paged features"], line = paged_parity(
        "grok-1-314b", params, features=True)
    print(f"[parity] {line}")
    parity["grok-1-314b moe layer bf16"], line = moe_layer_parity(
        ops, cfg, params)
    print(f"[parity] {line}")
    del params
    torch.cuda.empty_cache()
    lap("grok-1")
    # DeepSeek-V3 (5 layers) and gemma2-27b (6 layers) at their
    # published widths through the dense engine; each parity run then
    # takes its layers from the served weights, and the rest are freed
    for arch in ("deepseek-v3-671b", "gemma2-27b"):
        cfg, params = full_width_params(arch)
        print(f"[serve] {arch} at {cfg.n_layers} layers: "
              f"{torch.cuda.memory_allocated() / 1e9:.2f} GB of parameters "
              f"on the card")
        served(f"{arch} dense", serve_dense(ops, cfg, params))
        conv = serve_stats[f"{arch} dense"]["profile"]["decode"][
            "weight_conversions"]
        if arch == "gemma2-27b" and conv:
            fail(f"{arch}: its decode steps convert weights: {conv}")
        latent = serve_stats[f"{arch} dense"]["profile"]["decode"][
            "latent_conversions"]
        if arch == "deepseek-v3-671b" and latent:
            fail(f"{arch}: its decode steps convert kv_b's views or the "
                 f"latent cache: {latent}")
        if arch == "deepseek-v3-671b":
            parity[f"{arch} dense, run twice"], line = dense_repeat(
                cfg, params)
            print(f"[parity] {line}")
        params = cut_params(cfg, params, parity_cfg(arch))
        torch.cuda.empty_cache()
        parity[f"{arch} dense"], line = dense_parity(arch, params)
        print(f"[parity] {line}")
        del params
        torch.cuda.empty_cache()
        lap(arch)
    for arch in ("qwen3-14b", "minitron-8b"):
        cfg, params = full_width_params(arch)
        served(f"{arch} paged", serve_paged(ops, cfg, params))
        params = cut_params(cfg, params, parity_cfg(arch))
        torch.cuda.empty_cache()
        parity[f"{arch} paged"], line = paged_parity(arch, params)
        print(f"[parity] {line}")
        del params
        torch.cuda.empty_cache()
        lap(arch)
    for arch, serve_fn in (("qwen2-vl-7b", serve_embeddings),
                           ("hubert-xlarge", serve_encoder)):
        cfg, params = full_width_params(arch)
        served(arch, serve_fn(ops, cfg, params))
        parity[arch], line = embed_parity(cfg, params)
        print(f"[parity] {line}")
        del params
        torch.cuda.empty_cache()
        lap(arch)

    paper, paper_launches, paper_lines = paper_phase(ops)
    path_launches.update(paper_launches)
    for line in paper_lines:
        print(f"[paper] {line}")
    lap("phase 5")

    train, train_launches, train_lines = train_phase(ops)
    path_launches.update(train_launches)
    for line in train_lines:
        print(f"[train] {line}")
    lap("phase 6")

    mesh, mesh_launches, mesh_lines = mesh_phase(ops)
    path_launches.update(mesh_launches)
    for line in mesh_lines:
        print(f"[mesh] {line}")
    lap("phase 7")

    dmesh, dmesh_launches, dmesh_lines = dense_mesh_phase(ops)
    path_launches.update(dmesh_launches)
    for line in dmesh_lines:
        print(f"[dense-mesh] {line}")
    lap("phase 8")

    dry, dry_launches, dry_lines = dryrun_phase(ops, mesh["trainer"])
    path_launches.update(dry_launches)
    for line in dry_lines:
        print(f"[dryrun] {line}")
    lap("phase 9")

    cards, cards_launches, _ = cards_phase(ops)
    path_launches.update(cards_launches)
    lap("phase 10")

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
    OUT.mkdir(exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(
        dict(gpu=info, torch=torch.__version__, build_s=build_s, ptxas=ptxas,
             seconds=time.time() - t0,
             kernels=[recs[fn.__name__] for fn in ops.KERNELS],
             flash_local=flash_local,
             path_launches=path_launches, serve=serve_stats, parity=parity,
             product=product, einsum=einsum, combine=combine, paper=paper,
             train=train,
             mesh=mesh,
             dense_mesh=dmesh,
             dryrun=dry, cards=cards, section_s=laps),
        indent=2, default=str))
    print(f"[done] {time.time() - t0:.1f} s after the build started ("
          + ", ".join(f"{k} {v:.1f}" for k, v in laps.items()) + ")")
    print(f"[done] kernel launches by card over the run: "
          f"{ops.launches_by_card()}")
    print(json.dumps(kernels))
    print(gpu_info())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
