"""Public wrappers of the port's kernels, dispatched on the tensor's device.

A CPU tensor takes the plain PyTorch version (``kernels/ref.py``).  A CUDA
tensor takes the hand-written CUDA kernel (``csrc/``), built at first use;
if the card is not sm_90, or the build, the load or the launch fails, the
wrapper raises.  There is no fallback from the kernel to the plain version.

Each wrapper counts its kernel launches in ``<wrapper>.launches`` (plain
calls on CPU tensors do not count), so a run can show that its main path
went through the kernels.

A ``meta`` tensor (the dry run, ``launch/dryrun.py``) runs the same
checks as a CUDA tensor and returns empty outputs of the kernel's shapes
and dtypes, counted in ``<wrapper>.dry_calls`` and never in
``launches``: the counterpart of a Pallas custom call in the reference's
lowered program, whose work its cost analysis leaves out, as the dry
run's FLOP count does.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, out, B, S, H, hd, scale, softcap, causal, window, bf16, stream
    "flash_attention": [_P] * 4 + [_I] * 4 + [_F] * 2 + [_I] * 3 + [_P],
    # q, k_pages, v_pages, block_tables, pos, page_mask, out (acc with
    # partials), m, l, scratch, B, Kv, G, hd, ps, nmax, NS, tps, scale,
    # softcap, bf16, partials, stream
    "paged_decode_attention": [_P] * 10 + [_I] * 8 + [_F] * 2 + [_I] * 2
    + [_P],
    # q, k, v, out, scratch, B, T, Kv, G, hd, pos, NS, tps, scale,
    # softcap, bf16, stream
    "decode_attention": [_P] * 5 + [_I] * 8 + [_F] * 2 + [_I, _P],
    # x, w, out, E, C, D, F, x bf16, w bf16, out bf16, regime, rows, cols,
    # split, kps, stream
    "moe_gemm": [_P] * 3 + [_I] * 12 + [_P],
    # x, scale, out, N, D, eps, bf16, stream
    "rmsnorm": [_P] * 3 + [_I] * 2 + [_F, _I, _P],
    # x, delta, scale, sum, out, N, D, eps, bf16, stream
    "add_rmsnorm": [_P] * 5 + [_I] * 2 + [_F, _I, _P],
    # q, q_scale, q_out, Nq, k, k_scale, k_out, Nk, D, eps, bf16, stream
    "qk_rmsnorm": [_P] * 3 + [_I] + [_P] * 3 + [_I] * 2 + [_F, _I, _P],
    # a, b, h0, hs, hT, B, S, W, stream
    "rglru_scan": [_P] * 5 + [_I] * 3 + [_P],
    # r, k, v, lw, u, S0, o, S_T, B, S, H, K, V, bf16, design, stream
    "rwkv6_scan": [_P] * 8 + [_I] * 7 + [_P],
}
_LAUNCHERS = {}


# entry points that live in another kernel's library
_LIBRARY = {"add_rmsnorm": "rmsnorm", "qk_rmsnorm": "rmsnorm"}


def _launcher(name: str):
    fn = _LAUNCHERS.get(name)
    if fn is None:
        fn = getattr(build.library(_LIBRARY.get(name, name)),
                     f"{name}_launch")
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _LAUNCHERS[name] = fn
    return fn


def _check(name, device, tensors, float_names, int_names=(), fp32_names=(),
           free_names=()):
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA
    tensor on ``device``; ``float_names`` operands share one dtype of
    fp32/bf16, ``free_names`` operands are each fp32 or bf16 on their own,
    ``fp32_names`` operands are fp32, and index operands are int32.  First
    of all, refuse an operand that requires grad while grad mode is on:
    the kernel writes into a fresh tensor with no autograd graph, so its
    output would cut the gradient without a word."""
    if torch.is_grad_enabled():
        for key, t in tensors.items():
            if t.requires_grad:
                raise RuntimeError(
                    f"{name}: {key} requires grad, and the port's kernels, "
                    "like the reference's Pallas calls, have no backward; "
                    "train with impl='blocked' (or run under "
                    "torch.no_grad())")
    if device.type not in ("cuda", "meta"):
        raise ValueError(f"{name}: no kernel for device {device}")
    if device.type == "cuda":
        build.check_device(device)
    dtype = tensors[float_names[0]].dtype if float_names else None
    if float_names and dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: float32 or bfloat16 only, got {dtype}")
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {device}")
        if key in free_names and t.dtype not in (torch.float32,
                                                  torch.bfloat16):
            raise TypeError(f"{name}: {key} must be float32 or bfloat16, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if device.type == "cuda" and t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
        want = dtype if key in float_names else \
            torch.float32 if key in fp32_names else torch.int32
        if key in float_names + tuple(int_names) + tuple(fp32_names) \
                and t.dtype != want:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {want}")


def _dry(fn, out):
    """A meta call's outputs (the kernel's shapes, no launch), counted in
    ``fn.dry_calls``."""
    fn.dry_calls += 1
    return out


def _launch(name, device, *args):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _launcher(name)(*args, stream)
    if err:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError_t {err}")


def flash_attention(q, k, v, *, causal=True, window=None, scale=None,
                    softcap=None):
    """q,k,v (B,S,H,hd), k/v pre-expanded to H heads. Returns (B,S,H,hd).

    Any S; hd a multiple of 16, at most 256."""
    if q.device.type == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   scale=scale, softcap=softcap)
    B, S, H, hd = q.shape
    _check("flash_attention", q.device, {"q": q, "k": k, "v": v},
           ("q", "k", "v"))
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} must match")
    if hd % 16 or hd > 256:
        raise ValueError(f"flash_attention: head_dim {hd} must be a "
                         "multiple of 16 and at most 256")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} must be >= 1")
    if q.device.type == "meta":
        return _dry(flash_attention, torch.empty_like(q))
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    _launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, S, H, hd, scale,
            softcap or 0.0, int(causal), window or 0,
            int(q.dtype == torch.bfloat16))
    flash_attention.launches += 1
    return out


DECODE_TILE = {True: 64, False: 32}   # cache slots per tile: bf16, fp32
DECODE_CLUSTER = 8   # the bf16 kernel merges its splits in one cluster


def decode_plan(pairs: int, max_slots: int, sms: int, bf16: bool):
    """(NS, tiles per split) of the decode kernels: split each of the
    ``pairs`` CTA rows (sequence, kv head and, in bf16, group of up to 16
    query heads) over the tiles of ``max_slots`` cache slots.  Split s
    takes tiles [s * tps, (s + 1) * tps); every tile falls in exactly one
    split, and no split is empty.  The fp32 kernels aim at about four CTAs
    an SM and merge in a second launch.  The bf16 kernel holds two CTAs an
    SM at hd <= 128 (its ring is ~110 KB) and merges its splits in one
    thread-block cluster: it takes as many splits as fill those two slots
    in one wave, at most ``DECODE_CLUSTER``."""
    n_tiles = -(-max_slots // DECODE_TILE[bf16])
    if bf16:
        ns = min(n_tiles, DECODE_CLUSTER, max(1, 2 * sms // pairs))
    else:
        ns = min(n_tiles, max(1, -(-4 * sms // pairs)))
    tps = -(-n_tiles // ns)
    return -(-n_tiles // tps), tps


@functools.lru_cache(maxsize=None)
def _decode_plan(device, pairs: int, max_slots: int, bf16: bool):
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return decode_plan(pairs, max_slots, sms, bf16)


def _decode_launch_args(q, Kv, max_slots):
    """(NS, tps, scratch) for a decode launch: the plan from the live
    slots (dense) or the table width (paged: ``pos`` lives on the device,
    and splits past it do no work), and, for fp32 only, the scratch of
    the per-split partials (acc, m, l) that its merge kernel reads."""
    B, H, hd = q.shape
    bf16 = q.dtype == torch.bfloat16
    G = H // Kv
    pairs = B * Kv * (-(-G // 16) if bf16 else 1)
    ns, tps = _decode_plan(q.device, pairs, max_slots, bf16)
    scratch = None if bf16 else torch.empty(
        B * Kv * ns * G * (hd + 2), dtype=torch.float32, device=q.device)
    return ns, tps, scratch


def paged_decode_attention(q, k_pages, v_pages, block_tables, pos, *,
                           scale=None, softcap=None, page_mask=None,
                           partials=False):
    """q (B,H,hd); k_pages/v_pages (P,ps,Kv,hd); block_tables (B,nmax)
    int32 physical page ids; pos (B,) int32 per-sequence last valid slot.
    Returns (B,H,hd).  Slots past pos[b] are masked exactly and never read
    by the kernel.

    ``page_mask`` (B,nmax) int32: the table entries this caller owns (one
    stripe of a striped pool); an unowned entry is skipped, never read.
    ``partials=True`` returns the raw online-softmax state ``(acc
    (B,Kv,G,hd), m (B,Kv,G), l (B,Kv,G))`` in fp32 for a merge across
    stripes.  Launches with a mask count in ``masked_launches`` too."""
    if q.device.type == "cpu":
        return ref.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                          pos, scale=scale, softcap=softcap,
                                          page_mask=page_mask,
                                          partials=partials)
    B, H, hd = q.shape
    P, ps, Kv, hd_k = k_pages.shape
    nmax = block_tables.shape[1]
    tensors = {"q": q, "k_pages": k_pages, "v_pages": v_pages,
               "block_tables": block_tables, "pos": pos}
    if page_mask is not None:
        tensors["page_mask"] = page_mask
    _check("paged_decode_attention", q.device, tensors,
           ("q", "k_pages", "v_pages"), ("block_tables", "pos", "page_mask"))
    if v_pages.shape != k_pages.shape or hd_k != hd or H % Kv \
            or tuple(block_tables.shape) != (B, nmax) \
            or tuple(pos.shape) != (B,) or (
                page_mask is not None
                and tuple(page_mask.shape) != (B, nmax)):
        raise ValueError(
            f"paged_decode_attention: bad shapes q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, block_tables "
            f"{tuple(block_tables.shape)}, pos {tuple(pos.shape)}, page_mask "
            f"{None if page_mask is None else tuple(page_mask.shape)}")
    if hd % 16 or hd > 256:
        raise ValueError(f"paged_decode_attention: head_dim {hd} must be a "
                         "multiple of 16 and at most 256")
    scale = hd ** -0.5 if scale is None else scale
    G = H // Kv
    if q.device.type == "meta":
        m = torch.empty((B, Kv, G), dtype=torch.float32, device="meta")
        return _dry(paged_decode_attention, (
            torch.empty((B, Kv, G, hd), dtype=torch.float32, device="meta"),
            m, torch.empty_like(m)) if partials else torch.empty_like(q))
    ns, tps, scratch = _decode_launch_args(q, Kv, nmax * ps)
    if partials:
        out = torch.empty((B, Kv, G, hd), dtype=torch.float32,
                          device=q.device)
        m = torch.empty((B, Kv, G), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
    else:
        out = torch.empty_like(q)
        m = l = None
    _launch("paged_decode_attention", q.device, q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            pos.data_ptr(),
            None if page_mask is None else page_mask.data_ptr(),
            out.data_ptr(), None if m is None else m.data_ptr(),
            None if l is None else l.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, Kv, G, hd,
            ps, nmax, ns, tps, scale, softcap or 0.0,
            int(q.dtype == torch.bfloat16), int(partials))
    paged_decode_attention.launches += 1
    if page_mask is not None:
        paged_decode_attention.masked_launches += 1
    return (out, m, l) if partials else out


def decode_attention(q, k, v, pos, *, scale=None, softcap=None):
    """q (B,H,hd); k, v (B,T,Kv,hd) a contiguous cache; pos an int, the
    last valid slot of every sequence (slots <= pos are attended, and the
    kernel reads no other).  Returns (B,H,hd).  ``pos`` is a host int: the
    dense engine holds it on the host, and it sizes the launch."""
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, pos, scale=scale,
                                    softcap=softcap)
    B, H, hd = q.shape
    _, T, Kv, hd_k = k.shape
    _check("decode_attention", q.device, {"q": q, "k": k, "v": v},
           ("q", "k", "v"))
    if v.shape != k.shape or k.shape[0] != B or hd_k != hd or H % Kv:
        raise ValueError(f"decode_attention: bad shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if hd % 16 or hd > 256:
        raise ValueError(f"decode_attention: head_dim {hd} must be a "
                         "multiple of 16 and at most 256")
    pos = int(pos)
    if not 0 <= pos < T:
        raise ValueError(f"decode_attention: pos {pos} outside the cache "
                         f"of {T} slots")
    if q.device.type == "meta":
        return _dry(decode_attention, torch.empty_like(q))
    scale = hd ** -0.5 if scale is None else scale
    ns, tps, scratch = _decode_launch_args(q, Kv, pos + 1)
    out = torch.empty_like(q)
    _launch("decode_attention", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B, T, Kv,
            H // Kv, hd, pos, ns, tps, scale, softcap or 0.0,
            int(q.dtype == torch.bfloat16))
    decode_attention.launches += 1
    return out


MOE_REGIMES = {"simt": 0, "wgmma": 1, "stream": 2}
MOE_STREAM_N = (8, 16, 32, 64)   # the stream kernel's MMA widths (C <= N)
MOE_STREAM_COLS = 128            # columns of F a stream CTA
MOE_MAX_SPLIT = 8                # K splits: the CTAs of a portable cluster
MOE_BK = 64                      # depth of a k-step of regimes 1 and 2


class MoePlan(NamedTuple):
    """How ``moe_gemm`` computes one grouped GEMM.  ``regime``: "wgmma"
    (regime 1, prefill), "stream" (regime 2, C <= 64) or "simt" (every
    other operand pair, and bf16 with D or F not a multiple of 8).
    ``rows`` x ``cols`` is a CTA's tile of (C, F): for "stream" ``rows``
    is the MMA width N >= C.  K is split ``split`` ways, ``kps`` 64-deep
    k-steps a split ("stream" only; 1 and all of K otherwise).  ``grid``
    is the launch's (x, y, z), x the fastest."""
    regime: str
    rows: int
    cols: int
    split: int
    kps: int
    grid: tuple


def moe_plan(E: int, C: int, D: int, F: int, sms: int, x_bf16: bool,
             w_bf16: bool) -> MoePlan:
    """The plan of ``moe_gemm`` on a card of ``sms`` SMs.

    bf16 x bf16 with D and F multiples of 8 (TMA's 16-byte row strides)
    takes the tensor cores.  C <= 64: the bytes-streaming kernel, whose
    CTAs (two an SM) take 128 columns of F and a share of K, split over
    at most 8 CTAs of a cluster: the fewest splits within 10% of the
    least (waves + 1) x depth a CTA, which counts the waves and the drain
    of the last CTAs (the cluster's merge is not free; no split is
    empty).  Larger C: the wgmma kernel (one CTA an SM), with row tiles
    of 128 or 192 (whichever pads C less, 128 on a tie) and 256 columns
    of F, or 128 where 256 leaves more of the last wave empty than 128
    costs in tile efficiency (taken as 15%).  Every other pair: the
    fp32-core kernel on 64 x 64 tiles."""
    n_k = -(-D // MOE_BK)
    if not (x_bf16 and w_bf16 and D % 8 == 0 and F % 8 == 0 and D > 0):
        return MoePlan("simt", 64, 64, 1, n_k, (-(-C // 64), -(-F // 64), E))
    if C <= MOE_STREAM_N[-1]:
        n = next(v for v in MOE_STREAM_N if v >= C)
        tiles = -(-F // MOE_STREAM_COLS) * E
        slots = 2 * sms
        costs = {}
        for split in range(1, MOE_MAX_SPLIT + 1):
            kps = -(-n_k // split)
            if -(-n_k // kps) == split:   # else some split would be empty
                waves = -(-tiles * split // slots)
                costs[split] = ((waves + 1) * kps, kps)
        least = min(c for c, _ in costs.values())
        split = min(s for s, (c, _) in costs.items() if c <= 1.1 * least)
        kps = costs[split][1]
        return MoePlan("stream", n, MOE_STREAM_COLS, split, kps,
                       (split, -(-F // MOE_STREAM_COLS), E))
    rows = 128 if -(-C // 128) * 128 <= -(-C // 192) * 192 else 192
    row_tiles = -(-C // rows)

    def cost(cols):
        waves = -(-(row_tiles * -(-F // cols) * E) // sms)
        return waves * cols * (1.0 if cols == 256 else 1.15)

    cols = 256 if rows == 128 and cost(256) <= cost(128) else 128
    return MoePlan("wgmma", rows, cols, 1, n_k, (row_tiles, -(-F // cols), E))


@functools.lru_cache(maxsize=None)
def _moe_plan(device, E, C, D, F, x_bf16, w_bf16):
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return moe_plan(E, C, D, F, sms, x_bf16, w_bf16)


def moe_gemm(x, w, *, out_dtype=None):
    """Grouped GEMM x (E,C,D) @ w (E,D,F) -> (E,C,F), fp32 accumulation.
    x and w are each fp32 or bf16 (the tiny configs and the fp32 parity
    runs pair fp32 with bf16); bf16 x bf16 runs on the tensor cores, by
    ``moe_plan``.  The output is ``out_dtype``, fp32 or bf16, by default
    x's dtype (what the TPU kernel writes).  Any C, D, F."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return ref.moe_gemm(x, w, out_dtype)
    E, C, D = x.shape
    F = w.shape[-1]
    _check("moe_gemm", x.device, {"x": x, "w": w}, (),
           free_names=("x", "w"))
    if tuple(w.shape) != (E, D, F):
        raise ValueError(f"moe_gemm: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} do not chain")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"moe_gemm: out_dtype float32 or bfloat16 only, "
                        f"got {out_dtype}")
    out = torch.empty((E, C, F), dtype=out_dtype, device=x.device)
    if x.device.type == "meta":
        return _dry(moe_gemm, out)
    bf16 = torch.bfloat16
    _moe_launch(x, w, out, _moe_plan(x.device, E, C, D, F, x.dtype == bf16,
                                     w.dtype == bf16))
    moe_gemm.launches += 1
    return out


def _moe_launch(x, w, out, plan: MoePlan):
    """Launch moe_gemm's kernel on checked tensors by ``plan``."""
    E, C, D = x.shape
    bf16 = torch.bfloat16
    _launch("moe_gemm", x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(),
            E, C, D, w.shape[-1], int(x.dtype == bf16), int(w.dtype == bf16),
            int(out.dtype == bf16), MOE_REGIMES[plan.regime], plan.rows,
            plan.cols, plan.split, plan.kps)


RMS_MAX_CHUNKS = 8 * 256   # 16-byte chunks a row: 8 a thread, 256 threads


def _rms_width(name, x, *scales):
    """Raise unless every scale is (D,) for x (..., D), D a multiple of
    the 16-byte chunk and at most RMS_MAX_CHUNKS chunks.  Returns D."""
    D = x.shape[-1]
    chunk = 16 // x.element_size()
    if any(tuple(s.shape) != (D,) for s in scales) or D % chunk \
            or D // chunk > RMS_MAX_CHUNKS:
        raise ValueError(
            f"{name}: x {tuple(x.shape)} with scales "
            f"{[tuple(s.shape) for s in scales]}; D must be a multiple of "
            f"{chunk} and at most {chunk * RMS_MAX_CHUNKS}")
    return D


def rmsnorm(x, scale, *, eps=1e-6):
    """Row RMSNorm of x (..., D), fp32 or bf16, by scale (D,) fp32: fp32
    mean of squares, rsqrt, fp32 scale, cast to x's dtype.  D a multiple
    of 8 (bf16) or 4 (fp32), at most 16384 (bf16) or 8192 (fp32)."""
    if x.device.type == "cpu":
        return ref.rmsnorm(x, scale, eps)
    _check("rmsnorm", x.device, {"x": x, "scale": scale}, ("x",),
           fp32_names=("scale",))
    D = _rms_width("rmsnorm", x, scale)
    out = torch.empty_like(x)
    if x.device.type == "meta":
        return _dry(rmsnorm, out)
    _launch("rmsnorm", x.device, x.data_ptr(), scale.data_ptr(),
            out.data_ptr(), x.numel() // D, D, eps,
            int(x.dtype == torch.bfloat16))
    rmsnorm.launches += 1
    return out


def add_rmsnorm(x, delta, scale, *, eps=1e-6):
    """The residual add and the norm after it in one launch: returns
    (s, rmsnorm(s)) with s = x + delta rounded to x's dtype, the same
    bits as ``x + delta`` followed by ``rmsnorm``.  x and delta share one
    shape and dtype; the rest as ``rmsnorm``."""
    if x.device.type == "cpu":
        return ref.add_rmsnorm(x, delta, scale, eps)
    _check("add_rmsnorm", x.device, {"x": x, "delta": delta, "scale": scale},
           ("x", "delta"), fp32_names=("scale",))
    if delta.shape != x.shape:
        raise ValueError(f"add_rmsnorm: x {tuple(x.shape)} and delta "
                         f"{tuple(delta.shape)} differ")
    D = _rms_width("add_rmsnorm", x, scale)
    s, out = torch.empty_like(x), torch.empty_like(x)
    if x.device.type == "meta":
        return _dry(add_rmsnorm, (s, out))
    _launch("add_rmsnorm", x.device, x.data_ptr(), delta.data_ptr(),
            scale.data_ptr(), s.data_ptr(), out.data_ptr(), x.numel() // D,
            D, eps, int(x.dtype == torch.bfloat16))
    add_rmsnorm.launches += 1
    return s, out


def qk_rmsnorm(q, k, q_scale, k_scale, *, eps=1e-6):
    """``rmsnorm(q, q_scale), rmsnorm(k, k_scale)`` in one launch, with
    the same bits: q (..., D) and k (..., D) of one dtype (a layer's q
    and k heads); the rest as ``rmsnorm``."""
    if q.device.type == "cpu":
        return ref.rmsnorm(q, q_scale, eps), ref.rmsnorm(k, k_scale, eps)
    _check("qk_rmsnorm", q.device,
           {"q": q, "k": k, "q_scale": q_scale, "k_scale": k_scale},
           ("q", "k"), fp32_names=("q_scale", "k_scale"))
    if k.shape[-1] != q.shape[-1]:
        raise ValueError(f"qk_rmsnorm: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in width")
    D = _rms_width("qk_rmsnorm", q, q_scale, k_scale)
    qo, ko = torch.empty_like(q), torch.empty_like(k)
    if q.device.type == "meta":
        return _dry(qk_rmsnorm, (qo, ko))
    _launch("qk_rmsnorm", q.device, q.data_ptr(), q_scale.data_ptr(),
            qo.data_ptr(), q.numel() // D, k.data_ptr(), k_scale.data_ptr(),
            ko.data_ptr(), k.numel() // D, D, eps,
            int(q.dtype == torch.bfloat16))
    qk_rmsnorm.launches += 1
    return qo, ko


RWKV_CHUNK = 32          # tokens a chunk of the chunk kernel
RWKV_MAX_HEAD = 64       # K and V, zero-padded to it in shared memory
RWKV_STEP_COLS = 16      # V columns a CTA of the step kernel
RWKV_DESIGNS = {"step": 0, "chunks": 1}


class Rwkv6Plan(NamedTuple):
    """How ``rwkv6_scan`` runs one call.  ``design``: "step" (S = 1, a
    decode step: a CTA per (b, h) and 16 columns of V) or "chunks" (S > 1:
    a CTA per (b, h) walks ``chunks`` chunks of RWKV_CHUNK tokens in
    order, ``last`` tokens in the last one).  ``grid``: the launch's
    (x, y), x the fastest."""
    design: str
    chunks: int
    last: int
    grid: tuple


def rwkv6_plan(B: int, S: int, H: int, K: int, V: int) -> Rwkv6Plan:
    """The plan of ``rwkv6_scan``: S = 1 takes the step kernel, longer
    sequences the chunk kernel.  (A chunk kernel over slices of V, and a
    two-pass one, with the states at the chunk starts first and every
    chunk's output in parallel after, were slower at every S measured;
    PERF.md section 6.)"""
    if S == 1:
        return Rwkv6Plan("step", 1, 1, (-(-V // RWKV_STEP_COLS), B * H))
    chunks = -(-S // RWKV_CHUNK)
    return Rwkv6Plan("chunks", chunks, S - (chunks - 1) * RWKV_CHUNK,
                     (B * H, 1))


def rwkv6_scan(r, k, v, lw, u, S0):
    """RWKV-6 wkv.  r, k (B,S,H,K) and v (B,S,H,V) share one dtype, fp32
    or bf16; the log-decay lw (B,S,H,K), u (H,K) and S0 (B,H,K,V) are fp32
    whatever that dtype is (the reference keeps the decay and the state in
    fp32).  Returns (o (B,S,H,V), S_T (B,H,K,V)), fp32.  Any S >= 1;
    K, V <= 64; the kernel by ``rwkv6_plan``."""
    if r.device.type == "cpu":
        return ref.rwkv6_scan(r, k, v, lw, u, S0)
    B, S, H, K = r.shape
    V = v.shape[-1]
    _check("rwkv6_scan", r.device,
           {"r": r, "k": k, "v": v, "lw": lw, "u": u, "S0": S0},
           ("r", "k", "v"), fp32_names=("lw", "u", "S0"))
    if k.shape != r.shape or lw.shape != r.shape \
            or tuple(v.shape) != (B, S, H, V) or tuple(u.shape) != (H, K) \
            or tuple(S0.shape) != (B, H, K, V):
        raise ValueError(
            f"rwkv6_scan: bad shapes r {tuple(r.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, lw {tuple(lw.shape)}, u {tuple(u.shape)}, "
            f"S0 {tuple(S0.shape)}")
    if S < 1 or K > RWKV_MAX_HEAD or V > RWKV_MAX_HEAD:
        raise ValueError(f"rwkv6_scan: S={S} must be >= 1 and K={K}, V={V} "
                         f"at most {RWKV_MAX_HEAD}")
    o = torch.empty((B, S, H, V), dtype=torch.float32, device=r.device)
    S_T = torch.empty_like(S0)
    if r.device.type == "meta":
        return _dry(rwkv6_scan, (o, S_T))
    _launch("rwkv6_scan", r.device, r.data_ptr(), k.data_ptr(), v.data_ptr(),
            lw.data_ptr(), u.data_ptr(), S0.data_ptr(), o.data_ptr(),
            S_T.data_ptr(), B, S, H, K, V, int(r.dtype == torch.bfloat16),
            RWKV_DESIGNS[rwkv6_plan(B, S, H, K, V).design])
    rwkv6_scan.launches += 1
    return o, S_T


def rglru_scan(a, b, h0):
    """h_t = a_t * h_{t-1} + b_t with h0 the carry into step 0.  a, b
    (B,S,W) fp32; h0 (B,W) fp32.  Returns (hs (B,S,W), hT (B,W)), fp32."""
    if a.device.type == "cpu":
        return ref.rglru_scan(a, b, h0)
    B, S, W = a.shape
    _check("rglru_scan", a.device, {"a": a, "b": b, "h0": h0}, (),
           fp32_names=("a", "b", "h0"))
    if b.shape != a.shape or tuple(h0.shape) != (B, W) or S < 1:
        raise ValueError(f"rglru_scan: bad shapes a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}, h0 {tuple(h0.shape)}")
    hs = torch.empty_like(a)
    hT = torch.empty_like(h0)
    if a.device.type == "meta":
        return _dry(rglru_scan, (hs, hT))
    _launch("rglru_scan", a.device, a.data_ptr(), b.data_ptr(),
            h0.data_ptr(), hs.data_ptr(), hT.data_ptr(), B, S, W)
    rglru_scan.launches += 1
    return hs, hT


KERNELS = (flash_attention, paged_decode_attention, rwkv6_scan, rglru_scan,
           moe_gemm, decode_attention, rmsnorm)
# every wrapper that launches a kernel: the seven, and the fused rmsnorm
# entry points, whose launches count towards ``KERNEL_OF``'s kernel
WRAPPERS = KERNELS + (add_rmsnorm, qk_rmsnorm)
KERNEL_OF = {fn.__name__: _LIBRARY.get(fn.__name__, fn.__name__)
             for fn in WRAPPERS}


def reset_launches() -> None:
    for fn in WRAPPERS:
        fn.launches = 0
    paged_decode_attention.masked_launches = 0


def reset_dry_calls() -> None:
    for fn in WRAPPERS:
        fn.dry_calls = 0


def dry_calls() -> dict:
    """Each wrapper's meta calls since ``reset_dry_calls``."""
    return {fn.__name__: fn.dry_calls for fn in WRAPPERS}


reset_launches()
reset_dry_calls()
