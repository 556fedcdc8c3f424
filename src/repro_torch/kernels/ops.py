"""Public wrappers of the port's kernels, dispatched on the tensor's device.

A CPU tensor takes the plain PyTorch version (``kernels/ref.py``).  A CUDA
tensor takes the hand-written CUDA kernel (``csrc/``), built at first use;
if the card is not sm_90, or the build, the load or the launch fails, the
wrapper raises.  There is no fallback from the kernel to the plain version.

Each wrapper counts its kernel launches in ``<wrapper>.launches`` (plain
calls on CPU tensors do not count), so a run can show that its main path
went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build, ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, out, B, S, H, hd, scale, softcap, causal, window, bf16, stream
    "flash_attention": [_P] * 4 + [_I] * 4 + [_F] * 2 + [_I] * 3 + [_P],
    # q, k_pages, v_pages, block_tables, pos, out, scratch, B, Kv, G, hd,
    # ps, nmax, NS, tps, scale, softcap, bf16, stream
    "paged_decode_attention": [_P] * 7 + [_I] * 8 + [_F] * 2 + [_I, _P],
}
_LAUNCHERS = {}


def _launcher(name: str):
    fn = _LAUNCHERS.get(name)
    if fn is None:
        fn = getattr(build.library(name), f"{name}_launch")
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_int
        _LAUNCHERS[name] = fn
    return fn


def _check(name, device, tensors, float_names, int_names=()):
    """Raise unless every tensor is a contiguous, 16-byte aligned CUDA
    tensor on ``device``; float operands share one dtype of fp32/bf16 and
    index operands are int32."""
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    build.check_device(device)
    dtype = tensors[float_names[0]].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: float32 or bfloat16 only, got {dtype}")
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")
        want = dtype if key in float_names else torch.int32
        if key in float_names + tuple(int_names) and t.dtype != want:
            raise TypeError(f"{name}: {key} is {t.dtype}, expected {want}")


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
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    _launch("flash_attention", q.device, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), B, S, H, hd, scale,
            softcap or 0.0, int(causal), window or 0,
            int(q.dtype == torch.bfloat16))
    flash_attention.launches += 1
    return out


DECODE_TILE = 32   # cache slots per tile of the paged-decode kernel


@functools.lru_cache(maxsize=None)
def _decode_splits(device, pairs: int, max_slots: int):
    """(NS, tiles per split) for the paged-decode kernel: split each
    (sequence, kv head) pair's slot range so that about four CTAs per SM
    are in flight.  Sized from the table width, not from ``pos`` (which
    lives on the device); splits past a sequence's ``pos`` do no work."""
    n_tiles = -(-max_slots // DECODE_TILE)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    ns = min(n_tiles, max(1, -(-4 * sms // pairs)))
    tps = -(-n_tiles // ns)
    return -(-n_tiles // tps), tps


def paged_decode_attention(q, k_pages, v_pages, block_tables, pos, *,
                           scale=None, softcap=None):
    """q (B,H,hd); k_pages/v_pages (P,ps,Kv,hd); block_tables (B,nmax)
    int32 physical page ids; pos (B,) int32 per-sequence last valid slot.
    Returns (B,H,hd).  Slots past pos[b] are masked exactly and never read
    by the kernel."""
    if q.device.type == "cpu":
        return ref.paged_decode_attention(q, k_pages, v_pages, block_tables,
                                          pos, scale=scale, softcap=softcap)
    B, H, hd = q.shape
    P, ps, Kv, hd_k = k_pages.shape
    nmax = block_tables.shape[1]
    _check("paged_decode_attention", q.device,
           {"q": q, "k_pages": k_pages, "v_pages": v_pages,
            "block_tables": block_tables, "pos": pos},
           ("q", "k_pages", "v_pages"), ("block_tables", "pos"))
    if v_pages.shape != k_pages.shape or hd_k != hd or H % Kv \
            or tuple(block_tables.shape) != (B, nmax) \
            or tuple(pos.shape) != (B,):
        raise ValueError(
            f"paged_decode_attention: bad shapes q {tuple(q.shape)}, pages "
            f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, block_tables "
            f"{tuple(block_tables.shape)}, pos {tuple(pos.shape)}")
    if hd % 16 or hd > 256:
        raise ValueError(f"paged_decode_attention: head_dim {hd} must be a "
                         "multiple of 16 and at most 256")
    scale = hd ** -0.5 if scale is None else scale
    ns, tps = _decode_splits(q.device, B * Kv, nmax * ps)
    out = torch.empty_like(q)
    # per-split online-softmax partials (acc, m, l), merged by the kernel
    scratch = torch.empty(B * Kv * ns * (H // Kv) * (hd + 2),
                          dtype=torch.float32, device=q.device)
    _launch("paged_decode_attention", q.device, q.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            pos.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, Kv,
            H // Kv, hd, ps, nmax, ns, tps, scale, softcap or 0.0,
            int(q.dtype == torch.bfloat16))
    paged_decode_attention.launches += 1
    return out


flash_attention.launches = 0
paged_decode_attention.launches = 0
KERNELS = (flash_attention, paged_decode_attention)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
