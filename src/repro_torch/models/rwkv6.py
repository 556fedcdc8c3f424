"""RWKV-6 "Finch" layer: time-mix with data-dependent decay + channel-mix.

Reference: ``repro/models/rwkv6.py``.  Time-mix recurrence per head
(K = V = head_dim):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
with data-dependent per-channel decay w_t = exp(-exp(dd_t)) and token-shift
low-rank interpolation for the five projections (w,k,v,r,g).

Implementations (``cfg.impl``): ref = a loop over time (the kernel's
plain version, ``kernels/ref.rwkv6_scan``); blocked = the
chunked algorithm with exact log-space intra-chunk decays; pallas = the
``rwkv6_scan`` kernel through ``kernels/ops.py`` (the hand-written CUDA
kernel on a CUDA tensor).  The LoRA products promote a bf16 activation
against the fp32 parameters to fp32 and cast back where the reference
does.  The layer bundles its own channel-mix (squared ReLU with token
shift), so ``blocks.py`` treats kind "rwkv6" as a complete layer.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as kref
from repro_torch.models import modules as nn

LORA_MIX = 32
LORA_DECAY = 64
CHUNK = 32


class RWKVCache(NamedTuple):
    state: torch.Tensor   # (B, H, K, V) fp32 time-mix state
    x_tm: torch.Tensor    # (B, D) previous token (time-mix shift)
    x_cm: torch.Tensor    # (B, D) previous token (channel-mix shift)


def _shift(x, x_prev):
    """x (B,S,D); x_prev (B,D) -> previous-token tensor (B,S,D)."""
    return torch.cat([x_prev[:, None].to(x.dtype), x[:, :-1]], 1)


def _time_mix_inputs(p, x, x_prev):
    """Token-shift interpolation -> (xw, xk, xv, xr, xg), each (B,S,D)."""
    sx = _shift(x, x_prev) - x
    xxx = x + sx * p["rwkv_mix_x"].to(x.dtype)
    h = torch.tanh(torch.einsum("bsd,dfk->bsfk", xxx.float(),
                                p["rwkv_mix_lora_a"].float()))
    deltas = torch.einsum("bsfk,fkd->bsfd", h.to(x.dtype).float(),
                          p["rwkv_mix_lora_b"].float())
    mix = p["rwkv_mix_base"][None, None].float() + deltas
    outs = x.float()[:, :, None] + sx.float()[:, :, None] * mix
    outs = outs.to(x.dtype)
    return tuple(outs[:, :, i] for i in range(5))


def _decay(p, xw):
    """Per-channel log-decay lw = -exp(dd) (B,S,D) fp32; w = exp(lw)."""
    dd = p["rwkv_decay_base"].float() + (
        xw.float() @ p["rwkv_decay_lora_a"].float()
    ) @ p["rwkv_decay_lora_b"].float()
    return -torch.exp(dd)


def _group_norm(p, o, eps=64e-5):
    """Per-head layernorm on (B,S,H,hd) (population variance, as the
    reference's ``var``), then (D,) scale/bias."""
    B, S, H, hd = o.shape
    mu = o.mean(-1, keepdim=True)
    var = o.var(-1, keepdim=True, correction=0)
    y = (o - mu) * torch.rsqrt(var + eps)
    y = y.reshape(B, S, H * hd)
    return y * p["rwkv_ln_scale"] + p["rwkv_ln_bias"]


# ---------------------------------------------------------------------------
# wkv recurrence
# ---------------------------------------------------------------------------
def _wkv_chunked(r, k, v, lw, u, S0, chunk=CHUNK):
    """Chunked algorithm, exact in fp32 log space.

    Within a chunk of length L (la = inclusive cumsum of lw):
      inter:  o_t += (r_t * exp(la_{t-1})) @ S0
      intra:  o_t += sum_{s<t} (sum_K r k exp(la_{t-1}-la_s)) v_s
      diag:   o_t += (r_t * u * k_t) @ v_t
      state:  S' = diag(exp(la_L)) S0 + sum_s (k_s exp(la_L - la_s))^T v_s
    All exponent differences are <= 0, so nothing overflows.  L follows
    the reference's divisor rule (the largest L <= chunk dividing S).
    """
    B, S, H, K = r.shape
    V = v.shape[-1]
    L = min(chunk, S)
    while S % L:
        L -= 1
    n = S // L
    rf = r.float().reshape(B, n, L, H, K)
    kf = k.float().reshape(B, n, L, H, K)
    vf = v.float().reshape(B, n, L, H, V)
    lwf = lw.reshape(B, n, L, H, K)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=r.device), diagonal=-1)   # s < t
    os = []
    for c in range(n):
        rc, kc, vc, lwc = rf[:, c], kf[:, c], vf[:, c], lwf[:, c]
        la = torch.cumsum(lwc, dim=1)                    # inclusive
        la_prev = la - lwc                               # la_{t-1}
        q_int = rc * torch.exp(la_prev)                  # (B,L,H,K)
        o = torch.einsum("blhk,bhkv->blhv", q_int, S0)
        # mask the EXPONENT (not the exp output): for s > t the difference
        # is positive and exp would overflow
        diff = la_prev[:, :, None] - la[:, None]         # (B,L,L,H,K) t,s
        diff = torch.where(mask[None, :, :, None, None], diff, -torch.inf)
        A = torch.einsum("blhk,bmhk,blmhk->blmh", rc, kc, torch.exp(diff))
        o = o + torch.einsum("blmh,bmhv->blhv", A, vc)
        du = torch.einsum("blhk,blhk->blh", rc, u[None, None] * kc)
        o = o + du[..., None] * vc
        la_L = la[:, -1]                                 # (B,H,K)
        k_dec = kc * torch.exp(la_L[:, None] - la)
        S0 = torch.exp(la_L)[..., None] * S0 + torch.einsum(
            "blhk,blhv->bhkv", k_dec, vc)
        os.append(o)
    return torch.stack(os, dim=1).reshape(B, S, H, V), S0


# ---------------------------------------------------------------------------
# layer entry points
# ---------------------------------------------------------------------------
def time_mix(p, cfg, x, cache: RWKVCache):
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    xw, xk, xv, xr, xg = _time_mix_inputs(p, x, cache.x_tm)
    r = nn.matmul(xr, p["rwkv_wr"]).reshape(B, S, H, hd)
    k = nn.matmul(xk, p["rwkv_wk"]).reshape(B, S, H, hd)
    v = nn.matmul(xv, p["rwkv_wv"]).reshape(B, S, H, hd)
    g = F.silu(nn.matmul(xg, p["rwkv_wg"]))
    lw = _decay(p, xw).reshape(B, S, H, hd)
    u = p["rwkv_u"].float()
    if cfg.impl == "ref":
        o, S_T = kref.rwkv6_scan(r, k, v, lw, u, cache.state)
    elif cfg.impl == "blocked":
        o, S_T = _wkv_chunked(r, k, v, lw, u, cache.state)
    elif cfg.impl == "pallas":
        from repro_torch.kernels import ops as kops
        o, S_T = kops.rwkv6_scan(r, k, v, lw, u, cache.state)
    else:
        raise ValueError(cfg.impl)
    o = _group_norm(p, o.float()).to(x.dtype)
    out = nn.matmul(o * g, p["rwkv_wo"])
    return out, RWKVCache(state=S_T, x_tm=x[:, -1], x_cm=cache.x_cm)


def channel_mix(p, cfg, x, cache: RWKVCache):
    sx = _shift(x, cache.x_cm) - x
    xk = x + sx * p["rwkv_cm_mix_k"].to(x.dtype)
    xr = x + sx * p["rwkv_cm_mix_r"].to(x.dtype)
    h = torch.square(F.relu(nn.matmul(xk, p["rwkv_cm_wk"])))
    out = torch.sigmoid(nn.matmul(xr, p["rwkv_cm_wr"])) \
        * nn.matmul(h, p["rwkv_cm_wv"])
    return out, RWKVCache(state=cache.state, x_tm=cache.x_tm, x_cm=x[:, -1])


def cache_init(cfg, batch: int, dtype, device):
    return RWKVCache(
        state=torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                          dtype=torch.float32, device=device),
        x_tm=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        x_cm=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device))
