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

On a model group (``x`` Shards) each position holds its block of the
heads: the time-mix runs on the whole sequence (the residual gathered
before it, as in the reference's blocks), every position computing the
token-shift mixes and the decay (their weights are whole) and its heads'
r, k, v, g, wkv (the ``rwkv6_scan`` kernel under impl "pallas") and
group norm, summed back by ``row_parallel`` of wo; the channel-mix runs
on the sequence-split residual, each position's token shift reading the
last row of the position before it, its squared-ReLU columns and the
rows of wv through ``column_parallel`` and ``row_parallel``.
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
def _time_mix_tp(p, cfg, x, cache):
    """The time-mix on a model group: x Shards (B,S,D) whole on every
    position, ``cache`` each position's RWKVCache (its heads' state)."""
    from repro_torch.parallel import collectives as col
    g = x.group
    hd = cfg.head_dim

    def heads(m, pm, xm, c):
        B, S, D = xm.shape
        Hl = pm["rwkv_wr"].shape[-1] // hd
        cols = slice(m * Hl * hd, (m + 1) * Hl * hd)
        xw, xk, xv, xr, xg = _time_mix_inputs(pm, xm, c.x_tm)
        r = nn.matmul(xr, pm["rwkv_wr"]).reshape(B, S, Hl, hd)
        k = nn.matmul(xk, pm["rwkv_wk"]).reshape(B, S, Hl, hd)
        v = nn.matmul(xv, pm["rwkv_wv"]).reshape(B, S, Hl, hd)
        gt = F.silu(nn.matmul(xg, pm["rwkv_wg"]))
        lw = _decay(pm, xw)[..., cols].reshape(B, S, Hl, hd).contiguous()
        o, S_T = _wkv(cfg, r, k, v, lw, pm["rwkv_u"].float(), c.state)
        o = _group_norm({"rwkv_ln_scale": pm["rwkv_ln_scale"][cols],
                         "rwkv_ln_bias": pm["rwkv_ln_bias"][cols]},
                        o.float()).to(xm.dtype)
        return o * gt, RWKVCache(state=S_T, x_tm=xm[:, -1], x_cm=c.x_cm)
    og, caches = col.local(heads, p, x, col.PerPos(cache), index=True)
    og = col.Shards(list(og), g, og[0].ndim - 1)
    return col.row_parallel(og, p["rwkv_wo"]), col.PerPos(caches)


def _channel_mix_tp(p, cfg, x, cache):
    """The channel-mix on a model group: x Shards (B,S/n,D) split on the
    sequence (each token shift reads the previous position's last row)
    or whole on every position (a decode step)."""
    from repro_torch.parallel import collectives as col
    g = x.group
    if x.split is None:
        prev = col.PerPos(c.x_cm for c in cache)
        last = col.PerPos(t[:, -1] for t in x)
    else:
        prev = col.shift_in(x, cache[0].x_cm)
        last = col.broadcast(x[-1][:, -1], g, "shift", src=g.size - 1) \
            if g.size > 1 \
            else col.PerPos([x[0][:, -1]])

    def mixes(pm, xm, pv):
        sx = _shift(xm, pv) - xm
        return (xm + sx * pm["rwkv_cm_mix_k"].to(xm.dtype),
                xm + sx * pm["rwkv_cm_mix_r"].to(xm.dtype))
    xk, xr = col.local(mixes, p, x, prev)
    (kk,) = col.column_parallel(xk, [p["rwkv_cm_wk"]])
    h = col.local(lambda t: torch.square(F.relu(t)), kk)
    vv = col.row_parallel(h, p["rwkv_cm_wv"])
    out = col.local(lambda pm, t, v: torch.sigmoid(
        nn.matmul(t, pm["rwkv_cm_wr"])) * v, p, xr, vv)
    return out, col.PerPos(RWKVCache(state=c.state, x_tm=c.x_tm, x_cm=l)
                           for c, l in zip(cache, last))


def cache_init_tp(cfg, batch: int, dtype, group, heads: int):
    """Each position's zero cache on a model group, ``heads`` heads a
    position."""
    from repro_torch.parallel import collectives as col
    return col.PerPos(RWKVCache(
        state=torch.zeros((batch, heads, cfg.head_dim, cfg.head_dim),
                          dtype=torch.float32, device=d),
        x_tm=torch.zeros((batch, cfg.d_model), dtype=dtype, device=d),
        x_cm=torch.zeros((batch, cfg.d_model), dtype=dtype, device=d))
        for d in group.devices)


def _wkv(cfg, r, k, v, lw, u, S0):
    if cfg.impl == "ref":
        return kref.rwkv6_scan(r, k, v, lw, u, S0)
    if cfg.impl == "blocked":
        return _wkv_chunked(r, k, v, lw, u, S0)
    if cfg.impl == "pallas":
        from repro_torch.kernels import ops as kops
        return kops.rwkv6_scan(r, k, v, lw, u, S0)
    raise ValueError(cfg.impl)


def time_mix(p, cfg, x, cache: RWKVCache):
    from repro_torch.parallel import collectives as col
    if isinstance(x, col.Shards):
        return _time_mix_tp(p, cfg, x, cache)
    B, S, D = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    xw, xk, xv, xr, xg = _time_mix_inputs(p, x, cache.x_tm)
    r = nn.matmul(xr, p["rwkv_wr"]).reshape(B, S, H, hd)
    k = nn.matmul(xk, p["rwkv_wk"]).reshape(B, S, H, hd)
    v = nn.matmul(xv, p["rwkv_wv"]).reshape(B, S, H, hd)
    g = F.silu(nn.matmul(xg, p["rwkv_wg"]))
    lw = _decay(p, xw).reshape(B, S, H, hd)
    o, S_T = _wkv(cfg, r, k, v, lw, p["rwkv_u"].float(), cache.state)
    o = _group_norm(p, o.float()).to(x.dtype)
    out = nn.matmul(o * g, p["rwkv_wo"])
    return out, RWKVCache(state=S_T, x_tm=x[:, -1], x_cm=cache.x_cm)


def channel_mix(p, cfg, x, cache: RWKVCache):
    from repro_torch.parallel import collectives as col
    if isinstance(x, col.Shards):
        return _channel_mix_tp(p, cfg, x, cache)
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
