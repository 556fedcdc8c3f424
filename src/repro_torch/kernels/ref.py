"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Transcribed from ``repro/kernels/ref.py``: they materialize the full score
matrix or step a recurrence one timestep at a time, and are the ground
truth the CUDA kernels are held against.  The
wrappers in ``kernels/ops.py`` run these only for tensors on the CPU.
"""
from __future__ import annotations

import torch

NEG_INF = -2.0 ** 30


def flash_attention(q, k, v, *, causal=True, window=None, scale=None,
                    softcap=None):
    """q,k,v (B,S,H,hd) (k/v pre-expanded to H). Full-scores oracle."""
    B, S, H, hd = q.shape
    scale = hd ** -0.5 if scale is None else scale
    s = torch.einsum("bqhd,bthd->bhqt", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    i = torch.arange(S, device=q.device)[:, None]
    j = torch.arange(S, device=q.device)[None, :]
    ok = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        ok &= j <= i
    if window is not None:
        ok &= (i - j) < window
    s = torch.where(ok[None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bhqt,bthd->bqhd", w, v.float())
    return o.to(q.dtype)


def decode_attention(q, k, v, pos, *, scale=None, softcap=None):
    """q (B,H,hd); k,v (B,T,Kv,hd); pos scalar. Valid slots are <= pos."""
    B, H, hd = q.shape
    Kv = k.shape[2]
    G = H // Kv
    scale = hd ** -0.5 if scale is None else scale
    qg = q.reshape(B, Kv, G, hd).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    ok = torch.arange(k.shape[1], device=q.device) <= pos
    s = torch.where(ok[None, None, None], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,btkd->bkgd", w, v.float())
    return o.reshape(B, H, hd).to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, block_tables, pos, *,
                           scale=None, softcap=None, page_mask=None,
                           partials=False):
    """Paged-KV oracle: gather pages, then dense masked decode attention.

    q (B,H,hd); k_pages/v_pages (P,ps,Kv,hd); block_tables (B,nmax) int32
    physical page ids; pos (B,) int32 — slots <= pos[b] are valid.

    ``page_mask`` (B,nmax) int32 marks the table entries the caller owns
    (a stripe of a striped pool): an unowned entry is skipped, its page
    never reaches the arithmetic (its rows are replaced by zeros before
    the scores, so a NaN there cannot leak), as the TPU kernel skips it
    with ``pl.when``.  ``partials=True`` returns the raw online-softmax
    state ``(acc (B,Kv,G,hd), m (B,Kv,G), l (B,Kv,G))`` in fp32 instead
    of the normalized (B,H,hd) output; a sequence that owns no valid
    slot gets m = NEG_INF, l = 0, acc = 0.
    """
    B, H, hd = q.shape
    ps, Kv = k_pages.shape[1], k_pages.shape[2]
    nmax = block_tables.shape[1]
    T = nmax * ps
    G = H // Kv
    scale = hd ** -0.5 if scale is None else scale
    bt = block_tables.long()
    ok = torch.arange(T, device=q.device)[None, :] <= pos.long()[:, None]
    if page_mask is not None:
        owned = page_mask != 0
        ok = ok & owned.repeat_interleave(ps, dim=1)
        bt = torch.where(owned, bt, 0)
    k = k_pages[bt].reshape(B, T, Kv, hd)
    v = v_pages[bt].reshape(B, T, Kv, hd)
    if page_mask is not None:
        keep = ok[:, :, None, None]
        k = torch.where(keep, k, 0)
        v = torch.where(keep, v, 0)
    qg = q.reshape(B, Kv, G, hd).float()
    s = torch.einsum("bkgd,btkd->bkgt", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    if page_mask is None and not partials:
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgt,btkd->bkgd", w, v.float())
        return o.reshape(B, H, hd).to(q.dtype)
    m = s.amax(-1)
    p = torch.where(ok[:, None, None, :], torch.exp(s - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bkgt,btkd->bkgd", p, v.float())
    if partials:
        return acc, m, l
    o = acc / torch.clamp(l, min=1e-37)[..., None]
    return o.reshape(B, H, hd).to(q.dtype)


def rglru_scan(a, b, h0):
    """h_t = a_t * h_{t-1} + b_t, stepwise. a,b (B,S,W) f32; h0 (B,W).
    Returns (hs (B,S,W), hT (B,W))."""
    h = h0
    hs = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rwkv6_scan(r, k, v, lw, u, S0):
    """Stepwise RWKV-6 wkv. r,k,v,lw (B,S,H,K); u (H,K); S0 (B,H,K,V).
    Returns (o (B,S,H,V) fp32, S_T (B,H,K,V) fp32)."""
    S = S0.float()
    u = u.float()
    os = []
    for t in range(r.shape[1]):
        rt, kt, vt, lwt = (x[:, t].float() for x in (r, k, v, lw))
        kv = torch.einsum("bhk,bhv->bhkv", kt, vt)
        os.append(torch.einsum("bhk,bhkv->bhv", rt,
                               S + u[None, :, :, None] * kv))
        S = torch.exp(lwt)[..., None] * S + kv
    return torch.stack(os, dim=1), S


def moe_gemm(x, w, out_dtype=None):
    """Grouped GEMM: x (E,C,D) @ w (E,D,F) -> (E,C,F), fp32 accumulate,
    written in ``out_dtype`` (default x's dtype, as the TPU kernel)."""
    out = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    return out.to(x.dtype if out_dtype is None else out_dtype)


def rmsnorm(x, scale, eps=1e-6):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def add_rmsnorm(x, delta, scale, eps=1e-6):
    """The residual add, then the norm: (x + delta, rmsnorm(x + delta))."""
    s = x + delta
    return s, rmsnorm(s, scale, eps)
