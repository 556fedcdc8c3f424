"""Griffin recurrent block: temporal conv1d + RG-LRU gated linear recurrence.

Reference: ``repro/models/rglru.py``.  Recurrence (Griffin,
arXiv:2402.19427):
    r_t = sigmoid(blockdiag(W_a) u_t + b_a)          (recurrence gate)
    i_t = sigmoid(blockdiag(W_x) u_t + b_x)          (input gate)
    log a_t = -c * softplus(Lambda) * r_t            (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The block: x -> [linear gate branch -> GeLU] * [linear -> conv1d -> RG-LRU]
           -> linear out.

Implementations (``cfg.impl``): ref = a loop over time (the kernel's
plain version, ``kernels/ref.rglru_scan``); blocked =
a log-step doubling scan over the sequence; pallas = the ``rglru_scan``
kernel through ``kernels/ops.py`` (the hand-written CUDA kernel on a CUDA
tensor).  Decode is one plain step under every impl, as in the reference.

On a model group (``x`` Shards of the whole sequence, the residual
gathered before the mixer as the reference's blocks do) each position
holds its block of the RG-LRU lanes (the reference's "tp" specs): its
columns of the two input projections, its conv taps, its recurrence
(the ``rglru_scan`` kernel under impl "pallas") and its rows of the
output projection, which ``row_parallel`` sums.  The block-diagonal
gates are whole on every position; a lane block that cuts a gate head
gathers the conv output to every lane for them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as kref
from repro_torch.models import modules as nn

C_FACTOR = 8.0


class RGLRUCache(NamedTuple):
    h: torch.Tensor          # (B, W) recurrence state (fp32)
    conv: torch.Tensor       # (B, conv_width-1, W) trailing conv inputs


def _conv1d(p, x, state=None):
    """Causal depthwise conv, width K. x (B,S,W); state (B,K-1,W) or None.

    Written as the reference's sum of shifted products (F.conv1d would go
    through cuDNN, in TF32 by default).  A bf16 ``x`` times the fp32
    ``conv_w`` promotes to fp32, as in JAX, so the output is fp32 while
    the returned conv state keeps the activation dtype."""
    K = p["conv_w"].shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * p["conv_w"][K - 1 - i]
              for i in range(K))
    return out + p["conv_b"].to(x.dtype), xp[:, -(K - 1):]


def _gate_rz(p, heads: slice, u):
    """The recurrence and input gates of the gate heads ``heads`` from
    their lanes u (B,S,W_h): (r, i), fp32 (B,S,W_h)."""
    B, S, W = u.shape
    wa, wx = p["lru_a_gate_w"][heads], p["lru_x_gate_w"][heads]
    uh = u.reshape(B, S, wa.shape[0], wa.shape[1]).float()
    r = torch.sigmoid(torch.einsum("bshd,hde->bshe", uh, wa.float())
                      + p["lru_a_gate_b"][heads])
    i = torch.sigmoid(torch.einsum("bshd,hde->bshe", uh, wx.float())
                      + p["lru_x_gate_b"][heads])
    return r.reshape(B, S, W), i.reshape(B, S, W)


def _gates(p, cfg, u):
    """u (B,S,W) -> a, gated input (both fp32)."""
    r, i = _gate_rz(p, slice(None), u)
    return _gated(p, r, i, u)


def _gated(p, r, i, u):
    """a and the gated input from the gates r, i of the lanes u."""
    log_a = -C_FACTOR * F.softplus(p["lru_a_param"]) * r       # (B,S,W) fp32
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * i * u.float()
    return a, gated


def _scan_assoc(a, b, h0):
    """Log-step doubling scan over the sequence axis (Hillis-Steele):
    after the step with offset d every position holds the composition of
    the affine maps of its last 2d steps.  The reference calls
    ``lax.associative_scan``; torch has no public associative scan, so
    the combine (a_x, b_x) . (a_y, b_y) = (a_x a_y, a_y b_x + b_y) is
    applied with tensor shifts."""
    b = b.clone()
    b[:, 0] = b[:, 0] + a[:, 0] * h0        # fold h0 into the first step
    S = a.shape[1]
    d = 1
    while d < S:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a_prev], dim=1)
        d *= 2
    return b, b[:, -1]


def _scan(cfg, a, b, h0):
    if cfg.impl == "ref":
        return kref.rglru_scan(a, b, h0)
    if cfg.impl == "blocked":
        return _scan_assoc(a, b, h0)
    if cfg.impl == "pallas":
        from repro_torch.kernels import ops as kops
        return kops.rglru_scan(a, b, h0)
    raise ValueError(cfg.impl)


def _apply_tp(p, cfg, x, cache, decode: bool):
    """The block on a model group: x Shards (B,S,D) whole on every
    position; ``cache`` each position's RGLRUCache of its lanes, or None
    (a prefill from zeros).  A decode step (S = 1) is the plain step, as
    on one device.  Returns (out Shards, PerPos of RGLRUCache)."""
    from repro_torch.parallel import collectives as col
    g = x.group
    W = cfg.lru_width or cfg.d_model
    ghd = W // cfg.n_heads
    gate, ux = col.column_parallel(x, [p["lru_in_gate"], p["lru_in_x"]])
    gate = col.local(lambda t: F.gelu(t, approximate="tanh"), gate)
    u, conv = col.local(lambda pm, t, c: _conv1d(
        pm, t, None if c is None else c.conv), p, ux,
        col.PerPos(cache) if cache is not None else None)
    Wl = u[0].shape[-1]
    if Wl % ghd == 0:      # each lane block holds whole gate heads
        rz = col.local(lambda m, pm, t: _gate_rz(
            pm, slice(m * Wl // ghd, (m + 1) * Wl // ghd), t), p, u,
            index=True)
    else:
        uf = col.all_gather(u, -1, "lru_gates")
        rz = col.local(lambda m, pm, t: tuple(
            col.own_cols(z, m, g.size) for z in _gate_rz(pm, slice(None), t)),
            p, uf, index=True)
    ab = col.local(lambda pm, r, i, t: _gated(pm, r, i, t), p, rz[0], rz[1],
                   u)

    def rec(m, a, b, c):
        h0 = c.h if c is not None else torch.zeros(
            (a.shape[0], a.shape[-1]), dtype=torch.float32, device=a.device)
        if decode:
            h = a[:, 0] * h0 + b[:, 0]
            return h[:, None], h
        return _scan(cfg, a.contiguous(), b.contiguous(), h0)
    hs, hT = col.local(rec, ab[0], ab[1],
                       col.PerPos(cache) if cache is not None else None,
                       index=True)
    out = col.local(lambda h, gt, t: h.to(t.dtype) * gt, hs, gate, x)
    out = col.Shards(list(out), g, out[0].ndim - 1)
    return col.row_parallel(out, p["lru_out"]), col.PerPos(
        RGLRUCache(h=h, conv=c) for h, c in zip(hT, conv))


def apply(p, cfg, x, *, cache: RGLRUCache = None):
    """Full-sequence path. x (B,S,D) -> (out, RGLRUCache).  On a model
    group (``x`` Shards) ``_apply_tp``."""
    from repro_torch.parallel import collectives as col
    if isinstance(x, col.Shards):
        return _apply_tp(p, cfg, x, cache, decode=False)
    gate = F.gelu(nn.matmul(x, p["lru_in_gate"]), approximate="tanh")
    ux = nn.matmul(x, p["lru_in_x"])
    conv_state = cache.conv if cache is not None else None
    u, conv_out = _conv1d(p, ux, conv_state)
    a, b = _gates(p, cfg, u)
    h0 = cache.h if cache is not None else torch.zeros(
        (x.shape[0], u.shape[-1]), dtype=torch.float32, device=x.device)
    hs, hT = _scan(cfg, a, b, h0)
    out = hs.to(x.dtype) * gate
    return nn.matmul(out, p["lru_out"]), RGLRUCache(h=hT, conv=conv_out)


def apply_decode(p, cfg, x, cache: RGLRUCache):
    """Single-step path. x (B,1,D)."""
    from repro_torch.parallel import collectives as col
    if isinstance(x, col.Shards):
        return _apply_tp(p, cfg, x, cache, decode=True)
    gate = F.gelu(nn.matmul(x, p["lru_in_gate"]), approximate="tanh")
    ux = nn.matmul(x, p["lru_in_x"])
    u, conv_state = _conv1d(p, ux, cache.conv)
    a, b = _gates(p, cfg, u)
    h = a[:, 0] * cache.h + b[:, 0]
    out = h[:, None].to(x.dtype) * gate
    return nn.matmul(out, p["lru_out"]), RGLRUCache(h=h, conv=conv_state)


def cache_init(cfg, batch: int, dtype, device):
    w = cfg.lru_width or cfg.d_model
    return RGLRUCache(
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, cfg.conv1d_width - 1, w), dtype=dtype,
                         device=device))
