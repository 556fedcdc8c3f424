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


def _gates(p, cfg, u):
    """u (B,S,W) -> a, gated input (both fp32)."""
    B, S, W = u.shape
    heads = cfg.n_heads
    hd = W // heads
    uh = u.reshape(B, S, heads, hd).float()
    r = torch.sigmoid(torch.einsum("bshd,hde->bshe", uh,
                                   p["lru_a_gate_w"].float())
                      + p["lru_a_gate_b"])
    i = torch.sigmoid(torch.einsum("bshd,hde->bshe", uh,
                                   p["lru_x_gate_w"].float())
                      + p["lru_x_gate_b"])
    r = r.reshape(B, S, W)
    i = i.reshape(B, S, W)
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


def apply(p, cfg, x, *, cache: RGLRUCache = None):
    """Full-sequence path. x (B,S,D) -> (out, RGLRUCache)."""
    gate = F.gelu(nn.matmul(x, p["lru_in_gate"]), approximate="tanh")
    ux = nn.matmul(x, p["lru_in_x"])
    conv_state = cache.conv if cache is not None else None
    u, conv_out = _conv1d(p, ux, conv_state)
    a, b = _gates(p, cfg, u)
    h0 = cache.h if cache is not None else torch.zeros(
        (x.shape[0], u.shape[-1]), dtype=torch.float32, device=x.device)
    if cfg.impl == "ref":
        hs, hT = kref.rglru_scan(a, b, h0)
    elif cfg.impl == "blocked":
        hs, hT = _scan_assoc(a, b, h0)
    elif cfg.impl == "pallas":
        from repro_torch.kernels import ops as kops
        hs, hT = kops.rglru_scan(a, b, h0)
    else:
        raise ValueError(cfg.impl)
    out = hs.to(x.dtype) * gate
    return nn.matmul(out, p["lru_out"]), RGLRUCache(h=hT, conv=conv_out)


def apply_decode(p, cfg, x, cache: RGLRUCache):
    """Single-step path. x (B,1,D)."""
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
