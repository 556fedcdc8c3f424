"""Shared model primitives: norms, rotary embeddings, activations, FFN.

Reference: ``repro/models/modules.py``.  ``matmul``, the reference's
product (bf16 operands with fp32 accumulation on the card's tensor
cores, the promoted fp32 product elsewhere), lives in
``kernels/product.py``, which the collectives use too.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as kref
from repro_torch.kernels.product import matmul

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}


def dt(name: str) -> torch.dtype:
    return _DTYPES[name]


def rmsnorm(x, scale, eps: float = 1e-6, impl: Optional[str] = None):
    """fp32 mean of squares, rsqrt, fp32 scale, cast to x's dtype (the
    kernel's plain version); ``impl == "pallas"`` runs the rmsnorm
    kernel."""
    if impl == "pallas":
        from repro_torch.kernels import ops as kops
        return kops.rmsnorm(x.contiguous(), scale, eps=eps)
    return kref.rmsnorm(x, scale, eps)


def add_rmsnorm(x, delta, scale, eps: float = 1e-6,
                impl: Optional[str] = None):
    """The residual add and the norm after it: (x + delta, rmsnorm(x +
    delta)); ``impl == "pallas"`` runs both in one rmsnorm kernel launch,
    with the same bits."""
    if impl == "pallas":
        from repro_torch.kernels import ops as kops
        return kops.add_rmsnorm(x.contiguous(), delta.contiguous(), scale,
                                eps=eps)
    return kref.add_rmsnorm(x, delta, scale, eps)


def qk_rmsnorm(q, k, q_scale, k_scale, eps: float = 1e-6,
               impl: Optional[str] = None):
    """(rmsnorm(q, q_scale), rmsnorm(k, k_scale)); ``impl == "pallas"``
    runs both in one rmsnorm kernel launch, with the same bits."""
    if impl == "pallas":
        from repro_torch.kernels import ops as kops
        return kops.qk_rmsnorm(q.contiguous(), k.contiguous(), q_scale,
                               k_scale, eps=eps)
    return kref.rmsnorm(q, q_scale, eps), kref.rmsnorm(k, k_scale, eps)


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":       # the reference's jax.nn.gelu(approximate=True)
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(name)


# ---------------------------------------------------------------------------
# rotary position embeddings (standard RoPE)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def rope_angles(positions, head_dim: int, theta: float,
                sections: Optional[Tuple[int, int, int]] = None):
    """Angles (B, S, head_dim/2).

    positions: (B, S) int for standard RoPE, or (3, B, S) for M-RoPE,
    whose planes are the (temporal, height, width) ids; ``sections``
    gives how many of the head_dim/2 frequencies each plane owns."""
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., None].float() * inv              # (..., B, S, half)
    if sections is None:
        return ang
    t, h, w = sections
    assert t + h + w == head_dim // 2, (sections, head_dim)
    # per frequency, the angle of the plane it belongs to
    return torch.cat([ang[0, ..., :t], ang[1, ..., t:t + h],
                      ang[2, ..., t + h:]], dim=-1)


def apply_rope(x, angles):
    """x: (B, S, H, head_dim); angles: (B, S, head_dim/2). NeoX half-split,
    computed in fp32."""
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[..., None, :].float()     # (B,S,1,half)
    sin = torch.sin(angles)[..., None, :].float()
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# dense FFN (SwiGLU / GeGLU / plain MLP)
# ---------------------------------------------------------------------------
def ffn_apply(p, cfg, x):
    from repro_torch.parallel import collectives as col
    act = activation(cfg.act)
    if isinstance(x, col.Shards):
        if cfg.gated_ffn:
            gate, up = col.column_parallel(x, [p["w_gate"], p["w_up"]])
            h = col.local(lambda g, u: act(g) * u, gate, up)
        else:
            (up,) = col.column_parallel(x, [p["w_up"]])
            h = col.local(act, up)
        return col.row_parallel(h, p["w_down"])
    if cfg.gated_ffn:
        h = act(matmul(x, p["w_gate"])) * matmul(x, p["w_up"])
    else:
        h = act(matmul(x, p["w_up"]))
    return matmul(h, p["w_down"])
