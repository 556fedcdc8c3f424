"""Shared model primitives: norms, rotary embeddings, activations, FFN.

Reference: ``repro/models/modules.py``.  JAX's ``dot_general`` of a bf16
activation and an fp32 parameter promotes to fp32 and the reference then
casts back to the activation dtype; torch refuses mixed dtypes, so every
product here writes that promotion and the cast out explicitly.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref as kref

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8}


def dt(name: str) -> torch.dtype:
    return _DTYPES[name]


def matmul(x, w):
    """fp32 product of the promoted operands, cast back to ``x.dtype``."""
    return (x.float() @ w.float()).to(x.dtype)


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
    """Angles (B, S, head_dim/2) for positions (B, S) int."""
    if sections is not None:
        raise NotImplementedError(
            "M-RoPE (qwen2-vl) is not ported yet; see ROADMAP.md")
    inv = rope_freqs(head_dim, theta, positions.device)
    return positions[..., None].float() * inv


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
    act = activation(cfg.act)
    if cfg.gated_ffn:
        h = act(matmul(x, p["w_gate"])) * matmul(x, p["w_up"])
    else:
        h = act(matmul(x, p["w_up"]))
    return matmul(h, p["w_down"])
