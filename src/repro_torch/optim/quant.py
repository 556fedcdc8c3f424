"""Blockwise int8 quantization of optimizer state.

Reference: ``repro/optim/quant.py``.  Blocks of 256 along the flattened
tensor (``quantize``, block count padded to a multiple of 512) or of 128
along the last dim (``quantize_aligned``) share one fp32 absmax scale;
second moments are stored as their square root to tame their range.
``torch.round`` rounds half to even as ``jnp.round`` does, and the
divide-then-multiply order is the reference's, so the codes are equal
for equal inputs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

BLOCK = 256
# block count padded to a multiple of this (the reference shards the flat
# (n_blocks, BLOCK) layout over every mesh axis of a 512-chip mesh)
MAX_SHARDS = 512
BLOCK_ALIGNED = 128   # last-dim block of the param-shaped layout


def _pad_blocks(n_blocks: int) -> int:
    return -(-n_blocks // MAX_SHARDS) * MAX_SHARDS


class QTensor(NamedTuple):
    # mode "flat": q (n_blocks, BLOCK) int8, scale (n_blocks,)
    # mode "aligned": q param-shaped int8, scale (..., last/BLOCK_ALIGNED)
    q: torch.Tensor
    scale: torch.Tensor
    shape: tuple          # original shape
    sqrt_encoded: bool
    mode: str = "flat"


def flatten_blocks(x) -> torch.Tensor:
    """(any shape) -> fp32 (n_blocks_padded, BLOCK)."""
    xf = x.float().reshape(-1)
    n_blocks = _pad_blocks(-(-xf.numel() // BLOCK))
    pad = n_blocks * BLOCK - xf.numel()
    if pad:
        xf = F.pad(xf, (0, pad))
    return xf.reshape(n_blocks, BLOCK)


def unflatten_blocks(xb, shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return xb.float().reshape(-1)[:n].reshape(shape)


def _encode_input(x, sqrt_encode):
    xf = x.float()
    if not sqrt_encode:
        return xf
    # a correctly rounded fp32 sqrt, as jnp.sqrt's (and CUDA's sqrtf):
    # torch's vectorised CPU sqrt is off by one unit now and then, which
    # would move a block's scale; the fp64 root rounds to the right float
    return torch.sqrt(torch.clamp(xf, min=0.0).double()).float()


def codes(x, scale) -> torch.Tensor:
    """The int8 codes of fp32 ``x`` against its absmax ``scale``
    (broadcast to x's shape)."""
    return torch.round(x / torch.clamp(scale, min=1e-12) * 127.0).to(
        torch.int8)


def values(q, scale) -> torch.Tensor:
    """The fp32 values of int8 codes ``q`` against ``scale`` (broadcast
    to q's shape)."""
    return q.float() * (scale / 127.0)


def quantize_rows(xb):
    """fp32 rows of BLOCK -> (int8 codes, one absmax scale a row): the
    flat layout's blocks."""
    scale = xb.abs().amax(1)
    return codes(xb, scale[:, None]), scale


def quantize(x, *, sqrt_encode: bool = False) -> QTensor:
    q, scale = quantize_rows(flatten_blocks(_encode_input(x, sqrt_encode)))
    return QTensor(q, scale, tuple(x.shape), sqrt_encode, "flat")


def aligned_ok(shape) -> bool:
    return len(shape) >= 2 and shape[-1] % BLOCK_ALIGNED == 0


def quantize_aligned(x, *, sqrt_encode: bool = False) -> QTensor:
    """Param-shaped int8 with one scale per last-dim block of 128."""
    shape = tuple(x.shape)
    nb = shape[-1] // BLOCK_ALIGNED
    xb = _encode_input(x, sqrt_encode).reshape(*shape[:-1], nb,
                                               BLOCK_ALIGNED)
    scale = xb.abs().amax(-1)                               # (..., nb)
    return QTensor(codes(xb, scale[..., None]).reshape(shape), scale, shape,
                   sqrt_encode, "aligned")


def dequantize(qt: QTensor) -> torch.Tensor:
    if qt.mode == "aligned":
        nb = qt.shape[-1] // BLOCK_ALIGNED
        xb = values(qt.q.reshape(*qt.shape[:-1], nb, BLOCK_ALIGNED),
                    qt.scale[..., None])
        xf = xb.reshape(qt.shape)
    else:
        xf = unflatten_blocks(values(qt.q, qt.scale[:, None]), qt.shape)
    return decode_output(xf, qt.sqrt_encoded)


def decode_output(xf, sqrt_encoded: bool) -> torch.Tensor:
    """Undo ``_encode_input``'s square root."""
    return torch.square(xf) if sqrt_encoded else xf
