"""The reference's product: ``dot_general(x, w, preferred_element_type=
float32)`` cast to the output dtype (``repro/models/modules.py``
``matmul``), for the models and the collectives alike.

Two bf16 operands have their exact products summed in fp32 ("MXU
semantics"); a bf16 activation against an fp32 parameter is the promoted
fp32 product.  On a CUDA (or ``meta``) device two bf16 operands go to the
tensor cores (``torch.mm`` / ``torch.bmm`` with an fp32 output, cuBLAS's
bf16 x bf16 -> fp32 GEMM) through ``Product``, whose backward is the
reference's transpose rule and which saves the bf16 operands; ``meta``
takes that route so that the dry run predicts the card.  On the CPU, and
for any other dtype pair, both operands are promoted to fp32 (torch
refuses mixed dtypes), which for two bf16 operands is the same exact
products summed in fp32.
"""
from __future__ import annotations

import torch


def _tensor_core_route(a, b) -> bool:
    """Whether the product of ``a`` and ``b`` runs on the tensor cores:
    both bf16 on a CUDA device, or on ``meta``, where the dry run
    predicts the card."""
    return (a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16
            and a.device.type in ("cuda", "meta"))


def _dot32(a, b):
    """fp32-accumulated product a (..., K) @ b (K, N), or batched
    a (E, C, K) @ b (E, K, N), as an fp32 tensor.  Two bf16 operands on
    the card: cuBLAS's bf16 GEMM with an fp32 output, reading transposed
    operands in place; otherwise the promoted fp32 operands."""
    if not _tensor_core_route(a, b):
        return a.float() @ b.float()
    if b.ndim == 3:
        return torch.bmm(a, b, out_dtype=torch.float32)
    y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
    return y.reshape(*a.shape[:-1], b.shape[-1])


class Product(torch.autograd.Function):
    """``_dot32(x, w)`` cast to ``out_dtype``, with the reference's
    transpose rule for its gradient: dx = g @ w^T and dw = x^T @ g, each
    fp32-accumulated and cast to its operand's dtype.  A bf16 incoming
    gradient takes the tensor cores, an fp32 one (fp32 logits, fp32
    partial sums) the promotion, as the reference's mixed-dtype
    ``dot_general`` does.  Saves the operands themselves."""

    @staticmethod
    def forward(ctx, x, w, out_dtype):
        ctx.save_for_backward(x, w)
        return _dot32(x, w).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _dot32(g, w.transpose(-1, -2)).to(x.dtype)
        if ctx.needs_input_grad[1]:
            if w.ndim == 3:
                dw = _dot32(x.transpose(1, 2), g)
            else:
                dw = _dot32(x.reshape(-1, x.shape[-1]).t(),
                            g.reshape(-1, g.shape[-1]))
            dw = dw.to(w.dtype)
        return dx, dw, None


def matmul(x, w, out_dtype=None):
    """The reference's product: x (..., K) @ w (K, N) (or batched
    (E, C, K) @ (E, K, N)) with fp32 accumulation, cast to ``out_dtype``
    (default ``x.dtype``).  Two bf16 operands on the card: ``Product``;
    otherwise the promoted fp32 operands."""
    out_dtype = out_dtype or x.dtype
    if _tensor_core_route(x, w):
        return Product.apply(x, w, out_dtype)
    return _dot32(x, w).to(out_dtype)
