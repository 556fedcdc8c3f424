"""The reference's products: ``dot_general(x, w, preferred_element_type=
float32)`` cast to the output dtype (``repro/models/modules.py``
``matmul``), for the models and the collectives alike, and the
attention's two-operand ``jnp.einsum(eq, a, b, preferred_element_type=
float32)`` (``einsum32``: ``repro/models/attention.py`` and ``mla.py``).

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

import math

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


def _einsum_indices(eq):
    """(a's, b's and the output's index strings; the batch indices, in
    both operands and the output; a's and b's free indices, each in one
    operand and the output; the contracted indices, in both operands and
    not the output), batch and free in output order, contracted in a's.
    Takes the equations of the attention: two operands, one letter an
    axis, no index summed within one operand, no ellipsis."""
    ins, out = eq.replace(" ", "").split("->")
    ia, ib = ins.split(",")
    batch = [c for c in out if c in ia and c in ib]
    free_a = [c for c in out if c in ia and c not in ib]
    free_b = [c for c in out if c in ib and c not in ia]
    contr = [c for c in ia if c in ib and c not in out]
    for idx, parts in ((ia, batch + free_a + contr),
                       (ib, batch + free_b + contr),
                       (out, batch + free_a + free_b)):
        if not idx.isalpha() or sorted(idx) != sorted(parts):
            raise ValueError(f"einsum32 takes no equation {eq!r}")
    return ia, ib, out, batch, free_a, free_b, contr


def _as_rows(t, idx, batch, free, contr):
    """``t`` (indices ``idx``) as (batch, free, contracted), each group
    flattened: a view where ``t``'s strides allow, else a copy in
    ``t``'s dtype that keeps its last axis innermost (a free last axis
    is copied as (batch, contracted, free) and returned transposed)."""
    size = dict(zip(idx, t.shape))
    dims = [math.prod(size[c] for c in g) for g in (batch, free, contr)]
    if idx[-1] in free:
        order = batch + contr + free
        return t.permute([idx.index(c) for c in order]).reshape(
            dims[0], dims[2], dims[1]).transpose(1, 2)
    order = batch + free + contr
    return t.permute([idx.index(c) for c in order]).reshape(*dims)


def _einsum_dot32(eq, a, b):
    """``eq`` over ``a`` and ``b`` as one batched product with fp32
    accumulation, an fp32 tensor: a as (batch, M, K), b as (batch, N, K)
    read transposed; two bf16 operands on the card take cuBLAS's bf16
    GEMM with an fp32 output, any other pair the promoted operands."""
    ia, ib, out, batch, free_a, free_b, contr = _einsum_indices(eq)
    x = _as_rows(a, ia, batch, free_a, contr)
    w = _as_rows(b, ib, batch, free_b, contr).transpose(1, 2)
    if _tensor_core_route(a, b):
        y = torch.bmm(x, w, out_dtype=torch.float32)
    else:
        y = torch.bmm(x.float(), w.float())
    size = dict(zip(ia, a.shape)) | dict(zip(ib, b.shape))
    grouped = batch + free_a + free_b
    return y.reshape([size[c] for c in grouped]).permute(
        [grouped.index(c) for c in out])


class Einsum32(torch.autograd.Function):
    """``_einsum_dot32(eq, a, b)``, with the reference's transpose rule
    for its gradient: da = einsum(out, b -> a) of the cotangent and b,
    db = einsum(a, out -> b), each fp32-accumulated and cast to its
    operand's dtype.  The cotangent of an fp32 output is fp32, so the
    backward promotes the bf16 operand for its own product, as the
    reference's mixed-dtype ``dot_general`` does; a bf16 one takes the
    tensor cores.  Saves the operands themselves, not their copies."""

    @staticmethod
    def forward(ctx, eq, a, b):
        ctx.eq = eq
        ctx.save_for_backward(a, b)
        return _einsum_dot32(eq, a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ia, ib, out = _einsum_indices(ctx.eq)[:3]
        da = db = None
        if ctx.needs_input_grad[1]:
            da = _einsum_dot32(f"{out},{ib}->{ia}", g, b).to(a.dtype)
        if ctx.needs_input_grad[2]:
            db = _einsum_dot32(f"{ia},{out}->{ib}", a, g).to(b.dtype)
        return None, da, db


def einsum32(eq, a, b):
    """The reference's ``jnp.einsum(eq, a, b, preferred_element_type=
    jnp.float32)``: the exact products of two (possibly bf16) operands
    summed in fp32, an fp32 tensor.  Two bf16 operands on the card (or
    on ``meta``): ``Einsum32``, one tensor-core GEMM; otherwise
    ``torch.einsum`` of the promoted fp32 operands."""
    if _tensor_core_route(a, b):
        return Einsum32.apply(eq, a, b)
    return torch.einsum(eq, a.float(), b.float())
