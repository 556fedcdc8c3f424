"""AdamW with per-arch state-dtype policies.

Reference: ``repro/optim/adam.py`` (``state_specs``, the moments' mesh
layout, waits for mesh training).  opt_state_dtype "float32" |
"bfloat16" | "int8" (blockwise, ``optim/quant.py``).  The optimizer works
on the reference's parameter tree (``weights.to_reference``: a scanned
segment's leaves stacked on a leading ``n_cycles`` axis), in its leaf
order (``weights.tree_leaves``: dict keys sorted), because two of its
decisions depend on the stacked leaf's shape: weight decay applies to
leaves of ndim >= 2 (so a scanned segment's stacked norm scales are
decayed, an unscanned one's are not), and the int8 layout is
``quantize_aligned`` or the flat blocks, which then run across cycles.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional

import torch

from repro_torch.optim import quant
from repro_torch.weights import tree_leaves, tree_unflatten


@dataclass(frozen=True)
class AdamConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    state_dtype: str = "float32"   # float32 | bfloat16 | int8


class AdamState(NamedTuple):
    step: torch.Tensor   # 0-d int32
    m: List[Any]         # per-leaf moments (tensors or QTensors), leaf order
    v: List[Any]


def _encode(x, dtype: str, *, second_moment: bool):
    if dtype == "float32":
        return x.float()
    if dtype == "bfloat16":
        return x.to(torch.bfloat16)
    if dtype == "int8":
        if quant.aligned_ok(x.shape):
            return quant.quantize_aligned(x, sqrt_encode=second_moment)
        return quant.quantize(x, sqrt_encode=second_moment)
    raise ValueError(dtype)


def _decode(x):
    if isinstance(x, quant.QTensor):
        return quant.dequantize(x)
    return x.float()


def init(params, cfg: AdamConfig) -> AdamState:
    """Zero moments for the reference-shaped parameter tree ``params``."""
    leaves = tree_leaves(params)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    m = [_encode(zeros(p), cfg.state_dtype, second_moment=False)
         for p in leaves]
    v = [_encode(zeros(p), cfg.state_dtype, second_moment=True)
         for p in leaves]
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves[0].device if leaves else None)
    return AdamState(step=step, m=m, v=v)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


def update(grads, state: AdamState, params, *, lr, cfg: AdamConfig):
    """Returns (new_params, new_state, metrics).  ``grads`` and
    ``params`` are reference-shaped trees; ``lr`` a float or a 0-d fp32
    tensor.  ``state`` is consumed: its moments are released leaf by leaf
    as the new ones are made (the reference's jitted step donates its
    state), so that a step holds one set of moments beside the leaf in
    flight; the caller must not read ``state`` again."""
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)

    step = state.step + 1
    # the bias corrections in fp32 tensors, as the reference computes them
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    new_p, new_m, new_v = [], [], []
    for i, (p, g) in enumerate(zip(tree_leaves(params), tree_leaves(grads))):
        # clipped a leaf at a time; the reference's g * scale promotes a
        # bf16 gradient to fp32
        g = g.float() if scale is None else g.float() * scale
        m = cfg.b1 * _decode(state.m[i]) + (1 - cfg.b1) * g
        v = cfg.b2 * _decode(state.v[i]) + (1 - cfg.b2) * torch.square(g)
        del g
        state.m[i] = state.v[i] = None
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        pf = p.float()
        if cfg.weight_decay and p.ndim >= 2:   # no decay on norms/biases
            delta = delta + cfg.weight_decay * pf
        new_p.append((pf - lr * delta).to(p.dtype))
        new_m.append(_encode(m, cfg.state_dtype, second_moment=False))
        new_v.append(_encode(v, cfg.state_dtype, second_moment=True))

    return tree_unflatten(params, new_p), AdamState(step, new_m, new_v), \
        {"grad_norm": gnorm}


# -- schedules --------------------------------------------------------------
def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  min_frac: float = 0.1):
    s = torch.as_tensor(step).float()
    warm = s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(torch.pi * prog))
    return peak_lr * torch.where(s < warmup, warm, cos)
