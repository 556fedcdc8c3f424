"""Gradient compression with error feedback (distributed-optimization
trick for collective-bound training).

Reference: ``repro/optim/compress.py``.  ``compressed_all_reduce`` is a
quantized reduce-scatter + all-gather over one mesh axis:

  1. add the error-feedback residual to the local gradient,
  2. blockwise-int8 quantize (local absmax scales),
  3. reduce-scatter: each position sends every other position that
     position's chunk as int8 codes and fp32 block scales, and the owner
     sums the dequantized chunks (the mean: divided by the group size),
  4. all-gather the owner's requantized chunk, codes and scales again,
  5. keep (local - dequant(quant)) as the next step's residual.

One controller holds a value per mesh position (on the position's
device), as :mod:`~repro_torch.parallel.lattice` does; the codes and
scales are what crosses between positions, so the bytes each position
receives are ``wire_bytes(..., "int8_ef")``.  As in the reference,
nothing in the train step calls it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.optim import quant
from repro_torch.parallel.sharding import current_env


def _q8(x):
    """Blockwise int8 (BLOCK lanes share one absmax scale)."""
    return quant.quantize_rows(x.reshape(-1, quant.BLOCK))


def _dq8(q, scale):
    return quant.values(q, scale[:, None]).reshape(-1)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def compressed_all_reduce(x, err, axis: str = "data",
                          stats: Optional[Dict[str, int]] = None):
    """Mean-reduce ``x`` over mesh axis ``axis`` with int8 compression
    and error feedback.

    ``x`` and ``err`` are each one tensor, held by every position as the
    reference's replicated input is, or a sequence of tensors, one per
    mesh position (``mesh.devices`` order, each on its device: each
    position's own gradient and residual).  Returns (reduced, new_err) in
    the same form (position 0's for one tensor in).  Off a mesh, or over
    an axis of one position, ``(x, zeros)``.  ``stats``, if given,
    receives the bytes one position receives in each phase."""
    env = current_env()
    single = isinstance(x, torch.Tensor)
    if env is None or axis not in env.mesh.axis_names \
            or env.mesh.shape[axis] == 1:
        return (x, torch.zeros_like(x)) if single else \
            (list(x), [torch.zeros_like(t) for t in x])
    mesh = env.mesh
    devices = mesh.devices
    xs = [x.to(d) for d in devices] if single else list(x)
    es = [err.to(d) for d in devices] if single else list(err)
    n = mesh.shape[axis]
    shape, size = xs[0].shape, xs[0].numel()
    pad = (-size) % (quant.BLOCK * n)
    rows = (size + pad) // quant.BLOCK // n     # block rows of one chunk
    q, s, err_new = [None] * len(xs), [None] * len(xs), [None] * len(xs)
    for p in range(len(xs)):
        g = F.pad(xs[p].reshape(-1).float(), (0, pad)) \
            + F.pad(es[p].reshape(-1).float(), (0, pad))
        q[p], s[p] = _q8(g)
        err_new[p] = (g - _dq8(q[p], s[p]))[:size].reshape(shape)
    moved = {"reduce_scatter": 0, "all_gather": 0}
    out = [None] * len(xs)
    for group in mesh.axis_groups(axis):
        own = {}
        # phase 1: each member's chunk i goes to member i as codes +
        # scales; the owner sums the dequantized chunks in group order
        for i, p in enumerate(group):
            acc = None
            for r in group:
                cq = q[r][i * rows:(i + 1) * rows]
                cs = s[r][i * rows:(i + 1) * rows]
                if r != p:
                    cq, cs = cq.to(devices[p]), cs.to(devices[p])
                    if p == group[0]:
                        moved["reduce_scatter"] += _nbytes(cq, cs)
                d = _dq8(cq, cs)
                acc = d if acc is None else acc + d
            own[p] = _q8(acc / n)          # phase 2: requantize the chunk
        # phase 2: all-gather the owners' codes and scales
        for p in group:
            parts = []
            for r in group:
                cq, cs = own[r]
                if r != p:
                    cq, cs = cq.to(devices[p]), cs.to(devices[p])
                    if p == group[0]:
                        moved["all_gather"] += _nbytes(cq, cs)
                parts.append(_dq8(cq, cs))
            out[p] = torch.cat(parts)[:size].reshape(shape)
    if stats is not None:
        stats.update(moved)
    return (out[0], err_new[0]) if single else (out, err_new)


def wire_bytes(size: int, n: int, scheme: str = "int8_ef") -> float:
    """Per-device wire bytes for one reduction of ``size`` fp32 values."""
    f = (n - 1) / n
    if scheme == "fp32":
        return 2 * f * size * 4
    if scheme == "bf16":
        return 2 * f * size * 2
    if scheme == "int8_ef":
        scales = size / quant.BLOCK * 4
        return 2 * f * (size * 1 + scales)
    raise ValueError(scheme)
