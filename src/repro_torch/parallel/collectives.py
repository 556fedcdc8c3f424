"""Explicit sequence-parallel collectives (Megatron-SP) between the
positions of a model group.

Reference: ``repro/parallel/collectives.py``.  The reference makes the
two Megatron-SP collectives explicit program text inside ``shard_map``:

  gather_seq(x)        (B, S/tp, D) -> (B, S, D)      all-gather
                       backward: reduce-scatter
  row_parallel(x, w)   partial dot -> (B, S/tp, N)     reduce-scatter
                       backward: all-gather

Here one controller holds one tensor per position of a model group
(:class:`Shards`, on the positions' devices) and every transfer between
two positions is one ``_Send``: a copy to the receiver's device whose
backward sends the gradient back.  An all-gather is the concatenation of
what each position receives, so autograd's transpose of it is the
reduce-scatter of the gradient, and the reverse.  ``WIRE`` counts the
bytes each transfer carries between two different positions (also when
they share a card), by collective, the forward's under its own name and
the backward's under its transpose's.  With a plain tensor (no mesh)
each function is the reference's local fp32-accumulating matmul.

A residual stream that the group cannot split on the sequence (a decode
step's one token, or a length the group does not divide) is whole on
every position (``Shards`` with ``split=None``): the reference's
``_applicable`` then leaves the products to GSPMD, which partitions
them by the parameters' specs; here ``column_parallel`` gathers nothing
and ``row_parallel`` all-reduces its fp32 partial products instead of
reduce-scattering them, as GSPMD's partitioned dot does.
"""
from __future__ import annotations

import contextlib
from collections import Counter
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

# bytes received by every position together, by collective; the caller
# zeroes it (``WIRE.clear()``) and reads it
WIRE: Counter = Counter()


class Event(NamedTuple):
    """One collective as the reference's HLO would hold it: ``op`` its
    HLO name, each of ``group_size`` positions sending ``operand_bytes``
    and receiving ``result_bytes``; a point-to-point transfer is a
    ``collective-permute`` of one sender (``group_size`` 1).  ``site`` is
    its ``WIRE`` key."""
    site: str
    op: str
    group_size: int
    operand_bytes: int
    result_bytes: int


# every collective in call order; the caller clears it with WIRE
EVENTS: List[Event] = []
_HLO = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
        "all_reduce": "all-reduce"}
_in_collective = 0      # > 0 inside a call recorded as one Event


@contextlib.contextmanager
def _collective(site, kind, group_size, operand_bytes, result_bytes):
    """Record one Event for the collective called inside, whose own
    forward sends then record none."""
    global _in_collective
    if group_size > 1:
        EVENTS.append(Event(f"{site} {kind}", _HLO[kind], group_size,
                            operand_bytes, result_bytes))
    _in_collective += 1
    try:
        yield
    finally:
        _in_collective -= 1


def _nbytes(t) -> int:
    return t.numel() * t.element_size()

_TRANSPOSE = {"all_gather": "reduce_scatter", "reduce_scatter": "all_gather",
              "all_reduce": "all_reduce", "broadcast": "reduce",
              "halo": "halo", "all_to_all": "all_to_all",
              "ppermute": "ppermute"}


@dataclass(frozen=True)
class Group:
    """The positions of one model group (indices into ``mesh.devices``)
    and their devices, along mesh axis ``axis``."""
    positions: Tuple[int, ...]
    devices: Tuple[torch.device, ...]
    axis: str = "model"

    @property
    def size(self) -> int:
        return len(self.positions)

    @property
    def root(self) -> torch.device:
        return self.devices[0]


class Shards(list):
    """One tensor per position of ``group``: the blocks of one logical
    activation split on dim ``split`` (None: every position holds all
    of it)."""

    def __init__(self, parts, group: Group, split: Optional[int]):
        super().__init__(parts)
        self.group = group
        self.split = split


class PerPos(tuple):
    """One value per position of a group (a parameter's blocks, a
    constant placed on each device): ``local`` indexes it by position."""


def _count(key: str, x, in_collective: bool = False):
    n = _nbytes(x)
    WIRE[key] += n
    if not in_collective:
        EVENTS.append(Event(key, "collective-permute", 1, n, n))


class _Send(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, device, site, kind):
        ctx.src, ctx.site, ctx.kind = x.device, site, kind
        _count(f"{site} {kind}", x, _in_collective > 0)
        y = x.to(device)
        return y.view_as(y) if y is x else y

    @staticmethod
    def backward(ctx, g):
        _count(f"{ctx.site} {_TRANSPOSE[ctx.kind]}", g)
        return g.to(ctx.src), None, None, None


def send(x, device, site: str, kind: str):
    """``x`` from one position to another's ``device``, its bytes counted
    under ``site`` and ``kind`` (the backward's under the transpose); a
    tensor that needs no gradient is copied without the autograd
    node."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Send.apply(x, device, site, kind)
    _count(f"{site} {kind}", x, _in_collective > 0)
    return x.to(device)


def at(tree, m: int):
    """Position ``m``'s value of a nesting (dicts, lists) whose leaves are
    :class:`PerPos` or :class:`Shards`: a group's parameters
    (``weights.group_view``) become one position's."""
    if isinstance(tree, (Shards, PerPos)):
        return tree[m]
    if isinstance(tree, dict):
        return {k: at(v, m) for k, v in tree.items()}
    if isinstance(tree, list):
        return [at(v, m) for v in tree]
    return tree


def local(fn, *args, index: bool = False):
    """``fn`` on each position of a group: :class:`Shards` and
    :class:`PerPos` arguments give their position's value, and so do the
    leaves of a dict argument (``at``), the rest are passed whole;
    ``index=True`` passes the position's index in the group first.
    Returns Shards (the first Shards argument's layout), or a tuple of
    Shards when ``fn`` returns a tuple."""
    like = next(a for a in args if isinstance(a, Shards))
    outs = [fn(*(((m,) if index else ())
                 + tuple(a[m] if isinstance(a, (Shards, PerPos)) else
                         at(a, m) if isinstance(a, dict) else a
                         for a in args)))
            for m in range(like.group.size)]
    if isinstance(outs[0], tuple):
        return tuple(Shards(o, like.group, like.split) for o in zip(*outs))
    return Shards(outs, like.group, like.split)


def all_gather(xs: Shards, dim: int, site: str) -> Shards:
    """Every position gets the concatenation along ``dim`` of the group's
    blocks, in group order."""
    g = xs.group
    with _collective(site, "all_gather", g.size, _nbytes(xs[0]),
                     sum(_nbytes(x) for x in xs)):
        out = [torch.cat([x if q == p else send(x, g.devices[p], site,
                                                "all_gather")
                          for q, x in enumerate(xs)], dim)
               for p in range(g.size)]
    return Shards(out, g, None)


def reduce_scatter(parts: Sequence[torch.Tensor], group: Group, dim: int,
                   site: str) -> Shards:
    """Position p gets the sum, in group order and in the parts' dtype,
    of every position's p-th 1/size chunk along ``dim``."""
    n = group.size
    out = []
    with _collective(site, "reduce_scatter", n, _nbytes(parts[0]),
                     _nbytes(parts[0].chunk(n, dim)[0])):
        for p in range(n):
            acc = None
            for q, t in enumerate(parts):
                c = t.chunk(n, dim)[p]
                c = c if q == p else send(c, group.devices[p], site,
                                          "reduce_scatter")
                acc = c if acc is None else acc + c
            out.append(acc)
    return Shards(out, group, dim % parts[0].ndim)


def all_reduce_to_root(parts: Sequence[torch.Tensor], group: Group,
                       site: str, op: str = "sum"):
    """The sum (or max) of the group's tensors on the group's root
    device, in group order."""
    acc = None
    for q, t in enumerate(parts):
        t = t if q == 0 else send(t, group.root, site, "all_reduce")
        acc = t if acc is None else (acc + t if op == "sum"
                                     else torch.maximum(acc, t))
    return acc


def all_reduce(parts: Sequence[torch.Tensor], group: Group, site: str,
               op: str = "sum") -> "Shards":
    """The sum (or max) of the group's tensors, in group order, on every
    position: reduced on the root, then sent back to each position."""
    with _collective(site, "all_reduce", group.size, _nbytes(parts[0]),
                     _nbytes(parts[0])):
        acc = all_reduce_to_root(parts, group, site, op)
        return Shards([acc if p == 0 else send(acc, d, site, "all_reduce")
                       for p, d in enumerate(group.devices)], group, None)


def seq_splits(S: int, group: Group) -> bool:
    """Whether a sequence of S positions is split over the group (the
    reference's ``_applicable``: more than one token, and S divisible)."""
    return group.size > 1 and S > 1 and S % group.size == 0


def model_groups(mesh) -> List[Group]:
    """The model groups of a mesh (a :class:`Group` for each index of
    the other axes, in mesh order: the order of the batch's row
    blocks)."""
    if "model" in mesh.axis_names:
        groups = mesh.axis_groups("model")
    else:
        groups = [(p,) for p in range(len(mesh.devices))]
    return [Group(g, tuple(mesh.devices[p] for p in g)) for g in groups]


def full_cols(xs: "Shards", n: int, site: str) -> "Shards":
    """``xs`` with every position holding all ``n`` columns of its last
    dim: gathered when each position holds a column block, as is when
    the weight that made it was whole (a width the group does not
    divide)."""
    if xs[0].shape[-1] == n:
        return Shards(list(xs), xs.group, None if xs.split == xs[0].ndim - 1
                      else xs.split)
    return all_gather(xs, -1, site)


def own_cols(t, m: int, n_blocks: int):
    """Block ``m`` of ``n_blocks`` of the last dim of ``t``."""
    c = t.shape[-1] // n_blocks
    return t[..., m * c:(m + 1) * c]


def shift_in(xs: "Shards", first) -> PerPos:
    """For a sequence-split Shards (B, S/n, D): each position's previous
    row before its block, the last row of the position before it (sent),
    and ``first`` (B, D) before position 0: the halo of a token shift."""
    g = xs.group
    return PerPos(first.to(g.devices[0]) if m == 0 else
                  send(xs[m - 1][:, -1], g.devices[m], "shift", "halo")
                  for m in range(g.size))


def broadcast(x, group: Group, site: str) -> PerPos:
    """The root's ``x`` on every position of the group."""
    return PerPos(x if p == 0 else send(x, d, site, "broadcast")
                  for p, d in enumerate(group.devices))


def _matmul(x, w, out_dtype):
    return (x.float() @ w.float()).to(out_dtype)


def gather_seq(x):
    """(B, S/tp, D) seq-sharded -> full sequence on every position of the
    group; backward a reduce-scatter of the gradient.  No-op for a plain
    tensor (no mesh; a decode step's 1-token sequence is never split)."""
    if not isinstance(x, Shards) or x.split is None:
        return x
    return all_gather(x, x.split, "seq")


def column_parallel(x, ws: Sequence, out_dtype=None) -> List:
    """Fused column-parallel matmuls: one all-gather of the seq-sharded
    input, then each position's dot against its column block of every
    weight.  x Shards (B, S/tp, D); ``ws`` a list of PerPos (D, N_i/tp)
    blocks.  Returns a list of Shards (B, S, N_i/tp) (split on the last
    dim).  A plain ``x`` takes plain weights: the local matmuls."""
    if not isinstance(x, Shards):
        out_dtype = out_dtype or x.dtype
        return [_matmul(x, w, out_dtype) for w in ws]
    out_dtype = out_dtype or x[0].dtype
    xf = gather_seq(x)
    return [Shards([_matmul(xf[m], w[m], out_dtype)
                    for m in range(x.group.size)], x.group, x[0].ndim - 1)
            for w in ws]


def row_parallel(x, w, out_dtype=None):
    """Row-parallel matmul with an explicit reduce-scatter of its output:
    x Shards (B, S, K/tp) (split on K), ``w`` PerPos (K/tp, N) row blocks.
    Each position's partial product is cast to the activation dtype and
    reduced on the wire in it, as the reference's; returns Shards (B,
    S/tp, N) split on the sequence.  A sequence the group does not split
    (``seq_splits``) takes GSPMD's form: the fp32 partial products
    all-reduced, then cast, whole on every position.  An ``x`` whole on
    every position (a split-T decode's attention output) gives each
    position its block of K.  A plain ``x`` takes a plain ``w``: the
    local matmul."""
    if not isinstance(x, Shards):
        return _matmul(x, w, out_dtype or x.dtype)
    out_dtype = out_dtype or x[0].dtype
    g = x.group
    if x[0].shape[-1] != w[0].shape[0]:     # x whole, w in row blocks
        x = Shards([own_cols(t, m, g.size) for m, t in enumerate(x)], g,
                   x[0].ndim - 1)
    if seq_splits(x[0].shape[1], g):
        parts = [_matmul(x[m], w[m], out_dtype) for m in range(g.size)]
        return reduce_scatter(parts, g, 1, "row_parallel")
    parts = [x[m].float() @ w[m].float() for m in range(g.size)]
    return Shards([t.to(out_dtype) for t in all_reduce(
        parts, g, "row_parallel")], g, None)
