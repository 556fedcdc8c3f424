"""Activation checkpointing (remat) of the train forward's scanned cycles
and the cross-entropy's chunks.

Reference: ``jax.checkpoint`` around the reference's scan body
(``repro/models/lm.py``) and its chunked cross-entropy.  ``checkpoint``
is ``torch.utils.checkpoint(use_reentrant=False)``'s scheme: the
forward builds its graph but keeps none of the tensors it saves for the
backward (a pack hook numbers them), and the first of them the backward
unpacks runs ``fn`` again on the same inputs, keeping what it saves,
until it has saved as many as the forward did (the rest of ``fn``, which
saves nothing, is not run again: so the recompute runs, and sends, what
the reference's recomputed scan body runs).

The one difference is the recompute's guard.  The autograd engine runs
one thread per CUDA device; on a mesh whose positions are separate
cards, two device threads unpack tensors of one checkpointed cycle at
once, and ``torch.utils.checkpoint`` keeps its recompute state for a
backward without a lock, so both recompute and its count of saved
tensors runs past the forward's ("Unexpected state:
target_frame.early_stop is set").  Here a recompute runs under one lock
(the forward code it runs also updates module state: the collectives'
counts, the kernels' launch counts), once per backward, and every
thread reads what it saved.

``span`` is the dry run's marker (``launch/dryrun._Tally``): the cycle
loops call it at each cycle's start, and ``checkpoint`` re-enters the
span it was called in for its recompute and for the backward that
follows.  Off the dry run it does nothing.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Callable

import torch

_RECOMPUTE = threading.Lock()
_SPANS = None        # the dry run's tally while it runs, else None


def span(seg: int, cycle: int, n_cycles: int):
    """Cycle ``cycle`` of segment ``seg``'s ``n_cycles`` starts (``seg``
    past the last segment: the cycles are done)."""
    if _SPANS is not None:
        _SPANS.enter(seg, cycle, n_cycles)


@contextlib.contextmanager
def spans(tally):
    """``span`` and the checkpoints report to ``tally`` inside."""
    global _SPANS
    _SPANS = tally
    try:
        yield tally
    finally:
        _SPANS = None


class _Stop(Exception):
    """Raised by the recompute's pack hook once it has saved all."""


class _Holder:
    """What the forward's pack hook keeps of a saved tensor: its number."""
    __slots__ = ("i", "__weakref__")

    def __init__(self, i: int):
        self.i = i


class _Frame:
    """One checkpointed call: ``fn`` and its inputs, the forward's
    holders (weakly: a node the backward has run drops its own), and
    each backward's recomputed tensors by number."""

    def __init__(self, fn, args):
        self.fn, self.args = fn, args
        self.span = None if _SPANS is None else _SPANS.region
        self.holders = []
        self.recomputed = {}           # graph task id -> {number: tensor}

    def pack(self, x):
        h = _Holder(len(self.holders))
        self.holders.append(weakref.ref(h))
        return h

    def unpack(self, h):
        gid = torch._C._current_graph_task_id()
        with _RECOMPUTE:
            if gid not in self.recomputed:
                self.recomputed[gid] = self._recompute()
            return self.recomputed[gid].pop(h.i)

    def _recompute(self):
        out, n = {}, [0]

        def pack(x):
            i = n[0]
            n[0] += 1
            if i >= len(self.holders):
                raise RuntimeError(
                    "remat: the recompute saves more tensors than the "
                    f"forward's {len(self.holders)}")
            if self.holders[i]() is not None:
                out[i] = x.detach() if x.requires_grad else x
            if n[0] == len(self.holders):
                raise _Stop
            return None

        def unpack(_):
            raise RuntimeError("remat: a recompute's tensor was unpacked")
        if self.span is not None:
            _SPANS.phase(self.span, "recompute")
        if self.holders:
            try:
                with torch.enable_grad(), \
                        torch.autograd.graph.saved_tensors_hooks(pack, unpack):
                    self.fn(*self.args)
            except _Stop:
                pass
        if n[0] != len(self.holders):
            raise RuntimeError(f"remat: the recompute saved {n[0]} tensors, "
                               f"the forward {len(self.holders)}")
        if self.span is not None:
            _SPANS.phase(self.span, "backward")
        return out


def checkpoint(fn: Callable[..., Any], *args):
    """``fn(*args)`` without the tensors it saves for the backward kept:
    the backward recomputes them (``jax.checkpoint``).  ``args`` may be
    any values; ``fn`` must compute the same on them again (no randomness,
    no input changed in place)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    frame = _Frame(fn, args)
    with torch.autograd.graph.saved_tensors_hooks(frame.pack, frame.unpack):
        return fn(*args)
