"""Dry run: every (arch x shape x mesh) cell's step once on a meta mesh.

Reference: ``repro/launch/dryrun.py``, which lowers and compiles each
runnable cell's step for the 16x16 and 2x16x16 production meshes against
ShapeDtypeStructs and reads XLA's memory and cost analyses and the HLO's
collectives.  The port has no compiler to ask: it runs the cell's own
step (``steps.make_train_step`` / ``make_prefill_step`` /
``make_serve_step`` on the mesh) once on a mesh of ``meta`` positions
(shapes, no storage, no kernel launched: a kernel wrapper's meta branch
returns its outputs' shapes and counts ``dry_calls``), under

* ``FlopCounterMode``: the FLOPs of the matmuls, convolutions and
  attention products PyTorch runs, the counterpart of XLA's
  ``cost_analysis()["flops"]``; like it, the kernels' work (a Pallas
  custom call there) is left out;
* a tally of the live meta storages (``_Tally``): the arguments' bytes
  and the peak of everything alive at once in each window of the run.
  Every position is the one ``meta`` device, so a send between two
  positions would hand over the sender's storage; instead it makes a
  new one (``collectives._moved``), as a send between two cards makes a
  copy, and the tally counts each received block while it lives
  (``dry_step(received=False)`` leaves them out: sends between
  positions that share a card are views);
* ``collectives.WIRE`` and ``EVENTS``: the bytes of every collective by
  site, and the reference's ring-model summary (``analysis/wire.py``).

The record (``run_cell``) keeps the reference's keys: ``memory``
(per position: ``argument_size_in_bytes``, exact from the Sharded
placement; ``temp_size_in_bytes``, the most a position holds at once
beyond its arguments, its outputs included (XLA counts them apart:
arguments + temp is what a device must hold); ``output_size_in_bytes``
and ``alias_size_in_bytes`` (outputs that are arguments updated in
place); XLA's ``generated_code_size`` has no counterpart),
``cost_analysis`` (``flops``), ``collectives``, the roofline on H100
constants (``analysis/roofline.py``), ``kernel_dry_calls``,
``wire_bytes_by_site`` and ``lower_s``, the seconds the cell took.

The controller runs a mesh step's data groups in turn, each on its
model group's positions, so a position's temp is read from windows of
the run (``temp_by_phase`` in ``memory``):

* **the data groups' window**: the first group's bytes above the
  arguments at its peak, less what lies at positions outside it (the
  gradient blocks of leaves stored over the data axes, which each MoE
  layer's gather in its backward sends there: ``_Tally.place``),
  shared over its positions, plus, in a train step, a position's blocks
  of those gradients (the earlier groups' share, which a later group's
  positions already hold);
* **the optimizer's window** (a train step): every position updates its
  own blocks alike, so the mesh's bytes above the arguments at its peak
  over the positions.

A run of every group at full depth (``symmetry=False``) also gives
``peak_bytes_mesh``, what one device holding every position needs.

Two exact symmetries keep a production cell's host time down
(``symmetry`` in the record says which were used):

* **data groups**: every data group has the same shapes, so the run
  runs the first (``groups_run=1`` of the step makers and
  ``steps.mesh_loss_and_grads``) and counts it once for each group;
* **scanned cycles**: every cycle of a scanned segment does the same
  work, so a cell whose longest segment has C > 3 cycles runs the first
  group's window at two smaller counts (2 and 3 unless ZeRO-1 would
  place a moment otherwise there: ``cycle_cut``) and extrapolates every
  count and the window's bytes linearly to C (the reference multiplies
  a while body by its ``known_trip_count``); a train step's optimizer
  runs once at full depth on zero gradients, its cost not shrinking
  with the cycles (every leaf of a segment is one stacked tensor).

The counts (FLOPs, wire by site, the event summary, the kernels' dry
calls) are sums over the step's calls, so they come out exact, as do
the arguments and the outputs.  So is the window's peak: it is the
largest of the live bytes at every storage birth, and the tally keeps
each of them (``_Tally.points``) under its span (before the cut
segment, its first cycle, its last, after it; in the forward, a
checkpoint's recompute or the backward after it: ``remat.span``, which
the cycle loops call) and its ordinal in the span.  A point's bytes are
affine in its cycle and in the depth, so each is carried along its
line from the two cut depths to C, and the largest is the peak; a
middle cycle's points lie on or below the first's and the last's.  The
two depths' points must line up, or the run raises.  A line through
the two depths' peaks alone would fall below the true peak where
another point sets it at C (the peak is convex in the depth);
``tests/test_torch_dryrun_sym.py`` holds such a case, and
``scripts/dryrun_full_depth.py`` holds production cells against their
full-depth run.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k \\
      --mesh single
  python -m repro_torch.launch.dryrun --all --out results/torch_dryrun.json
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
import weakref
from collections import Counter
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import steps as steps_mod
from repro_torch import weights
from repro_torch.analysis import roofline as roofline_mod
from repro_torch.analysis import wire as wire_mod
from repro_torch.configs import SHAPES, cell_is_runnable, get_config
from repro_torch.configs import runnable_cells
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm, remat
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import Sharded, _axes, use_sharding

CUT_CYCLES = (2, 3)     # the fewest cycles the longest segment runs at


# ---------------------------------------------------------------------------
# the tally of live meta storages
# ---------------------------------------------------------------------------
def _tensors(tree):
    """Every tensor of a nesting of dicts, lists, tuples, NamedTuples and
    Sharded leaves."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Sharded):
        yield from (t for t in tree.shards if t is not None)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def position_bytes(tree, p: int) -> int:
    """Bytes position ``p`` holds of ``tree``: its block of each Sharded
    leaf, and every plain tensor whole (replicated)."""
    if isinstance(tree, Sharded):
        t = tree.shards[p]
        return 0 if t is None else t.numel() * t.element_size()
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(position_bytes(v, p) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(position_bytes(v, p) for v in tree)
    return 0


_DTYPES = {}     # (op, argument types) -> the output dtype, or None


def _pointwise(func, args, kwargs):
    """A functional pointwise op on contiguous meta tensors: its output,
    contiguous, of the broadcast shape and of the dtype the op gives the
    same argument types (asked once, on 1-element tensors), without
    PyTorch's Python reference implementation; None for any other op."""
    if torch.Tag.pointwise not in func.tags or func._schema.is_mutable:
        return None
    flat = list(args) + list(kwargs.values())
    ts = [a for a in flat if isinstance(a, torch.Tensor)]
    if not ts or not all(t.device.type == "meta" and t.is_contiguous()
                         for t in ts):
        return None
    key = (func, tuple(kwargs), tuple(
        (a.dtype, a.dim() == 0) if isinstance(a, torch.Tensor) else
        a if isinstance(a, (str, bool, torch.dtype, type(None))) else
        type(a) for a in flat))
    if key not in _DTYPES:
        def small(a):
            if isinstance(a, torch.Tensor):
                return torch.empty((1,) * a.dim(), dtype=a.dtype,
                                   device="meta")
            if isinstance(a, (list, tuple)):
                return None
            return a
        try:
            o = func(*[small(a) for a in args],
                     **{k: small(v) for k, v in kwargs.items()})
            _DTYPES[key] = o.dtype if isinstance(o, torch.Tensor) else None
        except Exception:   # noqa: an argument the 1-element call refuses
            _DTYPES[key] = None
    dtype = _DTYPES[key]
    if dtype is None:
        return None
    return torch.empty(torch.broadcast_shapes(*[t.shape for t in ts]),
                       dtype=dtype, device="meta")


class _Tally(TorchDispatchMode):
    """Bytes of the live storages: each new storage an op returns is
    added, and taken off when it is freed (a weak reference to it: a
    storage's Python object lives as long as the storage).  Each storage
    is numbered as it is born.  A storage ``place``d at a mesh position
    in ``away`` (positions outside the data groups run), and every
    storage an op makes from such storages at one position, lies there:
    ``peak`` is the window's largest ``live`` less those bytes, and
    ``peak_at`` the number of the last storage born by then (``window``
    starts another); ``top`` the largest ``live`` of every window.

    ``points`` keeps those bytes at every birth of the window, by its
    span and its ordinal in the span: a span is the cycle loops' region
    (``remat.span``: before the segment ``cut_seg``, its first cycle,
    its last, a middle one, after it) and the phase (the forward, a
    checkpoint's recompute, the backward after it); the ``"start"``
    point is the window's start."""

    def __init__(self, cut_seg: Optional[int] = None):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.peak_at = 0
        self.top = 0
        self._n = 0
        self._born = {}
        self.away = frozenset()
        self._away = {}         # storage -> (position, bytes), if away
        self._live_away = 0
        self._below = 0         # the window's peak before the last was set
        self.cut_seg = cut_seg
        self.points = {}
        self._point = {}        # storage -> its point, while it lives
        self.region = "before"
        self._span = ("before", "forward")
        self._ordinal = Counter()

    def enter(self, seg: int, cycle: int, n_cycles: int):
        """``remat.span``: a forward enters cycle ``cycle`` of segment
        ``seg``."""
        cut = -1 if self.cut_seg is None else self.cut_seg
        self.region = "before" if seg < cut else "after" if seg > cut \
            else "first" if cycle == 0 else "last" \
            if cycle == n_cycles - 1 else "middle"
        self._span = (self.region, "forward")

    def phase(self, region: str, phase: str):
        """A checkpoint made in ``region`` recomputes, or its backward
        runs."""
        self._span = (region, phase)

    def track(self, tree):
        """Count the storages of ``tree`` (a step's arguments)."""
        for t in _tensors(tree):
            self._add(t.untyped_storage())

    def window(self) -> int:
        """Start a window at the live bytes, which it returns."""
        self.peak = self._below = self.live - self._live_away
        self.peak_at = self._n
        self.points = {"start": self.peak}
        self._point.clear()
        self._ordinal.clear()
        self.region, self._span = "before", ("before", "forward")
        return self.live

    def place(self, t, pos: int):
        """``t``, just born, lies at mesh position ``pos``
        (``collectives.placing``: a gathered block's gradient sent back
        to the position that stores it)."""
        key = t.untyped_storage()._cdata
        if pos not in self.away or key not in self._born or key in self._away:
            return
        n = t.untyped_storage().nbytes()
        self._away[key] = (pos, n)
        self._live_away += n
        if key in self._point:
            self.points[self._point[key]] -= n
        if self._born[key] == self.peak_at:       # it set the peak
            self.peak = max(self._below, self.peak - n)

    def _add(self, s, made=None, away=None):
        key = s._cdata
        if key in self._born:
            return
        n = s.nbytes()
        self._n += 1
        self._born[key] = self._n
        self.live += n
        if away is not None:
            self._away[key] = (away, n)
            self._live_away += n
        here = self.live - self._live_away
        self._ordinal[self._span] += 1
        if self._span[0] != "middle":
            point = self._span + (self._ordinal[self._span],)
            self.points[point] = here
            self._point[key] = point
        if here > self.peak:
            self._below, self.peak, self.peak_at = self.peak, here, self._n
        self.top = max(self.top, self.live)
        weakref.finalize(s, self._free, key, n)

    def _free(self, key, n):
        if self._born.pop(key, None) is not None:
            self.live -= n
        self._point.pop(key, None)
        self._live_away -= self._away.pop(key, (None, 0))[1]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = _pointwise(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        ins = None
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            s = t.untyped_storage()
            if s._cdata in self._born:
                continue
            if ins is None:       # an output that is an input's view
                ins = {x.untyped_storage()._cdata
                       for x in tree_leaves((args, kwargs))
                       if isinstance(x, torch.Tensor)}
                at = {self._away[k][0] for k in ins if k in self._away}
                at = at.pop() if len(at) == 1 else None
            if s._cdata not in ins:
                self._add(s, (func, t), at)
        return out


class ByOp(_Tally):
    """The tally, which also notes what made each storage: (op, shape,
    dtype), "argument" for the step's arguments.  When the storage
    numbered ``target`` is born it sums the live ones by what made them
    (``at_target``: (live bytes, Counter)); ``made`` counts the bytes
    born by what made them."""

    def __init__(self, target: Optional[int] = None):
        super().__init__()
        self.target, self.at_target = target, None
        self.what = {}
        self.made = Counter()

    def _add(self, s, made=None, away=None):
        before = self._n
        super()._add(s, made, away)
        if self._n == before:
            return
        func, t = made if made is not None else (None, None)
        w = "argument" if func is None else (str(func), tuple(t.shape),
                                             str(t.dtype))
        self.what[s._cdata] = (w, s.nbytes())
        self.made[w] += s.nbytes()
        if self._n == self.target:
            live = Counter()
            for key, (w, n) in self.what.items():
                if key in self._born:
                    live[w] += n
            self.at_target = (self.live, live)


def peak_by_op(cfg, shape, mesh, rules=None):
    """The first data group's window of ``cfg``'s step (``_run``, no
    optimizer) twice: the first run finds the storage born at the
    window's peak, the second lists what is alive when it is born.
    Returns (the first run's record, its ByOp, (live bytes, Counter of
    live bytes by what made them))."""
    first = ByOp()
    run = _run(cfg, shape, mesh, rules, 1, optimizer=False, tally=first)
    second = ByOp(target=first.peak_at)
    _run(cfg, shape, mesh, rules, 1, optimizer=False, tally=second)
    return run, first, second.at_target


# ---------------------------------------------------------------------------
# one execution of a step: the data groups' window and the optimizer's
# ---------------------------------------------------------------------------
class _Counts:
    """Additive counts of a window: FLOPs, wire bytes by site, the events
    (each with a weight) and the kernels' dry calls; ``lin`` combines
    windows and runs."""

    def __init__(self, flops=0.0, wire=None, events=(), dry=None):
        self.flops = float(flops)
        self.wire = Counter(wire or {})
        self.events = list(events)
        self.dry = Counter(dry or {})

    def lin(self, other: "_Counts", a: float, b: float) -> "_Counts":
        """a * self + b * other, the events as weighted lists."""
        out = _Counts(a * self.flops + b * other.flops)
        for k in set(self.wire) | set(other.wire):
            out.wire[k] = a * self.wire[k] + b * other.wire[k]
        for k in set(self.dry) | set(other.dry):
            out.dry[k] = a * self.dry[k] + b * other.dry[k]
        out.events = [(w * a, e) for w, e in self.events] + \
            [(w * b, e) for w, e in other.events]
        return out


def _snap(fc):
    return dict(flops=fc.get_total_flops(), wire=Counter(col.WIRE),
                events=len(col.EVENTS), dry=ops.dry_calls())


def _between(a, b) -> _Counts:
    return _Counts(b["flops"] - a["flops"],
                   {k: v - a["wire"].get(k, 0) for k, v in b["wire"].items()},
                   [(1.0, e) for e in col.EVENTS[a["events"]:b["events"]]],
                   {k: v - a["dry"][k] for k, v in b["dry"].items()})


def _build(cfg, shape, mesh, env):
    """(the step's arguments, their bytes at position 0)."""
    adam_cfg = steps_mod.adam_config_for(cfg)
    params, opt = steps_mod.make_state_structs(cfg, adam_cfg, mesh, env)
    bspecs = steps_mod.batch_specs(cfg, env)
    if shape.kind == "train":
        batch = steps_mod.make_batch_struct(cfg, shape, mesh, env)
        args = (params, opt, batch)
        placed = (params, opt, steps_mod.with_shardings(batch, bspecs, mesh))
    elif shape.kind == "prefill":
        del opt
        batch = steps_mod.make_batch_struct(cfg, shape, mesh, env)
        args = (params, batch["tokens"])
        placed = (params, steps_mod.with_shardings(
            batch["tokens"], bspecs["tokens"], mesh))
    else:
        del opt
        tok, caches, pos = steps_mod.make_decode_structs(cfg, shape, mesh,
                                                         env)
        args = (params, tok, caches, pos)
        # pos: the reference's int32 scalar argument
        placed = (params, steps_mod.with_shardings(tok, bspecs["labels"]
                                                   + (None,) * (tok.ndim - 2),
                                                   mesh), caches,
                  torch.empty((), dtype=torch.int32, device="meta"))
    return args, position_bytes(placed, 0)


def _over_data(leaf) -> bool:
    """A leaf stored over the data axes (the MoE's "fsdp"): every data
    group's backward reaches each of its blocks."""
    return any(a != "model" for e in leaf.spec for a in _axes(e))


def _zero_fill(grads, params):
    """``grads`` with a zero block at every position none of the run
    groups reached (all of them where ``grads`` is None): the gradients
    of the groups not run, as the optimizer finds them."""
    leaves = weights.tree_leaves(params)
    if grads is None:
        return weights.tree_unflatten(params, [Sharded(
            [torch.zeros_like(t) for t in l.shards], l.spec, l.shape,
            l.mesh, partial=True) for l in leaves])
    for g, l in zip(weights.tree_leaves(grads), leaves):
        g.shards = [torch.zeros_like(l.shards[p]) if t is None else t
                    for p, t in enumerate(g.shards)]
    return grads


def _loss_metrics(cfg, params, mesh) -> dict:
    """Fp32 scalars in place of ``mesh_loss_and_grads``'s metrics (the
    loss is the cross-entropy's tensor unless an MoE or MTP term adds
    to it)."""
    zero = lambda: torch.zeros((), device=mesh.devices[0])     # noqa
    out = {"ce": zero(), "moe_aux": zero()}
    if cfg.mtp_depth and "mtp" in params:
        out["mtp_ce"] = zero()
    out["loss"] = zero() if cfg.moe is not None or "mtp_ce" in out \
        else out["ce"]
    return out


def _bmm_flops(a_shape, b_shape, *args, out_shape=None, **kwargs):
    """FLOPs of ``aten.bmm``, either overload: the tensor cores' bf16
    product takes a third positional argument (``out_dtype``), which
    torch's own formula mistakes for its ``out_shape``."""
    b, m, k = a_shape
    return 2 * b * m * k * b_shape[2]


def _run(cfg, shape, mesh, rules, groups_run: Optional[int],
         optimizer: bool = True, tally: Optional[_Tally] = None,
         cut_seg: Optional[int] = None) -> dict:
    """Run the cell's step once on the meta mesh, ``groups_run`` of its
    data groups (None: all; 0, a train step only: none, every gradient
    zero).  A train step is its two halves (``make_train_step``'s mesh
    path): ``mesh_loss_and_grads``, the data groups' window, then, with
    ``optimizer``, ``apply_update`` (the positions no run group reached
    given zero gradients), the optimizer's window; a prefill or decode
    step is one data groups' window.  Each window's counts and bytes
    above the arguments at its peak, less the bytes then at positions
    outside the run groups (the gradient blocks of leaves stored over
    the data axes, which each MoE layer's gather sends back there:
    ``collectives.placing``).  With ``cut_seg``, the data groups'
    window's bytes at every point (``_Tally.points``) by the spans of
    that segment."""
    groups = col.model_groups(mesh)
    run_pos = {p for g in groups[:groups_run] for p in g.positions}
    train = shape.kind == "train"
    res = {}
    with use_sharding(mesh, rules) as env:
        args, res["arg_pos"] = _build(cfg, shape, mesh, env)
        col.WIRE.clear()
        col.EVENTS.clear()
        ops.reset_dry_calls()
        tally = _Tally(cut_seg) if tally is None else tally
        tally.track(args)
        tally.away = frozenset(range(len(mesh.devices))) - run_pos
        res["arg_mesh"] = arg_mesh = tally.live
        res["od_pos"] = 0
        out = None
        with FlopCounterMode(display=False,
                             custom_mapping={torch.ops.aten.bmm: _bmm_flops}
                             ) as fc, tally, \
                col.placing(tally.place), remat.spans(tally):
            s0 = _snap(fc)
            tally.window()
            if train:
                params, opt, batch = args
                res["od_pos"] = sum(
                    l.shards[0].numel() * l.shards[0].element_size()
                    for l in weights.tree_leaves(params) if _over_data(l))
                steps_mod.check_mesh(cfg, mesh, env)
                if groups_run == 0:
                    metrics, grads = _loss_metrics(cfg, params, mesh), None
                else:
                    metrics, grads = steps_mod.mesh_loss_and_grads(
                        cfg, params, batch, groups_run)
            elif shape.kind == "prefill":
                out = steps_mod.make_prefill_step(
                    cfg, max_len=shape.seq_len, mesh=mesh,
                    groups_run=groups_run)(*args)
            else:
                out = steps_mod.make_serve_step(
                    cfg, mesh=mesh, groups_run=groups_run)(*args)
            s1 = _snap(fc)
            if groups_run != 0:
                res["groups"] = (_between(s0, s1), tally.peak - arg_mesh)
                res["points"] = {k: v - arg_mesh
                                 for k, v in tally.points.items()}
            if train and optimizer:
                grads = _zero_fill(grads, params)
                tally.window()
                out = steps_mod.apply_update(
                    params, opt, grads, metrics,
                    steps_mod.adam_config_for(cfg))
                res["opt"] = (_between(s1, _snap(fc)), tally.peak - arg_mesh)
            res["peak_mesh"] = tally.top
        in_args = {t.untyped_storage()._cdata for t in _tensors(args)}
        res["alias"] = sum(t.numel() * t.element_size() for t in _tensors(
            _position_tree(out, 0)) if t.untyped_storage()._cdata in in_args)
        # a prefill's or decode step's logits: the run groups' rows
        scale = len(groups) / len(groups[:groups_run]) \
            if not train and env.resolve("batch") is not None else 1.0
        res["out_pos"] = _output_bytes(out, scale)
        del out, args
    return res


def _output_bytes(out, scale: float) -> float:
    """Position 0's bytes of a step's outputs: its block of each Sharded
    leaf, and every plain tensor (the data groups' rows gathered on the
    mesh's first device) ``scale`` times: the groups that ran gave
    1/scale of its rows."""
    if isinstance(out, Sharded):
        return position_bytes(out, 0)
    if isinstance(out, torch.Tensor):
        return scale * out.numel() * out.element_size()
    if isinstance(out, dict):
        return sum(_output_bytes(v, scale) for v in out.values())
    if isinstance(out, (list, tuple)):
        return sum(_output_bytes(v, scale) for v in out)
    return 0


def _position_tree(tree, p):
    """Position ``p``'s tensors of a nesting of Sharded and plain
    tensors."""
    if isinstance(tree, Sharded):
        return tree.shards[p]
    if isinstance(tree, dict):
        return {k: _position_tree(v, p) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_position_tree(v, p) for v in tree]
    return tree


def _spec_signature(cfg, mesh, rules):
    """Every parameter's and moment's spec on ``mesh`` (an int8 moment's
    without its shape)."""
    from repro_torch.optim import adam
    from repro_torch.parallel.sharding import param_specs
    from repro_torch.weights import tree_leaves_specs
    with use_sharding(mesh, rules):
        ref = steps_mod.abstract_params(cfg)
        pspec = param_specs(ref)
        st = adam.state_specs(ref, steps_mod.adam_config_for(cfg), pspec)
    mom = [m._replace(shape=None) if hasattr(m, "_fields") else m
           for m in st.m + st.v]
    return tree_leaves_specs(pspec), mom


def cycle_cut(cfg, mesh, rules=None):
    """(the segment the dry run cuts, its cycles C, the two cycle counts
    it runs, ``cut(c)``: ``cfg`` with that segment at c cycles) for a
    config whose longest scanned segment has more than 3 cycles, else
    None.  The two counts are the least below C at which every parameter
    and moment keeps its full-depth spec (ZeRO-1 can shard a stacked
    leaf's cycle dim, by its size), else the cut is None."""
    segs = lm.make_segments(cfg)
    i = max(range(len(segs)),
            key=lambda j: segs[j].n_cycles * len(segs[j].kinds))
    seg = segs[i]
    if not seg.scanned or seg.n_cycles <= CUT_CYCLES[-1]:
        return None

    def cut(c):
        new = cfg.replace(n_layers=cfg.n_layers
                          - (seg.n_cycles - c) * len(seg.kinds))
        got = [s[:4] for s in lm.make_segments(new)]
        want = [s._replace(n_cycles=c)[:4] if j == i else s[:4]
                for j, s in enumerate(segs)]
        if got != want:
            raise ValueError(f"{cfg.name}: cutting segment {i} to {c} "
                             f"cycles gives {got}")
        return new
    full = _spec_signature(cfg, mesh, rules)
    same = [c for c in range(CUT_CYCLES[0], seg.n_cycles)
            if _spec_signature(cut(c), mesh, rules) == full][:2]
    if len(same) < 2:
        return None
    return i, seg.n_cycles, tuple(same), cut


def _summary(events, n_positions):
    """``wire.collective_summary`` of (weight, event) pairs."""
    return wire_mod.collective_summary([e for _, e in events], n_positions,
                                       [w for w, _ in events])


def dry_step(cfg, shape, mesh, rules=None, symmetry: bool = True,
             received: bool = True, cut: bool = True) -> dict:
    """The dry run of ``cfg``'s step for ``shape`` on ``mesh`` (a meta
    mesh): the record's counts and memory, with the symmetries of the
    module docstring where ``symmetry`` and the cell allow (``cut=False``
    keeps the data groups' and runs every cycle); without them, also
    ``peak_bytes_mesh``.  With ``received`` (the default) a
    send between two positions makes a new storage, as between two
    cards; without, it is a view, as between positions sharing one card
    (``memory["received_blocks"]`` says which)."""
    with (contextlib.nullcontext() if received else col.sends_as_views()):
        rec = _dry_step(cfg, shape, mesh, rules, symmetry, cut)
    rec["memory"]["received_blocks"] = received
    return rec


def _extrapolated_peak(p1: dict, p2: dict, num: int, den: int) -> int:
    """The largest of the points' bytes, each carried along the line
    through its bytes at the two cut depths to the full one (``num /
    den`` of the way past the first per unit between them).  Every point
    of a middle cycle lies on or below those of the first and the last
    cycle (its bytes are affine in its cycle), so these are all."""
    if p1.keys() != p2.keys():
        odd = sorted(set(p1) ^ set(p2), key=str)[:4]
        raise ValueError(f"dry run: the cut depths' points differ "
                         f"({len(p1)} against {len(p2)}: {odd})")
    return max(round(p1[k] + num * (p2[k] - p1[k]) / den) for k in p1)


def _dry_step(cfg, shape, mesh, rules, symmetry, cut=True):
    n_pos = len(mesh.devices)
    groups = col.model_groups(mesh)
    n_groups, gsize = len(groups), groups[0].size
    train = shape.kind == "train"
    cut = cycle_cut(cfg, mesh, rules) if symmetry and cut else None
    cycles = None
    if cut is None:
        # counts: the first group counted for each (or every group run);
        # the groups' window of the first group alone gives the temps
        run = _run(cfg, shape, mesh, rules, 1 if symmetry else None)
        counts, _ = run["groups"]
        if symmetry:
            counts = _Counts().lin(counts, 0.0, n_groups)
        one = run if symmetry or n_groups == 1 else \
            _run(cfg, shape, mesh, rules, 1, optimizer=False)
        _, above = one["groups"]
        whole = run
    else:
        seg, C, (c1, c2), cut_cfg = cut
        runs = [_run(cut_cfg(c), shape, mesh, rules, 1, optimizer=False,
                     cut_seg=seg) for c in (c1, c2)]
        t = (C - c1) / (c2 - c1)          # Y(C) = Y1 + t (Y2 - Y1)
        counts = _Counts().lin(runs[0]["groups"][0].lin(
            runs[1]["groups"][0], 1.0 - t, t), 0.0, n_groups)
        above = _extrapolated_peak(runs[0]["points"], runs[1]["points"],
                                   C - c1, c2 - c1)
        if train:
            # the optimizer at full depth on zero gradients: its cost
            # does not shrink with the cycles (a segment's leaf is one
            # stacked tensor)
            whole = _run(cfg, shape, mesh, rules, 0)
        else:
            whole = {k: round((1 - t) * runs[0][k] + t * runs[1][k])
                     for k in ("out_pos", "alias")}
            with use_sharding(mesh, rules) as env:       # full depth, exact
                whole["arg_pos"] = _build(cfg, shape, mesh, env)[1]
        cycles = {"segment": seg, "cycles": C, "runs_at": [c1, c2]}
    temps = {"data_group": (whole["od_pos"] if train else 0)
             + above / gsize}
    if train:
        opt_counts, opt_above = whole["opt"]
        counts = counts.lin(opt_counts, 1.0, 1.0)
        temps["optimizer"] = opt_above / n_pos
    return {
        "memory": {
            "argument_size_in_bytes": int(whole["arg_pos"]),
            "temp_size_in_bytes": int(max(max(temps.values()), 0)),
            "output_size_in_bytes": int(whole["out_pos"]),
            "alias_size_in_bytes": int(whole["alias"]),
            "temp_by_phase": {k: int(v) for k, v in temps.items()},
            "peak_bytes_mesh": None if symmetry else int(whole["peak_mesh"])},
        "cost_analysis": {"flops": float(counts.flops)},
        "collectives": _summary(counts.events, n_pos),
        "wire_bytes_by_site": {s: float(b) for s, b in
                               sorted(counts.wire.items()) if b},
        "kernel_dry_calls": {n: int(round(c))
                             for n, c in sorted(counts.dry.items())},
        "symmetry": {"cycles": cycles,
                     "data_groups_run": 1 if symmetry else n_groups,
                     "data_groups": n_groups,
                     "temp": "exact"},
    }


# ---------------------------------------------------------------------------
# the reference's entry points
# ---------------------------------------------------------------------------
def cell_rules(shape, mesh, rules=None):
    """``rules`` for a cell: long_500k-style shapes (global_batch=1)
    cannot shard the batch axis, so the batch is replicated and the
    parallelism comes from the model axis only."""
    batch_div = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            batch_div *= mesh.shape[a]
    if shape.global_batch % batch_div:
        return dict(rules or {}, batch=None)
    return rules


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rules=None, dump_wire: str = None, impl: str = None) -> dict:
    cfg = get_config(arch)
    if impl:
        cfg = cfg.replace(impl=impl)
    shape = SHAPES[shape_name]
    ok, why = cell_is_runnable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}

    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    n_chips = len(mesh.devices)
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "chips": int(n_chips)}
    t0 = time.time()

    cell = cell_rules(shape, mesh, rules)
    if cell is not rules:
        record["rules_override"] = {"batch": None}
    rules = cell

    rec = dry_step(cfg, shape, mesh, rules)
    record["lower_s"] = round(time.time() - t0, 1)
    record.update(rec)
    print(f"[{arch} x {shape_name} x {mesh_name}] memory: "
          f"{rec['memory']}")
    print(f"[{arch} x {shape_name} x {mesh_name}] cost_analysis: "
          f"flops={rec['cost_analysis']['flops']}")
    if dump_wire:
        with open(dump_wire, "w") as f:
            json.dump(rec["wire_bytes_by_site"], f, indent=1)

    tp = mesh.shape["model"]
    rl = roofline_mod.analyze(cfg, shape, mesh_name, n_chips, tp,
                              collectives=rec["collectives"],
                              cost_analysis=rec["cost_analysis"])
    record["roofline"] = rl.to_dict()
    print(f"[{arch} x {shape_name} x {mesh_name}] roofline "
          f"({rl.hardware}): compute={rl.t_compute:.4f}s "
          f"memory={rl.t_memory:.4f}s collective={rl.t_collective:.4f}s "
          f"dominant={rl.dominant} fraction={rl.roofline_fraction:.3f} "
          f"({record['lower_s']} s)")
    return record


def append_record(path: str, record: dict):
    recs = []
    if os.path.exists(path):
        with open(path) as f:
            recs = json.load(f)
    recs = [r for r in recs
            if not (r.get("arch") == record["arch"]
                    and r.get("shape") == record["shape"]
                    and r.get("mesh") == record.get("mesh"))]
    recs.append(record)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(recs, f, indent=1)
    os.replace(tmp, path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/torch_dryrun.json")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--dump-wire", default=None,
                    help="write the wire bytes by collective site (JSON)")
    ap.add_argument("--impl", default=None)
    ap.add_argument("--moe-ep", action="store_true",
                    help="expert-parallel MoE (experts striped over "
                         "'model') instead of expert-TP")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    cells = list(runnable_cells()) if args.all else [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    existing = set()
    if args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            for r in json.load(f):
                if "error" not in r and "skipped" not in r:
                    existing.add((r["arch"], r["shape"], r.get("mesh")))

    failures = 0
    for arch, shape_name in cells:
        for multi in meshes:
            mesh_name = "2x16x16" if multi else "16x16"
            if (arch, shape_name, mesh_name) in existing:
                print(f"skip existing {arch} x {shape_name} x {mesh_name}")
                continue
            t0 = time.time()
            try:
                rules = {"expert": "model", "expert_ff": None} \
                    if args.moe_ep else None
                rec = run_cell(arch, shape_name, multi, rules=rules,
                               dump_wire=args.dump_wire, impl=args.impl)
            except Exception as e:  # noqa
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                       "error": f"{type(e).__name__}: {e}",
                       "lower_s": round(time.time() - t0, 1)}
                failures += 1
            append_record(args.out, rec)
    print(f"done; failures={failures}")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
