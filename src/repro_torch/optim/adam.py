"""AdamW with per-arch state-dtype policies.

Reference: ``repro/optim/adam.py``.  opt_state_dtype "float32" |
"bfloat16" | "int8" (blockwise, ``optim/quant.py``).  The optimizer works
on the reference's parameter tree (``weights.to_reference``: a scanned
segment's leaves stacked on a leading ``n_cycles`` axis), in its leaf
order (``weights.tree_leaves``: dict keys sorted), because two of its
decisions depend on the stacked leaf's shape: weight decay applies to
leaves of ndim >= 2 (so a scanned segment's stacked norm scales are
decayed, an unscanned one's are not), and the int8 layout is
``quantize_aligned`` or the flat blocks, which then run across cycles.

On a mesh (parameters as :class:`~repro_torch.parallel.sharding.Sharded`
leaves) the moments are ZeRO-1: param-shaped, placed by the parameter's
spec augmented with the ("pod", "data") axes on a dim the gradient is
replicated over (``state_specs``; the flat int8 layout over every mesh
axis).  ``update`` then reduce-scatters the data replicas' gradients onto
the moment blocks, sums the gradient norm over every position, updates
each block where it lives and all-gathers the new parameters.  Weight
decay and the int8 blocks follow the logical (stacked) shape: a 128-wide
aligned block that a moment block's edge cuts takes the largest entry
over its pieces (an exchange of the block scales, which the reference's
scale spec replicates over the last dim), so the codes and scales equal
the one-device step's for equal moments.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.optim import quant
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import (Sharded, region, replicas,
                                           sum_regions)
from repro_torch.weights import tree_leaves, tree_leaves_specs, \
    tree_unflatten


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
    """Zero moments for the reference-shaped parameter tree ``params``
    (Sharded leaves: ZeRO-1 moments, ``state_specs``)."""
    leaves = tree_leaves(params)
    if leaves and isinstance(leaves[0], Sharded):
        return _init_sharded(leaves, cfg)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    m = [_encode(zeros(p), cfg.state_dtype, second_moment=False)
         for p in leaves]
    v = [_encode(zeros(p), cfg.state_dtype, second_moment=True)
         for p in leaves]
    step = torch.zeros((), dtype=torch.int32,
                       device=leaves[0].device if leaves else None)
    return AdamState(step=step, m=m, v=v)


def _augment_spec(shape, spec, batch_axes):
    """ZeRO-1: extend the param spec with the (grad-replicated) batch axes
    on the largest still-unsharded, divisible dim."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in entries:
        if isinstance(e, str):
            used.add(e)
        elif isinstance(e, tuple):
            used.update(e)
    batch_axes = {a: s for a, s in batch_axes.items() if a not in used}
    n = 1
    for a in batch_axes:
        n *= batch_axes[a]
    if n <= 1:
        return tuple(entries)
    best, best_size = None, 0
    for i, (d, e) in enumerate(zip(shape, entries)):
        if e is None and d % n == 0 and d > best_size:
            best, best_size = i, d
    if best is not None:
        entries[best] = tuple(batch_axes)
    return tuple(entries)


def _batch_axes(mesh):
    return {a: mesh.shape[a] for a in ("pod", "data")
            if a in mesh.axis_names}


def _moment_spec(shape, spec, mesh, state_dtype, sq):
    """The spec of one moment (a QTensor of specs for int8)."""
    aug = _augment_spec(shape, spec, _batch_axes(mesh) if mesh else {})
    if state_dtype != "int8":
        return aug
    if quant.aligned_ok(shape):
        return quant.QTensor(q=aug, scale=aug[:-1] + (None,),
                             shape=tuple(shape), sqrt_encoded=sq,
                             mode="aligned")
    all_axes = tuple(mesh.axis_names) if mesh else ()
    return quant.QTensor(q=(all_axes, None) if all_axes else (),
                         scale=(all_axes,) if all_axes else (),
                         shape=tuple(shape), sqrt_encoded=sq, mode="flat")


def state_specs(params, cfg: AdamConfig, param_spec_tree):
    """The spec tree of the AdamState of ``params`` (a reference-shaped
    tree; shapes only) under the current sharding environment.

    Moments are param-shaped with the param's spec AUGMENTED by the batch
    ("pod","data") axes on a grad-replicated dim: the update math is then
    completely local, and only the updated params are re-gathered —
    textbook ZeRO-1 without any moment movement.  int8 moments in the
    flat layout are split over every mesh axis."""
    from repro_torch.parallel.sharding import current_env
    env = current_env()
    mesh = env.mesh if env is not None else None
    p_leaves = tree_leaves(params)
    s_leaves = tree_leaves_specs(param_spec_tree)
    m = [_moment_spec(tuple(p.shape), s, mesh, cfg.state_dtype, False)
         for p, s in zip(p_leaves, s_leaves)]
    v = [_moment_spec(tuple(p.shape), s, mesh, cfg.state_dtype, True)
         for p, s in zip(p_leaves, s_leaves)]
    return AdamState(step=(), m=m, v=v)


# ---------------------------------------------------------------------------
# ZeRO-1 on a mesh
# ---------------------------------------------------------------------------
def _flat_blocks(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return quant._pad_blocks(-(-n // quant.BLOCK))


def _zeros(shape, spec, mesh, dtype):
    return Sharded([torch.zeros(tuple(r.stop - r.start for r in region(
        shape, spec, mesh, p)), dtype=dtype, device=d)
        for p, d in enumerate(mesh.devices)], spec, shape, mesh)


def _init_sharded(leaves, cfg: AdamConfig) -> AdamState:
    mesh = leaves[0].mesh

    def zero(st, sq):
        ms = _moment_spec(st.shape, st.spec, mesh, cfg.state_dtype, sq)
        if isinstance(ms, quant.QTensor):
            if ms.mode == "aligned":
                qs = st.shape
                ss = st.shape[:-1] + (st.shape[-1] // quant.BLOCK_ALIGNED,)
            else:
                ss = (_flat_blocks(st.shape),)
                qs = ss + (quant.BLOCK,)
            return ms._replace(q=_zeros(qs, ms.q, mesh, torch.int8),
                               scale=_zeros(ss, ms.scale, mesh,
                                            torch.float32))
        dt = torch.bfloat16 if cfg.state_dtype == "bfloat16" \
            else torch.float32
        return _zeros(st.shape, ms, mesh, dt)
    return AdamState(
        step=torch.zeros((), dtype=torch.int32, device=mesh.devices[0]),
        m=[zero(st, False) for st in leaves],
        v=[zero(st, True) for st in leaves])


def _rel(inner, outer):
    """``inner`` (a block's slices) relative to ``outer``'s start."""
    return tuple(slice(a.start - b.start, a.stop - b.start)
                 for a, b in zip(inner, outer))


def _key(reg):
    return tuple((r.start, r.stop) for r in reg)


class _Leaf:
    """One parameter leaf on the mesh: its blocks under the parameter's
    spec, and the moment blocks (param-shaped spec ``A``, or the flat
    int8 layout's rows of 256) each position updates."""

    def __init__(self, st: Sharded, moment):
        self.st, self.mesh, self.shape = st, st.mesh, st.shape
        self.n = len(st.mesh.devices)
        self.flat = isinstance(moment, quant.QTensor) \
            and moment.mode == "flat"
        self.A = (moment.q if isinstance(moment, quant.QTensor)
                  else moment).spec
        self.rp = [region(self.shape, st.spec, self.mesh, p)
                   for p in range(self.n)]
        if self.flat:
            self.nb = _flat_blocks(self.shape)
            self.rows = [region((self.nb, quant.BLOCK), self.A, self.mesh,
                                p)[0] for p in range(self.n)]
        else:
            self.ra = [region(self.shape, self.A, self.mesh, p)
                       for p in range(self.n)]

    def owner(self, p) -> bool:
        """Whether ``p`` is the first position holding its moment block
        (whose gradient the norm counts)."""
        return self.flat or replicas(self.A, self.mesh, p)[0] == p

    def _padded(self, t):
        return F.pad(t.reshape(-1), (0, self.nb * quant.BLOCK - t.numel()))

    def _scatter_rows(self, flat, site, kind):
        devs = self.mesh.devices
        out = []
        for p, d in enumerate(devs):
            r = self.rows[p]
            b = flat[r.start * quant.BLOCK:r.stop * quant.BLOCK]
            out.append(b if p == 0 else col.send(b, d, site, kind))
        return out

    def grad_blocks(self, g: Sharded):
        """Every position's fp32 block of the summed gradient: a
        reduce-scatter of the replicas' partial gradients onto the moment
        blocks (the flat layout's through the logical gradient on the
        first position)."""
        devs = self.mesh.devices
        if self.flat:
            parts = [t if q == 0 else col.send(t, devs[0], "zero grad",
                                               "reduce_scatter")
                     for q, t in enumerate(g.shards)]
            G = sum_regions(parts, self.shape, g.spec, self.mesh, devs[0])
            return self._scatter_rows(self._padded(G), "zero grad",
                                      "reduce_scatter")
        out = []
        for p, d in enumerate(devs):
            acc = None
            for q in replicas(self.st.spec, self.mesh, p):
                t = g.shards[q][_rel(self.ra[p], self.rp[q])]
                if q != p:
                    t = col.send(t, d, "zero grad", "reduce_scatter")
                acc = t.float() if acc is None else acc + t.float()
            out.append(acc)
        return out

    def param_blocks(self):
        """Every position's fp32 block of the parameter, moment-shaped."""
        if self.flat:
            from repro_torch.parallel.sharding import gather
            return self._scatter_rows(self._padded(gather(self.st).float()),
                                      "zero param", "all_gather")
        return [self.st.shards[p][_rel(self.ra[p], self.rp[p])].float()
                for p in range(self.n)]

    def new_param(self, blocks) -> Sharded:
        """All-gather the positions' updated blocks back to the
        parameter's placement."""
        devs, dtype = self.mesh.devices, self.st.dtype
        if self.flat:
            numel = 1
            for d in self.shape:
                numel *= d
            flat = torch.cat([b if p == 0 else col.send(
                b, devs[0], "zero param", "all_gather")
                for p, b in enumerate(blocks)])[:numel].reshape(self.shape)
            return Sharded([flat[self.rp[p]].clone() if p == 0 else col.send(
                flat[self.rp[p]], d, "zero param", "all_gather").contiguous()
                for p, d in enumerate(devs)], self.st.spec, self.shape,
                self.mesh)
        out = []
        for p, d in enumerate(devs):
            new = torch.empty_like(self.st.shards[p], dtype=dtype)
            seen = {_key(self.ra[p])}
            new[_rel(self.ra[p], self.rp[p])] = blocks[p]
            for q in replicas(self.st.spec, self.mesh, p):
                if _key(self.ra[q]) not in seen:
                    seen.add(_key(self.ra[q]))
                    new[_rel(self.ra[q], self.rp[p])] = col.send(
                        blocks[q], d, "zero param", "all_gather")
            out.append(new)
        return Sharded(out, self.st.spec, self.shape, self.mesh)

    def decode(self, enc, p):
        """Position ``p``'s fp32 moment block."""
        if not isinstance(enc, quant.QTensor):
            return enc.shards[p].float()
        q, sc = enc.q.shards[p], enc.scale.shards[p]
        if enc.mode == "flat":
            x = quant.values(q, sc[:, None]).reshape(-1)
        else:
            x = quant.values(q, sc.index_select(-1, self._blk(p, q.device)))
        return quant.decode_output(x, enc.sqrt_encoded)

    def _blk(self, p, device):
        """The 128-block of each last-dim column of position p's block."""
        last = self.ra[p][-1]
        return torch.arange(last.start, last.stop, device=device) \
            // quant.BLOCK_ALIGNED

    def encode(self, blocks, like, state_dtype):
        """The positions' new moment blocks in the state's layout."""
        mesh = self.mesh
        if state_dtype != "int8":
            dt = torch.bfloat16 if state_dtype == "bfloat16" \
                else torch.float32
            return Sharded([b.to(dt) for b in blocks], self.A, self.shape,
                           mesh)
        enc = [quant._encode_input(b, like.sqrt_encoded) for b in blocks]
        qs, ss = [], []
        if self.flat:
            for x in enc:
                q, sc = quant.quantize_rows(x.reshape(-1, quant.BLOCK))
                qs.append(q)
                ss.append(sc)
        else:
            # each position's largest entry of every 128-block its block
            # overlaps, then the max over the positions holding the same
            # rows (the scale block covers the whole last dim)
            L = quant.BLOCK_ALIGNED
            nb = self.shape[-1] // L
            partial = []
            for p, x in enumerate(enc):
                a, b = self.ra[p][-1].start, self.ra[p][-1].stop
                b0, b1 = a // L, -(-b // L)
                xp = F.pad(x.abs(), (a - b0 * L, b1 * L - b))
                full = torch.zeros(*x.shape[:-1], nb, dtype=torch.float32,
                                   device=x.device)
                full[..., b0:b1] = xp.reshape(*x.shape[:-1], b1 - b0,
                                              L).amax(-1)
                partial.append(full)
            lead = self.A[:-1] + (None,)
            for p, (d, x) in enumerate(zip(mesh.devices, enc)):
                sc, seen = partial[p], {_key(self.ra[p])}
                for q in replicas(lead, mesh, p):
                    if _key(self.ra[q]) not in seen:
                        seen.add(_key(self.ra[q]))
                        sc = torch.maximum(sc, col.send(
                            partial[q], d, "int8 scale", "all_gather"))
                qs.append(quant.codes(x, sc.index_select(
                    -1, self._blk(p, d))))
                ss.append(sc)
        return like._replace(q=Sharded(qs, like.q.spec, like.q.shape, mesh),
                             scale=Sharded(ss, like.scale.spec,
                                           like.scale.shape, mesh))


def _update_sharded(grads, state: AdamState, params, *, lr, cfg: AdamConfig):
    p_leaves, g_leaves = tree_leaves(params), tree_leaves(grads)
    mesh = p_leaves[0].mesh
    devs, root = mesh.devices, mesh.devices[0]
    leaves = [_Leaf(st, m) for st, m in zip(p_leaves, state.m)]
    # reduce-scatter each leaf's gradient onto the moment blocks
    gb = []
    for i, (lf, g) in enumerate(zip(leaves, g_leaves)):
        gb.append(lf.grad_blocks(g))
        g_leaves[i] = g.shards = None
    # the global norm: every moment block once, summed on the first device
    total = None
    for lf, blocks in zip(leaves, gb):
        for p, b in enumerate(blocks):
            if lf.owner(p):
                s = torch.sum(torch.square(b))
                s = s if p == 0 else col.send(s, root, "grad norm",
                                              "all_reduce")
                total = s if total is None else total + s
    gnorm = torch.sqrt(total)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    step = state.step + 1
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    on = {d: (None if scale is None else scale.to(d), b1c.to(d), b2c.to(d),
              lr.to(d) if isinstance(lr, torch.Tensor) else lr)
          for d in set(devs)}

    new_p, new_m, new_v = [], [], []
    for i, (lf, blocks) in enumerate(zip(leaves, gb)):
        pblk = lf.param_blocks()
        mb, vb, nb_ = [], [], []
        for p, d in enumerate(devs):
            sc, c1, c2, lr_d = on[d]
            g = blocks[p] if sc is None else blocks[p] * sc
            m = cfg.b1 * lf.decode(state.m[i], p) + (1 - cfg.b1) * g
            v = cfg.b2 * lf.decode(state.v[i], p) \
                + (1 - cfg.b2) * torch.square(g)
            del g
            delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            pf = pblk[p]
            if cfg.weight_decay and lf.st.ndim >= 2:   # the logical ndim
                delta = delta + cfg.weight_decay * pf
            nb_.append((pf - lr_d * delta).to(lf.st.dtype))
            mb.append(m)
            vb.append(v)
        gb[i] = pblk = None
        new_m.append(lf.encode(mb, state.m[i], cfg.state_dtype))
        new_v.append(lf.encode(vb, state.v[i], cfg.state_dtype))
        state.m[i] = state.v[i] = None
        new_p.append(lf.new_param(nb_))
    return tree_unflatten(params, new_p), AdamState(step, new_m, new_v), \
        {"grad_norm": gnorm}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


def update(grads, state: AdamState, params, *, lr, cfg: AdamConfig):
    """Returns (new_params, new_state, metrics).  ``grads`` and
    ``params`` are reference-shaped trees; ``lr`` a float or a 0-d fp32
    tensor.  ``state`` is consumed: its moments are released leaf by leaf
    as the new ones are made (the reference's jitted step donates its
    state), so that a step holds one set of moments beside the leaf in
    flight; the caller must not read ``state`` again.

    On a mesh ``params`` has Sharded leaves and ``grads`` partial Sharded
    ones (each position's share of the gradient): the ZeRO-1 update."""
    if isinstance(tree_leaves(params)[0], Sharded):
        return _update_sharded(grads, state, params, lr=lr, cfg=cfg)
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
