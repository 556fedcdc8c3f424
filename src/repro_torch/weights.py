"""Model parameters of the port: random init and the bridge from the
reference's parameter tree.

Layout (see ``models/lm.py``): ``params["segments"][seg][cycle][j]`` holds
the block parameters of layer kind ``seg.kinds[j]`` as the reference's
per-block dict (``ln1``, the mixer's ``attn`` / ``mla`` / ``rglru`` /
``rwkv``, ``ln2``, and ``ffn`` or ``moe`` with ``shared`` except in RWKV-6
layers), unstacked per cycle.  DeepSeek's ``mtp`` module (one more block
and its projections) is built and bridged; no serving path reads it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ATTN, LOCAL, MLA, RGLRU, RWKV6
from repro_torch.models import blocks, lm, modules as nn, rglru, rwkv6


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another one.  With no device given and no CUDA present it raises; it
    never carries on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return torch.device("cuda")


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes: widen exactly, then narrow
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.tensor(a, device=device)


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(fn, v) for v in tree)
    return fn(tree)


def from_reference(np_params, cfg, device=None):
    """Torch parameters from the reference's ``lm.init_params`` tree after
    ``jax.tree.map(np.asarray, ...)``.  Scanned segments carry a leading
    ``n_cycles`` axis on every leaf; it is unstacked into one entry per
    cycle."""
    device = resolve_device(device)
    out = {k: _tree(lambda a: _to_torch(a, device), v)
           for k, v in np_params.items() if k != "segments"}
    segs = []
    for seg, seg_p in zip(lm.make_segments(cfg), np_params["segments"]):
        if seg.scanned:
            cycles = [[_tree(lambda a, c=c: _to_torch(a[c], device), blk)
                       for blk in seg_p] for c in range(seg.n_cycles)]
        else:
            cycles = [[_tree(lambda a: _to_torch(a, device), blk)
                       for blk in seg_p]]
        segs.append(cycles)
    out["segments"] = segs
    return out


# ---------------------------------------------------------------------------
# the reference's tree: the layout of the optimizer and the checkpoints
# ---------------------------------------------------------------------------
def tree_leaves(tree) -> list:
    """The leaves of a nesting of dicts, lists and tuples in
    ``jax.tree.leaves`` order: dict keys sorted."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in tree_leaves(t)]
    return [tree]


def tree_unflatten(template, leaves):
    """``template``'s nesting with its leaves replaced, in
    ``tree_leaves`` order, by ``leaves``."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            new = {k: build(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)
    out = build(template)
    assert next(it, None) is None, "more leaves than the template holds"
    return out


def _stack(ts):
    """The cycles' tensors of one leaf stacked on a new leading axis; no
    copy when they are already the unbound rows of one contiguous stack
    (as ``unstack`` leaves them)."""
    base = ts[0]._base
    if base is not None and base.is_contiguous() \
            and tuple(base.shape) == (len(ts),) + tuple(ts[0].shape) \
            and all(t._base is base and t.data_ptr() == base[c].data_ptr()
                    for c, t in enumerate(ts)):
        return base
    return torch.stack(ts)


def _zip_tree(fn, trees):
    """``fn`` of the cycles' leaves at each position of one nesting."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: _zip_tree(fn, [t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(_zip_tree(fn, [t[i] for t in trees])
                        for i in range(len(t0)))
    return fn(trees)


def to_reference(params, cfg):
    """The reference's parameter tree of the port's ``params``: each
    scanned segment a list of blocks whose leaves are stacked on a
    leading ``n_cycles`` axis, each unscanned one the list of its blocks."""
    segs = []
    for seg, seg_p in zip(lm.make_segments(cfg), params["segments"]):
        if seg.scanned:
            segs.append([_zip_tree(_stack, [cyc[j] for cyc in seg_p])
                         for j in range(len(seg.kinds))])
        else:
            segs.append(list(seg_p[0]))
    out = {k: v for k, v in params.items() if k != "segments"}
    out["segments"] = segs
    return out


def unstack(tree, cfg):
    """The port's nesting of a reference-shaped torch tree: each scanned
    leaf split into its cycles' rows (views, ``Tensor.unbind``: autograd
    gives the stacked leaf one stacked gradient)."""
    rows = {}

    def row(a, c):
        if id(a) not in rows:
            rows[id(a)] = a.unbind(0)
        return rows[id(a)][c]

    segs = []
    for seg, seg_t in zip(lm.make_segments(cfg), tree["segments"]):
        if seg.scanned:
            segs.append([[_tree(lambda a, c=c: row(a, c), blk)
                          for blk in seg_t] for c in range(seg.n_cycles)])
        else:
            segs.append([list(seg_t)])
    out = {k: v for k, v in tree.items() if k != "segments"}
    out["segments"] = segs
    return out


# ---------------------------------------------------------------------------
# the reference-shaped tree on a mesh
# ---------------------------------------------------------------------------
class _Path:
    def __init__(self, path):
        self.path = path


def shard_params(params, cfg, mesh, consume: bool = False):
    """The reference-shaped tree (``to_reference``) of the port's
    ``params`` placed on ``mesh``: each leaf a
    :class:`~repro_torch.parallel.sharding.Sharded` by its
    ``sharding.param_specs`` entry under the current environment, built
    leaf by leaf: each position's block of a scanned leaf is stacked from
    the cycles' blocks, so the stacked leaf is never whole.  With
    ``consume`` each of ``params``' tensors is dropped from its nesting
    once placed, so that the peak memory is the parameters and one
    leaf's blocks (a model that fills most of the card)."""
    from repro_torch.parallel import sharding
    meta = _tree(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                       device="meta"), params)
    ref = to_reference(meta, cfg)
    specs = sharding.param_specs(ref)
    segs = lm.make_segments(cfg)

    def sources(path):
        """(the tensors of a reference leaf, stacked or not, and where
        each lives: (container, key))."""
        if path[0] != "segments":
            node = params
            for k in path[:-1]:
                node = node[k]
            return [(node, path[-1])], False
        si, j, rest = path[1], path[2], path[3:]
        seg = segs[si]
        out = []
        for c in range(seg.n_cycles if seg.scanned else 1):
            node = params["segments"][si][c][j]
            for k in rest[:-1]:
                node = node[k]
            out.append((node, rest[-1]))
        return out, seg.scanned

    leaves = []
    paths = [b.path for b in tree_leaves(sharding._map_with_path(
        lambda path, l: _Path(path), ref))]
    for path, spec, leaf in zip(paths, tree_leaves_specs(specs),
                                tree_leaves(ref)):
        src, stacked = sources(path)
        ts = [node[k] for node, k in src]
        shards = []
        for p, dev in enumerate(mesh.devices):
            reg = sharding.region(leaf.shape, spec, mesh, p)
            if stacked:
                blk = torch.stack([t[reg[1:]].to(dev) for t in ts])
            else:
                blk = ts[0][reg].to(dev)
            shards.append(blk.clone(memory_format=torch.contiguous_format))
        leaves.append(sharding.Sharded(shards, spec, leaf.shape, mesh))
        if consume:
            del ts
            for node, k in src:
                node[k] = None
    return tree_unflatten(ref, leaves)


def tree_leaves_specs(specs) -> list:
    """The specs of a spec tree in ``tree_leaves`` order (a spec is a
    tuple, so it is a leaf here)."""
    if isinstance(specs, dict):
        return [l for k in sorted(specs) for l in tree_leaves_specs(specs[k])]
    if isinstance(specs, list):
        return [l for t in specs for l in tree_leaves_specs(t)]
    return [specs]


def group_view(trees):
    """One nesting of several positions' trees (the same nesting), whose
    leaves hold each position's tensor (``collectives.PerPos``): the
    parameters of a model group as the train forward takes them."""
    from repro_torch.parallel.collectives import PerPos
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: group_view([t[k] for t in trees]) for k in t0}
    if isinstance(t0, (list, tuple)):
        return type(t0)(group_view([t[i] for t in trees])
                        for i in range(len(t0)))
    return PerPos(trees)


def group_params(params, group, cfg, shards=None):
    """The parameters of one model group as its forward takes them
    (``group_view`` of its positions' port nestings): each leaf of the
    reference-shaped Sharded tree ``params`` gives each position its
    block as its consumer takes it (``sharding.consumer_block``); a leaf
    stored over the data axes stays each position's stored blocks
    (``collectives.Stored``, a cycle's rows of a stacked leaf), which its
    layer gathers when it runs, also in a one-position group.
    ``shards`` (default each leaf's shards) is a list, per leaf in
    ``tree_leaves`` order, of the tensors to read, e.g. leaves that
    require grad."""
    from repro_torch.parallel import sharding
    leaves = tree_leaves(params)
    paths = tree_leaves(sharding._map_with_path(
        lambda path, leaf: sharding.path_str(path), params))
    shards = shards or [l.shards for l in leaves]
    trees = [unstack(tree_unflatten(params, [
        sharding.consumer_block(l, path, p, s)
        for l, path, s in zip(leaves, paths, shards)]), cfg)
        for p in group.positions]
    return trees[0] if group.size == 1 else group_view(trees)


def init_params(cfg, generator: Optional[torch.Generator] = None,
                device=None):
    """Random parameters drawn from the reference's distributions
    (``repro/models/modules.py`` dense/embed init, ``attention.init``,
    ``mla.init``, ``moe.init``, ``rglru.init``, ``rwkv6.init``,
    ``blocks.init``, ``lm.init_params``).  The bits differ from the
    reference's: torch and JAX generators differ."""
    device = resolve_device(device)
    if generator is None and device.type != "meta":   # meta: shapes only
        generator = torch.Generator(device=device).manual_seed(0)
    dtype = nn.dt(cfg.param_dtype)

    def normal(shape, std=1.0, to=dtype):
        # scaled in place: at grok's widths one expert tensor is 6.4 GB
        # in fp32 before the cast (DeepSeek's 15 GB)
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return x.mul_(std).to(to)

    def dense(d_in, d_out, scale=1.0, to=dtype):
        return normal((d_in, d_out), scale * d_in ** -0.5, to)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    def ones(n):
        return {"scale": full((n,), 1.0)}

    d, hd = cfg.d_model, cfg.head_dim
    layer_scale = 1.0 / max(1, cfg.n_layers) ** 0.5

    def attn():
        p = {"wq": dense(d, cfg.n_heads * hd),
             "wk": dense(d, cfg.n_kv_heads * hd),
             "wv": dense(d, cfg.n_kv_heads * hd),
             "wo": dense(cfg.n_heads * hd, d, layer_scale)}
        if cfg.qk_norm:
            p["q_norm"] = full((hd,), 1.0)
            p["k_norm"] = full((hd,), 1.0)
        return p

    def mla_block():
        m = cfg.mla
        qd = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "q_a": dense(d, m.q_lora_rank),
            "q_a_norm": full((m.q_lora_rank,), 1.0),
            "q_b": dense(m.q_lora_rank, cfg.n_heads * qd),
            "kv_a": dense(d, m.kv_lora_rank + m.qk_rope_head_dim),
            "kv_a_norm": full((m.kv_lora_rank,), 1.0),
            "kv_b": dense(m.kv_lora_rank, cfg.n_heads
                          * (m.qk_nope_head_dim + m.v_head_dim)),
            "wo": dense(cfg.n_heads * m.v_head_dim, d, layer_scale),
        }

    def rglru_block():
        w = cfg.lru_width or d
        heads = cfg.n_heads
        ghd = w // heads
        # Lambda so that a ~ U[0.9, 0.999]^(1/c) (Griffin app. A)
        u = 0.9 + 0.099 * torch.rand((w,), generator=generator,
                                     device=device, dtype=torch.float32)
        return {
            "lru_in_x": dense(d, w),
            "lru_in_gate": dense(d, w),
            "conv_w": normal((cfg.conv1d_width, w), cfg.conv1d_width ** -0.5),
            "conv_b": full((w,), 0.0),
            "lru_a_gate_w": normal((heads, ghd, ghd), ghd ** -0.5),
            "lru_a_gate_b": full((heads, ghd), 0.0),
            "lru_x_gate_w": normal((heads, ghd, ghd), ghd ** -0.5),
            "lru_x_gate_b": full((heads, ghd), 0.0),
            "lru_a_param": torch.log(torch.expm1(-torch.log(u)
                                                 / rglru.C_FACTOR)),
            "lru_out": dense(w, d, layer_scale),
        }

    def rwkv_block():
        return {
            "rwkv_mix_x": full((d,), 0.0),
            "rwkv_mix_base": full((5, d), 0.0),
            "rwkv_mix_lora_a": normal((d, 5, rwkv6.LORA_MIX), d ** -0.5),
            "rwkv_mix_lora_b": normal((5, rwkv6.LORA_MIX, d),
                                      rwkv6.LORA_MIX ** -0.5),
            "rwkv_decay_base": full((d,), -1.0),
            "rwkv_decay_lora_a": normal((d, rwkv6.LORA_DECAY), d ** -0.5),
            "rwkv_decay_lora_b": normal((rwkv6.LORA_DECAY, d),
                                        rwkv6.LORA_DECAY ** -0.5),
            "rwkv_u": normal((cfg.n_heads, hd), 0.1, to=torch.float32),
            "rwkv_wr": dense(d, d),
            "rwkv_wk": dense(d, d),
            "rwkv_wv": dense(d, d),
            "rwkv_wg": dense(d, d),
            "rwkv_wo": dense(d, d, layer_scale),
            "rwkv_ln_scale": full((d,), 1.0),
            "rwkv_ln_bias": full((d,), 0.0),
            "rwkv_cm_mix_k": full((d,), 0.5),
            "rwkv_cm_mix_r": full((d,), 0.5),
            "rwkv_cm_wk": dense(d, cfg.d_ff),
            "rwkv_cm_wv": dense(cfg.d_ff, d, layer_scale),
            "rwkv_cm_wr": dense(d, d),
        }

    def ffn(c):
        p = {"w_up": dense(d, c.d_ff),
             "w_down": dense(c.d_ff, d, layer_scale)}
        if c.gated_ffn:
            p["w_gate"] = dense(d, c.d_ff)
        return p

    def moe_block():
        m = cfg.moe
        E, fe = m.n_experts, m.d_ff_expert
        p = {"router_w": dense(d, E, to=torch.float32),
             "e_up": normal((E, d, fe), d ** -0.5),
             "e_down": normal((E, fe, d), layer_scale * fe ** -0.5)}
        if cfg.gated_ffn:
            p["e_gate"] = normal((E, d, fe), d ** -0.5)
        return p

    def block(kind, is_moe):
        p = {"ln1": ones(d)}
        if kind == RWKV6:
            p["rwkv"] = rwkv_block()
        elif kind == RGLRU:
            p["rglru"] = rglru_block()
        elif kind == MLA:
            p["mla"] = mla_block()
        elif kind in (ATTN, LOCAL):
            p["attn"] = attn()
        else:
            raise ValueError(kind)
        p["ln2"] = ones(d)
        if is_moe and kind != RWKV6:
            p["moe"] = moe_block()
            if cfg.moe.n_shared:
                p["shared"] = ffn(blocks.shared_cfg(cfg))
        elif kind != RWKV6:
            p["ffn"] = ffn(cfg)
        if cfg.post_norm:
            p["ln1_post"] = ones(d)
            p["ln2_post"] = ones(d)
        return p

    segs = lm.make_segments(cfg)
    params = {}
    if cfg.embed_inputs:
        params["embed"] = {"embed_table": normal((cfg.vocab_size, d))}
    params["segments"] = [[[block(k, seg.is_moe) for k in seg.kinds]
                           for _ in range(seg.n_cycles)] for seg in segs]
    params["final_norm"] = ones(d)
    if not cfg.tie_embeddings or not cfg.embed_inputs:
        params["head"] = {"head_w": dense(d, cfg.vocab_size)}
    if cfg.mtp_depth:
        params["mtp"] = {"mtp_proj": dense(2 * d, d), "norm_h": ones(d),
                         "norm_e": ones(d), "final_norm": ones(d),
                         "block": block(segs[-1].kinds[-1],
                                        segs[-1].is_moe)}
    return params
