"""Logical-axis sharding rules, parameter placement and the layout
autotuner.

Reference: ``repro/parallel/sharding.py``.  A rule table maps logical
axis names to the axes of a mesh (here the port's
:class:`~repro_torch.launch.mesh.DeviceMesh`); ``use_sharding`` makes a
mesh and its rules the current environment, which placement code reads
through ``current_env``.  The rule tables, ``resolve``, ``PARAM_RULES``
and ``param_specs`` are the reference's.

A spec is a tuple with one entry per dim, the counterpart of a
``PartitionSpec``: None (the dim is whole on every position), an axis
name, or a tuple of axis names (the dim is split over them, row-major in
the tuple's order); missing trailing entries are None.  A
:class:`Sharded` tensor holds the reference's placement literally: one
tensor per mesh position, on that position's device, the block of the
logical tensor its coordinates select (positions that differ only on an
axis the spec does not name hold equal copies).  ``shard`` cuts a
logical tensor by a spec and ``gather`` puts it back together; a
:class:`NamedSharding` (mesh, spec) is what ``restore`` places a leaf
by.
"""
from __future__ import annotations

import contextlib
import contextvars
import re
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

Axis = Union[str, Tuple[str, ...], None]
Spec = Tuple[Axis, ...]

# Baseline rule table (paper-faithful distributed-memory layout):
#   batch        -> farmer-worker axis (pod x data)
#   seq_sp       -> sequence-parallel residual stream (Megatron-SP)
#   heads/ffn/.. -> tensor-parallel "model" axis
#   fsdp         -> weight-shard storage axis (nodes-as-storage, C4)
DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "vocab": "model",
    # MoE: baseline is expert-TP ("expert_ff" over model, experts unsharded —
    # works for any expert count); the EP alternative maps "expert" -> model.
    "expert": None,
    "expert_ff": "model",
    "fsdp": ("pod", "data"),
    "fsdp_dense": None,
    "tp": "model",
    "stage": "pod",
    # paged-KV serving: the page axis of the KV pools is striped over the
    # TP axis with the paper's address%n rule (core/memory_server
    # .stripe_slab_index maps logical page -> physical slab row, so the
    # stripe of rows a position holds is exactly its node's pages)
    "pages": "model",
}

# Serving rule table: ONLY the paged-KV pools are sharded.  KV pages live
# on their striped_owner node, parameters and activations replicate, and
# the decode kernel's owner-partials merge is the only cross-node
# exchange.
SERVING_RULES: Dict[str, Axis] = dict(
    {k: None for k in DEFAULT_RULES}, pages="model")


@dataclass(frozen=True)
class ShardingEnv:
    mesh: object       # a DeviceMesh: axis_names and shape
    rules: Mapping[str, Axis] = field(default_factory=lambda: DEFAULT_RULES)

    def resolve(self, logical: Axis) -> Axis:
        """Map a logical axis name to mesh axes present in this mesh."""
        if logical is None:
            return None
        mapped = self.rules.get(logical, None) if isinstance(logical, str) \
            else logical
        if mapped is None:
            return None
        if isinstance(mapped, str):
            mapped = (mapped,)
        present = tuple(a for a in mapped if a in self.mesh.axis_names)
        if not present:
            return None
        return present if len(present) > 1 else present[0]

    def spec(self, *logical_axes: Axis) -> Spec:
        return tuple(self.resolve(a) for a in logical_axes)


_ENV: contextvars.ContextVar[Optional[ShardingEnv]] = contextvars.ContextVar(
    "sharding_env", default=None)


def current_env() -> Optional[ShardingEnv]:
    return _ENV.get()


@contextlib.contextmanager
def use_sharding(mesh, rules: Optional[Mapping[str, Axis]] = None):
    """Make ``mesh`` with ``rules`` (over the defaults) the current
    sharding environment; no mesh, no environment."""
    if mesh is None:
        yield None
        return
    env = ShardingEnv(mesh, dict(DEFAULT_RULES, **(rules or {})))
    tok = _ENV.set(env)
    try:
        yield env
    finally:
        _ENV.reset(tok)


def logical_constraint(x, *logical_axes: Axis):
    """The reference's ``with_sharding_constraint`` by logical axis names:
    ``x`` laid out as ``logical_axes`` say over its model group.  A no-op
    off a mesh and for a plain tensor.  The shards of a model group
    (:class:`~repro_torch.parallel.collectives.Shards`) must already be
    split on the dim whose logical axis resolves to the group's axis:
    the train forward's collectives land them so (``row_parallel``'s
    reduce-scatter splits on the sequence), and moving a split is not
    ported."""
    env = current_env()
    from repro_torch.parallel import collectives
    if env is None or not isinstance(x, collectives.Shards):
        return x
    split = None
    for i, a in enumerate(logical_axes):
        if x.group.axis in _axes(env.resolve(a)):
            split = i
    if split != x.split:
        raise NotImplementedError(
            f"shards split on dim {x.split}, asked for dim {split}: moving "
            f"a split is not ported")
    return x


# ---------------------------------------------------------------------------
# Parameter placement
# ---------------------------------------------------------------------------
# Leaf-name -> logical axes, matched on the last path component.  When the
# actual leaf has more dims than the spec (stacked scan params), leading
# dims are unsharded.
PARAM_RULES: Sequence[Tuple[str, Tuple[Axis, ...]]] = (
    # embeddings / head: vocab striped over TP = the paper's address%n
    (r"embed_table$", ("tp", "fsdp_dense")),
    (r"head_w$", ("fsdp_dense", "tp")),
    # attention
    (r"wq$", ("fsdp_dense", "tp")),
    (r"wk$", ("fsdp_dense", "tp")),
    (r"wv$", ("fsdp_dense", "tp")),
    (r"wo$", ("tp", "fsdp_dense")),
    (r"(q_norm|k_norm)$", (None,)),
    # MLA
    (r"q_a$", ("fsdp_dense", None)),
    (r"q_b$", ("fsdp_dense", "tp")),
    (r"kv_a$", ("fsdp_dense", None)),
    (r"kv_b$", ("fsdp_dense", "tp")),
    (r"(q_a_norm|kv_a_norm)$", (None,)),
    # dense FFN
    (r"w_gate$", ("fsdp_dense", "tp")),
    (r"w_up$", ("fsdp_dense", "tp")),
    (r"w_down$", ("tp", "fsdp_dense")),
    # MoE (experts striped over TP axis = expert parallelism)
    (r"router_w$", ("fsdp", None)),
    (r"router_b$", (None,)),
    (r"e_gate$", ("expert", "fsdp", "expert_ff")),
    (r"e_up$", ("expert", "fsdp", "expert_ff")),
    (r"e_down$", ("expert", "expert_ff", "fsdp")),
    # RG-LRU / Griffin
    (r"conv_w$", (None, "tp")),
    (r"conv_b$", ("tp",)),
    (r"lru_in_(x|gate)$", ("fsdp_dense", "tp")),
    (r"lru_out$", ("tp", "fsdp_dense")),
    # block-diag gates are (heads, hd, hd) with heads=10 for recurrentgemma:
    # not divisible by TP=16, and small — replicate them
    (r"lru_(a_gate|x_gate)_w$", (None, None, None)),
    (r"lru_(a_gate|x_gate)_b$", (None, None)),
    (r"lru_a_param$", ("tp",)),
    # RWKV6 time-mix
    (r"rwkv_(wr|wk|wv|wg)$", ("fsdp_dense", "tp")),
    (r"rwkv_wo$", ("tp", "fsdp_dense")),
    (r"rwkv_mix_lora_a$", ("fsdp_dense", None, None)),
    (r"rwkv_mix_lora_b$", (None, None, "fsdp_dense")),
    (r"rwkv_decay_lora_a$", ("fsdp_dense", None)),
    (r"rwkv_decay_lora_b$", (None, "fsdp_dense")),
    (r"rwkv_(mix_base|decay_base|mix_x)$", (None,)),
    (r"rwkv_u$", ("tp", None)),
    (r"rwkv_ln_(scale|bias)$", (None,)),
    # RWKV6 channel-mix
    (r"rwkv_cm_wk$", ("fsdp_dense", "tp")),
    (r"rwkv_cm_wv$", ("tp", "fsdp_dense")),
    (r"rwkv_cm_wr$", ("fsdp_dense", None)),
    (r"rwkv_cm_mix_(k|r)$", (None,)),
    # norms & misc small
    (r"scale$", (None,)),
    (r"bias$", (None,)),
    (r"mtp_proj$", ("fsdp_dense", "tp")),
)
# leaves that PARAM_RULES store in column blocks over "model" and whose
# layer takes them in row blocks: the first match wins, so the RWKV-6
# channel mix's wv takes the ``wv$`` rule, not its own, and its
# ``row_parallel`` wants ("tp", None)
ROW_CONSUMED = re.compile(r"rwkv_cm_wv$")


def _axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(env: ShardingEnv, resolved) -> int:
    n = 1
    for a in _axes(resolved):
        n *= env.mesh.shape[a]
    return n


def _leaf_spec(path: str, shape, env: ShardingEnv) -> Spec:
    ndim = len(shape)
    for pat, axes in PARAM_RULES:
        if re.search(pat, path):
            axes = tuple(axes)
            if len(axes) < ndim:  # stacked scan params: leading dims unsharded
                axes = (None,) * (ndim - len(axes)) + axes
            elif len(axes) > ndim:
                raise ValueError(f"spec {axes} too long for {path} ndim={ndim}")
            # drop axes that don't divide the dim (e.g. hubert vocab=504
            # over TP=16) — the leaf is then replicated on that dim
            resolved = [env.resolve(a) for a in axes]
            return tuple(r if shape[i] % _axis_size(env, r) == 0 else None
                         for i, r in enumerate(resolved))
    return ()  # replicate by default


def path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(params, env: Optional[ShardingEnv] = None):
    """The spec of every leaf of a reference-shaped parameter tree (dicts
    and lists of tensors, ``weights.to_reference``), by leaf-name rules;
    all replicated without an environment."""
    env = env or current_env()
    if env is None:
        return _map_with_path(lambda path, leaf: (), params)
    return _map_with_path(
        lambda path, leaf: _leaf_spec(path_str(path), tuple(leaf.shape), env),
        params)


def _coord(mesh, pos: int, axis: str) -> int:
    return (pos // mesh._stride(axis)) % mesh.shape[axis]


def _entry_index(mesh, pos: int, entry) -> Tuple[int, int]:
    """(index, count) of position ``pos`` along a spec entry's axes."""
    idx, n = 0, 1
    for a in _axes(entry):
        idx = idx * mesh.shape[a] + _coord(mesh, pos, a)
        n *= mesh.shape[a]
    return idx, n


def region(shape, spec: Spec, mesh, pos: int) -> Tuple[slice, ...]:
    """The block of a logical tensor of ``shape`` that position ``pos``
    holds under ``spec``."""
    out = []
    for i, d in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        idx, n = _entry_index(mesh, pos, entry)
        if d % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"over {n} positions ({entry})")
        c = d // n
        out.append(slice(idx * c, (idx + 1) * c))
    return tuple(out)


def replicas(spec: Spec, mesh, pos: int) -> Tuple[int, ...]:
    """The positions holding the same block as ``pos`` under ``spec``
    (those that differ from it only on axes the spec does not name), in
    mesh order."""
    used = {a for e in spec for a in _axes(e)}
    return tuple(q for q in range(len(mesh.devices))
                 if all(_coord(mesh, q, a) == _coord(mesh, pos, a)
                        for a in used))


class Sharded:
    """A logical tensor of ``shape`` placed on ``mesh`` by ``spec``:
    ``shards[p]`` is position p's block, on ``mesh.devices[p]``.  With
    ``partial`` (a gradient) each block is only that position's share of
    the work, and the logical tensor is their sum (``sum_regions``)."""

    def __init__(self, shards: Sequence[torch.Tensor], spec: Spec, shape,
                 mesh, partial: bool = False):
        self.shards = list(shards)
        self.spec = tuple(spec)
        self.shape = tuple(shape)
        self.mesh = mesh
        self.partial = partial

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def ndim(self):
        return len(self.shape)

    def __repr__(self):
        return (f"Sharded(shape={self.shape}, spec={self.spec}, "
                f"dtype={self.dtype}, positions={len(self.shards)})")


@dataclass(frozen=True)
class NamedSharding:
    """Where a leaf goes: ``mesh`` and ``spec`` (the reference's
    ``jax.sharding.NamedSharding``)."""
    mesh: object
    spec: Spec


def shard(t: torch.Tensor, spec: Spec, mesh) -> Sharded:
    """Cut the logical tensor ``t`` into every position's block, each a
    copy on the position's device (``t`` crosses to each distinct device
    once, and the blocks are cut there)."""
    on = {}
    out = []
    for p, dev in enumerate(mesh.devices):
        if dev not in on:
            on[dev] = t.to(dev)
        out.append(on[dev][region(t.shape, spec, mesh, p)].clone(
            memory_format=torch.contiguous_format))
    return Sharded(out, spec, t.shape, mesh)


def gather(st: Sharded, device=None) -> torch.Tensor:
    """The logical tensor of ``st`` on ``device`` (default: the first
    position's), each block read from the first position holding it."""
    if st.partial:
        raise ValueError("a partial Sharded is a sum: use sum_regions")
    device = st.mesh.devices[0] if device is None else torch.device(device)
    out = torch.empty(st.shape, dtype=st.dtype, device=device)
    seen = set()
    for p, t in enumerate(st.shards):
        reg = region(st.shape, st.spec, st.mesh, p)
        key = tuple((s.start, s.stop) for s in reg)
        if key not in seen:
            seen.add(key)
            out[reg] = t.to(device)
    return out


def data_sources(st: Sharded, pos: int):
    """(the dim, the positions) whose blocks make position ``pos``'s
    block of ``st`` under its spec with every axis but "model" dropped:
    for a leaf stored over the data axes (the reference's "fsdp") the
    positions that differ from ``pos`` only on those axes, in the order
    of their blocks along that dim; (None, (pos,)) when its own shard is
    its block."""
    mesh = st.mesh
    dims = [i for i, e in enumerate(st.spec)
            if any(a != "model" for a in _axes(e))]
    if not dims:
        return None, (pos,)
    if len(dims) > 1 or "model" in _axes(st.spec[dims[0]]):
        raise NotImplementedError(f"gathering spec {st.spec} over its "
                                  "non-model axes")
    d = dims[0]
    others = set(_axes(st.spec[d]))
    src = [q for q in range(len(mesh.devices))
           if all(_coord(mesh, q, a) == _coord(mesh, pos, a)
                  for a in mesh.axis_names if a not in others)]
    if len(src) == 1:            # the other axes have one position
        return None, (pos,)
    src.sort(key=lambda q: region(st.shape, st.spec, mesh, q)[d].start)
    return d, tuple(src)


def model_block(st: Sharded, pos: int, shards=None, site: str = "fsdp",
                row: bool = False, sources=None):
    """Position ``pos``'s block of ``st`` under its spec with every axis
    but "model" dropped: its own shard when the spec names no other axis;
    else (a leaf stored over the data axes, the reference's "fsdp") the
    blocks of the positions that differ from it on those axes
    (``data_sources``), sent to its device and concatenated in mesh
    order: the all-gather the reference's MoE makes of its expert
    weights.  ``shards`` (default ``st.shards``; by position) are the
    tensors to read, e.g. each position's leaf that requires grad; with
    ``row`` each is one row of a stacked leaf (a cycle's); ``sources``
    is ``data_sources(st, pos)`` when the caller has it."""
    from repro_torch.parallel import collectives as col
    shards = st.shards if shards is None else shards
    d, src = sources or data_sources(st, pos)
    if d is None:
        return shards[pos]
    return col.gather_blocks([shards[q] for q in src], src.index(pos),
                             st.mesh.devices[pos], d - 1 if row else d,
                             site, src)


def row_block(st: Sharded, pos: int, shards=None, site: str = "reshard"):
    """Position ``pos``'s row block (dim -2 split over "model") of a
    matrix (or a stack of them) stored in column blocks over "model"
    (spec (..., None, "model")):
    row block m of every position's column block, sent to ``pos`` and
    concatenated: the resharding the reference's ``row_parallel`` makes
    of a weight whose stored spec is not its ``("tp", None)``."""
    from repro_torch.parallel import collectives as col
    shards = st.shards if shards is None else shards
    mesh = st.mesh
    src = [q for q in range(len(mesh.devices))
           if all(_coord(mesh, q, a) == _coord(mesh, pos, a)
                  for a in mesh.axis_names if a != "model")]
    src.sort(key=lambda q: _coord(mesh, q, "model"))
    m, n = _coord(mesh, pos, "model"), mesh.shape["model"]
    rows = st.shape[-2] // n
    dev = mesh.devices[pos]
    pieces = [shards[q][..., m * rows:(m + 1) * rows, :] for q in src]
    return torch.cat([t if q == pos else col.send(t, dev, site, "all_to_all")
                      for q, t in zip(src, pieces)], -1)


def consumer_block(st: Sharded, path: str, pos: int, shards=None):
    """Position ``pos``'s block of the leaf at ``path`` as the layer that
    consumes it takes it: ``row_block`` for a ROW_CONSUMED leaf stored
    in column blocks over a model axis of more than one position; for a
    leaf stored over the data axes a
    :class:`~repro_torch.parallel.collectives.Stored` (its layer gathers
    it, ``model_block``, when it runs); else its own shard."""
    from repro_torch.parallel import collectives as col
    shards = st.shards if shards is None else shards
    if (ROW_CONSUMED.search(path) and st.spec[-2:] == (None, "model")
            and st.mesh.shape.get("model", 1) > 1):
        return row_block(st, pos, shards)
    sources = data_sources(st, pos)
    if sources[0] is not None:
        return col.Stored(st, pos, shards, sources)
    return shards[pos]


def cache_specs(cfg, env: ShardingEnv):
    """The reference's ``steps.cache_specs``: one spec per field of each
    layer's decode cache, in the port's segment/cycle nesting (the
    reference's stacked cycle axis is not there).  Attention and MLA
    caches are time-split over "seq_sp" (split-T), the RG-LRU state over
    "tp", the RWKV-6 state over "heads"."""
    from repro_torch.configs.base import ATTN, LOCAL, MLA, RGLRU, RWKV6
    from repro_torch.models import (attention, lm, mla, rglru, rwkv6)

    def kind_spec(kind):
        if kind in (ATTN, LOCAL):
            s = env.spec("batch", "seq_sp", None)
            return attention.AttnCache(k=s, v=s)
        if kind == MLA:
            s = env.spec("batch", "seq_sp", None)
            return mla.MLACache(ckv=s, k_rope=s)
        if kind == RGLRU:
            return rglru.RGLRUCache(h=env.spec("batch", "tp"),
                                    conv=env.spec("batch", None, "tp"))
        if kind == RWKV6:
            return rwkv6.RWKVCache(state=env.spec("batch", "heads", None,
                                                  None),
                                   x_tm=env.spec("batch", None),
                                   x_cm=env.spec("batch", None))
        raise ValueError(kind)
    return lm._nest(cfg, lambda kind, key: kind_spec(kind))


def sum_regions(parts: Sequence[torch.Tensor], shape, spec: Spec, mesh,
                device, dtype=torch.float32) -> torch.Tensor:
    """The logical tensor that is the sum, in mesh order, of every
    position's ``parts[p]`` placed at its block under ``spec`` (a
    gradient from each position's share of the work)."""
    out = torch.zeros(shape, dtype=dtype, device=device)
    for p, t in enumerate(parts):
        out[region(shape, spec, mesh, p)] += t.to(device, dtype)
    return out


# ---------------------------------------------------------------------------
# Layout autotuner (Swallow §II-B: pick the balanced design point)
# ---------------------------------------------------------------------------
def autotune_layout(cfg, shape=None, n_chips: Optional[int] = None,
                    mode: str = "circuit", serving: bool = False):
    """Pick the (data, model) mesh factorization the cost engine scores
    fastest for ``cfg`` at ``shape``.

    Returns ``(best, ranked)``: ``best.layout`` is the chosen
    :class:`~repro_torch.core.costs.Layout`, ``ranked`` every candidate,
    fastest first.  ``n_chips`` is the number of mesh positions to lay
    out; it defaults to the visible CUDA cards (1 without one).  Pure
    host-side arithmetic; the prices are the reference's TPU v5e-class
    model's, with its default link.  ``serving=True`` prices the paged-KV
    stripe traffic on top
    (:func:`~repro_torch.core.costs.rank_serving_layouts`)."""
    from repro_torch.core import costs as costs_mod
    if n_chips is None:
        n_chips = max(torch.cuda.device_count(), 1)
    rank = (costs_mod.rank_serving_layouts if serving
            else costs_mod.rank_layouts)
    ranked = rank(cfg, shape, n_chips, mode)
    return ranked[0], ranked


def make_layout_mesh(layout, devices=None):
    """Realise a :class:`~repro_torch.core.costs.Layout` as a
    :class:`~repro_torch.launch.mesh.DeviceMesh` over ``devices`` (see
    ``make_test_mesh``); None for the trivial single-chip layout."""
    from repro_torch.launch.mesh import make_test_mesh
    if layout.n_chips == 1:
        return None
    return make_test_mesh(layout.data, layout.model, layout.pod, devices)
