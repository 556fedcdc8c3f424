"""Logical-axis sharding rules and the layout autotuner, host-only.

Reference: ``repro/parallel/sharding.py``.  A rule table maps logical
axis names to the axes of a mesh (here the port's
:class:`~repro_torch.launch.mesh.DeviceMesh`); ``use_sharding`` makes a
mesh and its rules the current environment, which placement code reads
through ``current_env``.  The rule tables and ``resolve`` are the
reference's.  What the reference builds on them for jax
(``NamedSharding``, ``PartitionSpec``, ``shard_map``) has no counterpart
here: the port's one user of a mesh, the paged engine's striped pools,
places its stripes itself (``models/attention.py``).
"""
from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple, Union

import torch

Axis = Union[str, Tuple[str, ...], None]

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
