"""Elastic rescaling: restore a checkpoint onto a different mesh.

Reference: ``repro/runtime/elastic.py``.  Checkpoints store logical
arrays only (``runtime/checkpoint.py``), and every placement is derived
from (mesh, rules) at restore time, so moving from one mesh to another
after losing data rows is: build the new mesh, recompute the specs, cut
each leaf into the new positions' blocks.  The only constraint is the
global batch: ``rebatch`` keeps tokens per step constant by raising
gradient accumulation.
"""
from __future__ import annotations

from typing import Any, Tuple

from repro_torch import steps as steps_mod
from repro_torch.optim import adam as adam_lib
from repro_torch.optim.quant import QTensor
from repro_torch.parallel.sharding import (NamedSharding, ShardingEnv,
                                           param_specs, use_sharding)
from repro_torch.runtime import checkpoint as ckpt_lib


def _placed(spec_tree, mesh):
    """A spec tree with a NamedSharding at every spec."""
    if isinstance(spec_tree, QTensor):
        return spec_tree._replace(q=NamedSharding(mesh, spec_tree.q),
                                  scale=NamedSharding(mesh, spec_tree.scale))
    if isinstance(spec_tree, dict):
        return {k: _placed(v, mesh) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [_placed(v, mesh) for v in spec_tree]
    if isinstance(spec_tree, adam_lib.AdamState):
        return adam_lib.AdamState(*(_placed(v, mesh) for v in spec_tree))
    return NamedSharding(mesh, spec_tree)


def state_shardings(cfg, adam_cfg, env: ShardingEnv):
    """(the parameters' placements, the optimizer state's) on ``env``'s
    mesh: ``param_specs`` and ``adam.state_specs`` of the abstract state.
    Call it with ``env`` current (``use_sharding``)."""
    p_shape = steps_mod.abstract_params(cfg)
    p_spec = param_specs(p_shape, env)
    o_spec = adam_lib.state_specs(p_shape, adam_cfg, p_spec)
    return _placed(p_spec, env.mesh), _placed(o_spec, env.mesh)


def restore_elastic(ckpt_dir: str, cfg, adam_cfg, new_mesh,
                    rules=None) -> Tuple[int, Any, Any]:
    """Restore (step, params, opt_state) placed on ``new_mesh``: the
    reference-shaped parameter tree and the optimizer state with Sharded
    leaves.  One device's restore is ``checkpoint.restore``."""
    if new_mesh is None:
        raise ValueError("restore_elastic places a checkpoint on a mesh; "
                         "checkpoint.restore restores it on one device")
    with use_sharding(new_mesh, rules) as env:
        p_shape = steps_mod.abstract_params(cfg)
        o_shape = steps_mod.abstract_opt_state(cfg, adam_cfg, p_shape)
        p_shard, o_shard = state_shardings(cfg, adam_cfg, env)
        step, state = ckpt_lib.restore(
            ckpt_dir, {"params": p_shape, "opt": o_shape},
            shardings={"params": p_shard, "opt": o_shard})
    return step, state["params"], state["opt"]


def rebatch(global_batch: int, old_data: int, new_data: int,
            accum: int = 1) -> Tuple[int, int]:
    """Keep the *optimizer* batch (global_batch x accum) constant when the
    data axis changes: returns (per_step_batch, accum_steps).

    Policy: per-step batch must divide by the new data axis; any remainder
    of the optimizer batch is recovered by raising grad accumulation.
    """
    opt_tokens = global_batch * accum
    per = (global_batch // new_data) * new_data
    per = max(per, new_data)
    new_accum = max(1, round(opt_tokens / per))
    return per, new_accum


__all__ = ["restore_elastic", "state_shardings", "rebatch"]
