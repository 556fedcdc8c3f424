"""Step builders: the train step, prefill / serve steps, dense and
paged, and the paged engine's suffix prefill, chunk prefill, verify
window, fused speculative draft+verify and copy-on-write page copy, and
shape-only parameter and optimizer state.

Reference: ``repro/steps.py``.  The reference returns functions for
``jax.jit`` with the pools donated; PyTorch runs eagerly, so these are
plain callables and the pools (and the speculative history rows) are
updated in place.  The train step runs on the current sharding
environment's mesh, the dense prefill and serve steps on the mesh they
are given (each data group's rows on its model group, the caches
Sharded by ``sharding.cache_specs``).  ``make_state_structs``,
``make_batch_struct`` and ``make_decode_structs`` give a step's
arguments on a ``meta`` mesh (the dry run's, ``launch/dryrun.py``).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch import weights
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, lm, mla as mla_mod, modules as nn
from repro_torch.optim import adam as adam_lib
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import (Sharded, _axis_size,
                                           cache_specs, current_env, shard,
                                           use_sharding)

def check_mesh(cfg: ModelConfig, mesh, env=None):
    """Refuse a model axis that does not divide what it splits, as the
    reference's ``shard_map`` specs do: the heads of MLA and RWKV-6, the
    attention's q columns (a head count it does not divide is split by
    columns, ``attention._apply_tp``), the FFN width, the RG-LRU lanes,
    and each expert's FFN width under expert-TP or the expert count
    under EP (``env``'s rules)."""
    if mesh is None:
        return
    tp = mesh.shape.get("model", 1)
    if tp == 1:
        return
    kinds = set(cfg.layer_kinds)
    need = [("d_ff", cfg.d_ff)]
    if kinds & {"mla", "rwkv6"}:
        need.append(("n_heads", cfg.n_heads))
    if kinds & {"attn", "local"}:
        need.append(("n_heads * head_dim", cfg.n_heads * cfg.head_dim))
    if "rglru" in kinds:
        need.append(("lru_width", cfg.lru_width or cfg.d_model))
    if cfg.moe is not None:
        ep = env is not None and env.resolve("expert") is not None
        need.append(("n_experts", cfg.moe.n_experts) if ep else
                    ("d_ff_expert", cfg.moe.d_ff_expert))
    for what, n in need:
        if n % tp:
            raise NotImplementedError(
                f"{cfg.name}: {what}={n} does not split over a model "
                f"axis of {tp}")


def batch_specs(cfg: ModelConfig, env):
    """The specs the reference gives a batch's leaves: the batch dim over
    the ("pod", "data") axes."""
    tok = env.spec("batch", None) if cfg.embed_inputs \
        else env.spec("batch", None, None)
    b = {"tokens": tok, "labels": env.spec("batch", None),
         "mask": env.spec("batch", None)}
    if cfg.mrope_sections is not None:
        b["positions"] = env.spec(None, "batch", None)
    return b


def _group_batch(batch, specs, n_groups, g, device):
    """Data group ``g``'s rows of every batch leaf, on ``device``."""
    out = {}
    for k, v in batch.items():
        dim = next((i for i, e in enumerate(specs.get(k, ())) if e), None)
        out[k] = (v if dim is None else v.chunk(n_groups, dim)[g]).to(device)
    return out


def mesh_loss_and_grads(cfg: ModelConfig, params, batch,
                        groups_run: Optional[int] = None):
    """The loss of a batch on the current mesh and each leaf's gradient:
    every data group in turn (one group's activations alive at a time)
    runs its rows' forward and backward on its model group.  Its share
    of the loss is its NLL sum over the WHOLE batch's mask count (the
    reference's ``_chunk_ce`` sums both over the batch axes), its MoE
    load-balance loss over the number of groups (the reference's
    ``pmean`` over the batch axes; the capacity is the group's tokens')
    and its MTP NLL sum over the whole batch's MTP mask count.
    ``params`` is the reference-shaped tree of Sharded leaves; a leaf
    stored over the data axes (the MoE's "fsdp") is gathered for each
    group and its gradient comes back to every position holding a block
    of it.  Returns (metrics, gradients: a tree of partial Sharded
    leaves, each position's share).

    ``groups_run`` (at least 1) runs only the first that many data
    groups, as the dry run does (``launch/dryrun.py``: every group has
    the same shapes): the metrics are then theirs, and a position none
    of them reached has no gradient (None in its leaves' shards)."""
    env = current_env()
    mesh = env.mesh
    groups = col.model_groups(mesh)
    specs = batch_specs(cfg, env)
    B, S = batch["labels"].shape
    if B % len(groups) or S % groups[0].size:
        raise ValueError(
            f"a batch of {B} x {S} does not split over {len(groups)} data "
            f"groups (rows) and {groups[0].size} model positions (sequence)")
    leaves = weights.tree_leaves(params)
    n_pos = len(mesh.devices)
    mine = [[l.shards[p].detach().requires_grad_() for p in range(n_pos)]
            for l in leaves]
    flat = [t for ts in mine for t in ts]
    root = groups[0].root
    cnt = batch["mask"].sum().to(root)
    mtp_cnt = batch["mask"][:, 1:].sum().to(root)
    coef = cfg.moe.aux_loss_coef if cfg.moe is not None else 0.0
    grads = [None] * len(flat)
    tot = {}
    for g, group in enumerate(groups[:groups_run]):
        rows = _group_batch(batch, specs, len(groups), g, group.root)
        with torch.enable_grad():
            view = weights.group_params(params, group, cfg, mine)
            out = lm.loss_sums(view, cfg, rows,
                               group=group if group.size > 1 else None)
            obj = out["tot"] / cnt.to(out["tot"].device)
            if cfg.moe is not None:
                obj = obj + coef * out["aux"].to(obj.device) / len(groups)
            if "mtp_tot" in out:
                obj = obj + 0.3 * out["mtp_tot"].to(obj.device) \
                    / mtp_cnt.to(obj.device)
            gs = torch.autograd.grad(obj, flat, allow_unused=True)
        grads = [a if b is None else b if a is None else a + b
                 for a, b in zip(grads, gs)]
        for k, v in out.items():
            v = v.detach().to(root)
            tot[k] = v if k not in tot else tot[k] + v
        del view, out, gs, obj, v
    ce = tot["tot"] / torch.clamp(cnt, min=1.0)
    aux = tot["aux"] / len(groups)
    metrics = {"ce": ce, "moe_aux": aux}
    loss = ce + coef * aux if cfg.moe is not None else ce
    if "mtp_tot" in tot:
        metrics["mtp_ce"] = tot["mtp_tot"] / torch.clamp(mtp_cnt, min=1.0)
        loss = loss + 0.3 * metrics["mtp_ce"]
    metrics["loss"] = loss
    out = []
    for i, l in enumerate(leaves):
        gi = grads[i * n_pos:(i + 1) * n_pos]
        out.append(Sharded([torch.zeros_like(l.shards[p])
                            if t is None and groups_run is None else t
                            for p, t in enumerate(gi)],
                           l.spec, l.shape, mesh, partial=True))
    return metrics, weights.tree_unflatten(params, out)


def apply_update(params, opt_state, grads, metrics,
                 adam_cfg: adam_lib.AdamConfig, schedule=None):
    """The optimizer's half of a mesh train step: ``adam.update`` (the
    ZeRO-1 step) of the gradients of ``mesh_loss_and_grads`` at ``lr =
    schedule(opt_state.step)``; (params, opt_state, metrics)."""
    lr = (schedule or (lambda s: 3e-4))(opt_state.step)
    new, opt_state2, om = adam_lib.update(grads, opt_state, params, lr=lr,
                                          cfg=adam_cfg)
    metrics.update(om)
    metrics["lr"] = lr
    return new, opt_state2, metrics


def make_train_step(cfg: ModelConfig, adam_cfg: adam_lib.AdamConfig,
                    schedule=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``params`` is the port's nesting; the gradient is taken with respect
    to the reference's tree (``weights.to_reference``), whose stacked
    leaves the optimizer updates, and the new parameters come back as
    views of the new stacked leaves (``weights.unstack``).  ``lr =
    schedule(opt_state.step)`` is read before the step is counted, as in
    the reference.  The old optimizer state is consumed by the update
    (``adam.update``): the caller must not read it again.

    Under a sharding environment (``use_sharding(mesh)``) the step runs
    on the mesh: ``params`` is the reference-shaped tree of Sharded
    leaves (``weights.shard_params``), the batch is split over the
    ("pod", "data") axes (``batch_specs``), ``mesh_loss_and_grads`` takes
    the loss and the gradients and ``adam.update`` the ZeRO-1 step; the
    metrics are the whole batch's."""
    schedule = schedule or (lambda s: 3e-4)

    def mesh_step(params, opt_state, batch):
        metrics, grads = mesh_loss_and_grads(cfg, params, batch)
        return apply_update(params, opt_state, grads, metrics, adam_cfg,
                            schedule)

    def train_step(params, opt_state, batch):
        if current_env() is not None:
            check_mesh(cfg, current_env().mesh, current_env())
            return mesh_step(params, opt_state, batch)
        tree = weights.to_reference(params, cfg)
        leaves = [l.detach().requires_grad_() for l in
                  weights.tree_leaves(tree)]
        with torch.enable_grad():
            loss, metrics = lm.loss_fn(
                weights.unstack(weights.tree_unflatten(tree, leaves), cfg),
                cfg, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(l) if g is None else g
                 for l, g in zip(leaves, grads)]
        leaves = [l.detach() for l in leaves]
        lr = schedule(opt_state.step)
        new, opt_state2, om = adam_lib.update(
            weights.tree_unflatten(tree, grads), opt_state,
            weights.tree_unflatten(tree, leaves), lr=lr, cfg=adam_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(om)
        metrics["lr"] = lr
        return weights.unstack(new, cfg), opt_state2, metrics

    return train_step


def adam_config_for(cfg: ModelConfig) -> adam_lib.AdamConfig:
    return adam_lib.AdamConfig(state_dtype=cfg.opt_state_dtype)


def abstract_params(cfg: ModelConfig):
    """The reference-shaped parameter tree on the ``meta`` device: shapes
    and dtypes, no storage."""
    return weights.to_reference(weights.init_params(cfg, device="meta"),
                                cfg)


def abstract_opt_state(cfg: ModelConfig, adam_cfg: adam_lib.AdamConfig,
                       params_shape):
    """The optimizer state of ``params_shape`` (``abstract_params``) on
    the ``meta`` device."""
    return adam_lib.init(params_shape, adam_cfg)


def with_shardings(tree, spec_tree, mesh):
    """Each tensor of ``tree`` placed on ``mesh`` by its spec in
    ``spec_tree`` (the same nesting): a Sharded of its blocks, as the
    reference attaches a NamedSharding to each ShapeDtypeStruct."""
    if isinstance(tree, torch.Tensor):
        return shard(tree, spec_tree, mesh)
    if isinstance(tree, dict):
        return {k: with_shardings(v, spec_tree[k], mesh)
                for k, v in tree.items()}
    items = [with_shardings(v, sp, mesh) for v, sp in zip(tree, spec_tree)]
    if isinstance(tree, list):
        return items
    return type(tree)(*items) if hasattr(tree, "_fields") \
        else type(tree)(items)


def make_state_structs(cfg: ModelConfig, adam_cfg, mesh, env):
    """(params, opt_state) on ``mesh`` (a meta mesh: no storage): the
    reference-shaped Sharded parameter tree by ``env``'s parameter specs
    and its ZeRO-1 optimizer state."""
    with _mesh_env(mesh):
        params = weights.shard_params(
            weights.init_params(cfg, device=mesh.devices[0]), cfg, mesh)
        return params, adam_lib.init(params, adam_cfg)


def make_batch_struct(cfg: ModelConfig, shape, mesh, env):
    """A train or prefill step's batch of ``shape`` on the mesh's first
    device, whole: the step splits it over the data groups
    (``batch_specs``)."""
    B, S = shape.global_batch, shape.seq_len
    dev = mesh.devices[0]
    tok = torch.empty((B, S), dtype=torch.int32, device=dev) \
        if cfg.embed_inputs else torch.empty(
            (B, S, cfg.d_model), dtype=nn.dt(cfg.activation_dtype), device=dev)
    batch = {"tokens": tok,
             "labels": torch.empty((B, S), dtype=torch.int32, device=dev),
             "mask": torch.empty((B, S), dtype=torch.float32, device=dev)}
    if cfg.mrope_sections is not None:
        batch["positions"] = torch.empty((3, B, S), dtype=torch.int32,
                                         device=dev)
    return batch


def decode_cache_specs(cfg: ModelConfig, env, max_len: int):
    """``sharding.cache_specs``, with the time dim whole where the model
    group does not divide ``max_len`` (``_sharded_caches``)."""
    tp = _axis_size(env, env.resolve("seq_sp"))

    def fix(c):
        if isinstance(c, (attention.AttnCache, mla_mod.MLACache)) \
                and max_len % tp:
            return type(c)(*[(sp[0], None) + tuple(sp[2:]) for sp in c])
        return c
    return _map_caches(fix, cache_specs(cfg, env))


def make_decode_structs(cfg: ModelConfig, shape, mesh, env):
    """(tokens, caches, pos) of a serve step on ``mesh``: the tokens of
    ``shape.global_batch`` sequences on the first device, each layer's
    cache of ``shape.seq_len`` slots Sharded by
    ``sharding.cache_specs``, and ``pos`` the last slot (the reference's
    traced ``pos`` makes its program read the whole cache)."""
    B, T = shape.global_batch, shape.seq_len
    dev = mesh.devices[0]
    tok = torch.empty((B, 1), dtype=torch.int32, device=dev) \
        if cfg.embed_inputs else torch.empty(
            (B, 1, cfg.d_model), dtype=nn.dt(cfg.activation_dtype), device=dev)
    caches = with_shardings(lm.init_caches(cfg, B, T, dev),
                            decode_cache_specs(cfg, env, T), mesh)
    return tok, caches, T - 1


def _mesh_env(mesh):
    """The current sharding environment when it is ``mesh``'s (its rules
    kept), else ``mesh`` under the default rules."""
    env = current_env()
    if env is not None and env.mesh is mesh:
        return contextlib.nullcontext(env)
    return use_sharding(mesh)


class _GroupViews:
    """Each model group's parameter view (``weights.group_params``) of the
    last Sharded tree seen, built when the group first runs on it: a
    decode step reuses them."""

    def __init__(self, cfg, mesh):
        self.cfg, self.groups = cfg, col.model_groups(mesh)
        self.params, self.views = None, None

    def __call__(self, params, g: int):
        if params is not self.params:
            self.params, self.views = params, [None] * len(self.groups)
        if self.views[g] is None:
            self.views[g] = weights.group_params(params, self.groups[g],
                                                 self.cfg)
        return self.views[g]


def _caches_of_group(caches, group):
    """The caches of ``group``'s positions in the mesh's Sharded cache
    nesting: one cache a layer on a one-position group, else each
    position's (``attention.TimeShards`` for a time-split attention or
    MLA cache)."""
    def one(c):
        per = [type(c)(*[f.shards[p] for f in c]) for p in group.positions]
        if group.size == 1:
            return per[0]
        split = isinstance(c, (attention.AttnCache, mla_mod.MLACache)) \
            and c[0].spec[1] is not None
        return (attention.TimeShards if split else col.PerPos)(per)
    return _map_caches(one, caches)


def _map_caches(fn, caches):
    return [[tuple(fn(c) for c in cyc) for cyc in seg] for seg in caches]


def _sharded_caches(cfg, per_group, groups, env):
    """The mesh's cache nesting of each data group's caches: every field
    a Sharded by ``sharding.cache_specs``, whose time dim is whole when
    the caches are (a length the model group does not divide)."""
    mesh = env.mesh
    specs = cache_specs(cfg, env)
    out = []
    for si, seg in enumerate(specs):
        cycles = []
        for ci, cyc in enumerate(seg):
            layer = []
            for j, spec_c in enumerate(cyc):
                blocks = [per_group[g][si][ci][j] for g in range(len(groups))]
                if groups[0].size == 1:
                    blocks = [[b] for b in blocks]
                split = isinstance(blocks[0], attention.TimeShards)
                fields = []
                for f, spec in enumerate(spec_c):
                    if isinstance(spec_c, (attention.AttnCache,
                                           mla_mod.MLACache)) and not split:
                        spec = (spec[0], None) + tuple(spec[2:])
                    shards = [None] * len(mesh.devices)
                    for g, group in enumerate(groups):
                        for m, p in enumerate(group.positions):
                            shards[p] = blocks[g][m][f]
                    blk = shards[0].shape
                    shape = [d * _axis_size(env, e) for d, e in zip(
                        blk, tuple(spec) + (None,) * (len(blk) - len(spec)))]
                    fields.append(Sharded(shards, spec, shape, mesh))
                layer.append(type(spec_c)(*fields))
            cycles.append(tuple(layer))
        out.append(cycles)
    return out


def _data_rows(t, n_groups, g, device, env):
    """Data group g's rows of t, or all of them where the batch is not
    split (a batch rule of None: a batch of one sequence)."""
    if env.resolve("batch") is None:
        return t.to(device)
    return t.chunk(n_groups, 0)[g].to(device)


def _mesh_logits(logits, env):
    """The data groups' logits as the step's: their rows in order, or
    the first group's where the batch is not split (every group ran the
    same rows)."""
    return torch.cat(logits, 0) if env.resolve("batch") is not None \
        else logits[0]


def make_prefill_step(cfg: ModelConfig, max_len: int, mesh=None,
                      groups_run: Optional[int] = None):
    """(params, tokens (B,S)) -> (next-token logits (B,1,V), caches).

    With ``mesh`` (the dense engine on a device mesh) ``params`` is the
    reference-shaped tree of Sharded leaves (``weights.shard_params``),
    the batch rows split over the data groups, each group's prefill runs
    on its model group (``lm.prefill(group=)``), the logits come back to
    the mesh's first device and the caches are Sharded by
    ``sharding.cache_specs`` (split-T attention and MLA caches).  Where
    the rules leave the batch unsplit (a batch rule of None) every group
    runs all the rows, and the logits are the first group's.
    ``groups_run`` runs only the first that many data groups (the dry
    run's, as ``mesh_loss_and_grads``): the logits are their rows and
    the caches' other positions hold None."""
    if mesh is None:
        def prefill_step(params, tokens):
            return lm.prefill(params, cfg, tokens, max_len=max_len)
        return prefill_step
    views = _GroupViews(cfg, mesh)

    def prefill_mesh(params, tokens):
        groups = views.groups
        with _mesh_env(mesh) as env:
            if tokens.shape[0] % len(groups) and \
                    env.resolve("batch") is not None:
                raise ValueError(f"a batch of {tokens.shape[0]} does not "
                                 f"split over {len(groups)} data groups")
            check_mesh(cfg, mesh, env)
            logits, caches = [], []
            run = groups[:groups_run]
            for g, group in enumerate(run):
                lg, c = lm.prefill(
                    views(params, g), cfg,
                    _data_rows(tokens, len(groups), g, group.root, env),
                    max_len=max_len, group=group if group.size > 1 else None)
                logits.append(lg.to(mesh.devices[0]))
                caches.append(c)
            return _mesh_logits(logits, env), _sharded_caches(cfg, caches,
                                                              run, env)
    return prefill_mesh


def make_serve_step(cfg: ModelConfig, mesh=None,
                    groups_run: Optional[int] = None):
    """One decode step: greedy-sample next token given the KV cache.
    (params, tokens (B,1), caches, pos) -> (tokens (B,1), logits, caches).
    With ``mesh`` each data group's rows step on its model group against
    its positions' caches (``make_prefill_step``'s, and its
    ``groups_run``)."""
    def greedy(logits):
        return logits.argmax(-1).to(torch.int32)
    if mesh is None:
        def serve_step(params, tokens, caches, pos):
            logits, caches = lm.decode_step(params, cfg, tokens, caches, pos)
            return greedy(logits), logits, caches
        return serve_step
    views = _GroupViews(cfg, mesh)

    def serve_mesh(params, tokens, caches, pos):
        groups = views.groups
        with _mesh_env(mesh) as env:
            logits, new = [], []
            run = groups[:groups_run]
            for g, group in enumerate(run):
                lg, c = lm.decode_step(
                    views(params, g), cfg,
                    _data_rows(tokens, len(groups), g, group.root, env),
                    _caches_of_group(caches, group), pos,
                    group=group if group.size > 1 else None)
                logits.append(lg.to(mesh.devices[0]))
                new.append(c)
            logits = _mesh_logits(logits, env)
            return greedy(logits), logits, _sharded_caches(cfg, new, run,
                                                           env)
    return serve_mesh


def make_paged_prefill_step(cfg: ModelConfig):
    """Prefill ONE sequence straight into the paged KV pools.

    (params, tokens (1,S), pools, block_row (nmax,)) ->
    (next-token logits (1,1,V), pools updated in place)."""
    def prefill_paged(params, tokens, pools, block_row):
        x, pending, raw = lm.forward(params, cfg, tokens)
        pools = lm.paged_from_prefill(cfg, pools, raw, block_row)
        return lm.last_logits(params, cfg, x, pending), pools
    return prefill_paged


def make_paged_serve_step(cfg: ModelConfig):
    """One continuous-batch paged decode step (greedy sampling).

    (params, tokens (B,1), pools, block_tables (B,nmax), pos (B,)) ->
    (next tokens (B,1), logits, pools)."""
    def serve_paged(params, tokens, pools, block_tables, pos):
        logits, pools = lm.decode_step_paged(params, cfg, tokens, pools,
                                             block_tables, pos)
        return logits.argmax(-1).to(torch.int32), logits, pools
    return serve_paged


def make_paged_serve_scan(cfg: ModelConfig):
    """Fused K-step paged decode window (device-resident serving).

    (params, tokens (B,1), pools, block_tables (B,nmax), pos (B,),
     active (B,), k) -> (emitted (B,K), last tokens (B,1), pos (B,),
    pools).  One call and one host sync cover K decode steps."""
    def serve_scan(params, tokens, pools, block_tables, pos, active, *,
                   k: int):
        return lm.decode_window_paged(params, cfg, tokens, pools,
                                      block_tables, pos, active, k)
    return serve_scan


def make_paged_suffix_prefill(cfg: ModelConfig):
    """Batched suffix prefill for prefix-cache hits.

    (params, tokens (1,W) padded suffix ids, pools, block_row (nmax,),
     start, n_valid) -> (first-token logits (1,1,V), pools).  Only the
    uncached suffix runs through the model, in one pass, attending the
    shared-prefix KV through the block row; the engine buckets W to
    powers of two."""
    def suffix_prefill(params, tokens, pools, block_row, start, n_valid):
        return lm.prefill_suffix_paged(params, cfg, tokens, pools,
                                       block_row, start, n_valid)
    return suffix_prefill


def make_chunk_prefill(cfg: ModelConfig):
    """One page-aligned prefill chunk for a prefilling slot.

    (params, tokens (1,W) padded chunk ids, pools, block_row (nmax,),
     start, n_valid) -> (last-position logits (1,1,V), pools).  The chunk
    is a suffix continuation at ``start`` (``lm.chunk_prefill_paged``),
    so composed chunks write the KV one monolithic pass would, and only
    the final chunk's logits are read."""
    def chunk_prefill(params, tokens, pools, block_row, start, n_valid):
        return lm.chunk_prefill_paged(params, cfg, tokens, pools,
                                      block_row, start, n_valid)
    return chunk_prefill


def make_verify_window(cfg: ModelConfig):
    """Speculative-decoding verification window (one sequence, one pass).

    (params, tokens (1,W) [last token + K padded drafts], pools,
     block_row (nmax,), start, n_valid) -> (logits (1,W,V) at every
    position, pools)."""
    def verify_window(params, tokens, pools, block_row, start, n_valid):
        return lm.verify_window_paged(params, cfg, tokens, pools,
                                      block_row, start, n_valid)
    return verify_window


def make_spec_draft_verify(cfg: ModelConfig):
    """Fused speculative draft+verify for ONE slot, on the device.

    (params, history (B,H) device token-history rows, pools,
     block_tables (B,nmax), slot, start, k, *, W, max_n, min_n) ->
    (emitted (W,), n_emit, m, history, pools).  ``slot``, ``start`` and
    ``k`` are 0-d int32 device tensors, so nothing here waits for the
    host; ``W`` (the pow2 verify width) and the n-gram bounds are ints.

    The chain:

    1. ``device_propose`` suffix-matches the slot's history row
       (``hist_len = start + 1``: ``start`` is the next KV write
       position) for a draft of up to ``min(k, W-1)`` tokens;
    2. ``verify_window_paged`` scores last token + draft (``n_valid =
       m+1`` positions) against the paged KV in one model pass;
    3. the greedy acceptance rule keeps the longest matching prefix and
       appends the verifier's bonus/correction token — ``emitted[:n_emit]``
       is exactly what non-speculative greedy decode would emit;
    4. the emission is appended to the slot's history row in place.

    The caller pulls ``(emitted, n_emit, m)`` to the host once per
    verify."""
    from repro_torch.serving.spec_decode import device_propose

    def draft_verify(params, history, pools, block_tables, slot, start, k,
                     *, W: int, max_n: int, min_n: int):
        i32 = torch.int32
        dev = history.device
        H = history.shape[-1]
        sl = slot.reshape(1).long()
        row = history.index_select(0, sl)[0]
        block_row = block_tables.index_select(0, sl)[0]
        hist_len = start.to(i32) + 1
        draft, m = device_propose(row, hist_len, k, k_max=W - 1,
                                  max_n=max_n, min_n=min_n)
        last = row.index_select(
            0, torch.clamp(hist_len - 1, 0, H - 1).reshape(1).long())
        tokens = torch.cat([last, draft])[None]                  # (1, W)
        logits, pools = lm.verify_window_paged(params, cfg, tokens, pools,
                                               block_row, start, m + 1)
        greedy = logits[0].argmax(-1).to(i32)                    # (W,)
        offs = torch.arange(W, dtype=i32, device=dev)
        draft_w = torch.cat([draft, draft.new_zeros(1)])
        ok = (offs < m) & (greedy == draft_w)
        a = torch.cumprod(ok.to(i32), 0).sum().to(i32)  # accepted prefix
        bonus = greedy.index_select(0, a.reshape(1).long())  # correction
        emitted = torch.where(offs < a, draft_w, 0)
        emitted = torch.where(offs == a, bonus, emitted).to(i32)
        n_emit = a + 1
        # append the emission to the history row: positions hist_len ..
        # hist_len+n_emit-1 take emitted[0..n_emit-1]
        rel = torch.arange(H, dtype=i32, device=dev) - hist_len
        src = emitted[torch.clamp(rel, 0, W - 1).long()]
        new_row = torch.where((rel >= 0) & (rel < n_emit), src, row)
        history.index_copy_(0, sl, new_row[None])
        return emitted, n_emit, m, history, pools
    return draft_verify


def _pools(tree):
    """The per-layer pools of a pool nesting (plain or striped)."""
    if isinstance(tree, (attention.PagedAttnCache,
                         attention.StripedPagedCache)):
        yield tree
    else:
        for t in tree:
            yield from _pools(t)


def make_page_copy():
    """Copy-on-write: duplicate one physical page in every layer's k/v
    pool, in place.

    (pools, src, dst) -> pools with page ``dst`` := page ``src``
    everywhere.  The whole page is copied: slots past the shared fill
    point hold stale values the diverging request overwrites before its
    position ever reaches them.  In a striped pool each page is found on
    its stripe, and a copy between two stripes crosses devices when they
    are on different ones."""
    def copy_page(pools, src: int, dst: int):
        for pool in _pools(pools):
            if isinstance(pool, attention.StripedPagedCache):
                L = pool.rows
                for stripes in (pool.k, pool.v):
                    stripes[dst // L][dst % L] = \
                        stripes[src // L][src % L].to(stripes[dst // L].device)
            else:
                for a in pool:
                    a[dst] = a[src]
        return pools
    return copy_page
