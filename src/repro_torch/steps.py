"""Step builders: the train step, prefill / serve steps, dense and
paged, and the paged engine's suffix prefill, chunk prefill, verify
window, fused speculative draft+verify and copy-on-write page copy, and
shape-only parameter and optimizer state.

Reference: ``repro/steps.py``.  The reference returns functions for
``jax.jit`` with the pools donated; PyTorch runs eagerly, so these are
plain callables and the pools (and the speculative history rows) are
updated in place.
"""
from __future__ import annotations

import torch

from repro_torch import weights
from repro_torch.configs.base import ATTN, LOCAL, ModelConfig
from repro_torch.models import attention, lm
from repro_torch.optim import adam as adam_lib
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import Sharded, current_env


MESH_ITEM = "ROADMAP.md Queue A item 16"


def check_mesh(cfg: ModelConfig, mesh):
    """Refuse what the mesh trainer does not run, naming the ROADMAP item
    that holds it: MoE on any mesh (the reference's MoE averages each
    data shard's aux loss and sizes capacity from the local tokens), and
    a "model" axis over anything but GQA attention with a dense FFN."""
    if mesh is None:
        return
    tp = mesh.shape.get("model", 1)
    odd = sorted({k for k in cfg.layer_kinds if k not in (ATTN, LOCAL)})
    if tp > 1 and odd:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(odd)} layers on a model axis of {tp} "
            f"are not ported ({MESH_ITEM}); train it on a data-only mesh")
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: MoE training on a mesh is not ported ({MESH_ITEM},"
            " with the sharded MoE of item 7); train it on one device")
    if tp > 1:
        for what, n in (("n_heads", cfg.n_heads), ("d_ff", cfg.d_ff)):
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


def model_groups(mesh):
    """The model groups of a mesh (a :class:`collectives.Group` for each
    index of the other axes, in mesh order: the order of the batch's
    row blocks)."""
    if "model" in mesh.axis_names:
        groups = mesh.axis_groups("model")
    else:
        groups = [(p,) for p in range(len(mesh.devices))]
    return [col.Group(g, tuple(mesh.devices[p] for p in g)) for g in groups]


def _group_batch(batch, specs, n_groups, g, device):
    """Data group ``g``'s rows of every batch leaf, on ``device``."""
    out = {}
    for k, v in batch.items():
        dim = next((i for i, e in enumerate(specs.get(k, ())) if e), None)
        out[k] = (v if dim is None else v.chunk(n_groups, dim)[g]).to(device)
    return out


def mesh_loss_and_grads(cfg: ModelConfig, params, batch):
    """The loss of a batch on the current mesh and each leaf's gradient:
    every data group in turn (one group's activations alive at a time)
    runs its rows' forward and backward on its model group, its loss the
    group's NLL sum over the WHOLE batch's mask count (the reference's
    ``_chunk_ce`` sums both over the batch axes).  ``params`` is the
    reference-shaped tree of Sharded leaves; returns (metrics, gradients:
    a tree of partial Sharded leaves, each position's share)."""
    env = current_env()
    mesh = env.mesh
    groups = model_groups(mesh)
    specs = batch_specs(cfg, env)
    B, S = batch["labels"].shape
    if B % len(groups) or S % groups[0].size:
        raise ValueError(
            f"a batch of {B} x {S} does not split over {len(groups)} data "
            f"groups (rows) and {groups[0].size} model positions (sequence)")
    leaves = weights.tree_leaves(params)
    cnt = batch["mask"].sum().to(groups[0].root)
    grads = [[None] * len(mesh.devices) for _ in leaves]
    tot = None
    for g, group in enumerate(groups):
        rows = _group_batch(batch, specs, len(groups), g, group.root)
        mine = {p: [l.shards[p].detach().requires_grad_() for l in leaves]
                for p in group.positions}
        trees = [weights.unstack(weights.tree_unflatten(params, mine[p]),
                                 cfg) for p in group.positions]
        with torch.enable_grad():
            if group.size == 1:
                t, _ = lm.loss_sums(trees[0], cfg, rows)
            else:
                t, _ = lm.loss_sums(weights.group_view(trees), cfg, rows,
                                    group=group)
            flat = [x for p in group.positions for x in mine[p]]
            gs = torch.autograd.grad(t / cnt.to(t.device), flat,
                                     allow_unused=True)
        for j, p in enumerate(group.positions):
            for i, l in enumerate(leaves):
                gi = gs[j * len(leaves) + i]
                grads[i][p] = torch.zeros_like(l.shards[p]) if gi is None \
                    else gi
        t = t.detach().to(groups[0].root)
        tot = t if tot is None else tot + t
        del mine, trees, gs, flat
    ce = tot / torch.clamp(cnt, min=1.0)
    metrics = {"ce": ce, "moe_aux": torch.zeros_like(ce), "loss": ce}
    return metrics, weights.tree_unflatten(params, [
        Sharded(g, l.spec, l.shape, mesh, partial=True)
        for g, l in zip(grads, leaves)])


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
    leaves (``weights.shard_tree``), the batch is split over the
    ("pod", "data") axes (``batch_specs``), ``mesh_loss_and_grads`` takes
    the loss and the gradients and ``adam.update`` the ZeRO-1 step; the
    metrics are the whole batch's."""
    schedule = schedule or (lambda s: 3e-4)

    def mesh_step(params, opt_state, batch):
        metrics, grads = mesh_loss_and_grads(cfg, params, batch)
        lr = schedule(opt_state.step)
        new, opt_state2, om = adam_lib.update(grads, opt_state, params,
                                              lr=lr, cfg=adam_cfg)
        metrics.update(om)
        metrics["lr"] = lr
        return new, opt_state2, metrics

    def train_step(params, opt_state, batch):
        if current_env() is not None:
            check_mesh(cfg, current_env().mesh)
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


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, tokens):
        return lm.prefill(params, cfg, tokens, max_len=max_len)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: greedy-sample next token given the KV cache."""
    def serve_step(params, tokens, caches, pos):
        logits, caches = lm.decode_step(params, cfg, tokens, caches, pos)
        return logits.argmax(-1).to(torch.int32), logits, caches
    return serve_step


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
