"""Mixture-of-Experts FFN on one device: top-k routing, fixed-capacity
dispatch, a grouped GEMM per expert group.

Reference: ``repro/models/moe.py`` (``route``, ``capacity``,
``dispatch_indices``, ``_group_count``, ``local_moe`` and the
single-device branch of ``apply``).  The reference's ``lax.scan`` over
expert groups is a Python loop.  Its three grouped einsums
(``preferred_element_type=float32``) run through the ``moe_gemm`` kernel
under ``impl == "pallas"`` and otherwise as the reference's product
(``modules.matmul``: the card's tensor cores for bf16 operands, the
promoted fp32 product elsewhere); all keep the reference's fp32 between
the GEMMs.  The weighted expert rows are combined in the reference's
order: each token adds its slot rows in ascending slot order, which is
the order of the reference's ``at[].add`` scatter, so the sum does not
depend on how the card schedules it (``local_moe``).

On a model group (``x`` Shards: the dense engine's mesh and the mesh
trainer) ``apply`` is the reference's ``_sharded_moe``: each
position's expert blocks stored over the data axes are all-gathered
(the layer's own, when it runs), the sequence is all-gathered, every
position routes every token (as every shard of the reference does),
and each position's expert products run on its block
of the experts through the same grouped GEMMs: under expert-TP (the
default rules) an ``expert_ff`` slice of every expert, whose partial
outputs are reduce-scattered back to the sequence-split residual (summed
on every position when the sequence is not split); under EP (rules
``{"expert": "model", "expert_ff": None}``) ``E/n`` whole experts,
assignments to other positions' experts falling in the drop bucket
(``_local_moe_ep``), at the same global capacity.  Capacity comes from
the tokens one data group sees; the load-balance loss is each
position's, and the mesh's train step averages it over the data groups
(the reference's ``pmean`` over the batch axes).  Under the paged
engine's mesh (``SERVING_RULES``) nothing of the MoE is split and this
is the single-device function.

JAX's ``mode="drop"`` scatters have no torch counterpart (an index out of
range raises), so every scatter here writes into a buffer one row longer
than the reference's and drops that row: dropped assignments land in slot
``E*C``, as in the reference, and nothing syncs with the host.
"""
from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.models import modules as nn


def _scores(cfg, router_w, tokens):
    logits = tokens.float() @ router_w.float()
    if cfg.moe.score_func == "sigmoid":
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)


def route(cfg, router_w, tokens):
    """tokens (T, D) -> (weights (T,k), ids (T,k), aux_loss scalar).

    ``torch.topk`` promises no order between equal scores, where
    ``jax.lax.top_k`` takes the lower index; only an exact tie tells the
    two apart."""
    m = cfg.moe
    scores = _scores(cfg, router_w, tokens)
    w, ids = torch.topk(scores, m.top_k, dim=-1)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance aux: E * sum_e f_e * p_e
    probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    f = torch.zeros(m.n_experts, dtype=torch.float32, device=tokens.device)
    f = f.index_add(0, ids.reshape(-1), torch.ones(
        ids.numel(), dtype=torch.float32, device=tokens.device))
    f = f / ids.numel()
    aux = m.n_experts * torch.sum(f * probs.mean(0))
    return w, ids, aux


def router_gap(cfg, router_w, tokens):
    """tokens (T, D) -> (T,) fp32: each token's gap between its top_k-th
    and its next router score, how near its routing is to a flip (NaN
    where the token holds NaN)."""
    top = torch.topk(_scores(cfg, router_w, tokens), cfg.moe.top_k + 1,
                     dim=-1).values
    return top[:, -2] - top[:, -1]


_GAP_LOGS: list = []


@contextlib.contextmanager
def record_router_gaps():
    """Within the block, every routing call appends its tokens'
    ``router_gap`` (a (T,) tensor) to the list this yields.  Off by
    default: the served path then pays one empty-list check per layer."""
    log: list = []
    _GAP_LOGS.append(log)
    try:
        yield log
    finally:
        _GAP_LOGS.remove(log)


def capacity(cfg, n_tokens: int) -> int:
    m = cfg.moe
    c = int(math.ceil(n_tokens * m.top_k * m.capacity_factor / m.n_experts))
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def dispatch_indices(ids, n_tokens: int, top_k: int, E: int, C: int):
    """Sort token->expert assignments into fixed-capacity slots (a stable
    sort, so that earlier tokens keep their slots).

    Returns slot_tok (E*C,) token row per slot (sentinel n_tokens for
    empty), and slot (T*k,) destination slot per assignment (E*C =
    dropped)."""
    dev = ids.device
    flat_e = ids.reshape(-1)
    n = flat_e.numel()
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, torch.arange(E, device=dev))
    pos_in_e = torch.arange(n, device=dev) - first[sorted_e]
    slot_of_sorted = torch.where(pos_in_e < C, sorted_e * C + pos_in_e,
                                 E * C)
    slot = torch.empty_like(slot_of_sorted).scatter_(0, order, slot_of_sorted)
    tok_ids = torch.arange(n, device=dev) // top_k
    slot_tok = torch.full((E * C + 1,), n_tokens, dtype=torch.long,
                          device=dev).scatter_(0, slot, tok_ids)
    return slot_tok[:E * C], slot


def _group_count(E: int, C: int, D: int, budget_bytes: int = 1 << 27) -> int:
    """Experts per loop step sized so gathered activations stay ~<=128MB."""
    per_expert = C * D * 4
    eg = max(1, min(E, budget_bytes // max(per_expert, 1)))
    while E % eg:
        eg -= 1
    return E // eg


def _grouped(cfg, x, w):
    """x (E,C,D) @ w (E,D,F) in fp32: the reference's einsum with
    ``preferred_element_type=float32``."""
    if cfg.impl == "pallas":
        from repro_torch.kernels import ops as kops
        return kops.moe_gemm(x, w, out_dtype=torch.float32)
    return nn.matmul(x, w, torch.float32)


def _expert_rows(cfg, xg, e_gate, e_up, e_down, dtype):
    """(E*C, D) fp32: the experts' FFN on their dispatched tokens xg
    (E, C, D), the hidden h rounded to the activation dtype between the
    GEMMs, as the reference's group step does."""
    E, C, D = xg.shape
    act = nn.activation(cfg.act)
    up = _grouped(cfg, xg, e_up)
    if e_gate is not None:
        h = act(_grouped(cfg, xg, e_gate)) * up
    else:
        h = act(up)
    return _grouped(cfg, h.to(dtype), e_down).reshape(E * C, D)


def combine(y, slot_w, ss):
    """(T, D) fp32: each token's weighted expert rows added to zero in
    ascending slot order, the order of the reference's ``out.at[st]
    .add(y * sw)`` over its groups.  ``y`` (n, D) fp32 the rows of slots
    0 .. n-1, ``slot_w`` their weights, ``ss`` (T, k) each token's slots
    sorted; a slot at or past n (dropped, or another position's expert)
    adds an exact zero, which leaves the sum's bits as they are.  The k
    adds of every token run in a fixed order on any device."""
    n = y.shape[0]
    ssc = torch.clamp(ss, max=n - 1)
    terms = torch.where((ss < n)[..., None],
                        y[ssc] * slot_w[ssc][..., None], 0.0)
    out = torch.zeros((ss.shape[0], y.shape[1]), dtype=torch.float32,
                      device=y.device)
    for t in terms.unbind(1):
        out = out + t
    return out


def add_group(out, st, yw, C: int):
    """``out[st] += yw`` for one group's slot rows, ``C`` an expert, in
    the reference's order: one ``index_add_`` an expert, in expert order.
    A token holds at most one slot of an expert, so no two adds of one
    launch meet on a row (the sentinel row of empty slots aside), and
    each token's rows land in ascending slot order on any device."""
    for lo in range(0, st.shape[0], C):
        out.index_add_(0, st[lo:lo + C], yw[lo:lo + C])
    return out


def local_moe(cfg, tokens, router_w, e_gate, e_up, e_down):
    """Dense-math MoE on local tokens. tokens (T, D) -> (out (T, D), aux).

    One expert group (``_group_count``): the combine gathers each token's
    rows (``combine``).  More groups, each too large to keep beside the
    others: every group adds its rows into ``out`` as the reference's
    scatter does, an expert at a time (``add_group``)."""
    m = cfg.moe
    T, D = tokens.shape
    E = m.n_experts
    C = capacity(cfg, T)

    w, ids, aux = route(cfg, router_w, tokens)
    if _GAP_LOGS:
        gap = router_gap(cfg, router_w, tokens)
        for log in _GAP_LOGS:
            log.append(gap)
    slot_tok, slot = dispatch_indices(ids, T, m.top_k, E, C)
    slot_w = torch.zeros(E * C + 1, dtype=tokens.dtype,
                         device=tokens.device).scatter_(
        0, slot, w.reshape(-1).to(tokens.dtype))[:E * C]

    x_pad = torch.cat([tokens, tokens.new_zeros((1, D))], 0)
    n_g = _group_count(E, C, D)
    eg = E // n_g
    if n_g == 1:
        y = _expert_rows(cfg, x_pad[slot_tok].reshape(E, C, D), e_gate,
                         e_up, e_down, tokens.dtype)
        ss = slot.view(T, m.top_k).sort(dim=1).values
        return combine(y, slot_w, ss).to(tokens.dtype), aux
    out = torch.zeros((T + 1, D), dtype=torch.float32, device=tokens.device)
    for gi in range(n_g):
        rows = slice(gi * eg * C, (gi + 1) * eg * C)
        experts = slice(gi * eg, (gi + 1) * eg)
        st = slot_tok[rows]
        y = _expert_rows(
            cfg, x_pad[st].reshape(eg, C, D),
            None if e_gate is None else e_gate[experts], e_up[experts],
            e_down[experts], tokens.dtype)
        out = add_group(out, st, y * slot_w[rows, None], C)
    return out[:T].to(tokens.dtype), aux


def _local_moe_ep(cfg, tokens, router_w, e_gate, e_up, e_down, idx: int):
    """EP: this position holds experts idx*E_local .. (idx+1)*E_local-1;
    assignments to the others go to the drop bucket E_local with zero
    weight (their outputs come from the other positions).  tokens (T, D)
    -> (out (T, D) of this position's experts, aux)."""
    m = cfg.moe
    T, D = tokens.shape
    E_local = e_up.shape[0]
    e_lo = idx * E_local
    w, ids, aux = route(cfg, router_w, tokens)
    mine = (ids >= e_lo) & (ids < e_lo + E_local)
    ids_l = torch.where(mine, ids - e_lo, E_local)
    w_l = torch.where(mine, w, 0.0)
    C = capacity(cfg, T)          # the same global capacity per expert
    slot_tok, slot = dispatch_indices(ids_l, T, m.top_k, E_local + 1, C)
    n = E_local * C
    slot_w = torch.zeros(n + C + 1, dtype=tokens.dtype,
                         device=tokens.device).scatter_(
        0, slot, w_l.reshape(-1).to(tokens.dtype))[:n]
    x_pad = torch.cat([tokens, tokens.new_zeros((1, D))], 0)
    y = _expert_rows(cfg, x_pad[slot_tok[:n]].reshape(E_local, C, D),
                     e_gate, e_up, e_down, tokens.dtype)
    ss = slot.view(T, m.top_k).sort(dim=1).values
    return combine(y, slot_w, ss).to(tokens.dtype), aux


def _apply_tp(p, cfg, x):
    """The reference's ``_sharded_moe`` on a model group: x Shards
    (sequence-split or whole) -> (out Shards in x's layout, the first
    position's aux)."""
    from repro_torch.parallel import collectives as col
    g = x.group
    p = col.gathered(p)
    xf = col.gather_seq(x)
    B, S, D = xf[0].shape
    ep = p["e_up"][0].shape[0] != cfg.moe.n_experts

    def one(m, pm, xm):
        t = xm.reshape(B * S, D)
        if ep:
            return _local_moe_ep(cfg, t, pm["router_w"], pm.get("e_gate"),
                                 pm["e_up"], pm["e_down"], m)
        return local_moe(cfg, t, pm["router_w"], pm.get("e_gate"),
                         pm["e_up"], pm["e_down"])
    out, aux = col.local(one, p, xf, index=True)
    parts = [o.reshape(B, S, D) for o in out]
    if col.seq_splits(S, g):
        return col.reduce_scatter(parts, g, 1, "moe"), aux[0]
    return col.all_reduce(parts, g, "moe"), aux[0]


def apply(p, cfg, x):
    """x (B, S, D) -> (out (B, S, D), aux loss scalar).  On a model group
    (``x`` Shards) ``_apply_tp``.  A leaf stored over the data axes
    (``collectives.Stored``: a mesh's "fsdp" expert weights) is gathered
    here, one layer's at a time, and dies when the layer returns (unless
    autograd keeps it for the backward: not inside a checkpointed
    cycle, whose recompute gathers it again)."""
    from repro_torch.parallel import collectives as col
    if isinstance(x, col.Shards):
        return _apply_tp(p, cfg, x)
    p = col.gathered(p)
    B, S, D = x.shape
    out, aux = local_moe(cfg, x.reshape(B * S, D), p["router_w"],
                         p.get("e_gate"), p["e_up"], p["e_down"])
    return out.reshape(B, S, D), aux
