"""Mixture-of-Experts FFN on one device: top-k routing, fixed-capacity
dispatch, a grouped GEMM per expert group.

Reference: ``repro/models/moe.py`` (``route``, ``capacity``,
``dispatch_indices``, ``_group_count``, ``local_moe`` and the
single-device branch of ``apply``).  The reference's ``lax.scan`` over
expert groups is a Python loop.  Its three grouped einsums
(``preferred_element_type=float32``) run through the ``moe_gemm`` kernel
under ``impl == "pallas"`` and as fp32 ``torch.einsum`` otherwise; both
keep the reference's fp32 between the GEMMs.  The reference's sharded
expert-TP and EP branches are not ported: the port refuses a mesh where
it would enter (``PagedEngine(mesh=...)``, ROADMAP Queue A item 7).

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
    return torch.einsum("ecd,edf->ecf", x.float(), w.float())


def local_moe(cfg, tokens, router_w, e_gate, e_up, e_down):
    """Dense-math MoE on local tokens. tokens (T, D) -> (out (T, D), aux)."""
    m = cfg.moe
    T, D = tokens.shape
    E = m.n_experts
    C = capacity(cfg, T)
    act = nn.activation(cfg.act)

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
    out = torch.zeros((T + 1, D), dtype=torch.float32, device=tokens.device)
    for gi in range(n_g):
        st = slot_tok[gi * eg * C:(gi + 1) * eg * C]
        sw = slot_w[gi * eg * C:(gi + 1) * eg * C]
        experts = slice(gi * eg, (gi + 1) * eg)
        xg = x_pad[st].reshape(eg, C, D)
        up = _grouped(cfg, xg, e_up[experts])
        if e_gate is not None:
            h = act(_grouped(cfg, xg, e_gate[experts])) * up
        else:
            h = act(up)
        y = _grouped(cfg, h.to(tokens.dtype), e_down[experts])
        out.index_add_(0, st, (y.reshape(eg * C, D) * sw[:, None]).float())
    return out[:T].to(tokens.dtype), aux


def apply(p, cfg, x):
    """x (B, S, D) -> (out (B, S, D), aux loss scalar)."""
    B, S, D = x.shape
    out, aux = local_moe(cfg, x.reshape(B * S, D), p["router_w"],
                         p.get("e_gate"), p["e_up"], p["e_down"])
    return out.reshape(B, S, D), aux
