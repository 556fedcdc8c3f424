"""Multi-head Latent Attention (DeepSeek-V2/V3) with weight-absorbed decode.

Reference: ``repro/models/mla.py``.  Prefill: the latents are
up-projected to per-head k/v and attention runs as usual.  Decode: the
cache holds only the compressed latent c_kv (kv_lora) and the shared rope
key (qk_rope_head_dim); the queries are absorbed through kv_b, so scores
and outputs are computed in latent space and the cache is O(kv_lora +
rope) per token instead of O(H * head_dim).

As in the reference, neither path runs a kernel: prefill attends with the
plain ``attend_ref`` (impl "ref") or ``attend_blocked`` (impl "blocked"
and "pallas" alike, since the q/k head dim of 192 differs from v's 128),
and decode is latent-space einsums.  The q and latent norms run the
rmsnorm kernel under impl "pallas", like every norm of the port.

On a model group (``x`` Shards, the dense engine's mesh and the mesh
trainer) each position holds its heads' column blocks of q_b and kv_b
and row block of wo: a prefill runs its heads on the whole sequence
(the residual gathered before the mixer, as the reference's blocks do)
and ``row_parallel`` sums the heads back, and every position keeps its
time block of the latent cache (``attention.TimeShards``); a decode
step gathers the absorbed queries to every head, scans each position's
time block and merges the partials (the reference's split-T branch),
or scans the whole cache on every position when the group does not
divide its length.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models import attention as attn
from repro_torch.models import modules as nn

NEG_INF = attn.NEG_INF


class MLACache(NamedTuple):
    ckv: torch.Tensor     # (B, T, kv_lora)
    k_rope: torch.Tensor  # (B, T, rope_dim)


def _project_q(p, cfg, x, angles):
    m = cfg.mla
    cq = nn.rmsnorm(nn.matmul(x, p["q_a"]), p["q_a_norm"], cfg.norm_eps,
                    cfg.impl)
    q = nn.matmul(cq, p["q_b"]).reshape(
        *x.shape[:-1], cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    if angles is not None:
        q_rope = nn.apply_rope(q_rope, angles)
    return q_nope, q_rope


def _project_kv_latent(p, cfg, x, angles):
    m = cfg.mla
    lat = nn.matmul(x, p["kv_a"])
    # the latent's first kv_lora columns of each (kv_lora + rope)-wide
    # row: a strided view, copied to contiguous rows for the norm kernel
    ckv = lat[..., :m.kv_lora_rank].contiguous()
    k_rope = lat[..., m.kv_lora_rank:]
    ckv = nn.rmsnorm(ckv, p["kv_a_norm"], cfg.norm_eps, cfg.impl)
    if angles is not None:
        k_rope = nn.apply_rope(k_rope[..., None, :], angles)[..., 0, :]
    return ckv, k_rope


def _scale(cfg) -> float:
    m = cfg.mla
    return (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5


def v_pad(v, d):
    """Pad v's head dim to ``d`` so the generic attention helpers apply."""
    if v.shape[-1] == d:
        return v
    return F.pad(v, (0, d - v.shape[-1]))


def apply(p, cfg, x, *, angles):
    """Prefill.  Returns (out, (ckv, k_rope)) for the decode cache.  On a
    model group (``x`` Shards of the whole sequence) ``_apply_tp``."""
    from repro_torch.parallel import collectives as col
    if isinstance(x, col.Shards):
        return _apply_tp(p, cfg, x, angles=angles)
    o, lat = _heads_out(p, cfg, x, angles)
    return nn.matmul(o, p["wo"]), lat


def _heads_cfg(cfg, p):
    """``cfg`` with the heads that ``p``'s column block of q_b holds."""
    m = cfg.mla
    H = p["q_b"].shape[-1] // (m.qk_nope_head_dim + m.qk_rope_head_dim)
    return cfg if H == cfg.n_heads else cfg.replace(n_heads=H, n_kv_heads=H)


def _apply_tp(p, cfg, x, *, angles):
    """Each position's heads on the whole sequence, then ``row_parallel``
    of wo.  Returns (out, (ckv, k_rope) Shards, whole on every
    position)."""
    from repro_torch.parallel import collectives as col
    outs = col.local(lambda pm, xm, am: _heads_out(pm, _heads_cfg(cfg, pm),
                                                   xm, am),
                     p, x, angles)
    o, lat = outs[0], outs[1]
    o = col.Shards(list(o), x.group, o[0].ndim - 1)
    ckv = col.Shards([l[0] for l in lat], x.group, None)
    k_rope = col.Shards([l[1] for l in lat], x.group, None)
    return col.row_parallel(o, p["wo"]), (ckv, k_rope)


def _heads_out(p, cfg, x, angles):
    """The attention of ``cfg.n_heads`` heads: (o (B,S,H*v), (ckv,
    k_rope))."""
    m = cfg.mla
    H = cfg.n_heads
    B, S, _ = x.shape
    q_nope, q_rope = _project_q(p, cfg, x, angles)
    ckv, k_rope = _project_kv_latent(p, cfg, x, angles)
    kv = nn.matmul(ckv, p["kv_b"]).reshape(
        B, S, H, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, m.qk_rope_head_dim)], dim=-1)
    v = v_pad(v, q.shape[-1])
    kw = dict(causal=cfg.causal, window=None, scale=_scale(cfg),
              softcap=cfg.attn_softcap)
    if cfg.impl == "ref":
        o = attn.attend_ref(q, k, v, **kw)
    elif cfg.impl in ("blocked", "pallas"):
        o = attn.attend_blocked(q, k, v, block_q=cfg.attn_block_q,
                                block_kv=cfg.attn_block_kv, **kw)
    else:
        raise ValueError(cfg.impl)
    o = o[..., :m.v_head_dim]                        # un-pad v
    return o.reshape(B, S, H * m.v_head_dim), (ckv, k_rope)


# ---------------------------------------------------------------------------
# decode with absorbed weights + latent cache
# ---------------------------------------------------------------------------
def _kv_b_split(p, cfg):
    m = cfg.mla
    kv_b = p["kv_b"].reshape(m.kv_lora_rank, cfg.n_heads,
                             m.qk_nope_head_dim + m.v_head_dim)
    return kv_b[..., :m.qk_nope_head_dim], kv_b[..., m.qk_nope_head_dim:]


def cache_init(cfg, batch: int, max_len: int, dtype, device):
    m = cfg.mla
    return MLACache(
        ckv=torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dtype,
                        device=device),
        k_rope=torch.zeros((batch, max_len, m.qk_rope_head_dim), dtype=dtype,
                           device=device))


def cache_from_prefill(ckv, k_rope, max_len):
    pad = max_len - ckv.shape[1]
    if pad > 0:
        ckv = F.pad(ckv, (0, 0, 0, pad))
        k_rope = F.pad(k_rope, (0, 0, 0, pad))
    return MLACache(ckv.contiguous(), k_rope.contiguous())


def _decode_scores_local(q_lat, q_rope, ckv, k_rope, valid, cfg):
    """Absorbed attention over a latent cache.  Returns (m, l, acc_lat
    (B,H,lora)).  As in the reference, q_lat and the probabilities are
    rounded to the cache's dtype before their products, which accumulate
    in fp32."""
    s = attn._einsum32("bhl,btl->bht", q_lat.to(ckv.dtype), ckv)
    s = s + attn._einsum32("bhd,btd->bht", q_rope, k_rope)
    s = nn.softcap(s * _scale(cfg), cfg.attn_softcap)
    s = torch.where(valid[None, None], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    acc = attn._einsum32("bht,btl->bhl", p.to(ckv.dtype), ckv)
    return m, p.sum(-1), acc


def cache_from_prefill_tp(ckv, k_rope, max_len, group):
    """Each position's latent cache from the prefill's (Shards, whole on
    every position): its time block when the group divides max_len."""
    from repro_torch.parallel import collectives as col
    full = [cache_from_prefill(ckv[m], k_rope[m], max_len)
            for m in range(group.size)]
    n = group.size
    if n == 1 or max_len % n:
        return col.PerPos(full)
    Tl = max_len // n
    return attn.TimeShards(MLACache(c.ckv[:, m * Tl:(m + 1) * Tl].clone(),
                                    c.k_rope[:, m * Tl:(m + 1) * Tl].clone())
                           for m, c in enumerate(full))


def _apply_decode_tp(p, cfg, x, cache, pos, *, angles):
    """Absorbed decode on a model group: each position's heads' latent
    queries, gathered to every head; the new latent (the same on every
    position) written where its slot lives; the split-T partials merged
    (or each position's whole cache scanned); each position's heads'
    outputs through ``row_parallel`` of wo."""
    from repro_torch.parallel import collectives as col
    g = x.group
    B = x[0].shape[0]
    mc = cfg.mla

    def heads(pm, xm, am):
        c = _heads_cfg(cfg, pm)
        q_nope, q_rope = _project_q(pm, c, xm, am)
        w_uk, _ = _kv_b_split(pm, c)
        return (attn._einsum32("bhd,lhd->bhl", q_nope[:, 0], w_uk),
                q_rope[:, 0].contiguous())
    q_lat, q_rope = col.local(heads, p, x, angles)
    q_lat = col.all_gather(q_lat, 1, "q_lat")            # (B,H,lora)
    q_rope = col.all_gather(q_rope, 1, "q_lat")          # (B,H,rope)
    lat = col.local(lambda pm, xm, am: _project_kv_latent(pm, cfg, xm, am),
                    p, x, angles)
    if isinstance(cache, attn.TimeShards):
        Tl = cache[0].ckv.shape[1]
        o = pos // Tl
        cache[o].ckv[:, pos - o * Tl] = lat[0][o][:, 0]
        cache[o].k_rope[:, pos - o * Tl] = lat[1][o][:, 0]
        parts = []
        for m, c in enumerate(cache):
            valid = m * Tl + torch.arange(Tl, device=c.ckv.device) <= pos
            parts.append(_decode_scores_local(q_lat[m], q_rope[m], c.ckv,
                                              c.k_rope, valid, cfg))
        o_lat = attn.merge_partials(parts, g, "split_t")
    else:
        o_lat = []
        for m, c in enumerate(cache):
            c.ckv[:, pos] = lat[0][m][:, 0]
            c.k_rope[:, pos] = lat[1][m][:, 0]
            valid = torch.arange(c.ckv.shape[1], device=c.ckv.device) <= pos
            _, l, acc = _decode_scores_local(q_lat[m], q_rope[m], c.ckv,
                                             c.k_rope, valid, cfg)
            o_lat.append(acc / torch.clamp(l[..., None], min=1e-37))

    def out(m, pm, ol):
        c = _heads_cfg(cfg, pm)
        _, w_uv = _kv_b_split(pm, c)
        ol = ol[:, m * c.n_heads:(m + 1) * c.n_heads]
        o = attn._einsum32("bhl,lhv->bhv", ol.to(x[m].dtype), w_uv)
        return o.to(x[m].dtype).reshape(B, 1, c.n_heads * mc.v_head_dim)
    o = col.local(out, p, col.Shards(o_lat, g, None), index=True)
    o = col.Shards(list(o), g, 2)
    return col.row_parallel(o, p["wo"]), cache


def apply_decode(p, cfg, x, cache: MLACache, pos, *, angles):
    """x (B,1,D), pos an int.  Absorbed-weight decode in latent space; the
    cache is written in place at ``pos`` and returned.  On a model group
    (``x`` Shards) ``_apply_decode_tp``."""
    from repro_torch.parallel import collectives as col
    if isinstance(x, col.Shards):
        return _apply_decode_tp(p, cfg, x, cache, pos, angles=angles)
    m = cfg.mla
    B = x.shape[0]
    q_nope, q_rope = _project_q(p, cfg, x, angles)       # (B,1,H,nope/rope)
    ckv_new, k_rope_new = _project_kv_latent(p, cfg, x, angles)
    cache.ckv[:, pos] = ckv_new[:, 0]
    cache.k_rope[:, pos] = k_rope_new[:, 0]
    w_uk, w_uv = _kv_b_split(p, cfg)
    # absorb: q_lat[h] = q_nope[h] @ w_uk[:, h, :]^T, a latent-space query
    # (B,H,lora), kept in fp32
    q_lat = attn._einsum32("bhd,lhd->bhl", q_nope[:, 0], w_uk)
    T = cache.ckv.shape[1]
    valid = torch.arange(T, device=x.device) <= pos
    _, l, acc = _decode_scores_local(q_lat, q_rope[:, 0], cache.ckv,
                                     cache.k_rope, valid, cfg)
    o_lat = acc / torch.clamp(l[..., None], min=1e-37)
    o = attn._einsum32("bhl,lhv->bhv", o_lat.to(x.dtype), w_uv).to(x.dtype)
    out = nn.matmul(o.reshape(B, 1, cfg.n_heads * m.v_head_dim), p["wo"])
    return out, cache
