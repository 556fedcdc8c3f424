"""Per-layer block assembly: norm -> mixer -> residual -> norm -> FFN/MoE.

Reference: ``repro/models/blocks.py``.  Layer kinds: attn / local (GQA
attention), mla (DeepSeek latent attention) and rglru (Griffin recurrent
block), each with a dense FFN or an MoE FFN (with the config's shared
experts beside the routed ones), and rwkv6, the complete RWKV-6 layer
(its channel-mix takes the place of the FFN and its second norm sits
inside the branch).  gemma2-style post-norms via ``cfg.post_norm``: a
branch is normed before it joins the residual stream.

On a model group (a mesh with a "model" axis: the mesh trainer and the
dense engine's prefill and decode) ``x`` and ``pending`` are the
residual stream's sequence blocks (:class:`~repro_torch.parallel.
collectives.Shards`), or the whole stream on every position when the
group does not split the sequence (a decode step), and each norm runs
in that domain, as the reference's ``_seq_sp`` places it: the
all-gather to the full sequence happens after the norm, inside the
attention's and the FFN's ``column_parallel``, and before the MLA,
RG-LRU and RWKV-6 mixers, which take the whole sequence (the
reference's ``gather_seq``).  Caches are then each position's
(``collectives.PerPos``, or ``attention.TimeShards`` for a split-T
cache).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ATTN, LOCAL, MLA, RGLRU, RWKV6
from repro_torch.models import attention, mla as mla_mod, modules as nn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod, rwkv6 as rwkv6_mod
from repro_torch.parallel import collectives as col
from repro_torch.parallel.sharding import logical_constraint


def shared_cfg(cfg):
    """The config of the shared experts' FFN: one dense FFN as wide as
    ``n_shared`` experts."""
    return cfg.replace(d_ff=cfg.moe.d_ff_expert * cfg.moe.n_shared)


def _seq_sp(y):
    """A row-parallel branch output lands in the sequence-sharded
    residual layout (the reference's ``_seq_sp``)."""
    if isinstance(y, col.Shards) and y.split is not None:
        return logical_constraint(y, "batch", "seq_sp", None)
    return y


def _norm(scale, cfg, x):
    if isinstance(x, col.Shards):
        return col.local(lambda t, s: nn.rmsnorm(t, s, cfg.norm_eps,
                                                 cfg.impl), x, scale)
    return nn.rmsnorm(x, scale, cfg.norm_eps, cfg.impl)


def _post(p, cfg, name, y):
    if cfg.post_norm:
        y = _norm(p[name]["scale"], cfg, y)
    return _seq_sp(y)


def _add_norm(p, cfg, name, x, pending):
    """(x + pending, its norm ``name``): the residual add fused with the
    norm after it (one kernel launch under impl="pallas"); with nothing
    pending (the first layer), the norm of x alone."""
    if pending is None:
        return x, _norm(p[name]["scale"], cfg, x)
    if isinstance(x, col.Shards):
        return col.local(lambda a, b, s: nn.add_rmsnorm(
            a, b, s, cfg.norm_eps, cfg.impl), x, pending, p[name]["scale"])
    return nn.add_rmsnorm(x, pending, p[name]["scale"], cfg.norm_eps,
                          cfg.impl)


def _ffn_part(p, cfg, x):
    """Dense FFN, or MoE plus the shared experts.  Returns (out, the MoE
    load-balance loss, None for a dense FFN)."""
    if "moe" in p:
        out, aux = moe_mod.apply(p["moe"], cfg, x)
        if "shared" in p:
            sh = nn.ffn_apply(p["shared"], shared_cfg(cfg), x)
            out = col.local(torch.add, out, sh) \
                if isinstance(out, col.Shards) else out + sh
        return out, aux
    return nn.ffn_apply(p["ffn"], cfg, x), None


def _rwkv(p, cfg, x, h, cache):
    """The complete RWKV-6 layer on the normed input ``h``: time-mix,
    residual, second norm, channel-mix.  Returns (x, the channel-mix
    output still to add, cache)."""
    out, c1 = rwkv6_mod.time_mix(p["rwkv"], cfg, h, cache)
    x, h2 = _add_norm(p, cfg, "ln2", x, out)
    out2, c2 = rwkv6_mod.channel_mix(p["rwkv"], cfg, h2, c1)
    return x, out2, c2


def _ffn_half(p, cfg, x, out):
    """Residual of the mixer's output ``out``, second norm, FFN.  Returns
    (x, the FFN branch still to add, the MoE load-balance loss)."""
    x, h2 = _add_norm(p, cfg, "ln2", x, _post(p, cfg, "ln1_post", out))
    out2, aux = _ffn_part(p, cfg, h2)
    return x, _post(p, cfg, "ln2_post", out2), aux


# Every layer takes the residual stream ``x`` and the previous layer's
# last branch output ``pending`` (None before the first layer) and
# returns (x, its own last branch output, its cache), the full-sequence
# path also its MoE load-balance loss (the decode paths drop it, as the
# reference's do): the add of a branch is fused with the norm that
# follows it, in the next layer or the final norm (``lm.py``).
def apply(p, cfg, kind: str, x, pending, *, angles):
    """Full-sequence path (train / prefill).  Returns (x, pending, the
    layer's raw cache contribution: (k, v) before max-len padding, or the
    recurrent cache; the MoE load-balance loss, None without MoE)."""
    x, h = _add_norm(p, cfg, "ln1", x, pending)
    if kind in (MLA, RGLRU, RWKV6):
        h = col.gather_seq(h)     # these mixers take the whole sequence
    if kind in (ATTN, LOCAL):
        out, cache = attention.apply(p["attn"], cfg, h, kind=kind,
                                     angles=angles)
    elif kind == MLA:
        out, cache = mla_mod.apply(p["mla"], cfg, h, angles=angles)
    elif kind == RGLRU:
        out, cache = rglru_mod.apply(p["rglru"], cfg, h)
    elif kind == RWKV6:
        if isinstance(x, col.Shards):
            cache0 = rwkv6_mod.cache_init_tp(
                cfg, x[0].shape[0], x[0].dtype, x.group,
                p["rwkv"]["rwkv_wr"][0].shape[-1] // cfg.head_dim)
        else:
            cache0 = rwkv6_mod.cache_init(cfg, x.shape[0], x.dtype,
                                          x.device)
        return (*_rwkv(p, cfg, x, h, cache0), None)
    else:
        raise ValueError(kind)
    x, out2, aux = _ffn_half(p, cfg, x, out)
    return x, out2, cache, aux


def apply_decode(p, cfg, kind: str, x, pending, cache, pos, *, angles):
    """Single-token decode path. Returns (x, pending, the layer's new
    cache): the attention caches are written in place and returned, the
    recurrent states are new tensors."""
    x, h = _add_norm(p, cfg, "ln1", x, pending)
    if kind in (ATTN, LOCAL):
        out, cache = attention.apply_decode(p["attn"], cfg, h, cache, pos,
                                            kind=kind, angles=angles)
    elif kind == MLA:
        out, cache = mla_mod.apply_decode(p["mla"], cfg, h, cache, pos,
                                          angles=angles)
    elif kind == RGLRU:
        out, cache = rglru_mod.apply_decode(p["rglru"], cfg, h, cache)
    elif kind == RWKV6:
        return _rwkv(p, cfg, x, h, cache)
    else:
        raise ValueError(kind)
    x, out2, _ = _ffn_half(p, cfg, x, out)
    return x, out2, cache


def apply_decode_paged(p, cfg, kind: str, x, pending, pool, block_tables,
                       pos, *, angles):
    """Single-token decode against a paged KV pool. Returns (x, pending,
    pool)."""
    if kind != ATTN:
        raise NotImplementedError(
            f"paged decode supports global-attention layers only, got {kind!r}")
    x, h = _add_norm(p, cfg, "ln1", x, pending)
    out, pool = attention.apply_decode_paged(p["attn"], cfg, h, pool,
                                             block_tables, pos,
                                             angles=angles)
    x, out2, _ = _ffn_half(p, cfg, x, out)
    return x, out2, pool


def apply_prefill_paged(p, cfg, kind: str, x, pending, pool, block_row,
                        start, n_valid, *, angles):
    """Suffix prefill against a paged KV pool (a prefix-cache hit's
    suffix, a prefill chunk, a verify window): x (1,W,D) holds positions
    start..start+W-1 and attends the earlier KV through the block row.
    Returns (x, pending, pool)."""
    if kind != ATTN:
        raise NotImplementedError(
            f"paged prefill supports global-attention layers only, "
            f"got {kind!r}")
    x, h = _add_norm(p, cfg, "ln1", x, pending)
    out, pool = attention.apply_prefill_paged(p["attn"], cfg, h, pool,
                                              block_row, start, n_valid,
                                              angles=angles)
    x, out2, _ = _ffn_half(p, cfg, x, out)
    return x, out2, pool


def paged_cache_init(cfg, kind: str, n_pages: int, page_size: int, dtype,
                     device):
    if kind != ATTN:
        raise NotImplementedError(
            f"paged KV pools exist for global attention only, got {kind!r}")
    return attention.paged_cache_init(cfg, n_pages, page_size, dtype, device)


def paged_cache_from_prefill(cfg, kind: str, pool, raw, block_row):
    """Scatter one sequence's prefill kv into its pages."""
    if kind != ATTN:
        raise NotImplementedError(kind)
    k, v = raw
    return attention.paged_cache_from_prefill(pool, k, v, block_row)


def cache_init(cfg, kind: str, batch: int, max_len: int, dtype, device):
    if kind == ATTN:
        return attention.cache_init(cfg, batch, max_len, None, dtype, device)
    if kind == LOCAL:
        return attention.cache_init(cfg, batch, max_len, cfg.sliding_window,
                                    dtype, device)
    if kind == MLA:
        return mla_mod.cache_init(cfg, batch, max_len, dtype, device)
    if kind == RGLRU:
        return rglru_mod.cache_init(cfg, batch, dtype, device)
    if kind == RWKV6:
        return rwkv6_mod.cache_init(cfg, batch, dtype, device)
    raise ValueError(kind)


def cache_from_prefill(cfg, kind: str, raw, max_len: int, group=None):
    """Convert the prefill cache contribution into decode-ready form; on a
    model group, each position's (the attention and MLA caches in time
    blocks when the group divides their length)."""
    if group is not None and kind in (ATTN, LOCAL, MLA):
        window = cfg.sliding_window if kind == LOCAL else None
        if kind == MLA:
            return mla_mod.cache_from_prefill_tp(*raw, max_len, group)
        return attention.cache_from_prefill_tp(*raw, window, max_len, group)
    if kind in (ATTN, LOCAL):
        k, v = raw
        window = cfg.sliding_window if kind == LOCAL else None
        return attention.cache_from_prefill(k, v, window, max_len)
    if kind == MLA:
        ckv, k_rope = raw
        return mla_mod.cache_from_prefill(ckv, k_rope, max_len)
    if kind in (RGLRU, RWKV6):
        return raw       # the recurrent caches are already decode-ready
    raise ValueError(kind)
