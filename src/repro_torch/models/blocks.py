"""Per-layer block assembly: norm -> mixer -> residual -> norm -> FFN.

Reference: ``repro/models/blocks.py``.  The port has the global and local
(sliding-window) attention blocks and the RG-LRU block, each with a dense
FFN or an MoE FFN (routed experts only), and the RWKV-6 layer, which is
complete in itself (its channel-mix takes the place of the FFN and its
second norm sits inside the branch).  MLA blocks and shared experts raise
until their slice lands.
"""
from __future__ import annotations

from repro_torch.configs.base import ATTN, LOCAL, RGLRU, RWKV6
from repro_torch.models import attention, modules as nn, moe as moe_mod
from repro_torch.models import rglru as rglru_mod, rwkv6 as rwkv6_mod


def _unported(what) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; see ROADMAP.md for the order of the "
        "remaining model families")


def _post(p, cfg, name, y):
    if cfg.post_norm:
        y = nn.rmsnorm(y, p[name]["scale"], cfg.norm_eps, cfg.impl)
    return y


def _add_norm(p, cfg, name, x, pending):
    """(x + pending, its norm ``name``): the residual add fused with the
    norm after it (one kernel launch under impl="pallas"); with nothing
    pending (the first layer), the norm of x alone."""
    if pending is None:
        return x, nn.rmsnorm(x, p[name]["scale"], cfg.norm_eps, cfg.impl)
    return nn.add_rmsnorm(x, pending, p[name]["scale"], cfg.norm_eps,
                          cfg.impl)


def _ffn_part(p, cfg, x):
    """Dense FFN or MoE.  The MoE load-balance loss is dropped: the serving
    paths drop it in the reference too."""
    if "moe" in p:
        if cfg.moe.n_shared:
            raise _unported("shared experts (the DeepSeek slice)")
        return moe_mod.apply(p["moe"], cfg, x)[0]
    return nn.ffn_apply(p["ffn"], cfg, x)


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
    (x, the FFN branch still to add)."""
    x, h2 = _add_norm(p, cfg, "ln2", x, _post(p, cfg, "ln1_post", out))
    return x, _post(p, cfg, "ln2_post", _ffn_part(p, cfg, h2))


# Every layer takes the residual stream ``x`` and the previous layer's
# last branch output ``pending`` (None before the first layer) and
# returns (x, its own last branch output, its cache): the add of a branch
# is fused with the norm that follows it, in the next layer or the final
# norm (``lm.py``).
def apply(p, cfg, kind: str, x, pending, *, angles):
    """Full-sequence (prefill) path.  Returns (x, pending, the layer's raw
    cache contribution: (k, v) before max-len padding, or the recurrent
    cache)."""
    x, h = _add_norm(p, cfg, "ln1", x, pending)
    if kind in (ATTN, LOCAL):
        out, cache = attention.apply(p["attn"], cfg, h, kind=kind,
                                     angles=angles)
    elif kind == RGLRU:
        out, cache = rglru_mod.apply(p["rglru"], cfg, h)
    elif kind == RWKV6:
        cache0 = rwkv6_mod.cache_init(cfg, x.shape[0], x.dtype, x.device)
        return _rwkv(p, cfg, x, h, cache0)
    else:
        raise _unported(f"layer kind {kind!r}")
    return (*_ffn_half(p, cfg, x, out), cache)


def apply_decode(p, cfg, kind: str, x, pending, cache, pos, *, angles):
    """Single-token decode path. Returns (x, pending, the layer's new
    cache): the attention caches are written in place and returned, the
    recurrent states are new tensors."""
    x, h = _add_norm(p, cfg, "ln1", x, pending)
    if kind in (ATTN, LOCAL):
        out, cache = attention.apply_decode(p["attn"], cfg, h, cache, pos,
                                            kind=kind, angles=angles)
    elif kind == RGLRU:
        out, cache = rglru_mod.apply_decode(p["rglru"], cfg, h, cache)
    elif kind == RWKV6:
        return _rwkv(p, cfg, x, h, cache)
    else:
        raise _unported(f"layer kind {kind!r}")
    return (*_ffn_half(p, cfg, x, out), cache)


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
    return (*_ffn_half(p, cfg, x, out), pool)


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
    if kind == RGLRU:
        return rglru_mod.cache_init(cfg, batch, dtype, device)
    if kind == RWKV6:
        return rwkv6_mod.cache_init(cfg, batch, dtype, device)
    raise _unported(f"the decode cache of layer kind {kind!r}")


def cache_from_prefill(cfg, kind: str, raw, max_len: int):
    """Convert the prefill cache contribution into decode-ready form."""
    if kind in (ATTN, LOCAL):
        k, v = raw
        window = cfg.sliding_window if kind == LOCAL else None
        return attention.cache_from_prefill(k, v, window, max_len)
    if kind in (RGLRU, RWKV6):
        return raw       # the recurrent caches are already decode-ready
    raise _unported(f"the decode cache of layer kind {kind!r}")
