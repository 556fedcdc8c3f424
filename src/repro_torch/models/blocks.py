"""Per-layer block assembly: norm -> mixer -> residual -> norm -> FFN.

Reference: ``repro/models/blocks.py``.  The port has the global-attention
block with a dense FFN; local-window, MLA, RG-LRU, RWKV-6 and MoE blocks
raise until their slices land.
"""
from __future__ import annotations

from repro_torch.configs.base import ATTN
from repro_torch.models import attention, modules as nn


def _unported(what) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet; see ROADMAP.md for the order of the "
        "remaining model families")


def _post(p, cfg, name, y):
    if cfg.post_norm:
        y = nn.rmsnorm(y, p[name]["scale"], cfg.norm_eps)
    return y


def _ffn_part(p, cfg, x):
    """Dense FFN (the MoE branch comes with the MoE slice)."""
    if "ffn" not in p:
        raise _unported("the MoE FFN")
    return nn.ffn_apply(p["ffn"], cfg, x)


def apply(p, cfg, kind: str, x, *, angles):
    """Full-sequence (prefill) path.  Returns (x, the layer's raw (k, v)
    before max-len padding)."""
    if kind != ATTN:
        raise _unported(f"layer kind {kind!r}")
    h = nn.rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps)
    out, kv = attention.apply(p["attn"], cfg, h, kind=kind, angles=angles)
    x = x + _post(p, cfg, "ln1_post", out)
    h2 = nn.rmsnorm(x, p["ln2"]["scale"], cfg.norm_eps)
    x = x + _post(p, cfg, "ln2_post", _ffn_part(p, cfg, h2))
    return x, kv


def apply_decode(p, cfg, kind: str, x, cache, pos, *, angles):
    """Single-token decode path. Returns (x, cache)."""
    if kind != ATTN:
        raise _unported(f"layer kind {kind!r}")
    h = nn.rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps)
    out, cache = attention.apply_decode(p["attn"], cfg, h, cache, pos,
                                        angles=angles)
    x = x + _post(p, cfg, "ln1_post", out)
    h2 = nn.rmsnorm(x, p["ln2"]["scale"], cfg.norm_eps)
    x = x + _post(p, cfg, "ln2_post", _ffn_part(p, cfg, h2))
    return x, cache


def apply_decode_paged(p, cfg, kind: str, x, pool, block_tables, pos, *,
                       angles):
    """Single-token decode against a paged KV pool. Returns (x, pool)."""
    if kind != ATTN:
        raise NotImplementedError(
            f"paged decode supports global-attention layers only, got {kind!r}")
    h = nn.rmsnorm(x, p["ln1"]["scale"], cfg.norm_eps)
    out, pool = attention.apply_decode_paged(p["attn"], cfg, h, pool,
                                             block_tables, pos,
                                             angles=angles)
    x = x + _post(p, cfg, "ln1_post", out)
    h2 = nn.rmsnorm(x, p["ln2"]["scale"], cfg.norm_eps)
    x = x + _post(p, cfg, "ln2_post", _ffn_part(p, cfg, h2))
    return x, pool


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
        return attention.cache_init(cfg, batch, max_len, dtype, device)
    raise _unported(f"the decode cache of layer kind {kind!r}")


def cache_from_prefill(cfg, kind: str, raw, max_len: int):
    """Convert the prefill cache contribution into decode-ready form."""
    if kind == ATTN:
        k, v = raw
        return attention.cache_from_prefill(k, v, max_len)
    raise _unported(f"the decode cache of layer kind {kind!r}")
