"""GQA attention: reference, blocked-flash, kernel, and decode paths.

Reference: ``repro/models/attention.py`` (single-device paths).  Three
prefill implementations (``cfg.impl``):

  ref     — naive (S,S) scores; the oracle.
  blocked — q-block x kv-block online softmax; bounded memory.
  pallas  — the flash-attention kernel through ``kernels/ops.py``
            (the hand-written CUDA kernel on a CUDA tensor); in decode,
            the paged-decode kernel, and the decode-attention kernel on
            a global layer's dense cache.

Caches are stored FLAT (B, T, Kv*hd) and paged pools (P, ps, Kv*hd), as in
the reference; T is the max length for global layers and min(window,
max_len) for the ring cache of local (sliding-window) layers.  The
reference's caches are immutable and its jitted steps donate them; here
the update functions write the cache tensors in place (``index_put_`` /
slice assignment) and return them, which saves the copy.  The sharded
decode branches wait for the sharded-serving slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.models import modules as nn

NEG_INF = -2.0 ** 30  # large-negative that survives bf16 arithmetic


class AttnCache(NamedTuple):
    # FLAT (B, T, Kv*hd); T = max len
    k: torch.Tensor
    v: torch.Tensor


def _split_heads(x, n, hd):
    return x.reshape(*x.shape[:-1], n, hd)


def _scale(cfg) -> float:
    return cfg.attn_logit_scale if cfg.attn_logit_scale is not None \
        else cfg.head_dim ** -0.5


def expand_kv(k, n_heads: int):
    """(B,T,Kv,hd) -> (B,T,H,hd) by repeating each kv head G times, as a
    contiguous tensor (with Kv = 1 the reshape alone would be a stride-0
    view, which the kernels do not take)."""
    B, T, Kv, hd = k.shape
    G = n_heads // Kv
    if G == 1:
        return k
    return k[:, :, :, None, :].expand(B, T, Kv, G, hd).reshape(
        B, T, n_heads, hd).contiguous()


def _qkv(p, cfg, x, angles):
    """Project + head-split + qk-norm + rope.  Returns q (B,S,H,hd) and
    k/v (B,S,Kv,hd).  On one device the reference's fused
    ``column_parallel`` is three matmuls."""
    q = _split_heads(nn.matmul(x, p["wq"]), cfg.n_heads, cfg.head_dim)
    k = _split_heads(nn.matmul(x, p["wk"]), cfg.n_kv_heads, cfg.head_dim)
    v = _split_heads(nn.matmul(x, p["wv"]), cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q, k = nn.qk_rmsnorm(q, k, p["q_norm"], p["k_norm"], cfg.norm_eps,
                             cfg.impl)
    if cfg.rope and angles is not None:
        q = nn.apply_rope(q, angles)
        k = nn.apply_rope(k, angles)
    return q, k, v


def _einsum32(eq, a, b):
    """einsum with fp32 accumulation of (possibly bf16) operands — the
    reference's ``preferred_element_type=jnp.float32``."""
    return torch.einsum(eq, a.float(), b.float())


# ---------------------------------------------------------------------------
# reference implementation — full (S, S) scores, H-space
# ---------------------------------------------------------------------------
def _mask_ok(iq, jk, causal: bool, window: Optional[int]):
    ok = torch.ones((iq.shape[0], jk.shape[0]), dtype=torch.bool,
                    device=iq.device)
    if causal:
        ok &= jk[None, :] <= iq[:, None]
    if window is not None:
        ok &= (iq[:, None] - jk[None, :]) < window
    return ok


def attend_ref(q, k, v, *, causal, window, scale, softcap):
    """q (B,S,H,hd); k,v (B,S,H,hd) pre-expanded -> (B,S,H,hd)."""
    S = q.shape[1]
    s = _einsum32("bqhd,bthd->bhqt", q, k) * scale
    s = nn.softcap(s, softcap)
    idx = torch.arange(S, device=q.device)
    bias = torch.where(_mask_ok(idx, idx, causal, window), 0.0, NEG_INF)
    w = torch.softmax((s + bias[None, None]).float(), dim=-1)
    return _einsum32("bhqt,bthd->bqhd", w.to(q.dtype), v).to(q.dtype)


# ---------------------------------------------------------------------------
# blocked flash — bounded memory, loop over q and kv blocks (H-space)
# ---------------------------------------------------------------------------
def attend_blocked(q, k, v, *, causal, window, scale, softcap,
                   block_q: int, block_kv: int):
    B, S, H, hd = q.shape
    bq = min(block_q, S)
    while S % bq:
        bq -= 1
    bkv = min(block_kv, S)
    while S % bkv:
        bkv -= 1
    if window is not None and window + bq < S and causal:
        # sliding-window fast path: slices just the kv window per q block
        return _attend_local_blocked(q, k, v, causal=causal, window=window,
                                     scale=scale, softcap=softcap, bq=bq)
    dev = q.device
    outs = []
    for qi in range(S // bq):
        q_blk = q[:, qi * bq:(qi + 1) * bq]
        iq = qi * bq + torch.arange(bq, device=dev)
        m = torch.full((B, H, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, bq, hd), dtype=torch.float32, device=dev)
        for ki in range(S // bkv):
            k_blk = k[:, ki * bkv:(ki + 1) * bkv]
            v_blk = v[:, ki * bkv:(ki + 1) * bkv]
            s = _einsum32("bqhd,bthd->bhqt", q_blk, k_blk) * scale
            s = nn.softcap(s, softcap)
            jk = ki * bkv + torch.arange(bkv, device=dev)
            s = torch.where(_mask_ok(iq, jk, causal, window)[None, None], s,
                            NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + _einsum32(
                "bhqt,bthd->bhqd", p.to(v_blk.dtype), v_blk)
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-37)
        outs.append(out.transpose(1, 2))                 # (B, bq, H, hd)
    return torch.cat(outs, dim=1).to(q.dtype)


def _attend_local_blocked(q, k, v, *, causal, window, scale, softcap, bq):
    """Sliding-window attention: per q block, slice only the kv window
    (O(S * (window + bq)) work)."""
    B, S, H, hd = q.shape
    span = window + bq
    dev = q.device
    outs = []
    for qi in range(S // bq):
        q_blk = q[:, qi * bq:(qi + 1) * bq]
        start = min(max(qi * bq + bq - span, 0), S - span)
        k_w = k[:, start:start + span]
        v_w = v[:, start:start + span]
        s = _einsum32("bqhd,bthd->bhqt", q_blk, k_w) * scale
        s = nn.softcap(s, softcap)
        iq = qi * bq + torch.arange(bq, device=dev)
        jk = start + torch.arange(span, device=dev)
        s = torch.where(_mask_ok(iq, jk, causal, window)[None, None], s,
                        NEG_INF)
        w = torch.softmax(s, dim=-1)
        outs.append(_einsum32("bhqt,bthd->bqhd", w.to(v_w.dtype), v_w))
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# dense decode — one query against the cache (the oracle's path)
# ---------------------------------------------------------------------------
def attend_decode(q, cache: AttnCache, pos, *, window, scale, softcap,
                  n_kv: int):
    """q (B,1,H,hd); cache.k/v FLAT (B,T,Kv*hd); pos scalar.

    Global cache: slot = t, valid slots are <= pos.
    Local (ring) cache: slot = t % T; a slot is valid when the absolute
    position it holds lies inside the window."""
    B, _, H, hd = q.shape
    T = cache.k.shape[1]
    Kv = n_kv
    k = cache.k.reshape(B, T, Kv, hd)
    v = cache.v.reshape(B, T, Kv, hd)
    qg = q.reshape(B, Kv, H // Kv, hd)
    s = _einsum32("bkgd,btkd->bkgt", qg, k) * scale
    s = nn.softcap(s, softcap)
    slots = torch.arange(T, device=q.device)
    if window is None:
        ok = slots <= pos
    else:
        abs_pos = pos - ((pos - slots) % T)    # T == window for ring caches
        ok = (abs_pos >= 0) & (abs_pos > pos - window)
    s = torch.where(ok[None, None, None], s, NEG_INF)
    w = torch.softmax(s.float(), dim=-1)
    o = _einsum32("bkgt,btkd->bkgd", w.to(v.dtype), v).to(q.dtype)
    return o.reshape(B, 1, H * hd)


def cache_init(cfg, batch: int, max_len: int, window, dtype, device):
    T = min(window, max_len) if window is not None else max_len
    shape = (batch, T, cfg.n_kv_heads * cfg.head_dim)
    return AttnCache(k=torch.zeros(shape, dtype=dtype, device=device),
                     v=torch.zeros(shape, dtype=dtype, device=device))


def cache_update_decode(cache: AttnCache, k_new, v_new, pos, window):
    """Write the step-t k/v (B,1,Kv,hd) into slot t (global) or t % T
    (ring), in place."""
    B = k_new.shape[0]
    slot = pos % cache.k.shape[1] if window is not None else pos
    cache.k[:, slot:slot + 1] = k_new.reshape(B, 1, -1)
    cache.v[:, slot:slot + 1] = v_new.reshape(B, 1, -1)
    return cache


def cache_from_prefill(k, v, window, max_len):
    """Build the flat decode cache from prefill k/v (B,S,Kv,hd): padded to
    max_len (global), or the last min(window, max_len) positions placed
    at their ring slots (local)."""
    B, S, Kv, hd = k.shape
    k = k.reshape(B, S, Kv * hd)
    v = v.reshape(B, S, Kv * hd)
    if window is None:
        pad = max(max_len - S, 0)
        return AttnCache(torch.nn.functional.pad(k, (0, 0, 0, pad)),
                         torch.nn.functional.pad(v, (0, 0, 0, pad)))
    W = min(window, max_len)
    ck = k.new_zeros((B, W, Kv * hd))
    cv = v.new_zeros((B, W, Kv * hd))
    if S >= W:
        slots = torch.arange(S - W, S, device=k.device) % W
        ck[:, slots] = k[:, S - W:]
        cv[:, slots] = v[:, S - W:]
    else:
        ck[:, :S] = k
        cv[:, :S] = v
    return AttnCache(ck, cv)


# ---------------------------------------------------------------------------
# paged decode — the KV cache as fixed-size pages named by a block table
# ---------------------------------------------------------------------------
# Physical page 0 is reserved as the null page: padded block-table slots
# point at it and their contribution is masked out exactly, so garbage
# there never reaches a real token.

class PagedAttnCache(NamedTuple):
    # k/v pools, FLAT features: (n_pages, page_size, Kv*hd)
    k: torch.Tensor
    v: torch.Tensor


def paged_cache_init(cfg, n_pages: int, page_size: int, dtype, device):
    shape = (n_pages, page_size, cfg.n_kv_heads * cfg.head_dim)
    return PagedAttnCache(k=torch.zeros(shape, dtype=dtype, device=device),
                          v=torch.zeros(shape, dtype=dtype, device=device))


def paged_cache_update(pool: PagedAttnCache, k_new, v_new, block_tables,
                       pos):
    """Write step-t k/v (B,1,Kv,hd) into page ``block_tables[b, t//ps]``,
    slot t%ps, in place (the reference donates the pool instead).
    Inactive batch slots point at the null page; their writes collide
    there harmlessly."""
    B = k_new.shape[0]
    ps = pool.k.shape[1]
    pos = pos.long()
    page = block_tables.long().gather(1, (pos // ps)[:, None])[:, 0]
    slot = pos % ps
    pool.k.index_put_((page, slot), k_new.reshape(B, -1))
    pool.v.index_put_((page, slot), v_new.reshape(B, -1))
    return pool


def attend_decode_paged(q, pool: PagedAttnCache, block_tables, pos, *,
                        scale, softcap, n_kv: int, impl=None):
    """q (B,1,H,hd); pool pages (P,ps,Kv*hd); pos (B,) int32.

    ``impl == "pallas"`` runs the paged-decode kernel; otherwise the
    sequence's pages are gathered through the block table and attended
    with the same masked arithmetic as the dense path."""
    B, _, H, hd = q.shape
    P_, ps = pool.k.shape[0], pool.k.shape[1]
    Kv = n_kv
    if impl == "pallas":
        from repro_torch.kernels import ops as kops
        o = kops.paged_decode_attention(
            q.reshape(B, H, hd), pool.k.view(P_, ps, Kv, hd),
            pool.v.view(P_, ps, Kv, hd), block_tables, pos,
            scale=scale, softcap=softcap)
        return o.reshape(B, 1, H * hd)
    T = block_tables.shape[1] * ps
    bt = block_tables.long()
    k = pool.k[bt].reshape(B, T, Kv, hd)
    v = pool.v[bt].reshape(B, T, Kv, hd)
    qg = q.reshape(B, Kv, H // Kv, hd)
    s = _einsum32("bkgd,btkd->bkgt", qg, k) * scale
    s = nn.softcap(s, softcap)
    ok = torch.arange(T, device=q.device)[None, :] <= pos.long()[:, None]
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s.float(), dim=-1)
    o = _einsum32("bkgt,btkd->bkgd", w.to(v.dtype), v).to(q.dtype)
    return o.reshape(B, 1, H * hd)


def paged_cache_from_prefill(pool: PagedAttnCache, k, v, block_row,
                             start: int = 0):
    """Scatter prefill k/v (1,S,Kv,hd) of ONE sequence into the pool, in
    place; tokens land at logical slots start..start+S-1 of the pages
    named by ``block_row`` (nmax,)."""
    S = k.shape[1]
    ps = pool.k.shape[1]
    t = start + torch.arange(S, device=pool.k.device)
    page = block_row.long()[t // ps]
    slot = t % ps
    pool.k.index_put_((page, slot), k.reshape(S, -1))
    pool.v.index_put_((page, slot), v.reshape(S, -1))
    return pool


def apply_decode_paged(p, cfg, x, pool: PagedAttnCache, block_tables,
                       pos, *, angles):
    """Paged decode path: x (B,1,D), pos (B,). Returns (out, pool)."""
    q, k_new, v_new = _qkv(p, cfg, x, angles)
    pool = paged_cache_update(pool, k_new, v_new, block_tables, pos)
    o = attend_decode_paged(q, pool, block_tables, pos, scale=_scale(cfg),
                            softcap=cfg.attn_softcap, n_kv=cfg.n_kv_heads,
                            impl=cfg.impl)
    return nn.matmul(o, p["wo"]), pool


# ---------------------------------------------------------------------------
# full layer entry points
# ---------------------------------------------------------------------------
def apply(p, cfg, x, *, kind: str, angles):
    """Prefill path, routed by ``cfg.impl``. Returns (out, (k, v))."""
    impl = cfg.impl
    window = cfg.sliding_window if kind == "local" else None
    q, k, v = _qkv(p, cfg, x, angles)
    kh = expand_kv(k, cfg.n_heads)
    vh = expand_kv(v, cfg.n_heads)
    kw = dict(causal=cfg.causal, window=window, scale=_scale(cfg),
              softcap=cfg.attn_softcap)
    if impl == "ref":
        o = attend_ref(q, kh, vh, **kw)
    elif impl == "blocked":
        o = attend_blocked(q, kh, vh, block_q=cfg.attn_block_q,
                           block_kv=cfg.attn_block_kv, **kw)
    elif impl == "pallas":
        from repro_torch.kernels import ops as kops
        o = kops.flash_attention(q, kh, vh, **kw)
    else:
        raise ValueError(impl)
    o = o.reshape(*x.shape[:-1], cfg.n_heads * cfg.head_dim)
    return nn.matmul(o, p["wo"]), (k, v)


def apply_decode(p, cfg, x, cache: AttnCache, pos, *, kind: str, angles):
    """Dense decode path: x (B,1,D), pos an int. Returns (out, cache).

    A global layer under ``impl == "pallas"`` runs the decode-attention
    kernel on the cache viewed as (B,T,Kv,hd); a local layer's ring cache
    falls outside the kernel's ``slot <= pos`` mask and stays plain."""
    window = cfg.sliding_window if kind == "local" else None
    q, k_new, v_new = _qkv(p, cfg, x, angles)
    cache = cache_update_decode(cache, k_new, v_new, pos, window)
    kw = dict(scale=_scale(cfg), softcap=cfg.attn_softcap)
    if window is None and cfg.impl == "pallas":
        from repro_torch.kernels import ops as kops
        B, T = cache.k.shape[:2]
        H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        o = kops.decode_attention(q.reshape(B, H, hd),
                                  cache.k.view(B, T, Kv, hd),
                                  cache.v.view(B, T, Kv, hd), pos, **kw)
        o = o.reshape(B, 1, H * hd)
    else:
        o = attend_decode(q, cache, pos, window=window, n_kv=cfg.n_kv_heads,
                          **kw)
    return nn.matmul(o, p["wo"]), cache
