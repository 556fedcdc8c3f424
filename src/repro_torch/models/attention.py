"""GQA attention: reference, blocked-flash, kernel, and decode paths.

Reference: ``repro/models/attention.py``.  Three
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
slice assignment) and return them, which saves the copy.

Striped pools (:class:`StripedPagedCache`): under a sharding environment
whose "pages" axis has M > 1 positions (``parallel/sharding.py``,
``SERVING_RULES``), ``paged_cache_init`` cuts each pool into M stripes of
P/M contiguous physical rows, stripe d on the mesh's device d: the
placement the reference gets from a ``NamedSharding`` over the page
axis.  GSPMD routes the reference's writes and gathers to the owning
device; here every paged function routes them itself, with fixed shapes
(one scatter a stripe, its rows that other stripes own sent to the
stripe's sink row), so no routing decision waits for the host.  Decode
runs the reference's ``shard_map`` body once per stripe and merges the
stripes' online-softmax partials on the caller's device.

On a model group (the dense engine's mesh, ``lm.prefill`` / ``lm.
decode_step`` with ``group=``) a prefill runs each position's query
heads through the core (the flash kernel under impl "pallas") and keeps
every kv head of the whole sequence on every position, from which each
position keeps its time block of the decode cache (:class:`TimeShards`,
the reference's split-T layout, ``sharding.cache_specs``).  A decode step
gathers q, k_new and v_new to every head on every position, writes the
new slot on the position that owns it, and merges the positions'
online-softmax partials (``attend_decode_sharded``: pmax, then the sums
of ``l * corr`` and ``acc * corr``).  A cache length the group does not
divide keeps the whole cache on every position instead, each attending
with the single-device path (the decode kernel on a global layer).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import product
from repro_torch.models import modules as nn
from repro_torch.parallel.sharding import current_env

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


class TimeShards(tuple):
    """Each position's time block of a split-T decode cache, in group
    order: position m holds slots m*T/n .. (m+1)*T/n - 1 of every kv
    head (a plain PerPos of caches holds the whole cache everywhere)."""


def _qkv_tp(p, cfg, x, angles, whole_q: bool = False):
    """``_qkv`` on a model group, as the reference places it: one fused
    ``column_parallel`` of wq, wk and wv on the seq-sharded ``x``, q
    split on heads (H/tp a position), k and v all-gathered to every kv
    head on every position, so that any kv-head count works; ``angles``
    a PerPos of the full sequence's.  ``whole_q`` gathers q to every
    head too (a split-T decode step, or a head count the group does not
    divide: ``_apply_tp``)."""
    from repro_torch.parallel import collectives as col
    qf, kf, vf = col.column_parallel(x, [p["wq"], p["wk"], p["wv"]])
    hd, kv = cfg.head_dim, cfg.n_kv_heads
    whole_q = whole_q or cfg.n_heads % x.group.size != 0
    kf = col.full_cols(kf, kv * hd, "kv")   # column blocks: every head
    vf = col.full_cols(vf, kv * hd, "kv")
    if whole_q:
        qf = col.full_cols(qf, cfg.n_heads * hd, "q")
    q = col.local(lambda t: _split_heads(t, t.shape[-1] // hd, hd), qf)
    k = col.local(lambda t: _split_heads(t, kv, hd), kf)
    v = col.local(lambda t: _split_heads(t, kv, hd), vf)
    if cfg.qk_norm:
        q, k = col.local(lambda a, b, sq, sk: nn.qk_rmsnorm(
            a, b, sq, sk, cfg.norm_eps, cfg.impl), q, k, p["q_norm"],
            p["k_norm"])
    if cfg.rope and angles is not None:
        q = col.local(nn.apply_rope, q, angles)
        k = col.local(nn.apply_rope, k, angles)
    return q, k, v


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
    """The reference's ``jnp.einsum(eq, a, b, preferred_element_type=
    jnp.float32)``, an fp32 tensor (``product.einsum32``): two bf16
    operands on the card are one bf16 x bf16 -> fp32 tensor-core GEMM
    saving the bf16 operands; on the CPU, or any other dtype pair, the
    einsum of the operands promoted to fp32."""
    return product.einsum32(eq, a, b)


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
# split-T decode on a model group
# ---------------------------------------------------------------------------
def _valid_slots(slots, pos, T: int, window):
    """Which cache slots hold a position the query at ``pos`` attends:
    slot <= pos (global), or a ring slot whose absolute position lies in
    the window (local; T is the ring's length, min(window, max_len))."""
    if window is None:
        return slots <= pos
    abs_pos = pos - ((pos - slots) % T)
    return (abs_pos >= 0) & (abs_pos > pos - window)


def _decode_partial(q, k, v, valid, *, scale, softcap, n_kv: int):
    """The reference's partial attention over a cache slice.  q
    (B,1,H,hd); k/v (B,Tl,Kv*hd); valid (Tl,) bool.  Returns (m, l, acc),
    the probabilities rounded to v's dtype before their product."""
    B, _, H, hd = q.shape
    Tl = k.shape[1]
    kk = k.reshape(B, Tl, n_kv, hd)
    vv = v.reshape(B, Tl, n_kv, hd)
    qg = q.reshape(B, n_kv, H // n_kv, hd)
    s = _einsum32("bkgd,btkd->bkgt", qg, kk) * scale
    s = nn.softcap(s, softcap)
    s = torch.where(valid[None, None, None], s, NEG_INF)
    m = s.amax(-1)                                      # (B,Kv,G)
    p = torch.exp(s - m[..., None])
    acc = _einsum32("bkgt,btkd->bkgd", p.to(vv.dtype), vv)
    return m, p.sum(-1), acc


def merge_partials(parts, group, site: str):
    """The reference's merge of per-position online-softmax partials
    [(m, l, acc)]: pmax of m, then the sums of ``l * corr`` and ``acc *
    corr``; returns acc / l on every position (fp32)."""
    from repro_torch.parallel import collectives as col
    m_g = col.all_reduce([m for m, _, _ in parts], group, site, op="max")
    corr = [torch.exp(m - m_g[i]) for i, (m, _, _) in enumerate(parts)]
    l_g = col.all_reduce([l * c for (_, l, _), c in zip(parts, corr)],
                         group, site)
    acc_g = col.all_reduce([a * c[..., None] for (_, _, a), c in
                            zip(parts, corr)], group, site)
    return [a / torch.clamp(l[..., None], min=1e-37)
            for a, l in zip(acc_g, l_g)]


def attend_decode_sharded(q, cache: TimeShards, pos, *, window, scale,
                          softcap, n_kv: int):
    """Split-T decode (the reference's ``shard_map`` body, once a
    position): q Shards (B,1,H,hd), every head on every position; each
    position scans its time block of the cache and the partials merge.
    Returns Shards (B,1,H*hd), whole on every position."""
    from repro_torch.parallel import collectives as col
    g = q.group
    B, _, H, hd = q[0].shape
    parts = []
    for m, c in enumerate(cache):
        Tl = c.k.shape[1]
        slots = m * Tl + torch.arange(Tl, device=c.k.device)
        valid = _valid_slots(slots, pos, Tl * g.size, window)
        parts.append(_decode_partial(q[m], c.k, c.v, valid, scale=scale,
                                     softcap=softcap, n_kv=n_kv))
    return col.Shards([o.to(q[m].dtype).reshape(B, 1, H * hd) for m, o in
                       enumerate(merge_partials(parts, g, "split_t"))],
                      g, None)


def cache_from_prefill_tp(k, v, window, max_len, group):
    """Each position's decode cache from the prefill's k/v (Shards, every
    kv head of the whole sequence on every position): its time block
    (:class:`TimeShards`) when the group divides the cache length, else
    the whole cache (a PerPos)."""
    from repro_torch.parallel import collectives as col
    full = [cache_from_prefill(k[m], v[m], window, max_len)
            for m in range(group.size)]
    T = full[0].k.shape[1]
    if group.size == 1 or T % group.size:
        return col.PerPos(full)
    Tl = T // group.size
    return TimeShards(AttnCache(c.k[:, m * Tl:(m + 1) * Tl].clone(),
                                c.v[:, m * Tl:(m + 1) * Tl].clone())
                      for m, c in enumerate(full))


def _apply_decode_tp(p, cfg, x, cache, pos, *, kind: str, angles):
    """The decode step on a model group: x Shards (B,1,D) whole on every
    position, ``cache`` its positions' caches.  The new slot's k/v go to
    the position that owns the slot (every position of a whole cache);
    then the split-T attention, or each position's single-device
    attention over its whole cache, and ``row_parallel`` of wo, whose
    partial products are all-reduced."""
    from repro_torch.parallel import collectives as col
    window = cfg.sliding_window if kind == "local" else None
    q, k_new, v_new = _qkv_tp(p, cfg, x, angles, whole_q=True)
    g = x.group
    B = x[0].shape[0]
    kw = dict(scale=_scale(cfg), softcap=cfg.attn_softcap)
    if isinstance(cache, TimeShards):
        Tl = cache[0].k.shape[1]
        slot = pos % (Tl * g.size) if window is not None else pos
        m = slot // Tl
        cache[m].k[:, slot - m * Tl] = k_new[m].reshape(B, -1)
        cache[m].v[:, slot - m * Tl] = v_new[m].reshape(B, -1)
        o = attend_decode_sharded(q, cache, pos, window=window,
                                  n_kv=cfg.n_kv_heads, **kw)
    else:
        cache = col.PerPos(cache_update_decode(c, k_new[m], v_new[m], pos,
                                               window)
                           for m, c in enumerate(cache))
        o = col.Shards([_attend_whole(cfg, q[m], c, pos, window, kw)
                        for m, c in enumerate(cache)], g, None)
    return col.row_parallel(o, p["wo"]), cache


def _attend_whole(cfg, q, cache, pos, window, kw):
    """One position's decode attention over a whole cache: the
    decode-attention kernel on a global layer under impl "pallas", else
    the plain path."""
    if window is None and cfg.impl == "pallas":
        from repro_torch.kernels import ops as kops
        B, T = cache.k.shape[:2]
        H, Kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        o = kops.decode_attention(q.reshape(B, H, hd).contiguous(),
                                  cache.k.view(B, T, Kv, hd),
                                  cache.v.view(B, T, Kv, hd), pos, **kw)
        return o.reshape(B, 1, H * hd)
    return attend_decode(q, cache, pos, window=window, n_kv=cfg.n_kv_heads,
                         **kw)


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
    ok = _valid_slots(torch.arange(T, device=q.device), pos, T, window)
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


class StripedPagedCache(NamedTuple):
    """A pool striped over M devices: stripe d holds physical rows
    [d*L, (d+1)*L) (L = n_pages / M) as its local rows 0..L-1, plus a
    sink row L that only receives the writes of rows other stripes own
    (nothing reads it).  k[d], v[d] (L+1, page_size, Kv*hd) live on
    stripe d's device."""
    k: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]

    @property
    def rows(self) -> int:
        """L: the physical rows a stripe owns."""
        return self.k[0].shape[0] - 1

    @property
    def page_size(self) -> int:
        return self.k[0].shape[1]


def _paged_shard_axes(env, n_pages: int):
    """The mesh axis the page pools stripe over, or None when the
    single-device path applies (no env, trivial axis, or a page count
    the stripe cannot divide)."""
    if env is None:
        return None
    axes = env.resolve("pages")
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    if len(axes) != 1:
        return None
    n = env.mesh.shape[axes[0]]
    if n <= 1 or n_pages % n:
        return None
    return axes


def paged_cache_init(cfg, n_pages: int, page_size: int, dtype, device):
    """The zeroed pools of one layer: one (n_pages, page_size, Kv*hd)
    tensor pair on ``device``, or, under a sharding environment that
    stripes "pages", a :class:`StripedPagedCache` over the devices along
    that mesh axis."""
    F = cfg.n_kv_heads * cfg.head_dim
    env = current_env()
    axes = _paged_shard_axes(env, n_pages)
    if axes is None:
        shape = (n_pages, page_size, F)
        return PagedAttnCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device))
    devs = env.mesh.axis_devices(axes[0])
    shape = (n_pages // len(devs) + 1, page_size, F)
    return StripedPagedCache(
        k=tuple(torch.zeros(shape, dtype=dtype, device=d) for d in devs),
        v=tuple(torch.zeros(shape, dtype=dtype, device=d) for d in devs))


def _striped_put(pool: StripedPagedCache, rows, slots, k, v):
    """Write k/v (N, Kv*hd) at physical ``rows`` (N,), page slots
    ``slots`` (N,), in place: one scatter a stripe, the rows it does not
    own sent to its sink row (duplicates there collide harmlessly)."""
    L = pool.rows
    for j, (kj, vj) in enumerate(zip(pool.k, pool.v)):
        d = kj.device
        local = rows.to(d) - j * L
        local = torch.where((local >= 0) & (local < L), local, L)
        idx = (local, slots.to(d))
        kj.index_put_(idx, k.to(d))
        vj.index_put_(idx, v.to(d))


def _striped_gather(pool: StripedPagedCache, rows, device):
    """(k, v) (N, page_size, Kv*hd) of the physical ``rows`` (N,) on
    ``device``, each row read from its owner stripe (one fixed-shape
    gather a stripe, merged by select)."""
    L = pool.rows
    k = v = None
    for j, (kj, vj) in enumerate(zip(pool.k, pool.v)):
        d = kj.device
        local = rows.to(d) - j * L
        mine = (local >= 0) & (local < L)
        safe = torch.where(mine, local, 0)
        gk, gv = kj[safe].to(device), vj[safe].to(device)
        if k is None:
            k, v = gk, gv
        else:
            sel = mine.to(device)[:, None, None]
            k = torch.where(sel, gk, k)
            v = torch.where(sel, gv, v)
    return k, v


def paged_cache_update(pool, k_new, v_new, block_tables, pos):
    """Write step-t k/v (B,1,Kv,hd) into page ``block_tables[b, t//ps]``,
    slot t%ps, in place (the reference donates the pool instead).
    Inactive batch slots point at the null page; their writes collide
    there harmlessly."""
    B = k_new.shape[0]
    striped = isinstance(pool, StripedPagedCache)
    ps = pool.page_size if striped else pool.k.shape[1]
    pos = pos.long()
    page = block_tables.long().gather(1, (pos // ps)[:, None])[:, 0]
    slot = pos % ps
    if striped:
        _striped_put(pool, page, slot, k_new.reshape(B, -1),
                     v_new.reshape(B, -1))
        return pool
    pool.k.index_put_((page, slot), k_new.reshape(B, -1))
    pool.v.index_put_((page, slot), v_new.reshape(B, -1))
    return pool


def attend_decode_paged_sharded(q, pool: StripedPagedCache, block_tables,
                                pos, *, scale, softcap, n_kv: int,
                                impl=None):
    """Striped-pool decode: the reference's ``shard_map`` body once per
    stripe, on the stripe's device, then its merge on ``q``'s device.

    Stripe j attends only the table entries whose physical rows it owns
    (``[j*L, (j+1)*L)``), through its local safe table (unowned entries
    name local row 0) and their ownership mask, and yields its
    online-softmax partials (m, l, acc); the merge rescales them by
    exp(m - max m) and sums, as the reference's ``pmax``/``psum``.  A
    stripe a sequence does not touch has m = NEG_INF and adds exactly 0.
    ``impl == "pallas"`` runs the paged-decode kernel in its masked
    partials mode; otherwise the reference's plain body, whose
    probabilities of unowned slots are set to exactly 0 (the reference
    leaves exp(0) = 1 there when a stripe owns nothing; the merge gives
    them weight 0 either way)."""
    B, _, H, hd = q.shape
    L, ps = pool.rows, pool.page_size
    Kv = n_kv
    G = H // Kv
    T = block_tables.shape[1] * ps
    dev = q.device
    parts = []
    for j, (kj, vj) in enumerate(zip(pool.k, pool.v)):
        d = kj.device
        local = block_tables.to(d) - j * L
        mine = (local >= 0) & (local < L)
        safe = torch.where(mine, local, 0)
        q_l, pos_l = q.to(d), pos.to(d)
        if impl == "pallas":
            from repro_torch.kernels import ops as kops
            acc, m, l = kops.paged_decode_attention(
                q_l.reshape(B, H, hd), kj.view(L + 1, ps, Kv, hd),
                vj.view(L + 1, ps, Kv, hd), safe, pos_l, scale=scale,
                softcap=softcap, page_mask=mine.to(torch.int32),
                partials=True)
        else:
            k = kj[safe.long()].reshape(B, T, Kv, hd)
            v = vj[safe.long()].reshape(B, T, Kv, hd)
            qg = q_l.reshape(B, Kv, G, hd)
            s = _einsum32("bkgd,btkd->bkgt", qg, k) * scale
            s = nn.softcap(s, softcap)
            valid = (torch.arange(T, device=d)[None, :]
                     <= pos_l.long()[:, None]) \
                & mine.repeat_interleave(ps, dim=1)
            valid = valid[:, None, None, :]
            s = torch.where(valid, s, NEG_INF)
            m = s.amax(-1)                                  # (B,Kv,G)
            p = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
            l = p.sum(-1)
            acc = _einsum32("bkgt,btkd->bkgd", p.to(v.dtype), v)
        parts.append((m.to(dev), l.to(dev), acc.to(dev)))
    m_g = parts[0][0]
    for m, _, _ in parts[1:]:
        m_g = torch.maximum(m_g, m)
    l_g = acc_g = 0.0
    for m, l, acc in parts:
        corr = torch.exp(m - m_g)
        l_g = l_g + l * corr
        acc_g = acc_g + acc * corr[..., None]
    o = acc_g / torch.clamp(l_g[..., None], min=1e-37)
    return o.to(q.dtype).reshape(B, 1, H * hd)


def attend_decode_paged(q, pool, block_tables, pos, *, scale, softcap,
                        n_kv: int, impl=None):
    """q (B,1,H,hd); pool pages (P,ps,Kv*hd); pos (B,) int32.

    ``impl == "pallas"`` runs the paged-decode kernel; otherwise the
    sequence's pages are gathered through the block table and attended
    with the same masked arithmetic as the dense path.  A striped pool
    takes the per-stripe partials path (same math, partials merged)."""
    if isinstance(pool, StripedPagedCache):
        return attend_decode_paged_sharded(
            q, pool, block_tables, pos, scale=scale, softcap=softcap,
            n_kv=n_kv, impl=impl)
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


def paged_cache_from_prefill(pool, k, v, block_row, start: int = 0):
    """Scatter prefill k/v (1,S,Kv,hd) of ONE sequence into the pool, in
    place; tokens land at logical slots start..start+S-1 of the pages
    named by ``block_row`` (nmax,)."""
    S = k.shape[1]
    striped = isinstance(pool, StripedPagedCache)
    dev = pool.k[0].device if striped else pool.k.device
    ps = pool.page_size if striped else pool.k.shape[1]
    t = start + torch.arange(S, device=dev)
    page = block_row.to(dev).long()[t // ps]
    slot = t % ps
    if striped:
        _striped_put(pool, page, slot, k.reshape(S, -1), v.reshape(S, -1))
        return pool
    pool.k.index_put_((page, slot), k.reshape(S, -1))
    pool.v.index_put_((page, slot), v.reshape(S, -1))
    return pool


def paged_cache_scatter_suffix(pool, k, v, block_row, start, n_valid):
    """Scatter a prompt *suffix*'s kv (1,W,Kv,hd) into the pool, in place,
    at logical positions start..start+W-1 (a prefix-cache hit: the first
    ``start`` positions already live in shared pages).  Slots at or past
    ``n_valid`` are padding and go to the null page, whose garbage is
    masked by design, so one width serves every suffix length in a
    bucket.  ``start`` and ``n_valid`` are ints or 0-d device tensors."""
    W = k.shape[1]
    striped = isinstance(pool, StripedPagedCache)
    dev = block_row.device
    ps = pool.page_size if striped else pool.k.shape[1]
    w = torch.arange(W, device=dev)
    t = start + w
    idx = torch.clamp(t // ps, 0, block_row.shape[0] - 1)
    # physical page 0 is the reserved null page (serving/paged_kv.py)
    page = torch.where(w < n_valid, block_row.long()[idx], 0)
    slot = t % ps
    if striped:
        _striped_put(pool, page, slot, k.reshape(W, -1), v.reshape(W, -1))
        return pool
    pool.k.index_put_((page, slot), k.reshape(W, -1))
    pool.v.index_put_((page, slot), v.reshape(W, -1))
    return pool


def attend_prefill_paged(q, pool: PagedAttnCache, block_row, start, *,
                         scale, softcap, n_kv: int):
    """Suffix-prefill attention: q (1,W,H,hd) holds query positions
    start..start+W-1; keys/values are gathered from the sequence's pages
    (cached prefix + the just-scattered suffix; each page from its stripe
    in a striped pool) and masked causally at ``j <= start + w`` — plain
    tensor ops with the decode path's fp32 scores and softmax, as in the
    reference (which has no kernel here)."""
    B, W, H, hd = q.shape
    Kv = n_kv
    if isinstance(pool, StripedPagedCache):
        ps = pool.page_size
        T = block_row.shape[0] * ps
        k, v = _striped_gather(pool, block_row.long(), q.device)
        k, v = k.reshape(B, T, Kv, hd), v.reshape(B, T, Kv, hd)
    else:
        ps = pool.k.shape[1]
        T = block_row.shape[0] * ps
        bt = block_row.long()
        k = pool.k[bt].reshape(B, T, Kv, hd)
        v = pool.v[bt].reshape(B, T, Kv, hd)
    qg = q.reshape(B, W, Kv, H // Kv, hd)
    s = _einsum32("bwkgd,btkd->bkgwt", qg, k) * scale
    s = nn.softcap(s, softcap)
    dev = q.device
    ok = torch.arange(T, device=dev)[None, :] \
        <= (start + torch.arange(W, device=dev))[:, None]
    s = torch.where(ok[None, None, None], s, NEG_INF)
    w = torch.softmax(s.float(), dim=-1)
    o = _einsum32("bkgwt,btkd->bwkgd", w.to(v.dtype), v).to(q.dtype)
    return o.reshape(B, W, H * hd)


def apply_prefill_paged(p, cfg, x, pool: PagedAttnCache, block_row, start,
                        n_valid, *, angles):
    """Paged suffix-prefill path: x (1,W,D) at positions start..;
    scatters the suffix kv then attends over the whole page run.
    Returns (out (1,W,D'), pool)."""
    q, k_new, v_new = _qkv(p, cfg, x, angles)
    pool = paged_cache_scatter_suffix(pool, k_new, v_new, block_row,
                                      start, n_valid)
    o = attend_prefill_paged(q, pool, block_row, start, scale=_scale(cfg),
                             softcap=cfg.attn_softcap, n_kv=cfg.n_kv_heads)
    return nn.matmul(o, p["wo"]), pool


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
def _apply_tp(p, cfg, x, *, kind: str, angles):
    """The train forward and the prefill on a model group: ``_qkv_tp``,
    each position's heads through the core (ref, blocked, or the flash
    kernel under impl "pallas", which has no backward) against the kv
    heads they read, then ``row_parallel`` of wo back to the residual
    stream's layout.  A head count the group does not divide (40 heads
    over 16 positions) takes q whole on every position, and position m
    computes the heads that cover its row block of wo (m * H * hd / n
    onwards), a head shared with a neighbour on both, and keeps that
    block's columns.  Returns (out, (k, v): Shards of every kv head of
    the whole sequence)."""
    from repro_torch.parallel import collectives as col
    q, k, v = _qkv_tp(p, cfg, x, angles)
    window = cfg.sliding_window if kind == "local" else None
    kw = dict(causal=cfg.causal, window=window, scale=_scale(cfg),
              softcap=cfg.attn_softcap)
    hd, n = cfg.head_dim, x.group.size

    def core(m, q_m, k_m, v_m):
        cols = None
        if cfg.n_heads % n:
            c = cfg.n_heads * hd // n          # wo's rows a position
            h0, h1 = m * c // hd, -(-(m + 1) * c // hd)
            heads, cols = slice(h0, h1), slice(m * c - h0 * hd,
                                               (m + 1) * c - h0 * hd)
            q_m = q_m[:, :, heads]
        else:
            hl = q_m.shape[2]
            heads = slice(m * hl, (m + 1) * hl)
        hl = q_m.shape[2]
        kh = expand_kv(k_m, cfg.n_heads)[:, :, heads]
        vh = expand_kv(v_m, cfg.n_heads)[:, :, heads]
        if cfg.impl == "ref":
            o = attend_ref(q_m, kh, vh, **kw)
        elif cfg.impl == "blocked":
            o = attend_blocked(q_m, kh, vh, block_q=cfg.attn_block_q,
                               block_kv=cfg.attn_block_kv, **kw)
        elif cfg.impl == "pallas":
            from repro_torch.kernels import ops as kops
            o = kops.flash_attention(q_m.contiguous(), kh.contiguous(),
                                     vh.contiguous(), **kw)
        else:
            raise ValueError(cfg.impl)
        o = o.reshape(*o.shape[:2], hl * hd)
        return o if cols is None else o[..., cols]
    o = col.local(core, q, k, v, index=True)
    return col.row_parallel(o, p["wo"]), (k, v)


def apply(p, cfg, x, *, kind: str, angles):
    """Prefill path, routed by ``cfg.impl``. Returns (out, (k, v)).  On
    a model group (``x`` the seq-sharded Shards of a mesh's train
    forward) ``_apply_tp``, which keeps no cache."""
    from repro_torch.parallel import collectives as col
    if isinstance(x, col.Shards):
        return _apply_tp(p, cfg, x, kind=kind, angles=angles)
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
    falls outside the kernel's ``slot <= pos`` mask and stays plain.  On
    a model group (``x`` Shards) ``_apply_decode_tp``."""
    from repro_torch.parallel import collectives as col
    if isinstance(x, col.Shards):
        return _apply_decode_tp(p, cfg, x, cache, pos, kind=kind,
                                angles=angles)
    window = cfg.sliding_window if kind == "local" else None
    q, k_new, v_new = _qkv(p, cfg, x, angles)
    cache = cache_update_decode(cache, k_new, v_new, pos, window)
    kw = dict(scale=_scale(cfg), softcap=cfg.attn_softcap)
    o = _attend_whole(cfg, q, cache, pos, window, kw)
    return nn.matmul(o, p["wo"]), cache
