"""Unified LM: forward / prefill / decode over layer segments.

Reference: ``repro/models/lm.py``.  Layers are grouped into the same
homogeneous *segments* (``make_segments``).  The reference stacks a
scanned segment's parameters and caches on a leading ``n_cycles`` axis and
``lax.scan``s over it; the port keeps one entry per cycle instead:

    params["segments"][seg][cycle][j]   block params of kind seg.kinds[j]
    caches[seg][cycle][j]               that layer's decode cache
    pools[seg][cycle][j]                that layer's PagedAttnCache

and runs the cycles as a Python loop over device tensors.  As in the
reference, ``decode_step`` returns the new cache nesting: attention caches
are written in place and returned, the recurrent states (RG-LRU, RWKV-6)
are new tensors, so the caller must use the caches it gets back.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, modules as nn


class SegmentSpec(NamedTuple):
    kinds: Tuple[str, ...]
    is_moe: bool
    n_cycles: int
    scanned: bool
    start_layer: int


def make_segments(cfg: ModelConfig) -> List[SegmentSpec]:
    kinds = cfg.layer_kinds
    moe_flags = [cfg.moe is not None and i >= cfg.first_k_dense
                 for i in range(cfg.n_layers)]
    p = len(cfg.layer_pattern)
    segs: List[SegmentSpec] = []
    i = 0
    while i < cfg.n_layers:
        if i % p == 0 and i + p <= cfg.n_layers \
                and len(set(moe_flags[i:i + p])) == 1:
            # count consecutive full cycles with the same MoE signature
            n = 0
            j = i
            while j + p <= cfg.n_layers \
                    and kinds[j:j + p] == cfg.layer_pattern \
                    and len(set(moe_flags[j:j + p])) == 1 \
                    and moe_flags[j] == moe_flags[i]:
                n += 1
                j += p
            segs.append(SegmentSpec(cfg.layer_pattern, moe_flags[i], n,
                                    n > 1, i))
            i = j
        else:
            # remainder: group consecutive same-(kind, moe) layers
            k0, m0 = kinds[i], moe_flags[i]
            n = 0
            while i + n < cfg.n_layers and kinds[i + n] == k0 \
                    and moe_flags[i + n] == m0:
                n += 1
            segs.append(SegmentSpec((k0,), m0, n, n > 1, i))
            i += n
    assert sum(s.n_cycles * len(s.kinds) for s in segs) == cfg.n_layers
    return segs


def _layers(cfg, params, states):
    """Yield (kind, block params, state, (seg, cycle, j)) for every layer
    in order; ``states`` mirrors the segment/cycle nesting (or is None)."""
    for si, seg in enumerate(make_segments(cfg)):
        for c in range(seg.n_cycles):
            for j, kind in enumerate(seg.kinds):
                st = None if states is None else states[si][c][j]
                yield kind, params["segments"][si][c][j], st, (si, c, j)


def _nest(cfg, fn):
    """The segment/cycle/kind nesting with ``fn(kind, (seg, cycle, j))``
    at every layer."""
    return [[tuple(fn(kind, (si, c, j)) for j, kind in enumerate(seg.kinds))
             for c in range(seg.n_cycles)]
            for si, seg in enumerate(make_segments(cfg))]


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------
def _angles(cfg, positions):
    if not cfg.rope:
        return None
    return nn.rope_angles(positions, cfg.head_dim, cfg.rope_theta,
                          cfg.mrope_sections)


def default_positions(batch: int, seq: int, device=None):
    return torch.arange(seq, dtype=torch.int32, device=device)[None].expand(
        batch, seq)


def embed_tokens(params, cfg, tokens):
    if not cfg.embed_inputs:
        raise NotImplementedError(
            "embedding-input (audio/vlm) frontends are not ported yet")
    table = params["embed"]["embed_table"]
    x = table[tokens.long()].to(nn.dt(cfg.activation_dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def head_logits(params, cfg, h):
    """h (..., D) -> fp32 logits (..., V), with final softcap.  The tied
    head promotes bf16 ``h`` against the fp32 table, as JAX does."""
    if cfg.tie_embeddings and cfg.embed_inputs:
        logits = h.float() @ params["embed"]["embed_table"].float().T
    else:
        logits = h.float() @ params["head"]["head_w"].float()
    if cfg.logit_softcap is not None:
        logits = nn.softcap(logits, cfg.logit_softcap)
    return logits


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------
def forward(params, cfg: ModelConfig, tokens):
    """Prefill forward (the training path is not ported yet).  tokens:
    (B,S) int ids.  Returns (x, pending, raw caches): the residual stream
    before the last layer's branch output ``pending`` is added (h_final =
    x + pending, pre-final-norm; ``last_logits`` adds it fused with the
    final norm), and the per-layer nesting of (k, v) or recurrent caches,
    converted by ``caches_from_prefill``."""
    x = embed_tokens(params, cfg, tokens)
    B, S = x.shape[:2]
    angles = _angles(cfg, default_positions(B, S, device=x.device))
    raw, pending = {}, None
    for kind, p, _, key in _layers(cfg, params, None):
        x, pending, raw[key] = blocks.apply(p, cfg, kind, x, pending,
                                            angles=angles)
    return x, pending, _nest(cfg, lambda kind, key: raw[key])


def final_norm(params, cfg, x, pending):
    """The last residual add fused with the final norm."""
    return nn.add_rmsnorm(x, pending, params["final_norm"]["scale"],
                          cfg.norm_eps, cfg.impl)[1]


def last_logits(params, cfg, x, pending):
    """Next-token logits (B,1,V) of the last position of a prefill."""
    return head_logits(params, cfg, final_norm(params, cfg, x[:, -1:],
                                               pending[:, -1:]))


# ---------------------------------------------------------------------------
# prefill / dense decode (the oracle path)
# ---------------------------------------------------------------------------
def caches_from_prefill(cfg, raw_caches, max_len: int):
    return _nest(cfg, lambda kind, key: blocks.cache_from_prefill(
        cfg, kind, raw_caches[key[0]][key[1]][key[2]], max_len))


def prefill(params, cfg, tokens, *, max_len: int):
    """Returns (next-token logits (B,1,V), decode caches)."""
    x, pending, raw = forward(params, cfg, tokens)
    caches = caches_from_prefill(cfg, raw, max_len)
    return last_logits(params, cfg, x, pending), caches


def init_caches(cfg, batch: int, max_len: int, device):
    dtype = nn.dt(cfg.activation_dtype)
    return _nest(cfg, lambda kind, key: blocks.cache_init(
        cfg, kind, batch, max_len, dtype, device))


def decode_step(params, cfg, tokens, caches, pos):
    """One decode step. tokens (B,1) ids; pos int (shared position).

    Returns (logits (B,1,V), new caches)."""
    x = embed_tokens(params, cfg, tokens)
    positions = torch.full((x.shape[0], 1), int(pos), dtype=torch.int32,
                           device=x.device)
    angles = _angles(cfg, positions)
    new, pending = {}, None
    for kind, p, cache, key in _layers(cfg, params, caches):
        x, pending, new[key] = blocks.apply_decode(
            p, cfg, kind, x, pending, cache, int(pos), angles=angles)
    h = final_norm(params, cfg, x, pending)
    return head_logits(params, cfg, h), _nest(cfg, lambda kind, key: new[key])


# ---------------------------------------------------------------------------
# paged decode — pools + block tables instead of per-sequence slabs
# ---------------------------------------------------------------------------
def paged_decodable(cfg) -> bool:
    """Paged serving needs causal, embedded-token, global-attention-only
    configs and no M-RoPE."""
    return (cfg.supports_decode and cfg.embed_inputs
            and cfg.mrope_sections is None
            and all(k == "attn" for k in cfg.layer_kinds))


def init_paged_caches(cfg, n_pages: int, page_size: int, device):
    """One PagedAttnCache per layer; all layers share one block table."""
    assert paged_decodable(cfg), f"{cfg.name} is not paged-decodable"
    dtype = nn.dt(cfg.activation_dtype)
    return _nest(cfg, lambda kind, key: blocks.paged_cache_init(
        cfg, kind, n_pages, page_size, dtype, device))


def paged_from_prefill(cfg, pools, raw_caches, block_row):
    """Scatter ONE sequence's prefill kv (from ``forward``, batch 1) into the pools at the pages named by ``block_row``, in
    place."""
    for si, seg in enumerate(make_segments(cfg)):
        for c in range(seg.n_cycles):
            for j, kind in enumerate(seg.kinds):
                blocks.paged_cache_from_prefill(
                    cfg, kind, pools[si][c][j], raw_caches[si][c][j],
                    block_row)
    return pools


def decode_step_paged(params, cfg, tokens, pools, block_tables, pos):
    """One paged decode step over a continuous batch.

    tokens (B,1) int32; block_tables (B,nmax) int32 physical page ids;
    pos (B,) int32 per-sequence positions (inactive slots: 0, with a
    null-page block row).  Returns (logits (B,1,V), pools updated in
    place)."""
    x = embed_tokens(params, cfg, tokens)
    angles = _angles(cfg, pos[:, None].to(torch.int32))
    pending = None
    for kind, p, pool, _ in _layers(cfg, params, pools):
        x, pending, _ = blocks.apply_decode_paged(
            p, cfg, kind, x, pending, pool, block_tables, pos, angles=angles)
    h = final_norm(params, cfg, x, pending)
    return head_logits(params, cfg, h), pools


def decode_window_paged(params, cfg, tokens, pools, block_tables, pos,
                        active, k: int):
    """Fused K-step greedy decode window, entirely on device.

    The reference's ``lax.scan`` becomes a Python loop over device
    tensors: the greedy argmax of step j feeds step j+1 with no host
    round-trip, KV pages are appended in place, and per-slot positions
    advance on device.  The block tables stay fixed for the window (the
    scheduler pre-reserves its pages).

    tokens (B,1) int32 last emitted token per slot; pos (B,) int32 write
    positions; active (B,) int32 1 for occupied slots (inactive slots hold
    token/pos fixed so their null-page writes stay at slot 0).
    Returns (emitted (B,K) int32, last tokens (B,1), pos (B,), pools).
    """
    tok, p = tokens, pos
    emitted = []
    for _ in range(k):
        logits, pools = decode_step_paged(params, cfg, tok, pools,
                                          block_tables, p)
        nxt = logits.argmax(-1).to(torch.int32)                  # (B,1)
        tok = torch.where(active[:, None] > 0, nxt, tok)
        p = p + active
        emitted.append(tok[:, 0])
    return torch.stack(emitted, dim=1), tok, p, pools
