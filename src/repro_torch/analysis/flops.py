"""Analytic per-step cost model: HLO-equivalent FLOPs and HBM bytes.

``compiled.cost_analysis()`` counts while/scan bodies once, so for a
scanned-layer model it undercounts by ~n_layers.  This module computes the
*HLO-equivalent* global FLOPs (what the device actually executes,
including blocked-attention full-S^2 compute, MoE capacity padding,
GSPMD head-padding waste, remat recompute and the backward pass) plus a
per-chip HBM-traffic model.  Validated against cost_analysis() on small
*unrolled* configs in tests/test_cost_model.py.

MODEL_FLOPS (the "useful" count) = 6*N_active*tokens for training,
2*N_active*tokens for inference — the MaxText/PaLM convention.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import (ATTN, LOCAL, MLA, RGLRU, RWKV6, ModelConfig,
                                ShapeConfig)
# the RWKV-6 scan chunk (reference: models/rwkv6.py CHUNK), copied so the
# cost model needs no model module of the port
RWKV_CHUNK = 32


@dataclass
class CellCost:
    flops_fwd: float = 0.0          # global forward FLOPs (one step)
    flops_total: float = 0.0        # incl. backward + remat (train)
    hbm_bytes_per_chip: float = 0.0
    model_flops: float = 0.0        # 6*N_active*D (train) / 2*N*D (infer)
    breakdown: Dict[str, float] = field(default_factory=dict)

    def add(self, name: str, flops: float):
        self.flops_fwd += flops
        self.breakdown[name] = self.breakdown.get(name, 0.0) + flops


def _pad_factor(n: int, shards: int) -> float:
    """GSPMD padding waste when n is sharded over `shards`."""
    if shards <= 1:
        return 1.0
    return math.ceil(n / shards) * shards / n


def _blocked(block: int, s: int) -> int:
    b = min(block, s)
    while s % b:
        b -= 1
    return b


def attention_core_flops(cfg: ModelConfig, kind: str, S: int, B: int,
                         mode: str, tp: int, cache_len: int = 0) -> float:
    """Score + AV einsum FLOPs (global), incl. sharding-padding waste."""
    H, hd = cfg.n_heads, cfg.head_dim
    if cfg.mla is not None:
        m = cfg.mla
        qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
        v_dim = qk_dim  # v is padded to qk_dim in the blocked path
    else:
        qk_dim = v_dim = hd
    pad = _pad_factor(cfg.n_kv_heads if cfg.mla is None else H, tp)
    if mode == "decode":
        T = cache_len
        if kind == LOCAL:
            T = min(cfg.sliding_window, T)
        if cfg.mla is not None:
            m = cfg.mla
            lat = m.kv_lora_rank + m.qk_rope_head_dim
            # absorbed decode: scores vs latent + output in latent space
            core = 2.0 * B * H * T * lat + 2.0 * B * H * T * m.kv_lora_rank
            absorb = 2.0 * B * H * m.qk_nope_head_dim * m.kv_lora_rank \
                + 2.0 * B * H * m.kv_lora_rank * m.v_head_dim
            return (core + absorb) * _pad_factor(H, tp)
        return (2.0 * B * H * T * qk_dim + 2.0 * B * H * T * v_dim) * pad
    # train / prefill — blocked flash computes the full S^2 (masked), except
    # the sliding-window fast path which only touches the window span
    if kind == LOCAL and cfg.causal:
        bq = _blocked(cfg.attn_block_q, S)
        span = cfg.sliding_window + bq
        if span < S:
            kv_span = span
        else:
            kv_span = S
    else:
        kv_span = S
    return (2.0 * B * H * S * kv_span * qk_dim
            + 2.0 * B * H * S * kv_span * v_dim) * pad


def layer_flops(cfg: ModelConfig, kind: str, is_moe: bool, t: float,
                S: int, B: int, mode: str, tp: int,
                cache_len: int = 0) -> Dict[str, float]:
    """Global forward FLOPs for one layer. t = tokens processed."""
    d = cfg.d_model
    out: Dict[str, float] = {}
    mm = lambda m, k, n: 2.0 * m * k * n

    if kind in (ATTN, LOCAL):
        out["attn_proj"] = (mm(t, d, cfg.q_dim) + 2 * mm(t, d, cfg.kv_dim)
                            + mm(t, cfg.q_dim, d))
        out["attn_core"] = attention_core_flops(cfg, kind, S, B, mode, tp,
                                                cache_len)
    elif kind == MLA:
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        out["attn_proj"] = (
            mm(t, d, m.q_lora_rank) + mm(t, m.q_lora_rank, cfg.n_heads * qk)
            + mm(t, d, m.kv_lora_rank + m.qk_rope_head_dim)
            + mm(t, cfg.n_heads * m.v_head_dim, d))
        if mode != "decode":   # decode absorbs kv_b (counted in core)
            out["attn_proj"] += mm(t, m.kv_lora_rank,
                                   cfg.n_heads * (m.qk_nope_head_dim
                                                  + m.v_head_dim))
        out["attn_core"] = attention_core_flops(cfg, kind, S, B, mode, tp,
                                                cache_len)
    elif kind == RGLRU:
        w = cfg.lru_width or d
        hd = w // cfg.n_heads
        out["rglru_proj"] = 3 * mm(t, d, w)
        out["rglru_gates"] = 2 * mm(t * cfg.n_heads, hd, hd)
        out["rglru_scan"] = 12.0 * t * w  # conv + gating + assoc-scan
    elif kind == RWKV6:
        out["rwkv_proj"] = 5 * mm(t, d, d)
        out["rwkv_lora"] = (mm(t, d, 5 * 32) + 5 * mm(t, 32, d)
                            + mm(t, d, 64) + mm(t, 64, d))
        H, hd = cfg.n_heads, cfg.head_dim
        L = min(RWKV_CHUNK, S if mode != "decode" else 1)
        nc = max(1, (S if mode != "decode" else 1) // L)
        per_chunk = (2.0 * B * H * L * hd * hd      # inter (o += q @ S0)
                     + 3.0 * B * H * L * L * hd     # intra decay product
                     + 2.0 * B * H * L * L * hd     # intra o
                     + 2.0 * B * H * L * hd * hd)   # state update
        out["rwkv_core"] = per_chunk * nc * _pad_factor(H, tp)
        out["rwkv_cm"] = mm(t, d, cfg.d_ff) + mm(t, cfg.d_ff, d) + mm(t, d, d)
        return out
    else:
        raise ValueError(kind)

    if is_moe:
        m = cfg.moe
        # dispatch capacity is computed per data-shard token count; the
        # padded slot count is what the grouped GEMM actually computes
        slots = t * m.top_k * m.capacity_factor
        n_mats = 3 if cfg.gated_ffn else 2
        out["moe_router"] = mm(t, d, m.n_experts)
        out["moe_experts"] = n_mats * mm(slots, d, m.d_ff_expert)
        if m.n_shared:
            out["moe_shared"] = n_mats * mm(t, d, m.d_ff_expert * m.n_shared)
    else:
        n_mats = 3 if cfg.gated_ffn else 2
        out["ffn"] = n_mats * mm(t, d, cfg.d_ff)
    return out


def step_costs(cfg: ModelConfig, shape: ShapeConfig, n_chips: int,
               tp: int = 16) -> CellCost:
    """Full-step analytic cost for one (arch x shape) cell."""
    mode = shape.kind
    B = shape.global_batch
    S = shape.seq_len
    d = cfg.d_model
    cost = CellCost()
    mm = lambda m, k, n: 2.0 * m * k * n

    if mode == "decode":
        t = float(B)          # one token per sequence
        S_eff = 1
        cache_len = S
    else:
        t = float(B) * S
        S_eff = S
        cache_len = 0

    for i, kind in enumerate(cfg.layer_kinds):
        is_moe = cfg.moe is not None and i >= cfg.first_k_dense
        for name, f in layer_flops(cfg, kind, is_moe, t, S_eff, B, mode, tp,
                                   cache_len).items():
            cost.add(name, f)

    # head / loss
    V = cfg.vocab_size
    if mode == "train":
        cost.add("head", mm(t, d, V) + 6.0 * t * V)   # logits + CE softmax
        if cfg.mtp_depth:
            seg_kind = cfg.layer_kinds[-1]
            is_moe = cfg.moe is not None
            cost.add("mtp_proj", mm(t, 2 * d, d))
            for name, f in layer_flops(cfg, seg_kind, is_moe, t, S_eff, B,
                                       mode, tp).items():
                cost.add("mtp_" + name, f)
            cost.add("mtp_head", mm(t, d, V) + 6.0 * t * V)
    else:
        t_head = float(B)     # prefill/decode: only last-position logits
        cost.add("head", mm(t_head, d, V))

    # --- totals -------------------------------------------------------------
    if mode == "train":
        # backward = 2x fwd matmuls; remat recomputes the scanned fwd once
        fwd = cost.flops_fwd
        remat = fwd if cfg.remat else 0.0
        cost.flops_total = fwd * 3.0 + remat
        tokens_for_model = t
        cost.model_flops = 6.0 * cfg.n_active_params() * tokens_for_model
    else:
        cost.flops_total = cost.flops_fwd
        cost.model_flops = 2.0 * _n_active_no_mtp(cfg) * t

    cost.hbm_bytes_per_chip = hbm_bytes_per_chip(cfg, shape, n_chips, tp)
    return cost


def _n_active_no_mtp(cfg: ModelConfig) -> float:
    """Active params for inference MODEL_FLOPS: excludes MTP modules and
    the vocab matrices (embedding lookup is a gather; the unembed runs
    only on the last position for prefill/decode)."""
    n = cfg.n_active_params()
    n -= cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    if cfg.mtp_depth:
        # MTP modules are train-only
        mtp = cfg._mixer_params(cfg.layer_kinds[-1]) + 3 * cfg.d_model \
            + cfg.d_model * 2 * cfg.d_model
        if cfg.moe is not None:
            m = cfg.moe
            per = (3 if cfg.gated_ffn else 2) * cfg.d_model * m.d_ff_expert
            mtp += (m.top_k + m.n_shared) * per
        n -= cfg.mtp_depth * mtp
    return float(n)


def param_bytes(cfg: ModelConfig) -> float:
    bpp = {"float32": 4, "bfloat16": 2}[cfg.param_dtype]
    return float(cfg.n_params()) * bpp


def opt_state_bytes(cfg: ModelConfig) -> float:
    per = {"float32": 8.0, "bfloat16": 4.0, "int8": 2.02}[cfg.opt_state_dtype]
    return float(cfg.n_params()) * per


def kv_cache_bytes(cfg: ModelConfig, B: int, T: int) -> float:
    act = 2  # bf16
    total = 0.0
    for kind in cfg.layer_kinds:
        if kind == ATTN:
            total += 2.0 * B * T * cfg.kv_dim * act
        elif kind == LOCAL:
            total += 2.0 * B * min(T, cfg.sliding_window) * cfg.kv_dim * act
        elif kind == MLA:
            m = cfg.mla
            total += B * T * (m.kv_lora_rank + m.qk_rope_head_dim) * act
        elif kind == RGLRU:
            w = cfg.lru_width or cfg.d_model
            total += B * w * 4.0 + B * (cfg.conv1d_width - 1) * w * act
        elif kind == RWKV6:
            total += B * cfg.n_heads * cfg.head_dim ** 2 * 4.0 \
                + 2.0 * B * cfg.d_model * act
    return total


def activation_stream_bytes(cfg: ModelConfig, t: float) -> float:
    """Approximate global activation HBM traffic of one forward pass:
    input+output of every major matmul at bf16."""
    act = 2.0
    d = cfg.d_model
    total = 0.0
    for i, kind in enumerate(cfg.layer_kinds):
        is_moe = cfg.moe is not None and i >= cfg.first_k_dense
        if kind in (ATTN, LOCAL):
            widths = [cfg.q_dim, 2 * cfg.kv_dim, cfg.q_dim, d]
        elif kind == MLA:
            m = cfg.mla
            widths = [m.q_lora_rank,
                      cfg.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim),
                      m.kv_lora_rank + m.qk_rope_head_dim,
                      cfg.n_heads * (m.qk_nope_head_dim + m.v_head_dim), d]
        elif kind == RGLRU:
            w = cfg.lru_width or d
            widths = [w, w, w, d]
        else:  # rwkv6
            widths = [d] * 6 + [cfg.d_ff]
        for wdt in widths:
            total += t * (d + wdt) * act
        if is_moe:
            m = cfg.moe
            slots = t * m.top_k * m.capacity_factor
            n_mats = 3 if cfg.gated_ffn else 2
            total += n_mats * slots * (d + m.d_ff_expert) * act
        elif kind != RWKV6:
            n_mats = 3 if cfg.gated_ffn else 2
            total += n_mats * t * (d + cfg.d_ff) * act
    return total


def hbm_bytes_per_chip(cfg: ModelConfig, shape: ShapeConfig,
                       n_chips: int, tp: int) -> float:
    """Per-chip HBM traffic for one step (documented approximation)."""
    mode = shape.kind
    B, S = shape.global_batch, shape.seq_len
    pb = param_bytes(cfg)
    if mode == "train":
        t = float(B) * S
        # own shard r/w for optimizer + grads; gathered copies (sharded only
        # over tp) read for fwd, bwd and remat
        weights = pb / n_chips * 3.0 + 3.0 * pb / tp
        opt = opt_state_bytes(cfg) / n_chips * 2.0
        acts = activation_stream_bytes(cfg, t) / n_chips * 3.0
        return weights + opt + acts
    if mode == "prefill":
        t = float(B) * S
        weights = pb / tp
        acts = activation_stream_bytes(cfg, t) / n_chips
        cache = kv_cache_bytes(cfg, B, S) / n_chips
        return weights + acts + cache
    # decode: weights + full cache read per token
    weights = pb / tp
    cache = kv_cache_bytes(cfg, B, S) / n_chips
    acts = activation_stream_bytes(cfg, float(B)) / n_chips
    return weights + cache + acts
