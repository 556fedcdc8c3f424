"""Step builders: prefill / serve steps, dense and paged.

Reference: ``repro/steps.py``.  The reference returns functions for
``jax.jit`` with the pools donated; PyTorch runs eagerly, so these are
plain callables and the pools are updated in place.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, tokens):
        return lm.prefill(params, cfg, tokens, max_len=max_len)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: greedy-sample next token given the KV cache."""
    def serve_step(params, tokens, caches, pos):
        logits, caches = lm.decode_step(params, cfg, tokens, caches, pos)
        return logits.argmax(-1).to(torch.int32), logits, caches
    return serve_step


def make_paged_prefill_step(cfg: ModelConfig):
    """Prefill ONE sequence straight into the paged KV pools.

    (params, tokens (1,S), pools, block_row (nmax,)) ->
    (next-token logits (1,1,V), pools updated in place)."""
    def prefill_paged(params, tokens, pools, block_row):
        x, pending, raw = lm.forward(params, cfg, tokens)
        pools = lm.paged_from_prefill(cfg, pools, raw, block_row)
        return lm.last_logits(params, cfg, x, pending), pools
    return prefill_paged


def make_paged_serve_step(cfg: ModelConfig):
    """One continuous-batch paged decode step (greedy sampling).

    (params, tokens (B,1), pools, block_tables (B,nmax), pos (B,)) ->
    (next tokens (B,1), logits, pools)."""
    def serve_paged(params, tokens, pools, block_tables, pos):
        logits, pools = lm.decode_step_paged(params, cfg, tokens, pools,
                                             block_tables, pos)
        return logits.argmax(-1).to(torch.int32), logits, pools
    return serve_paged


def make_paged_serve_scan(cfg: ModelConfig):
    """Fused K-step paged decode window (device-resident serving).

    (params, tokens (B,1), pools, block_tables (B,nmax), pos (B,),
     active (B,), k) -> (emitted (B,K), last tokens (B,1), pos (B,),
    pools).  One call and one host sync cover K decode steps."""
    def serve_scan(params, tokens, pools, block_tables, pos, active, *,
                   k: int):
        return lm.decode_window_paged(params, cfg, tokens, pools,
                                      block_tables, pos, active, k)
    return serve_scan
