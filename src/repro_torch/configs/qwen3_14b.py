"""Qwen3-14B [hf:Qwen/Qwen3-8B family; hf-verified].

Dense decoder: 40L, d_model=5120, 40 Q heads / 8 KV heads (GQA), d_ff=17408,
vocab=151936, qk-norm on per-head q/k, SwiGLU.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    act="silu",
    gated_ffn=True,
)


def tiny() -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, attn_block_q=16, attn_block_kv=32)
