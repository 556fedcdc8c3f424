"""Qwen3-1.7B [hf:Qwen/Qwen3-8B family; hf-verified].

Dense decoder: 28L, d_model=2048, 16 Q heads / 8 KV heads, d_ff=6144,
vocab=151936, qk-norm, SwiGLU, tied embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    act="silu",
    gated_ffn=True,
    tie_embeddings=True,
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, attn_block_q=16, attn_block_kv=32)
