"""Minitron-8B (width-pruned Nemotron-4) [arXiv:2407.14679; hf-verified].

Dense decoder: 32L, d_model=4096, 32 Q heads / 8 KV heads, d_ff=16384,
vocab=256000.  Nemotron family: squared-ReLU MLP (no GLU gate), untied
embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    act="relu2",
    gated_ffn=False,
    rope_theta=10_000.0,
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, attn_block_q=16, attn_block_kv=32)
