"""~100M-parameter dense LM used by the end-to-end example driver.

Not an assigned architecture — it is the Swallow-style "motivating
application": small enough to train a few hundred steps on CPU, structured
exactly like the big dense configs (GQA + SwiGLU + qk_norm).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tiny-100m",
    family="dense",
    n_layers=8,
    d_model=512,
    n_heads=8,
    n_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab_size=32768,
    qk_norm=True,
    act="silu",
    gated_ffn=True,
    tie_embeddings=True,
    attn_block_q=128,
    attn_block_kv=256,
)


def tiny() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=256,
                          attn_block_q=16, attn_block_kv=32)
