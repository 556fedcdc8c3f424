"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427; hf-verified].

Hybrid: 26L, d_model=2560, 10 Q heads / 1 KV head (MQA), d_ff=7680,
vocab=256000.  Repeating (RG-LRU, RG-LRU, local-attention) pattern — 2:1
recurrent:attention — with a 2048-token local window, GeGLU, sqrt(d) embed
scale.  Sub-quadratic: eligible for the long_500k shape.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    layer_pattern=("rglru", "rglru", "local"),
    sliding_window=2048,
    lru_width=2560,
    conv1d_width=4,
    act="gelu",
    gated_ffn=True,
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab_size=256, sliding_window=32, lru_width=64,
        attn_block_q=16, attn_block_kv=32)
