"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892; unverified].

Attention-free SSM-like: 24L, d_model=2048, d_ff=7168 (RWKV channel-mix),
vocab=65536.  Time-mix with data-dependent decay (head size 64 → 32 heads),
token-shift low-rank interpolation, bonus term u.  Sub-quadratic:
eligible for long_500k.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,            # d_model / 64 RWKV head size
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    layer_pattern=("rwkv6",),
    act="relu2",           # RWKV channel-mix uses squared ReLU
    gated_ffn=False,
    rope=False,
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, attn_block_q=16, attn_block_kv=32)
