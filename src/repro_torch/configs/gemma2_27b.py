"""Gemma2-27B [arXiv:2408.00118; hf-verified].

Dense decoder: 46L, d_model=4608, 32 Q heads / 16 KV heads, d_ff=36864,
vocab=256000.  Alternating local (4096-window) / global attention, attention
logit softcap 50, final logit softcap 30, GeGLU, pre+post sublayer norms,
query scale 1/sqrt(d_model/n_heads)=1/sqrt(144), sqrt(d_model) embed scaling.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    layer_pattern=("local", "attn"),
    sliding_window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    attn_logit_scale=(4608 // 32) ** -0.5,
    act="gelu",
    gated_ffn=True,
    post_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    # 27B at TP-only sharding: bf16 params keep params+grads+ZeRO moments
    # within 16 GB/chip on the 256-chip pod
    param_dtype="bfloat16",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, sliding_window=32,
        attn_logit_scale=(64 // 4) ** -0.5,
        attn_block_q=16, attn_block_kv=32)
