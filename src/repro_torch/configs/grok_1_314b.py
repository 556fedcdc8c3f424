"""Grok-1 314B [hf:xai-org/grok-1; unverified].

MoE: 64L, d_model=6144, 48 Q heads / 8 KV heads, vocab=131072, 8 experts
top-2 (d_ff_expert=32768), GeGLU, attention + final logit softcap 30,
sqrt(d) embedding scale.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    n_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768, n_shared=0,
                  capacity_factor=1.25, score_func="softmax"),
    attn_softcap=30.0,
    logit_softcap=30.0,
    act="gelu",
    gated_ffn=True,
    embed_scale=True,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32, n_shared=0),
        param_dtype="float32", attn_block_q=16, attn_block_kv=32)
