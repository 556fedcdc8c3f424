"""DeepSeek-V3 671B [arXiv:2412.19437; hf-verified].

MoE: 61L, d_model=7168, 128 attention heads with MLA (q_lora 1536, kv_lora
512, nope 128 + rope 64 q/k dims, v 128), vocab=129280.  First 3 layers are
dense FFN (d_ff=18432); the remaining 58 use 1 shared + 256 routed experts
(d_ff_expert=2048), sigmoid-score top-8 routing, plus 1 multi-token-
prediction module.  671B total / ~37B active parameters.

Memory policy (16 GB/chip on a 256-chip pod): bf16 parameters and int8
block-quantized Adam moments (see optim/adam.py).
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,        # MLA: heads share one latent; kept for bookkeeping
    head_dim=128,
    d_ff=18432,            # dense layers (first_k_dense)
    vocab_size=129280,
    layer_pattern=("mla",),
    first_k_dense=3,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
                  capacity_factor=1.25, score_func="sigmoid"),
    mtp_depth=1,
    act="silu",
    gated_ffn=True,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
    opt_state_dtype="int8",
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256, first_k_dense=1,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1,
                      capacity_factor=1.25, score_func="sigmoid"),
        mtp_depth=1, param_dtype="float32", opt_state_dtype="float32",
        attn_block_q=16, attn_block_kv=32)
