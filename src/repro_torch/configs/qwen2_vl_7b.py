"""Qwen2-VL-7B LM backbone [arXiv:2409.12191; hf-verified].

VLM: 28L, d_model=3584, 28 Q heads / 4 KV heads, d_ff=18944, vocab=152064,
M-RoPE with (temporal, height, width) sections (16, 24, 24) over the 64
rotary half-dims.  The vision frontend (dynamic-resolution ViT) is a STUB:
``input_specs()`` feeds precomputed patch/text embeddings (B, S, d_model)
plus 3-D M-RoPE position ids (3, B, S).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab_size=152064,
    mrope_sections=(16, 24, 24),
    rope_theta=1_000_000.0,
    act="silu",
    gated_ffn=True,
    embed_inputs=False,   # modality frontend stub supplies embeddings
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, mrope_sections=(4, 2, 2),
        attn_block_q=16, attn_block_kv=32)
