"""HuBERT-XLarge backbone [arXiv:2106.07447; unverified].

Audio encoder-only transformer: 48L, d_model=1280, 16 heads (no GQA:
kv=16), d_ff=5120, output vocab (codebook targets) = 504.  Standard GELU
MLP (no GLU), bidirectional attention, no rotary (the conv feature
extractor + conv positional embedding frontend is a STUB: ``input_specs()``
feeds precomputed frame embeddings (B, S, d_model)).

Encoder-only: no decode shapes (see DESIGN.md §4).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    rope=False,
    act="gelu",
    gated_ffn=False,
    embed_inputs=False,   # frame-embedding frontend stub
)


def tiny() -> ModelConfig:
    return CONFIG.replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=64, attn_block_q=16, attn_block_kv=32)
