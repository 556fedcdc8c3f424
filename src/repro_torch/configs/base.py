"""Config dataclasses for swallow-jax model architectures.

Every assigned architecture is expressed as a ``ModelConfig``.  Layer
heterogeneity (gemma2 local/global alternation, recurrentgemma RG-LRU:attn 2:1,
deepseek first-k-dense-then-MoE) is expressed with a cyclic ``layer_pattern``
plus ``first_k_dense`` so the model can ``lax.scan`` over homogeneous groups.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# Layer kinds usable in ``layer_pattern``.
ATTN = "attn"          # global self attention (GQA)
LOCAL = "local"        # sliding-window self attention
MLA = "mla"            # multi-head latent attention (deepseek)
RGLRU = "rglru"        # Griffin RG-LRU recurrent block
RWKV6 = "rwkv6"        # RWKV-6 time-mix block
LAYER_KINDS = (ATTN, LOCAL, MLA, RGLRU, RWKV6)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # routed experts
    top_k: int
    d_ff_expert: int               # per-expert FFN hidden
    n_shared: int = 0              # shared (always-on) experts
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # deepseek-style aux-loss-free bias routing; we implement standard
    # softmax-top-k with an optional load-balance aux loss.
    aux_loss_coef: float = 0.001
    score_func: str = "softmax"    # softmax | sigmoid (deepseek-v3 uses sigmoid)


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128

    # -- layer composition ---------------------------------------------------
    layer_pattern: Tuple[str, ...] = (ATTN,)   # cycled across layers
    first_k_dense: int = 0         # leading layers forced dense-FFN (deepseek)

    # -- attention details ---------------------------------------------------
    causal: bool = True            # False => encoder-only (hubert)
    qk_norm: bool = False
    attn_softcap: Optional[float] = None     # gemma2: 50.0
    logit_softcap: Optional[float] = None    # gemma2: 30.0
    rope_theta: float = 10_000.0
    sliding_window: int = 4096     # for LOCAL layers
    mrope_sections: Optional[Tuple[int, int, int]] = None  # qwen2-vl M-RoPE
    attn_logit_scale: Optional[float] = None  # override 1/sqrt(head_dim)
    rope: bool = True              # False => no positional rotation (hubert stub)
    post_norm: bool = False        # gemma2: extra norm after each sublayer

    # -- FFN -------------------------------------------------------------
    act: str = "silu"              # silu | gelu
    gated_ffn: bool = True         # GLU-style (SwiGLU / GeGLU); False => plain MLP

    # -- optional sub-configs --------------------------------------------
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None

    # -- recurrent blocks --------------------------------------------------
    lru_width: Optional[int] = None  # RG-LRU recurrence width (default d_model)
    conv1d_width: int = 4            # temporal conv in the RG-LRU block

    # -- embeddings / head -----------------------------------------------
    tie_embeddings: bool = False
    embed_scale: bool = False      # gemma-style sqrt(d_model) embedding scale
    norm_eps: float = 1e-6
    # vlm/audio backbones take precomputed embeddings instead of token ids.
    embed_inputs: bool = True      # False => inputs are (B, S, d_model) floats
    mtp_depth: int = 0             # deepseek multi-token-prediction modules

    # -- numerics / memory policy ------------------------------------------
    param_dtype: str = "float32"   # deepseek/grok: bfloat16
    activation_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"   # deepseek: int8 (block-quantized)
    remat: bool = True

    # -- implementation switch (ref | blocked | pallas) -----------------------
    impl: str = "blocked"
    attn_block_q: int = 512        # flash blocking (blocked/pallas impls)
    attn_block_kv: int = 1024
    scan_layers: bool = True       # lax.scan over layer groups

    def __post_init__(self):
        for k in self.layer_pattern:
            if k not in LAYER_KINDS:
                raise ValueError(f"unknown layer kind {k!r}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")
        # n_layers need not be divisible by the pattern period: the model
        # scans over full cycles and unrolls the remainder (recurrentgemma:
        # 26 layers over a (rglru, rglru, local) period-3 pattern).

    # -- derived -------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        """Fully unrolled per-layer kind list (length n_layers)."""
        p = self.layer_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    def uses_kind(self, kind: str) -> bool:
        return kind in self.layer_pattern

    @property
    def sub_quadratic(self) -> bool:
        """True iff no layer does *global* attention (long_500k eligibility)."""
        return all(k in (LOCAL, RGLRU, RWKV6) for k in self.layer_pattern)

    @property
    def supports_decode(self) -> bool:
        return self.causal

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, v = self.d_model, self.vocab_size
        n = v * d                      # embedding
        if not self.tie_embeddings:
            n += v * d                 # unembed
        for i, kind in enumerate(self.layer_kinds):
            n += self._mixer_params(kind)
            n += self._ffn_params(i)
            n += 2 * d                 # two pre-norms (ignore post-norm nuance)
        n += d                         # final norm
        if self.mtp_depth:
            n += self.mtp_depth * (
                self._mixer_params(self.layer_kinds[-1])
                + self._ffn_params(self.n_layers - 1) + 3 * d + d * 2 * d)
        return n

    def _mixer_params(self, kind: str) -> int:
        d, hd = self.d_model, self.head_dim
        if kind in (ATTN, LOCAL):
            return d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d \
                + (2 * hd if self.qk_norm else 0)
        if kind == MLA:
            m = self.mla
            qr = m.q_lora_rank or d
            n = d * m.q_lora_rank + m.q_lora_rank * self.n_heads * (
                m.qk_nope_head_dim + m.qk_rope_head_dim) if m.q_lora_rank else \
                d * self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            n += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            n += m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
            n += self.n_heads * m.v_head_dim * d
            del qr
            return n
        if kind == RGLRU:
            w = self.lru_width or d
            # linear in/out + conv1d + gates (RG-LRU a,x gates) + Λ
            return 2 * d * w + self.conv1d_width * w + 2 * w * w + w
        if kind == RWKV6:
            # r,k,v,g,o projections + time-mix lora + decay lora + u
            return 5 * d * d + 6 * (d * 32 + 32 * d) + 2 * d
        raise ValueError(kind)

    def _ffn_params(self, layer_idx: int) -> int:
        d = self.d_model
        if self.moe is not None and layer_idx >= self.first_k_dense:
            m = self.moe
            per = (3 if self.gated_ffn else 2) * d * m.d_ff_expert
            return (m.n_experts + m.n_shared) * per + d * m.n_experts  # + router
        return (3 if self.gated_ffn else 2) * d * self.d_ff

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only routed top_k + shared)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        m = self.moe
        per = (3 if self.gated_ffn else 2) * d * m.d_ff_expert
        inactive = 0
        n_moe_layers = self.n_layers - self.first_k_dense
        inactive = n_moe_layers * (m.n_experts - m.top_k) * per
        return self.n_params() - inactive

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned): every (arch x shape) cell is defined by these.
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Implements the skip rules recorded in DESIGN.md §4."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "global attention is not sub-quadratic at 500k"
    return True, ""
