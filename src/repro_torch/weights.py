"""Model parameters of the port: random init and the bridge from the
reference's parameter tree.

Layout (see ``models/lm.py``): ``params["segments"][seg][cycle][j]`` holds
the block parameters of layer kind ``seg.kinds[j]`` as the reference's
per-block dict (``ln1``, the mixer's ``attn`` / ``rglru`` / ``rwkv``,
``ln2``, and ``ffn`` or ``moe`` except in RWKV-6 layers), unstacked per
cycle.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ATTN, LOCAL, RGLRU, RWKV6
from repro_torch.models import lm, modules as nn, rglru, rwkv6


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another one.  With no device given and no CUDA present it raises; it
    never carries on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return torch.device("cuda")


def _to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes: widen exactly, then narrow
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.tensor(a, device=device)


def _tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree(fn, v) for v in tree)
    return fn(tree)


def from_reference(np_params, cfg, device=None):
    """Torch parameters from the reference's ``lm.init_params`` tree after
    ``jax.tree.map(np.asarray, ...)``.  Scanned segments carry a leading
    ``n_cycles`` axis on every leaf; it is unstacked into one entry per
    cycle."""
    device = resolve_device(device)
    out = {k: _tree(lambda a: _to_torch(a, device), v)
           for k, v in np_params.items() if k != "segments"}
    segs = []
    for seg, seg_p in zip(lm.make_segments(cfg), np_params["segments"]):
        if seg.scanned:
            cycles = [[_tree(lambda a, c=c: _to_torch(a[c], device), blk)
                       for blk in seg_p] for c in range(seg.n_cycles)]
        else:
            cycles = [[_tree(lambda a: _to_torch(a, device), blk)
                       for blk in seg_p]]
        segs.append(cycles)
    out["segments"] = segs
    return out


def init_params(cfg, generator: Optional[torch.Generator] = None,
                device=None):
    """Random parameters drawn from the reference's distributions
    (``repro/models/modules.py`` dense/embed init, ``attention.init``,
    ``moe.init``, ``rglru.init``, ``rwkv6.init``, ``lm.init_params``).
    The bits differ from the reference's: torch and JAX generators
    differ."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dtype = nn.dt(cfg.param_dtype)

    def normal(shape, std=1.0, to=dtype):
        # scaled in place: at grok's widths one expert tensor is 6.4 GB
        # in fp32 before the cast
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return x.mul_(std).to(to)

    def dense(d_in, d_out, scale=1.0, to=dtype):
        return normal((d_in, d_out), scale * d_in ** -0.5, to)

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=device)

    def ones(n):
        return {"scale": full((n,), 1.0)}

    d, hd = cfg.d_model, cfg.head_dim
    layer_scale = 1.0 / max(1, cfg.n_layers) ** 0.5

    def attn():
        p = {"wq": dense(d, cfg.n_heads * hd),
             "wk": dense(d, cfg.n_kv_heads * hd),
             "wv": dense(d, cfg.n_kv_heads * hd),
             "wo": dense(cfg.n_heads * hd, d, layer_scale)}
        if cfg.qk_norm:
            p["q_norm"] = full((hd,), 1.0)
            p["k_norm"] = full((hd,), 1.0)
        return p

    def rglru_block():
        w = cfg.lru_width or d
        heads = cfg.n_heads
        ghd = w // heads
        # Lambda so that a ~ U[0.9, 0.999]^(1/c) (Griffin app. A)
        u = 0.9 + 0.099 * torch.rand((w,), generator=generator,
                                     device=device, dtype=torch.float32)
        return {
            "lru_in_x": dense(d, w),
            "lru_in_gate": dense(d, w),
            "conv_w": normal((cfg.conv1d_width, w), cfg.conv1d_width ** -0.5),
            "conv_b": full((w,), 0.0),
            "lru_a_gate_w": normal((heads, ghd, ghd), ghd ** -0.5),
            "lru_a_gate_b": full((heads, ghd), 0.0),
            "lru_x_gate_w": normal((heads, ghd, ghd), ghd ** -0.5),
            "lru_x_gate_b": full((heads, ghd), 0.0),
            "lru_a_param": torch.log(torch.expm1(-torch.log(u)
                                                 / rglru.C_FACTOR)),
            "lru_out": dense(w, d, layer_scale),
        }

    def rwkv_block():
        return {
            "rwkv_mix_x": full((d,), 0.0),
            "rwkv_mix_base": full((5, d), 0.0),
            "rwkv_mix_lora_a": normal((d, 5, rwkv6.LORA_MIX), d ** -0.5),
            "rwkv_mix_lora_b": normal((5, rwkv6.LORA_MIX, d),
                                      rwkv6.LORA_MIX ** -0.5),
            "rwkv_decay_base": full((d,), -1.0),
            "rwkv_decay_lora_a": normal((d, rwkv6.LORA_DECAY), d ** -0.5),
            "rwkv_decay_lora_b": normal((rwkv6.LORA_DECAY, d),
                                        rwkv6.LORA_DECAY ** -0.5),
            "rwkv_u": normal((cfg.n_heads, hd), 0.1, to=torch.float32),
            "rwkv_wr": dense(d, d),
            "rwkv_wk": dense(d, d),
            "rwkv_wv": dense(d, d),
            "rwkv_wg": dense(d, d),
            "rwkv_wo": dense(d, d, layer_scale),
            "rwkv_ln_scale": full((d,), 1.0),
            "rwkv_ln_bias": full((d,), 0.0),
            "rwkv_cm_mix_k": full((d,), 0.5),
            "rwkv_cm_mix_r": full((d,), 0.5),
            "rwkv_cm_wk": dense(d, cfg.d_ff),
            "rwkv_cm_wv": dense(cfg.d_ff, d, layer_scale),
            "rwkv_cm_wr": dense(d, d),
        }

    def moe_block():
        m = cfg.moe
        if m.n_shared:
            raise NotImplementedError(
                "init of shared experts (the DeepSeek slice) is not ported "
                "yet; see ROADMAP.md")
        E, fe = m.n_experts, m.d_ff_expert
        p = {"router_w": dense(d, E, to=torch.float32),
             "e_up": normal((E, d, fe), d ** -0.5),
             "e_down": normal((E, fe, d), layer_scale * fe ** -0.5)}
        if cfg.gated_ffn:
            p["e_gate"] = normal((E, d, fe), d ** -0.5)
        return p

    def block(kind, is_moe):
        if kind not in (ATTN, LOCAL, RGLRU, RWKV6):
            raise NotImplementedError(
                f"init of {kind!r} blocks is not ported yet; see ROADMAP.md")
        p = {"ln1": ones(d)}
        if kind == RWKV6:
            p["rwkv"] = rwkv_block()
        elif kind == RGLRU:
            p["rglru"] = rglru_block()
        else:
            p["attn"] = attn()
        p["ln2"] = ones(d)
        if is_moe and kind != RWKV6:
            p["moe"] = moe_block()
        elif kind != RWKV6:
            p["ffn"] = {"w_up": dense(d, cfg.d_ff),
                        "w_down": dense(cfg.d_ff, d, layer_scale)}
            if cfg.gated_ffn:
                p["ffn"]["w_gate"] = dense(d, cfg.d_ff)
        if cfg.post_norm:
            p["ln1_post"] = ones(d)
            p["ln2_post"] = ones(d)
        return p

    params = {"embed": {"embed_table": normal((cfg.vocab_size, d))},
              "segments": [[[block(k, seg.is_moe) for k in seg.kinds]
                            for _ in range(seg.n_cycles)]
                           for seg in lm.make_segments(cfg)],
              "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        params["head"] = {"head_w": dense(d, cfg.vocab_size)}
    return params
