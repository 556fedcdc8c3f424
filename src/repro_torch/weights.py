"""Model parameters of the port: random init and the bridge from the
reference's parameter tree.

Layout (see ``models/lm.py``): ``params["segments"][seg][cycle][j]`` holds
the block parameters of layer kind ``seg.kinds[j]`` as the reference's
per-block dict (``ln1``, ``attn``, ``ln2``, ``ffn``), unstacked per cycle.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ATTN, LOCAL
from repro_torch.models import lm, modules as nn


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
    ``lm.init_params``).  The bits differ from the reference's: torch and
    JAX generators differ."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dtype = nn.dt(cfg.param_dtype)

    def normal(shape, std=1.0):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x * std).to(dtype)

    def dense(d_in, d_out, scale=1.0):
        return normal((d_in, d_out), scale * d_in ** -0.5)

    def ones(n):
        return {"scale": torch.ones(n, dtype=torch.float32, device=device)}

    d, hd = cfg.d_model, cfg.head_dim
    layer_scale = 1.0 / max(1, cfg.n_layers) ** 0.5

    def block(kind, is_moe):
        if kind not in (ATTN, LOCAL) or is_moe:
            raise NotImplementedError(
                f"init of {kind!r}{' MoE' if is_moe else ''} blocks is not "
                "ported yet; see ROADMAP.md")
        attn = {"wq": dense(d, cfg.n_heads * hd),
                "wk": dense(d, cfg.n_kv_heads * hd),
                "wv": dense(d, cfg.n_kv_heads * hd),
                "wo": dense(cfg.n_heads * hd, d, layer_scale)}
        if cfg.qk_norm:
            attn["q_norm"] = torch.ones(hd, dtype=torch.float32,
                                        device=device)
            attn["k_norm"] = torch.ones(hd, dtype=torch.float32,
                                        device=device)
        ffn = {"w_up": dense(d, cfg.d_ff),
               "w_down": dense(cfg.d_ff, d, layer_scale)}
        if cfg.gated_ffn:
            ffn["w_gate"] = dense(d, cfg.d_ff)
        p = {"ln1": ones(d), "attn": attn, "ln2": ones(d), "ffn": ffn}
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
