"""Architecture registry of the port: ``get_config("qwen3-14b")``.

The reference's eleven configs (``repro/configs``), field for field.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig, ShapeConfig

_ARCH_MODULES: Dict[str, str] = {
    "qwen3-14b": "repro_torch.configs.qwen3_14b",
    "minitron-8b": "repro_torch.configs.minitron_8b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "qwen2-vl-7b": "repro_torch.configs.qwen2_vl_7b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3_671b",
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "tiny-100m": "repro_torch.configs.tiny_100m",
}


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: "
                       f"{sorted(_ARCH_MODULES)}")
    return importlib.import_module(_ARCH_MODULES[name])


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_tiny_config(name: str) -> ModelConfig:
    """Reduced same-family config for smoke tests."""
    return _module(name).tiny()


def list_archs() -> List[str]:
    return list(_ARCH_MODULES)


__all__ = ["ModelConfig", "ShapeConfig", "get_config", "get_tiny_config",
           "list_archs"]
