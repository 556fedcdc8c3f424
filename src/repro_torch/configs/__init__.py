"""Architecture registry of the port: ``get_config("qwen3-1.7b")``.

Only the configs the port serves so far are registered; the others are
still to be ported (see ROADMAP.md).
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig, ShapeConfig

_ARCH_MODULES: Dict[str, str] = {
    "grok-1-314b": "repro_torch.configs.grok_1_314b",
    "qwen3-1.7b": "repro_torch.configs.qwen3_1_7b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "rwkv6-1.6b": "repro_torch.configs.rwkv6_1_6b",
    "tiny-100m": "repro_torch.configs.tiny_100m",
}


def _module(name: str):
    if name not in _ARCH_MODULES:
        raise KeyError(
            f"arch {name!r} is not ported yet (ported: "
            f"{sorted(_ARCH_MODULES)}); see ROADMAP.md for the order in "
            "which the other configs follow")
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
