"""Architecture registry: ``get_config(arch_id)`` / ``--arch <id>``.

One module per assigned architecture; each cites its source in ``source=``.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from ..models.config import ModelConfig

_ARCH_MODULES = [
    "hubert_xlarge",
    "deepseek_moe_16b",
    "qwen1_5_110b",
    "paligemma_3b",
    "smollm_135m",
    "recurrentgemma_9b",
    "h2o_danube_1_8b",
    "granite_moe_3b_a800m",
    "rwkv6_1_6b",
    "gemma_2b",
]

_REGISTRY: Dict[str, ModelConfig] = {}


def _load() -> None:
    if _REGISTRY:
        return
    for mod_name in _ARCH_MODULES:
        mod = importlib.import_module(f".{mod_name}", __package__)
        cfg: ModelConfig = mod.CONFIG.validate()
        _REGISTRY[cfg.arch_id] = cfg


def list_archs() -> List[str]:
    _load()
    return sorted(_REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    _load()
    key = arch_id.replace("_", "-")
    if key not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; available: {list_archs()}")
    return _REGISTRY[key]
