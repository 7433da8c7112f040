"""Architecture registry: arch id -> ModelConfig."""
from __future__ import annotations

import importlib

from .base import ModelConfig, VLMCfg

_MODULES = {
    # the paper's own workload; further archs join with their families
    "internvl3-2b": "internvl3_2b",
}

ALL_ARCHS = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ALL_ARCHS}")
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.CONFIG


__all__ = ["ModelConfig", "VLMCfg", "get_config", "ALL_ARCHS"]
