"""Architecture registry: arch id -> ModelConfig."""
from __future__ import annotations

import importlib

from .base import HybridCfg, ModelConfig, MoECfg, SSMCfg, VLMCfg

_MODULES = {
    # the paper's own workload; further archs join with their families
    "internvl3-2b": "internvl3_2b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mamba2-370m": "mamba2_370m",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

ALL_ARCHS = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ALL_ARCHS}")
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.CONFIG


__all__ = ["HybridCfg", "ModelConfig", "MoECfg", "SSMCfg", "VLMCfg",
           "get_config", "ALL_ARCHS"]
