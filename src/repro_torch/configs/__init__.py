"""Architecture registry: arch id -> ModelConfig."""
from __future__ import annotations

import importlib

from .base import (EncDecCfg, HybridCfg, ModelConfig, MoECfg, SSMCfg,
                   VLMCfg)

_MODULES = {
    # the paper's own workloads
    "internvl3-2b": "internvl3_2b",
    "qwen3vl-8b": "qwen3vl_8b",
    "chatglm3-6b": "chatglm3_6b",
    "glm4-9b": "glm4_9b",
    "minitron-4b": "minitron_4b",
    "pixtral-12b": "pixtral_12b",
    "llama3-405b": "llama3_405b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mamba2-370m": "mamba2_370m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-small": "whisper_small",
}

ALL_ARCHS = list(_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ALL_ARCHS}")
    mod = importlib.import_module(f".{_MODULES[arch_id]}", __package__)
    return mod.CONFIG


__all__ = ["EncDecCfg", "HybridCfg", "ModelConfig", "MoECfg", "SSMCfg",
           "VLMCfg", "get_config", "ALL_ARCHS"]
