"""repro_torch — the PyTorch/CUDA port of the DHP reproduction.

A package of its own beside the JAX reference package `repro`: it
imports torch and numpy, never JAX, and nothing of `repro`. Entry points
(`Engine`, `ClusterSpec`, `ServingEngine`) run on the CUDA card unless
the caller passes `device="cpu"`.
"""
from .api import ClusterSpec, Engine, get_strategy

__all__ = ["ClusterSpec", "Engine", "get_strategy"]
