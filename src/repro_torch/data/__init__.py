"""Synthetic heterogeneous multimodal data (the training slice's input)."""
from .pipeline import HeterogeneousLoader, RaggedBatch

__all__ = ["HeterogeneousLoader", "RaggedBatch"]
