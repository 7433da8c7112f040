"""llama3-405b [arXiv:2407.21783]
126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, kv_heads=8,
    d_ff=53248, vocab=128256, rope_theta=500_000.0,
    source="arXiv:2407.21783",
)
