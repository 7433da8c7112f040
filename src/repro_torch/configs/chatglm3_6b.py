"""chatglm3-6b [arXiv:2406.12793]
28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024; 2D (partial) RoPE."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, kv_heads=2,
    d_ff=13696, vocab=65024, rope_theta=10_000.0, rope_2d=True,
    source="arXiv:2406.12793",
)
