"""glm4-9b [hf:THUDM/glm-4-9b]
40L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=151552; RoPE, GQA."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, kv_heads=2,
    d_ff=13696, vocab=151552, rope_theta=10_000.0,
    source="hf:THUDM/glm-4-9b",
)
