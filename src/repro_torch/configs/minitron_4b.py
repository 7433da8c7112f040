"""minitron-4b [arXiv:2407.14679] — pruned nemotron
32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000."""
from .base import ModelConfig

CONFIG = ModelConfig(
    arch_id="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, kv_heads=8,
    d_ff=9216, vocab=256000,
    source="arXiv:2407.14679",
)
