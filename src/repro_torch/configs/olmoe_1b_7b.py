"""olmoe-1b-7b [arXiv:2409.02060]
16L d_model=2048 16H (GQA kv=16) d_ff=1024/expert vocab=50304, MoE 64e top-8."""
from .base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    arch_id="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, kv_heads=16,
    d_ff=1024, vocab=50304,
    moe=MoECfg(n_experts=64, top_k=8, expert_ff=1024,
               dispatch="sort"),  # einsum = the one-hot baseline
    source="arXiv:2409.02060",
)
