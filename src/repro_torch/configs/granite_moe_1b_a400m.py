"""granite-moe-1b-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base]
24L d_model=1024 16H (GQA kv=8) d_ff=512/expert vocab=49155, MoE 32e top-8."""
from .base import ModelConfig, MoECfg

CONFIG = ModelConfig(
    arch_id="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, kv_heads=8,
    d_ff=512, vocab=49155,
    moe=MoECfg(n_experts=32, top_k=8, expert_ff=512,
               dispatch="sort"),  # einsum = the one-hot baseline
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
