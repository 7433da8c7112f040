"""recurrentgemma-2b [arXiv:2402.19427]
26L d_model=2560 10H (MQA kv=1) d_ff=7680 vocab=256000; RG-LRU + local
attention, pattern (rec, rec, attn), window 2048."""
from .base import HybridCfg, ModelConfig

CONFIG = ModelConfig(
    arch_id="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, kv_heads=1,
    d_ff=7680, vocab=256000, rope_theta=10_000.0,
    hybrid=HybridCfg(pattern=("rec", "rec", "attn"), lru_width=2560,
                     window=2048),
    remat=True,
    source="arXiv:2402.19427",
)
