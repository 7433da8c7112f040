"""Qwen3-VL-8B — the paper's largest workload (Table 5): 36L 32H (GQA kv=8)
d_model=4096, vision hidden 1152 (ViT stubbed)."""
from .base import ModelConfig, VLMCfg

CONFIG = ModelConfig(
    arch_id="qwen3vl-8b", family="vlm",
    n_layers=36, d_model=4096, n_heads=32, kv_heads=8,
    d_ff=12288, vocab=151674,
    vlm=VLMCfg(vision_dim=1152, patches_per_seq_frac=0.5),
    source="paper Table 5 / arXiv:2511.21631",
)
