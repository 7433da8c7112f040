"""pixtral-12b [hf:mistralai/Pixtral-12B-2409]
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072; pixtral-ViT
frontend stubbed (input_specs provides patch embeddings)."""
from .base import ModelConfig, VLMCfg

CONFIG = ModelConfig(
    arch_id="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, kv_heads=8,
    d_ff=14336, vocab=131072,
    vlm=VLMCfg(vision_dim=1024, patches_per_seq_frac=0.25),
    source="hf:mistralai/Pixtral-12B-2409",
)
