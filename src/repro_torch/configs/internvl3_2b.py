"""InternVL3-2B — the paper's own workload (Table 5): 28L 12H (GQA kv=2)
d_model=1536, vision hidden 1024 (ViT stubbed). Used by the DHP
end-to-end examples and simulator calibration."""
from .base import ModelConfig, VLMCfg

CONFIG = ModelConfig(
    arch_id="internvl3-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, kv_heads=2,
    d_ff=8960, vocab=151674,
    vlm=VLMCfg(vision_dim=1024, patches_per_seq_frac=0.5),
    source="paper Table 5 / arXiv:2312.14238",
)
