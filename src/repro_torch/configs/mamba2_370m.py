"""mamba2-370m [arXiv:2405.21060] — SSD (state-space duality)
48L d_model=1024 attn-free, ssm_state=128, vocab=50280."""
from .base import ModelConfig, SSMCfg

CONFIG = ModelConfig(
    arch_id="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, kv_heads=0,
    d_ff=0, vocab=50280,
    ssm=SSMCfg(d_state=128, head_dim=64, expand=2, chunk=256),
    remat=True,
    source="arXiv:2405.21060",
)
