"""whisper-small [arXiv:2212.04356]
12L d_model=768 12H d_ff=3072 vocab=51865; enc-dec, conv frontend stubbed
(the caller provides precomputed frame embeddings)."""
from .base import EncDecCfg, ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small", family="audio",
    n_layers=12, d_model=768, n_heads=12, kv_heads=12,
    d_ff=3072, vocab=51865, activation="gelu", use_rope=False,
    encdec=EncDecCfg(n_enc_layers=12, n_audio_frames=1500),
    source="arXiv:2212.04356",
)
