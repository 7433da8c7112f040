"""Model / run configuration system.

One frozen dataclass describes an architecture; `ModelConfig.reduced()`
derives the CPU smoke-test variant (2 layers, d_model <= 256). This copy
carries the dense/VLM fields the serving slice runs; the family-specific
sub-configs (MoE, SSM, hybrid, encoder-decoder) come with the slices that
port those families.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class VLMCfg:
    """Pixtral-style VLM; ViT frontend is a stub providing patch embeds."""
    vision_dim: int = 1024            # stub patch-embedding dim
    patches_per_seq_frac: float = 0.25  # fraction of seq positions = image


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str               # dense | vlm
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    source: str = ""          # paper / model-card citation

    head_dim: Optional[int] = None      # default d_model // n_heads
    rope_theta: float = 500_000.0
    rope_2d: bool = False               # chatglm3 partial-rotary style
    use_rope: bool = True               # False: absolute sinusoidal (whisper)
    norm_eps: float = 1e-5
    activation: str = "swiglu"          # swiglu | gelu
    tie_embeddings: bool = False

    vlm: Optional[VLMCfg] = None

    # attention behaviour
    sliding_window: Optional[int] = None    # sub-quadratic variant (decode)
    attn_impl: str = "cuda"                 # reference | cuda
    param_dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers, d_model<=256."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        kv = max(1, min(self.kv_heads, n_heads))
        while n_heads % kv:
            kv -= 1
        kw = dict(
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            kv_heads=kv,
            head_dim=None,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 1024),
            param_dtype="float32",
            attn_impl="reference",
        )
        if self.vlm:
            kw["vlm"] = dataclasses.replace(self.vlm, vision_dim=64)
        return self.with_(**kw)
