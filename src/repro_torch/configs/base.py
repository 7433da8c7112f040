"""Model / run configuration system.

One frozen dataclass describes an architecture; `ModelConfig.reduced()`
derives the CPU smoke-test variant (2 layers, 3 for the hybrid family,
d_model <= 256, <= 4 experts, 2 encoder layers over 16 audio frames).
This copy carries the fields of the families the port runs (dense, VLM,
MoE, SSM, hybrid and the audio encoder-decoder: every architecture of
the JAX package).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    expert_ff: int            # d_ff of each expert
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    dispatch: str = "einsum"  # einsum (one-hot baseline) | sort (O(T·k·D))
    dispatch_group: int = 8192  # sort: tokens per shard-local dispatch
                                # group (0 = one global group)


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2           # d_inner = expand * d_model
    chunk: int = 256          # SSD chunk length
    conv_width: int = 4
    dt_min: float = 1e-3
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class HybridCfg:
    # RecurrentGemma / Griffin: pattern unit (rec, rec, attn)
    pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    lru_width: Optional[int] = None   # defaults to d_model
    window: int = 2048                # local attention window
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class EncDecCfg:
    """Whisper-style encoder-decoder; encoder consumes stub frame embeds."""
    n_enc_layers: int = 12
    n_audio_frames: int = 1500        # conv-frontend output length (stub)


@dataclasses.dataclass(frozen=True)
class VLMCfg:
    """Pixtral-style VLM; ViT frontend is a stub providing patch embeds."""
    vision_dim: int = 1024            # stub patch-embedding dim
    patches_per_seq_frac: float = 0.25  # fraction of seq positions = image


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    # dense | vlm | moe | ssm | hybrid | audio; vlm is dense with a
    # connector that writes projected patch embeddings into the token
    # stream (the model's forward and prefill), and Engine runs it as
    # dense; audio is whisper's encoder-decoder
    family: str
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

    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    hybrid: Optional[HybridCfg] = None
    encdec: Optional[EncDecCfg] = None
    vlm: Optional[VLMCfg] = None

    # attention behaviour
    sliding_window: Optional[int] = None    # sub-quadratic variant (decode)
    attn_impl: str = "cuda"                 # reference | cuda
    # activation checkpoint per layer (the JAX package's default is on);
    # here on only for a config whose largest group does not fit the card
    # without it: mamba2-370m and recurrentgemma-2b (see
    # tests/test_torch_cuda.py)
    remat: bool = False
    param_dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: 2 layers (3 hybrid), d_model<=256, <=4
        experts, 2 encoder layers over 16 frames."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        kv = max(1, min(self.kv_heads, n_heads))
        while n_heads % kv:
            kv -= 1
        kw = dict(
            n_layers=2 if self.family != "hybrid" else 3,
            d_model=d_model,
            n_heads=n_heads,
            kv_heads=kv,
            head_dim=None,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 1024),
            param_dtype="float32",
            attn_impl="reference",
            remat=False,
        )
        if self.moe:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=min(self.moe.top_k, 2),
                expert_ff=min(self.moe.expert_ff, 256))
        if self.ssm:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=32, chunk=32)
        if self.hybrid:
            kw["hybrid"] = dataclasses.replace(
                self.hybrid, lru_width=d_model, window=64)
        if self.encdec:
            kw["encdec"] = dataclasses.replace(
                self.encdec, n_enc_layers=2, n_audio_frames=16)
        if self.vlm:
            kw["vlm"] = dataclasses.replace(self.vlm, vision_dim=64)
        return self.with_(**kw)
