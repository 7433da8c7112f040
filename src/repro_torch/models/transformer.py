"""Transformer assembly: per-family layers and stacked layer parameters.

Layer parameters are STACKED along a leading [L] axis, as in the JAX
package (whose `lax.scan` consumes them); here a Python loop walks the
layers and `unstack(stack)` gives each layer's leaves as views.

Families:
  dense  — [attn + MLP] x L                   (chatglm3, glm4, minitron,
                                               llama3)
  vlm    — dense, patch embeddings written into the token stream by a
           connector (model._input_embeddings)   (internvl3, qwen3vl,
                                               pixtral)
  moe    — [attn + MoE-FFN] x L               (granite, olmoe)
  ssm    — [mamba2 SSD] x L                   (mamba2-370m)
  hybrid — [(rec, rec, attn) + MLP each] x .. (recurrentgemma-2b)
  audio  — encoder [full attn + MLP] x E, decoder [causal attn + cross
           attn + MLP] x L, LayerNorms    (whisper-small; the blocks
                                               are in model.py)
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..configs.base import ModelConfig
from .attention import attention, init_attention
from .layers import (_dtype, init_layernorm, init_mlp, init_rmsnorm, mlp,
                     rms_norm)
from .moe import init_moe, moe_ffn
from .rglru import init_rglru_block, rglru_block
from .ssm import init_ssm, ssm_forward


def _init_dense_layer(gen, cfg: ModelConfig, device, stack: tuple = ()):
    """An attention layer: the MoE family's FFN is its experts."""
    dt = _dtype(cfg.param_dtype)
    layer = {
        "ln1": init_rmsnorm(cfg.d_model, dt, device, stack),
        "attn": init_attention(gen, cfg.d_model, cfg.n_heads, cfg.kv_heads,
                               cfg.resolved_head_dim, dt, device, stack),
        "ln2": init_rmsnorm(cfg.d_model, dt, device, stack),
    }
    if cfg.family == "moe":
        layer["moe"] = init_moe(gen, cfg.d_model, cfg.moe.n_experts,
                                cfg.moe.expert_ff, dt, device, stack)
    else:
        layer["mlp"] = init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation,
                                dt, device, stack)
    return layer


def _init_ssm_layer(gen, cfg: ModelConfig, device, stack: tuple = ()):
    dt = _dtype(cfg.param_dtype)
    s = cfg.ssm
    return {
        "ln1": init_rmsnorm(cfg.d_model, dt, device, stack),
        "ssm": init_ssm(gen, cfg.d_model, d_state=s.d_state,
                        head_dim=s.head_dim, expand=s.expand,
                        conv_width=s.conv_width, dtype=dt, device=device,
                        stack=stack),
    }


def _init_rec_layer(gen, cfg: ModelConfig, device, stack: tuple = ()):
    dt = _dtype(cfg.param_dtype)
    h = cfg.hybrid
    return {
        "ln1": init_rmsnorm(cfg.d_model, dt, device, stack),
        "rec": init_rglru_block(gen, cfg.d_model, h.lru_width or cfg.d_model,
                                h.conv_width, dt, device, stack=stack),
        "ln2": init_rmsnorm(cfg.d_model, dt, device, stack),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, dt,
                        device, stack),
    }


def _init_enc_layer(gen, cfg: ModelConfig, device, stack: tuple = ()):
    """A whisper encoder layer: LayerNorms, full self-attention, GELU
    MLP."""
    dt = _dtype(cfg.param_dtype)
    return {
        "ln1": init_layernorm(cfg.d_model, dt, device, stack),
        "attn": init_attention(gen, cfg.d_model, cfg.n_heads, cfg.kv_heads,
                               cfg.resolved_head_dim, dt, device, stack),
        "ln2": init_layernorm(cfg.d_model, dt, device, stack),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, "gelu", dt, device,
                        stack),
    }


def _init_encdec_layer(gen, cfg: ModelConfig, device, stack: tuple = ()):
    """A whisper decoder layer: causal self-attention, cross-attention
    over the encoder's output (`xattn`, its own `ln_x`), GELU MLP."""
    dt = _dtype(cfg.param_dtype)

    def attn():
        return init_attention(gen, cfg.d_model, cfg.n_heads, cfg.kv_heads,
                              cfg.resolved_head_dim, dt, device, stack)
    return {
        "ln1": init_layernorm(cfg.d_model, dt, device, stack),
        "attn": attn(),
        "ln_x": init_layernorm(cfg.d_model, dt, device, stack),
        "xattn": attn(),
        "ln2": init_layernorm(cfg.d_model, dt, device, stack),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, "gelu", dt, device,
                        stack),
    }


def init_stack(gen, cfg: ModelConfig, n_layers: int, init_fn, device):
    """Every leaf of `init_fn`'s layer gains a leading [n_layers] axis."""
    return init_fn(gen, cfg, device, stack=(n_layers,))


def unstack(stacked: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Every layer of a stacked tree (views, no copies), from one
    `torch.unbind` per leaf. Under autograd the layers' gradients are
    stacked once per leaf, where indexing layer by layer would add a
    zero-filled [L, ...] gradient per layer."""
    leaves = {k: unstack(v) if isinstance(v, dict) else torch.unbind(v)
              for k, v in stacked.items()}
    return [{k: v[i] for k, v in leaves.items()}
            for i in range(n_stacked(stacked))]


def n_stacked(stacked: Dict[str, Any]) -> int:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def _rope_frac(cfg: ModelConfig) -> float:
    """Rotated share of each head: 0.5 for 2D RoPE, 0 without RoPE."""
    return 0.0 if not cfg.use_rope else 0.5 if cfg.rope_2d else 1.0


def _attn_kwargs(cfg: ModelConfig, mode: str, window=None):
    return dict(n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
                head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
                rope_frac=_rope_frac(cfg), impl=cfg.attn_impl, mode=mode,
                window=window)


def moe_kwargs(cfg: ModelConfig) -> dict:
    m = cfg.moe
    return dict(top_k=m.top_k, capacity_factor=m.capacity_factor,
                dispatch=m.dispatch, dispatch_group=m.dispatch_group)


def ffn(p, h, cfg: ModelConfig, per_row: bool = False):
    """An attention layer's FFN on h [B,S,d] -> (out, aux loss): the MLP
    (aux None), or the MoE FFN where the layer has one (`per_row` as
    `moe_ffn` takes it)."""
    if "moe" in p:
        return moe_ffn(p["moe"], h, per_row=per_row, **moe_kwargs(cfg))
    return mlp(p["mlp"], h, cfg.activation), None


def _dense_block(p, x, cfg: ModelConfig, mode="causal", window=None,
                 positions=None, segment_ids=None, span_ids=None,
                 ring=None):
    """One attention layer (pre-norm attention, then the MLP, or the MoE
    FFN where the layer has one) -> (x, aux loss: the MoE FFN's, else
    0). With a `ring`, attention runs ring context parallelism over x's
    rows (the ring's shards); every other op is per token. The router
    takes every row of x as one routing set."""
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    x = x + attention(p["attn"], h, positions=positions,
                      segment_ids=segment_ids, span_ids=span_ids,
                      ring=ring, **_attn_kwargs(cfg, mode, window))
    out, aux = ffn(p, rms_norm(p["ln2"], x, cfg.norm_eps), cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + out, aux


def _ssm_block(p, x, cfg: ModelConfig, **_):
    """One Mamba-2 layer (pre-norm SSD mixer) -> (x, aux loss 0). The
    segment and span tables are ignored: SSM sequences run padded, one
    per row."""
    s = cfg.ssm
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    x = x + ssm_forward(p["ssm"], h, d_state=s.d_state,
                        head_dim=s.head_dim, expand=s.expand,
                        chunk=s.chunk, impl=cfg.attn_impl)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def _rec_block(p, x, cfg: ModelConfig, **_):
    """One Griffin recurrent layer (pre-norm RG-LRU block + MLP) -> (x,
    aux loss 0). The tables are ignored: the recurrence and the conv run
    over whole rows (hybrid sequences run padded, one per row)."""
    h = rms_norm(p["ln1"], x, cfg.norm_eps)
    x = x + rglru_block(p["rec"], h, impl=cfg.attn_impl)
    h = rms_norm(p["ln2"], x, cfg.norm_eps)
    x = x + mlp(p["mlp"], h, cfg.activation)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def hybrid_layout(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...]]:
    """(n_full_units, tail_block_types). 26 layers @ (rec,rec,attn) ->
    8 full units + ('rec','rec') tail."""
    unit = cfg.hybrid.pattern
    n_units = cfg.n_layers // len(unit)
    tail = cfg.n_layers - n_units * len(unit)
    return n_units, unit[:tail]


_LAYER_INIT = {"dense": _init_dense_layer, "vlm": _init_dense_layer,
               "moe": _init_dense_layer, "ssm": _init_ssm_layer}
_BLOCK = {"dense": _dense_block, "vlm": _dense_block, "moe": _dense_block,
          "ssm": _ssm_block}
