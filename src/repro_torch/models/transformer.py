"""Transformer assembly: the dense layer and stacked layer parameters.

Layer parameters are STACKED along a leading [L] axis, as in the JAX
package (whose `lax.scan` consumes them); here a Python loop walks the
layers and `layer(stack, i)` takes layer i's leaves as views.
"""
from __future__ import annotations

from typing import Any, Dict

from ..configs.base import ModelConfig
from .attention import init_attention
from .layers import _dtype, init_mlp, init_rmsnorm


def _init_dense_layer(gen, cfg: ModelConfig, device, stack: tuple = ()):
    dt = _dtype(cfg.param_dtype)
    return {
        "ln1": init_rmsnorm(cfg.d_model, dt, device, stack),
        "attn": init_attention(gen, cfg.d_model, cfg.n_heads, cfg.kv_heads,
                               cfg.resolved_head_dim, dt, device, stack),
        "ln2": init_rmsnorm(cfg.d_model, dt, device, stack),
        "mlp": init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.activation, dt,
                        device, stack),
    }


def init_stack(gen, cfg: ModelConfig, n_layers: int, init_fn, device):
    """Every leaf of `init_fn`'s layer gains a leading [n_layers] axis."""
    return init_fn(gen, cfg, device, stack=(n_layers,))


def layer(stacked: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer i of a stacked parameter tree (views, no copies)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


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
