"""Shared neural building blocks (plain functions on tensors).

Parameters are plain nested dicts of tensors keyed as in the JAX package;
every block exposes `init_*(gen, ..., device) -> params` and a pure apply
function. Dense weights are `[in, out]` and applied as `x @ W`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device, stack: tuple = ()) -> torch.Tensor:
    """N(0, 1/in_dim) weight `[*stack, in, out]`, drawn in fp32 from `gen`
    (which must live on `device`) and cast to `dtype`."""
    w = torch.randn(*stack, in_dim, out_dim, generator=gen,
                    dtype=torch.float32, device=device)
    return (w * (1.0 / math.sqrt(in_dim))).to(dtype)


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------
def init_rmsnorm(d: int, dtype, device, stack: tuple = ()) -> dict:
    return {"scale": torch.ones(*stack, d, dtype=dtype, device=device)}


def rms_norm(params: dict, x: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    orig = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(orig)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------
def init_mlp(gen, d_model: int, d_ff: int, activation: str, dtype, device,
             stack: tuple = ()) -> dict:
    p = {"up": dense_init(gen, d_model, d_ff, dtype, device, stack),
         "down": dense_init(gen, d_ff, d_model, dtype, device, stack)}
    if activation == "swiglu":
        p["gate"] = dense_init(gen, d_model, d_ff, dtype, device, stack)
    return p


def mlp(params: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    up = x @ params["up"]
    if activation == "swiglu":
        h = F.silu(x @ params["gate"]) * up
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up, approximate="tanh")
    return h @ params["down"]


# --------------------------------------------------------------------------
# Embedding / head
# --------------------------------------------------------------------------
def init_embedding(gen, vocab: int, d_model: int, dtype, device
                   ) -> torch.Tensor:
    w = torch.randn(vocab, d_model, generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(table_or_head: torch.Tensor, x: torch.Tensor,
            tied: bool) -> torch.Tensor:
    if tied:
        return x @ table_or_head.T
    return x @ table_or_head


# --------------------------------------------------------------------------
# RoPE (interleaved pairs, as the JAX package rotates them)
# --------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, rotary_frac: float = 1.0,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for the rotated sub-dimension."""
    rot = int(head_dim * rotary_frac) // 2 * 2
    idx = torch.arange(0, rot, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (idx / rot))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_frac: float = 1.0) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S].

    Rotates the interleaved pairs (x[..., 0::2], x[..., 1::2]) of the
    leading `rotary_frac` of each head (ChatGLM-style partial rotary
    below 1); the remainder passes through."""
    d = x.shape[-1]
    inv = rope_frequencies(d, theta, rotary_frac, device=x.device)
    rot = inv.shape[0] * 2
    if rot == 0:                # rotary disabled (absolute-pos models)
        return x
    ang = positions[..., :, None].float() * inv          # [..., S, rot/2]
    sin = torch.sin(ang)[..., :, None, :]                # bcast over heads
    cos = torch.cos(ang)[..., :, None, :]
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)
