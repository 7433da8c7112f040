"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427):
the training path.

Recurrence:  a_t = a^(c * r_t),  a = sigmoid(Lambda),  c = 8
             h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The gates run in fp32 as in the JAX package; the linear recurrence runs
through kernel K4 (`kernels/rglru_scan.py`: the CUDA scan on the card,
its plain loop on the CPU), where the JAX package's model takes
`lax.associative_scan`. The Griffin block wraps the RG-LRU with a GeLU
gate branch and a short causal conv, then projects back. Serving
decodes one token at a time through `rglru_decode_step` (one step of the
recurrence in torch ops, as the JAX package's decode runs no kernel),
from the state of `rglru_init_state`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.rglru_scan import rglru_scan as _scan
from ..kernels.rglru_scan import rglru_scan_plain
from .layers import dense_init
from .ssm import _causal_conv

_C = 8.0


def init_rglru_block(gen, d_model: int, lru_width: int, conv_width: int,
                     dtype, device, n_blocks: int = 8,
                     stack: tuple = ()) -> dict:
    """Keyed and laid out as the JAX package's `init_rglru_block` (leaves
    gain a leading `stack` shape), drawn from `gen`. Gates use
    block-diagonal weights [nb, W/nb, W/nb]."""
    while lru_width % n_blocks:
        n_blocks -= 1
    wb = lru_width // n_blocks
    f32 = dict(dtype=torch.float32, device=device)
    in_gate = dense_init(gen, d_model, lru_width, dtype, device, stack)
    in_rec = dense_init(gen, d_model, lru_width, dtype, device, stack)
    conv = torch.randn(*stack, conv_width, lru_width, generator=gen, **f32)
    blk = torch.randn(*stack, 2, n_blocks, wb, wb, generator=gen, **f32)
    blk = (blk / math.sqrt(wb)).to(dtype)
    lam = torch.rand(*stack, lru_width, generator=gen, **f32) * 3.0 + 2.0
    return {
        "in_gate": in_gate,
        "in_rec": in_rec,
        "conv": (conv * 0.1).to(dtype),
        "w_a": blk.select(len(stack), 0).contiguous(),
        "w_x": blk.select(len(stack), 1).contiguous(),
        "b_a": torch.zeros(*stack, lru_width, **f32),
        "b_x": torch.zeros(*stack, lru_width, **f32),
        "lambda": lam,                       # a = sigmoid(lambda) in (0,1)
        "out": dense_init(gen, lru_width, d_model, dtype, device, stack),
    }


def _blockdiag(u, w):
    """u: [..., W], w: [nb, Wb, Wb] block-diagonal matmul."""
    nb, wb, _ = w.shape
    ub = u.reshape(*u.shape[:-1], nb, wb)
    out = torch.einsum("...nw,nwv->...nv", ub, w)
    return out.reshape(u.shape)


def _gates(params, u):
    """(a, b) of the recurrence, fp32."""
    uf = u.float()
    r = torch.sigmoid(_blockdiag(uf, params["w_a"].float())
                      + params["b_a"])
    i = torch.sigmoid(_blockdiag(uf, params["w_x"].float())
                      + params["b_x"])
    log_a_base = F.logsigmoid(params["lambda"])         # log a, a in (0,1)
    log_a = _C * r * log_a_base                         # a_t = a^(c r_t)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i * uf)


def rglru_scan(params: dict, u: torch.Tensor, h0=None,
               impl: str = "cuda") -> torch.Tensor:
    """u: [B,S,W] -> h: [B,S,W] fp32, through kernel K4 (its plain loop,
    differentiated by autograd, with `impl="reference"`). A carried
    state `h0` [B,W] is folded into the first step's additive term, as
    the JAX package folds it."""
    a, b = _gates(params, u)
    if h0 is not None:
        b = torch.cat([(b[:, 0] + a[:, 0] * h0)[:, None], b[:, 1:]], dim=1)
    return rglru_scan_plain(a, b) if impl == "reference" else _scan(a, b)


def rglru_block(params: dict, x: torch.Tensor, h0=None,
                impl: str = "cuda") -> torch.Tensor:
    """Griffin recurrent block: [B,S,D] -> [B,S,D]. The gate's GeLU is
    the tanh approximation (`jax.nn.gelu`'s default)."""
    gate = F.gelu((x @ params["in_gate"]).float(), approximate="tanh")
    u = x @ params["in_rec"]
    u = _causal_conv(u, params["conv"])
    h = rglru_scan(params, u, h0, impl)
    return (h * gate).to(x.dtype) @ params["out"]


def rglru_init_state(batch: int, lru_width: int, conv_width: int,
                     dtype=torch.float32, device="cuda") -> dict:
    """Zero decode state: `h` [B,W] fp32 and the conv's last
    `conv_width - 1` inputs [B, conv_width-1, W] in `dtype`."""
    return {
        "h": torch.zeros(batch, lru_width, dtype=torch.float32,
                         device=device),
        "conv_buf": torch.zeros(batch, conv_width - 1, lru_width,
                                dtype=dtype, device=device),
    }


def rglru_decode_step(params: dict, x1: torch.Tensor, state: dict):
    """x1 [B,D] one token -> (y [B,D], new state); O(1). The conv's taps
    line up with `_causal_conv`'s (tap W-1 takes the newest input); the
    gates are `_gates`. Returns new tensors; `state` is left as it was."""
    gate = F.gelu((x1 @ params["in_gate"]).float(), approximate="tanh")
    buf = torch.cat([state["conv_buf"], (x1 @ params["in_rec"])[:, None]],
                    dim=1)
    a, b = _gates(params, torch.einsum("bwc,wc->bc", buf, params["conv"]))
    h = a * state["h"] + b
    y = (h * gate).to(x1.dtype) @ params["out"]
    return y, {"h": h, "conv_buf": buf[:, 1:]}
