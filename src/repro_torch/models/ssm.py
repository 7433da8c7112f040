"""Mamba-2 (SSD — state-space duality) block, arXiv:2405.21060: the
training and prefill path.

Chunked SSD: within a chunk the recurrence is evaluated in its dual
quadratic form (kernel K3, `kernels/ssd_chunk.py`); chunk states pass
between chunks through an exact sequential scan. Scalar-identity A per
head (Mamba-2's choice): a_t = exp(dt_t * A).

One path: `ssm_forward` runs K3 on the card (`impl="cuda"`) and K3's
plain version on the CPU or with `impl="reference"`. Serving decodes one
token at a time through `ssm_decode_step`, the recurrence in plain torch
ops (the JAX package's decode runs no kernel either), from the state of
`ssm_init_state`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd_chunk import ssd_chunk_scan
from .layers import dense_init


def init_ssm(gen, d_model: int, *, d_state: int, head_dim: int,
             expand: int, conv_width: int, dtype, device,
             stack: tuple = ()) -> dict:
    """Keyed and laid out as the JAX package's `init_ssm` (leaves gain a
    leading `stack` shape), drawn from `gen`."""
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv = torch.randn(*stack, conv_width, d_inner + 2 * d_state,
                       generator=gen, dtype=torch.float32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # fused input projection -> [z (gate), x, B, C, dt]
        "in_proj": dense_init(gen, d_model,
                              2 * d_inner + 2 * d_state + n_heads, dtype,
                              device, stack),
        "conv": (conv * 0.1).to(dtype),
        "A_log": torch.zeros(*stack, n_heads, **f32),
        "D": torch.ones(*stack, n_heads, **f32),
        "dt_bias": torch.zeros(*stack, n_heads, **f32),
        "out_proj": dense_init(gen, d_inner, d_model, dtype, device, stack),
        "norm_scale": torch.ones(*stack, d_inner, dtype=dtype,
                                 device=device),
    }


def _split_proj(p, d_inner, d_state, n_heads):
    """[z | x | B | C | dt] along the last axis (views)."""
    return torch.split(p, [d_inner, d_inner, d_state, d_state, n_heads],
                       dim=-1)


def _causal_conv(x, w):
    """Depthwise causal conv: x [B,S,C], w [W,C] -> the sum of W shifted
    products, in x's dtype, as the JAX package sums them."""
    W, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = xp[:, 0:S] * w[0]
    for i in range(1, W):
        out = out + xp[:, i:i + S] * w[i]
    return out


def ssm_forward(params: dict, xin: torch.Tensor, *, d_state: int,
                head_dim: int, expand: int, chunk: int,
                dt_min: float = 1e-3, impl: str = "cuda") -> torch.Tensor:
    """xin [B,S,D] -> [B,S,D] (training/prefill path, chunked SSD)."""
    Bsz, S, Dm = xin.shape
    d_inner = expand * Dm
    H = d_inner // head_dim
    P, N = head_dim, d_state

    proj = xin @ params["in_proj"]
    z, x, Bm, Cm, dt = _split_proj(proj, d_inner, d_state, H)
    xbc = torch.cat([x, Bm, Cm], dim=-1)
    xbc = F.silu(_causal_conv(xbc, params["conv"]))
    x, Bm, Cm = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"]) + dt_min    # [B,S,H]
    A = -torch.exp(params["A_log"])                             # [H] (<0)

    pad = (-S) % chunk                 # pad to a chunk multiple
    if pad:
        x, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (x, Bm, Cm))
        dt = F.pad(dt, (0, 0, 0, pad))
    Sp = S + pad
    xh = x.reshape(Bsz, Sp, H, P)
    y = ssd_chunk_scan(Cm, Bm, xh, dt * A, dt, chunk=chunk,
                       plain=(impl == "reference"))             # fp32
    y = y + xh.float() * params["D"][:, None]
    return _ssm_output(params, y[:, :S], z, Bsz, S, d_inner, xin.dtype)


def _ssm_output(params, y, z, Bsz, S, d_inner, out_dtype):
    """Gated RMSNorm (Mamba-2) + output projection: y [B,S,...] fp32,
    z [B,S,d_inner] -> [B,S,D]."""
    y = y.reshape(Bsz, S, d_inner)
    y = y * F.silu(z.float())
    var = y.square().mean(dim=-1, keepdim=True)
    y = y * torch.rsqrt(var + 1e-5) * params["norm_scale"].float()
    return y.to(out_dtype) @ params["out_proj"]


def ssm_init_state(batch: int, d_model: int, *, d_state: int,
                   head_dim: int, expand: int, conv_width: int,
                   dtype=torch.float32, device="cuda") -> dict:
    """Zero decode state: `h` [B,H,N,P] fp32 and the conv's last
    `conv_width - 1` inputs [B, W-1, d_inner + 2N] in `dtype`."""
    d_inner = expand * d_model
    H = d_inner // head_dim
    return {
        "h": torch.zeros(batch, H, d_state, head_dim, dtype=torch.float32,
                         device=device),
        "conv_buf": torch.zeros(batch, conv_width - 1,
                                d_inner + 2 * d_state, dtype=dtype,
                                device=device),
    }


def ssm_decode_step(params: dict, x1: torch.Tensor, state: dict, *,
                    d_state: int, head_dim: int, expand: int,
                    dt_min: float = 1e-3):
    """x1 [B,D] one token -> (y [B,D], new state); O(1) a token. The
    conv's taps line up with `_causal_conv`'s: tap W-1 takes the newest
    input. Returns new tensors; `state` is left as it was."""
    Bsz, Dm = x1.shape
    d_inner = expand * Dm
    H = d_inner // head_dim
    proj = x1 @ params["in_proj"]
    z, x, Bm, Cm, dt = _split_proj(proj, d_inner, d_state, H)
    buf = torch.cat([state["conv_buf"],
                     torch.cat([x, Bm, Cm], dim=-1)[:, None]], dim=1)
    xbc = F.silu(torch.einsum("bwc,wc->bc", buf, params["conv"]))
    x, Bm, Cm = torch.split(xbc, [d_inner, d_state, d_state], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"]) + dt_min    # [B,H]
    a = torch.exp(dt * -torch.exp(params["A_log"]))
    xh = x.reshape(Bsz, H, head_dim).float()
    dBx = torch.einsum("bh,bn,bhp->bhnp", dt, Bm.float(), xh)
    h = state["h"] * a[..., None, None] + dBx
    y = torch.einsum("bn,bhnp->bhp", Cm.float(), h)
    y = y + xh * params["D"][None, :, None]
    out = _ssm_output(params, y, z[:, None], Bsz, 1, d_inner, x1.dtype)
    return out[:, 0], {"h": h, "conv_buf": buf[:, 1:]}
