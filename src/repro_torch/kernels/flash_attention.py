"""Flash attention (kernel K2): the CUDA kernel's wrapper and its plain
PyTorch version.

`flash_attention(q, k, v, mode=, window=, kv_offset=)` computes what the
JAX package's `kernels/ops.flash_attention` + `flash_attention_flat`
compute, in the model layout: q `[B, Sq, H, D]`, k/v `[B, Sk, Hkv, D]`
(GQA: head h reads KV head h // (H // Hkv)) -> `[B, Sq, H, D]` in q's
dtype. Query i sits at position i, key j at `kv_offset + j`; causal
keeps keys at or before the query, sliding also drops keys `window` or
more positions back. A row with no valid key is zeros.

On CPU tensors the wrapper runs `flash_attention_ref`; on CUDA tensors
it launches `csrc/flash_attention.cu` or raises. It never falls back.
bf16 inputs run on the tensor cores (`mma.sync`, fp32 accumulation,
probabilities rounded to bf16 before the product with V); fp32 inputs
run in fp32 on the CUDA cores.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build

MODES = {"full": 0, "causal": 1, "sliding": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def _valid_mask(Sq: int, Sk: int, mode: str, window: Optional[int],
                kv_offset: int, device) -> torch.Tensor:
    """[Sq, Sk] bool: key j is attendable from query i."""
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = kv_offset + torch.arange(Sk, device=device)[None, :]
    if mode == "full":
        return torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    m = kpos <= qpos
    if mode == "sliding":
        m = m & (kpos > qpos - window)
    return m


def flash_attention_ref(q, k, v, *, mode: str = "causal",
                        window: Optional[int] = None,
                        kv_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the CPU path and the test
    oracle): full fp32 score matrix, masked softmax, zero rows where no
    key is valid."""
    _check_args(q, k, v, mode, window)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    kf = k.float().repeat_interleave(G, dim=2)
    vf = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / math.sqrt(D)
    valid = _valid_mask(Sq, Sk, mode, window, kv_offset, q.device)
    s = s.masked_fill(~valid, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(valid.any(dim=-1)[:, None], p, 0.0)  # empty rows
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return o.to(q.dtype)


def _check_args(q, k, v, mode, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, D]")
    B, _, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"{H} query heads do not group over "
                         f"{k.shape[2]} KV heads")
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if mode == "sliding" and (window is None or window < 1):
        raise ValueError("sliding mode needs a window >= 1")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"dtype mismatch: {q.dtype}, {k.dtype}, {v.dtype}")


def _launch(q, k, v, mode, window, kv_offset) -> torch.Tensor:
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, not {q.dtype}")
    B, Sq, H, D = q.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, not {D}")
    if not (q.is_contiguous() and k.is_contiguous()
            and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start on 16-byte boundaries (the "
                         "bf16 kernel loads rows 16 bytes at a time)")
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, Sq, k.shape[1], H, k.shape[2], D, _DTYPES[q.dtype],
                 MODES[mode], int(window or 0), int(kv_offset), stream)
    if err != 0:
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg}")
    flash_attention.launches += 1
    return o


def flash_attention(q, k, v, *, mode: str = "causal",
                    window: Optional[int] = None,
                    kv_offset: int = 0) -> torch.Tensor:
    """Model-layout flash attention; see the module docstring."""
    _check_args(q, k, v, mode, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, mode=mode, window=window,
                                   kv_offset=kv_offset)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return _launch(q, k, v, mode, window, kv_offset)


#: kernel launches since the count was last set to 0 (CPU calls and
#: plain-version calls do not count)
flash_attention.launches = 0
