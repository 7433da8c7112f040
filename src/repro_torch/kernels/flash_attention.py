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
The kernel has no backward, so on the card it refuses inputs that need
a gradient (training attends through the packed kernel K1).
bf16 inputs run on the tensor cores (`wgmma`, fp32 accumulation,
probabilities rounded to bf16 before the product with V; two
warpgroups over 128 query rows a block); fp32 inputs run on the tensor
cores in split TF32 (`wgmma`: each operand as a TF32 hi and lo, each
product as three, which keeps fp32's accuracy; one warpgroup over 64
query rows a block). `last_launch` reads back either kernel's last
launch; `flash_attention.launches_by` counts the launches by kernel and
mode. Head dims 32, 64 and 128 run in both types, 160 (pixtral-12b) in
bf16 only.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build

MODES = {"full": 0, "causal": 1, "sliding": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel of `csrc/flash_attention.cu` each input dtype launches
KERNELS = {torch.float32: "flash_fwd_f32_kernel",
           torch.bfloat16: "flash_fwd_wg_kernel"}
_HEAD_DIMS = (32, 64, 128, 160)
#: head dims the kernel takes in bf16 only (pixtral-12b's 160, which no
#: config runs in fp32 through K2)
_BF16_ONLY = (160,)


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


def _library() -> ctypes.CDLL:
    """The kernel's library, its functions' C types bound once per
    loaded library rather than on every call."""
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.k2_last_launch.argtypes = [ctypes.c_void_p]
        lib.k2_last_launch.restype = None
    return lib


def last_launch() -> dict:
    """The last launch of either kernel (bf16 or fp32, any head_dim), as
    the library recorded it: `grid` (x, y, z), `threads` a block and
    `smem_bytes` of dynamic shared memory; all 0 before the first."""
    out = (ctypes.c_longlong * 5)()
    _library().k2_last_launch(out)
    return dict(grid=tuple(out[:3]), threads=out[3], smem_bytes=out[4])


def _launch(q, k, v, mode, window, kv_offset) -> torch.Tensor:
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if q.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, not {q.dtype}")
    B, Sq, H, D = q.shape
    if D not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, not {D}")
    if D in _BF16_ONLY and q.dtype != torch.bfloat16:
        raise ValueError(f"kernel takes head_dim {D} in bfloat16 only, "
                         f"not {q.dtype}")
    if not (q.is_contiguous() and k.is_contiguous()
            and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start on 16-byte boundaries (the "
                         "bf16 kernel loads rows 16 bytes at a time)")
    lib = _library()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq,
            k.shape[1], H, k.shape[2], D, _DTYPES[q.dtype], MODES[mode],
            int(window or 0), int(kv_offset), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg}")
    flash_attention.launches += 1
    key = f"{KERNELS[q.dtype]} {mode}"
    flash_attention.launches_by[key] = \
        flash_attention.launches_by.get(key, 0) + 1
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError("kernel K2 has no backward; attention "
                                  "that needs a gradient runs K1")
    return _launch(q, k, v, mode, window, kv_offset)


#: kernel launches since the count was last set to 0 (CPU calls and
#: plain-version calls do not count)
flash_attention.launches = 0
#: the same launches by kernel and mode ("flash_fwd_f32_kernel full",
#: ...), since the dict was last set to {}
flash_attention.launches_by = {}
