"""RG-LRU linear scan (kernel K4): the CUDA kernels' wrappers, their
plain PyTorch versions, and the autograd function that binds forward and
backward.

`rglru_scan(a, b)` computes what the JAX package's
`kernels/rglru_scan.rglru_scan_pallas` computes: a, b `[B, S, W]` ->
h `[B, S, W]` in a's dtype, with

    h_t = a_t * h_{t-1} + b_t,    h_{-1} = 0,

the state carried in fp32 (fp64 for fp64 inputs, the plain version's
exact mode). Its gradient is the reverse scan

    g_t = dh_t + a_{t+1} g_{t+1},  db_t = g_t,  da_t = g_t h_{t-1},

which the JAX package has no kernel for (its model differentiates
`lax.associative_scan`); the backward kernel computes it from the
forward's saved h.

On CPU tensors both directions run the plain versions (sequential loops
over time); on CUDA tensors they launch `csrc/rglru_scan.cu` (fp32 or
bf16) or raise, never falling back. The forward is one kernel, a single
pass whose tiles take their carry by decoupled look-back; it keeps a
state between calls (a ticket, a count of finished blocks, an epoch and
a 16-byte record a (row, tile of 64 steps, channel): 2.6 MB at one
4096-token row of 2560 channels), one zeroed buffer per (device,
stream), sized for the largest shape it has seen.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CHUNK = 64                   # time steps per chunk of the backward
#: (device index, stream) -> the forward's state, zeroed when made
_FWD_STATE = {}


# ---------------------------------------------------------- plain forms
def _state_dtype(t) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def rglru_scan_plain(a, b) -> torch.Tensor:
    """Plain version of the forward kernel (the CPU path and the oracle
    on the card): a sequential loop over time, as the JAX package's
    `rglru_scan_ref`, with the state in fp32 (fp64 for fp64 inputs) and
    h returned in a's dtype. Differentiable by autograd (the plain path
    of `models/rglru` with `impl="reference"`)."""
    _check_args(a, b)
    sd = _state_dtype(a)
    af, bf = a.to(sd), b.to(sd)
    h = torch.zeros_like(af[:, 0])
    hs = []
    for t in range(a.shape[1]):
        h = af[:, t] * h + bf[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(a.dtype)


def rglru_scan_bwd_plain(a, h, dh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: the reverse loop over time
    giving (da, db) in a's dtype, from a, the forward's output h and the
    output gradient dh."""
    _check_args(a, h)
    sd = _state_dtype(a)
    af, hf, dhf = a.to(sd), h.to(sd), dh.to(sd)
    S = a.shape[1]
    da = torch.empty_like(af)
    db = torch.empty_like(af)
    g = torch.zeros_like(af[:, 0])
    for t in range(S - 1, -1, -1):
        g = dhf[:, t] + (af[:, t + 1] * g if t + 1 < S else 0.0)
        db[:, t] = g
        da[:, t] = g * hf[:, t - 1] if t > 0 else 0.0
    return da.to(a.dtype), db.to(a.dtype)


def _check_args(a, b) -> None:
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"want a, b [B, S, W] of one shape, not "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.dtype != b.dtype:
        raise ValueError(f"dtype mismatch: {a.dtype}, {b.dtype}")


# -------------------------------------------------------------- kernels
def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        lib.k4_error_string.restype = ctypes.c_char_p
        lib.k4_error_string.argtypes = [ctypes.c_int]
        msg = lib.k4_error_string(err).decode()
        raise RuntimeError(f"rglru_scan {what} kernel launch failed: {msg}")


def _operands(*ts):
    if ts[0].dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, not "
                        f"{ts[0].dtype}")
    if any(t.dtype != ts[0].dtype or t.device != ts[0].device
           for t in ts):
        raise ValueError("operands must share one dtype and one device")
    return [t.contiguous() for t in ts]


def _scratch(a) -> torch.Tensor:
    """The backward's scratch: each chunk's reverse map."""
    B, S, W = a.shape
    return torch.empty(2 * B * (-(-S // _CHUNK)) * W, dtype=torch.float32,
                       device=a.device)


def _fwd_state(lib, a, stream: int) -> torch.Tensor:
    """The forward's state for `a`'s device and `stream`: zeroed once,
    kept between calls (the kernel readies it for the next call), and
    made anew, zeroed, when a larger shape needs more records."""
    fn = lib.k4_forward_state_words
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_longlong
    words = fn(*a.shape, _DTYPES[a.dtype])
    if words < 0:
        raise ValueError(f"rglru_scan: the forward kernel refuses shape "
                         f"{tuple(a.shape)}")
    key = (a.device.index, stream)
    state = _FWD_STATE.get(key)
    if state is None or state.numel() < words:
        state = torch.zeros(words, dtype=torch.int32, device=a.device)
        _FWD_STATE[key] = state
    return state


def _launch_fwd(a, b):
    a, b = _operands(a, b)
    B, S, W = a.shape
    lib = build.load("rglru_scan")
    fn = lib.k4_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    h = torch.empty_like(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        state = _fwd_state(lib, a, stream)
        err = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), state.data_ptr(),
                 B, S, W, _DTYPES[a.dtype], stream)
    _raise_on(lib, err, "forward")
    rglru_scan.launches += 1
    return h


def _launch_bwd(a, h, dh):
    a, h, dh = _operands(a, h, dh.to(a.dtype))
    B, S, W = a.shape
    lib = build.load("rglru_scan")
    fn = lib.k4_backward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    da, db = torch.empty_like(a), torch.empty_like(a)
    scratch = _scratch(a)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), dh.data_ptr(), h.data_ptr(), da.data_ptr(),
                 db.data_ptr(), scratch.data_ptr(), B, S, W,
                 _DTYPES[a.dtype], stream)
    _raise_on(lib, err, "backward")
    rglru_scan_bwd.launches += 1
    return da, db


def _on_card(t) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


class _RGLRUScan(torch.autograd.Function):
    """Forward and backward bound for autograd: the kernels on CUDA
    tensors, the plain loops on CPU tensors."""

    @staticmethod
    def forward(ctx, a, b):
        h = _launch_fwd(a, b) if _on_card(a) else rglru_scan_plain(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return rglru_scan_bwd(a, h, dh)


def rglru_scan(a, b) -> torch.Tensor:
    """h `[B, S, W]` in a's dtype; see the module docstring.
    Differentiable in a and b."""
    _check_args(a, b)
    return _RGLRUScan.apply(a, b)


def rglru_scan_bwd(a, h, dh) -> Tuple[torch.Tensor, torch.Tensor]:
    """(da, db) of `rglru_scan` for output gradient `dh`, given its
    output h: the backward kernel on CUDA tensors, the plain reverse loop
    on CPU tensors."""
    _check_args(a, h)
    if not _on_card(a):
        return rglru_scan_bwd_plain(a, h, dh)
    return _launch_bwd(a, h, dh)


#: forward / backward kernel launches since the counts were last set to
#: 0 (CPU calls and plain-version calls do not count)
rglru_scan.launches = 0
rglru_scan_bwd.launches = 0
