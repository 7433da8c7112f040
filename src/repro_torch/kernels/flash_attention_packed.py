"""Packed variable-length flash attention (kernel K1): the CUDA kernels'
wrappers, their plain PyTorch versions, and the autograd function that
binds forward and backward.

`flash_attention_packed(q, k, v, segment_ids, ...)` computes what the JAX
package's `kernels/ops.flash_attention_packed` + `flash_attention_packed_flat`
compute, in the model layout: q `[B, Sq, H, D]`, k/v `[B, Sk, Hkv, D]`
(GQA: head h reads KV head h // (H // Hkv)), tables int `[B, S]` or `[S]`.

Mask of a (query i, key j) pair, as `_packed_kernel` builds it:
  * same segment: `segment_ids[i] == kv_segment_ids[j]`, `segment_ids[i]
    >= 0` (query padding is -1; key padding -2, so it never matches);
  * mode != full: key position `kv_offset + j <= i` (sliding also
    `> i - window`), OR'd with the span test `span_ids[i] >= 0` and
    `span_ids[i] == kv_span_ids[j]` when a span table is given;
  * the segment test is AND'd last.
`kv_segment_ids`/`kv_span_ids`/`kv_offset` are a ring hop's inputs: the
neighbour's tables and the position of its first key (defaults: the
query side's tables, offset 0). A row with no valid key is zeros, with
LSE -inf.

On CPU tensors the wrappers run the plain versions (the backward forms
P from the `lse` and delta from the `o` it is given, as the kernel does);
on CUDA tensors they launch
`csrc/flash_attention_packed.cu` or raise, never falling back
(`flash_attention_packed.launches_by` counts the launches by kernel and
mode, `launches_by_shape` by kernel, mode and shape). bf16 runs
on the tensor cores with fp32 accumulation, P and dS rounded to bf16
before their products: the forward by `wgmma`, two warpgroups over 128
query rows sharing a ring of K/V tiles (two blocks an SM at head_dim 64
/ 128, one at 160 and 256), the backward by `wgmma` with one block per
(query head, 64-key tile), each query head's fp32 dK and dV summed over
its KV head's group afterwards. Head dim 160 (pixtral-12b) runs as 192
columns in shared memory, the upper 32 zero-filled on the load: the
tensors cross device memory at 160. fp32 at head_dim 64 (whisper-small's)
runs in split TF32 by `wgmma` both ways: the forward as two warpgroups
over 128 query rows sharing each split K/V tile, the backward as two
kernels that each write their gradients once (dK and dV, then dQ: the
same bits on every call). fp32's backward at 128 and 160 runs in split
TF32 by `mma.sync`, as two kernels that each write their gradients once
(each query head's dK and dV, summed over its KV head's group after, then
dQ); its forward at 128 and 160 runs on the CUDA cores. Head dims 64,
128 and 160 run in both types, 256 (recurrentgemma-2b) in bf16 only.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build
from .flash_attention import MODES

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the forward and backward kernels of `csrc/flash_attention_packed.cu`
#: each input dtype launches (fp32 at head_dim 64; its backward: dK and
#: dV, with F32_DQ_KERNEL after it; see `fwd_kernel` and `bwd_kernels`)
KERNELS = {torch.float32: ("packed_fwd_f32_kernel", "packed_bwd_f32_kernel"),
           torch.bfloat16: ("packed_fwd_wg_kernel", "packed_bwd_kv_kernel")}
#: fp32's dQ kernel at head_dim 64; its CUDA-core forward at 128 / 160,
#: and its split-TF32 backward there by mma.sync (dK and dV, then dQ)
F32_DQ_KERNEL = "packed_bwd_f32_dq_kernel"
F32_FWD_CC_KERNEL = "packed_fwd_f32_cc_kernel"
F32_MMA_KERNELS = ("packed_bwd_f32_mma_kernel",
                   "packed_bwd_f32_mma_dq_kernel")
#: the head dim of fp32's split-TF32 kernels
F32_TC_HEAD_DIM = 64
_HEAD_DIMS = (64, 128, 160, 256)
#: head dims the kernels take in bf16 only (recurrentgemma-2b's 256: no
#: config runs it in fp32)
_BF16_ONLY = (256,)
_SUM_ROWS = 32            # rows per table summary entry of the kernel
NEG_INF = -1e30


# --------------------------------------------------------------- tables
def _table(t, B: int, S: int, device, fill: Optional[int] = None):
    """[S] or [B,S] ids -> contiguous int32 [B,S]; None -> `fill` or
    None."""
    if t is None:
        if fill is None:
            return None
        return torch.full((B, S), fill, dtype=torch.int32, device=device)
    t = torch.as_tensor(t, device=device).to(torch.int32)
    if t.dim() == 1:
        t = t[None].expand(B, S)
    if tuple(t.shape) != (B, S):
        raise ValueError(f"table of shape {tuple(t.shape)}, want "
                         f"[{B}, {S}] or [{S}]")
    return t.contiguous()


def _tables(q, k, segment_ids, span_ids, kv_segment_ids, kv_span_ids):
    """(segq, segk, spanq, spank) as int32 [B,S]; spans both None when
    no span table was given (the span-free kernel compiles no span
    code)."""
    B, Sq = q.shape[:2]
    Sk = k.shape[1]
    segq = _table(segment_ids, B, Sq, q.device)
    segk = (_table(kv_segment_ids, B, Sk, q.device)
            if kv_segment_ids is not None else segq)
    if segk.shape[1] != Sk:
        raise ValueError("pass kv_segment_ids when Sk != Sq")
    if span_ids is None and kv_span_ids is None:
        return segq, segk, None, None
    spanq = _table(span_ids, B, Sq, q.device, fill=-1)
    spank = (_table(kv_span_ids, B, Sk, q.device)
             if kv_span_ids is not None else spanq)
    if spank.shape[1] != Sk:
        raise ValueError("pass kv_span_ids when Sk != Sq")
    return segq, segk, spanq, spank


def pair_mask(Sq: int, Sk: int, segq, segk, spanq=None, spank=None, *,
              mode: str = "causal", window: Optional[int] = None,
              kv_offset: int = 0) -> torch.Tensor:
    """[B, Sq, Sk] bool: key j is attendable from query i (see the module
    docstring)."""
    dev = segq.device
    segq, segk = segq.long(), segk.long()
    valid = (segq[:, :, None] == segk[:, None, :]) & (segq >= 0)[:, :, None]
    if mode == "full":
        return valid
    qpos = torch.arange(Sq, device=dev)[:, None]
    kpos = kv_offset + torch.arange(Sk, device=dev)[None, :]
    ok = (kpos <= qpos)[None]
    if mode == "sliding":
        ok = ok & (kpos > qpos - window)[None]
    if spanq is not None:
        spanq, spank = spanq.long(), spank.long()
        ok = ok | ((spanq[:, :, None] >= 0)
                   & (spanq[:, :, None] == spank[:, None, :]))
    return valid & ok


# ---------------------------------------------------------- plain forms
def flash_attention_packed_ref(q, k, v, segment_ids, *,
                               mode: str = "causal",
                               window: Optional[int] = None,
                               span_ids=None, kv_segment_ids=None,
                               kv_span_ids=None, kv_offset: int = 0
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel (the CPU path and the
    test oracle): the full fp32 score matrix, masked with a finite -1e30
    so that the autograd gradient of a row without keys stays finite
    (the row is then zeroed). Returns (o in q's dtype, lse fp32
    [B, H, Sq], -inf where a row has no key). Differentiable in q, k,
    v: its autograd gradient is what `flash_attention_packed_bwd_ref`
    gives from this call's own o and lse."""
    _check_args(q, k, v, mode, window)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    segq, segk, spanq, spank = _tables(q, k, segment_ids, span_ids,
                                       kv_segment_ids, kv_span_ids)
    valid = pair_mask(Sq, Sk, segq, segk, spanq, spank, mode=mode,
                      window=window, kv_offset=kv_offset)
    vm = valid[:, None, None]                            # [B,1,1,Sq,Sk]
    qg = q.float().reshape(B, Sq, Hkv, G, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(D)
    s = s.masked_fill(~vm, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    any_key = valid.any(dim=-1)                          # [B,Sq]
    o = torch.where(any_key[:, :, None, None, None], o, 0.0)
    with torch.no_grad():
        lse = torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
        lse = torch.where(any_key[:, None, :], lse, float("-inf"))
    return o.reshape(B, Sq, H, D).to(q.dtype), lse


def flash_attention_packed_bwd_ref(q, k, v, o, lse, do, segment_ids, *,
                                   mode: str = "causal",
                                   window: Optional[int] = None,
                                   span_ids=None, kv_segment_ids=None,
                                   kv_span_ids=None, kv_offset: int = 0
                                   ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the backward kernel: (dq, dk, dv) in the inputs'
    dtypes for output gradient `do`, from the `o` and fp32 `lse` [B, H,
    Sq] it is given, in fp32 as the kernel forms them: P = exp(S - lse)
    on the valid pairs (0 elsewhere), dP = dO Vᵀ, delta = rowsum(dO ∘ o),
    dS = P ∘ (dP - delta), then dq, and dk and dv summed over each KV
    head's group. Rows whose `lse` is -inf give zeros. Given the
    forward's own `o` and `lse` this is the autograd gradient of
    `flash_attention_packed_ref`; given those of a larger softmax (a ring
    hop's keys under the merged `o` and `lse`) it is this key block's
    share of that softmax's gradient."""
    _check_args(q, k, v, mode, window)
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    segq, segk, spanq, spank = _tables(q, k, segment_ids, span_ids,
                                       kv_segment_ids, kv_span_ids)
    valid = pair_mask(Sq, Sk, segq, segk, spanq, spank, mode=mode,
                      window=window, kv_offset=kv_offset)
    scale = 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, Sq, Hkv, G, D)
    dog = do.float().reshape(B, Sq, Hkv, G, D)
    kf, vf = k.float(), v.float()
    lse = lse.float().reshape(B, Hkv, G, Sq, 1)
    live = valid[:, None, None] & torch.isfinite(lse)   # [B,Hkv,G,Sq,Sk]
    s = torch.einsum("bskgd,btkd->bkgst", qg, kf) * scale
    p = torch.where(live, torch.exp(s - lse.nan_to_num(neginf=0.0)), 0.0)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, vf)
    delta = (dog * o.float().reshape(B, Sq, Hkv, G, D)).sum(-1)
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


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


# -------------------------------------------------------------- kernels
def _check_launch(tensors, D) -> None:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("all tensors must be on one device")
    if tensors[0].dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, not "
                        f"{tensors[0].dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"kernel takes head_dim in {_HEAD_DIMS}, not {D}")
    if D in _BF16_ONLY and tensors[0].dtype != torch.bfloat16:
        raise ValueError(f"kernel takes head_dim {D} in bfloat16 only, "
                         f"not {tensors[0].dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("q, k, v (and o, do) must be contiguous")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("tensors must start on 16-byte boundaries (the "
                         "bf16 kernels load rows 16 bytes at a time)")


def _summaries(B, S, device) -> torch.Tensor:
    return torch.empty(B, -(-S // _SUM_ROWS), 4, dtype=torch.int32,
                       device=device)


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        lib.k1_error_string.restype = ctypes.c_char_p
        lib.k1_error_string.argtypes = [ctypes.c_int]
        msg = lib.k1_error_string(err).decode()
        raise RuntimeError(f"flash_attention_packed {what} kernel launch "
                           f"failed: {msg}")


def _launch_fwd(q, k, v, tables, mode, window, kv_offset):
    segq, segk, spanq, spank = tables
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    _check_launch((q, k, v), D)
    lib = build.load("flash_attention_packed")
    fn = lib.k1_forward
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    o = torch.empty_like(q)
    lse = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    sumq, sumk = _summaries(B, Sq, q.device), _summaries(B, Sk, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), segq.data_ptr(), segk.data_ptr(),
                 _ptr(spanq), _ptr(spank), sumq.data_ptr(),
                 sumk.data_ptr(), B, Sq, Sk, H, Hkv, D, _DTYPES[q.dtype],
                 MODES[mode], int(window or 0), int(kv_offset), stream)
    _raise_on(lib, err, "forward")
    flash_attention_packed.launches += 1
    _count_by(fwd_kernel(q.dtype, D), mode, q.shape[1], k.shape[1])
    return o, lse


def _last_launch(fn: str, n: int) -> list:
    lib = build.load("flash_attention_packed")
    out = (ctypes.c_longlong * n)()
    getattr(lib, fn).argtypes = [ctypes.c_void_p]
    getattr(lib, fn).restype = None
    getattr(lib, fn)(out)
    return list(out)


def last_fwd_launch() -> dict:
    """The last launch of the forward kernel (either dtype, any
    head_dim: the one `fwd_kernel` names), as the library recorded it:
    `grid` (x, y, z), `threads` a block and `smem_bytes` of dynamic
    shared memory."""
    out = _last_launch("k1_last_fwd_launch", 5)
    return dict(grid=tuple(out[:3]), threads=out[3], smem_bytes=out[4])


def last_bwd_kv_launch() -> dict:
    """The last launch of the backward's key-side kernel (either dtype,
    any head_dim; in fp32 its dK / dV kernel), as the library recorded
    it: `grid` (x, y, z), `threads` a block, `smem_bytes` of dynamic
    shared memory and `work_bytes` of the fp32 scratch (each query
    head's dK and dV; 0 when H == Hkv, and in fp32 at head_dim 64) it
    addressed."""
    out = _last_launch("k1_last_bwd_kv_launch", 6)
    return dict(grid=tuple(out[:3]), threads=out[3], smem_bytes=out[4],
                work_bytes=out[5])


def last_bwd_dq_launch() -> dict:
    """The last launch of fp32's dQ kernel (any head_dim), as the library
    recorded it: `grid` (x, y, z), `threads` a block and `smem_bytes` of
    dynamic shared memory."""
    out = _last_launch("k1_last_bwd_dq_launch", 5)
    return dict(grid=tuple(out[:3]), threads=out[3], smem_bytes=out[4])


def fwd_kernel(dtype, D: int) -> str:
    """The kernel one forward launches in `dtype` at head_dim `D` (the
    summaries aside)."""
    if dtype == torch.float32 and D != F32_TC_HEAD_DIM:
        return F32_FWD_CC_KERNEL
    return KERNELS[dtype][0]


def bwd_kernels(dtype, D: int) -> tuple:
    """The kernels one backward launches in `dtype` at head_dim `D`, in
    launch order (the summaries and delta aside)."""
    if dtype == torch.float32:
        return ((KERNELS[dtype][1], F32_DQ_KERNEL) if D == F32_TC_HEAD_DIM
                else F32_MMA_KERNELS)
    return (KERNELS[dtype][1],)


def _launch_bwd(q, k, v, o, lse, do, tables, mode, window, kv_offset):
    segq, segk, spanq, spank = tables
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    do = do.contiguous()
    _check_launch((q, k, v, o, do), D)
    if do.dtype != q.dtype or o.dtype != q.dtype:
        raise ValueError("o and do must have q's dtype")
    lib = build.load("flash_attention_packed")
    fn = lib.k1_backward
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    # bf16 adds dQ with atomics; fp32's dQ kernels write every row
    dq_acc = (torch.zeros if q.dtype == torch.bfloat16 else torch.empty)(
        q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    sumq, sumk = _summaries(B, Sq, q.device), _summaries(B, Sk, q.device)
    # H > Hkv in bf16, and in fp32 beside head_dim 64: each query head's
    # dK and dV in fp32 before the group sum
    grouped = H != Hkv and (q.dtype == torch.bfloat16
                            or D != F32_TC_HEAD_DIM)
    work = (torch.empty(2 * B * Sk * H * D, dtype=torch.float32,
                        device=q.device) if grouped else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                 dq_acc.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 _ptr(work), segq.data_ptr(), segk.data_ptr(), _ptr(spanq),
                 _ptr(spank), sumq.data_ptr(), sumk.data_ptr(), B, Sq, Sk,
                 H, Hkv, D, _DTYPES[q.dtype], MODES[mode],
                 int(window or 0), int(kv_offset), stream)
    _raise_on(lib, err, "backward")
    flash_attention_packed_bwd.launches += 1
    for kernel in bwd_kernels(q.dtype, D):
        _count_by(kernel, mode, q.shape[1], k.shape[1])
    return dq_acc.to(q.dtype), dk, dv


def _count_by(kernel: str, mode: str, sq: int, sk: int) -> None:
    for by, key in ((flash_attention_packed.launches_by, f"{kernel} {mode}"),
                    (flash_attention_packed.launches_by_shape,
                     f"{kernel} {mode} {sq}x{sk}")):
        by[key] = by.get(key, 0) + 1


def _on_card(q) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return True


class _PackedAttention(torch.autograd.Function):
    """Forward and backward kernels bound for autograd (CUDA tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, tables, mode, window, kv_offset):
        o, lse = _launch_fwd(q, k, v, tables, mode, window, kv_offset)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.tables, ctx.cfg = tables, (mode, window, kv_offset)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _launch_bwd(q, k, v, o, lse, do, ctx.tables,
                                 *ctx.cfg)
        return dq, dk, dv, None, None, None, None


def flash_attention_packed(q, k, v, segment_ids, *, mode: str = "causal",
                           window: Optional[int] = None, span_ids=None,
                           kv_segment_ids=None, kv_span_ids=None,
                           kv_offset: int = 0, return_lse: bool = False):
    """Model-layout packed attention; see the module docstring. Returns
    o `[B, Sq, H, D]` in q's dtype, and with `return_lse` also the fp32
    LSE `[B, H, Sq]`. Differentiable in q, k, v."""
    _check_args(q, k, v, mode, window)
    kw = dict(mode=mode, window=window, span_ids=span_ids,
              kv_segment_ids=kv_segment_ids, kv_span_ids=kv_span_ids,
              kv_offset=kv_offset)
    if not _on_card(q):
        o, lse = flash_attention_packed_ref(q, k, v, segment_ids, **kw)
    else:
        tables = _tables(q, k, segment_ids, span_ids, kv_segment_ids,
                         kv_span_ids)
        o, lse = _PackedAttention.apply(q.contiguous(), k.contiguous(),
                                        v.contiguous(), tables, mode,
                                        window, int(kv_offset))
    return (o, lse) if return_lse else o


def flash_attention_packed_bwd(q, k, v, o, lse, do, segment_ids, *,
                               mode: str = "causal",
                               window: Optional[int] = None, span_ids=None,
                               kv_segment_ids=None, kv_span_ids=None,
                               kv_offset: int = 0):
    """(dq, dk, dv) of the packed attention for output gradient `do`,
    given the forward's `o` and `lse`: the backward kernel on CUDA
    tensors, the plain version on CPU tensors."""
    _check_args(q, k, v, mode, window)
    kw = dict(mode=mode, window=window, span_ids=span_ids,
              kv_segment_ids=kv_segment_ids, kv_span_ids=kv_span_ids,
              kv_offset=kv_offset)
    if not _on_card(q):
        return flash_attention_packed_bwd_ref(q, k, v, o, lse, do,
                                              segment_ids, **kw)
    tables = _tables(q, k, segment_ids, span_ids, kv_segment_ids,
                     kv_span_ids)
    return _launch_bwd(q.contiguous(), k.contiguous(), v.contiguous(),
                       o.contiguous(), lse, do, tables, mode, window,
                       int(kv_offset))


#: forward / backward kernel launches since the counts were last set to
#: 0 (CPU calls and plain-version calls do not count)
flash_attention_packed.launches = 0
flash_attention_packed_bwd.launches = 0
#: the launches of both directions by kernel and mode
#: ("packed_fwd_f32_kernel full", "packed_bwd_kv_kernel causal", ...:
#: the kernels that ran, `fwd_kernel` and `bwd_kernels`; fp32's backward
#: counts both its kernels), since the dict was last set to {}
flash_attention_packed.launches_by = {}
#: the same by kernel, mode and shape (query rows x key rows a batch
#: row: "packed_bwd_f32_kernel full 448x1500", ...)
flash_attention_packed.launches_by_shape = {}
