"""Mamba-2 SSD intra-chunk step (kernel K3): the CUDA kernels' wrappers,
their plain PyTorch versions, and the autograd function that binds
forward and backward.

What it computes, per (sequence, chunk, head) cell of c tokens, as the
JAX package's `kernels/ssd_chunk.ssd_chunk_pallas` does:

    cum      = cumsum(da)                                 [c]
    L[i,j]   = exp(cum_i - cum_j) for i >= j, else 0       [c,c]
    y_intra  = ((C B^T) * L * dt_j) x                      [c,P]
    states   = (B * dt * exp(cum_end - cum))^T x           [N,P]

`exp` is taken only where i >= j. Above the diagonal cum_i - cum_j is a
positive sum of dt (about 190 over a 256-token chunk), whose exp
overflows fp32: the forward would still be finite (the mask drops those
entries), but the gradient would multiply a zero cotangent by inf and
give NaN, as the JAX reference's does at mamba2-370m's chunk length.

Two layouts:
  * `ssd_chunk_ref(C, B, x, da, dt)` — the JAX package's: C, B [G,c,N],
    x [G,c,P], da, dt [G,c] (G = batch x heads x chunks) -> (y [G,c,P],
    states [G,N,P], cum [G,c]), fp32. The plain version; its autograd
    gradient is the backward kernel's plain version.
  * `ssd_chunk(C, B, x, da, dt, chunk=)` — the model's: C, B [Bsz,S,N]
    (one B/C group shared by every head; the token stride may be any,
    so slices of the conv output pass without a copy), x [Bsz,S,H,P]
    (heads contiguous), da, dt fp32 [Bsz,S,H], S a multiple of `chunk`
    -> (y [Bsz,S,H,P], states [Bsz,nc,H,N,P], cum [Bsz,S,H]), fp32.
    The JAX layout is its case H = 1, Bsz = G, S = c.

On CPU tensors `ssd_chunk` runs the plain version; on CUDA tensors it
launches `csrc/ssd_chunk.cu` (fp32 or bf16 C, B, x, upcast in the
kernel; fp32 arithmetic, the tensor-core products in split TF32 that
keeps it) or raises, never falling back. Both directions form C B^T
once a chunk (C and B are shared by the heads) and take a group of
heads a block: the forward in two kernels, the backward in three, which
also sums the score gradient over heads before its products with B and
C (`last_fwd_launch` and `last_bwd_launch` record the launch of the
kernel that takes the heads).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the (d_state N, head_dim P) pairs the kernels are built for: those of
#: the configs (mamba2-370m full width and reduced)
_DIMS = ((128, 64), (16, 32))
_TILE = 32                      # chunk lengths: multiples of the row tile
#: the profiler range around `ssd_chunk_scan`'s inter-chunk part
INTER_CHUNK = "ssd_inter_chunk"


# ----------------------------------------------------------- plain form
def _up(t):
    """fp32, or fp64 for fp64 inputs (the plain version's exact mode)."""
    return t if t.dtype == torch.float64 else t.float()


def ssd_chunk_ref(C, B, x, da, dt) -> Tuple[torch.Tensor, ...]:
    """Plain version in the JAX layout (see the module docstring), with
    the decay formed only on and below the diagonal. Computes in fp32,
    or in fp64 when given fp64 inputs."""
    C, B, x, da, dt = (_up(t) for t in (C, B, x, da, dt))
    c = C.shape[1]
    cum = torch.cumsum(da, dim=1)                          # [G,c]
    tril = torch.ones(c, c, dtype=torch.bool, device=C.device).tril()
    diff = cum[:, :, None] - cum[:, None, :]
    L = diff.masked_fill(~tril, float("-inf")).exp()       # 0 above
    scores = torch.einsum("gin,gjn->gij", C, B) * L * dt[:, None, :]
    y = torch.einsum("gij,gjp->gip", scores, x)
    decay_end = torch.exp(cum[:, -1:] - cum) * dt          # [G,c]
    states = torch.einsum("gjn,gj,gjp->gnp", B, decay_end, x)
    return y, states, cum


def _to_cells(C, B, x, da, dt, chunk):
    """Model layout -> the JAX layout, C and B broadcast to every head.
    Everything is upcast first, as the JAX package upcasts before its
    broadcast, so the gradients of C and B are summed over heads in
    fp32 and rounded to the input type once."""
    C, B, x, da, dt = (_up(t) for t in (C, B, x, da, dt))
    Bsz, S, H, P = x.shape
    N, nc = C.shape[-1], S // chunk
    cb = lambda t: t.reshape(Bsz, nc, 1, chunk, N).expand(  # noqa: E731
        Bsz, nc, H, chunk, N).reshape(-1, chunk, N)
    xs = x.reshape(Bsz, nc, chunk, H, P).permute(0, 1, 3, 2, 4)
    sc = lambda t: t.reshape(Bsz, nc, chunk, H).permute(  # noqa: E731
        0, 1, 3, 2).reshape(-1, chunk)
    return cb(C), cb(B), xs.reshape(-1, chunk, P), sc(da), sc(dt)


def ssd_chunk_plain(C, B, x, da, dt, *, chunk: int):
    """Plain version in the model layout (`ssd_chunk`'s CPU path and the
    kernel's oracle on the card, where it runs on fp64 copies of the
    inputs: at c = 256 its fp32 gradients are themselves some 2e-4 off)."""
    _check_args(C, B, x, da, dt, chunk)
    Bsz, S, H, P = x.shape
    N, nc = C.shape[-1], S // chunk
    y, st, cum = ssd_chunk_ref(*_to_cells(C, B, x, da, dt, chunk))
    y = y.reshape(Bsz, nc, H, chunk, P).permute(0, 1, 3, 2, 4)
    cum = cum.reshape(Bsz, nc, H, chunk).permute(0, 1, 3, 2)
    return (y.reshape(Bsz, S, H, P), st.reshape(Bsz, nc, H, N, P),
            cum.reshape(Bsz, S, H))


def ssd_chunk_bwd_plain(C, B, x, da, dt, dy, dstates, dcum, *,
                        chunk: int):
    """Plain version of the backward kernel: (dC, dB, dx, dda, ddt), the
    autograd gradient of `ssd_chunk_plain`."""
    with torch.enable_grad():
        ins = [t.detach().requires_grad_(True) for t in (C, B, x, da, dt)]
        outs = ssd_chunk_plain(*ins, chunk=chunk)
        cots = [g.to(o.dtype) for g, o in zip((dy, dstates, dcum), outs)]
        return torch.autograd.grad(outs, ins, cots)


def _check_args(C, B, x, da, dt, chunk) -> None:
    if x.dim() != 4 or C.dim() != 3 or B.shape != C.shape:
        raise ValueError(f"want C, B [Bsz,S,N] and x [Bsz,S,H,P], not "
                         f"{tuple(C.shape)}, {tuple(B.shape)}, "
                         f"{tuple(x.shape)}")
    Bsz, S, H, _ = x.shape
    if C.shape[:2] != (Bsz, S):
        raise ValueError("C, B and x disagree on batch or length")
    if da.shape != (Bsz, S, H) or dt.shape != (Bsz, S, H):
        raise ValueError(f"da and dt must be [{Bsz}, {S}, {H}]")
    if chunk < 1 or S % chunk:
        raise ValueError(f"length {S} is not a multiple of chunk {chunk}")


# -------------------------------------------------------------- kernels
def _rows(t):
    """(tensor, token stride) of a [Bsz, S, ...] input whose rows the
    kernel can walk in place: last dims contiguous, tokens at one
    stride."""
    inner = 1
    for d in range(t.dim() - 1, 1, -1):
        if t.stride(d) != inner:
            t = t.contiguous()
            break
        inner *= t.shape[d]
    ld = t.stride(1)
    if t.stride(0) != t.shape[1] * ld or ld < inner:
        t = t.contiguous()
        ld = t.stride(1)
    return t, ld


def _operands(C, B, x, da, dt, chunk):
    """Checked kernel operands: (C, B, x, the C/B token stride, the x
    token stride, da and dt as contiguous fp32). C, B and x are copied
    where the kernels could not load them 16 bytes at a time."""
    _check_launch(C, B, x, chunk)
    C, ld_cb = _rows(C)
    B, ld_b = _rows(B)
    if ld_b != ld_cb or _misaligned(C, ld_cb) or _misaligned(B, ld_cb):
        C, B = (t.clone(memory_format=torch.contiguous_format)
                for t in (C, B))
    x = _aligned(*_rows(x))
    return (C, B, x, C.stride(1), x.stride(1), da.float().contiguous(),
            dt.float().contiguous())


def _check_launch(C, B, x, chunk) -> None:
    if C.dtype not in _DTYPES:
        raise TypeError(f"kernel takes float32 or bfloat16, not {C.dtype}")
    if not (C.dtype == B.dtype == x.dtype):
        raise ValueError(f"dtype mismatch: {C.dtype}, {B.dtype}, {x.dtype}")
    N, P = C.shape[-1], x.shape[-1]
    if (N, P) not in _DIMS:
        raise ValueError(f"kernel takes (d_state, head_dim) in {_DIMS}, "
                         f"not ({N}, {P})")
    if chunk % _TILE or chunk > 1024:
        raise ValueError(f"kernel takes chunks of a multiple of {_TILE} "
                         f"up to 1024, not {chunk}")


def _library() -> ctypes.CDLL:
    """The kernels' library, its functions' C types bound once per loaded
    library rather than on every call."""
    lib = build.load("ssd_chunk")
    if lib.k3_backward.argtypes is None:
        for fn, n_ptr in ((lib.k3_forward, 9), (lib.k3_backward, 14)):
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + \
                [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for fn in (lib.k3_forward_work, lib.k3_backward_work):
            fn.argtypes = [ctypes.c_int] * 7
            fn.restype = ctypes.c_longlong
        for fn in (lib.k3_last_fwd_launch, lib.k3_last_bwd_launch):
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = None
        lib.k3_error_string.argtypes = [ctypes.c_int]
        lib.k3_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.k3_error_string(err).decode()
        raise RuntimeError(f"ssd_chunk {what} kernel launch failed: {msg}")


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(C, B, x, da, dt, chunk):
    C, B, x, ld_cb, ld_x, da, dt = _operands(C, B, x, da, dt, chunk)
    Bsz, S, H, P = x.shape
    N, nc = C.shape[-1], S // chunk
    lib = _library()
    dev, code = x.device, _DTYPES[x.dtype]
    work = torch.empty(lib.k3_forward_work(Bsz, S, H, N, P, chunk, code),
                       dtype=torch.uint8, device=dev)
    y = torch.empty(Bsz, S, H, P, dtype=torch.float32, device=dev)
    states = torch.empty(Bsz, nc, H, N, P, dtype=torch.float32, device=dev)
    cum = torch.empty(Bsz, S, H, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.k3_forward(
            C.data_ptr(), B.data_ptr(), x.data_ptr(), da.data_ptr(),
            dt.data_ptr(), y.data_ptr(), states.data_ptr(), cum.data_ptr(),
            work.data_ptr(), Bsz, S, H, N, P, chunk, ld_cb, ld_x, code,
            _stream(x))
    _raise_on(lib, err, "forward")
    ssd_chunk.launches += 1
    return y, states, cum


def _launch_record(fn, kernel) -> dict:
    out = (ctypes.c_longlong * 8)()
    fn(out)
    return dict(kernel=kernel if out[0] else None, grid=tuple(out[1:4]),
                threads=out[4], smem_bytes=out[5], heads_per_block=out[6],
                work_bytes=out[7])


def last_fwd_launch() -> dict:
    """The last forward launch, as the library recorded it: the kernel
    that took the heads (`k3_fwd_heads`, after `k3_cb`), its `grid` (x,
    y, z), `threads` a block, `smem_bytes` of dynamic shared memory and
    `heads_per_block`, and `work_bytes` of fp32 scratch (C B^T) the
    forward used; all 0 (kernel None) before the first."""
    return _launch_record(_library().k3_last_fwd_launch, "k3_fwd_heads")


def last_bwd_launch() -> dict:
    """The last backward launch, as `last_fwd_launch` has it: the kernel
    that took the heads (`k3_bwd_heads`, after `k3_cb` and before
    `k3_bwd_dcb`) and the fp32 scratch the backward used."""
    return _launch_record(_library().k3_last_bwd_launch, "k3_bwd_heads")


def _misaligned(t, ld=None) -> bool:
    """Whether `t` (or its token stride `ld`, in elements) is not in
    whole 16-byte units: the kernels load 16 bytes at a time."""
    return bool(t.data_ptr() % 16
                or (ld is not None and ld * t.element_size() % 16))


def _aligned(t, ld=None):
    """`t`, or a fresh contiguous copy of it where it is misaligned."""
    return t.clone(memory_format=torch.contiguous_format) \
        if _misaligned(t, ld) else t


def _launch_bwd(C, B, x, da, dt, dy, dstates, dcum, chunk):
    in_dtype = C.dtype
    C, B, x, ld_cb, ld_x, da, dt = _operands(C, B, x, da, dt, chunk)
    Bsz, S, H, P = x.shape
    N, nc = C.shape[-1], S // chunk
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dy = (torch.zeros(Bsz, S, H, P, **f32) if dy is None
          else _aligned(dy.float().contiguous()))
    dstates = (torch.zeros(Bsz, nc, H, N, P, **f32) if dstates is None
               else _aligned(dstates.float().contiguous()))
    dcum = (torch.zeros(Bsz, S, H, **f32) if dcum is None
            else dcum.float().contiguous())
    lib = _library()
    code = _DTYPES[in_dtype]
    work = torch.empty(lib.k3_backward_work(Bsz, S, H, N, P, chunk, code),
                       dtype=torch.uint8, device=dev)
    dC = torch.empty(Bsz, S, N, dtype=in_dtype, device=dev)
    dB = torch.empty(Bsz, S, N, dtype=in_dtype, device=dev)
    dx = torch.empty(Bsz, S, H, P, dtype=in_dtype, device=dev)
    dda = torch.empty(Bsz, S, H, **f32)
    ddt = torch.empty(Bsz, S, H, **f32)
    with torch.cuda.device(dev):
        err = lib.k3_backward(
            C.data_ptr(), B.data_ptr(), x.data_ptr(), da.data_ptr(),
            dt.data_ptr(), dy.data_ptr(), dstates.data_ptr(),
            dcum.data_ptr(), dC.data_ptr(), dB.data_ptr(), dx.data_ptr(),
            dda.data_ptr(), ddt.data_ptr(), work.data_ptr(), Bsz, S, H, N,
            P, chunk, ld_cb, ld_x, code, _stream(x))
    _raise_on(lib, err, "backward")
    ssd_chunk_bwd.launches += 1
    return dC, dB, dx, dda, ddt


def _on_card(t) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return True


class _SSDChunk(torch.autograd.Function):
    """Forward and backward kernels bound for autograd (CUDA tensors)."""

    @staticmethod
    def forward(ctx, C, B, x, da, dt, chunk):
        y, states, cum = _launch_fwd(C, B, x, da, dt, chunk)
        ctx.save_for_backward(C, B, x, da, dt)
        ctx.chunk = chunk
        return y, states, cum

    @staticmethod
    def backward(ctx, dy, dstates, dcum):
        C, B, x, da, dt = ctx.saved_tensors
        dC, dB, dx, dda, ddt = _launch_bwd(C, B, x, da, dt, dy, dstates,
                                           dcum, ctx.chunk)
        return dC, dB, dx, dda, ddt, None


def ssd_chunk(C, B, x, da, dt, *, chunk: int):
    """Model-layout intra-chunk SSD; see the module docstring. Returns
    (y_intra, states, cum), fp32. Differentiable in every input."""
    _check_args(C, B, x, da, dt, chunk)
    if not _on_card(x):
        return ssd_chunk_plain(C, B, x, da, dt, chunk=chunk)
    return _SSDChunk.apply(C, B, x, da, dt, int(chunk))


def ssd_chunk_bwd(C, B, x, da, dt, dy, dstates, dcum, *, chunk: int):
    """(dC, dB, dx, dda, ddt) of `ssd_chunk` for the output gradients:
    the backward kernel on CUDA tensors, the plain version on CPU ones."""
    _check_args(C, B, x, da, dt, chunk)
    if not _on_card(x):
        return ssd_chunk_bwd_plain(C, B, x, da, dt, dy, dstates, dcum,
                                   chunk=chunk)
    return _launch_bwd(C, B, x, da, dt, dy, dstates, dcum, int(chunk))


def ssd_chunk_scan(C, B, x, da, dt, *, chunk: int,
                   plain: bool = False) -> torch.Tensor:
    """The full chunked SSD of independent sequences, as the JAX
    package's `kernels/ops.ssd_chunk_scan`: the intra-chunk term from K3
    (or its plain version with `plain=True`), then the O(nc) scan of the
    chunk states and the inter-chunk term C h_prev exp(cum). Model
    layout as `ssd_chunk`; returns y [Bsz,S,H,P] fp32. The scan and the
    inter-chunk product are torch ops (the JAX package keeps them out of
    its kernel too); autograd through them hands K3's backward its
    dstates and dcum."""
    fn = ssd_chunk_plain if plain else ssd_chunk
    y_intra, states, cum = fn(C, B, x, da, dt, chunk=chunk)
    Bsz, S, H, P = x.shape
    N, nc = C.shape[-1], S // chunk
    # a profiler range, so that a trace can show this part's device time
    with torch.profiler.record_function(INTER_CHUNK):
        decay = torch.exp(cum[:, chunk - 1::chunk])        # [Bsz,nc,H]
        h = torch.zeros(Bsz, H, N, P, dtype=torch.float32,
                        device=x.device)
        prev = []
        for k in range(nc):
            prev.append(h)                                 # state BEFORE k
            h = h * decay[:, k, :, None, None] + states[:, k]
        h_prev = torch.stack(prev, dim=1)                  # [Bsz,nc,H,N,P]
        Cc = C.float().reshape(Bsz, nc, chunk, N)
        y_inter = torch.einsum("bkin,bkhnp->bkihp", Cc, h_prev)
        y_inter = y_inter.reshape(Bsz, S, H, P) * torch.exp(cum)[..., None]
    return y_intra + y_inter


#: forward / backward kernel launches since the counts were last set to
#: 0 (CPU calls and plain-version calls do not count)
ssd_chunk.launches = 0
ssd_chunk_bwd.launches = 0
