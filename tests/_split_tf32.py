"""What the CPU replays of K1's fp32 split-TF32 kernels share
(tests/test_torch_k1_f32_split.py for the backward,
tests/test_torch_k1_f32_fwd_split.py for the forward): TF32 rounding as
the card does it, the split product, the tables' segments and spans,
the kernels' key order `kap` and the 128-byte swizzle `sw128`."""
import numpy as np
import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as `cvt.rna.tf32.f32` rounds: the magnitude to 10
    mantissa bits, nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_product(a, b, lo=True):
    """a @ b as the kernels form it: hi hi' + hi lo' + lo hi', each a
    product of TF32 values (exact in fp32), summed in fp32; `lo=False`
    is plain TF32 (every lo zeroed)."""
    ah, bh = tf32(a), tf32(b)
    if not lo:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def scaled(got, want) -> float:
    """max |got - want| / max(1, |want|), chip_smoke.py's fp32 measure."""
    want = torch.as_tensor(np.array(want, np.float32))
    return ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()


def seg(B, S, lens, frame=None):
    """Segments of `lens` then tail padding (-1); with `frame`, spans of
    `frame` tokens after every `frame // 2` causal ones (ids unique)."""
    segs = np.full((B, S), -1, np.int32)
    span = np.full((B, S), -1, np.int32)
    off, sid = 0, 0
    for i, L in enumerate(lens):
        segs[:, off:off + L] = i
        p = (frame or 0) // 2
        while frame and p < L:
            span[:, off + p:off + min(p + frame, L)] = sid
            sid, p = sid + 1, p + frame + frame // 2
        off += L
    return segs, (span if frame else None)


def as_tensor(a):
    """numpy -> torch on the CPU; None stays None."""
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def kap(r: int) -> int:
    """The kernels' position of walked row r in a transposed tile: within
    each group of 8, row 2i at i and row 2i + 1 at i + 4."""
    w = r & 7
    return (r & ~7) + (4 + (w >> 1) if w & 1 else w >> 1)


def sw128(rows, r, c):
    """`sw128<ROWS>(r, c)` of hopper.cuh: byte offset of 16-byte chunk c
    of row r, rows of 128 bytes in blocks of ROWS, chunks swizzled by
    r % 8."""
    return (c >> 3) * (rows * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4)
