"""K2's fp32 kernel as it runs, replayed in torch ops on the CPU.

`flash_fwd_f32_kernel` (`csrc/flash_attention.cu`) forms both products
of attention on the tensor cores in split TF32: each fp32 operand x as
hi = tf32(x) (round to nearest, ties away from zero) and lo = tf32(x -
hi), each product as hi hi' + hi lo' + lo hi', summed in fp32. It walks
blocks of 64 query rows over the key tiles of 64 their rows can see,
with an online softmax in log2 units. `split_tf32_attention` below
replays that walk, rounding where the kernel rounds, and holds it:

  * to the port's plain version and to the JAX package's Pallas kernel
    (interpret mode) at small shapes in every mode, Sq != Sk, GQA and a
    kv_offset (1e-5);
  * at whisper-small's encoder shape (1 x 1500, 12:12 heads of 64, full)
    within fp32's 1e-4 limit, where plain TF32 (the lo terms dropped)
    misses it: the reason the kernel splits;
  * and the register layout it relies on: P's A operand taken from S's
    accumulator as it lies meets V^T's keys in the permuted order the
    kernel writes them, and their product is P V exactly.
"""
import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.ops import flash_attention as jax_flash
from repro_torch.kernels.flash_attention import _valid_mask
from repro_torch.kernels.flash_attention import flash_attention_ref

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

#: chip_smoke.py phase 3's fp32 limit, max|err| / max(1, |plain|)
TOL_F32 = 1e-4
BQ = BK = 64   # the kernel's query rows a block and keys a tile
LOG2E = 1.4426950408889634


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 as `cvt.rna.tf32.f32` rounds: the magnitude to 10
    mantissa bits, nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor, lo: bool = True):
    hi = tf32(x)
    return hi, (tf32(x - hi) if lo else torch.zeros_like(x))


def split_product(a, b, lo=True):
    """a @ b as the kernel forms it: hi hi' + hi lo' + lo hi', each a
    product of TF32 values (exact in fp32), summed in fp32; `lo=False`
    is plain TF32."""
    (ah, al), (bh, bl) = split(a, lo), split(b, lo)
    return al @ bh + ah @ bl + ah @ bh


def split_tf32_attention(q, k, v, *, mode="causal", window=None,
                         kv_offset=0, lo=True):
    """The kernel's walk in fp32 torch ops: q [B, Sq, H, D], k/v [B, Sk,
    Hkv, D] -> [B, Sq, H, D]; rows with no valid key are zeros."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qh = q.permute(0, 2, 1, 3)                             # [B, H, Sq, D]
    kh = k.repeat_interleave(G, 2).permute(0, 2, 1, 3)     # [B, H, Sk, D]
    vh = v.repeat_interleave(G, 2).permute(0, 2, 1, 3)
    valid = _valid_mask(Sq, Sk, mode, window, kv_offset, "cpu")
    sl2 = (1.0 / D ** 0.5) * LOG2E
    out = torch.zeros(B, H, Sq, D)
    # in full mode every block of query rows walks the same key tiles
    # with row-wise softmax state, so all blocks walk them at once
    bq = Sq if mode == "full" else BQ
    for q0 in range(0, Sq, bq):
        q1 = min(q0 + bq, Sq)
        j_lo, j_hi = 0, Sk
        if mode != "full":
            j_hi = max(0, min(Sk, q1 - kv_offset))
            if mode == "sliding":
                j_lo = max(0, q0 - window - kv_offset + 1)
        m = torch.full((B, H, q1 - q0, 1), float("-inf"))
        l = torch.zeros(B, H, q1 - q0, 1)
        acc = torch.zeros(B, H, q1 - q0, D)
        for j0 in range(j_lo // BK * BK, j_hi, BK):
            j1 = min(j0 + BK, Sk)
            s = split_product(qh[:, :, q0:q1], kh[:, :, j0:j1].transpose(
                -1, -2), lo) * sl2
            s = s.masked_fill(~valid[q0:q1, j0:j1], float("-inf"))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            m0 = torch.where(m_new == float("-inf"), 0.0, m_new)
            corr = torch.exp2(m - m0)
            p = torch.exp2(s - m0)
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + split_product(p, vh[:, :, j0:j1], lo)
            m = m_new
        out[:, :, q0:q1] = torch.where(l > 0, acc / l.clamp_min(1e-30),
                                       0.0)
    return out.permute(0, 2, 1, 3)


@contextlib.contextmanager
def _one_thread():
    """torch on one thread, restored after: the suite's workers share the
    machine's cores, and a walk of many small products slows down most
    when every worker's threads contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _inputs(B, Sq, Sk, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


def _scaled(got, want) -> float:
    want = torch.from_numpy(np.array(want, np.float32))
    return ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()


#: (B, Sq, Sk, H, Hkv, D, mode, window, kv_offset): full over a partial
#: last key tile (Sq != Sk), causal at a kv_offset either way (rows with
#: no key), sliding longer than a tile, GQA, head dims 32 and 128
CASES = [(2, 70, 150, 4, 4, 64, "full", None, 0),
         (1, 130, 130, 4, 2, 64, "causal", None, 0),
         (2, 100, 160, 4, 1, 32, "causal", None, 40),
         (1, 90, 200, 4, 2, 128, "causal", None, -64),
         (2, 200, 200, 4, 4, 64, "sliding", 72, 0)]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_split_tf32_walk_matches_plain_and_pallas(case):
    """The kernel's walk against the port's plain version (every case)
    and the JAX package's Pallas kernel (interpret; the cases without a
    kv_offset, which its model-layout wrapper does not take), 1e-5."""
    B, Sq, Sk, H, Hkv, D, mode, window, off = CASES[case]
    q, k, v = _inputs(B, Sq, Sk, H, Hkv, D, 200 + case)
    got = split_tf32_attention(q, k, v, mode=mode, window=window,
                               kv_offset=off)
    plain = flash_attention_ref(q, k, v, mode=mode, window=window,
                                kv_offset=off)
    assert _scaled(got, plain) <= 1e-5
    if mode != "full" and off > 0:
        assert (got[:, :off] == 0).all() and (plain[:, :off] == 0).all()
    if off == 0:
        want = jax_flash(*(jnp.asarray(a.numpy()) for a in (q, k, v)),
                         mode=mode, window=window)
        assert _scaled(got, want) <= 1e-5


def test_plain_tf32_misses_the_limit_at_whisper_encoder():
    """whisper-small's encoder attention (1 x 1500 full, 12:12 heads of
    64, 1500 keys): the split walk lies far within 1e-4 of the plain
    fp32 version; the same walk without the lo terms (plain TF32, the
    fault k2_fault_check.py plants as f32_lo_dropped) lies beyond it."""
    q, k, v = _inputs(1, 1500, 1500, 12, 12, 64, 90)
    with _one_thread():
        plain = flash_attention_ref(q, k, v, mode="full")
        split_err = _scaled(split_tf32_attention(q, k, v, mode="full"),
                            plain)
        tf32_err = _scaled(split_tf32_attention(q, k, v, mode="full",
                                                lo=False), plain)
    print(f"split TF32 {split_err:.3g}, plain TF32 {tf32_err:.3g}")
    assert split_err <= TOL_F32 / 10
    assert tf32_err > TOL_F32


def test_p_operand_meets_v_in_permuted_key_order():
    """One warp's 16 rows and a tile of 64 keys, as the kernel lays them
    out. S's accumulator gives lane l = 4 g + t the values at rows g, g +
    8 and keys 8 n + 2 t (+1); P's A operand of k-step kk is
    {s[kk][0], s[kk][2], s[kk][1], s[kk][3]} at (row g, k t), (g + 8, t),
    (g, t + 4), (g + 8, t + 4); V^T holds key r of the tile at position
    kap(r). The mma's product over those operands is P V, to the bit."""
    rng = np.random.default_rng(5)
    P = rng.integers(-8, 8, (16, 64)).astype(np.float64)
    V = rng.integers(-8, 8, (64, 32)).astype(np.float64)

    def kap(r):  # the kernel's V^T position of key r
        w = r & 7
        return (r & ~7) + (4 + (w >> 1) if w & 1 else w >> 1)
    assert sorted(kap(r) for r in range(64)) == list(range(64))
    Vt = np.zeros((32, 64))
    for r in range(64):
        Vt[:, kap(r)] = V[r]
    O = np.zeros((16, 32))
    for kk in range(8):
        A = np.zeros((16, 8))            # the A operand, (row, k)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            s = [P[g + 8 * (e >> 1), 8 * kk + 2 * t + (e & 1)]
                 for e in range(4)]      # s[kk][e] as the lane holds it
            a = (s[0], s[2], s[1], s[3])
            A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a
        # B[k][n] = V^T[n][8 kk + k]: K-major, k-step kk's 8 positions
        O += A @ Vt[:, 8 * kk:8 * kk + 8].T
    np.testing.assert_array_equal(O, P @ V)
