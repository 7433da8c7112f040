"""K1's fp32 backward as it runs at head_dim 64, replayed in torch ops on
the CPU.

`packed_bwd_f32_kernel` and `packed_bwd_f32_dq_kernel`
(`csrc/flash_attention_packed.cu`) form every product of the backward on
the tensor cores in split TF32: each fp32 operand x as hi = tf32(x)
(round to nearest, ties away from zero) and lo = tf32(x - hi), each
product as hi hi' + hi lo' + lo hi', summed in fp32. The first walks
64-key tiles over query tiles of 32, head by head of the KV head's group
(S^T = K Q^T, dP^T = V dO^T, P^T, dS^T, dV += P^T dO, dK += dS^T Q); the
second walks 64-query tiles over key tiles of 32 (S = Q K^T, dP = dO
V^T, P, dS, dQ += dS K). `split_tf32_backward` below replays both walks,
every tile at once and the walked tiles in order, rounding where the
kernels round, and holds them:

  * to the port's plain version and to `jax.grad` of the JAX package's
    `attn_reference` at small shapes in every mode, with spans, GQA,
    Sq != Sk and a ring hop (1e-5);
  * at whisper-small's encoder shape (1 x 1500, 12:12 heads of 64, full)
    within fp32's 1e-4 limit, where plain TF32 (every lo term dropped),
    and the lo terms of dK's product alone, miss it;
  * and the register layout the kernels rely on, at the backward's
    walked tiles of 32 rows and the forward's of 64 keys: an
    accumulator used as a wgmma A operand as it lies meets the
    transposed walked tile's rows in the permuted order the kernels
    write them (kap), and their product is exact; the transposed stores
    hit every word of the tile once, a warp's 32 stores in 32 banks.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models.attention import attn_reference
from _split_tf32 import (as_tensor as _t, kap, scaled as _scaled,
                         seg as _seg, split_product, sw128 as _sw128,
                         tf32)
from repro_torch.kernels.flash_attention_packed import (
    _tables, flash_attention_packed_bwd_ref, flash_attention_packed_ref,
    pair_mask)

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

#: chip_smoke.py's fp32 gradient limit, max|err| / max(1, |plain|)
TOL_F32 = 1e-4
ROWS = 64      # the rows a warpgroup owns: keys (dK / dV), queries (dQ)
STEP = 32      # the rows of a walked tile
LOG2E = 1.4426950408889634
#: the backward's products, by what they form
PRODUCTS = ("s", "dp", "dv", "dk", "dq")


def _tiles(x, n):
    """[..., S, D] -> [..., ceil(S / n), n, D], the last tile zero-filled
    (rows past S read as zeros, as the kernels load them)."""
    S = x.shape[-2]
    pad = -S % n
    if pad:
        x = torch.cat([x, x.new_zeros(*x.shape[:-2], pad, x.shape[-1])], -2)
    return x.reshape(*x.shape[:-2], -1, n, x.shape[-1])


def split_tf32_backward(q, k, v, o, lse, do, segment_ids, *, mode="causal",
                        window=None, span_ids=None, kv_segment_ids=None,
                        kv_span_ids=None, kv_offset=0, lo=PRODUCTS):
    """(dq, dk, dv) as the two kernels form them, fp32: q, o, do [B, Sq,
    H, D], k, v [B, Sk, Hkv, D], lse [B, H, Sq]. `lo`: the products that
    keep their lo terms (the others run in plain TF32)."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(D)
    sl2 = scale * LOG2E
    tabs = _tables(q, k, segment_ids, span_ids, kv_segment_ids,
                   kv_span_ids)
    valid = pair_mask(Sq, Sk, *tabs, mode=mode, window=window,
                      kv_offset=kv_offset)                  # [B, Sq, Sk]
    lse2 = lse.float() * LOG2E                              # [B, H, Sq]
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)  # [B, H, Sq]
    live = valid[:, None] & torch.isfinite(lse2)[..., None]  # [B,H,Sq,Sk]
    qh, doh = (x.float().permute(0, 2, 1, 3) for x in (q, do))  # [B,H,S,D]
    kh, vh = (x.float().permute(0, 2, 1, 3) for x in (k, v))  # [B,Hkv,S,D]
    nq, nk = -(-Sq // STEP), -(-Sk // ROWS)

    def weights(s, dp, rows_live, lse_t, delta_t):
        p = torch.where(rows_live, torch.exp2(s * sl2 - lse_t.nan_to_num(
            neginf=0.0)), 0.0)
        return p, p * (dp - delta_t) * scale

    # dK / dV: each 64-key tile over the query tiles of 32 of every head
    # of its group, in order
    kt, vt = _tiles(kh, ROWS), _tiles(vh, ROWS)      # [B, Hkv, nk, 64, D]
    live_t = _tiles(live.transpose(-1, -2).float(), ROWS).bool()
    # live_t: [B, H, nk, 64 keys, Sq]
    dk = torch.zeros_like(kt)
    dv = torch.zeros_like(vt)
    for hh in range(G):
        heads = slice(hh, H, G)                       # head hk * G + hh
        for i in range(nq):
            q0, q1 = i * STEP, min((i + 1) * STEP, Sq)
            qs = _tiles(qh[:, heads, q0:q1], STEP)[:, :, None, 0]
            ds = _tiles(doh[:, heads, q0:q1], STEP)[:, :, None, 0]
            rows = torch.zeros(B, Hkv, nk, ROWS, STEP, dtype=torch.bool)
            rows[..., :q1 - q0] = live_t[:, heads, :, :, q0:q1]
            pad = STEP - (q1 - q0)
            lse_t = torch.nn.functional.pad(lse2[:, heads, q0:q1], (0, pad))
            del_t = torch.nn.functional.pad(delta[:, heads, q0:q1], (0, pad))
            s = split_product(kt, qs.transpose(-1, -2), "s" in lo)
            dp = split_product(vt, ds.transpose(-1, -2), "dp" in lo)
            p, dst = weights(s, dp, rows, lse_t[:, :, None, None],
                             del_t[:, :, None, None])
            dv = dv + split_product(p, ds, "dv" in lo)
            dk = dk + split_product(dst, qs, "dk" in lo)

    # dQ: each 64-query tile over the key tiles of 32, in order
    qt, dot = _tiles(qh, ROWS), _tiles(doh, ROWS)    # [B, H, nqr, 64, D]
    nqr = qt.shape[2]
    live_q = _tiles(live.float(), ROWS).bool()       # [B, H, nqr, 64, Sk]
    lse_q = _tiles(lse2[..., None], ROWS)[..., 0]    # [B, H, nqr, 64]
    del_q = _tiles(delta[..., None], ROWS)[..., 0]
    dq = torch.zeros_like(qt)
    kg, vg = (x.repeat_interleave(G, 1) for x in (kh, vh))   # [B, H, Sk, D]
    for j in range((Sk + STEP - 1) // STEP):
        j0, j1 = j * STEP, min((j + 1) * STEP, Sk)
        ks = _tiles(kg[:, :, j0:j1], STEP)[:, :, None, 0]
        vs = _tiles(vg[:, :, j0:j1], STEP)[:, :, None, 0]
        rows = torch.zeros(B, H, nqr, ROWS, STEP, dtype=torch.bool)
        rows[..., :j1 - j0] = live_q[..., j0:j1]
        s = split_product(qt, ks.transpose(-1, -2), "s" in lo)
        dp = split_product(dot, vs.transpose(-1, -2), "dp" in lo)
        _, dsq = weights(s, dp, rows, lse_q[..., None], del_q[..., None])
        dq = dq + split_product(dsq, ks, "dq" in lo)

    def untile(x, S):
        return x.reshape(*x.shape[:2], -1, D)[:, :, :S].permute(0, 2, 1, 3)
    return untile(dq, Sq), untile(dk, Sk), untile(dv, Sk)


def _inputs(B, Sq, Sk, H, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
                      (B, Sq, H, D))]


#: name -> (B, Sq, Sk, H, Hkv, mode, window, segments, span frame, ring
#: hop): full at Sq != Sk over a partial last tile (one segment a row,
#: as the cross-attention has), causal with spans and GQA over several
#: segments with tail padding, sliding with spans at a window longer
#: than a walked tile, full with spans at 4:1, and a ring hop (the
#: second half's queries over the first half's keys, their own tables,
#: kv_offset) whose rows partly see no key
CASES = {
    "full_sq_ne_sk": (2, 70, 150, 4, 4, "full", None, None, None, False),
    "causal_spans_gqa": (1, 150, 150, 4, 2, "causal", None, [60, 37, 40],
                         8, False),
    "sliding_spans": (2, 140, 140, 4, 4, "sliding", 40, [90, 33], 8,
                      False),
    "full_spans_gqa": (1, 100, 100, 4, 1, "full", None, [50, 30, 11], 8,
                       False),
    "ring_hop_gqa": (1, 160, 160, 4, 2, "causal", None, [70, 55, 30], 8,
                     True),
}
D = 64   # the head dim the kernels are built for


def _case(name):
    B, Sq, Sk, H, Hkv, mode, window, lens, frame, hop = CASES[name]
    q, k, v, do = _inputs(B, Sq, Sk, H, Hkv, D, 300 + len(name))
    kw = dict(mode=mode, window=window)
    seg = np.zeros((B, Sq), np.int32) if lens is None else \
        _seg(B, Sq, lens, frame)[0]
    span = None if lens is None else _seg(B, Sq, lens, frame)[1]
    if Sq != Sk:
        kw["kv_segment_ids"] = torch.zeros(B, Sk, dtype=torch.int32)
    if hop:
        half = Sq // 2
        kseg = seg[:, :half].copy()
        kseg[kseg < 0] = -2
        q, do = q[:, half:].contiguous(), do[:, half:].contiguous()
        k, v = k[:, :half].contiguous(), v[:, :half].contiguous()
        kw.update(kv_segment_ids=_t(kseg), kv_span_ids=_t(span[:, :half]),
                  kv_offset=-half)
        seg, span = seg[:, half:], span[:, half:]
    kw["span_ids"] = _t(span)
    return q, k, v, do, _t(seg), kw


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_walk_matches_plain_and_jax_grad(name):
    """The kernels' walks against the port's plain backward (every
    case), and against jax.grad of `attn_reference` for the output
    gradient dO (the cases without a ring hop's own key tables, which it
    does not take), 1e-5."""
    q, k, v, do, seg, kw = _case(name)
    o, lse = flash_attention_packed_ref(q, k, v, seg, **kw)
    got = split_tf32_backward(q, k, v, o, lse, do, seg, **kw)
    want = flash_attention_packed_bwd_ref(q, k, v, o, lse, do, seg, **kw)
    for g, w in zip(got, want):
        assert _scaled(g, w) <= 1e-5
    if kw.get("kv_offset"):
        # rows whose segment has no key in the hop: exact zeros
        none = ~torch.isfinite(lse).any(1)                   # [B, Sq]
        assert none.any() and (got[0][none] == 0).all()
        return
    jseg = None if CASES[name][7] is None else jnp.asarray(seg.numpy())
    jspan = None if kw["span_ids"] is None else \
        jnp.asarray(kw["span_ids"].numpy())
    jdo = jnp.asarray(do.numpy())

    def loss(a, b, c):
        out = attn_reference(a, b, c, mode=kw["mode"], window=kw["window"],
                             segment_ids=jseg, span_ids=jspan)
        return (out * jdo).sum()
    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)))
    for g, w in zip(got, want):
        assert _scaled(g, w) <= 1e-5


@pytest.fixture(scope="module")
def whisper_encoder():
    """whisper-small's encoder attention, 1 x 1500 frames, 12:12 heads of
    64, full: inputs, the plain forward's o and LSE, the plain
    backward."""
    q, k, v, do = _inputs(1, 1500, 1500, 12, 12, D, 90)
    seg = torch.zeros(1, 1500, dtype=torch.int32)
    o, lse = flash_attention_packed_ref(q, k, v, seg, mode="full")
    want = flash_attention_packed_bwd_ref(q, k, v, o, lse, do, seg,
                                          mode="full")
    return (q, k, v, o, lse, do, seg), want


def _err(args, want, lo):
    got = split_tf32_backward(*args, mode="full", lo=lo)
    return {n: _scaled(g, w) for n, g, w in zip(("dq", "dk", "dv"), got,
                                                 want)}


def test_split_walk_holds_the_limit_at_whisper_encoder(whisper_encoder):
    """At whisper-small's encoder shape the split walk lies far within
    1e-4 of the plain fp32 backward; the same walk in plain TF32 (every
    lo term dropped) lies beyond it."""
    args, want = whisper_encoder
    split = _err(args, want, PRODUCTS)
    plain = _err(args, want, ())
    print(f"split TF32 {split}, plain TF32 {plain}")
    assert max(split.values()) <= TOL_F32 / 10
    assert max(plain.values()) > TOL_F32


def test_dk_product_alone_in_plain_tf32_misses_the_limit(whisper_encoder):
    """dK += dS^T Q with its lo terms dropped and every other product
    split (the fault k1_fault_check.py plants as f32_lo_dropped) misses
    1e-4 in dk at whisper-small's encoder shape, and moves nothing
    else."""
    args, want = whisper_encoder
    err = _err(args, want, tuple(p for p in PRODUCTS if p != "dk"))
    print(f"dK's product in plain TF32: {err}")
    assert err["dk"] > TOL_F32
    assert err["dq"] <= TOL_F32 / 10 and err["dv"] <= TOL_F32 / 10


#: the rows of a walked tile: the backward's (32), the forward's (64 keys)
TILE_ROWS = (STEP, 64)


@pytest.mark.parametrize("rows", TILE_ROWS)
def test_accumulator_operand_meets_transposed_rows_in_kap_order(rows):
    """One warp's 16 rows of an accumulator over a walked tile of `rows`
    (P^T over 32 queries in the backward, P over 64 keys in the
    forward), as the kernels lay them out. The accumulator gives lane l
    = 4 g + t the values at rows g, g + 8 and columns 8 n + 2 t (+1); its
    A operand of k-step kk (split_acc) is {s[kk][0], s[kk][2], s[kk][1],
    s[kk][3]} at (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4);
    the transposed tile holds walked row r at column kap(r). The
    products over those operands are P^T dO (P V), to the bit."""
    rng = np.random.default_rng(6)
    P = rng.integers(-8, 8, (16, rows)).astype(np.float64)
    dO = rng.integers(-8, 8, (rows, D)).astype(np.float64)
    assert sorted(kap(r) for r in range(rows)) == list(range(rows))
    dOt = np.zeros((D, rows))
    for r in range(rows):
        dOt[:, kap(r)] = dO[r]
    out = np.zeros((16, D))
    for kk in range(rows // 8):
        A = np.zeros((16, 8))
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            s = [P[g + 8 * (e >> 1), 8 * kk + 2 * t + (e & 1)]
                 for e in range(4)]
            A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = (
                s[0], s[2], s[1], s[3])
        # B[k][n] = dO^T[n][8 kk + k]: K-major, k-step kk's 8 columns
        out += A @ dOt[:, 8 * kk:8 * kk + 8].T
    np.testing.assert_array_equal(out, P @ dO)


@pytest.mark.parametrize("rows", TILE_ROWS)
def test_transposed_stores_cover_the_tile_without_bank_conflicts(rows):
    """split_step's transposed stores: element (walked row r, column d) of
    a [rows][64] tile goes to sw128<64>(d, kap(r) / 4) + (kap(r) % 4) * 4
    of the [64][rows] tile: every word once; a warp (32 consecutive rows,
    one 16-byte column c, one of its 4 elements) in 32 banks. Its loads,
    16 bytes of 32 rows of the landed tile, cover 32 distinct chunks."""
    addr = {}
    for r in range(rows):
        for d in range(D):
            p = kap(r)
            addr[r, d] = _sw128(D, d, p >> 2) + (p & 3) * 4
    assert sorted(addr.values()) == list(range(0, rows * D * 4, 4))
    for first in range(0, rows, 32):
        warp = range(first, first + 32)
        for c in range(D // 4):
            assert len({_sw128(rows, r, c) for r in warp}) == 32
            for e in range(4):
                banks = {addr[r, 4 * c + e] // 4 % 32 for r in warp}
                assert len(banks) == 32
