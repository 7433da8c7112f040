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


#: how fp32's backward kernels walk, by head dim: at 64 (wgmma) S and dP
#: are formed over all of D and each KV head's dK / dV is summed along
#: one walk over the group's heads; at 128 and 160 (mma.sync) S and dP
#: are two halves of D added, and each query head's dK / dV is walked on
#: its own and the group's heads summed after, in order
WALKS = {64: dict(halves=1, per_head=False),
         128: dict(halves=2, per_head=True),
         160: dict(halves=2, per_head=True)}


def split_tf32_backward(q, k, v, o, lse, do, segment_ids, *, mode="causal",
                        window=None, span_ids=None, kv_segment_ids=None,
                        kv_span_ids=None, kv_offset=0, lo=(PRODUCTS,),
                        rows=ROWS, step=STEP):
    """[(dq, dk, dv)] as the kernels at q's head dim (WALKS) form them,
    fp32, one for each entry of `lo`: the products that keep their lo
    terms (the others run in plain TF32). q, o, do [B, Sq, H, D], k, v
    [B, Sk, Hkv, D], lse [B, H, Sq]; `rows` the rows a block owns (keys
    for dK / dV, queries for dQ), `step` the rows of a walked tile. The
    entries share every product they form alike."""
    B, Sq, H, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    halves, per_head = WALKS[D]["halves"], WALKS[D]["per_head"]
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
    nq = -(-Sq // step)
    flags = [{p: p in one for p in PRODUCTS} for one in lo]
    cols = [slice(i * D // halves, (i + 1) * D // halves)
            for i in range(halves)]

    def first(a, w, use_lo):
        """a w^T over D, the halves' products added"""
        out = None
        for c in cols:
            part = split_product(a[..., c], w[..., c].transpose(-1, -2),
                                 use_lo)
            out = part if out is None else out + part
        return out

    def weights(s, dp, rows_live, lse_t, delta_t):
        p = torch.where(rows_live, torch.exp2(s * sl2 - lse_t.nan_to_num(
            neginf=0.0)), 0.0)
        return p, p * (dp - delta_t) * scale

    def once(memo, key, fn):
        if key not in memo:
            memo[key] = fn()
        return memo[key]

    # dK / dV: each `rows`-key tile over the query tiles of each head of
    # its group, in order
    kt, vt = _tiles(kh, rows), _tiles(vh, rows)      # [B, Hkv, nk, rows, D]
    nk = kt.shape[2]
    live_t = _tiles(live.transpose(-1, -2).float(), rows).bool()
    # live_t: [B, H, nk, rows keys, Sq]
    dk = [torch.zeros_like(kt) for _ in lo]
    dv = [torch.zeros_like(vt) for _ in lo]
    for hh in range(G):
        heads = slice(hh, H, G)                       # head hk * G + hh
        dkh = [torch.zeros_like(kt) for _ in lo] if per_head else dk
        dvh = [torch.zeros_like(vt) for _ in lo] if per_head else dv
        for i in range(nq):
            q0, q1 = i * step, min((i + 1) * step, Sq)
            qs = _tiles(qh[:, heads, q0:q1], step)[:, :, None, 0]
            ds = _tiles(doh[:, heads, q0:q1], step)[:, :, None, 0]
            rows_live = torch.zeros(B, Hkv, nk, rows, step,
                                    dtype=torch.bool)
            rows_live[..., :q1 - q0] = live_t[:, heads, :, :, q0:q1]
            pad = step - (q1 - q0)
            lse_t = torch.nn.functional.pad(lse2[:, heads, q0:q1], (0, pad))
            del_t = torch.nn.functional.pad(delta[:, heads, q0:q1], (0, pad))
            memo = {}
            for n, f in enumerate(flags):
                s = once(memo, ("s", f["s"]),
                         lambda: first(kt, qs, f["s"]))
                dp = once(memo, ("dp", f["dp"]),
                          lambda: first(vt, ds, f["dp"]))
                p, dst = once(memo, ("w", f["s"], f["dp"]), lambda: weights(
                    s, dp, rows_live, lse_t[:, :, None, None],
                    del_t[:, :, None, None]))
                dvh[n] = dvh[n] + once(
                    memo, ("dv", f["s"], f["dv"]),
                    lambda: split_product(p, ds, f["dv"]))
                dkh[n] = dkh[n] + once(
                    memo, ("dk", f["s"], f["dp"], f["dk"]),
                    lambda: split_product(dst, qs, f["dk"]))
        if per_head:
            # the group's heads summed in order after the walks
            for n in range(len(lo)):
                dk[n] = dkh[n] if hh == 0 else dk[n] + dkh[n]
                dv[n] = dvh[n] if hh == 0 else dv[n] + dvh[n]

    # dQ: each `rows`-query tile over the key tiles of `step`, in order
    qt, dot = _tiles(qh, rows), _tiles(doh, rows)    # [B, H, nqr, rows, D]
    nqr = qt.shape[2]
    live_q = _tiles(live.float(), rows).bool()       # [B, H, nqr, rows, Sk]
    lse_q = _tiles(lse2[..., None], rows)[..., 0]    # [B, H, nqr, rows]
    del_q = _tiles(delta[..., None], rows)[..., 0]
    dq = [torch.zeros_like(qt) for _ in lo]
    kg, vg = (x.repeat_interleave(G, 1) for x in (kh, vh))   # [B, H, Sk, D]
    for j in range((Sk + step - 1) // step):
        j0, j1 = j * step, min((j + 1) * step, Sk)
        ks = _tiles(kg[:, :, j0:j1], step)[:, :, None, 0]
        vs = _tiles(vg[:, :, j0:j1], step)[:, :, None, 0]
        rows_live = torch.zeros(B, H, nqr, rows, step, dtype=torch.bool)
        rows_live[..., :j1 - j0] = live_q[..., j0:j1]
        memo = {}
        for n, f in enumerate(flags):
            s = once(memo, ("s", f["s"]), lambda: first(qt, ks, f["s"]))
            dp = once(memo, ("dp", f["dp"]), lambda: first(dot, vs, f["dp"]))
            _, dsq = once(memo, ("w", f["s"], f["dp"]), lambda: weights(
                s, dp, rows_live, lse_q[..., None], del_q[..., None]))
            dq[n] = dq[n] + once(
                memo, ("dq", f["s"], f["dp"], f["dq"]),
                lambda: split_product(dsq, ks, f["dq"]))

    def untile(x, S):
        return x.reshape(*x.shape[:2], -1, D)[:, :, :S].permute(0, 2, 1, 3)
    return [(untile(a, Sq), untile(b, Sk), untile(c, Sk))
            for a, b, c in zip(dq, dk, dv)]


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
#: the head dims the fp32 backward kernels are built for: 64 (wgmma), 128
#: and 160 (mma.sync)
HEAD_DIMS = (64, 128, 160)


def _case(name, D):
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


@pytest.mark.parametrize("name,D", [
    pytest.param(name, D, id=name if D == 64 else f"{name}-D{D}")
    for D in HEAD_DIMS for name in sorted(CASES)])
def test_split_walk_matches_plain_and_jax_grad(name, D):
    """The kernels' walks at head_dim D against the port's plain backward
    (every case), and against jax.grad of `attn_reference` for the output
    gradient dO (the cases without a ring hop's own key tables, which it
    does not take), 1e-5."""
    q, k, v, do, seg, kw = _case(name, D)
    o, lse = flash_attention_packed_ref(q, k, v, seg, **kw)
    got, = split_tf32_backward(q, k, v, o, lse, do, seg, **kw)
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


#: the limit shapes: (B, S, H, Hkv, D, mode, seed), one segment a row;
#: whisper-small's encoder attention (1 x 1500 frames, 12:12 heads of 64,
#: full) and a causal row of 1024 at 4:2 heads of 128
LIMIT_SHAPES = {"whisper_encoder": (1, 1500, 12, 12, 64, "full", 90),
                "causal1024_d128": (1, 1024, 4, 2, 128, "causal", 90)}
#: what each limit shape's walk keeps its lo terms in: every product
#: (split TF32), none (plain TF32), every product but dK's
LIMIT_LO = (PRODUCTS, (), tuple(p for p in PRODUCTS if p != "dk"))


@pytest.fixture(scope="module", params=sorted(LIMIT_SHAPES))
def limit_walks(request):
    """A limit shape's inputs through the plain forward and backward and
    through the kernels' walk with the lo terms of LIMIT_LO, one walk
    forming what the three have in common once; torch on one thread
    (restored after): the suite's workers share the machine's cores, and
    a walk of many small products slows down most when every worker's
    threads contend for them. -> (shape name, {lo: (dq, dk, dv) errors
    against the plain backward})."""
    B, S, H, Hkv, D, mode, seed = LIMIT_SHAPES[request.param]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        q, k, v, do = _inputs(B, S, S, H, Hkv, D, seed)
        seg = torch.zeros(B, S, dtype=torch.int32)
        o, lse = flash_attention_packed_ref(q, k, v, seg, mode=mode)
        want = flash_attention_packed_bwd_ref(q, k, v, o, lse, do, seg,
                                              mode=mode)
        walks = split_tf32_backward(q, k, v, o, lse, do, seg, mode=mode,
                                    lo=LIMIT_LO)
    finally:
        torch.set_num_threads(n)
    return request.param, {
        lo: {n: _scaled(g, w) for n, g, w in zip(("dq", "dk", "dv"), got,
                                                   want)}
        for lo, got in zip(LIMIT_LO, walks)}


def test_split_walk_holds_the_limit_at_whisper_encoder(limit_walks):
    """At whisper-small's encoder shape (D = 64) and at a causal 1024 row
    of 4:2 heads of 128, the split walk lies far within 1e-4 of the
    plain fp32 backward; the same walk in plain TF32 (every lo term
    dropped) lies beyond it."""
    name, err = limit_walks
    split, plain = err[PRODUCTS], err[()]
    print(f"{name}: split TF32 {split}, plain TF32 {plain}")
    assert max(split.values()) <= TOL_F32 / 10
    assert max(plain.values()) > TOL_F32


def test_dk_product_alone_in_plain_tf32_misses_the_limit(limit_walks):
    """dK += dS^T Q with its lo terms dropped and every other product
    split (the fault k1_fault_check.py plants as f32_lo_dropped at D =
    64 and f32_mma_dk_lo_dropped at 128 / 160) misses 1e-4 in dk at both
    limit shapes, and moves nothing else."""
    name, err = limit_walks
    err = err[LIMIT_LO[2]]
    print(f"{name}: dK's product in plain TF32: {err}")
    assert err["dk"] > TOL_F32
    assert err["dq"] <= TOL_F32 / 10 and err["dv"] <= TOL_F32 / 10


#: the rows of a walked tile at D = 64 (wgmma): the backward's (32), the
#: forward's (64 keys)
TILE_ROWS = (STEP, 64)
#: the layouts each fp32 design relies on: (route, walked rows, head dim)
LAYOUTS = [pytest.param("wgmma", rows, 64, id=str(rows))
           for rows in TILE_ROWS] + [
    pytest.param("mma", STEP, D, id=f"mma-{D}") for D in (128, 160)]


def _fw(D, r, c):
    """`fw<D>(r, c)`: the word of (row r, column c) in a tile of rows of
    D words, columns XORed with 4 (r % 8) within their 32-word group."""
    return r * D + (c ^ ((r & 7) << 2))


def _mma(a, b):
    """One warp's mma.sync.m16n8k8 from its fragments: lane 4 g + t holds
    a[l] = A's (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) and b[l] =
    B's (t, g), (t + 4, g); returns each lane's (g, 2t), (g, 2t + 1),
    (g + 8, 2t), (g + 8, 2t + 1) of A B (float64)."""
    A, Bm = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a[lane]
        Bm[t, g], Bm[t + 4, g] = b[lane]
    C = A @ Bm
    return np.array([[C[lane >> 2, 2 * (lane & 3)],
                      C[lane >> 2, 2 * (lane & 3) + 1],
                      C[(lane >> 2) + 8, 2 * (lane & 3)],
                      C[(lane >> 2) + 8, 2 * (lane & 3) + 1]]
                     for lane in range(32)])


def _accumulator_product_mma(P, W, D):
    """acc += P W over a walked tile as second_product forms it: P [16 x
    rows] a warp's accumulator (lane g, t: rows g, g + 8, columns 8 n + 2t
    (+1)), its A operand of k-step kk {s[kk][0], s[kk][2], s[kk][1],
    s[kk][3]}, B read from the walked tile W ([rows][D], swizzled) at
    rows 8 kk + 2t and 8 kk + 2t + 1, column 8 nd + g."""
    rows = P.shape[1]
    flat = np.zeros(rows * D)
    for r in range(rows):
        for c in range(D):
            flat[_fw(D, r, c)] = W[r, c]
    out = np.zeros((16, D))
    for nd in range(D // 8):
        f = np.zeros((32, 4))
        for kk in range(rows // 8):
            a, b = [], []
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                s = [P[g + 8 * (e >> 1), 8 * kk + 2 * t + (e & 1)]
                     for e in range(4)]
                a.append((s[0], s[2], s[1], s[3]))
                b.append((flat[_fw(D, 8 * kk + 2 * t, 8 * nd + g)],
                          flat[_fw(D, 8 * kk + 2 * t + 1, 8 * nd + g)]))
            f += _mma(a, b)
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for e in range(4):
                out[g + 8 * (e >> 1), 8 * nd + 2 * t + (e & 1)] = f[lane, e]
    return out


@pytest.mark.parametrize("route,rows,D", LAYOUTS)
def test_accumulator_operand_meets_transposed_rows_in_kap_order(route, rows,
                                                                D):
    """One warp's 16 rows of an accumulator over a walked tile of `rows`
    (P^T over 32 queries in the backward, P over 64 keys in the forward),
    as the kernels lay them out. The accumulator gives lane l = 4 g + t
    the values at rows g, g + 8 and columns 8 n + 2 t (+1); its A operand
    of k-step kk (split_acc) is {s[kk][0], s[kk][2], s[kk][1], s[kk][3]}
    at (row g, k t), (g + 8, t), (g, t + 4), (g + 8, t + 4). wgmma (D =
    64): the transposed tile holds walked row r at column kap(r). mma.sync
    (D = 128, 160): B's (t, g) and (t + 4, g) are read from the walked
    tile's rows 8 kk + 2t and 8 kk + 2t + 1 as it lies (swizzled). The
    products over those operands are P^T dO (P V), to the bit."""
    rng = np.random.default_rng(6)
    P = rng.integers(-8, 8, (16, rows)).astype(np.float64)
    dO = rng.integers(-8, 8, (rows, D)).astype(np.float64)
    if route == "mma":
        np.testing.assert_array_equal(_accumulator_product_mma(P, dO, D),
                                      P @ dO)
        return
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


@pytest.mark.parametrize("route,rows,D", LAYOUTS)
def test_transposed_stores_cover_the_tile_without_bank_conflicts(route, rows,
                                                                 D):
    """wgmma (D = 64): split_step's transposed stores: element (walked row
    r, column d) of a [rows][64] tile goes to sw128<64>(d, kap(r) / 4) +
    (kap(r) % 4) * 4 of the [64][rows] tile: every word once; a warp (32
    consecutive rows, one 16-byte column c, one of its 4 elements) in 32
    banks. Its loads, 16 bytes of 32 rows of the landed tile, cover 32
    distinct chunks. mma.sync (D = 128, 160): the tiles are stored once,
    as they land, word c of row r at fw(r, c): every word once, each
    16-byte copy to 16 contiguous bytes; the fragment loads of the first
    products (rows 8 n + g, words 8 kk + t (+4) from either half's first
    column) and of the second (rows 8 kk + 2t (+1), word 8 nd + g) each
    in 32 banks."""
    if route == "mma":
        words = {(r, c): _fw(D, r, c) for r in range(rows) for c in range(D)}
        assert sorted(words.values()) == list(range(rows * D))
        for r in range(rows):
            for c4 in range(D // 4):
                at = [words[r, 4 * c4 + e] for e in range(4)]
                assert at[0] % 4 == 0 and at == list(range(at[0], at[0] + 4))
        for c0 in (0, D // 2):
            for kk in range(D // 16):
                for n in range(rows // 8):
                    for plus in (0, 4):
                        banks = {words[8 * n + (lane >> 2),
                                       c0 + 8 * kk + (lane & 3) + plus] % 32
                                 for lane in range(32)}
                        assert len(banks) == 32, (c0, kk, n, plus)
            for nd in range(D // 16):
                for kk in range(rows // 8):
                    for e in (0, 1):
                        banks = {words[8 * kk + 2 * (lane & 3) + e,
                                       c0 + 8 * nd + (lane >> 2)] % 32
                                 for lane in range(32)}
                        assert len(banks) == 32, (c0, nd, kk, e)
        return
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


@pytest.mark.parametrize("D", (128, 160))
def test_mma_first_products_split_at_load_match_split_product(D):
    """One warp's first products as first_products and add_halves form
    them at head_dim D: A's rows g, g + 8 and B's rows 8 n + g read from
    the swizzled tiles at words 8 kk + t (+4) of each half of D, every
    word split as it loads (hi = tf32(x), lo = tf32(x - hi)), lo hi' + hi
    lo' + hi hi' per k-step, the halves' partials added: equal to
    split_product over the two halves (float64 sums of the same TF32
    products), and within 2^-21 relative of the exact product."""
    rng = np.random.default_rng(7)
    F = rng.standard_normal((16, D)).astype(np.float32)
    W = rng.standard_normal((STEP, D)).astype(np.float32)
    hi = {n: tf32(torch.from_numpy(x)).numpy() for n, x in (("F", F),
                                                            ("W", W))}
    lo = {n: tf32(torch.from_numpy(x - hi[n])).numpy() for n, x in (
        ("F", F), ("W", W))}
    fl = {}
    for n, x in (("F", F), ("W", W)):
        for part, y in (("hi", hi[n]), ("lo", lo[n])):
            flat = np.zeros(x.shape[0] * D)
            for r in range(x.shape[0]):
                for c in range(D):
                    flat[_fw(D, r, c)] = y[r, c]
            fl[n, part] = flat
    out = np.zeros((16, STEP))
    for c0 in (0, D // 2):
        part = np.zeros((32, STEP // 8, 4))
        for kk in range(D // 16):
            def frag_a(which, lane):
                g, t = lane >> 2, lane & 3
                c = c0 + 8 * kk + t
                return tuple(fl["F", which][_fw(D, r, cc)] for r, cc in (
                    (g, c), (g + 8, c), (g, c + 4), (g + 8, c + 4)))
            for n in range(STEP // 8):
                def frag_b(which, lane):
                    g, t = lane >> 2, lane & 3
                    c = c0 + 8 * kk + t
                    return (fl["W", which][_fw(D, 8 * n + g, c)],
                            fl["W", which][_fw(D, 8 * n + g, c + 4)])
                for wa, wb in (("lo", "hi"), ("hi", "lo"), ("hi", "hi")):
                    part[:, n] += _mma([frag_a(wa, ln) for ln in range(32)],
                                       [frag_b(wb, ln) for ln in range(32)])
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            for n in range(STEP // 8):
                for e in range(4):
                    out[g + 8 * (e >> 1), 8 * n + 2 * t + (e & 1)] += \
                        part[lane, n, e]
    h64 = {n: x.astype(np.float64) for n, x in hi.items()}
    l64 = {n: x.astype(np.float64) for n, x in lo.items()}
    want = sum(l64["F"][:, c] @ h64["W"][:, c].T + h64["F"][:, c]
               @ l64["W"][:, c].T + h64["F"][:, c] @ h64["W"][:, c].T
               for c in (slice(0, D // 2), slice(D // 2, D)))
    np.testing.assert_allclose(out, want, rtol=0, atol=1e-12)
    # the replay's split_product (fp32 sums) agrees to fp32 rounding
    size = (np.abs(F).astype(np.float64) @ np.abs(W.T)).max()
    got = sum(split_product(torch.from_numpy(F[:, c]),
                            torch.from_numpy(W[:, c].T.copy()))
              for c in (slice(0, D // 2), slice(D // 2, D))).numpy()
    assert np.abs(got - want).max() <= 2.0 ** -20 * size
    exact = F.astype(np.float64) @ W.T.astype(np.float64)
    assert np.abs(out - exact).max() <= 2.0 ** -21 * size
