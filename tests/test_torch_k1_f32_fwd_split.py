"""K1's fp32 forward as it runs at head_dim 64, replayed in torch ops on
the CPU.

`packed_fwd_f32_kernel` (`csrc/flash_attention_packed.cu`) forms both
products of the forward on the tensor cores in split TF32: each fp32
operand x as hi = tf32(x) (round to nearest, ties away from zero) and
lo = tf32(x - hi), each product as hi hi' + hi lo' + lo hi', summed in
fp32. A block's rows walk the live 64-key tiles in order: S = Q K^T,
the scores in log2 units (scale * log2(e)), the online softmax by exp2,
P split in registers, O rescaled and each tile's P V added into it, and
at the end o = O / l and the LSE in natural-log units, m ln 2 + log(l)
(-inf and zeros for a row with no valid key). A dead or wholly masked
tile adds exactly nothing, so `split_tf32_forward` below replays every row's walk over all key tiles
at once (every query row and head together, the key tiles in order) and
holds it:

  * to the port's plain version and to the JAX package's Pallas kernel
    (`flash_attention_packed_flat`, interpret mode) at small shapes in
    every mode, with spans, GQA at 4:2, Sq != Sk with kv_offset, a ring
    hop and rows without a valid key: o within 1e-4, the LSE within 1e-5
    of a float64 LSE;
  * at whisper-small's encoder shape (1 x 1500, 12:12 heads of 64, full)
    within fp32's 1e-4 limit, where the same walk in plain TF32 (every
    lo term zeroed: k1_fault_check.py's f32_fwd_lo_zeroed) misses it.

The layout the kernel relies on at its 64-key tiles (S's accumulator as
P's A operand meets V^T's keys in kap order; the transposed stores
without bank conflicts) is checked beside the backward's 32-row tiles in
tests/test_torch_k1_f32_split.py, as both kernels split their walked
tiles by the same helper.
"""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.flash_attention import flash_attention_packed_flat
from _split_tf32 import (as_tensor as _t, scaled as _scaled, seg as _seg,
                         split_product, tf32)
from repro_torch.kernels.flash_attention_packed import (
    _tables, flash_attention_packed_ref, pair_mask)

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

#: chip_smoke.py's fp32 limit, max|err| / max(1, |plain|)
TOL_F32 = 1e-4
#: the LSE against a float64 LSE, on rows with a valid key
TOL_LSE = 1e-5
KEYS = 64      # the keys of a tile
D = 64         # the head dim the kernel is built for
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def split_tf32_forward(q, k, v, segment_ids, *, mode="causal", window=None,
                       span_ids=None, kv_segment_ids=None, kv_span_ids=None,
                       kv_offset=0, lo=True):
    """(o [B, Sq, H, D], lse [B, H, Sq]) as the kernel forms them, fp32:
    q [B, Sq, H, D], k, v [B, Sk, Hkv, D] (query head h reads KV head
    h // (H // Hkv)). `lo=False`: both products in plain TF32."""
    B, Sq, H, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    tabs = _tables(q, k, segment_ids, span_ids, kv_segment_ids,
                   kv_span_ids)
    valid = pair_mask(Sq, Sk, *tabs, mode=mode, window=window,
                      kv_offset=kv_offset)[:, None]       # [B, 1, Sq, Sk]
    qh = q.float().permute(0, 2, 1, 3)                    # [B, H, Sq, D]
    kh, vh = (x.float().repeat_interleave(G, 2).permute(0, 2, 1, 3)
              for x in (k, v))                            # [B, H, Sk, D]
    # scale * log2(e) in fp32, as the kernel's sl2
    sl2 = torch.tensor(1.0 / math.sqrt(Dh), dtype=torch.float32) * \
        torch.tensor(LOG2E, dtype=torch.float32)
    m = torch.full((B, H, Sq, 1), -math.inf)
    l = torch.zeros(B, H, Sq, 1)
    acc = torch.zeros(B, H, Sq, Dh)
    for j0 in range(0, Sk, KEYS):
        j1 = min(j0 + KEYS, Sk)
        s = split_product(qh, kh[:, :, j0:j1].transpose(-1, -2), lo)
        s = torch.where(valid[..., j0:j1], s * sl2, -math.inf)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        mu = torch.where(m_new == -math.inf, 0.0, m_new)
        corr = torch.exp2(m - mu)
        p = torch.exp2(s - mu)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + split_product(p, vh[:, :, j0:j1], lo)
        m = m_new
    has = l > 0
    o = acc * torch.where(has, 1.0 / torch.where(has, l, 1.0), 0.0)
    lse = torch.where(has, m * torch.tensor(LN2, dtype=torch.float32)
                      + torch.log(torch.where(has, l, 1.0)), -math.inf)
    return o.permute(0, 2, 1, 3), lse[..., 0]


def lse_f64(q, k, segment_ids, *, mode="causal", window=None, span_ids=None,
            kv_segment_ids=None, kv_span_ids=None, kv_offset=0):
    """The LSE in float64 [B, H, Sq], -inf for a row with no valid key."""
    B, Sq, H, Dh = q.shape
    Sk, G = k.shape[1], H // k.shape[2]
    tabs = _tables(q, k, segment_ids, span_ids, kv_segment_ids,
                   kv_span_ids)
    valid = pair_mask(Sq, Sk, *tabs, mode=mode, window=window,
                      kv_offset=kv_offset)[:, None]
    s = torch.einsum("bshd,bthd->bhst", q.double(),
                     k.double().repeat_interleave(G, 2)) / math.sqrt(Dh)
    return torch.logsumexp(s.masked_fill(~valid, -math.inf), -1)


def _lse_err(got, want) -> float:
    """max |got - want| on rows with a valid key, after the rows without
    one (-inf) are found to agree."""
    fin = torch.isfinite(want)
    assert torch.equal(fin, torch.isfinite(got))
    return (got.double() - want)[fin].abs().max().item()


#: name -> (B, Sq, Sk, H, Hkv, mode, window, segments, span frame, key
#: side): full at Sq != Sk over a partial last tile (one segment a row,
#: as the cross-attention has); causal with spans and GQA over several
#: segments and tail padding (rows without keys); sliding with spans at
#: a window shorter than a tile; full with spans at 4:2; causal at Sq !=
#: Sk with the keys from 64 positions before the first query (kv_offset
#: -64); and a ring hop
#: (the second half's queries over the first half's keys, their own
#: tables, kv_offset) whose rows partly see no key
CASES = {
    "full_sq_ne_sk": (2, 70, 150, 4, 4, "full", None, None, None, None),
    "causal_spans_gqa": (1, 150, 150, 4, 2, "causal", None, [60, 37, 40], 8,
                         None),
    "sliding_spans": (2, 140, 140, 4, 4, "sliding", 40, [90, 33], 8, None),
    "full_spans_gqa": (1, 100, 100, 4, 2, "full", None, [50, 30, 11], 8,
                       None),
    "causal_sq_ne_sk_offset": (1, 100, 164, 4, 2, "causal", None, None,
                               None, "offset"),
    "ring_hop_gqa": (1, 160, 160, 4, 2, "causal", None, [70, 55, 30], 8,
                     "hop"),
}


def _case(name):
    """q, k, v, segment table and keyword arguments of a case (numpy
    seed, fp32)."""
    B, Sq, Sk, H, Hkv, mode, window, lens, frame, keys = CASES[name]
    rng = np.random.default_rng(500 + len(name))
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Sk, Hkv, D)).astype(np.float32)
            for _ in range(2))
    if lens is None:
        seg, span = np.zeros((B, Sq), np.int32), None
    else:
        seg, span = _seg(B, Sq, lens, frame)
    kw = dict(mode=mode, window=window)
    if keys == "offset":
        kw.update(kv_segment_ids=np.zeros((B, Sk), np.int32), kv_offset=-64)
    elif keys == "hop":
        half = Sq // 2
        kseg = seg[:, :half].copy()
        kseg[kseg < 0] = -2
        q, k, v = q[:, half:], k[:, :half], v[:, :half]
        kw.update(kv_segment_ids=kseg, kv_span_ids=span[:, :half],
                  kv_offset=-half)
        seg, span = seg[:, half:], span[:, half:]
    elif Sq != Sk:
        kw["kv_segment_ids"] = np.zeros((B, Sk), np.int32)
    kw["span_ids"] = span
    return q, k, v, seg, kw


def _pallas(q, k, v, seg, kw):
    """The JAX package's Pallas kernel (interpret mode), head by head in
    its flat layout [B * H, S, D] (GQA: each head's KV head repeated),
    back in the model layout [B, Sq, H, D]."""
    B, Sq, H, _ = q.shape
    G = H // k.shape[2]

    def flat(x):
        x = np.repeat(x, G, axis=2) if x.shape[2] != H else x
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(B * H, -1, D))

    def rows(t):
        return None if t is None else jnp.asarray(np.repeat(t, H, axis=0))
    out = flash_attention_packed_flat(
        flat(q), flat(k), flat(v), rows(seg),
        kv_segment_ids=rows(kw.get("kv_segment_ids")),
        span_ids=rows(kw.get("span_ids")),
        kv_span_ids=rows(kw.get("kv_span_ids")), mode=kw["mode"],
        window=kw["window"], kv_offset=kw.get("kv_offset", 0), block_q=32,
        block_k=32)
    return np.asarray(out).reshape(B, H, Sq, D).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_walk_matches_plain_pallas_and_f64_lse(name):
    """The kernel's walk against the port's plain forward (o, 1e-4; the
    rows without a valid key exact zeros with LSE -inf), the Pallas
    kernel on the rows with a key (o, 1e-4; it leaves a row without one
    at V's mean), and a float64 LSE (1e-5)."""
    q, k, v, seg, kw = _case(name)
    tkw = {n: _t(a) if isinstance(a, np.ndarray) else a
           for n, a in kw.items()}
    args = (_t(q), _t(k), _t(v), _t(seg))
    o, lse = split_tf32_forward(*args, **tkw)
    ro, rlse = flash_attention_packed_ref(*args, **tkw)
    assert _scaled(o, ro) <= TOL_F32
    assert _lse_err(lse, lse_f64(_t(q), _t(k), _t(seg), **tkw)) <= TOL_LSE
    keyless = ~torch.isfinite(rlse).any(1)                # [B, Sq]
    assert (o[keyless] == 0).all() and torch.isinf(lse.transpose(
        1, 2)[keyless]).all()
    if name in ("causal_spans_gqa", "ring_hop_gqa"):
        assert keyless.any()                  # the case has such rows
    want = _pallas(q, k, v, seg, kw)
    keyed = (~keyless).numpy()
    assert _scaled(o[keyed], want[keyed]) <= TOL_F32


@pytest.fixture(scope="module")
def whisper_encoder():
    """whisper-small's encoder attention, 1 x 1500 frames, its 12:12
    heads of 64, full: inputs (numpy seed 91), the plain forward, the
    float64 LSE."""
    rng = np.random.default_rng(91)
    q, k, v = (_t(rng.standard_normal((1, 1500, 12, D)).astype(np.float32))
               for _ in range(3))
    seg = torch.zeros(1, 1500, dtype=torch.int32)
    ro, _ = flash_attention_packed_ref(q, k, v, seg, mode="full")
    return (q, k, v, seg), ro, lse_f64(q, k, seg, mode="full")


def test_split_walk_holds_the_limit_at_whisper_encoder(whisper_encoder):
    """At whisper-small's encoder shape (all 12 heads) the split walk
    lies within 1e-4 of the plain fp32 forward (o) and 1e-5 of the
    float64 LSE; the same walk with every lo zeroed (plain TF32, the
    fault k1_fault_check.py plants as f32_fwd_lo_zeroed) misses 1e-4 in
    o."""
    args, ro, want_lse = whisper_encoder
    o, lse = split_tf32_forward(*args, mode="full")
    po, plse = split_tf32_forward(*args, mode="full", lo=False)
    split, plain = _scaled(o, ro), _scaled(po, ro)
    print(f"12:12 heads, 1 x 1500: split TF32 o {split:.3g} lse "
          f"{_lse_err(lse, want_lse):.3g}; plain TF32 o {plain:.3g} lse "
          f"{_lse_err(plse, want_lse):.3g}")
    assert split <= TOL_F32 / 10
    assert _lse_err(lse, want_lse) <= TOL_LSE
    assert plain > TOL_F32
