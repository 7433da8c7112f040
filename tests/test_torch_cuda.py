"""The CUDA kernels against their plain versions on the card.

Marked `cuda`: they skip without an NVIDIA GPU (and need nvcc to build
the kernels). This file imports no JAX, so it runs on a machine with
only the port's requirements:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -m cuda
"""
import functools
import importlib

import numpy as np
import pytest
import torch

import _ring_faults as hop_faults
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)

#: each output element lies within TOL * max(1, |plain|) of the plain
#: version's. bf16: the two round at different points, and one bf16 step
#: is up to 2^-7 of |o|; fp32: sums are taken in a different order
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: gradients of the packed kernel: in bf16 the backward rounds P and dS
#: to bf16 before their products and forms delta = rowsum(dO * O) from
#: the bf16 output, where dP - delta can cancel, so dq/dk/dv sit a few
#: bf16 steps from the fp32-computed plain gradient (measured up to
#: 0.021 on an H100 at S=230, D=128)
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-2}
#: bf16 K1 outputs and gradients are also held as whole tensors,
#: max|err| <= REL_TOL_BF16 * max|plain|: the elementwise limit above is
#: about as large as a typical gradient element (see chip_smoke.py)
REL_TOL_BF16 = 2e-2
CASES = [("causal", None, 0), ("full", None, 0), ("sliding", 64, 0),
         ("causal", None, 50), ("causal", None, -30)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,D", [(2, 200, 200, 64),
                                       (2, 200, 200, 128),
                                       (1, 77, 150, 32),
                                       (3, 1, 1, 128)])
def test_flash_attention_kernel_matches_plain(card, dtype, B, Sq, Sk, D):
    rng = np.random.default_rng(0)
    q, k, v = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(card, dtype)
               for s in ((B, Sq, 12, D), (B, Sk, 2, D), (B, Sk, 2, D))]
    before = flash_attention.launches
    for mode, window, off in CASES:
        out = flash_attention(q, k, v, mode=mode, window=window,
                              kv_offset=off)
        ref = flash_attention_ref(q, k, v, mode=mode, window=window,
                                  kv_offset=off)
        torch.cuda.synchronize()
        ref = ref.float()
        err = ((out.float() - ref).abs() / ref.abs().clamp_min(1.0)).max()
        assert err.item() <= TOL[dtype], (mode, off, err.item())
    assert flash_attention.launches == before + len(CASES)


# The bf16 kernel (D = 32, 64, 128): two warpgroups over 128 query rows
# of one (head, batch), every product by wgmma, a ring of K/V tiles, the
# live key range by arithmetic and an unmasked path
def _k2_close(card, tag, B, Sq, Sk, H, Hkv, D, seed,
              dtype=torch.bfloat16, **kw):
    """K2 (bf16 by default) on random inputs vs its plain version (phase
    3's elementwise limit); returns (kernel output, plain output)."""
    rng = np.random.default_rng(seed)
    q, k, v = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(card, dtype)
               for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]
    before = flash_attention.launches
    out = flash_attention(q, k, v, **kw)
    ref = flash_attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    diff = (out.float() - ref.float()).abs()
    err = (diff / ref.float().abs().clamp_min(1.0)).max().item()
    print(f"K2 {tag} {kw}: elementwise {err:.4g}")
    assert err <= TOL[dtype], (tag, kw, err)
    return out, ref


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(CASES)))
def test_k2_long_rows(card, case):
    """4 rows of 2048 at internvl3-2b's 12:2 heads of 128: 32 key tiles a
    row through the ring, most on the unmasked path; the library records
    the launch: (H, ceil(Sq / 128), B) blocks of 256 threads."""
    from repro_torch.kernels.flash_attention import last_launch
    mode, window, off = CASES[case]
    _k2_close(card, "4x2048", 4, 2048, 2048, 12, 2, 128, 50 + case,
              mode=mode, window=window, kv_offset=off)
    launch = last_launch()
    assert launch["grid"] == (12, 2048 // 128, 4), launch
    assert launch["threads"] == 256, launch


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("Hkv", [1, 2, 12])
def test_k2_kv_heads(card, Hkv, D):
    """12 query heads over 1 (MQA), 2 or 12 KV heads, every mode and
    kv_offset of CASES, a partial last query tile and key tile."""
    for mode, window, off in CASES:
        _k2_close(card, f"Hkv={Hkv} D={D}", 2, 300, 300, 12, Hkv, D,
                  60 + Hkv, mode=mode, window=window, kv_offset=off)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [32, 64, 128])
def test_k2_more_keys_than_queries(card, D):
    """Sk > Sq with positive kv_offset (keys start after some queries, so
    the first rows see none) and with the queries at the end of the keys
    (a chunk after a cache), causal and sliding."""
    for mode, window in (("causal", None), ("sliding", 100)):
        for off in (40, -320):
            _k2_close(card, f"Sk>Sq D={D}", 2, 200, 520, 12, 2, D, 70,
                      mode=mode, window=window, kv_offset=off)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [16, 64, 200])
def test_k2_sliding_windows(card, window):
    """Windows below, at and above a key tile, each with and without an
    offset: the unmasked path must stop at the window's edge."""
    for off in (0, -30, 50):
        _k2_close(card, f"window {window}", 2, 700, 700, 12, 2, 128, 80,
                  mode="sliding", window=window, kv_offset=off)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,window", [("causal", None),
                                         ("sliding", 64)])
def test_k2_rows_without_keys_are_zero(card, mode, window):
    """kv_offset 150: queries 0-149 see no key and come out exactly 0
    (the documented deviation from the Pallas kernel); the rest match."""
    out, _ = _k2_close(card, "no keys", 2, 300, 300, 12, 2, 128, 90,
                       mode=mode, window=window, kv_offset=150)
    assert (out[:, :150] == 0).all()
    assert out[:, 150:].abs().amax(dim=(0, 2, 3)).min() > 0


@pytest.mark.cuda
def test_k2_is_deterministic(card):
    """Each row's sums run in one fixed order: two calls give the same
    bits."""
    for B, S, mode, window in ((4, 256, "causal", None),
                               (2, 700, "sliding", 64)):
        rng = np.random.default_rng(95)
        q, k, v = [torch.from_numpy(rng.standard_normal(s)
                                    .astype(np.float32))
                   .to(card, torch.bfloat16)
                   for s in ((B, S, 12, 128), (B, S, 2, 128),
                             (B, S, 2, 128))]
        a = flash_attention(q, k, v, mode=mode, window=window)
        b = flash_attention(q, k, v, mode=mode, window=window)
        assert torch.equal(a, b), (B, S, mode)


# K2 at head_dim 160 (pixtral-12b, 32:8, bf16 only): tiles of 192
# columns in shared memory, the upper 32 zero-filled, O's third block by
# its own m64n64 product
@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(CASES)))
def test_k2_head_dim_160(card, case):
    """4 rows of 2048 at 32:8 heads of 160 (the co-batched prefill's
    largest shape), every mode and offset of CASES, then exact lengths
    (one row, causal) as the exact-length prefill runs them; one block
    an SM of shared memory."""
    from repro_torch.kernels.flash_attention import last_launch
    mode, window, off = CASES[case]
    _k2_close(card, "4x2048 D=160", 4, 2048, 2048, 32, 8, 160, 100 + case,
              mode=mode, window=window, kv_offset=off)
    launch = last_launch()
    assert launch["grid"] == (32, 2048 // 128, 4), launch
    assert launch["smem_bytes"] > 232448 // 2, launch
    if case == 0:
        for L in (1, 96, 200, 1500):
            _k2_close(card, f"1x{L} D=160", 1, L, L, 32, 8, 160, L,
                      mode="causal")


@pytest.mark.cuda
@pytest.mark.parametrize("mode,window", [("causal", None),
                                         ("sliding", 64)])
def test_k2_head_dim_160_rows_without_keys_are_zero(card, mode, window):
    """As test_k2_rows_without_keys_are_zero at 32:8 heads of 160."""
    out, _ = _k2_close(card, "no keys D=160", 2, 300, 300, 32, 8, 160, 91,
                       mode=mode, window=window, kv_offset=150)
    assert (out[:, :150] == 0).all()
    assert out[:, 150:].abs().amax(dim=(0, 2, 3)).min() > 0


@pytest.mark.cuda
def test_k2_head_dim_160_refuses_fp32(card):
    q = torch.zeros(1, 64, 32, 160, device=card)
    k = torch.zeros(1, 64, 8, 160, device=card)
    with pytest.raises(ValueError, match="bfloat16 only"):
        flash_attention(q, k, k)


# ------------------------------------------------- packed attention (K1)
def _packed_tables(B, S, lens, with_spans, frame=8):
    """Segments of `lens` tokens then tail padding (-1); with spans,
    bidirectional frames of `frame` tokens after every text block of
    `frame // 2` tokens (ids unique per row, -1 elsewhere)."""
    seg = np.full((B, S), -1, np.int32)
    span = np.full((B, S), -1, np.int32)
    for b in range(B):
        off, sid = 0, 0
        for i, L in enumerate(lens):
            seg[b, off:off + L] = i
            p = frame // 2
            while with_spans and p < L:
                f = min(frame, L - p)
                span[b, off + p:off + p + f] = sid
                sid += 1
                p += f + frame // 2
            off += L
    return seg, (span if with_spans else None)


K1_CASES = [  # mode, window, spans, kv_offset, Sk - Sq
    ("causal", None, False, 0, 0), ("causal", None, True, 0, 0),
    ("full", None, False, 0, 0), ("full", None, True, 0, 0),
    ("sliding", 24, False, 0, 0), ("sliding", 24, True, 0, 0),
    ("causal", None, True, -40, 40),   # a ring hop: kv tables + offset
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 160])
def test_packed_kernel_forward_and_backward_match_plain(card, dtype, D):
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed, flash_attention_packed_bwd,
        flash_attention_packed_bwd_ref, flash_attention_packed_ref)
    rng = np.random.default_rng(1)
    B, Sq, H, Hkv = 2, 230, 12, 2
    lens = [37, 90, 1, 70]
    n_fwd = flash_attention_packed.launches
    n_bwd = flash_attention_packed_bwd.launches
    for mode, window, spans, off, extra in K1_CASES:
        Sk = Sq + extra
        seg, span = _packed_tables(B, Sq, lens, spans)
        kw = dict(mode=mode, window=window, kv_offset=off)
        if spans:
            kw["span_ids"] = torch.from_numpy(span).to(card)
        if extra:
            kseg, kspan = _packed_tables(B, Sk, [40] + lens, spans)
            kseg = np.where(kseg >= 0, kseg - 1, -2).astype(np.int32)
            kw["kv_segment_ids"] = torch.from_numpy(kseg).to(card)
            if spans:
                kw["kv_span_ids"] = torch.from_numpy(kspan).to(card)
        q, do = [torch.from_numpy(rng.standard_normal((B, Sq, H, D))
                                  .astype(np.float32)).to(card, dtype)
                 for _ in range(2)]
        k, v = [torch.from_numpy(rng.standard_normal((B, Sk, Hkv, D))
                                 .astype(np.float32)).to(card, dtype)
                for _ in range(2)]
        segt = torch.from_numpy(seg).to(card)
        o, lse = flash_attention_packed(q, k, v, segt, return_lse=True,
                                        **kw)
        ro, rlse = flash_attention_packed_ref(q, k, v, segt, **kw)
        grads = flash_attention_packed_bwd(q, k, v, o, lse, do, segt, **kw)
        refs = flash_attention_packed_bwd_ref(q, k, v, ro, rlse, do, segt,
                                              **kw)
        torch.cuda.synchronize()
        for name, a, r in [("o", o, ro), ("dq", grads[0], refs[0]),
                           ("dk", grads[1], refs[1]),
                           ("dv", grads[2], refs[2])]:
            r = r.float()
            diff = (a.float() - r).abs()
            err = (diff / r.abs().clamp_min(1.0)).max()
            tol = TOL[dtype] if name == "o" else GRAD_TOL[dtype]
            assert err.item() <= tol, (mode, spans, off, name, err.item())
            if dtype == torch.bfloat16:
                rel = diff.max() / r.abs().max()
                assert rel.item() <= REL_TOL_BF16, (mode, spans, off, name,
                                                    rel.item())
        fin = torch.isfinite(rlse)
        assert torch.equal(fin, torch.isfinite(lse))
        assert (lse[fin] - rlse[fin]).abs().max().item() <= 1e-3
    assert flash_attention_packed.launches == n_fwd + len(K1_CASES)
    assert flash_attention_packed_bwd.launches == n_bwd + len(K1_CASES)


# The bf16 backward (every head dim): one block per (query head, 64-key
# tile), each head's dK / dV summed over its KV head's group after the
# kernel, dQ added with 16-byte vector atomics
#: query and KV heads by head_dim: internvl3-2b's 12:2 at 64 / 128,
#: pixtral-12b's 32:8 at 160, recurrentgemma-2b's 10:1 (MQA) at 256
K1_HEADS = {64: (12, 2), 128: (12, 2), 160: (32, 8), 256: (10, 1)}


def _k1_bf16(card, rng, B, Sq, Sk, H, Hkv, D):
    q, do = [torch.from_numpy(rng.standard_normal((B, Sq, H, D))
                              .astype(np.float32)).to(card, torch.bfloat16)
             for _ in range(2)]
    k, v = [torch.from_numpy(rng.standard_normal((B, Sk, Hkv, D))
                             .astype(np.float32)).to(card, torch.bfloat16)
            for _ in range(2)]
    return q, k, v, do


def _k1_grads(card, q, k, v, do, seg, **kw):
    """(kernel (dq, dk, dv), plain (dq, dk, dv)); the kernel's forward o
    and lse come from the kernel, as on the training path, the plain
    backward's from the plain forward."""
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed, flash_attention_packed_bwd,
        flash_attention_packed_bwd_ref, flash_attention_packed_ref)
    segt = torch.as_tensor(seg, device=card)
    o, lse = flash_attention_packed(q, k, v, segt, return_lse=True, **kw)
    got = flash_attention_packed_bwd(q, k, v, o, lse, do, segt, **kw)
    ro, rlse = flash_attention_packed_ref(q, k, v, segt, **kw)
    want = flash_attention_packed_bwd_ref(q, k, v, ro, rlse, do, segt, **kw)
    torch.cuda.synchronize()
    return got, want, (o, lse, segt)


def _k1_close(tag, got, want):
    """The other K1 checks' limits: GRAD_TOL elementwise, REL_TOL_BF16
    as whole tensors."""
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        r = r.float()
        diff = (a.float() - r).abs()
        err = (diff / r.abs().clamp_min(1.0)).max().item()
        rel = diff.max().item() / r.abs().max().item()
        print(f"K1 bwd {tag} {name}: elementwise {err:.4g} whole {rel:.4g}")
        assert err <= GRAD_TOL[torch.bfloat16], (tag, name, err)
        assert rel <= REL_TOL_BF16, (tag, name, rel)


def _frames(S, frame=256, text=32):
    """One segment of S tokens with `frame`-token bidirectional spans
    after every `text` causal tokens, as an openvid row packs."""
    span = np.full(S, -1, np.int32)
    p, sid = text, 0
    while p < S:
        span[p:p + frame] = sid
        sid, p = sid + 1, p + frame + text
    return np.zeros(S, np.int32), span


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 160, 256])
def test_packed_backward_at_the_training_shape(card, D):
    """The training path's shape: one 4096-token row with 256-token
    frames; at D = 64 / 128 12 query heads over 2 KV heads, causal
    (internvl3-2b's heads at 128), at D = 160 pixtral-12b's 32 over 8,
    causal, at D = 256 recurrentgemma-2b's 10
    over one KV head, sliding at its window of 2048. Most tiles take the
    unmasked path; the launch count moves once per call, and the library
    records a launch of one block per (query head, 64-key tile) with
    each head's fp32 dK / dV as scratch."""
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed_bwd, last_bwd_kv_launch)
    rng = np.random.default_rng(30)
    H, Hkv = K1_HEADS[D]
    q, k, v, do = _k1_bf16(card, rng, 1, 4096, 4096, H, Hkv, D)
    seg, span = _frames(4096)
    kw = dict(mode="sliding", window=2048) if D == 256 else {}
    n_bwd = flash_attention_packed_bwd.launches
    got, want, _ = _k1_grads(card, q, k, v, do, seg,
                             span_ids=torch.from_numpy(span).to(card), **kw)
    _k1_close(f"4096 D={D}", got, want)
    assert flash_attention_packed_bwd.launches == n_bwd + 1
    launch = last_bwd_kv_launch()
    assert launch["grid"] == (H, 4096 // 64, 1), launch
    assert launch["work_bytes"] == 2 * 4096 * H * D * 4, launch


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 160, 256])
@pytest.mark.parametrize("mode,window,spans", [("causal", None, True),
                                               ("full", None, False),
                                               ("sliding", 100, True)])
def test_packed_backward_one_query_head_per_kv_head(card, D, mode, window,
                                                    spans):
    """H == Hkv: each block writes bf16 dK / dV itself and the reduction
    is skipped. Segments long enough for whole 64-row tiles in one
    segment (the unmasked path) beside ragged ones."""
    from repro_torch.kernels.flash_attention_packed import last_bwd_kv_launch
    rng = np.random.default_rng(31)
    B, S, H = 2, 700, 4
    seg, span = _packed_tables(B, S, [300, 37, 250, 1], spans, frame=40)
    q, k, v, do = _k1_bf16(card, rng, B, S, S, H, H, D)
    kw = dict(mode=mode, window=window)
    if spans:
        kw["span_ids"] = torch.from_numpy(span).to(card)
    got, want, _ = _k1_grads(card, q, k, v, do, seg, **kw)
    _k1_close(f"G=1 D={D} {mode}", got, want)
    assert last_bwd_kv_launch()["work_bytes"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 160, 256])
def test_packed_backward_rows_without_keys_are_zero(card, D):
    """A ring hop whose keys hold no token of some query segments (their
    rows have LSE -inf) and padding on both sides: those rows of dq, and
    the rows of dk / dv no query sees, are exactly 0; the rest match
    the plain version."""
    rng = np.random.default_rng(32)
    (B, Sq, Sk), (H, Hkv) = (1, 300, 200), K1_HEADS[D]
    seg = np.full((B, Sq), -1, np.int32)
    seg[0, :120], seg[0, 120:250] = 0, 1          # segment 1: no keys
    kseg = np.full((B, Sk), -2, np.int32)
    kseg[0, :150] = 0                             # kv padding after 150
    q, k, v, do = _k1_bf16(card, rng, B, Sq, Sk, H, Hkv, D)
    kw = dict(kv_segment_ids=torch.from_numpy(kseg).to(card),
              kv_offset=-Sk)
    got, want, (_, lse, _) = _k1_grads(card, q, k, v, do, seg, **kw)
    _k1_close(f"no keys D={D}", got, want)
    assert torch.isinf(lse[0, :, 120:]).all()
    assert torch.isfinite(lse[0, :, :120]).all()
    assert (got[0][0, 120:] == 0).all()
    assert (got[1][0, 150:] == 0).all() and (got[2][0, 150:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 160, 256])
def test_packed_backward_dk_dv_are_deterministic(card, D):
    """dK and dV are written once per (query head, key) and summed over
    the group in a fixed order: two calls give the same bits. (dQ is
    added with atomics in an order that varies, so it is not.) At D =
    256 over recurrentgemma-2b's ten query heads of one KV head, at D =
    160 over pixtral-12b's groups of four."""
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed_bwd)
    rng = np.random.default_rng(33)
    B, S = 2, 1024
    seg, span = _packed_tables(B, S, [600, 300, 100], True, frame=64)
    q, k, v, do = _k1_bf16(card, rng, B, S, S, *K1_HEADS[D], D)
    kw = dict(span_ids=torch.from_numpy(span).to(card))
    got, want, (o, lse, segt) = _k1_grads(card, q, k, v, do, seg, **kw)
    _k1_close(f"determinism D={D}", got, want)
    n_bwd = flash_attention_packed_bwd.launches
    again = flash_attention_packed_bwd(q, k, v, o, lse, do, segt, **kw)
    assert flash_attention_packed_bwd.launches == n_bwd + 1
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])


# The bf16 forward (every head dim): two warpgroups over 128 query rows,
# every product by wgmma, a ring of K/V tiles
def _k1_forward(card, q, k, v, seg, **kw):
    """(kernel (o, lse), plain (o, lse)), the kernel's launch counted."""
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed, flash_attention_packed_ref)
    segt = torch.as_tensor(seg, device=card)
    n_fwd = flash_attention_packed.launches
    got = flash_attention_packed(q, k, v, segt, return_lse=True, **kw)
    want = flash_attention_packed_ref(q, k, v, segt, **kw)
    torch.cuda.synchronize()
    assert flash_attention_packed.launches == n_fwd + 1
    return got, want


def _k1_fwd_close(tag, got, want):
    """Phase 7's limits: o within TOL elementwise and REL_TOL_BF16 as a
    whole, the LSE within 1e-3 on rows with keys, -inf on the others."""
    (o, lse), (ro, rlse) = got, want
    ro = ro.float()
    diff = (o.float() - ro).abs()
    err = (diff / ro.abs().clamp_min(1.0)).max().item()
    rel = diff.max().item() / ro.abs().max().item()
    fin = torch.isfinite(rlse)
    lse_err = (lse[fin] - rlse[fin]).abs().max().item()
    print(f"K1 fwd {tag}: o elementwise {err:.4g} whole {rel:.4g}, "
          f"lse {lse_err:.3g}")
    assert err <= TOL[torch.bfloat16], (tag, err)
    assert rel <= REL_TOL_BF16, (tag, rel)
    assert torch.equal(fin, torch.isfinite(lse)), tag
    assert lse_err <= 1e-3, (tag, lse_err)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 160, 256])
def test_packed_forward_at_the_training_shape(card, D):
    """The training path's row: one 4096-token row with 256-token
    frames; at D = 64 / 128 12 query heads over 2 KV heads, causal
    (internvl3-2b's heads at 128), at D = 160 pixtral-12b's 32 over 8,
    causal, at D = 256 recurrentgemma-2b's 10
    over one KV head, sliding at its window of 2048. Most key tiles take
    the unmasked path. The library records the launch: two warpgroups a
    block over 128 rows of one query head."""
    from repro_torch.kernels.flash_attention_packed import last_fwd_launch
    rng = np.random.default_rng(40)
    H, Hkv = K1_HEADS[D]
    q, k, v, _ = _k1_bf16(card, rng, 1, 4096, 4096, H, Hkv, D)
    seg, span = _frames(4096)
    kw = dict(mode="sliding", window=2048) if D == 256 else {}
    got, want = _k1_forward(card, q, k, v, seg,
                            span_ids=torch.from_numpy(span).to(card), **kw)
    _k1_fwd_close(f"4096 D={D}", got, want)
    launch = last_fwd_launch()
    assert launch["grid"] == (H, 4096 // 128, 1), launch
    assert launch["threads"] == 256, launch


K1_FWD_CASES = [  # mode, window, spans, H == Hkv, ring hop
    ("causal", None, True, False, False), ("causal", None, False, True,
                                           False),
    ("full", None, False, False, False), ("full", None, True, True, False),
    ("sliding", 100, True, False, False), ("sliding", 100, False, True,
                                           False),
    ("causal", None, True, False, True), ("sliding", 100, False, False,
                                          True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 160, 256])
@pytest.mark.parametrize("case", range(len(K1_FWD_CASES)))
def test_packed_forward_modes(card, D, case):
    """Every mode, with and without spans, over segments long enough for
    whole 64-key tiles in one segment (the unmasked path) beside ragged
    ones and a partial last query tile; the head dim's model's heads
    (12:2, at D = 256 10:1) and H == Hkv; a ring hop: the buffer's last 400 queries against its first 400 keys, which
    bring their own tables, at kv_offset -400."""
    mode, window, spans, mha, hop = K1_FWD_CASES[case]
    rng = np.random.default_rng(41 + case)
    B, Sq = 2, 700
    H, Hkv = (4, 4) if mha else K1_HEADS[D]
    seg, span = _packed_tables(B, Sq, [300, 37, 250, 1], spans, frame=40)
    kw = dict(mode=mode, window=window)
    Sk = Sq
    if hop:
        Sk = 400
        kseg = np.where(seg[:, :Sk] >= 0, seg[:, :Sk], -2).astype(np.int32)
        kw.update(kv_offset=-Sk,
                  kv_segment_ids=torch.from_numpy(kseg).to(card))
        if spans:
            kw["kv_span_ids"] = torch.from_numpy(span[:, :Sk]).to(card)
        seg, span = seg[:, Sk - 100:], (None if span is None
                                        else span[:, Sk - 100:])
        Sq = seg.shape[1]
    if spans:
        kw["span_ids"] = torch.from_numpy(np.ascontiguousarray(span)).to(
            card)
    q, k, v, _ = _k1_bf16(card, rng, B, Sq, Sk, H, Hkv, D)
    got, want = _k1_forward(card, q, k, v, np.ascontiguousarray(seg), **kw)
    _k1_fwd_close(f"D={D} {mode} spans={spans} mha={mha} hop={hop}", got,
                  want)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 160, 256])
def test_packed_forward_rows_without_keys(card, D):
    """A ring hop whose keys hold no token of one query segment, and
    padding on both sides: those rows' o is exactly 0 and their LSE
    -inf; the rest match the plain version."""
    rng = np.random.default_rng(42)
    (B, Sq, Sk), (H, Hkv) = (1, 300, 200), K1_HEADS[D]
    seg = np.full((B, Sq), -1, np.int32)
    seg[0, :120], seg[0, 120:250] = 0, 1          # segment 1: no keys
    kseg = np.full((B, Sk), -2, np.int32)
    kseg[0, :150] = 0                             # kv padding after 150
    q, k, v, _ = _k1_bf16(card, rng, B, Sq, Sk, H, Hkv, D)
    got, want = _k1_forward(card, q, k, v, seg, kv_offset=-Sk,
                            kv_segment_ids=torch.from_numpy(kseg).to(card))
    _k1_fwd_close(f"no keys D={D}", got, want)
    o, lse = got
    assert torch.isinf(lse[0, :, 120:]).all()
    assert torch.isfinite(lse[0, :, :120]).all()
    assert (o[0, 120:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 160, 256])
def test_packed_forward_is_deterministic(card, D):
    """Each row's sums run in one fixed order: two calls give the same
    bits of o and the LSE."""
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed)
    rng = np.random.default_rng(43)
    B, S = 2, 1024
    seg, span = _packed_tables(B, S, [600, 300, 100], True, frame=64)
    q, k, v, _ = _k1_bf16(card, rng, B, S, S, *K1_HEADS[D], D)
    kw = dict(span_ids=torch.from_numpy(span).to(card))
    got, want = _k1_forward(card, q, k, v, seg, **kw)
    _k1_fwd_close(f"determinism D={D}", got, want)
    again = flash_attention_packed(q, k, v, torch.as_tensor(seg, device=card),
                                   return_lse=True, **kw)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


# ----------------------------------------------------- SSD chunk (K3)
#: K3 against its plain version run in fp64 on the same inputs (the
#: exact value of the function): y, states and cum within K3_TOL x max(1,
#: |plain|). The gradients within K3_GRAD_TOL elementwise and, as whole
#: tensors, max|err| <= K3_TOL x max|plain|: at c = 256 each gradient
#: element sums some 256 products of both signs, and the plain version
#: itself in fp32 lies up to 2.1e-4 (dda), 1.5e-4 (dB) from the fp64
#: value there. bf16 C, B, x are upcast exactly and all arithmetic is
#: fp32; dC, dB and dx come back in bf16, one rounding (up to 2^-8 of
#: the value) from fp32
K3_TOL = 1e-4
K3_GRAD_TOL = 1e-3
K3_BF16_GRAD_TOL = 1e-2
K3_CASES = [  # Bsz, S, H, N, P, chunk
    (2, 128, 3, 16, 32, 32),       # mamba2-370m reduced: N=16, P=32
    (1, 512, 4, 128, 64, 256),     # its full width: N=128, P=64, c=256
    (3, 192, 5, 16, 32, 64),       # ragged cell counts
    (1, 96, 2, 16, 32, 96),
]


def _k3_inputs(card, dtype, Bsz, S, H, N, P, seed=2):
    """C, B, x in `dtype` and fp32 da, dt as the model makes them: dt =
    softplus(.) + 1e-3 and A = -1 (A_log = 0 at init), so the sum of dt
    over a 256-token chunk is about 200 and exp above the diagonal
    would overflow."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(card)
    C, B = f(Bsz, S, N) * 0.3, f(Bsz, S, N) * 0.3
    x = f(Bsz, S, H, P)
    dt = torch.nn.functional.softplus(f(Bsz, S, H)) + 1e-3
    return C.to(dtype), B.to(dtype), x.to(dtype), -dt, dt


def _k3_close(name, a, r, tol, whole=None):
    r = r.double()
    diff = (a.double() - r).abs()
    assert torch.isfinite(a).all(), name
    err = (diff / r.abs().clamp_min(1.0)).max().item()
    assert err <= tol, (name, err)
    if whole is not None:
        rel = diff.max().item() / max(r.abs().max().item(), 1e-30)
        assert rel <= whole, (name, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K3_CASES)
def test_ssd_chunk_kernel_matches_plain(card, dtype, case):
    from repro_torch.kernels.ssd_chunk import (ssd_chunk, ssd_chunk_bwd,
                                               ssd_chunk_bwd_plain,
                                               ssd_chunk_plain)
    Bsz, S, H, N, P, c = case
    C, B, x, da, dt = _k3_inputs(card, dtype, Bsz, S, H, N, P)
    n_fwd, n_bwd = ssd_chunk.launches, ssd_chunk_bwd.launches
    outs = ssd_chunk(C, B, x, da, dt, chunk=c)
    ins64 = [t.double() for t in (C, B, x, da, dt)]
    refs = ssd_chunk_plain(*ins64, chunk=c)
    rng = np.random.default_rng(3)
    grads_in = [torch.from_numpy(rng.standard_normal(tuple(o.shape))
                                 .astype(np.float32)).to(card)
                for o in outs]
    grads = ssd_chunk_bwd(C, B, x, da, dt, *grads_in, chunk=c)
    rgrads = ssd_chunk_bwd_plain(*ins64, *grads_in, chunk=c)
    torch.cuda.synchronize()
    for name, a, r in zip(("y", "states", "cum"), outs, refs):
        _k3_close(name, a, r, K3_TOL)
    for name, a, r in zip(("dC", "dB", "dx", "dda", "ddt"), grads, rgrads):
        if dtype == torch.bfloat16 and name in ("dC", "dB", "dx"):
            _k3_close(name, a, r, K3_BF16_GRAD_TOL, whole=K3_BF16_GRAD_TOL)
        else:
            _k3_close(name, a, r, K3_GRAD_TOL, whole=K3_TOL)
    assert ssd_chunk.launches == n_fwd + 1
    assert ssd_chunk_bwd.launches == n_bwd + 1


@pytest.mark.cuda
def test_ssd_chunk_gradient_is_finite_at_full_chunk(card):
    """c=256 with the model's dt: exp above the diagonal would be inf;
    the kernel's gradient through autograd is finite and agrees with the
    plain version's (in fp64)."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_plain
    C, B, x, da, dt = _k3_inputs(card, torch.float32, 2, 512, 4, 128, 64,
                                 seed=5)
    assert dt.reshape(2, 2, 256, 4).sum(2).min().item() > 150
    grads = {}
    for name, fn, dt_ in (("kernel", ssd_chunk, torch.float32),
                          ("plain", ssd_chunk_plain, torch.float64)):
        ins = [t.to(dt_).requires_grad_(True) for t in (C, B, x, da, dt)]
        y, st, cum = fn(*ins, chunk=256)
        loss = y.square().mean() + st.square().mean() + cum.mean()
        grads[name] = torch.autograd.grad(loss, ins)
    torch.cuda.synchronize()
    for name, a, r in zip(("dC", "dB", "dx", "dda", "ddt"),
                          grads["kernel"], grads["plain"]):
        _k3_close(name, a, r, K3_GRAD_TOL, whole=K3_TOL)


#: planted faults of K3: name -> (the outputs it must show in, a piece of
#: csrc/ssd_chunk.cu, the line inserted after its first line). Each is
#: next to the diagonal: with the model's dt the decay across a whole
#: 64-token tile is some exp(-45), so a fault farther off adds nothing
#: an fp32 sum can hold, and changes nothing
K3_FAULTS = {
    # k3_fwd_heads: y += S x skipped on the 64-wide tile pair (2, 1),
    # under the diagonal tile (1, 1)
    "fwd_drops_key_tile": (("y",), (
        "    }\n"
        "    wmm<NY, true, false, true, F32>(yacc, BT, sS, LDT, xs, LDP, wm,\n"),
        "    if (cur.it != 2 || cur.jt != 1)\n"),
    # k3_bwd_heads: dS zero on the 64-wide tile pair (2, 1), under the
    # diagonal tile (1, 1)
    "bwd_drops_pair_next_to_diagonal": (("dC", "dB", "dda", "ddt"), (
        "        wmm<4, true, true, true, F32>(dsc, P, dys, LDP, xs, LDP, wm, "
        "wh * 32);\n"),
        "        if (it == 2 && jt == 1) zero(dsc);\n"),
    # k3_bwd_heads: the group's sum of M leaves out its second head
    "bwd_group_sum_drops_a_head": (("dC", "dB"), (
        "            msum[n][e] += m;\n"),
        "            if (g == 1) msum[n][e] -= m;\n"),
}
K3_NAMES = ("y", "states", "cum", "dC", "dB", "dx", "dda", "ddt")
#: launches K3 forward and backward from the package on PYTHONPATH
_K3_RUN = """
import sys, torch
import repro_torch
assert repro_torch.__file__.startswith(sys.argv[3]), repro_torch.__file__
from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_bwd
ins, douts, c = torch.load(sys.argv[1])
ins, douts = [t.cuda() for t in ins], [t.cuda() for t in douts]
outs = ssd_chunk(*ins, chunk=c)
grads = ssd_chunk_bwd(*ins, *douts, chunk=c)
assert ssd_chunk.launches == ssd_chunk_bwd.launches == 1
torch.save([t.cpu() for t in (*outs, *grads)], sys.argv[2])
"""


def _whole_errs(got, ref):
    """max|err| / max|plain| of each output and gradient."""
    return {n: ((a.double().cpu() - r.double().cpu()).abs().max()
                / r.double().abs().max()).item()
            for n, a, r in zip(K3_NAMES, got, ref)}


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(K3_FAULTS))
def test_ssd_chunk_limit_catches_planted_fault(card, tmp_path, fault):
    """K3's whole-tensor limit (K3_TOL) lies between the sound kernel and
    one with a planted fault, at mamba2-370m's full width (fp32, one
    4096-token row, 32 heads: the backward takes four heads a block
    there, so a fault in a group's sum shows). The fault is built from
    an edited copy of the package in a temporary directory; the
    checkout is not touched. Prints both readings."""
    import os
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.kernels.ssd_chunk import (ssd_chunk, ssd_chunk_bwd,
                                               ssd_chunk_bwd_plain,
                                               ssd_chunk_plain)
    must_show, anchor, skip = K3_FAULTS[fault]
    pkg = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    copy = tmp_path / "src" / "repro_torch"
    shutil.copytree(pkg, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = copy / "kernels" / "csrc" / "ssd_chunk.cu"
    text = cu.read_text()
    assert text.count(anchor) == 1, fault
    head, rest = anchor.split("\n", 1)
    cu.write_text(text.replace(anchor, head + "\n" + skip + rest))

    c = 256
    ins = _k3_inputs(card, torch.float32, 1, 4096, 32, 128, 64, seed=7)
    rng = np.random.default_rng(8)
    outs = ssd_chunk(*ins, chunk=c)
    douts = [torch.from_numpy(rng.standard_normal(tuple(o.shape))
                              .astype(np.float32)).to(card) for o in outs]
    sound = list(outs) + list(ssd_chunk_bwd(*ins, *douts, chunk=c))
    ins64 = [t.double() for t in ins]
    ref = list(ssd_chunk_plain(*ins64, chunk=c)) + \
        list(ssd_chunk_bwd_plain(*ins64, *douts, chunk=c))
    torch.save([[t.cpu() for t in ins], [t.cpu() for t in douts], c],
               tmp_path / "in.pt")
    env = dict(os.environ, PYTHONPATH=str(tmp_path / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _K3_RUN, str(tmp_path / "in.pt"),
         str(tmp_path / "out.pt"), str(copy)],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    faulty = torch.load(tmp_path / "out.pt")
    readings = {"sound": _whole_errs(sound, ref),
                "fault": _whole_errs(faulty, ref)}
    print(f"K3 planted fault {fault}: {readings}")
    assert all(e <= K3_TOL for e in readings["sound"].values()), readings
    for name in must_show:
        assert readings["fault"][name] > K3_TOL, (name, readings)


#: (Bsz, S) of phase 14's bf16 shapes with mamba2-370m's 32 heads: two
#: rows of 2048 tokens and one of 4096
K3_TRAIN_SHAPES = [(2, 2048), (1, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("Bsz,S", K3_TRAIN_SHAPES)
def test_ssd_chunk_backward_at_the_training_shape(card, Bsz, S):
    """K3's backward at mamba2-370m's training shape (bf16, 32 heads,
    N=128, P=64, c=256), held to the plain version in fp64 with
    test_ssd_chunk_kernel_matches_plain's limits; its launch takes four
    heads a block over every (sequence, chunk)."""
    from repro_torch.kernels.ssd_chunk import (last_bwd_launch,
                                               ssd_chunk_bwd,
                                               ssd_chunk_bwd_plain)
    H, N, P, c = 32, 128, 64, 256
    ins = _k3_inputs(card, torch.bfloat16, Bsz, S, H, N, P, seed=9)
    rng = np.random.default_rng(10)
    douts = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             .to(card) for s in ((Bsz, S, H, P), (Bsz, S // c, H, N, P),
                                 (Bsz, S, H))]
    grads = ssd_chunk_bwd(*ins, *douts, chunk=c)
    launch = last_bwd_launch()
    rgrads = ssd_chunk_bwd_plain(*[t.double() for t in ins], *douts,
                                 chunk=c)
    torch.cuda.synchronize()
    for name, a, r in zip(("dC", "dB", "dx", "dda", "ddt"), grads, rgrads):
        if name in ("dC", "dB", "dx"):
            assert a.dtype == torch.bfloat16, name
            _k3_close(name, a, r, K3_BF16_GRAD_TOL, whole=K3_BF16_GRAD_TOL)
        else:
            assert a.dtype == torch.float32, name
            _k3_close(name, a, r, K3_GRAD_TOL, whole=K3_TOL)
    assert launch["kernel"] == "k3_bwd_heads", launch
    assert launch["grid"] == (H // 4, Bsz * S // c, 1), launch
    assert launch["threads"] == 256 and launch["heads_per_block"] == 4
    print(f"K3 backward launch at {Bsz}x{S}: {launch}")


@pytest.mark.cuda
@pytest.mark.parametrize("Bsz,S,H", [(1, 512, 8), (1, 4096, 32),
                                     (3, 2048, 32)])
def test_ssd_chunk_backward_launch_names_the_grouped_kernel(card, Bsz, S, H):
    """bf16, (N, P) = (128, 64), c = 256 runs k3_bwd_heads, and its record
    is what the launch needed: one block per group of heads of a chunk
    (1 to 4 heads, by the waves of blocks the card takes: 4 at one
    4096-token row), its shared memory within the H100's 227 KB, and the
    scratch for C B^T and the groups' sums."""
    from repro_torch.kernels.ssd_chunk import last_bwd_launch, ssd_chunk_bwd
    N, P, c = 128, 64, 256
    ins = _k3_inputs(card, torch.bfloat16, Bsz, S, H, N, P, seed=11)
    douts = [torch.ones(s, device=card) for s in (
        (Bsz, S, H, P), (Bsz, S // c, H, N, P), (Bsz, S, H))]
    ssd_chunk_bwd(*ins, *douts, chunk=c)
    torch.cuda.synchronize()
    launch = last_bwd_launch()
    G = launch["heads_per_block"]
    groups, nbk = -(-H // G), Bsz * S // c
    pairs = (c // 64) * (c // 64 + 1) // 2 * 64 * 64
    assert launch == dict(
        kernel="k3_bwd_heads", grid=(groups, nbk, 1), threads=256,
        smem_bytes=launch["smem_bytes"], heads_per_block=G,
        work_bytes=4 * nbk * (pairs * (1 + groups) + groups * c * N))
    assert 1 <= G <= 4 and 0 < launch["smem_bytes"] <= 232448
    if (Bsz, S) == (1, 4096):
        assert G == 4
    print(f"K3 backward launch at {Bsz}x{S}, {H} heads: {launch}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_backward_is_deterministic(card, dtype):
    """No atomics: two calls give the same bits in every gradient."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd
    Bsz, S, H, N, P, c = 1, 1024, 6, 128, 64, 256
    ins = _k3_inputs(card, dtype, Bsz, S, H, N, P, seed=12)
    rng = np.random.default_rng(13)
    douts = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             .to(card) for s in ((Bsz, S, H, P), (Bsz, S // c, H, N, P),
                                 (Bsz, S, H))]
    first = ssd_chunk_bwd(*ins, *douts, chunk=c)
    again = ssd_chunk_bwd(*ins, *douts, chunk=c)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("Bsz,S", K3_TRAIN_SHAPES)
def test_ssd_chunk_forward_at_the_training_shape(card, Bsz, S):
    """K3's forward at mamba2-370m's training shape (bf16, 32 heads,
    N=128, P=64, c=256, the model's dt), held to the plain version in
    fp64 with test_ssd_chunk_kernel_matches_plain's limit; its launch
    takes four heads a block over every (sequence, chunk)."""
    from repro_torch.kernels.ssd_chunk import (last_fwd_launch, ssd_chunk,
                                               ssd_chunk_plain)
    H, N, P, c = 32, 128, 64, 256
    ins = _k3_inputs(card, torch.bfloat16, Bsz, S, H, N, P, seed=14)
    outs = ssd_chunk(*ins, chunk=c)
    launch = last_fwd_launch()
    refs = ssd_chunk_plain(*[t.double() for t in ins], chunk=c)
    torch.cuda.synchronize()
    for name, a, r in zip(("y", "states", "cum"), outs, refs):
        assert a.dtype == torch.float32, name
        _k3_close(name, a, r, K3_TOL)
    assert launch["kernel"] == "k3_fwd_heads", launch
    assert launch["grid"] == (H // 4, Bsz * S // c, 1), launch
    assert launch["threads"] == 256 and launch["heads_per_block"] == 4
    print(f"K3 forward launch at {Bsz}x{S}: {launch}")


@pytest.mark.cuda
@pytest.mark.parametrize("Bsz,S,H", [(1, 512, 8), (1, 4096, 32),
                                     (3, 2048, 32)])
def test_ssd_chunk_forward_launch_names_the_grouped_kernel(card, Bsz, S, H):
    """bf16, (N, P) = (128, 64), c = 256 runs k3_fwd_heads after k3_cb,
    and its record is what the launch needed: one block per group of
    heads of a chunk (more than one head at one 4096-token row, by the
    waves of blocks the card takes), its shared memory within the H100's
    227 KB, and the scratch for C B^T's tile pairs."""
    from repro_torch.kernels.ssd_chunk import last_fwd_launch, ssd_chunk
    N, P, c = 128, 64, 256
    ins = _k3_inputs(card, torch.bfloat16, Bsz, S, H, N, P, seed=15)
    ssd_chunk(*ins, chunk=c)
    torch.cuda.synchronize()
    launch = last_fwd_launch()
    G = launch["heads_per_block"]
    nbk = Bsz * S // c
    pairs = (c // 64) * (c // 64 + 1) // 2 * 64 * 64
    assert launch == dict(
        kernel="k3_fwd_heads", grid=(-(-H // G), nbk, 1), threads=256,
        smem_bytes=launch["smem_bytes"], heads_per_block=G,
        work_bytes=4 * nbk * pairs)
    assert 1 <= G <= 8 and 0 < launch["smem_bytes"] <= 232448
    if (Bsz, S) == (1, 4096):
        assert G > 1
    print(f"K3 forward launch at {Bsz}x{S}, {H} heads: {launch}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_forward_is_deterministic(card, dtype):
    """No atomics: two calls give the same bits in y, states and cum."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk
    Bsz, S, H, N, P, c = 1, 1024, 6, 128, 64, 256
    ins = _k3_inputs(card, dtype, Bsz, S, H, N, P, seed=16)
    first = ssd_chunk(*ins, chunk=c)
    again = ssd_chunk(*ins, chunk=c)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_chunk_forward_takes_a_misaligned_slice(card, dtype):
    """C and B sliced from one buffer at an odd offset and an odd token
    stride (as a slice of the conv output could be), and x one element
    into its buffer: the kernels load 16 bytes at a time, so the
    wrapper copies them, and the forward and backward still agree with
    the plain versions at test_ssd_chunk_kernel_matches_plain's limits."""
    from repro_torch.kernels.ssd_chunk import (ssd_chunk, ssd_chunk_bwd,
                                               ssd_chunk_bwd_plain,
                                               ssd_chunk_plain)
    Bsz, S, H, N, P, c = 2, 512, 4, 128, 64, 256
    C0, B0, x0, da, dt = _k3_inputs(card, dtype, Bsz, S, H, N, P, seed=17)
    buf = torch.zeros(Bsz, S, 2 * N + 3, dtype=dtype, device=card)
    buf[..., 1:N + 1], buf[..., N + 2:2 * N + 2] = C0, B0
    C, B = buf[..., 1:N + 1], buf[..., N + 2:2 * N + 2]
    xbuf = torch.zeros(x0.numel() + 1, dtype=dtype, device=card)
    x = xbuf[1:].view(x0.shape)
    x.copy_(x0)
    assert C.data_ptr() % 16 and x.data_ptr() % 16
    outs = ssd_chunk(C, B, x, da, dt, chunk=c)
    rng = np.random.default_rng(18)
    douts = [torch.from_numpy(rng.standard_normal(tuple(o.shape))
                              .astype(np.float32)).to(card) for o in outs]
    grads = ssd_chunk_bwd(C, B, x, da, dt, *douts, chunk=c)
    ins64 = [t.double() for t in (C0, B0, x0, da, dt)]
    refs = ssd_chunk_plain(*ins64, chunk=c)
    rgrads = ssd_chunk_bwd_plain(*ins64, *douts, chunk=c)
    torch.cuda.synchronize()
    for name, a, r in zip(("y", "states", "cum"), outs, refs):
        _k3_close(name, a, r, K3_TOL)
    for name, a, r in zip(("dC", "dB", "dx", "dda", "ddt"), grads, rgrads):
        if dtype == torch.bfloat16 and name in ("dC", "dB", "dx"):
            _k3_close(name, a, r, K3_BF16_GRAD_TOL, whole=K3_BF16_GRAD_TOL)
        else:
            _k3_close(name, a, r, K3_GRAD_TOL, whole=K3_TOL)


#: the device memory a training run may hold without per-layer remat
#: (of the H100's 80 GB: the rest is the allocator's and the context's)
REMAT_LIMIT_BYTES = 70e9


@pytest.mark.cuda
def test_mamba2_full_width_training_needs_remat(card):
    """`remat` is on for mamba2-370m alone: the openvid run of
    `chip_smoke.py` (global batch 8, sequences up to 4096 tokens, padded
    one per row) does not fit the card without it, and fits with it.
    internvl3-2b's packed run fits without it (`chip_smoke.py` phase 9
    reads its peak). Prints both peaks."""
    import gc

    from repro_torch.api import ClusterSpec, Engine
    from repro_torch.configs import get_config

    cfg = get_config("mamba2-370m")
    assert cfg.remat and not get_config("internvl3-2b").remat
    run = dict(steps=3, dataset="openvid", global_batch=8,
               max_tokens=4096, tokens_per_frame=256)
    peaks = {}
    for remat in (False, True):
        eng = Engine(cfg.with_(remat=remat),
                     ClusterSpec.auto(mem_budget=4096), seed=0)
        torch.cuda.reset_peak_memory_stats(card)
        oom = None
        try:
            eng.train(**run)
        except torch.OutOfMemoryError as e:
            oom = str(e).split("\n")[0]
        finally:
            eng.close()
        peaks[remat] = (torch.cuda.max_memory_allocated(card), oom)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    print(f"mamba2-370m peak bytes, out-of-memory: without remat "
          f"{peaks[False]}, with remat {peaks[True]}")
    peak, oom = peaks[True]
    assert oom is None and peak < REMAT_LIMIT_BYTES, peaks
    peak, oom = peaks[False]
    assert oom is not None or peak > REMAT_LIMIT_BYTES, peaks


# ------------------------------------------------- RG-LRU scan (K4)
#: K4 against its plain version run in fp64 on the same inputs: fp32 h,
#: da, db within K4_TOL x max(1, |plain|) (the state is carried in fp32;
#: the chunked scan composes the same products in another order), bf16
#: within K4_BF16_TOL (h, da, db come back in bf16, one rounding of up to
#: 2^-9 of the value, and da is formed from the saved bf16 h)
K4_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
K4_CASES = [  # B, S, W
    (1, 4096, 2560),     # recurrentgemma-2b: one 4096-token row
    (3, 100, 300),       # ragged: a part chunk, a part channel block
    (2, 64, 32),         # exactly one chunk
    (1, 1, 7),
]


def _k4_inputs(card, dtype, B, S, W, seed=11):
    """a in (0.3, 0.999) as the model's gates make it (a = sigmoid(L)^(8
    r), L in (2, 5)), b and the output gradient standard normal."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.3, 0.999, (B, S, W)).astype(np.float32)
    b, dh = (rng.standard_normal((B, S, W)).astype(np.float32)
             for _ in range(2))
    return [torch.from_numpy(x).to(card, dtype) for x in (a, b, dh)]


def _k4_err(a, r):
    r = r.double()
    assert torch.isfinite(a).all()
    return ((a.double() - r).abs() / r.abs().clamp_min(1.0)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", K4_CASES)
def test_rglru_scan_kernel_matches_plain(card, dtype, case):
    from repro_torch.kernels.rglru_scan import (rglru_scan, rglru_scan_bwd,
                                                rglru_scan_bwd_plain,
                                                rglru_scan_plain)
    a, b, dh = _k4_inputs(card, dtype, *case)
    n_fwd, n_bwd = rglru_scan.launches, rglru_scan_bwd.launches
    h = rglru_scan(a, b)
    da, db = rglru_scan_bwd(a, h, dh)
    rh = rglru_scan_plain(a.double(), b.double())
    rda, rdb = rglru_scan_bwd_plain(a.double(), rh, dh.double())
    torch.cuda.synchronize()
    assert h.dtype == da.dtype == db.dtype == dtype
    errs = {n: _k4_err(x, r) for n, x, r in (("h", h, rh), ("da", da, rda),
                                             ("db", db, rdb))}
    print(f"K4 {case} {dtype}: {errs}")
    assert all(e <= K4_TOL[dtype] for e in errs.values()), errs
    assert rglru_scan.launches == n_fwd + 1
    assert rglru_scan_bwd.launches == n_bwd + 1


@pytest.mark.cuda
def test_rglru_scan_autograd_runs_both_kernels(card):
    from repro_torch.kernels.rglru_scan import (rglru_scan, rglru_scan_bwd,
                                                rglru_scan_plain)
    a, b, dh = _k4_inputs(card, torch.float32, 2, 300, 96, seed=12)
    ins = [t.clone().requires_grad_(True) for t in (a, b)]
    n_fwd, n_bwd = rglru_scan.launches, rglru_scan_bwd.launches
    got = torch.autograd.grad(rglru_scan(*ins), ins, dh)
    ref_ins = [t.double().requires_grad_(True) for t in (a, b)]
    want = torch.autograd.grad(rglru_scan_plain(*ref_ins), ref_ins,
                               dh.double())
    torch.cuda.synchronize()
    for x, r in zip(got, want):
        assert _k4_err(x, r) <= K4_TOL[torch.float32]
    assert (rglru_scan.launches, rglru_scan_bwd.launches) == \
        (n_fwd + 1, n_bwd + 1)


@pytest.mark.cuda
def test_rglru_scan_forward_calls_in_a_row_each_match_plain(card):
    """The forward keeps its ticket, its count of finished blocks, its
    epoch and its tiles' records between calls: calls in a row on other
    inputs and other shapes (fewer tiles, then more, which remakes the
    state, then fewer again) each equal their plain result."""
    from repro_torch.kernels.rglru_scan import (rglru_scan,
                                                rglru_scan_plain)
    shapes = [(1, 4096, 2560), (1, 4096, 2560), (3, 100, 300),
              (4, 4096, 2560), (1, 1000, 2560), (1, 1000, 2560)]
    n_fwd = rglru_scan.launches
    for i, case in enumerate(shapes):
        a, b, _ = _k4_inputs(card, torch.float32, *case, seed=20 + i)
        h = rglru_scan(a, b)
        rh = rglru_scan_plain(a.double(), b.double())
        torch.cuda.synchronize()
        err = _k4_err(h, rh)
        print(f"K4 call {i} {case}: h {err}")
        assert err <= K4_TOL[torch.float32], (i, case, err)
    assert rglru_scan.launches == n_fwd + len(shapes)


@pytest.mark.cuda
def test_rglru_scan_forward_many_more_tiles_than_the_card_holds(card):
    """16 rows of 4096 steps at recurrentgemma-2b's width: 20480 tiles,
    many times what the card holds at once, so most blocks take their
    ticket after earlier ones have finished (a wrong ticket order would
    hang or read a carry not yet there)."""
    from repro_torch.kernels.rglru_scan import (rglru_scan,
                                                rglru_scan_plain)
    a, b, _ = _k4_inputs(card, torch.float32, 16, 4096, 2560, seed=14)
    h = rglru_scan(a, b)
    rh = rglru_scan_plain(a.double(), b.double())
    torch.cuda.synchronize()
    err = _k4_err(h, rh)
    print(f"K4 16x4096: h {err}")
    assert err <= K4_TOL[torch.float32]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rglru_scan_forward_gives_the_same_bits_on_every_call(card, dtype):
    """Held to the same bits, not to K4_TOL: every tile composes its
    carry from the same maps in the same order (the inclusive prefix at
    the end of the group before, then its group's earlier tiles' maps),
    whatever order the blocks ran in."""
    from repro_torch.kernels.rglru_scan import rglru_scan
    a, b, _ = _k4_inputs(card, dtype, 4, 4096, 2560, seed=15)
    first = rglru_scan(a, b)
    for _ in range(3):
        assert torch.equal(rglru_scan(a, b), first)


#: planted faults of K4: name -> (the outputs it must show in, the line
#: of csrc/rglru_scan.cu it edits, the edited line). The forward's two
#: break its look-back (each tile takes one tile fewer of its group,
#: leaving out the group's first; a group's last tile publishes its
#: carry as its inclusive prefix, without its own map); the backward's
#: drops, for every chunk, the map of the chunk next to it from the
#: carry
K4_FAULTS = {
    "fwd_lookback_stops_one_tile_early": (("h",), (
        "  const int n_look = tt - first;           // its group's before "
        "it\n"),
        "  const int n_look = tt - first - 1;       // its group's before "
        "it\n"),
    "fwd_inclusive_without_own_map": (("h",), (
        "        one[j] = 1.f, incl[j] = fmaf(ga[j], prev[j], gb[j]);\n"),
        "        one[j] = 1.f, incl[j] = fmaf(Al[j], prev[j], Bl[j]);\n"),
    "bwd_drops_next_chunk": (("da", "db"), (
        "    g = fmaf(sumP[so + (int64_t)k * s.W], g, "
        "sumG[so + (int64_t)k * s.W]);\n"),
        "    if (k != c + 1) g = fmaf(sumP[so + (int64_t)k * s.W], g, "
        "sumG[so + (int64_t)k * s.W]);\n"),
}
_K4_RUN = """
import sys, torch
import repro_torch
assert repro_torch.__file__.startswith(sys.argv[3]), repro_torch.__file__
from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
a, b, dh, h_sound = [t.cuda() for t in torch.load(sys.argv[1])]
h = rglru_scan(a, b)
da, db = rglru_scan_bwd(a, h_sound, dh)
assert rglru_scan.launches == rglru_scan_bwd.launches == 1
torch.save([t.cpu() for t in (h, da, db)], sys.argv[2])
"""


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(K4_FAULTS))
def test_rglru_scan_limit_catches_planted_fault(card, tmp_path, fault):
    """K4's fp32 limit (K4_TOL) lies between the sound kernel and one
    with a planted fault, at recurrentgemma-2b's width (one 1024-token
    row of 2560 channels). The faulty kernel is built from an edited copy
    of the package in a temporary directory. Prints both readings."""
    import os
    import shutil
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.kernels.rglru_scan import (rglru_scan, rglru_scan_bwd,
                                                rglru_scan_bwd_plain,
                                                rglru_scan_plain)
    must_show, line, edited = K4_FAULTS[fault]
    pkg = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    copy = tmp_path / "src" / "repro_torch"
    shutil.copytree(pkg, copy,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = copy / "kernels" / "csrc" / "rglru_scan.cu"
    text = cu.read_text()
    assert text.count(line) == 1, fault
    cu.write_text(text.replace(line, edited))

    a, b, dh = _k4_inputs(card, torch.float32, 1, 1024, 2560, seed=13)
    h = rglru_scan(a, b)
    sound = [h, *rglru_scan_bwd(a, h, dh)]
    rh = rglru_scan_plain(a.double(), b.double())
    ref = [rh, *rglru_scan_bwd_plain(a.double(), rh, dh.double())]
    torch.save([t.cpu() for t in (a, b, dh, h)], tmp_path / "in.pt")
    env = dict(os.environ, PYTHONPATH=str(tmp_path / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _K4_RUN, str(tmp_path / "in.pt"),
         str(tmp_path / "out.pt"), str(copy)],
        cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    faulty = torch.load(tmp_path / "out.pt")
    names = ("h", "da", "db")
    readings = {"sound": {n: _k4_err(x, r) for n, x, r
                          in zip(names, sound, ref)},
                "fault": {n: _k4_err(x.to(card), r) for n, x, r
                          in zip(names, faulty, ref)}}
    print(f"K4 planted fault {fault}: {readings}")
    limit = K4_TOL[torch.float32]
    assert all(e <= limit for e in readings["sound"].values()), readings
    for name in must_show:
        assert readings["fault"][name] > limit, (name, readings)


# -------------------------------------- K1 at head_dim 256 (hybrid)
def _hybrid_tables(B, S, spans):
    """One segment per row (the padded hybrid batch: no segment table is
    emitted, attention takes segment 0 everywhere) and a span table with
    the given (start, length) bidirectional blocks in every row."""
    seg = np.zeros((B, S), np.int32)
    span = np.full((B, S), -1, np.int32)
    for i, (start, n) in enumerate(spans):
        span[:, start:start + n] = i
    return seg, span


K1_WIDE_CASES = [  # B, S, window, spans
    # recurrentgemma-2b: window 2048, 256-token frames after 32 text
    # tokens each, over one 4096-token row
    (1, 4096, 2048, [(32 + 288 * i, 256) for i in range(14)]),
    # a span longer than the window (the reduced config's window is 64)
    (2, 512, 64, [(40, 200), (300, 20)]),
    (3, 300, 64, []),       # no spans: the span-free kernel
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(K1_WIDE_CASES)))
def test_packed_kernel_head_dim_256(card, case):
    """K1 in bf16 at recurrentgemma-2b's heads (10 query heads over one
    KV head, D = 256), sliding, against the plain versions, with PR 12's
    limits: elementwise TOL / GRAD_TOL and REL_TOL_BF16 as whole
    tensors."""
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed, flash_attention_packed_bwd,
        flash_attention_packed_bwd_ref, flash_attention_packed_ref)
    B, S, window, spans = K1_WIDE_CASES[case]
    seg, span = _hybrid_tables(B, S, spans)
    rng = np.random.default_rng(20 + case)
    dtype = torch.bfloat16
    q, do = [torch.from_numpy(rng.standard_normal((B, S, 10, 256))
                              .astype(np.float32)).to(card, dtype)
             for _ in range(2)]
    k, v = [torch.from_numpy(rng.standard_normal((B, S, 1, 256))
                             .astype(np.float32)).to(card, dtype)
            for _ in range(2)]
    segt = torch.from_numpy(seg).to(card)
    kw = dict(mode="sliding", window=window,
              span_ids=torch.from_numpy(span).to(card) if spans else None)
    n_fwd = flash_attention_packed.launches
    n_bwd = flash_attention_packed_bwd.launches
    o, lse = flash_attention_packed(q, k, v, segt, return_lse=True, **kw)
    grads = flash_attention_packed_bwd(q, k, v, o, lse, do, segt, **kw)
    ro, rlse = flash_attention_packed_ref(q, k, v, segt, **kw)
    refs = flash_attention_packed_bwd_ref(q, k, v, ro, rlse, do, segt, **kw)
    torch.cuda.synchronize()
    errs = {}
    for name, a, r in [("o", o, ro), ("dq", grads[0], refs[0]),
                       ("dk", grads[1], refs[1]), ("dv", grads[2], refs[2])]:
        r = r.float()
        diff = (a.float() - r).abs()
        errs[name] = ((diff / r.abs().clamp_min(1.0)).max().item(),
                      diff.max().item() / r.abs().max().item())
    print(f"K1 D=256 case {case}: {errs}")
    for name, (err, rel) in errs.items():
        tol = TOL[dtype] if name == "o" else GRAD_TOL[dtype]
        assert err <= tol and rel <= REL_TOL_BF16, (name, errs)
    fin = torch.isfinite(rlse)
    assert torch.equal(fin, torch.isfinite(lse))
    assert (lse[fin] - rlse[fin]).abs().max().item() <= 1e-3
    assert flash_attention_packed.launches == n_fwd + 1
    assert flash_attention_packed_bwd.launches == n_bwd + 1


@pytest.mark.cuda
def test_packed_kernel_head_dim_256_refuses_fp32(card):
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed)
    q = torch.zeros(1, 64, 10, 256, device=card)
    k = torch.zeros(1, 64, 1, 256, device=card)
    seg = torch.zeros(1, 64, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="bfloat16 only"):
        flash_attention_packed(q, k, k, seg, mode="sliding", window=16)


@pytest.mark.cuda
def test_table_free_attention_with_gradient_runs_k1(card):
    """A padded text-only group has no tables; its attention needs a
    gradient, which K2 cannot give, so it runs K1 with one segment per
    row (and K2 still serves calls without a gradient)."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed, flash_attention_packed_bwd)
    from repro_torch.models.attention import attention, init_attention
    gen = torch.Generator(device=card).manual_seed(0)
    params = init_attention(gen, 256, 4, 1, 64, torch.bfloat16, card)
    x = torch.randn(2, 96, 256, generator=gen, device=card).to(
        torch.bfloat16)
    kw = dict(n_heads=4, kv_heads=1, head_dim=64, rope_theta=1e4,
              mode="sliding", window=32, impl="cuda")
    n = (flash_attention.launches, flash_attention_packed.launches,
         flash_attention_packed_bwd.launches)
    xg = x.clone().requires_grad_(True)
    out = attention(params, xg, **kw)
    (dx,) = torch.autograd.grad(out.float().square().sum(), xg)
    with torch.no_grad():
        again = attention(params, x, **kw)
    torch.cuda.synchronize()
    assert (flash_attention.launches - n[0],
            flash_attention_packed.launches - n[1],
            flash_attention_packed_bwd.launches - n[2]) == (1, 1, 1)
    assert torch.isfinite(dx).all()
    ref = attention(params, x, **{**kw, "impl": "reference"})
    for o in (out, again):
        err = (o.float() - ref.float()).abs().max().item()
        assert err <= TOL[torch.bfloat16] * max(
            1.0, ref.float().abs().max().item()), err


@pytest.mark.cuda
def test_recurrentgemma_full_width_training_memory(card, monkeypatch):
    """recurrentgemma-2b's openvid run of `chip_smoke.py` (global batch
    8, sequences up to 4096 tokens, padded one per row) fits the card
    only with both of its memory measures: `remat` per pattern unit (on
    in its config) and the padded path's head and NLL in checkpointed
    pieces (`core/executor.token_nll`). Without either it runs out of
    memory. Prints the three peaks."""
    import gc

    from repro_torch.api import ClusterSpec, Engine
    from repro_torch.configs import get_config
    from repro_torch.core import executor as ex

    token_nll = ex.token_nll

    def whole_batch_nll(params, cfg, batch, pieces=False, ring=None):
        return token_nll(params, cfg, batch, ring=ring)

    cfg = get_config("recurrentgemma-2b")
    assert cfg.remat
    run = dict(steps=3, dataset="openvid", global_batch=8,
               max_tokens=4096, tokens_per_frame=256)
    peaks = {}
    for name, remat, nll in (("without remat", False, ex.token_nll),
                             ("whole-batch loss", True, whole_batch_nll),
                             ("both", True, ex.token_nll)):
        monkeypatch.setattr(ex, "token_nll", nll)
        eng = Engine(cfg.with_(remat=remat),
                     ClusterSpec.auto(mem_budget=4096), seed=0)
        torch.cuda.reset_peak_memory_stats(card)
        oom = None
        try:
            eng.train(**run)
        except torch.OutOfMemoryError as e:
            oom = str(e).split("\n")[0]
        finally:
            eng.close()
        peaks[name] = (torch.cuda.max_memory_allocated(card), oom)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    print(f"recurrentgemma-2b peak bytes, out-of-memory: {peaks}")
    assert peaks["both"][1] is None, peaks
    assert peaks["without remat"][1] is not None, peaks
    assert peaks["whole-batch loss"][1] is not None, peaks


# Ring context parallelism (parallel/ring_attention.py): a LocalRing of
# degree 3 on the card, every hop through K1, in the contiguous and the
# striped layout (rank r holds tokens i 3 + r: the inputs permuted, the
# results put back), against K1 unsharded on the same bf16 inputs, with
# the K1 checks' limits (TOL / GRAD_TOL elementwise, REL_TOL_BF16 as
# whole tensors); segments and spans cross the shard borders. Four
# planted faults must break those limits: the wrapped rows' shard
# distance with the wrong sign, dK / dV left one shift short of home,
# and in the striped layout's hop arithmetic (`striped_hop`) the offset
# without its +1 and the window W where W' belongs.
#: head_dim -> (query heads, KV heads, mode, window): internvl3-2b's
#: attention and recurrentgemma-2b's (a window below S_loc; striped at
#: d = 3 each hop's window W' is 133 or 134)
RING_SHAPES = {128: (12, 2, "causal", None), 256: (10, 1, "sliding", 400)}


#: fault -> (head dim of its case, the planted striped_hop or None)
RING_FAULT_CASES = {"wrong_sign": (128, None), "short_home": (128, None),
                    "no_plus_one": (128, hop_faults.no_plus_one),
                    "raw_window": (256, hop_faults.raw_window)}


def _ring_faults():
    from repro_torch.parallel import LocalRing

    class WrongSign(LocalRing):
        """The wrapped rows' shard distance with the wrong sign."""

        def hops(self, h, rows):
            return [(s, abs(dist)) for s, dist in super().hops(h, rows)]

    class ShortHome(LocalRing):
        """dK and dV not shifted home after the last hop (the only shift
        of two tensors: the hops move K, V and the tables with them)."""

        def shift(self, *ts):
            return ts if len(ts) == 2 else super().shift(*ts)

    striped = functools.partial(LocalRing, striped=True)
    return {"wrong_sign": WrongSign, "short_home": ShortHome,
            "no_plus_one": striped, "raw_window": striped}


def _ring_errors(card, D, ring, d=3, S=1536):
    """{name: (elementwise, whole)} of ring_attention over `ring` against
    K1 unsharded, for o, dq, dk, dv; and the ring's K1 launches."""
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed, flash_attention_packed_bwd)
    from repro_torch.parallel import ring_attention
    Hq, Hkv, mode, window = RING_SHAPES[D]
    seg, span = _packed_tables(1, S, [500, 410, 300, 250], True, frame=96)
    rng = np.random.default_rng(31 + D)
    q, k, v, do = _k1_bf16(card, rng, 1, S, S, Hq, Hkv, D)
    segt, spant = (torch.from_numpy(t).to(card) for t in (seg, span))
    kw = dict(mode=mode, window=window, span_ids=spant)
    o, lse = flash_attention_packed(q, k, v, segt, return_lse=True, **kw)
    want = (o,) + tuple(flash_attention_packed_bwd(q, k, v, o, lse, do, segt,
                                                   **kw))
    order = (torch.arange(S).reshape(S // d, d).T.reshape(-1)
             if ring.striped else torch.arange(S)).to(card)
    rows = lambda t: t[:, order].reshape(d, S // d,  # noqa: E731
                                         *t.shape[2:])
    qs, ks, vs = (rows(t).detach().requires_grad_(True) for t in (q, k, v))
    n = (flash_attention_packed.launches,
         flash_attention_packed_bwd.launches)
    ro = ring_attention(qs, ks, vs, rows(segt), ring=ring, mode=mode,
                        window=window, span_ids=rows(spant))
    got = (ro,) + torch.autograd.grad(ro, (qs, ks, vs), rows(do))
    torch.cuda.synchronize()
    launches = (flash_attention_packed.launches - n[0],
                flash_attention_packed_bwd.launches - n[1])
    errs = {}
    back = torch.argsort(order)
    for name, a, r in zip(("o", "dq", "dk", "dv"), got, want):
        a, r = a.reshape(r.shape)[:, back].float(), r.float()
        diff = (a - r).abs()
        errs[name] = ((diff / r.abs().clamp_min(1.0)).max().item(),
                      diff.max().item() / r.abs().max().item())
    return errs, launches


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 256])
def test_ring_matches_k1_unsharded(card, D):
    from repro_torch.parallel import LocalRing
    errs, launches = _ring_errors(card, D, LocalRing(3))
    print(f"ring d=3 D={D}: {errs}")
    assert launches == (5, 5)            # hop 0 once, then two a hop
    for name, (err, rel) in errs.items():
        tol = TOL[torch.bfloat16] if name == "o" else \
            GRAD_TOL[torch.bfloat16]
        assert err <= tol and rel <= REL_TOL_BF16, (name, errs)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 256])
def test_striped_ring_matches_k1_unsharded(card, D):
    from repro_torch.parallel import LocalRing
    errs, launches = _ring_errors(card, D, LocalRing(3, striped=True))
    print(f"striped ring d=3 D={D}: {errs}")
    assert launches == (5, 5)            # spans: no hop is skipped
    for name, (err, rel) in errs.items():
        tol = TOL[torch.bfloat16] if name == "o" else \
            GRAD_TOL[torch.bfloat16]
        assert err <= tol and rel <= REL_TOL_BF16, (name, errs)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", list(RING_FAULT_CASES))
def test_ring_limit_catches_planted_fault(card, monkeypatch, fault):
    D, hop = RING_FAULT_CASES[fault]
    if hop is not None:
        monkeypatch.setattr(importlib.import_module(
            "repro_torch.parallel.ring_attention"), "striped_hop", hop)
    errs, _ = _ring_errors(card, D, _ring_faults()[fault](3))
    print(f"ring fault {fault}: {errs}")
    caught = [name for name, (err, rel) in errs.items()
              if err > (TOL if name == "o" else GRAD_TOL)[torch.bfloat16]
              or rel > REL_TOL_BF16]
    assert caught, errs
    if fault == "short_home":
        assert set(caught) <= {"dk", "dv"} and caught, errs


# ------------------------------------------------------------------ MoE
def _moe_layer(device, D=256, E=32, F=128):
    from repro_torch.models.moe import init_moe
    gen = torch.Generator(device="cpu").manual_seed(0)
    p = init_moe(gen, D, E, F, torch.float32, "cpu")
    return {k: v.to(device) for k, v in p.items()}


@pytest.mark.cuda
def test_moe_router_product_is_ieee_fp32_on_the_card(card):
    """The router's product runs in IEEE fp32 whatever the caller set:
    under TF32 (the caller's "high") it stays within fp32's rounding of
    the fp64 product, and the caller's setting comes back."""
    from repro_torch.models.moe import route
    p = _moe_layer(card)
    x = torch.randn(4096, 256, generator=torch.Generator().manual_seed(1))
    want = torch.softmax(x.double() @ p["router"].cpu().double(), dim=-1)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        probs, _, _ = route(p, x.to(card), 8)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    err = (probs.cpu().double() - want).abs().max().item()
    print(f"router probs vs fp64: {err:.3e}")
    assert err <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch,per_row", [("sort", False),
                                              ("sort", True),
                                              ("einsum", False)])
def test_moe_ffn_on_the_card_equals_the_cpu(card, dispatch, per_row):
    """fp32 (TF32 off): the card's routing and values are the CPU's,
    dropping tokens (capacity factor 1.0) and in groups."""
    from repro_torch.models.moe import moe_ffn
    p = _moe_layer(card)
    x = torch.randn(4, 64, 256, generator=torch.Generator().manual_seed(2))
    kw = dict(top_k=8, capacity_factor=1.0, dispatch=dispatch,
              dispatch_group=128, per_row=per_row)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("highest")
        out, aux = moe_ffn(p, x.to(card), **kw)
    finally:
        torch.set_float32_matmul_precision(prev)
    want, want_aux = moe_ffn({k: v.cpu() for k, v in p.items()}, x, **kw)
    torch.testing.assert_close(out.cpu(), want, atol=1e-4, rtol=0)
    torch.testing.assert_close(aux.cpu(), want_aux, atol=1e-6, rtol=1e-5)


# --------------------------------------------------- the audio family
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq", [1500, 1, 448])
def test_k2_full_at_whisper_shapes(card, dtype, Sq):
    """whisper-small's attention in full mode at 12:12 heads of 64:
    its encoder over 1500 frames (Sq = Sk; 1500 = 23 key tiles of 64 and
    one of 28), and its decoder's cross-attention of one token and of
    448 tokens over the frames (Sq != Sk)."""
    _k2_close(card, f"whisper {Sq}x1500", 1, Sq, 1500, 12, 12, 64, 90 + Sq,
              dtype=dtype, mode="full")


# K2's fp32 kernel: split TF32 on the tensor cores, one warpgroup over 64
# query rows a block, two blocks an SM at D = 64
@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq", [(1, 1500), (2, 448)])
def test_k2_f32_split_tf32_at_whisper_shapes(card, B, Sq):
    """whisper-small's encoder (1x1500) and forward's cross-attention
    (2x448) over 1500 frames at 12:12 heads of 64, fp32: within 1e-4 of
    the plain version (plain TF32 reads 2e-4 to 4e-4 there); the launch
    is (H, ceil(Sq / 64), B) blocks of 128 threads in at most half an
    SM's shared memory; a second call gives the same bits (no atomics)."""
    from repro_torch.kernels.flash_attention import last_launch
    out, _ = _k2_close(card, f"fp32 {B}x{Sq}x1500", B, Sq, 1500, 12, 12, 64,
                       110 + B, dtype=torch.float32, mode="full")
    launch = last_launch()
    assert launch["grid"] == (12, -(-Sq // 64), B), launch
    assert launch["threads"] == 128, launch
    assert launch["smem_bytes"] <= 232448 // 2, launch
    rng = np.random.default_rng(110 + B)
    q, k, v = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(card) for s in ((B, Sq, 12, 64), (B, 1500, 12, 64),
                                   (B, 1500, 12, 64))]
    assert torch.equal(out, flash_attention(q, k, v, mode="full"))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("mode,window", [("causal", None),
                                         ("sliding", 64)])
def test_k2_f32_rows_without_keys_are_zero(card, mode, window, D):
    """As test_k2_rows_without_keys_are_zero in fp32 (kv_offset 150, GQA
    12:2): queries 0-149 come out exactly 0, the rest within 1e-4."""
    out, _ = _k2_close(card, "fp32 no keys", 2, 300, 300, 12, 2, D, 92,
                       dtype=torch.float32, mode=mode, window=window,
                       kv_offset=150)
    assert (out[:, :150] == 0).all()
    assert out[:, 150:].abs().amax(dim=(0, 2, 3)).min() > 0


def _whisper(card):
    """Reduced whisper-small (fp32, attn_impl="cuda"), its parameters
    on the CPU and on the card, and frames from a numpy seed."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as tm
    cfg = get_config("whisper-small").reduced().with_(attn_impl="cuda")
    params = tm.init_params(cfg, seed=0, device="cpu")
    on_card = _to(params, card)
    frames = np.random.default_rng(4).standard_normal(
        (2, cfg.encdec.n_audio_frames, cfg.d_model)).astype(np.float32)
    return cfg, params, on_card, torch.from_numpy(frames)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.cuda
def test_prefill_cross_kv_on_the_card_equals_the_cpu(card):
    """The encoder's full attention through K2 (fp32, a launch an
    encoder layer), TF32 off: the cross K/V are the CPU's within K2's
    fp32 limit."""
    from repro_torch.models import model as tm
    cfg, params, on_card, frames = _whisper(card)
    want = tm.prefill_cross_kv(params, cfg, frames,
                               tm.init_cache(cfg, 2, 8, device="cpu"))
    prev = torch.get_float32_matmul_precision()
    before = flash_attention.launches
    try:
        torch.set_float32_matmul_precision("highest")
        got = tm.prefill_cross_kv(on_card, cfg, frames.to(card),
                                  tm.init_cache(cfg, 2, 8, device=card))
        torch.cuda.synchronize()
    finally:
        torch.set_float32_matmul_precision(prev)
    assert flash_attention.launches == before + cfg.encdec.n_enc_layers
    for name in ("cross_k", "cross_v"):
        assert got[name].dtype == torch.float32
        err = ((got[name].cpu() - want[name]).abs()
               / want[name].abs().clamp_min(1.0)).max().item()
        assert err <= TOL[torch.float32], (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq,Sk", [(2, 448, 1500), (1, 1, 1500),
                                     (2, 40, 48), (1, 1500, 1500)])
def test_k1_f32_full_at_sq_ne_sk(card, B, Sq, Sk):
    """K1's fp32 kernels in full mode at whisper-small's heads (12:12,
    D=64), one segment a row on each side: the cross-attention's Sq !=
    Sk (448 and 1 queries over 1500 frames, whose last 32-key tile holds
    28; 40 over 48) and the encoder's 1500 x 1500, forward and backward
    against the plain versions within the fp32 limits, each launch
    counted under its kernel and mode and under its shape, and recorded
    by the library: the split-TF32 forward a block per (query head, 128
    queries, row); the split-TF32 backward's dK / dV kernel a block per
    (128 keys, KV head, row), its dQ kernel per (query head, 128
    queries, row); 256 threads each."""
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed, flash_attention_packed_bwd,
        flash_attention_packed_bwd_ref, flash_attention_packed_ref,
        last_bwd_dq_launch, last_bwd_kv_launch, last_fwd_launch)
    rng = np.random.default_rng(Sq + Sk)
    q, do = (torch.from_numpy(rng.standard_normal((B, Sq, 12, 64)).astype(
        np.float32)).to(card) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Sk, 12, 64)).astype(
        np.float32)).to(card) for _ in range(2))
    seg = torch.zeros(B, Sq, dtype=torch.int32, device=card)
    kw = dict(mode="full", kv_segment_ids=torch.zeros(
        B, Sk, dtype=torch.int32, device=card))
    flash_attention_packed.launches_by = {}
    flash_attention_packed.launches_by_shape = {}
    o, lse = flash_attention_packed(q, k, v, seg, return_lse=True, **kw)
    fwd_launch = last_fwd_launch()
    got = flash_attention_packed_bwd(q, k, v, o, lse, do, seg, **kw)
    bwd_launch, dq_launch = last_bwd_kv_launch(), last_bwd_dq_launch()
    ro, rlse = flash_attention_packed_ref(q, k, v, seg, **kw)
    want = flash_attention_packed_bwd_ref(q, k, v, ro, rlse, do, seg, **kw)
    torch.cuda.synchronize()
    assert flash_attention_packed.launches_by == {
        "packed_fwd_f32_kernel full": 1, "packed_bwd_f32_kernel full": 1,
        "packed_bwd_f32_dq_kernel full": 1}
    assert flash_attention_packed.launches_by_shape == {
        f"packed_fwd_f32_kernel full {Sq}x{Sk}": 1,
        f"packed_bwd_f32_kernel full {Sq}x{Sk}": 1,
        f"packed_bwd_f32_dq_kernel full {Sq}x{Sk}": 1}
    assert fwd_launch["grid"] == (12, -(-Sq // 128), B), fwd_launch
    assert fwd_launch["threads"] == 256
    assert bwd_launch["grid"] == (-(-Sk // 128), 12, B), bwd_launch
    assert dq_launch["grid"] == (12, -(-Sq // 128), B), dq_launch
    assert bwd_launch["threads"] == dq_launch["threads"] == 256
    assert bwd_launch["work_bytes"] == 0
    print(f"K1 fp32 bwd launches: dK/dV {bwd_launch}, dQ {dq_launch}")
    assert (lse - rlse).abs().max().item() <= 1e-4
    for name, a, r in zip(("o", "dq", "dk", "dv"), (o, *got), (ro, *want)):
        err = ((a - r).abs() / r.abs().clamp_min(1.0)).max().item()
        print(f"K1 fp32 full B={B} Sq={Sq} Sk={Sk} {name}: {err:.3g}")
        assert err <= TOL[torch.float32], (name, err)


#: shared memory of the split-TF32 forward's block: two stages of split
#: 64-key tiles (K's hi and lo, V^T's hi and lo), two of landing tiles,
#: the stages' key tables, 1024 bytes of alignment room
K1_F32_FWD_SMEM = 1024 + 12 * 64 * 64 * 4 + 4 * 8 * 64


def _k1_f32_fwd_check(card, tag, q, k, v, seg, **kw):
    """The fp32 forward against its plain version: o within fp32's limit
    elementwise, the LSE within 1e-5 on rows with keys (-inf on the same
    rows), the launch counted under its kernel; two calls give the same
    bits. Returns o's elementwise error and the launch."""
    from repro_torch.kernels.flash_attention_packed import (
        fwd_kernel, last_fwd_launch)
    (o, lse), (ro, rlse) = _k1_forward(card, q, k, v, seg, **kw)
    launch = last_fwd_launch()
    err = ((o - ro).abs() / ro.abs().clamp_min(1.0)).max().item()
    fin = torch.isfinite(rlse)
    lse_err = (lse[fin] - rlse[fin]).abs().max().item() if fin.any() else 0.
    print(f"K1 fp32 fwd {tag} ({fwd_kernel(q.dtype, q.shape[-1])}): o "
          f"{err:.3g}, lse {lse_err:.3g}, launch {launch}")
    assert err <= TOL[torch.float32], (tag, err)
    assert torch.equal(fin, torch.isfinite(lse)), tag
    assert lse_err <= 1e-5, (tag, lse_err)
    (o2, lse2), _ = _k1_forward(card, q, k, v, seg, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2), tag
    return err, launch


@pytest.mark.cuda
@pytest.mark.parametrize("B,Sq", [(8, 1500), (8, 448)])
def test_k1_f32_forward_at_whisper_training_shapes(card, B, Sq):
    """The split-TF32 forward at whisper-small's training shapes (8 rows;
    the encoder's 1500 x 1500 and the cross-attention's 448 over 1500
    frames, 12:12 heads of 64, full): within 1e-4 of the plain version,
    the same bits on every call, launched as a block of 256 threads per
    (query head, 128 queries, row) with K1_F32_FWD_SMEM bytes of shared
    memory, counted under packed_fwd_f32_kernel."""
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed)
    rng = np.random.default_rng(B * Sq)
    q, k, v, _ = _k1_f32(card, rng, B, Sq, 1500, 12, 12)
    seg = np.zeros((B, Sq), np.int32)
    flash_attention_packed.launches_by = {}
    _, launch = _k1_f32_fwd_check(
        card, f"whisper {B}x{Sq}", q, k, v, seg, mode="full",
        kv_segment_ids=torch.zeros(B, 1500, dtype=torch.int32, device=card))
    assert flash_attention_packed.launches_by == {
        "packed_fwd_f32_kernel full": 2}
    assert launch == dict(grid=(12, -(-Sq // 128), B), threads=256,
                          smem_bytes=K1_F32_FWD_SMEM), launch


@pytest.mark.cuda
def test_k1_f32_forward_at_the_longest_packed_row(card):
    """The longest row the main paths build, a 4096-token packed bucket
    with 256-token frames at 12:2 causal (64 live key tiles for its last
    rows), in fp32 at head_dim 64: O summed on the tensor cores over the
    whole walk stays within 1e-4 of the plain version (the reading is
    printed)."""
    rng = np.random.default_rng(44)
    q, k, v, _ = _k1_f32(card, rng, 1, 4096, 4096, 12, 2)
    seg, span = _frames(4096)
    _k1_f32_fwd_check(card, "4096 causal 12:2 spans", q, k, v, seg,
                      span_ids=torch.from_numpy(span).to(card))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 160])
def test_k1_f32_forward_head_dims_128_160_run_the_cuda_core_kernel(card, D):
    """fp32 at head_dim 128 and 160 keeps the CUDA-core forward: a block
    of 128 threads per (64 queries, query head, row), counted under
    packed_fwd_f32_cc_kernel; within 1e-4 of the plain version."""
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed)
    rng = np.random.default_rng(45)
    B, S = 2, 700
    seg, span = _packed_tables(B, S, [300, 37, 250, 1], True, frame=40)
    q, k, v, _ = _k1_f32(card, rng, B, S, S, *K1_HEADS[D], D)
    flash_attention_packed.launches_by = {}
    _, launch = _k1_f32_fwd_check(card, f"D={D}", q, k, v, seg,
                                  span_ids=torch.from_numpy(span).to(card))
    assert flash_attention_packed.launches_by == {
        "packed_fwd_f32_cc_kernel causal": 2}
    assert launch["grid"] == (-(-S // 64), K1_HEADS[D][0], B), launch
    assert launch["threads"] == 128, launch


#: shared memory of the mma.sync backward's blocks (fp32, head_dim 128
#: and 160; both kernels): the two fixed [64][D] tiles, two stages of two
#: walked [32][D] tiles, the eight warps' S and dP partials (16 x 32 each),
#: two stages of the walked rows' four tables and the fixed rows' four
def _k1_f32_mma_smem(D):
    return 4 * (2 * 64 * D + 4 * 32 * D + 8 * 2 * 16 * 32 + 8 * 32 + 4 * 64)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 160])
def test_k1_f32_backward_head_dims_128_160_run_the_mma_kernels(card, D):
    """fp32's backward at head_dim 128 (internvl3-2b's 12:2 heads) and
    160 (pixtral-12b's 32:8) runs the split-TF32 kernels by mma.sync:
    packed_bwd_f32_mma_kernel a block of 256 threads per (query head, 64
    keys, row), its heads' dK / dV in fp32 scratch [2, B, Sk, H, D]
    before the group sum, then packed_bwd_f32_mma_dq_kernel per (query
    head, 64 queries, row), each with _k1_f32_mma_smem(D) bytes of shared
    memory (165,888 at 128, 198,656 at 160), counted under both names;
    within 1e-4 of the plain version."""
    from repro_torch.kernels.flash_attention_packed import (
        bwd_kernels, flash_attention_packed, last_bwd_dq_launch,
        last_bwd_kv_launch)
    rng = np.random.default_rng(46)
    B, S = 2, 700
    H, Hkv = K1_HEADS[D]
    seg, span = _packed_tables(B, S, [300, 37, 250, 1], True, frame=40)
    q, k, v, do = _k1_f32(card, rng, B, S, S, H, Hkv, D)
    assert bwd_kernels(torch.float32, D) == (
        "packed_bwd_f32_mma_kernel", "packed_bwd_f32_mma_dq_kernel")
    flash_attention_packed.launches_by = {}
    got, want, _ = _k1_grads(card, q, k, v, do, seg,
                             span_ids=torch.from_numpy(span).to(card))
    kv, dq = last_bwd_kv_launch(), last_bwd_dq_launch()
    _k1_f32_close(f"mma D={D}", got, want)
    print(f"K1 fp32 bwd D={D} launches: dK/dV {kv}, dQ {dq}")
    assert flash_attention_packed.launches_by == {
        "packed_fwd_f32_cc_kernel causal": 1,
        "packed_bwd_f32_mma_kernel causal": 1,
        "packed_bwd_f32_mma_dq_kernel causal": 1}
    smem = _k1_f32_mma_smem(D)
    assert smem == {128: 165888, 160: 198656}[D]
    assert kv == dict(grid=(H, -(-S // 64), B), threads=256, smem_bytes=smem,
                      work_bytes=2 * B * S * H * D * 4), kv
    assert dq == dict(grid=(H, -(-S // 64), B), threads=256,
                      smem_bytes=smem), dq


def _k1_f32(card, rng, B, Sq, Sk, H, Hkv, D=64):
    q, do = (torch.from_numpy(rng.standard_normal((B, Sq, H, D)).astype(
        np.float32)).to(card) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Sk, Hkv, D)).astype(
        np.float32)).to(card) for _ in range(2))
    return q, k, v, do


def _k1_f32_close(tag, got, want):
    """fp32's gradient limit, elementwise."""
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        err = ((a - r).abs() / r.abs().clamp_min(1.0)).max().item()
        print(f"K1 fp32 bwd {tag} {name}: {err:.3g}")
        assert err <= GRAD_TOL[torch.float32], (tag, name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("D,H,Hkv,spans", [
    pytest.param(64, 12, 12, False, id="12-False"),
    pytest.param(64, 12, 2, True, id="2-True"),
    pytest.param(128, 12, 2, True, id="D128-2-True"),
    pytest.param(128, 12, 12, False, id="D128-12-False"),
    pytest.param(160, 32, 8, True, id="D160-8-True")])
def test_k1_f32_backward_gives_the_same_bits_on_every_call(card, D, H, Hkv,
                                                           spans):
    """fp32's split-TF32 backward writes dK and dV once a (key, KV head),
    summed over the group's heads in order (at head_dim 64 along one
    walk, at 128 and 160 from each query head's own after it), and dQ
    once a (query, head) from its own kernel: two calls give the same
    bits in all three, at head_dim 64 at whisper-small's 12:12 heads and
    at 12:2, at 128 at internvl3-2b's 12:2 and at 12:12, at 160 at
    pixtral-12b's 32:8, with spans and several segments."""
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed_bwd)
    rng = np.random.default_rng(34)
    B, S = 2, 700
    seg, span = _packed_tables(B, S, [300, 37, 250, 1], spans, frame=40)
    q, k, v, do = _k1_f32(card, rng, B, S, S, H, Hkv, D)
    kw = dict(mode="causal")
    if spans:
        kw["span_ids"] = torch.from_numpy(span).to(card)
    got, want, (o, lse, segt) = _k1_grads(card, q, k, v, do, seg, **kw)
    _k1_f32_close(f"determinism D={D} {H}:{Hkv}", got, want)
    again = flash_attention_packed_bwd(q, k, v, o, lse, do, segt, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("D,H,Hkv", [
    pytest.param(64, 12, 12, id="12"), pytest.param(64, 12, 2, id="2"),
    pytest.param(128, 12, 2, id="D128-2"),
    pytest.param(160, 32, 8, id="D160-8")])
def test_k1_f32_backward_rows_without_keys_are_zero(card, D, H, Hkv):
    """fp32 at head_dim 64, 128 and 160: a ring hop whose keys hold no
    token of one query segment (its rows have LSE -inf) and padding on
    both sides: those rows of dq, and the rows of dk / dv no query sees,
    are exactly 0; the rest match the plain version."""
    rng = np.random.default_rng(35)
    B, Sq, Sk = 1, 300, 200
    seg = np.full((B, Sq), -1, np.int32)
    seg[0, :120], seg[0, 120:250] = 0, 1          # segment 1: no keys
    kseg = np.full((B, Sk), -2, np.int32)
    kseg[0, :150] = 0                             # kv padding after 150
    q, k, v, do = _k1_f32(card, rng, B, Sq, Sk, H, Hkv, D)
    kw = dict(kv_segment_ids=torch.from_numpy(kseg).to(card),
              kv_offset=-Sk)
    got, want, (_, lse, _) = _k1_grads(card, q, k, v, do, seg, **kw)
    _k1_f32_close(f"no keys D={D} {H}:{Hkv}", got, want)
    assert torch.isinf(lse[0, :, 120:]).all()
    assert torch.isfinite(lse[0, :, :120]).all()
    assert (got[0][0, 120:] == 0).all()
    assert (got[1][0, 150:] == 0).all() and (got[2][0, 150:] == 0).all()


@pytest.mark.cuda
def test_audio_train_step_on_the_card_equals_the_cpu(card):
    """One reduced whisper-small step of `make_train_step` (fp32, TF32
    off) on the card, through K1's kernels (the encoder and the cross-
    attention fp32 full, the decoder fp32 causal), against the same step
    on the CPU through their plain versions: loss and grad_norm within
    1e-4 relative; every parameter after AdamW within 2 lr of the CPU's,
    and at most 10 elements more than 1e-4 apart (the first step is lr
    times the gradient's sign, which a gradient near 0 may flip)."""
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed)
    from repro_torch.training import AdamW, TrainState, make_train_step
    from repro_torch.training.optimizer import tree_leaves
    cfg, params, on_card, _ = _whisper(card)
    batch = {k: torch.from_numpy(v)
             for k, v in synthetic_batch(cfg, 4, 12, seed=1).items()}
    step = make_train_step(cfg, AdamW())
    want_state, want = step(TrainState(params), batch)
    prev = torch.get_float32_matmul_precision()
    flash_attention_packed.launches_by = {}
    try:
        torch.set_float32_matmul_precision("highest")
        got_state, got = step(TrainState(on_card),
                              {k: v.to(card) for k, v in batch.items()})
        torch.cuda.synchronize()
    finally:
        torch.set_float32_matmul_precision(prev)
    L, n = cfg.n_layers, cfg.encdec.n_enc_layers + cfg.n_layers
    assert flash_attention_packed.launches_by == {
        "packed_fwd_f32_kernel full": n, "packed_bwd_f32_kernel full": n,
        "packed_bwd_f32_dq_kernel full": n,
        "packed_fwd_f32_kernel causal": L,
        "packed_bwd_f32_kernel causal": L,
        "packed_bwd_f32_dq_kernel causal": L}
    for name in ("loss", "grad_norm"):
        a, b = float(got[name]), float(want[name])
        assert abs(a - b) <= 1e-4 * abs(b), (name, a, b)
    loose = 0
    for a, b in zip(tree_leaves(got_state.params),
                    tree_leaves(want_state.params)):
        diff = (a.cpu() - b).abs()
        assert diff.max().item() <= 2 * 3e-4 + 1e-6
        loose += int((diff > 1e-4).sum())
    assert loose <= 10, loose


@pytest.mark.cuda
@pytest.mark.parametrize("frames_dtype,full_kernel", [
    (torch.float32, "flash_fwd_f32_kernel"),
    (torch.bfloat16, "flash_fwd_wg_kernel")])
def test_audio_forward_launches_by_kernel_and_mode(card, frames_dtype,
                                                   full_kernel):
    """Reduced whisper-small with bf16 parameters: fp32 frames run the
    encoder and the cross-attention through K2's fp32 kernel (the
    reference promotes them), bf16 frames through the bf16 one; the
    decoder's causal self-attention runs the bf16 kernel either way.
    The wrapper counts each launch under its kernel and mode."""
    from repro_torch.models import model as tm
    cfg, _, on_card, frames = _whisper(card)
    cfg = cfg.with_(param_dtype="bfloat16")
    on_card = _to(on_card, torch.bfloat16)
    tokens = torch.zeros(2, 5, dtype=torch.long, device=card)
    flash_attention.launches_by = {}
    with torch.no_grad():
        logits, _ = tm.forward(on_card, cfg, {
            "tokens": tokens, "frames": frames.to(card, frames_dtype)})
    torch.cuda.synchronize()
    n_enc, n_dec = cfg.encdec.n_enc_layers, cfg.n_layers
    assert flash_attention.launches_by == {
        f"{full_kernel} full": n_enc + n_dec,
        "flash_fwd_wg_kernel causal": n_dec}
    assert torch.isfinite(logits).all()
