"""The CUDA kernels against their plain versions on the card.

Marked `cuda`: they skip without an NVIDIA GPU (and need nvcc to build
the kernels). This file imports no JAX, so it runs on a machine with
only the port's requirements:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

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
@pytest.mark.parametrize("D", [64, 128])
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
        refs = flash_attention_packed_bwd_ref(q, k, v, do, segt, **kw)
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
