"""The packed attention kernel K1's plain versions against the JAX package.

Forward: the port's `flash_attention_packed_ref` (what the wrapper runs
on CPU tensors) vs the Pallas `flash_attention_packed_flat` in interpret
mode and `kernels/ref.flash_attention_packed_ref`, over the cases of
tests/test_packed.py and tests/test_modality.py: causal/full/sliding,
1..8 uneven segments with tail padding (exact zeros), per-row tables with
GQA, interleaved bidirectional spans, and ring-hop inputs (the
neighbour's segment/span tables and `kv_offset`). Backward: the wrapper's
gradient vs `jax.grad` of `attn_reference` with the same tables. LSE vs
the JAX chunked core's. fp32, atol 1e-4 (the JAX tests' tolerance: sums
in different orders)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels.flash_attention import flash_attention_packed_flat
from repro.kernels.ops import flash_attention_packed as jax_packed_ops
from repro.kernels.ref import flash_attention_packed_ref as jax_packed_ref
from repro.models.attention import _attn_chunked_fwd_impl, attn_reference
from repro_torch.kernels.flash_attention_packed import (
    flash_attention_packed, flash_attention_packed_bwd,
    flash_attention_packed_ref)

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

ATOL = 1e-4
SEGMENT_SETS = [
    [64], [37, 27], [5, 60, 3], [17, 1, 29, 13],
    [9, 9, 9, 9, 9, 9, 9, 9], [31, 2, 19, 7, 11, 23, 3, 24],
]
MODES = [("causal", None), ("full", None), ("sliding", 8)]


def _seg(lens, S):
    seg = np.full(S, -1, np.int32)
    off = 0
    for i, L in enumerate(lens):
        seg[off:off + L] = i
        off += L
    return seg


def _spans(lens, S, frame=8):
    """Bidirectional frames of `frame` tokens after every text block of
    frame // 2 tokens, ids unique in the buffer; -1 elsewhere."""
    span = np.full(S, -1, np.int32)
    off, sid = 0, 0
    for L in lens:
        p = frame // 2
        while p < L:
            f = min(frame, L - p)
            span[off + p:off + p + f] = sid
            sid += 1
            p += f + frame // 2
        off += L
    return span


def _flat_inputs(S, BH=2, D=32, Sk=None, seed=0):
    """[BH, S, D] arrays; the port sees them as [1, S, BH, D] (one KV
    head per query head)."""
    rng = np.random.default_rng(seed)
    Sk = Sk or S
    return (rng.standard_normal((BH, S, D)).astype(np.float32),
            rng.standard_normal((BH, Sk, D)).astype(np.float32),
            rng.standard_normal((BH, Sk, D)).astype(np.float32))


def _model(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(1, 0, 2))[None])


def _flat(o):
    return o[0].numpy().transpose(1, 0, 2)


def _t(a):
    return None if a is None else torch.from_numpy(a)


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("mode,window", MODES)
@pytest.mark.parametrize("lens", SEGMENT_SETS,
                         ids=[f"{len(s)}seg" for s in SEGMENT_SETS])
@pytest.mark.parametrize("with_spans", [False, True],
                         ids=["nospan", "span"])
def test_plain_packed_matches_pallas_and_ref(mode, window, lens,
                                             with_spans):
    S = sum(lens) + 13                          # tail padding
    seg = _seg(lens, S)
    span = _spans(lens, S) if with_spans else None
    q, k, v = _flat_inputs(S)
    kw = dict(mode=mode, window=window)
    jspan = None if span is None else jnp.asarray(span)
    pallas = flash_attention_packed_flat(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg),
        span_ids=jspan, block_q=32, block_k=32, **kw)
    ref = jax_packed_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         jnp.asarray(seg), span_ids=jspan, **kw)
    out, lse = flash_attention_packed(_model(q), _model(k), _model(v),
                                      _t(seg), span_ids=_t(span),
                                      return_lse=True, **kw)
    np.testing.assert_allclose(_flat(out), np.asarray(pallas), atol=ATOL)
    np.testing.assert_allclose(_flat(out), np.asarray(ref), atol=ATOL)
    pad = sum(lens)
    assert not out[:, pad:].any()               # padding rows: exact zeros
    assert torch.isinf(lse[..., pad:]).all()
    assert torch.isfinite(lse[..., :pad]).all()


@pytest.mark.parametrize("with_spans", [False, True])
def test_plain_packed_gqa_per_row_tables_match_jax(with_spans):
    """[B,S,H,D] layout, 4 query heads over 2 KV heads read in place,
    one table per batch row (4 x 16 segments; 1 segment + padding)."""
    B, S, H, Hkv, D = 2, 64, 4, 2, 16
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = [rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
            for _ in range(2)]
    seg = np.stack([np.repeat(np.arange(4), 16),
                    np.r_[np.zeros(50, int), -np.ones(14, int)]]
                   ).astype(np.int32)
    span = (np.stack([_spans([16] * 4, S), _spans([50], S)])
            if with_spans else None)
    want = jax_packed_ops(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(seg), mode="causal",
                          span_ids=None if span is None
                          else jnp.asarray(span))
    out = flash_attention_packed(_t(q), _t(k), _t(v), _t(seg),
                                 span_ids=_t(span), mode="causal")
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("mode,window", MODES)
@pytest.mark.parametrize("with_spans", [False, True])
@pytest.mark.parametrize("kv_offset", [-40, 24])
def test_plain_packed_ring_hop_matches_pallas(mode, window, with_spans,
                                              kv_offset):
    """A ring hop: queries of one shard against the neighbour's keys,
    which sit `kv_offset` positions away and bring their own segment
    and span tables (kv padding is -2)."""
    lens = [30, 50, 40]
    S = 128
    full_seg, full_span = _seg(lens, S), _spans(lens, S)
    qs = slice(64, 128)
    ks = slice(64 + kv_offset, 128 + kv_offset) if kv_offset < 0 \
        else slice(0, 64)
    seg_q, seg_k = full_seg[qs], full_seg[ks].copy()
    seg_k[seg_k < 0] = -2
    span_q = full_span[qs] if with_spans else None
    span_k = full_span[ks] if with_spans else None
    off = ks.start - qs.start
    q, k, v = _flat_inputs(64, seed=5)
    kw = dict(mode=mode, window=window)
    jt = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    want = flash_attention_packed_flat(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(seg_q),
        kv_segment_ids=jnp.asarray(seg_k), span_ids=jt(span_q),
        kv_span_ids=jt(span_k), kv_offset=off, block_q=32, block_k=32,
        **kw)
    out = flash_attention_packed(
        _model(q), _model(k), _model(v), _t(seg_q),
        kv_segment_ids=_t(seg_k), span_ids=_t(span_q),
        kv_span_ids=_t(span_k), kv_offset=off, **kw)
    # the Pallas kernel leaves a row whose visited tiles are all masked
    # at the mean of V; rows with no valid key are exact zeros here
    valid = np.asarray(flash_attention_packed_ref(
        _model(q), _model(k), _model(v), _t(seg_q),
        kv_segment_ids=_t(seg_k), span_ids=_t(span_q),
        kv_span_ids=_t(span_k), kv_offset=off, **kw)[1][0, 0]
        > -np.inf)
    np.testing.assert_allclose(_flat(out)[:, valid],
                               np.asarray(want)[:, valid], atol=ATOL)
    assert not out[0, ~valid].any()


# --------------------------------------------------------------- backward
def _model_layout_case(lens, S, with_spans, seed):
    B, H, Hkv, D = 1, 4, 2, 16
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k, v = [rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
            for _ in range(2)]
    seg = _seg(lens, S)[None]
    span = _spans(lens, S)[None] if with_spans else None
    return q, k, v, seg, span


@pytest.mark.parametrize("lens", [[23, 41, 9], [64], [17, 9, 29, 13]],
                         ids=["3seg", "1seg", "4seg"])
@pytest.mark.parametrize("with_spans", [False, True])
def test_packed_gradient_matches_jax_grad_of_attn_reference(lens,
                                                            with_spans):
    valid = sum(lens)
    S = valid + 13
    q, k, v, seg, span = _model_layout_case(lens, S, with_spans, 7)
    jspan = None if span is None else jnp.asarray(span)

    def jloss(a, b, c):
        o = attn_reference(a, b, c, mode="causal",
                           segment_ids=jnp.asarray(seg), span_ids=jspan)
        return (o[:, :valid] ** 2).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o = flash_attention_packed(tq, tk, tv, _t(seg), span_ids=_t(span),
                               mode="causal")
    (o[:, :valid] ** 2).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    # the backward wrapper (the kernel's plain version here) agrees
    do = torch.zeros_like(o)
    do[:, :valid] = 2 * o.detach()[:, :valid]
    o2, lse = flash_attention_packed(*(t.detach() for t in (tq, tk, tv)),
                                     _t(seg), span_ids=_t(span),
                                     return_lse=True)
    grads = flash_attention_packed_bwd(
        *(t.detach() for t in (tq, tk, tv)), o2, lse, do, _t(seg),
        span_ids=_t(span))
    for got, ref in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("mode,window", MODES)
@pytest.mark.parametrize("with_spans", [False, True])
def test_plain_backward_uses_the_o_and_lse_it_is_given(mode, window,
                                                       with_spans):
    """The plain backward forms P from the `lse` and delta from the `o`
    it is given, as the kernel does. With the call's own o and lse it is
    the autograd gradient of the plain forward; with the whole
    attention's o and lse, key blocks split as ring hops split them give
    dq's that sum to the whole gradient and dk/dv's that concatenate to
    it (before the repair: dq off by 1.30 against a largest |dq| of
    1.54, fp32, S=64, 4:2 heads of 16, full mode)."""
    lens = [23, 30, 9]
    S = 64
    q, k, v, seg, span = (_t(a) for a in _model_layout_case(
        lens, S, with_spans, 13))
    do = torch.from_numpy(np.random.default_rng(14).standard_normal(
        q.shape).astype(np.float32))
    kw = dict(mode=mode, window=window, span_ids=span)
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    o, lse = flash_attention_packed(qr, kr, vr, seg, return_lse=True, **kw)
    want = torch.autograd.grad(o, (qr, kr, vr), do)
    o = o.detach()
    own = flash_attention_packed_bwd(q, k, v, o, lse, do, seg, **kw)
    for got, ref in zip(own, want):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)
    parts = []
    for ks in (slice(0, 24), slice(24, 50), slice(50, S)):
        parts.append(flash_attention_packed_bwd(
            q, k[:, ks], v[:, ks], o, lse, do, seg,
            kv_segment_ids=seg[:, ks],
            kv_span_ids=None if span is None else span[:, ks],
            kv_offset=ks.start, **kw))
    dq = sum(p[0] for p in parts)
    dk, dv = (torch.cat([p[i] for p in parts], dim=1) for i in (1, 2))
    for got, ref in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("with_spans", [False, True])
def test_packed_lse_matches_jax_chunked_core(with_spans):
    lens = [23, 41, 9]
    valid = sum(lens)
    S = valid + 11
    q, k, v, seg, span = _model_layout_case(lens, S, with_spans, 9)
    f = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    _, jlse = _attn_chunked_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), f(seg), f(seg),
        None if span is None else f(span), None if span is None
        else f(span), "causal", None, 0, 0, 32)
    jlse = np.asarray(jlse).reshape(1, S, 4).transpose(0, 2, 1)  # [B,H,S]
    _, lse = flash_attention_packed(_t(q), _t(k), _t(v), _t(seg),
                                    span_ids=_t(span), return_lse=True)
    np.testing.assert_allclose(lse.numpy()[..., :valid],
                               jlse[..., :valid], atol=ATOL)
    assert torch.isinf(lse[..., valid:]).all()


def test_wrapper_on_cpu_runs_plain_uncounted():
    q, k, v, seg, span = _model_layout_case([20, 30], 64, True, 11)
    from repro_torch.kernels import flash_attention_packed as mod
    before = (mod.flash_attention_packed.launches,
              mod.flash_attention_packed_bwd.launches)
    out = flash_attention_packed(_t(q), _t(k), _t(v), _t(seg),
                                 span_ids=_t(span))
    ref, _ = flash_attention_packed_ref(_t(q), _t(k), _t(v), _t(seg),
                                        span_ids=_t(span))
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    assert (mod.flash_attention_packed.launches,
            mod.flash_attention_packed_bwd.launches) == before


@pytest.mark.parametrize("bad", ["mode", "window", "table"])
def test_wrapper_rejects_bad_arguments(bad):
    q, k, v, seg, _ = _model_layout_case([20, 30], 64, False, 12)
    kw = {"mode": "causal"}
    if bad == "mode":
        kw["mode"] = "diagonal"
    elif bad == "window":
        kw["mode"] = "sliding"
    else:
        seg = seg[:, :10]
    with pytest.raises(ValueError):
        flash_attention_packed(_t(q), _t(k), _t(v), _t(seg), **kw)
