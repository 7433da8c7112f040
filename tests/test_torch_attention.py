"""The port's attention against the JAX package: the plain version of the
flash-attention kernel (K2) vs the Pallas kernel run in interpret mode,
the chunked-prefill and decode cores, and the projection + RoPE block.
Inputs come from numpy seeds; fp32 throughout, atol 1e-5 (the two sides
sum in different orders)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels.flash_attention import flash_attention_flat
from repro.kernels.ops import flash_attention as jax_flash
from repro.models import attention as jattn
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.models import attention as tattn

ATOL = 1e-5


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _qkv(B, Sq, H, Hkv, D, Sk=None, seed=0):
    rng = np.random.default_rng(seed)
    Sk = Sk or Sq
    return (_randn(rng, B, Sq, H, D), _randn(rng, B, Sk, Hkv, D),
            _randn(rng, B, Sk, Hkv, D))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ------------------------------------------------------- plain K2 vs Pallas
@pytest.mark.parametrize("mode,window", [("causal", None), ("full", None),
                                         ("sliding", 48)])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D", [
    (2, 128, 128, 4, 2, 32),     # GQA, block-aligned
    (1, 100, 100, 4, 1, 64),     # unaligned lengths, one KV head
    (1, 96, 160, 2, 2, 32),      # Sq != Sk
])
def test_plain_flash_matches_pallas(mode, window, B, Sq, Sk, H, Hkv, D):
    q, k, v = _qkv(B, Sq, H, Hkv, D, Sk)
    ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    mode=mode, window=window, block_q=64, block_k=64)
    out = flash_attention_ref(*_t(q, k, v), mode=mode, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("kv_offset", [-64, 128])
def test_plain_flash_kv_offset_matches_pallas(kv_offset):
    """A ring hop: every key in the past (-64) or all in the future
    (+128, zeros through the l guard)."""
    q, k, v = _qkv(1, 128, 1, 1, 32, seed=1)
    flat = [jnp.asarray(a[:, :, 0]) for a in (q, k, v)]
    ref = flash_attention_flat(*flat, mode="causal", block_q=64,
                               block_k=64, kv_offset=kv_offset)
    out = flash_attention_ref(*_t(q, k, v), mode="causal",
                              kv_offset=kv_offset)
    np.testing.assert_allclose(out.numpy()[:, :, 0], np.asarray(ref),
                               atol=ATOL)
    if kv_offset > 0:
        assert not out.any()


def test_plain_flash_rows_without_keys_are_zero():
    """kv_offset=+40: queries 0..39 see no key. The Pallas kernel gives
    those rows exp(-1e30 - -1e30) = 1 weights (a uniform average); the
    port returns exact zeros there and agrees everywhere else."""
    q, k, v = _qkv(1, 128, 1, 1, 32, seed=2)
    flat = [jnp.asarray(a[:, :, 0]) for a in (q, k, v)]
    ref = np.asarray(flash_attention_flat(*flat, mode="causal",
                                          block_q=64, block_k=64,
                                          kv_offset=40))
    out = flash_attention_ref(*_t(q, k, v), mode="causal",
                              kv_offset=40).numpy()[:, :, 0]
    assert not out[:, :40].any()
    np.testing.assert_allclose(out[:, 40:], ref[:, 40:], atol=ATOL)


def test_wrapper_on_cpu_runs_the_plain_version_uncounted():
    q, k, v = _t(*_qkv(1, 64, 4, 2, 32, seed=3))
    before = flash_attention.launches
    out = flash_attention(q, k, v, mode="causal")
    assert flash_attention.launches == before
    torch.testing.assert_close(out, flash_attention_ref(q, k, v),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_wrapper_on_cuda_launches_the_kernel():
    """On CUDA tensors the wrapper launches the kernel (counted) and
    agrees with the plain version; skips without a GPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, k, v = [t.cuda() for t in _t(*_qkv(2, 100, 4, 2, 64, seed=5))]
    before = flash_attention.launches
    out = flash_attention(q, k, v, mode="causal", kv_offset=-7)
    assert flash_attention.launches == before + 1
    ref = flash_attention_ref(q, k, v, mode="causal", kv_offset=-7)
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-4)


@pytest.mark.parametrize("bad", ["mode", "window", "heads"])
def test_wrapper_rejects_bad_arguments(bad):
    q, k, v = _t(*_qkv(1, 64, 4, 2, 32, seed=4))
    kw = {"mode": "causal"}
    if bad == "mode":
        kw["mode"] = "diagonal"
    elif bad == "window":
        kw["mode"] = "sliding"
    else:
        k = k.repeat(1, 1, 2, 1)[:, :, :3]
        v = v.repeat(1, 1, 2, 1)[:, :, :3]
    with pytest.raises(ValueError):
        flash_attention(q, k, v, **kw)


# ------------------------------------------------- serving-path cores
def _spans(rng, B, n):
    t = np.full((B, n), -1, np.int32)
    t[:, 4:12] = 0
    t[:, 20:26] = 1
    return t


@pytest.mark.parametrize("with_spans", [False, True])
def test_attn_prefill_chunk_matches_jax(with_spans):
    rng = np.random.default_rng(6)
    B, C, H, Hkv, D, T, start = 2, 8, 4, 2, 32, 40, 16
    q = _randn(rng, B, C, H, D)
    kc, vc = _randn(rng, B, T, Hkv, D), _randn(rng, B, T, Hkv, D)
    kw_j, kw_t = {}, {}
    if with_spans:
        cache_spans = _spans(rng, B, T)
        cache_spans[:, start:start + 4] = 2          # block inside chunk
        chunk_spans = cache_spans[:, start:start + C]
        kw_j = dict(chunk_span_ids=jnp.asarray(chunk_spans),
                    cache_span_ids=jnp.asarray(cache_spans))
        kw_t = dict(chunk_span_ids=torch.from_numpy(chunk_spans),
                    cache_span_ids=torch.from_numpy(cache_spans))
    ref = jattn.attn_prefill_chunk(jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), start, **kw_j)
    out = tattn.attn_prefill_chunk(*_t(q, kc, vc), start, **kw_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_attn_decode_matches_jax():
    rng = np.random.default_rng(7)
    B, H, Hkv, D, T = 3, 4, 2, 32, 24
    q = _randn(rng, B, 1, H, D)
    kc, vc = _randn(rng, B, T, Hkv, D), _randn(rng, B, T, Hkv, D)
    valid = np.array([1, 13, 24], np.int32)
    ref = jattn.attn_decode(jnp.asarray(q), jnp.asarray(kc),
                            jnp.asarray(vc), jnp.asarray(valid))
    out = tattn.attn_decode(*_t(q, kc, vc), torch.from_numpy(valid))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_attn_reference_with_tables_matches_jax():
    rng = np.random.default_rng(8)
    q, k, v = _qkv(2, 32, 4, 2, 32, seed=8)
    seg = np.repeat(np.array([[0] * 20 + [1] * 8 + [-1] * 4]), 2, 0)
    span = _spans(rng, 2, 32)
    ref = jattn.attn_reference(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), mode="causal",
                               segment_ids=jnp.asarray(seg),
                               span_ids=jnp.asarray(span))
    out = tattn.attn_reference(*_t(q, k, v), mode="causal",
                               segment_ids=torch.from_numpy(seg),
                               span_ids=torch.from_numpy(span))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("rope_frac", [1.0, 0.5])
def test_attention_block_cuda_impl_matches_pallas(rope_frac):
    """Projections + interleaved RoPE + the K2 dispatch (plain version on
    CPU) vs the JAX block with impl='pallas'."""
    d, H, Hkv, D = 64, 4, 2, 16
    p = jattn.init_attention(jax.random.PRNGKey(0), d, H, Hkv, D,
                             jnp.float32)
    x = np.random.default_rng(9).standard_normal((2, 24, d)).astype(
        np.float32)
    kw = dict(n_heads=H, kv_heads=Hkv, head_dim=D, rope_theta=10_000.0,
              rope_frac=rope_frac, mode="causal", return_kv=True)
    ref, (rk, rv) = jattn.attention(p, jnp.asarray(x), impl="pallas", **kw)
    out, (k, v) = tattn.attention(
        params_from_numpy(jax.tree.map(np.asarray, p)),
        torch.from_numpy(x), impl="cuda", **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(k.numpy(), np.asarray(rk), atol=ATOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(rv), atol=ATOL)
