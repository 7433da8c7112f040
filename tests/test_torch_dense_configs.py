"""The remaining dense and VLM configs against the JAX package, on the CPU.

  * every config of the port equals the JAX package's field by field, and
    `ALL_ARCHS` holds every JAX arch, whisper-small's encoder-decoder
    sub-config included;
  * head_dim 160 (pixtral-12b: 5120 / 32 heads): the plain K1 forward and
    its gradient, and the plain K2, at 4 query heads over one KV head
    (pixtral's 32:8 narrowed), against the Pallas kernels in interpret
    mode and `jax.grad` of `attn_reference`;
  * reduced chatglm3-6b (`rope_2d`, 2 KV heads) and reduced pixtral-12b
    at `head_dim=160` with 2 KV heads: two `Engine.train` steps against
    the JAX `Engine.train` on the same weights (losses 2e-5; the first
    batch's gradient, and the next batch's at the parameters the JAX
    steps reach, 1e-4), and `Engine.serve`'s tokens equal to the JAX
    package's. The parameters themselves are not held: AdamW divides
    each moment by its root mean square, so an element whose gradient is
    as small as the engines' difference may step up to 2 lr apart.

fp32 throughout; atol 1e-4 (sums in different orders). Each JAX
reference runs once a module (module fixtures).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.api import Engine as JaxEngine
from repro.configs import ALL_ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import HeterogeneousLoader as JaxLoader
from repro.kernels.flash_attention import flash_attention_flat
from repro.kernels.ops import flash_attention as jax_flash
from repro.kernels.ops import flash_attention_packed as jax_packed
from repro.models.attention import attn_reference
from repro_torch.api import Engine
from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import HeterogeneousLoader
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention_packed import (
    flash_attention_packed, flash_attention_packed_bwd)
from repro_torch.training import TrainState

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

ATOL = 1e-4
LOSS_TOL, GRAD_TOL = 2e-5, 1e-4
RUN = dict(dataset="openvid", global_batch=4, max_tokens=256,
           tokens_per_frame=16)
#: the port's defaults that differ from the JAX package's on purpose:
#: its kernels run by default, and remat is on only where a config needs
#: it on the card
PORT_DEFAULTS = ("attn_impl", "remat")


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("which", ["full", "reduced"])
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_matches_jax(arch, which):
    ours, theirs = get_config(arch), jax_get_config(arch)
    if which == "reduced":
        ours, theirs = ours.reduced(), theirs.reduced()
    for f in dataclasses.fields(ours):
        if f.name in PORT_DEFAULTS and which == "full":
            continue
        mine, want = getattr(ours, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(mine):
            assert dataclasses.asdict(mine) == dataclasses.asdict(want), \
                (arch, f.name)
        else:
            assert mine == want, (arch, f.name)
    assert ours.resolved_head_dim == theirs.resolved_head_dim


def test_every_jax_arch_is_ported():
    assert sorted(ALL_ARCHS) == sorted(JAX_ARCHS)
    assert len(ALL_ARCHS) == 12
    enc = get_config("whisper-small").encdec
    assert dataclasses.asdict(enc) == dataclasses.asdict(
        jax_get_config("whisper-small").encdec)
    assert (enc.n_enc_layers, enc.n_audio_frames) == (12, 1500)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("whisper-large")
    # the reference keeps pixtral-12b at 5120 / 32 = 160 (the published
    # model sets 128): the port copies the reference
    assert get_config("pixtral-12b").resolved_head_dim == 160


# ------------------------------------------------- kernels at D = 160
def _segments(lens, S):
    seg = np.full(S, -1, np.int32)
    off = 0
    for i, L in enumerate(lens):
        seg[off:off + L] = i
        off += L
    return seg


def _qkv(B, Sq, H, Hkv, D, seed, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = Sk or Sq
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))]


@pytest.mark.parametrize("mode,window", [("causal", None), ("full", None),
                                         ("sliding", 40)])
def test_plain_k1_at_head_dim_160_matches_pallas(mode, window):
    """4 query heads over one KV head of 160, three segments and tail
    padding over 192 rows, causal with spans of 24-token frames."""
    S, lens = 192, [90, 41, 50]
    seg = _segments(lens, S)[None]
    span = np.full((1, S), -1, np.int32)
    span[0, 10:34], span[0, 100:124] = 0, 1
    q, k, v = _qkv(1, S, 4, 1, 160, 11)
    jspan = jnp.asarray(span) if mode != "full" else None
    want = jax_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      jnp.asarray(seg), mode=mode, window=window,
                      span_ids=jspan, block_q=64, block_k=64)
    out = flash_attention_packed(
        *(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(seg),
        mode=mode, window=window,
        span_ids=None if jspan is None else torch.from_numpy(span))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL)
    assert not out[:, sum(lens):].any()


@pytest.mark.parametrize("with_spans", [False, True])
def test_plain_k1_gradient_at_head_dim_160_matches_jax_grad(with_spans):
    """The autograd gradient and the backward wrapper (the kernel's
    plain version here) vs `jax.grad` of `attn_reference` over the same
    tables."""
    lens = [70, 33, 100]
    valid = sum(lens)
    S = valid + 11
    seg = _segments(lens, S)[None]
    span = None
    if with_spans:
        span = np.full((1, S), -1, np.int32)
        span[0, 8:40], span[0, 120:150] = 0, 1
    q, k, v = _qkv(1, S, 4, 1, 160, 12)
    jspan = None if span is None else jnp.asarray(span)

    def jloss(a, b, c):
        o = attn_reference(a, b, c, mode="causal",
                           segment_ids=jnp.asarray(seg), span_ids=jspan)
        return (o[:, :valid] ** 2).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tspan = None if span is None else torch.from_numpy(span)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o = flash_attention_packed(tq, tk, tv, torch.from_numpy(seg),
                               span_ids=tspan)
    (o[:, :valid] ** 2).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    o2, lse = flash_attention_packed(
        *(t.detach() for t in (tq, tk, tv)), torch.from_numpy(seg),
        span_ids=tspan, return_lse=True)
    do = torch.zeros_like(o2)
    do[:, :valid] = 2 * o2[:, :valid]
    grads = flash_attention_packed_bwd(
        *(t.detach() for t in (tq, tk, tv)), o2, lse, do,
        torch.from_numpy(seg), span_ids=tspan)
    for got, ref in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("mode,window", [("causal", None), ("full", None),
                                         ("sliding", 48)])
def test_plain_k2_at_head_dim_160_matches_pallas(mode, window):
    """2 rows of 96, 4 query heads over one KV head of 160."""
    q, k, v = _qkv(2, 96, 4, 1, 160, 13)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     mode=mode, window=window, block_q=64, block_k=64)
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          mode=mode, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL)


def test_plain_k2_at_head_dim_160_with_kv_offset_matches_pallas():
    """A prefill chunk after its cache: 96 queries against 160 keys
    that start 64 positions before them (kv_offset -64)."""
    q, k, v = _qkv(1, 96, 1, 1, 160, 14, Sk=160)
    want = flash_attention_flat(*(jnp.asarray(a[:, :, 0]) for a in
                                  (q, k, v)), mode="causal", block_q=32,
                                block_k=32, kv_offset=-64)
    out = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          mode="causal", kv_offset=-64)
    np.testing.assert_allclose(out.numpy()[:, :, 0], np.asarray(want),
                               atol=ATOL)


# --------------------------------------------- engines: train and serve
#: the reduced configs trained and served here: chatglm3-6b's 2D RoPE
#: over 4:2 heads of 64, and pixtral-12b at head_dim 160 over 4:2 heads
CONFIGS = {
    "chatglm3": lambda get: get("chatglm3-6b").reduced(),
    "d160": lambda get: get("pixtral-12b").reduced().with_(head_dim=160,
                                                           kv_heads=2),
}


def _loader(cls, vocab):
    return cls(RUN["dataset"], RUN["global_batch"], vocab, seed=0,
               max_tokens=RUN["max_tokens"],
               tokens_per_frame=RUN["tokens_per_frame"])


def _third_batch(cls, vocab):
    """The batch after the two that `train(steps=2)` takes."""
    loader = _loader(cls, vocab)
    return [next(loader) for _ in range(3)][-1]


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return np.asarray(tree, np.float32)


def _assert_trees_close(a, b, atol):
    a, b = _np_tree(a), _np_tree(b)
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_close(a[k], b[k], atol)
        else:
            np.testing.assert_allclose(a[k], b[k], atol=atol, err_msg=k)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def jax_run(request):
    """The JAX Engine on one CPU device: the first batch's loss and
    gradient, two training steps, and Engine.serve's tokens from the
    initial weights."""
    jcfg = CONFIGS[request.param](jax_get_config)
    eng = JaxEngine(jcfg, seed=0)
    params0 = jax.tree.map(np.asarray, eng.state.params)
    prompts = np.random.default_rng(5).integers(
        0, jcfg.vocab, size=(2, 14)).astype(np.int32)
    served, _ = eng.serve(jnp.asarray(prompts), gen_tokens=6)
    data0 = next(_loader(JaxLoader, eng.cfg.vocab))
    loss0, grads0 = eng.executor.run_plan(eng.state.params,
                                          eng.plan(data0), data0)
    history = eng.train(steps=2, lookahead=False, **RUN)
    data2 = _third_batch(JaxLoader, eng.cfg.vocab)
    loss2, grads2 = eng.executor.run_plan(eng.state.params,
                                          eng.plan(data2), data2)
    out = dict(name=request.param, params0=params0, prompts=prompts,
               served=np.asarray(served).tolist(), loss0=float(loss0),
               grads0=jax.tree.map(np.asarray, grads0),
               losses=[m.loss for m in history] + [float(loss2)],
               grads2=jax.tree.map(np.asarray, grads2),
               params=jax.tree.map(np.asarray, eng.state.params))
    eng.close()
    return out


def _port_engine(run):
    cfg = CONFIGS[run["name"]](get_config).with_(attn_impl="cuda")
    eng = Engine(cfg, device="cpu", seed=0)
    eng.state = TrainState(params=params_from_numpy(run["params0"]))
    return eng


def test_engine_train_matches_jax(jax_run):
    eng = _port_engine(jax_run)
    assert eng.cfg.family == "dense"        # Engine runs VLM as dense
    data0 = next(_loader(HeterogeneousLoader, eng.cfg.vocab))
    loss0, grads0 = eng.executor.run_plan(eng.state.params,
                                          eng.plan(data0), data0)
    assert abs(float(loss0) - jax_run["loss0"]) <= LOSS_TOL
    _assert_trees_close(grads0, jax_run["grads0"], GRAD_TOL)
    history = eng.train(steps=2, lookahead=False, **RUN)
    assert int(eng.state.opt.step) == 2
    eng.state = TrainState(params=params_from_numpy(jax_run["params"]))
    data2 = _third_batch(HeterogeneousLoader, eng.cfg.vocab)
    loss2, grads2 = eng.executor.run_plan(eng.state.params,
                                          eng.plan(data2), data2)
    eng.close()
    np.testing.assert_allclose([m.loss for m in history] + [float(loss2)],
                               jax_run["losses"], atol=LOSS_TOL)
    _assert_trees_close(grads2, jax_run["grads2"], GRAD_TOL)


def test_engine_serve_matches_jax(jax_run):
    eng = _port_engine(jax_run)
    out, rep = eng.serve(jax_run["prompts"], gen_tokens=6)
    assert out.tolist() == jax_run["served"]
    assert rep["batch"] == 2 and rep["prompt_len"] == 14
