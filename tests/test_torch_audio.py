"""The audio family of the port's model (whisper-small) against the JAX
package, on the CPU.

Reduced whisper-small (2 encoder and 2 decoder layers, d_model 256, 4:4
heads of 64, 16 frames) on the JAX package's weights converted through
`repro_torch.convert`:

  * `layer_norm` (fp32 and bf16 inputs) and the sinusoidal positions
    (`sinusoidal`, `_sinusoidal_at` at a scalar and at a [B] position)
    equal the JAX functions';
  * `init_params` draws the JAX package's tree (keys, shapes, dtypes);
    `synthetic_batch` is the JAX package's, frames included, array for
    array;
  * fp32: `forward` with frames gives the JAX logits (1e-4),
    `prefill_cross_kv` the JAX cross K/V (1e-5), and 12 `decode_step`s
    the JAX logits (1e-4) and the port's own `forward` (2e-3, as
    tests/test_models.py's test_audio_decode_consistency holds the JAX
    package's);
  * K2's plain version at the cross-attention's shapes (full, Sq != Sk)
    equals the Pallas kernel (interpret mode);
  * bf16 parameters: every cache leaf's dtype is the JAX package's, for
    fp32 frames (an fp32 encoder, fp32 cross K/V) and for bf16 frames;
    `forward` and decode logits lie within twice the reference's own
    distance from its fp32 run of the JAX package's;
  * the gradient through the cross-attention alone (K1 at Sq != Sk)
    equals `jax.grad`'s;
  * what does not run: `prefill` and `Engine.train` raise, each with its
    reason.

The JAX side runs its attention through the Pallas kernel in interpret
mode; the port through the kernels' plain versions (`attn_impl="cuda"`
on CPU tensors). Each JAX reference is built once a module.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import InputShape as JaxInputShape
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.kernels.ops import flash_attention as jax_flash
from repro.models import layers as jl
from repro.models import model as jm
from repro_torch.api import Engine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.models import layers as tl
from repro_torch.models import model as tm

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

ATOL = 1e-4
#: prefill_cross_kv's leaves: one encoder pass and a projection
CROSS_ATOL = 1e-5
#: decode_step logits against the port's own forward
FWD_TOL = 2e-3
B, S, CACHE = 2, 12, 32
JCFG = jax_get_config("whisper-small").reduced().with_(attn_impl="pallas")
TCFG = get_config("whisper-small").reduced().with_(attn_impl="cuda")


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _scaled(got, want) -> float:
    """Largest |got - want| / max(1, |want|)."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


def _jax_decode(jp, jcfg, cache, tokens):
    step = jax.jit(lambda p, c, t: jm.decode_step(p, jcfg, c, t))
    out = []
    for t in range(tokens.shape[1]):
        lg, cache = step(jp, cache, jnp.asarray(tokens[:, t]))
        out.append(np.asarray(lg, np.float32))
    return np.stack(out, 1)


def _port_decode(tp, tcfg, cache, tokens):
    out = []
    for t in range(tokens.shape[1]):
        lg, cache = tm.decode_step(tp, tcfg, cache,
                                   torch.from_numpy(tokens[:, t]))
        out.append(lg.float().numpy())
    return np.stack(out, 1), cache


@pytest.fixture(scope="module")
def fp32():
    """JAX params, the same converted, a synthetic batch, and the JAX
    logits, cross K/V and 12 decode logits on it."""
    jp = jm.init_params(jax.random.PRNGKey(0), JCFG)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    batch = synthetic_batch(TCFG, B, S, seed=1)
    logits, _ = jax.jit(lambda p, b: jm.forward(p, JCFG, b))(jp, _j(batch))
    cache = jm.prefill_cross_kv(jp, JCFG, jnp.asarray(batch["frames"]),
                                jm.init_cache(JCFG, B, CACHE))
    decoded = _jax_decode(jp, JCFG, cache, batch["tokens"])
    return dict(jp=jp, tp=tp, batch=batch, logits=np.asarray(logits),
                cache={k: np.asarray(v) for k, v in cache.items()},
                decoded=decoded)


# ------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    want = jl.layer_norm(_j(p), jx, 1e-5)
    got = tl.layer_norm(_t(p), tx, 1e-5)
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == dtype
    # fp32 math in both; bf16 outputs round the same fp32 values
    np.testing.assert_allclose(_np(got), _np(want),
                               atol=1e-5 if dtype == "float32" else 0,
                               rtol=0 if dtype == "float32" else 8e-3)
    init = tl.init_layernorm(48, torch.bfloat16, "cpu", stack=(2,))
    assert {k: (tuple(v.shape), v.dtype) for k, v in init.items()} == {
        "scale": ((2, 48), torch.bfloat16), "bias": ((2, 48), torch.bfloat16)}


@pytest.mark.parametrize("where", ["table", "scalar", "rows"])
def test_sinusoidal_matches_jax(where):
    """The whole table to 1500 frames; one row at a scalar position; the
    rows at a [B] position tensor (the slot cache's one depth a row)."""
    if where == "table":
        got, want = tm.sinusoidal(1500, 768), jm.sinusoidal(1500, 768)
        assert tuple(got.shape) == (1500, 768)
    elif where == "scalar":
        got, want = tm._sinusoidal_at(37, 256), jm._sinusoidal_at(37, 256)
        assert tuple(got.shape) == (256,)
    else:
        pos = np.array([0, 5, 31, 1499])
        got = tm._sinusoidal_at(torch.from_numpy(pos), 256)
        want = jnp.stack([jm._sinusoidal_at(int(p), 256) for p in pos])
        assert tuple(got.shape) == (4, 256)
    assert got.dtype == torch.float32
    # the angles reach 1499 rad, whose fp32 ulp is 1.2e-4: the two
    # libraries' exp may part the inverse frequencies by an ulp, which
    # moves an angle there by about one of its own ulps (1.2e-4 read)
    np.testing.assert_allclose(_np(got), _np(want), atol=2.5e-4, rtol=0)


# --------------------------------------------------------- parameters
def test_init_params_tree_matches_jax():
    for cfg, jcfg in ((TCFG, JCFG),
                      (TCFG.with_(param_dtype="bfloat16"),
                       JCFG.with_(param_dtype="bfloat16"))):
        jp = jax.eval_shape(lambda k: jm.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
        ours = tm.init_params(cfg, seed=0, device="cpu")
        want = jax.tree_util.tree_flatten_with_path(jp)[0]
        got = {jax.tree_util.keystr(p): leaf for p, leaf in
               jax.tree_util.tree_flatten_with_path(ours)[0]}
        assert len(got) == len(want)
        for path, leaf in want:
            t = got[jax.tree_util.keystr(path)]
            assert tuple(t.shape) == leaf.shape, path
            assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
    assert sorted(ours) == ["dec_layers", "embed", "enc_layers", "head",
                            "ln_enc", "ln_f"]
    assert ours["enc_layers"]["attn"]["wq"].shape[0] == 2
    assert sorted(ours["dec_layers"]) == ["attn", "ln1", "ln2", "ln_x",
                                          "mlp", "xattn"]


def test_synthetic_batch_matches_jax():
    ours = synthetic_batch(TCFG, 3, 20, seed=7)
    want = jax_synthetic_batch(JCFG, JaxInputShape("t", 20, 3, "train"),
                               seed=7)
    assert sorted(ours) == sorted(want) == ["frames", "labels", "tokens"]
    for k in want:
        assert ours[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(ours[k], want[k], err_msg=k)
    assert ours["frames"].shape == (3, TCFG.encdec.n_audio_frames,
                                    TCFG.d_model)


# ----------------------------------------------------- fp32 parity
def test_forward_matches_jax(fp32):
    got, aux = tm.forward(fp32["tp"], TCFG, _t(fp32["batch"]))
    assert tuple(got.shape) == (B, S, TCFG.vocab)
    np.testing.assert_allclose(_np(got), fp32["logits"], atol=ATOL)
    assert float(aux) == 0.0
    # the frames reach the logits through the cross-attention
    other = dict(fp32["batch"], frames=fp32["batch"]["frames"][::-1].copy())
    moved, _ = tm.forward(fp32["tp"], TCFG, _t(other))
    assert (moved - got).abs().max() > 1e-2


def test_prefill_cross_kv_matches_jax(fp32):
    cache = tm.init_cache(TCFG, B, CACHE, device="cpu")
    zeros = cache["k"]
    got = tm.prefill_cross_kv(fp32["tp"], TCFG,
                              torch.from_numpy(fp32["batch"]["frames"]),
                              cache)
    assert got["k"] is zeros                # only the cross leaves change
    for name in ("cross_k", "cross_v"):
        want = fp32["cache"][name]
        assert tuple(got[name].shape) == want.shape == (
            TCFG.n_layers, B, TCFG.encdec.n_audio_frames, TCFG.kv_heads,
            TCFG.resolved_head_dim)
        np.testing.assert_allclose(_np(got[name]), want, atol=CROSS_ATOL)


def test_decode_matches_jax_and_forward(fp32):
    cache = tm.prefill_cross_kv(
        fp32["tp"], TCFG, torch.from_numpy(fp32["batch"]["frames"]),
        tm.init_cache(TCFG, B, CACHE, device="cpu"))
    got, cache = _port_decode(fp32["tp"], TCFG, cache,
                              fp32["batch"]["tokens"])
    np.testing.assert_allclose(got, fp32["decoded"], atol=ATOL)
    full, _ = tm.forward(fp32["tp"], TCFG, _t(fp32["batch"]))
    np.testing.assert_allclose(got, _np(full), atol=FWD_TOL, rtol=FWD_TOL)
    assert int(cache["pos"]) == S


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,sk", [(1, 16), (12, 16), (5, 40)])
def test_plain_k2_cross_shapes_match_pallas(sq, sk, dtype):
    """K2's plain version in full mode at Sq != Sk (the decoder's
    cross-attention; 40 keys leave a partial last tile) against the
    Pallas kernel in interpret mode, 4:4 heads of 64."""
    rng = np.random.default_rng(sq * 100 + sk)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, sq, 4, 64), (2, sk, 4, 64), (2, sk, 4, 64)))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jax_flash(*(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                     mode="full")
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    got = flash_attention_ref(*(torch.from_numpy(a).to(tdt)
                                for a in (q, k, v)), mode="full")
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert _scaled(got, want) <= tol


# ----------------------------------------------------- bf16 params
@pytest.fixture(scope="module")
def bf16():
    """bf16 parameters (JAX, converted, and the same values in fp32), the
    fp32 batch, and the JAX logits and decode logits in bf16 and fp32."""
    jcfg = JCFG.with_(param_dtype="bfloat16")
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    batch = synthetic_batch(TCFG, B, S, seed=2)
    out = dict(jp=jp, tp=params_from_numpy(jax.tree.map(np.asarray, jp)),
               batch=batch)
    for name, c, p in (("bf16", jcfg, jp), ("fp32", JCFG, jp32)):
        logits, _ = jax.jit(lambda p, b, c=c: jm.forward(p, c, b))(
            p, _j(batch))
        cache = jm.prefill_cross_kv(p, c, jnp.asarray(batch["frames"]),
                                    jm.init_cache(c, B, CACHE))
        out[name] = (np.asarray(logits, np.float32),
                     _jax_decode(p, c, cache, batch["tokens"]))
    return out


@pytest.mark.parametrize("frames", ["float32", "bfloat16"])
def test_bf16_cache_dtypes_match_jax(bf16, frames):
    """fp32 frames promote the encoder to fp32 in the reference
    (`frames.astype(bf16) + sinusoidal(...).astype(frames.dtype)`), so
    its cross K/V are fp32 beside bf16 self K/V; bf16 frames keep every
    leaf bf16. The port's leaves take the same dtypes."""
    jcfg, tcfg = (JCFG.with_(param_dtype="bfloat16"),
                  TCFG.with_(param_dtype="bfloat16"))
    x = bf16["batch"]["frames"]
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if frames == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    want = jm.prefill_cross_kv(bf16["jp"], jcfg, jx,
                               jm.init_cache(jcfg, B, CACHE))
    got = tm.prefill_cross_kv(bf16["tp"], tcfg, tx,
                              tm.init_cache(tcfg, B, CACHE, device="cpu"))
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == leaf.shape, name
        if name != "pos":
            assert str(got[name].dtype).split(".")[-1] == str(leaf.dtype), \
                name
    cross = "float32" if frames == "float32" else "bfloat16"
    assert str(want["cross_k"].dtype) == cross
    assert tm.cache_batch_axes(tcfg) == {"k": 1, "v": 1, "cross_k": 1,
                                         "cross_v": 1}


def test_bf16_forward_and_decode_near_jax(bf16):
    """bf16 has no fixed limit: the port's bf16 logits (forward, and 12
    decode steps from fp32 cross K/V, as Engine.serve keeps them) lie
    within twice the reference's own bf16-from-fp32 distance of the JAX
    package's bf16 logits."""
    tcfg = TCFG.with_(param_dtype="bfloat16")
    batch = bf16["batch"]
    logits, _ = tm.forward(bf16["tp"], tcfg, _t(batch))
    assert logits.dtype == torch.bfloat16
    cache = tm.prefill_cross_kv(bf16["tp"], tcfg,
                                torch.from_numpy(batch["frames"]),
                                tm.init_cache(tcfg, B, CACHE, device="cpu"))
    decoded, _ = _port_decode(bf16["tp"], tcfg, cache, batch["tokens"])
    for i, got in enumerate((logits, decoded)):
        want, truth = bf16["bf16"][i], bf16["fp32"][i]
        own = _scaled(want, truth)
        assert 0 < own < 0.2
        assert _scaled(got, want) <= 2 * own, (i, _scaled(got, want), own)


# ------------------------------------- the cross-attention's gradient
def test_cross_attention_gradient_matches_jax(fp32):
    """A forward that needs a gradient through the cross-attention alone
    (the encoder's weights need none, so it runs K2) runs K1 in full
    mode at Sq != Sk, one segment a row on each side: the gradient of a
    fixed projection of the logits in the cross-attention's weights
    equals `jax.grad`'s (1e-4) on the JAX package's reference
    attention."""
    w = np.random.default_rng(3).normal(
        0, 1, fp32["logits"].shape).astype(np.float32)
    jcfg = JCFG.with_(attn_impl="reference")

    def jloss(xattn, jp, batch):
        jp = {**jp, "dec_layers": {**jp["dec_layers"], "xattn": xattn}}
        return jnp.sum(jm.forward(jp, jcfg, batch)[0] * w)
    want = jax.grad(jloss)(fp32["jp"]["dec_layers"]["xattn"], fp32["jp"],
                           _j(fp32["batch"]))
    xattn = {k: v.clone().requires_grad_(True)
             for k, v in fp32["tp"]["dec_layers"]["xattn"].items()}
    tp = {**fp32["tp"], "dec_layers": {**fp32["tp"]["dec_layers"],
                                       "xattn": xattn}}
    logits, _ = tm.forward(tp, TCFG, _t(fp32["batch"]))
    got = torch.autograd.grad((logits * torch.from_numpy(w)).sum(),
                              list(xattn.values()))
    assert sorted(xattn) == sorted(want)
    for name, g in zip(xattn, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[name]),
                                   atol=ATOL, err_msg=name)


# ----------------------------------------------------- what raises
def test_prefill_and_train_refuse_audio(fp32):
    with pytest.raises(NotImplementedError, match="prefill_cross_kv"):
        tm.prefill(fp32["tp"], TCFG,
                   {"tokens": torch.zeros(1, 4, dtype=torch.long)})
    eng = Engine(TCFG, device="cpu", seed=0)
    with pytest.raises(NotImplementedError, match="KeyError: 'frames'"):
        eng.train(steps=1, global_batch=2)
    eng.close()
