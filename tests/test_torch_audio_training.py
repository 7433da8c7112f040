"""Audio training (whisper-small through `make_train_step`) against the
JAX package, on the CPU.

Reduced whisper-small (2 encoder and 2 decoder layers, d_model 256, 4:4
heads of 64, 16 frames, vocab 1024) on the JAX package's weights
converted through `repro_torch.convert`, one numpy `synthetic_batch` of
4 rows x 12 tokens fed to both:

  * fp32: `make_train_step` gives the JAX step's loss (2e-5), total, aux
    and grad_norm (1e-4 relative), and parameters that agree wherever
    the gradient has a sign both can agree on (`SIGN_FLOOR`); every
    gradient leaf of `loss_fn` equals `jax.grad`'s (1e-4); the same step
    with `accum_steps=2`; `make_eval_step` the JAX eval step's loss;
  * bf16 parameters with the fp32 frames `synthetic_batch` draws: every
    gradient leaf in the JAX package's dtype, within 3e-2 (scaled) of
    its value, and within 3e-2 of its largest value as a whole leaf;
  * K1's plain version at the cross-attention's Sq != Sk in full mode
    (partial tiles: 40 and 1 queries over 48 keys): output and gradients
    against `attn_chunked`'s custom VJP and `jax.grad(attn_reference)`
    (1e-4).

The JAX side runs its reduced config as it comes (`attn_impl=
"reference"`); the port runs `attn_impl="cuda"`, whose kernels run their
plain versions on CPU tensors: K1 for the encoder and the cross-attention
(one segment a row), K1 causal for the decoder. The JAX reference is
built once a module.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.models import model as jm
from repro.models.attention import attn_chunked, attn_reference
from repro.training import optimizer as jopt
from repro.training import train_step as jts
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.kernels.flash_attention_packed import flash_attention_packed
from repro_torch.training import (AdamW, TrainState, make_eval_step,
                                  make_train_step, value_and_grad)
from repro_torch.training.optimizer import tree_map

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

LOSS_TOL = 2e-5
GRAD_TOL = 1e-4
BF16_TOL = 3e-2
#: a gradient element below this (some 100 x the two packages' gradient
#: difference) has no sign both can agree on; AdamW's first step is lr
#: times that sign, so such an element may step up to 2 lr apart
SIGN_FLOOR = 1e-6
B, S = 4, 12
JCFG = jax_get_config("whisper-small").reduced()
TCFG = get_config("whisper-small").reduced().with_(attn_impl="cuda")


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return np.asarray(tree, np.float32)


def _paths(*trees, path=""):
    if isinstance(trees[0], dict):
        assert all(sorted(t) == sorted(trees[0]) for t in trees)
        for k in sorted(trees[0]):
            yield from _paths(*(t[k] for t in trees), path=f"{path}/{k}")
    else:
        yield (path, *trees)


def _jax_grads(jp, jcfg, batch):
    return jax.jit(jax.grad(lambda p, b: jts.loss_fn(p, jcfg, b)[0]))(
        jp, batch)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def reference():
    """JAX params (fp32), one batch, the JAX gradient and the JAX train
    step (accum 1 and 2) and eval step on it."""
    jp = jm.init_params(jax.random.PRNGKey(0), JCFG)
    batch = synthetic_batch(TCFG, B, S, seed=1)
    jb = _jbatch(batch)
    opt = jopt.AdamW()
    state = jts.TrainState(jp, opt.init(jp))
    steps = {}
    for accum in (1, 2):
        step = jax.jit(jts.make_train_step(JCFG, opt, accum_steps=accum))
        new, metrics = step(state, jb)
        steps[accum] = (jax.tree.map(np.asarray, new.params),
                        {k: float(v) for k, v in metrics.items()})
    grads = jax.tree.map(np.asarray, _jax_grads(jp, JCFG, jb))
    eval_loss = float(jax.jit(jts.make_eval_step(JCFG))(jp, jb))
    return dict(params=jax.tree.map(np.asarray, jp), batch=batch,
                grads=grads, steps=steps, eval_loss=eval_loss)


def test_gradient_matches_jax(reference):
    """Every gradient leaf of the loss, through K1's plain versions for
    the encoder, the decoder and the cross-attention."""
    tp = params_from_numpy(reference["params"])
    grads = value_and_grad(tp, TCFG, _tbatch(reference["batch"]))[3]
    n = 0
    for path, got, want in _paths(_np_tree(grads), reference["grads"]):
        assert got.shape == want.shape, path
        np.testing.assert_allclose(got, want, atol=GRAD_TOL, err_msg=path)
        n += 1
    assert n == len(jax.tree.leaves(reference["grads"]))


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(reference, accum):
    """One step: loss within 2e-5, total and aux beside it, grad_norm
    within 1e-4 relative, and the parameters after AdamW within 1e-4
    wherever the gradient lies above SIGN_FLOOR (2 lr elsewhere). With
    `accum_steps=2` the two micro-batches' gradients are summed in fp32,
    as the reference's scan sums them."""
    params, want = reference["steps"][accum]
    opt = AdamW()
    tp = params_from_numpy(reference["params"])
    step = make_train_step(TCFG, opt, accum_steps=accum)
    state, metrics = step(TrainState(tp), _tbatch(reference["batch"]))
    got = {k: float(v) for k, v in metrics.items()}
    assert sorted(got) == ["aux", "grad_norm", "loss", "total"]
    assert abs(got["loss"] - want["loss"]) <= LOSS_TOL, (got, want)
    assert abs(got["total"] - want["total"]) <= LOSS_TOL, (got, want)
    assert got["aux"] == want["aux"] == 0.0
    assert abs(got["grad_norm"] - want["grad_norm"]) \
        <= GRAD_TOL * want["grad_norm"], (got, want)
    assert int(state.opt.step) == 1
    undecided = tree_map(
        lambda g: (np.abs(g) < SIGN_FLOOR).astype(np.float32),
        reference["grads"])
    n_loose = 0
    for path, a, b, u in _paths(_np_tree(state.params), params, undecided):
        np.testing.assert_array_less(np.abs(a - b),
                                     GRAD_TOL + 2 * opt.lr * u + 1e-12,
                                     err_msg=path)
        n_loose += int((np.abs(a - b) > GRAD_TOL).sum())
    assert n_loose <= 10, n_loose


def test_eval_step_matches_jax(reference):
    tp = params_from_numpy(reference["params"])
    loss = make_eval_step(TCFG)(tp, _tbatch(reference["batch"]))
    assert abs(float(loss) - reference["eval_loss"]) <= LOSS_TOL
    assert abs(float(loss) - reference["steps"][1][1]["loss"]) <= LOSS_TOL


def test_bf16_gradients_near_jax(reference):
    """bf16 parameters, fp32 frames: the encoder and the cross K/V run in
    fp32 (the reference's promotion), the decoder in bf16; every
    gradient leaf comes back in its parameter's dtype, as the JAX one,
    and lies within 3e-2 * max(1, |jax|) of it elementwise and, as a
    whole leaf, within 3e-2 of its largest value (the gradients are
    below 0.1, where the elementwise limit alone says little; the two
    packages read at most 1.2e-2 apart so)."""
    jcfg = JCFG.with_(param_dtype="bfloat16")
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    jg = _jax_grads(jp, jcfg, _jbatch(reference["batch"]))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    tg = value_and_grad(tp, TCFG.with_(param_dtype="bfloat16"),
                        _tbatch(reference["batch"]))[3]
    n = 0
    for path, got, want in _paths(tg, jax.tree.map(np.asarray, jg)):
        assert str(got.dtype).split(".")[-1] == str(want.dtype), path
        got, want = got.float().numpy(), want.astype(np.float32)
        diff = np.abs(got - want)
        err = np.max(diff / np.maximum(1.0, np.abs(want)))
        assert err <= BF16_TOL, (path, err)
        assert diff.max() <= BF16_TOL * np.abs(want).max(), path
        n += 1
    assert n == len(jax.tree.leaves(jg))


@pytest.mark.parametrize("sq", [40, 1])
def test_plain_k1_cross_matches_jax(sq):
    """K1's plain forward and its gradient at Sq != Sk (48 keys: one full
    32-key tile and a partial one), full mode, one segment a row on each
    side: against `attn_chunked` (its custom VJP) and
    `jax.grad(attn_reference)`."""
    rng = np.random.default_rng(7)
    sk, h, d = 48, 4, 64
    q, do = (rng.normal(0, 1, (2, sq, h, d)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(0, 1, (2, sk, h, d)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    o = flash_attention_packed(
        tq, tk, tv, torch.zeros(2, sq, dtype=torch.int32),
        kv_segment_ids=torch.zeros(2, sk, dtype=torch.int32), mode="full")
    got = [o.detach().numpy()] + [
        g.numpy() for g in torch.autograd.grad(o, (tq, tk, tv),
                                               torch.from_numpy(do))]
    for fn in (lambda a, b, c: attn_chunked(a, b, c, mode="full", chunk=16),
               lambda a, b, c: attn_reference(a, b, c, mode="full")):
        out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
        want = [out] + list(vjp(jnp.asarray(do)))
        for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(a, np.asarray(b), atol=GRAD_TOL,
                                       err_msg=name)
