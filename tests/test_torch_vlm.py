"""The VLM family of the port's model against the JAX package, on the CPU.

Reduced pixtral-12b and qwen3vl-8b (2 layers, d_model 256, 4:4 heads of
64, vision_dim 64), and reduced pixtral-12b at its full model's
head_dim 160 over 4:2 heads, fp32, on the JAX package's weights
converted through `repro_torch.convert` (the `connector` among them):

  * `init_params` draws the JAX package's tree (keys, shapes, dtypes),
    `connector` [vision_dim, d_model] included;
  * `synthetic_batch` is the JAX package's, array for array;
  * `forward` with `patch_embeds` / `patch_pos` (the connector's
    projection written over the token embeddings at those rows) gives
    the JAX logits; `prefill` with patches and 8 `decode_step`s give the
    JAX logits and caches (tests/test_models.py's make_batch and its
    decode-vs-forward check);
  * the gradient of a next-token loss through the connector, the
    embedding and the layers' query projection equals `jax.grad`.

The JAX side runs attention through its Pallas kernels in interpret
mode (its plain attention under `jax.grad`), the port through the
kernels' plain versions. atol 1e-4: sums
over d_model and vocab are taken in different orders.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import InputShape as JaxInputShape
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import synthetic_batch as jax_synthetic_batch
from repro.models import model as jm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.models import model as tm

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

ATOL = 1e-4
B, S = 2, 40
#: name -> (arch, overrides of the reduced config)
CONFIGS = {
    "pixtral": ("pixtral-12b", {}),
    "qwen3vl": ("qwen3vl-8b", {}),
    "pixtral_d160": ("pixtral-12b", dict(head_dim=160, kv_heads=2)),
}


def _configs(name):
    arch, kw = CONFIGS[name]
    return (jax_get_config(arch).reduced().with_(attn_impl="pallas", **kw),
            get_config(arch).reduced().with_(attn_impl="cuda", **kw))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    """(JAX config, port config, JAX params, the same params converted)."""
    jcfg, tcfg = _configs(request.param)
    jp = jm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _batch(cfg, seed, seq=S):
    """tests/test_models.py's VLM batch, from numpy: tokens, and patches
    over the first seq // 4 rows of every sequence."""
    rng = np.random.default_rng(seed)
    P = max(1, seq // 4)
    return {"tokens": rng.integers(0, cfg.vocab, (B, seq)).astype(np.int32),
            "patch_embeds": rng.standard_normal(
                (B, P, cfg.vlm.vision_dim)).astype(np.float32),
            "patch_pos": np.tile(np.arange(P, dtype=np.int32), (B, 1))}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(a, b, atol=ATOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(a, np.asarray(b), atol=atol)


def test_init_params_tree_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    ours = tm.init_params(tcfg, seed=0, device="cpu")
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = {jax.tree_util.keystr(p): leaf for p, leaf in
           jax.tree_util.tree_flatten_with_path(ours)[0]}
    assert len(got) == len(want)
    for path, leaf in want:
        t = got[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)
    assert tuple(ours["connector"].shape) == (tcfg.vlm.vision_dim,
                                              tcfg.d_model)
    np.testing.assert_array_equal(tp["connector"].numpy(),
                                  np.asarray(jp["connector"]))


def test_synthetic_batch_matches_jax(model):
    jcfg, tcfg, _, _ = model
    ours = synthetic_batch(tcfg, 3, 48, seed=7)
    want = jax_synthetic_batch(jcfg, JaxInputShape("t", 48, 3, "train"),
                               seed=7)
    assert sorted(ours) == sorted(want) == [
        "labels", "patch_embeds", "patch_pos", "tokens"]
    for k in want:
        assert ours[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(ours[k], want[k], err_msg=k)
    assert ours["patch_pos"].shape == (3, int(48 * tcfg.vlm.
                                              patches_per_seq_frac))


def test_forward_with_patches_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    batch = synthetic_batch(tcfg, B, S, seed=1)
    want, _ = jm.forward(jp, jcfg, _j(batch))
    got, _ = tm.forward(tp, tcfg, _t(batch))
    _close(got, want)
    # the patches reach the logits: without them the rows differ
    text, _ = tm.forward(tp, tcfg.with_(family="dense"),
                         {"tokens": torch.from_numpy(batch["tokens"])})
    assert (text - got).abs().max() > 1e-2


def test_vlm_batch_without_patches_raises(model):
    """The patches are part of a VLM batch, as in the JAX package: a
    batch without them fails in `forward` and `prefill` instead of giving
    text-only logits; a prompt chunk (tokens only) still prefills."""
    _, tcfg, _, tp = model
    tokens = torch.from_numpy(_batch(tcfg, 5)["tokens"])
    with pytest.raises(KeyError, match="patch_embeds"):
        tm.forward(tp, tcfg, {"tokens": tokens})
    with pytest.raises(KeyError, match="patch_embeds"):
        tm.prefill(tp, tcfg, {"tokens": tokens})
    cache = tm.init_cache(tcfg, B, S, device="cpu")
    cache = tm.prefill_chunk(tp, tcfg, cache, tokens[:, :8], 0)
    assert int(cache["pos"]) == 8


def test_prefill_and_decode_with_patches_match_jax(model):
    """prefill of a prompt with patches, then 8 decode steps: logits and
    caches as the JAX package's; the last decode step's logits equal
    `forward` over the whole sequence with the same patches."""
    jcfg, tcfg, jp, tp = model
    batch = _batch(tcfg, 2)
    jlog, jc = jm.prefill(jp, jcfg, _j(batch), cache_len=S + 8)
    tlog, tc = tm.prefill(tp, tcfg, _t(batch), cache_len=S + 8)
    _close(tlog, jlog)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    nxt = np.random.default_rng(3).integers(
        0, tcfg.vocab, (8, B)).astype(np.int32)
    for step in range(8):
        jlog, jc = jm.decode_step(jp, jcfg, jc, jnp.asarray(nxt[step]))
        tlog, tc = tm.decode_step(tp, tcfg, tc, torch.from_numpy(nxt[step]))
        _close(tlog, jlog)
    _close(tc["k"], jc["k"])
    assert int(tc["pos"]) == int(jc["pos"]) == S + 8
    whole = dict(batch, tokens=np.concatenate([batch["tokens"], nxt.T], 1))
    ref, _ = tm.forward(tp, tcfg, _t(whole))
    _close(tlog, ref[:, -1], atol=5e-5)


def test_gradient_through_the_connector_matches_jax_grad(model):
    """`jax.grad` differentiates the JAX package's plain attention (its
    Pallas kernels have no gradient); the port's runs K1's plain version
    under autograd."""
    jcfg, tcfg, jp, tp = model
    jcfg = jcfg.with_(attn_impl="reference")
    batch = synthetic_batch(tcfg, B, S, seed=4)
    names = ("connector", "embed")

    def jloss(sub, params):
        logits, _ = jm.forward({**params, **sub}, jcfg, _j(batch))
        logp = jax.nn.log_softmax(logits, -1)
        nll = -jnp.take_along_axis(logp, jnp.asarray(batch["labels"])
                                   [..., None], -1)
        return nll.mean()

    want = jax.grad(jloss)({n: jp[n] for n in names}, jp)
    wq_want = jax.grad(lambda w: jloss(
        {"layers": {**jp["layers"], "attn": {**jp["layers"]["attn"],
                                             "wq": w}}}, jp))(
        jp["layers"]["attn"]["wq"])

    leaves = {n: tp[n].clone().requires_grad_(True) for n in names}
    wq = tp["layers"]["attn"]["wq"].clone().requires_grad_(True)
    params = {**tp, **leaves,
              "layers": {**tp["layers"],
                         "attn": {**tp["layers"]["attn"], "wq": wq}}}
    logits, _ = tm.forward(params, tcfg, _t(batch))
    nll = -torch.log_softmax(logits, -1).gather(
        -1, torch.from_numpy(batch["labels"]).long()[..., None])
    nll.mean().backward()
    for n in names:
        _close(leaves[n].grad, want[n])
    _close(wq.grad, wq_want)
    assert leaves["connector"].grad.abs().max() > 0
