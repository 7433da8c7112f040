"""The port's MoE layer and models against the JAX package on the CPU.

Same weights (JAX `init_moe` / `init_params` converted through
`repro_torch.convert`), same numpy inputs, fp32:

  * granite-moe-1b-a400m's and olmoe-1b-7b's configs, full and reduced;
  * `moe_ffn`, sort and einsum dispatch, drop-free, dropping (capacity
    factor 1.0) and grouped (`dispatch_group` below T): the routing
    first (top-k experts, kept slots, queue positions equal), then the
    output and aux loss (1e-4) and the gradients of x and every leaf;
  * the per-row dispatch against `jax.vmap` of B=1 calls, on inputs where
    per-row and joint routing differ (asserted, so that it shows);
  * reduced models: `forward`'s logits and aux loss, and `prefill` +
    `decode_step` against `forward` at drop-free capacity (as the JAX
    package's test_prefill_decode_matches_forward) and against the JAX
    functions;
  * the router stays fp32 in a bf16 model, through the bridge and
    `init_params`, and its product leaves the caller's fp32 precision as
    it found it.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.models import model as jm
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe
from repro_torch.training.optimizer import tree_map

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

ARCHS = ("granite-moe-1b-a400m", "olmoe-1b-7b")
TOL = 1e-4
D, E, F, K = 64, 4, 32, 2


def _np(t):
    return t.detach().float().numpy()


@pytest.fixture(scope="module")
def layer():
    """One MoE layer's JAX parameters (numpy) and the port's copy."""
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(0), D, E,
                                               F, jnp.float32))
    return p, params_from_numpy(p)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jax_queue(idx, n_groups, cap):
    """Queue positions and kept mask of the JAX one-hot formulation,
    per group: idx [T,k] -> (pos [T,k], keep [T,k])."""
    T, k = idx.shape
    onehot = np.eye(E, dtype=np.int64)[idx].reshape(n_groups, -1, E)
    pos = np.cumsum(onehot, axis=1) - 1
    pos = (pos * onehot).sum(-1).reshape(T, k)
    return pos, pos < cap


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_matches_jax(arch, which):
    ours, theirs = get_config(arch), jax_get_config(arch)
    if which == "reduced":
        ours, theirs = ours.reduced(), theirs.reduced()
    for f in dataclasses.fields(ours):
        if f.name == "attn_impl" and which == "full":
            continue        # the port runs its kernels, JAX its chunked
        if f.name == "remat" and which == "full":
            continue        # the port's default is off (configs/base.py)
        mine, want = getattr(ours, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(mine):
            assert dataclasses.asdict(mine) == dataclasses.asdict(want), \
                f.name
        else:
            assert mine == want, f.name
    assert ours.moe.dispatch == "sort"
    assert ours.moe.n_experts == (4 if which == "reduced" else
                                  {"granite-moe-1b-a400m": 32,
                                   "olmoe-1b-7b": 64}[arch])


# ------------------------------------------------------------- moe_ffn
CASES = {
    # name: (x shape, capacity factor, dispatch_group)
    "drop_free": ((2, 32, D), float(E), 0),
    "drops": ((2, 32, D), 1.0, 0),
    "grouped": ((4, 32, D), 1.25, 16),
}


@pytest.mark.parametrize("dispatch,case", [
    ("sort", "drop_free"), ("sort", "drops"), ("sort", "grouped"),
    ("einsum", "drop_free"), ("einsum", "drops")])
def test_moe_ffn_matches_jax(layer, dispatch, case):
    jp, tp = layer
    shape, cf, group = CASES[case]
    x = _x(shape, seed=len(case))
    w = _x(shape, seed=7)                 # weights of the summed output
    kw = dict(top_k=K, capacity_factor=cf, dispatch=dispatch,
              dispatch_group=group)

    # routing first: a flipped near-tie shows here, not as a value
    T = shape[0] * shape[1]
    jprobs = jax.nn.softmax(jnp.asarray(x.reshape(T, D)) @ jp["router"])
    jgates, jidx = jax.lax.top_k(jprobs, K)
    _, gates, idx = tmoe.route(tp, torch.from_numpy(x.reshape(T, D)), K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(_np(gates), np.asarray(
        jgates / jgates.sum(-1, keepdims=True)), atol=1e-6)
    Tg = group or T
    n_groups = T // Tg if dispatch == "sort" else 1
    cap = int(cf * (T // n_groups) * K / E) or 1
    want_pos, want_keep = _jax_queue(np.asarray(jidx), n_groups, cap)
    *_, pos = tmoe.queue_positions(idx.reshape(n_groups, -1), E)
    pos = pos.reshape(T, K).numpy()
    np.testing.assert_array_equal(pos, want_pos)
    np.testing.assert_array_equal(pos < cap, want_keep)
    if case == "drops":
        assert not want_keep.all()
    elif case == "drop_free":
        assert want_keep.all()

    def jloss(p, x):
        out, aux = jmoe.moe_ffn(p, x, **kw)
        return (out * w).sum(), (out, aux)
    (_, (jout, jaux)), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))

    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe_ffn(leaves, xt, **kw)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(_np(out), np.asarray(jout), atol=TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(jgrads[1]),
                               atol=TOL)
    for k in tp:
        np.testing.assert_allclose(_np(leaves[k].grad),
                                   np.asarray(jgrads[0][k]), atol=TOL,
                                   err_msg=k)


@pytest.mark.parametrize("dispatch", ["sort", "einsum"])
@pytest.mark.parametrize("rows,seq", [(6, 1), (4, 5)])
def test_per_row_dispatch_is_vmap_of_single_rows(layer, dispatch, rows,
                                                 seq):
    """per_row=True equals the JAX package's `vmap` of [1,S,D] calls (the
    serving slots' routing), and differs from joint routing here: 6
    decode tokens jointly have capacity 3 an expert and drop, one alone
    never drops; 4 rows of 5 route with capacity 6 jointly, 1 a row."""
    jp, tp = layer
    x = _x((rows, seq, D), seed=rows)
    kw = dict(top_k=K, capacity_factor=1.25, dispatch=dispatch,
              dispatch_group=8192)
    jout, jaux = jax.jit(jax.vmap(lambda xr: jmoe.moe_ffn(
        jax.tree.map(jnp.asarray, jp), xr[None], **kw)))(jnp.asarray(x))
    out, aux = tmoe.moe_ffn(tp, torch.from_numpy(x), per_row=True, **kw)
    np.testing.assert_allclose(_np(out), np.asarray(jout)[:, 0], atol=TOL)
    assert aux.shape == (rows,)
    np.testing.assert_allclose(_np(aux), np.asarray(jaux), rtol=1e-5)
    joint, _ = tmoe.moe_ffn(tp, torch.from_numpy(x), **kw)
    jjoint, _ = jax.jit(lambda x: jmoe.moe_ffn(
        jax.tree.map(jnp.asarray, jp), x, **kw))(jnp.asarray(x))
    np.testing.assert_allclose(_np(joint), np.asarray(jjoint), atol=TOL)
    gap = np.abs(_np(joint) - _np(out)).max(axis=-1)
    assert (gap > 1e-3).any(), "per-row and joint routing agree here"


# ------------------------------------------------------------- models
@pytest.fixture(scope="module")
def models():
    """Each reduced arch's JAX config and parameters (numpy), built once."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_get_config(arch).reduced()
        out[arch] = (jcfg, jax.tree.map(
            np.asarray, jm.init_params(jax.random.PRNGKey(0), jcfg)))
    return out


def _tokens(shape, vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_jax(models, arch):
    jcfg, p0 = models[arch]
    cfg = get_config(arch).reduced()
    toks = _tokens((2, 24), cfg.vocab)
    jlogits, jaux = jm.forward(jax.tree.map(jnp.asarray, p0), jcfg,
                               {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        logits, aux = tm.forward(params_from_numpy(p0), cfg,
                                 {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), atol=TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    assert float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_match_forward_and_jax(models, arch):
    """At drop-free capacity (a decode micro-batch of B tokens and a
    forward of B·S route alike only there), prefill + one decode_step
    gives forward's last logits; each also equals the JAX function's."""
    jcfg, p0 = models[arch]
    free = dict(capacity_factor=float(jcfg.moe.n_experts))
    jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, **free))
    cfg = get_config(arch).reduced()
    cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, **free))
    B, S = 2, 12
    toks = _tokens((B, S + 1), cfg.vocab, seed=4)
    params = params_from_numpy(p0)
    jparams = jax.tree.map(jnp.asarray, p0)

    logits, cache = tm.prefill(params, cfg,
                               {"tokens": torch.from_numpy(toks[:, :S])},
                               cache_len=S + 4)
    step, _ = tm.decode_step(params, cfg, cache,
                             torch.from_numpy(toks[:, S]))
    with torch.no_grad():
        full, _ = tm.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(step), _np(full[:, -1]), atol=5e-5,
                               rtol=5e-5)

    jlogits, jcache = jm.prefill(jparams, jcfg,
                                 {"tokens": jnp.asarray(toks[:, :S])},
                                 cache_len=S + 4)
    jstep, _ = jm.decode_step(jparams, jcfg, jcache, jnp.asarray(toks[:, S]))
    np.testing.assert_allclose(_np(logits), np.asarray(jlogits), atol=TOL)
    np.testing.assert_allclose(_np(step), np.asarray(jstep), atol=TOL)


# ------------------------------------------------------------- dtypes
@pytest.mark.parametrize("arch", ARCHS)
def test_router_stays_fp32_in_a_bf16_model(arch):
    """The bridge keeps each leaf's dtype, and the port's own init makes
    the same tree: a bf16 model with an fp32 router."""
    jcfg = jax_get_config(arch).reduced().with_(param_dtype="bfloat16")
    cfg = get_config(arch).reduced().with_(param_dtype="bfloat16")
    conv = params_from_numpy(jax.tree.map(
        np.asarray, jm.init_params(jax.random.PRNGKey(0), jcfg)))
    mine = tm.init_params(cfg, seed=0, device="cpu")
    for tree in (conv, mine):
        moe = tree["layers"]["moe"]
        assert moe["router"].dtype == torch.float32
        assert all(moe[k].dtype == torch.bfloat16
                   for k in ("gate", "up", "down"))
    shapes = lambda t: tree_map(lambda a: (tuple(a.shape), a.dtype), t)  # noqa: E731
    assert shapes(mine) == shapes(conv)


def test_router_product_restores_the_callers_precision(layer):
    _, tp = layer
    tp = {k: v if k == "router" else v.to(torch.bfloat16)
          for k, v in tp.items()}
    x = torch.from_numpy(_x((1, 8, D), seed=5)).to(torch.bfloat16)
    prev = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        out, _ = tmoe.moe_ffn(tp, x, top_k=K)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()
