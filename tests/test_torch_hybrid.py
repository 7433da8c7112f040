"""The port's hybrid training slice (recurrentgemma-2b) against the JAX
package on the CPU.

Same weights (JAX `init_params` converted through `repro_torch.convert`),
same numpy inputs, fp32:

  * the recurrentgemma-2b config, full and reduced, field for field;
  * K4's plain version (the CPU path of `kernels/rglru_scan`) against the
    Pallas kernel in interpret mode and `rglru_scan_ref` at the JAX
    tests' shapes (1e-5; bf16 inputs 5e-2), its reverse loop against
    `jax.vjp` of `rglru_scan_ref` (1e-5);
  * `rglru_block` (and `rglru_scan` with a carried state) against the
    JAX versions (1e-5);
  * a reduced recurrentgemma-2b of 5 layers (one (rec, rec, attn) unit
    and a (rec, rec) tail) with span tables: the parameter tree, and the
    logits against the JAX `forward` (1e-4), with and without remat,
    through the kernels' plain versions and the full-matrix attention;
  * two `Engine.train` steps on openvid against the JAX `Engine.train`
    on the same config and batches: plan hashes and step keys equal,
    losses within 2e-5, each step's gradient within 1e-4, parameters
    within 1e-4 (up to 2 lr where a step's gradient is too small for
    its sign to be decided: see `test_engine_train_matches_jax`);
  * a text-only padded group (no table at all): its attention needs a
    gradient, so it runs K1 with one segment per row and never K2, and
    its loss and gradient equal the JAX ones.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.api import Engine as JaxEngine
from repro.configs import get_config as jax_get_config
from repro.core import executor as jexec
from repro.data.pipeline import HeterogeneousLoader as JaxLoader
from repro.data.pipeline import padded_batch as jax_padded_batch
from repro.kernels.ref import rglru_scan_ref
from repro.kernels.rglru_scan import rglru_scan_pallas
from repro.models import model as jm
from repro.models import rglru as jrg
from repro_torch.api import Engine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import HeterogeneousLoader, padded_batch
from repro_torch.kernels.rglru_scan import (rglru_scan_bwd_plain,
                                            rglru_scan_plain)
from repro_torch.models import attention as tattn
from repro_torch.models import model as tm
from repro_torch.models import rglru as trg
from repro_torch.training import TrainState
from repro_torch.training.optimizer import tree_map

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

LOSS_TOL, GRAD_TOL, FWD_TOL, SCAN_TOL = 2e-5, 1e-4, 1e-4, 1e-5
RUN = dict(dataset="openvid", global_batch=4, max_tokens=256,
           tokens_per_frame=16)
#: one (rec, rec, attn) unit and a (rec, rec) tail
JCFG = jax_get_config("recurrentgemma-2b").reduced().with_(n_layers=5)
TCFG = get_config("recurrentgemma-2b").reduced().with_(n_layers=5)


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
            assert a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], atol=atol, err_msg=k)


def _loader(cls, vocab=TCFG.vocab):
    return cls(RUN["dataset"], RUN["global_batch"], vocab, seed=0,
               max_tokens=RUN["max_tokens"],
               tokens_per_frame=RUN["tokens_per_frame"])


# ------------------------------------------------------------- config
@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_matches_jax(which):
    ours = get_config("recurrentgemma-2b")
    theirs = jax_get_config("recurrentgemma-2b")
    if which == "reduced":
        ours, theirs = ours.reduced(), theirs.reduced()
    for f in dataclasses.fields(ours):
        if f.name == "attn_impl" and which == "full":
            continue    # the port's default runs its kernels
        mine, want = getattr(ours, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(mine):
            assert dataclasses.asdict(mine) == dataclasses.asdict(want), \
                f.name
        else:
            assert mine == want, f.name
    assert ours.n_layers == (26 if which == "full" else 3)


# ------------------------------------------------------------ K4 plain
@pytest.mark.parametrize("S,W,chunk", [(64, 32, 16), (100, 16, 32),
                                       (128, 128, 64)])
def test_rglru_scan_plain_matches_pallas_and_ref(S, W, chunk):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.3, 0.99, (2, S, W)).astype(np.float32)
    b = (rng.standard_normal((2, S, W)) * 0.1).astype(np.float32)
    got = rglru_scan_plain(torch.from_numpy(a), torch.from_numpy(b))
    for want in (rglru_scan_pallas(jnp.asarray(a), jnp.asarray(b),
                                   chunk=chunk),
                 rglru_scan_ref(jnp.asarray(a), jnp.asarray(b))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=SCAN_TOL, rtol=SCAN_TOL)


def test_rglru_scan_plain_bf16_matches_pallas():
    rng = np.random.default_rng(1)
    a = rng.uniform(0.5, 0.95, (1, 64, 32)).astype(np.float32)
    b = (rng.standard_normal((1, 64, 32)) * 0.1).astype(np.float32)
    ja, jb = (jnp.asarray(x).astype(jnp.bfloat16) for x in (a, b))
    ta, tb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    got = rglru_scan_plain(ta, tb)
    assert got.dtype == torch.bfloat16
    want = rglru_scan_pallas(ja, jb, chunk=32)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("S", [1, 37, 130])
def test_rglru_scan_plain_backward_matches_jax_grad(S):
    rng = np.random.default_rng(S + 3)
    a = rng.uniform(0.3, 0.999, (2, S, 24)).astype(np.float32)
    b, dh = (rng.standard_normal((2, S, 24)).astype(np.float32)
             for _ in range(2))
    h, vjp = jax.vjp(rglru_scan_ref, jnp.asarray(a), jnp.asarray(b))
    want = vjp(jnp.asarray(dh))
    got = rglru_scan_bwd_plain(torch.from_numpy(a),
                               torch.from_numpy(np.array(h)),
                               torch.from_numpy(dh))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=SCAN_TOL, rtol=SCAN_TOL)
    # the autograd function's CPU path runs the same reverse loop
    ta, tb = (torch.from_numpy(x).requires_grad_(True) for x in (a, b))
    auto = torch.autograd.grad(trg._scan(ta, tb), (ta, tb),
                               torch.from_numpy(dh))
    for g, w in zip(auto, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=SCAN_TOL, rtol=SCAN_TOL)


# ------------------------------------------------------------- block
def test_rglru_block_matches_jax():
    params = jrg.init_rglru_block(jax.random.PRNGKey(5), 48, 64, 4,
                                  jnp.float32)
    # the JAX init leaves the gate biases at 0: move them off
    rng = np.random.default_rng(9)
    params = dict(params, b_a=jnp.asarray(rng.uniform(-1, 1, 64),
                                          jnp.float32),
                  b_x=jnp.asarray(rng.uniform(-1, 1, 64), jnp.float32))
    x = (rng.standard_normal((2, 45, 48)) * 0.5).astype(np.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, params))
    got = trg.rglru_block(tp, torch.from_numpy(x))
    want = jrg.rglru_block(params, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SCAN_TOL, rtol=SCAN_TOL)
    # the scan with a carried state, folded into the first step
    u = rng.standard_normal((2, 45, 64)).astype(np.float32)
    h0 = rng.standard_normal((2, 64)).astype(np.float32)
    got = trg.rglru_scan(tp, torch.from_numpy(u), torch.from_numpy(h0))
    want = jrg.rglru_scan(params, jnp.asarray(u), jnp.asarray(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SCAN_TOL, rtol=SCAN_TOL)


# ------------------------------------------------------------- model
def _record_grads(executor, to_numpy):
    """Wrap `executor.run_plan` so that every step's mean gradient is
    kept (as numpy) in the returned list."""
    kept, run = [], executor.run_plan

    def run_plan(*a, **k):
        loss, g = run(*a, **k)
        kept.append(to_numpy(g))
        return loss, g
    executor.run_plan = run_plan
    return kept


@pytest.fixture(scope="module")
def reference():
    """The JAX reference, built once: reduced 5-layer recurrentgemma-2b
    params, one padded span batch's logits, and two `Engine.train`
    steps (one CPU device, plans logged)."""
    eng = JaxEngine(JCFG)
    params0 = eng.state.params
    data = next(_loader(JaxLoader))
    ids = [0, 1, 2]
    b0 = jax_padded_batch([data.by_id(i) for i in ids], 256,
                          spans=[data.infos[i].spans for i in ids])
    logits0, _ = jm.forward(params0, JCFG,
                            {k: jnp.asarray(v) for k, v in b0.items()})
    plans = []
    grads = _record_grads(eng.executor, lambda g: jax.tree.map(np.asarray,
                                                               g))
    history = eng.train(steps=2, lookahead=True, plan_log=plans, **RUN)
    out = dict(params0=jax.tree.map(np.asarray, params0), b0=b0,
               logits0=np.asarray(logits0),
               losses=[m.loss for m in history], grads=grads,
               hashes=[p.structural_hash() for p in plans],
               keys=list(eng.executor.last_exe_keys),
               params=jax.tree.map(np.asarray, eng.state.params))
    eng.close()
    return out


def test_init_params_tree_matches_jax(reference):
    mine = tm.init_params(TCFG, seed=0, device="cpu")
    conv = params_from_numpy(reference["params0"])
    shapes = lambda t: tree_map(lambda a: tuple(a.shape), t)  # noqa: E731
    assert shapes(mine) == shapes(conv)
    dtypes = lambda t: tree_map(lambda a: a.dtype, t)  # noqa: E731
    assert dtypes(mine) == dtypes(conv)
    # stacked unit leaves keep their [n_units] axis, the tail has none
    assert conv["units"]["0_rec"]["rec"]["lambda"].shape == (1, 256)
    assert conv["tail"]["1_rec"]["rec"]["lambda"].shape == (256,)
    assert sorted(conv["units"]) == ["0_rec", "1_rec", "2_attn"]
    assert sorted(conv["tail"]) == ["0_rec", "1_rec"]


@pytest.mark.parametrize("impl,remat", [("cuda", False), ("cuda", True),
                                        ("reference", False)])
def test_forward_logits_match_jax(reference, impl, remat):
    cfg = TCFG.with_(attn_impl=impl, remat=remat)
    params = params_from_numpy(reference["params0"])
    b0 = reference["b0"]
    assert "modality_ids" in b0 and (b0["modality_ids"] >= 0).any()
    batch = {k: torch.from_numpy(v) for k, v in b0.items()}
    with torch.enable_grad():     # remat checkpoints only under autograd
        logits, _ = tm.forward(params, cfg, batch)
    np.testing.assert_allclose(logits.detach().numpy(),
                               reference["logits0"], atol=FWD_TOL,
                               rtol=FWD_TOL)


#: a gradient element below this (some 100 x the two engines' gradient
#: difference, about 1e-8 here) has no sign both can agree on
SIGN_FLOOR = 1e-6


def test_engine_train_matches_jax(reference):
    """Two steps: the same plans and step keys, losses within 2e-5, each
    step's gradient within 1e-4, and the parameters within 1e-4. AdamW
    moves an element by about lr x g / (|g| + 1e-8), a step of the
    gradient's sign: where a step's gradient lies below SIGN_FLOOR the
    two engines' sums of some 256 products of both signs may take
    opposite signs, and that element may then differ by up to 2 lr per
    such step (AdamW itself is held to the JAX one in
    tests/test_torch_training.py)."""
    eng = Engine(TCFG.with_(attn_impl="cuda"), device="cpu")
    eng.state = TrainState(params=params_from_numpy(reference["params0"]))
    plans = []
    grads = _record_grads(eng.executor, _np_tree)
    history = eng.train(steps=2, lookahead=True, plan_log=plans, **RUN)
    eng.close()
    assert [p.structural_hash() for p in plans] == reference["hashes"]
    assert eng.executor.last_exe_keys == reference["keys"]
    assert all(k[0] == "grad" for k in reference["keys"])   # padded
    np.testing.assert_allclose([m.loss for m in history],
                               reference["losses"], atol=LOSS_TOL)
    for mine, want in zip(grads, reference["grads"]):
        _assert_trees_close(mine, want, GRAD_TOL)
    lr = eng.optimizer.lr
    undecided = tree_map(lambda *g: sum((np.abs(np.asarray(x)) < SIGN_FLOOR)
                                        .astype(np.float32) for x in g),
                         *reference["grads"])
    got, want = _np_tree(eng.state.params), _np_tree(reference["params"])
    n_loose = 0
    for path, a, b, u in _leaf_paths(got, want, _np_tree(undecided)):
        np.testing.assert_array_less(np.abs(a - b),
                                     GRAD_TOL + 2 * lr * u + 1e-12,
                                     err_msg=path)
        n_loose += int((np.abs(a - b) > GRAD_TOL).sum())
    assert n_loose <= 10, n_loose
    assert int(eng.state.opt.step) == 2


def _leaf_paths(*trees, path=""):
    if isinstance(trees[0], dict):
        assert all(sorted(t) == sorted(trees[0]) for t in trees)
        for k in trees[0]:
            yield from _leaf_paths(*(t[k] for t in trees),
                                   path=f"{path}/{k}")
    else:
        yield (path, *trees)


def test_text_only_group_runs_k1_without_tables(reference, monkeypatch):
    """A padded group without spans has no table; the attention layer's
    call needs a gradient and so takes K1 (one segment per row), never
    K2. Its loss and gradient equal the JAX executor's."""
    data = next(_loader(HeterogeneousLoader))
    seqs = [data.by_id(i)[:100] for i in range(2)]
    b = padded_batch(seqs, 128)
    assert "modality_ids" not in b and "segment_ids" not in b

    def no_k2(*a, **k):
        raise AssertionError("the table-free gradient call reached K2")
    calls = []
    k1 = tattn.flash_attention_packed

    def counting_k1(*a, **k):
        calls.append(a[3].shape)
        return k1(*a, **k)
    monkeypatch.setattr(tattn, "flash_attention", no_k2)
    monkeypatch.setattr(tattn, "flash_attention_packed", counting_k1)
    cfg = TCFG.with_(attn_impl="cuda")
    leaves = params_from_numpy(reference["params0"])
    from repro_torch.core.executor import DHPExecutor
    from repro_torch.training.optimizer import tree_leaves
    step = DHPExecutor(cfg, Engine(cfg, device="cpu").cluster.pool()) \
        ._build_step(False)()
    loss, grads, _ = step(leaves, {k: torch.from_numpy(v)
                                   for k, v in b.items()})
    assert calls == [(2, 128)]        # the one attention layer, zeros

    def loss_fn(params, batch):
        logits, _ = jm.forward(params, JCFG, batch)
        s, c = jexec._masked_nll(logits, batch["labels"], batch["mask"])
        return s / jnp.maximum(c, 1.0)
    jb = jax_padded_batch(seqs, 128)
    want_loss, want_grads = jax.value_and_grad(loss_fn)(
        jax.tree.map(jnp.asarray, reference["params0"]),
        {k: jnp.asarray(v) for k, v in jb.items()})
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL
    _assert_trees_close(grads, jax.tree.map(np.asarray, want_grads),
                        GRAD_TOL)
    assert len(list(tree_leaves(grads))) == \
        len(jax.tree_util.tree_leaves(want_grads))


def test_loss_pieces_sum_what_the_whole_batch_sums(reference, monkeypatch):
    """`token_nll` takes a padded batch's head and NLL in checkpointed
    pieces of the flattened tokens; the NLL and its gradient equal the
    whole-batch computation's. Pieces of 100 tokens here cross rows."""
    from repro_torch.core import executor as ex
    from repro_torch.training.optimizer import tree_leaves
    assert not ex.DHPExecutor(TCFG, Engine(TCFG, device="cpu").cluster
                              .pool()).packed     # the hybrid runs padded
    monkeypatch.setattr(ex, "LOSS_PIECE_BYTES", 4 * TCFG.vocab * 100)
    b = {k: torch.from_numpy(v) for k, v in reference["b0"].items()}
    assert b["labels"].shape[0] > 1
    out = {}
    for name in ("pieces", "whole"):
        p = tree_map(lambda t: t.requires_grad_(True),
                     params_from_numpy(reference["params0"]))
        nll = ex.token_nll(p, TCFG, b, pieces=name == "pieces")
        loss = (nll * b["loss_mask"]).sum() / b["loss_mask"].sum()
        out[name] = (nll.detach(), torch.autograd.grad(
            loss, list(tree_leaves(p))))
    np.testing.assert_allclose(out["pieces"][0].numpy(),
                               out["whole"][0].numpy(), atol=1e-6,
                               rtol=1e-6)
    for g, w in zip(out["pieces"][1], out["whole"][1]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6,
                                   rtol=1e-5)


def test_hybrid_init_cache_builds_and_prefill_refuses():
    """The hybrid serves from a fresh state cache (its decode is held in
    tests/test_torch_hybrid_serving.py); like the JAX package's, its
    `prefill` takes the attention families only."""
    cache = tm.init_cache(TCFG, 1, 16, device="cpu")
    assert cache["k"].shape[:4] == (1, 1, 1, 16)
    assert cache["tail_h"].shape == (2, 1, TCFG.d_model)
    params = tm.init_params(TCFG, device="cpu")
    with pytest.raises(NotImplementedError, match="hybrid serving"):
        tm.prefill(params, TCFG,
                   {"tokens": torch.zeros(1, 4, dtype=torch.long)})
