"""The port's MoE training (reduced granite-moe-1b-a400m, fp32) against a
reference composed from JAX package functions, on the CPU.

The JAX `Engine.train` itself is not the reference: inside its
executor's `shard_map` the layer scan of `apply_stack` fails on the MoE
family (its carry's aux loss depends on x and so varies over the
shards, where the carry's initial zero does not: a scan-carry type
error). So the reference runs the same functions without it: the JAX
executor's packed `_group_batch` on the JAX engine's plans, `forward`,
`executor._masked_nll`, `jax.value_and_grad` and the JAX `AdamW`, as
tests/test_torch_ssm.py does for the SSM family (which fails the same
way). Held: the plans' structural hashes, the step keys, the losses
(2e-5), each step's gradient at the reference's own parameters (1e-4)
and the parameters after two steps; MoE groups run packed (through K1's
plain version here), and a group of degree > 1 raises with its reason.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.api import Engine as JaxEngine
from repro.configs import get_config as jax_get_config
from repro.core import executor as jexec
from repro.data.pipeline import HeterogeneousLoader as JaxLoader
from repro.models import model as jm
from repro.training import optimizer as jopt
from repro_torch.api import ClusterSpec, Engine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import HeterogeneousLoader
from repro_torch.training import TrainState
from repro_torch.training.optimizer import tree_map

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

ARCH = "granite-moe-1b-a400m"
LOSS_TOL, GRAD_TOL = 2e-5, 1e-4
#: a gradient element below this has no sign both engines can agree on:
#: AdamW's first steps move it by up to lr whichever sign it takes
SIGN_FLOOR = 1e-6
RUN = dict(dataset="openvid", global_batch=4, max_tokens=256,
           tokens_per_frame=16)
JCFG = jax_get_config(ARCH).reduced()
TCFG = get_config(ARCH).reduced()


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return np.asarray(tree, np.float32)


def _leaf_paths(*trees, path=""):
    if isinstance(trees[0], dict):
        assert all(sorted(t) == sorted(trees[0]) for t in trees)
        for k in trees[0]:
            yield from _leaf_paths(*(t[k] for t in trees),
                                   path=f"{path}/{k}")
    else:
        yield (path, *trees)


def _assert_trees_close(a, b, atol):
    for path, x, y in _leaf_paths(_np_tree(a), _np_tree(b)):
        np.testing.assert_allclose(x, y, atol=atol, err_msg=path)


def _loader(cls):
    return cls(RUN["dataset"], RUN["global_batch"], TCFG.vocab, seed=0,
               max_tokens=RUN["max_tokens"],
               tokens_per_frame=RUN["tokens_per_frame"])


def _jax_loss_fn(with_spans):
    """The JAX executor's per-group loss, without its shard_map."""
    def loss_fn(params, batch):
        logits, _ = jm.forward(params, JCFG, batch)
        if not with_spans:
            s, c = jexec._masked_nll(logits, batch["labels"],
                                     batch["mask"])
        else:
            nll = jexec._token_nll(logits, batch["labels"])
            s, c = (nll * batch["loss_mask"]).sum(), batch["loss_mask"].sum()
        return s / jnp.maximum(c, 1.0)
    return loss_fn


_VG = {w: jax.jit(jax.value_and_grad(_jax_loss_fn(w))) for w in (0, 1)}


def _jax_plan_grad(jx, params, plan, data):
    """(mean loss, token-weighted mean gradient, step keys) of a plan:
    each group packed by the JAX executor's `_group_batch` and weighted
    by its loss tokens, as both executors weight them."""
    spans_by_id = data.spans_by_id()
    loss_acc, g_acc, total, keys = 0.0, None, 0.0, []
    for mi, gi, start, _ in plan.group_slots(jx.pool.n_replicas):
        g = plan.micro_batches[mi].groups[gi]
        seqs = [data.by_id(i) for i in g.seq_ids]
        b, _, _, bucket = jx._group_batch(
            seqs, g.degree, spans=[spans_by_id.get(i) for i in g.seq_ids])
        with_spans = "modality_ids" in b
        keys.append(("pgrad", start, g.degree, bucket)
                    + (("mm",) if with_spans else ()))
        w = float(b.get("loss_mask", b["mask"]).sum())
        loss, grads = _VG[with_spans](
            params, {k: jnp.asarray(v) for k, v in b.items()})
        total += w
        loss_acc += float(loss) * w
        gw = jax.tree.map(lambda a: np.asarray(a, np.float32) * w, grads)
        g_acc = gw if g_acc is None else jax.tree.map(np.add, g_acc, gw)
    return loss_acc / total, jax.tree.map(lambda a: a / total, g_acc), keys


@pytest.fixture(scope="module")
def reference():
    """Two steps of the JAX reference on the JAX engine's plans (one CPU
    device): each step's parameters, loss, gradient and keys."""
    jeng = JaxEngine(ARCH, reduced=True)
    jx = jexec.DHPExecutor(JCFG, pool=jeng.cluster.pool())
    assert jx.packed
    opt = jopt.AdamW(lr=3e-4)
    params = jm.init_params(jax.random.PRNGKey(0), JCFG)
    state = opt.init(params)
    out = dict(params=[], losses=[], grads=[], keys=[], hashes=[])
    data = _loader(JaxLoader)
    for _ in range(2):
        d = next(data)
        plan = jeng.plan(d)
        out["hashes"].append(plan.structural_hash())
        out["params"].append(jax.tree.map(np.asarray, params))
        loss, grads, keys = _jax_plan_grad(jx, params, plan, d)
        out["losses"].append(loss)
        out["grads"].append(grads)
        out["keys"].append(keys)
        params, state = opt.update(jax.tree.map(jnp.asarray, grads), state,
                                   params)
    out["final"] = jax.tree.map(np.asarray, params)
    jeng.close()
    return out


def _port_engine(params, **kw):
    eng = Engine(TCFG, device="cpu", **kw)
    eng.state = TrainState(params=params_from_numpy(params))
    return eng


@pytest.mark.parametrize("impl,step", [("cuda", 0), ("reference", 0),
                                       ("cuda", 1)])
def test_plan_gradient_matches_jax(reference, impl, step):
    """Each step's batch and plan at the reference's own parameters:
    loss, gradient and the packed step keys ("cuda" runs K1's plain
    version on the CPU)."""
    eng = _port_engine(reference["params"][step])
    eng.cfg = eng.cfg.with_(attn_impl=impl)
    loader = _loader(HeterogeneousLoader)
    for _ in range(step + 1):
        data = next(loader)
    plan = eng.plan(data)
    assert plan.structural_hash() == reference["hashes"][step]
    loss, grads = eng.executor.run_plan(eng.state.params, plan, data)
    eng.close()
    assert abs(float(loss) - reference["losses"][step]) <= LOSS_TOL
    _assert_trees_close(grads, reference["grads"][step], GRAD_TOL)
    assert eng.executor.last_exe_keys == reference["keys"][step]
    assert eng.executor.packed
    assert all(k[0] == "pgrad" for k in reference["keys"][step])


def test_engine_train_matches_jax_reference(reference):
    """Two `Engine.train` steps: the same plans and keys, losses within
    2e-5, the first step's gradient within 1e-4, and the parameters
    within 1e-4 except where a step's gradient lies below SIGN_FLOOR
    (there the two engines' sums may take opposite signs, and AdamW then
    moves the element up to 2 lr apart)."""
    eng = _port_engine(reference["params"][0])
    grads, run = [], eng.executor.run_plan

    def run_plan(*a, **k):
        loss, g = run(*a, **k)
        grads.append(_np_tree(g))
        return loss, g
    eng.executor.run_plan = run_plan
    plans = []
    history = eng.train(steps=2, lookahead=True, plan_log=plans, **RUN)
    eng.close()
    assert [p.structural_hash() for p in plans] == reference["hashes"]
    assert eng.executor.last_exe_keys == reference["keys"][1]
    np.testing.assert_allclose([m.loss for m in history],
                               reference["losses"], atol=LOSS_TOL)
    _assert_trees_close(grads[0], reference["grads"][0], GRAD_TOL)
    lr = eng.optimizer.lr
    undecided = tree_map(lambda *g: sum((np.abs(x) < SIGN_FLOOR).astype(
        np.float32) for x in g), *reference["grads"])
    got, want = _np_tree(eng.state.params), _np_tree(reference["final"])
    for path, a, b, u in _leaf_paths(got, want, _np_tree(undecided)):
        np.testing.assert_array_less(np.abs(a - b),
                                     GRAD_TOL + 2 * lr * u + 1e-12,
                                     err_msg=path)
    assert int(eng.state.opt.step) == 2


def test_group_above_degree_one_raises():
    """At 8 ranks the planner gives a group degree > 1; the MoE family
    refuses it, and says why (the reference routes each CP shard alone
    and cannot run the family under shard_map)."""
    eng = Engine(ARCH, ClusterSpec(devices=[torch.device("cpu")] * 8,
                                   mem_budget=300.0), reduced=True)
    data = next(_loader(HeterogeneousLoader))
    plan = eng.plan(data)
    assert max(g.degree for mb in plan.micro_batches
               for g in mb.groups) > 1
    with pytest.raises(NotImplementedError, match="MoE.*shard_map"):
        eng.executor.run_plan(eng.state.params, plan, data)
    eng.close()
