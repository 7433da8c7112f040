"""The port's training slice against the JAX package on the CPU.

Same weights (JAX `init_params` converted through `repro_torch.convert`),
same seeds, reduced internvl3-2b run as dense, `openvid`, one device:

  * the loader yields the JAX loader's batches bit for bit, and
    `flatten_group` packs them into the same tables;
  * AdamW (with the stacked-leaf decay rule), `cosine_schedule` and
    `clip_by_global_norm` equal the JAX versions on the same trees;
  * `Engine.train` runs the same plans (structural hashes, step-pool
    keys), losses within 2e-5, the first step's gradient and the
    parameters after two updates within 1e-4 (fp32) — with the packed
    kernel K1's plain version (`attn_impl="cuda"` on CPU tensors) and
    with the full-matrix reference;
  * dynamic and static plans of one batch on one rank give the same
    loss (2e-5) and gradient (1e-4); only the grouping differs;
  * a packed group at degree 2 (two ranks on one device, a ring) gives
    its degree-1 loss and gradient; the padded families refuse it.

The JAX executor runs its attention as one ring-CP hop; K1 gives zeros
on tail-padding rows where that hop gives the mean of V. Padding rows
carry no loss and no real row attends them, so losses and gradients
agree (the hidden states differ there only).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.api import Engine as JaxEngine
from repro.core.packing import flatten_group as jax_flatten_group
from repro.data.pipeline import HeterogeneousLoader as JaxLoader
from repro.training import optimizer as jopt
from repro_torch.api import (ClusterSpec, Engine, StepMetrics,
                             metrics_from_json, metrics_to_json)
from repro_torch.convert import params_from_numpy
from repro_torch.core.packing import flatten_group
from repro_torch.core.scheduler import diff_plans
from repro_torch.data.pipeline import HeterogeneousLoader
from repro_torch.training import (AdamW, TrainState, clip_by_global_norm,
                                  cosine_schedule)
from repro_torch.training.optimizer import tree_leaves, tree_map

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

LOSS_TOL, GRAD_TOL = 2e-5, 1e-4
RUN = dict(dataset="openvid", global_batch=8, max_tokens=512,
           tokens_per_frame=16)


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


def _loader(cls, vocab):
    return cls(RUN["dataset"], RUN["global_batch"], vocab, seed=0,
               max_tokens=RUN["max_tokens"],
               tokens_per_frame=RUN["tokens_per_frame"])


# ------------------------------------------------------- data + packing
def test_loader_yields_the_jax_batches_bit_for_bit():
    ours, theirs = _loader(HeterogeneousLoader, 1024), \
        _loader(JaxLoader, 1024)
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert [(s.length, s.eta, s.seq_id) for s in a.infos] == \
            [(s.length, s.eta, s.seq_id) for s in b.infos]
        assert [tuple(sp.to_json()) for s in a.infos for sp in s.spans] == \
            [tuple(sp.to_json()) for s in b.infos for sp in s.spans]
        for x, y in zip(a.tokens, b.tokens):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    state = ours.state()
    nxt = next(ours)
    ours.set_state(state)
    again = next(ours)
    assert all(np.array_equal(x, y) for x, y in zip(nxt.tokens,
                                                    again.tokens))


def test_flatten_group_equals_jax():
    a = next(_loader(HeterogeneousLoader, 1024))
    b = next(_loader(JaxLoader, 1024))
    ids = [0, 3, 5]
    ours, cu = flatten_group([a.by_id(i) for i in ids], 2048,
                             spans=[a.infos[i].spans for i in ids])
    theirs, jcu = jax_flatten_group([b.by_id(i) for i in ids], 2048,
                                    spans=[b.infos[i].spans for i in ids])
    assert sorted(ours) == sorted(theirs)
    assert "modality_ids" in ours and np.array_equal(cu, jcu)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype, k
        assert np.array_equal(ours[k], theirs[k]), k


# ----------------------------------------------------------- optimizer
def _trees(seed):
    """A params/grads pair shaped like stacked layer leaves: [2, 8]
    norm scales (decayed: ndim 2), [8] final scale (not decayed)."""
    rng = np.random.default_rng(seed)
    shapes = {"layers": {"ln1": {"scale": (2, 8)}, "w": (2, 8, 4)},
              "ln_f": {"scale": (8,)}}
    return (tree_map(lambda s: rng.standard_normal(s).astype(np.float32),
                     shapes),
            tree_map(lambda s: rng.standard_normal(s).astype(np.float32),
                     shapes))


def test_adamw_matches_jax_including_stacked_leaf_decay():
    params, grads = _trees(0)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = tree_map(torch.from_numpy, params)
    jo = jopt.AdamW(lr=jopt.cosine_schedule(1e-2, 1, 4))
    to = AdamW(lr=cosine_schedule(1e-2, 1, 4))
    js, ts = jo.init(jparams), to.init(tparams)
    for step in range(3):
        g = tree_map(lambda a: a * (step + 1), grads)
        jparams, js = jo.update(jax.tree.map(jnp.asarray, g), js, jparams)
        tparams, ts = to.update(tree_map(torch.from_numpy, g), ts, tparams)
        _assert_trees_close(tparams, jparams, 1e-6)
        _assert_trees_close(ts.m, js.m, 1e-6)
        _assert_trees_close(ts.v, js.v, 1e-6)
    # the rule: a stacked [L, d] scale decays, the [d] final one does not
    p0, _ = _trees(0)
    zero = tree_map(lambda a: np.zeros_like(a), p0)
    after, _ = AdamW(lr=0.5, weight_decay=0.1).update(
        tree_map(torch.from_numpy, zero),
        AdamW().init(tree_map(torch.from_numpy, p0)),
        tree_map(torch.from_numpy, p0))
    np.testing.assert_allclose(after["layers"]["ln1"]["scale"].numpy(),
                               p0["layers"]["ln1"]["scale"] * 0.95,
                               rtol=1e-6)
    np.testing.assert_array_equal(after["ln_f"]["scale"].numpy(),
                                  p0["ln_f"]["scale"])


def test_schedule_and_clipping_match_jax():
    jlr, tlr = jopt.cosine_schedule(3e-4, 5, 50), \
        cosine_schedule(3e-4, 5, 50)
    for s in (0, 1, 4, 5, 6, 30, 50, 70):
        np.testing.assert_allclose(float(tlr(torch.tensor(s))),
                                   float(jlr(jnp.asarray(s))), rtol=1e-6)
    _, grads = _trees(1)
    for max_norm in (0.5, 1e3):
        jc, jn = jopt.clip_by_global_norm(
            jax.tree.map(jnp.asarray, grads), max_norm)
        tc, tn = clip_by_global_norm(tree_map(torch.from_numpy, grads),
                                     max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_trees_close(tc, jc, 1e-6)


# ----------------------------------------------------- engine vs JAX
@pytest.fixture(scope="module")
def jax_run():
    """JAX Engine(reduced=True), one CPU device: the first batch's loss
    and gradient, then two training steps (lookahead on, plans logged)."""
    eng = JaxEngine("internvl3-2b", reduced=True)
    params0 = jax.tree.map(np.asarray, eng.state.params)
    data0 = next(_loader(JaxLoader, eng.cfg.vocab))
    loss0, grads0 = eng.executor.run_plan(eng.state.params,
                                          eng.plan(data0), data0)
    keys0 = list(eng.executor.last_exe_keys)
    plans = []
    history = eng.train(steps=2, lookahead=True, plan_log=plans, **RUN)
    out = dict(params0=params0, loss0=float(loss0),
               grads0=jax.tree.map(np.asarray, grads0), keys0=keys0,
               keys1=list(eng.executor.last_exe_keys),
               losses=[m.loss for m in history],
               hashes=[p.structural_hash() for p in plans],
               params=jax.tree.map(np.asarray, eng.state.params))
    eng.close()
    return out


def _port_engine(params0, impl, **kw):
    eng = Engine("internvl3-2b", reduced=True, device="cpu", **kw)
    eng.cfg = eng.cfg.with_(attn_impl=impl)
    eng.state = TrainState(params=params_from_numpy(params0))
    return eng


@pytest.mark.parametrize("impl,lookahead", [("cuda", True),
                                            ("reference", False)])
def test_engine_train_matches_jax(jax_run, impl, lookahead):
    eng = _port_engine(jax_run["params0"], impl)
    data0 = next(_loader(HeterogeneousLoader, eng.cfg.vocab))
    loss0, grads0 = eng.executor.run_plan(eng.state.params,
                                          eng.plan(data0), data0)
    assert eng.executor.last_exe_keys == jax_run["keys0"]
    assert any(k[-1] == "mm" for k in jax_run["keys0"])  # spans ran
    assert abs(float(loss0) - jax_run["loss0"]) <= LOSS_TOL
    _assert_trees_close(grads0, jax_run["grads0"], GRAD_TOL)

    plans = []
    history = eng.train(steps=2, lookahead=lookahead, plan_log=plans,
                        **RUN)
    eng.close()
    assert [p.structural_hash() for p in plans] == jax_run["hashes"]
    assert eng.executor.last_exe_keys == jax_run["keys1"]
    np.testing.assert_allclose([m.loss for m in history],
                               jax_run["losses"], atol=LOSS_TOL)
    _assert_trees_close(eng.state.params, jax_run["params"], GRAD_TOL)
    assert int(eng.state.opt.step) == 2
    # the metrics wire format round-trips
    again = metrics_from_json(metrics_to_json(history))
    assert [m.to_json() for m in again] == [m.to_json() for m in history]
    assert isinstance(again[0], StepMetrics)
    assert history[0].modality_loss and history[0].exe_misses == 0  # warm


def test_dynamic_and_static_plans_agree_on_one_rank(jax_run):
    """Same batch, DHP plan vs static plan: the groups differ, the loss
    and the token-weighted gradient do not."""
    out = {}
    for name in ("dhp", "static"):
        eng = _port_engine(jax_run["params0"], "cuda", strategy=name)
        data = next(_loader(HeterogeneousLoader, eng.cfg.vocab))
        plan = eng.plan(data)
        out[name] = (plan, *eng.executor.run_plan(eng.state.params, plan,
                                                  data))
    (pd, ld, gd), (ps, ls, gs) = out["dhp"], out["static"]
    assert pd.structural_hash() != ps.structural_hash()
    assert abs(float(ld) - float(ls)) <= LOSS_TOL
    _assert_trees_close(gd, gs, GRAD_TOL)
    delta = diff_plans(pd, ps, 1)
    assert delta.reused == [(0, 1)] and not delta.created


def test_scheduler_lookahead_plans_what_schedule_plans():
    """DHPScheduler.prepare/collect (the planner thread) returns the plan
    schedule() returns for the same batch, and the JAX scheduler's."""
    from repro.api.engine import demo_cost_model as jax_cost_model
    from repro.configs import get_config as jax_config
    from repro.core.scheduler import DHPScheduler as JaxScheduler
    from repro_torch.api import demo_cost_model
    from repro_torch.configs import get_config
    from repro_torch.core.scheduler import DHPScheduler
    infos = next(_loader(HeterogeneousLoader, 1024)).infos
    jinfos = next(_loader(JaxLoader, 1024)).infos
    sched = DHPScheduler(demo_cost_model(get_config("internvl3-2b")), 4,
                         4096)
    want = sched.schedule(infos).structural_hash()
    sched.prepare(infos)
    assert sched.collect().structural_hash() == want
    sched.close()
    with pytest.raises(RuntimeError):
        sched.collect()
    jsched = JaxScheduler(jax_cost_model(jax_config("internvl3-2b")), 4,
                          4096)
    assert jsched.schedule(jinfos).structural_hash() == want


def test_strategy_keeps_one_plan_in_flight():
    """Strategy.prepare/collect plans on the planner thread what plan()
    plans; a second prepare() before collect() raises."""
    from repro_torch.api import demo_cost_model
    from repro_torch.api.strategies import get_strategy
    from repro_torch.configs import get_config
    infos = next(_loader(HeterogeneousLoader, 1024)).infos
    strat = get_strategy("dhp").bind(
        demo_cost_model(get_config("internvl3-2b")), 1, 4096)
    want = strat.plan(infos).structural_hash()
    strat.prepare(infos)
    with pytest.raises(RuntimeError, match="in flight"):
        strat.prepare(infos)
    assert strat.collect().structural_hash() == want
    with pytest.raises(RuntimeError):
        strat.collect()
    strat.close()


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-2b"])
def test_group_of_degree_above_one_raises(arch):
    """The padded families refuse a degree > 1: the JAX reference
    restarts their recurrent state at every shard (ROADMAP Queue 3)."""
    eng = Engine(arch, ClusterSpec(devices=[torch.device("cpu")] * 2),
                 reduced=True)
    data = next(_loader(HeterogeneousLoader, eng.cfg.vocab))
    plan = eng.plan(data)
    plan.micro_batches[0].groups[0].degree = 2
    with pytest.raises(NotImplementedError, match="recurrent state"):
        eng.executor.run_plan(eng.state.params, plan, data)


def test_dense_group_of_degree_two_matches_degree_one(jax_run):
    """A packed group at degree 2 runs as a ring on one device and gives
    the loss and gradient of the same plan at degree 1."""
    eng = Engine("internvl3-2b",
                 ClusterSpec(devices=[torch.device("cpu")] * 2),
                 reduced=True)
    eng.state = TrainState(params=params_from_numpy(jax_run["params0"]))
    data = next(_loader(HeterogeneousLoader, eng.cfg.vocab))
    plan = eng.plan(data)
    loss1, grads1 = eng.executor.run_plan(eng.state.params, plan, data)
    plan.micro_batches[0].groups[0].degree = 2
    loss2, grads2 = eng.executor.run_plan(eng.state.params, plan, data)
    assert eng.executor.last_exe_keys[0][2] == 2
    assert abs(float(loss2) - float(loss1)) <= LOSS_TOL
    _assert_trees_close(grads2, grads1, GRAD_TOL)
    # ranks on several devices wait for the executor over NCCL
    two = Engine("internvl3-2b", ClusterSpec(
        devices=[torch.device("cpu"), torch.device("meta")]), reduced=True)
    with pytest.raises(NotImplementedError, match="NCCL"):
        two.executor.run_plan(two.state.params, plan, data)


def test_trace_records_each_groups_bucket_and_spans():
    eng = Engine("internvl3-2b", reduced=True, device="cpu")
    history = eng.train(steps=1, lookahead=False, trace=True, **RUN)
    spans = [e for e in eng.last_tracer.to_json()["traceEvents"]
             if e.get("name") == "execute"]
    keys = eng.executor.last_exe_keys
    assert [(e["args"]["bucket"], e["args"]["spans"]) for e in spans] == \
        [(k[3], k[-1] == "mm") for k in keys]
    names = {e.get("name") for e in eng.last_tracer.to_json()["traceEvents"]}
    assert {"plan", "collect", "run_plan"} <= names
    assert history[0].tokens == sum(
        len(t) for t in next(_loader(HeterogeneousLoader,
                                     eng.cfg.vocab)).tokens)
    assert sum(1 for _ in tree_leaves(eng.state.params)) == \
        sum(1 for _ in tree_leaves(eng.state.opt.m))
