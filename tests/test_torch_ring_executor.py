"""The port's executor and engine at CP degree > 1 against the JAX package
on the CPU.

Reduced internvl3-2b (`family="dense", vlm=None`) over 8 ranks on one
device (`ClusterSpec(devices=[cpu] * 8)`): the port runs a packed group
of degree d as d rows of one tensor, attention as ring CP over a
`LocalRing` (K1's plain version a hop). The JAX reference runs the same
plan (passed as the plan IR's JSON) and two `Engine.train` steps under
`shard_map` on 8 forced host devices, once per module in one subprocess
(`tests/conftest.py::run_in_subprocess`), on the JAX `init_params` the
port takes through `convert.params_from_numpy`:

  * the `openvid` batch and `mem_budget=900` of
    `tests/test_parallel.py::test_executor_dynamic_equals_static` plan a
    group of degree 6;
  * the port's dynamic plan gives its own static plan's loss (2e-5) and
    gradient (1e-4), and the JAX executor's on the same plan;
  * two `Engine.train` steps (plans with degrees 4 and 2) give the JAX
    engine's plans, step-pool keys, losses and parameters.
"""
import json

import numpy as np
import pytest
import torch

from conftest import run_in_subprocess
from repro_torch.api import ClusterSpec, Engine
from repro_torch.convert import params_from_numpy
from repro_torch.core.scheduler import static_plan
from repro_torch.configs import get_config
from repro_torch.data.pipeline import HeterogeneousLoader
from repro_torch.models.model import forward_hidden, init_params
from repro_torch.parallel import LocalRing
from repro_torch.training import TrainState

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

LOSS_TOL, GRAD_TOL = 2e-5, 1e-4
RANKS, BUDGET = 8, 900.0
#: the batch of tests/test_parallel.py's executor tests
BATCH = dict(dataset="openvid", global_batch=12, seed=1, max_tokens=512,
             tokens_per_frame=16)
#: Engine.train's stream; at 8 ranks and BUDGET its plans hold degrees 4
#: and 2
RUN = dict(dataset="openvid", global_batch=8, max_tokens=512,
           tokens_per_frame=16)

JAX_SCRIPT = """
import json
import jax, numpy as np
from repro.api import ClusterSpec, Engine
from repro.core.scheduler import ExecutionPlan
from repro.data.pipeline import HeterogeneousLoader

out_path, plan_path = {out!r}, {plan!r}
run, batch = {run!r}, {batch!r}
assert len(jax.devices()) == {ranks}
eng = Engine("internvl3-2b", ClusterSpec(mem_budget={budget}),
             reduced=True)
out = {{}}

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(p.key for p in path)
        out[prefix + key] = np.asarray(leaf, np.float32)

put("params0/", eng.state.params)
loader = HeterogeneousLoader(batch.pop("dataset"), batch.pop("global_batch"),
                             eng.cfg.vocab, **batch)
data = next(iter(loader))
with open(plan_path) as f:
    plan = ExecutionPlan.from_json(json.load(f))
loss, grads = eng.executor.run_plan(eng.state.params, plan, data)
out["loss0"] = np.float64(loss)
put("grads0/", grads)
plans = []
hist = eng.train(steps=2, lookahead=False, plan_log=plans, **run)
out["losses"] = np.array([m.loss for m in hist])
put("params/", eng.state.params)
eng.close()
np.savez(out_path, **out)
print(json.dumps({{"hashes": [p.structural_hash() for p in plans],
                  "keys": [list(k) for k in eng.executor.last_exe_keys]}}))
"""


def _tree(flat, prefix):
    out = {}
    for key, arr in flat.items():
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = arr
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, (tree.detach().float().numpy()
                       if isinstance(tree, torch.Tensor)
                       else np.asarray(tree, np.float32))


def _assert_trees_close(a, b, atol):
    la, lb = list(_leaves(a)), list(_leaves(b))
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        np.testing.assert_allclose(x, y, atol=atol, err_msg=k)


def _engine(params0=None):
    eng = Engine("internvl3-2b",
                 ClusterSpec(devices=[torch.device("cpu")] * RANKS,
                             mem_budget=BUDGET), reduced=True)
    if params0 is not None:
        eng.state = TrainState(params=params_from_numpy(params0))
    return eng


def _batch(vocab):
    kw = dict(BATCH)
    return next(HeterogeneousLoader(kw.pop("dataset"),
                                    kw.pop("global_batch"), vocab, **kw))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The port's plan of BATCH, and what the JAX package computes on it
    and in two Engine.train steps at 8 host devices."""
    tmp = tmp_path_factory.mktemp("ring_executor")
    eng = _engine()
    plan = eng.plan(_batch(eng.cfg.vocab))
    eng.close()
    plan_path, out_path = tmp / "plan.json", tmp / "jax.npz"
    plan_path.write_text(json.dumps(plan.to_json()))
    stdout = run_in_subprocess(JAX_SCRIPT.format(
        ranks=RANKS, budget=BUDGET, out=str(out_path),
        plan=str(plan_path), run=RUN, batch=dict(BATCH)), n_devices=RANKS)
    meta = json.loads(stdout.strip().splitlines()[-1])
    flat = dict(np.load(out_path))
    return dict(plan=plan, params0=_tree(flat, "params0/"),
                loss0=float(flat["loss0"]), grads0=_tree(flat, "grads0/"),
                losses=flat["losses"], params=_tree(flat, "params/"),
                hashes=meta["hashes"],
                keys=[tuple(k) for k in meta["keys"]])


def test_plan_holds_a_group_above_degree_one(reference):
    degrees = [g.degree for mb in reference["plan"].micro_batches
               for g in mb.groups]
    assert max(degrees) > 1, degrees


def test_dynamic_plan_matches_jax_executor_and_static_plan(reference):
    eng = _engine(reference["params0"])
    data = _batch(eng.cfg.vocab)
    plan = reference["plan"]
    loss, grads = eng.executor.run_plan(eng.state.params, plan, data)
    keys = eng.executor.last_exe_keys
    assert any(k[2] > 1 for k in keys), keys
    assert abs(float(loss) - reference["loss0"]) <= LOSS_TOL
    _assert_trees_close(grads, reference["grads0"], GRAD_TOL)

    splan = static_plan(data.infos, eng.cost_model, RANKS, BUDGET)
    assert all(g.degree == 1 for mb in splan.micro_batches
               for g in mb.groups)
    s_loss, s_grads = eng.executor.run_plan(eng.state.params, splan, data)
    eng.close()
    assert abs(float(loss) - float(s_loss)) <= LOSS_TOL
    _assert_trees_close(grads, s_grads, GRAD_TOL)


def test_engine_train_at_eight_ranks_matches_jax(reference):
    eng = _engine(reference["params0"])
    plans = []
    hist = eng.train(steps=2, lookahead=False, plan_log=plans, **RUN)
    eng.close()
    assert [p.structural_hash() for p in plans] == reference["hashes"]
    assert eng.executor.last_exe_keys == reference["keys"]
    assert any(max(m.degree_histogram) > 1 for m in hist)
    np.testing.assert_allclose([m.loss for m in hist],
                               reference["losses"], atol=LOSS_TOL)
    _assert_trees_close(eng.state.params, reference["params"], GRAD_TOL)


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-2b"])
def test_padded_families_refuse_a_ring(arch):
    """Their recurrent state would cross the shard borders; the model
    refuses a ring rather than restart the state on every shard."""
    cfg = get_config(arch).reduced()
    params = init_params(cfg, device="cpu")
    batch = {"tokens": np.zeros((2, 8), np.int64)}
    with pytest.raises(NotImplementedError, match="recurrent state"):
        forward_hidden(params, cfg, batch, ring=LocalRing(2))
