"""The port's serving slice vs the JAX package: ServingEngine token
streams on converted weights, the copied planner stack's plans, and the
rule that the port imports neither JAX nor `repro`."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
from repro.api import Engine as JaxEngine
from repro.api import get_strategy as jax_get_strategy
from repro.api.engine import demo_cost_model as jax_demo_cost_model
from repro.configs import get_config as jax_get_config
from repro.core.cost_model import ModalitySpan as JaxSpan
from repro.serving.kv_cache import KVCacheManager as JaxKV
from repro.serving.scheduler import (ContinuousBatchingScheduler as
                                     JaxScheduler)
from repro.serving.scheduler import ServeRequest as JaxRequest
from repro.serving.trace import sample_trace
from repro_torch.api import Engine, demo_cost_model, get_strategy
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.cost_model import ModalitySpan
from repro_torch.serving.kv_cache import KVCacheManager
from repro_torch.training import TrainState
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler,
                                           ServeRequest)

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
JCFG = jax_get_config("internvl3-2b").reduced().with_(attn_impl="pallas")
TCFG = get_config("internvl3-2b").reduced().with_(attn_impl="cuda")


@pytest.fixture(scope="module")
def engines():
    jeng = JaxEngine(JCFG, strategy="dhp", seed=0)
    eng = Engine(TCFG, device="cpu", seed=0)
    eng.state = TrainState(params=params_from_numpy(
        jax.tree.map(np.asarray, jeng.state.params)))
    return jeng, eng


def _spans(cls):
    return (cls("text", 0, 6), cls("vision", 6, 12, "bidirectional"),
            cls("text", 18, 12))


def _trace(cls, span_cls, with_span: bool):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, TCFG.vocab, size=L, dtype=np.int32)
               for L in (21, 5, 1, 30)]
    reqs = [cls(request_id=i, tokens=p, max_new_tokens=4)
            for i, p in enumerate(prompts[:3])]
    if with_span:
        reqs.append(cls(request_id=3, tokens=prompts[3], max_new_tokens=4,
                        spans=_spans(span_cls)))
    return reqs


@pytest.mark.parametrize("chunk,with_span", [(8, False), (64, False),
                                             (8, True)])
def test_serving_streams_match_jax(engines, chunk, with_span):
    jeng, eng = engines
    jrep = jeng.serving(slots=2, prefill_chunk=chunk).run(
        _trace(JaxRequest, JaxSpan, with_span))
    rep = eng.serving(slots=2, prefill_chunk=chunk).run(
        _trace(ServeRequest, ModalitySpan, with_span))
    assert [m.tokens for m in rep.requests] == \
        [m.tokens for m in jrep.requests]
    assert rep.total_tokens == jrep.total_tokens == 4 * len(rep.requests)
    assert rep.n_prefill_chunks == jrep.n_prefill_chunks
    assert rep.n_decode_steps == jrep.n_decode_steps


def test_static_strategy_serves_the_same_streams(engines):
    """The prefill plan only groups chunks: `strategy="static"` gives the
    streams `dhp` gives, as the JAX runtime's `strategy=` does."""
    _, eng = engines
    reps = {name: eng.serving(slots=2, prefill_chunk=8, strategy=name).run(
        _trace(ServeRequest, ModalitySpan, True))
        for name in ("dhp", "static")}
    assert [m.tokens for m in reps["static"].requests] == \
        [m.tokens for m in reps["dhp"].requests]
    assert reps["static"].plan_cache != {}
    with pytest.raises(KeyError, match="unknown strategy"):
        eng.serving(strategy="megatron")


def _plan_hashes(sched_cls, kv_cls, planner, reqs, chunk=32):
    """Host-only lifecycle run; the structural hash of every plan."""
    kv = kv_cls(2, 64, 16)
    sched = sched_cls(kv, planner, prefill_chunk=chunk)
    for r in reqs:
        sched.submit(r)
    hashes = []
    while sched.has_work():
        it = sched.step()
        if it.plan is not None:
            hashes.append(it.plan.structural_hash())
        for g in it.prefill_groups:
            for c in g.chunks:
                sched.mark_prefilled(c.request_id, c.length)
        for rid in it.decode_ids:
            st = sched.states[rid]
            st.generated.append(0)
            if len(st.generated) >= st.request.max_new_tokens:
                sched.finish(rid, 0.0)
    return hashes


def test_planner_copies_give_jax_plans():
    """A sampled span-bearing trace through both schedulers and DHP
    planners (8 ranks): every iteration's plan hashes the same."""
    jreqs = sample_trace("openvid", 10, np.random.default_rng(3),
                         max_prompt=200, max_new_tokens=6)
    reqs = [ServeRequest(
        request_id=r.request_id, tokens=r.tokens,
        max_new_tokens=r.max_new_tokens, eta=r.eta,
        spans=tuple(ModalitySpan(s.modality, s.start, s.length, s.attn)
                    for s in r.spans))
        for r in jreqs]
    jplanner = jax_get_strategy("dhp").bind(jax_demo_cost_model(JCFG), 8,
                                            1024.0)
    planner = get_strategy("dhp").bind(demo_cost_model(TCFG), 8, 1024.0)
    want = _plan_hashes(JaxScheduler, JaxKV, jplanner, jreqs)
    got = _plan_hashes(ContinuousBatchingScheduler, KVCacheManager,
                       planner, reqs)
    assert len(want) > 3 and got == want
    assert planner.plan_cache.stats["hits"] == \
        jplanner.plan_cache.stats["hits"]


def test_port_imports_neither_jax_nor_repro():
    script = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'repro')\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "assert {'repro_torch.models.rglru',\n"
        "        'repro_torch.kernels.rglru_scan',\n"
        "        'repro_torch.configs.recurrentgemma_2b'} <= set(names)\n"
        "print(len(names))\n")
    r = subprocess.run([sys.executable, "-c", script],
                       env={**os.environ, "PYTHONPATH": SRC},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 25
