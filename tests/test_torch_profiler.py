"""The port's Profiler against the JAX package's on the CPU.

  * the same samples (the reference test's grid of known `CostModel`
    times, L x d x eta) give the same fitted coefficients, `error()` and
    `predict()`, to 1e-9 relative, and the error stays under the
    paper's 8%;
  * `profiling_grid` is the reference's for several `max_len`;
  * `fit()` on no samples raises;
  * the measure path of `chip_smoke.py` (one sequence a sample, planned
    as one group and timed by `executor.run_plan(timings=...)`) on
    reduced internvl3-2b on the CPU: samples collected, coefficients
    finite and >= 0, predictions > 0, K1's plain version called and no
    kernel launched, and `profile_tables` (the tables phase 46 holds K1
    to its plain version at) equal to the tables the timed groups gave
    K1. No bound is put on a MAPE of CPU wall time; the
    measure function itself times the card's groups only and raises on
    a CPU engine.
"""
import dataclasses
import importlib.util
import math
import os

import pytest
import torch

from repro.core import CostModel as JCostModel
from repro.core import Profiler as JProfiler
from repro.core import SeqInfo as JSeqInfo
from repro.core import analytic_coeffs as janalytic_coeffs
from repro.core import profiling_grid as jprofiling_grid
from repro_torch.core import CostModel, Profiler, SeqInfo, analytic_coeffs
from repro_torch.core import profiling_grid

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

ROOT = os.path.join(os.path.dirname(__file__), "..")
#: the fits solve the same least-squares system on the same numbers
RTOL = 1e-9
#: the reference test's model and grid
SHAPE = dict(hidden=2048, n_layers=24, n_heads=16, kv_heads=8, ffn=8192,
             vocab=50000)
LENGTHS = (512, 1024, 2048, 4096, 8192)
DEGREES = (1, 2, 3, 4, 6, 8)
ETAS = (0.0, 0.5, 1.0)


def _close(a, b, rtol=RTOL):
    return math.isclose(a, b, rel_tol=rtol, abs_tol=0.0) or a == b


def _fitted():
    """(JAX Profiler, port Profiler) fed the same samples: the JAX
    cost model's times over the reference test's grid."""
    true = JCostModel(janalytic_coeffs(**SHAPE))
    port_true = CostModel(analytic_coeffs(**SHAPE))
    jprof, prof = JProfiler(hw=true.hw), Profiler()
    for L in LENGTHS:
        for d in DEGREES:
            for eta in ETAS:
                t = true.group_time([JSeqInfo(length=L, eta=eta)], d)
                assert t == port_true.group_time([SeqInfo(length=L,
                                                          eta=eta)], d)
                jprof.add_sample(L, d, eta, t)
                prof.add_sample(L, d, eta, t)
    return jprof, prof


def test_fit_equals_reference():
    jprof, prof = _fitted()
    want, got = jprof.fit(), prof.fit()
    for name, w in dataclasses.asdict(want).items():
        assert _close(getattr(got, name), w), (name, getattr(got, name), w)
    assert _close(prof.error(), jprof.error())
    assert prof.error() < 8.0, f"estimator error {prof.error()}% (paper: <8%)"
    for L, d, eta in ((700, 1, 0.3), (3000, 5, 0.0), (9000, 8, 1.0)):
        assert _close(prof.predict(L, d, eta), jprof.predict(L, d, eta))
    holdout = jprof.samples[::7]
    assert _close(prof.error(holdout), jprof.error(holdout))


@pytest.mark.parametrize("max_len", [256, 512, 1000, 4096, 65536])
def test_profiling_grid_equals_reference(max_len):
    assert profiling_grid(max_len) == jprofiling_grid(max_len)


def test_fit_without_samples_raises():
    with pytest.raises(RuntimeError, match="no samples"):
        Profiler().fit()
    with pytest.raises(RuntimeError, match="no samples"):
        Profiler().cost_model()


def test_collect_calls_measure_over_the_grid():
    seen = []

    def measure(L, d, eta):
        seen.append((L, d, eta))
        return 1e-3 * L / d

    prof, jprof = Profiler(), JProfiler()
    prof.collect(measure, [512, 1024], [1, 2], etas=(0.0, 0.5))
    jprof.collect(measure, [512, 1024], [1, 2], etas=(0.0, 0.5))
    assert seen[:8] == seen[8:] and len(seen) == 16
    assert [dataclasses.astuple(s) for s in prof.samples] == \
        [dataclasses.astuple(s) for s in jprof.samples]


@pytest.fixture
def one_thread():
    """torch on one thread, restored after: the suite's workers share the
    machine's cores, and a reduced model's many small ops slow down most
    when every worker's threads contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_measure_path_on_cpu(one_thread, monkeypatch):
    from repro_torch.api import ClusterSpec, Engine
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention_packed as k1

    smoke = _chip_smoke()
    calls = []
    plain = k1.flash_attention_packed_ref

    def counting(*a, **kw):
        calls.append((a[0].shape, a[3], kw.get("span_ids")))
        return plain(*a, **kw)
    monkeypatch.setattr(k1, "flash_attention_packed_ref", counting)
    k1.flash_attention_packed.launches = 0
    k1.flash_attention_packed_bwd.launches = 0
    # K1's path (attn_impl="cuda"), its plain version on CPU tensors
    cfg = get_config("internvl3-2b").reduced().with_(attn_impl="cuda")
    eng = Engine(cfg, ClusterSpec.auto(device="cpu", mem_budget=512,
                                       bucketing="mult256"), seed=0)
    with pytest.raises(RuntimeError, match="card"):
        smoke.measure_fn(eng)
    # the spans realise each eta
    for L, eta in ((128, 0.25), (96, 1.0), (64, 0.0)):
        info = smoke.profile_batch(L, eta, eng.cfg.vocab).infos[0]
        assert info.length == L and info.eta == pytest.approx(eta)

    def measure(L, d, eta):
        return smoke.time_group(eng, L, eta, warmup=1, reps=1)[0]

    prof = Profiler(m_token=1.0, m_ms=0.0)
    prof.collect(measure, [64, 128, 256], [1], etas=(0.0, 1.0))
    assert len(prof.samples) == 6
    assert all(s.time_s > 0 for s in prof.samples)
    fit = prof.fit()
    assert all(math.isfinite(c) and c >= 0
               for c in (fit.a1, fit.a2, fit.b1, fit.a3))
    assert (fit.m_token, fit.m_ms) == (1.0, 0.0)
    assert all(prof.predict(L, 1, eta) > 0 for L, eta in ((64, 0.0),
                                                          (200, 0.5)))
    assert math.isfinite(prof.error())
    # 6 samples x 2 runs x n_layers through K1's plain forward, no launch
    assert len(calls) == 12 * eng.cfg.n_layers
    # the tables the card's rows are checked at are the timed groups'
    per_sample = 2 * eng.cfg.n_layers
    for i, s in enumerate(prof.samples):
        bucket, seg, span = smoke.profile_tables(eng, s.length, s.eta)
        assert bucket == 256 * -(-s.length // 256)
        for shape, got_seg, got_span in calls[i * per_sample:
                                              (i + 1) * per_sample]:
            assert shape[1] == bucket
            assert got_seg.reshape(-1).tolist() == seg.tolist()
            assert got_span.reshape(-1).tolist() == span.tolist()
    assert k1.flash_attention_packed.launches == 0
    assert k1.flash_attention_packed_bwd.launches == 0
    # the fitted model prices the engine's plans
    fitted = smoke.fitted_cost_model(dataclasses.asdict(fit), eng.cfg)
    assert fitted.coeffs.a1 == fit.a1
    assert fitted.coeffs.a3 == eng.cost_model.coeffs.a3
    eng.close()
