"""The port's planner layer against the JAX package's on the CPU.

Both packages get the same inputs (the same cost coefficients, batches
drawn by each package's `sample_mm_batch` from one seed, the same
timings) and must give the same answers:

  * the strategy registry: the same names, classes' options and
    defaults, and for every name the same plans over a stream of
    batches at 4, 6 and 8 ranks (`to_json()` equal apart from the
    fields that hold measured host time, `structural_hash()` equal);
  * the Stage-2 solvers (`allocate`, `allocate_reference`,
    `allocate_bruteforce`, `allocate_many`, `evaluate_degrees`,
    `IncrementalAllocator`), `use_all_ranks=False` included: equal
    degrees and makespans, to the bit;
  * the scheduler's options, `static_plan(degree=, power_of_two=)`,
    `PlanCache.nearest`, `GroupDelta.summary`, `ExecutionPlan.n_groups`;
  * plan files: either package's `save_plans` loads in the other, and
    `ReplayStrategy` replays a JAX-saved trace with equal hashes and
    rank slots and raises on a drifted stream;
  * the oracle: `MeasuredCostModel`, `observe` skipping compile-tainted
    timings, `plan_cost` on the same timings;
  * the run report: `build_report` (and `step_model_error`,
    `wave_stats`, `straggler_scores`) on the same recorded plans and
    timings gives the same JSON, floats within 1e-12 relative;
  * `validate_trace` and `sample_trace`.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.api as japi
import repro.core as jcore
import repro.obs as jobs
from repro.api.engine import StepMetrics as JStepMetrics
from repro.core.packing import AtomicGroup as JAtomicGroup
from repro.serving.trace import sample_trace as jsample_trace
import repro_torch.api as tapi
import repro_torch.core as tcore
import repro_torch.obs as tobs
from repro_torch.api.engine import StepMetrics as TStepMetrics
from repro_torch.core.packing import AtomicGroup as TAtomicGroup
from repro_torch.serving.trace import sample_trace as tsample_trace

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

#: plan fields that hold measured host time, not plan content
HOST_TIME_FIELDS = ("schedule_ms", "solver_ms", "stage_ms")
#: the report's floats: sums over the same values in the same order
REPORT_RTOL = 1e-12
RANKS = (4, 6, 8)
BUDGET = 1500.0
NAMES = tuple(japi.available_strategies())


def _cost_model(pkg):
    return pkg.CostModel(dataclasses.replace(
        pkg.analytic_coeffs(hidden=1024, n_layers=8, n_heads=8,
                            kv_heads=4, ffn=4096, vocab=32000),
        m_ms=0.0, m_token=1.0))


JCM, TCM = _cost_model(jcore), _cost_model(tcore)


def _stream(pkg, seed, n_batches=3, n=10, max_tokens=3000):
    """A stream of span-bearing batches (the second repeats the first's
    shape under new ids, so the plan cache serves it)."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        mm = pkg.sample_mm_batch("openvid", n, rng, max_tokens=max_tokens)
        out.append([dataclasses.replace(m.seq_info, seq_id=100 * b + i)
                    for i, m in enumerate(mm)])
    if n_batches > 1:
        out[1] = [dataclasses.replace(s, seq_id=50 + s.seq_id)
                  for s in out[0]]
    return out


def _plan_doc(plan) -> dict:
    doc = plan.to_json()
    for k in HOST_TIME_FIELDS:
        doc.pop(k)
    return doc


def _same_alloc(a, b):
    assert a.degrees == b.degrees and a.makespan == b.makespan, (a, b)
    assert a.ranks_used == b.ranks_used


# ------------------------------------------------------------ registry
def test_available_strategies_equal():
    assert tapi.available_strategies() == japi.available_strategies()
    assert set(NAMES) == {"static", "megatron", "deepspeed", "dhp",
                          "dhp-faithful", "bruteforce", "oracle"}


@pytest.mark.parametrize("name", NAMES)
def test_registry_entry_options_equal(name):
    """The same class (by name), the same registered defaults and the
    same constructed options; `get_strategy(name, **options)` overrides
    them as the JAX registry does."""
    jcls, jdef = japi.STRATEGY_REGISTRY[name]
    tcls, tdef = tapi.STRATEGY_REGISTRY[name]
    assert tcls.__name__ == jcls.__name__
    assert tdef == jdef
    j, t = japi.get_strategy(name), tapi.get_strategy(name)
    assert t.name == j.name == name
    assert not t.is_bound
    assert t.wants_measurement == j.wants_measurement
    for attr in ("degree", "power_of_two"):
        assert getattr(t, attr, None) == getattr(j, attr, None)
    jopt, topt = getattr(j, "options", {}), getattr(t, "options", {})
    assert {k: getattr(v, "__name__", v) for k, v in topt.items()} == \
        {k: getattr(v, "__name__", v) for k, v in jopt.items()}
    assert (t.plan_cache is None) == (j.plan_cache is None)
    if name == "static":
        assert tapi.get_strategy(name, degree=4).degree == 4
    with pytest.raises(KeyError, match="unknown strategy"):
        tapi.get_strategy(name + "-nope")


@pytest.mark.parametrize("n_ranks", RANKS)
@pytest.mark.parametrize("name", NAMES)
def test_plans_equal_field_by_field(name, n_ranks):
    """Three batches through one bound strategy of each package: every
    plan's JSON equal apart from HOST_TIME_FIELDS, its hash equal, and
    the cache / incremental paths taken alike (`from_cache`,
    `replan_mode` are in the JSON)."""
    j = japi.get_strategy(name).bind(JCM, n_ranks, BUDGET)
    t = tapi.get_strategy(name).bind(TCM, n_ranks, BUDGET)
    jb, tb = _stream(jcore, 7 + n_ranks), _stream(tcore, 7 + n_ranks)
    for jseqs, tseqs in zip(jb, tb):
        assert [(s.length, s.eta) for s in tseqs] == \
            [(s.length, s.eta) for s in jseqs]
        jp, tp = j.plan(jseqs), t.plan(tseqs)
        assert tp.structural_hash() == jp.structural_hash()
        assert _plan_doc(tp) == _plan_doc(jp)
        tp.validate(tseqs, n_ranks=n_ranks, cost_model=TCM,
                    mem_budget=BUDGET)
    if name == "deepspeed":
        assert all(d & (d - 1) == 0 for d in tp.degree_histogram)


def test_unbound_strategy_raises():
    with pytest.raises(RuntimeError, match="unbound"):
        tapi.get_strategy("dhp").plan(
            [tcore.SeqInfo(length=100, seq_id=0)])


def test_lookahead_window_is_a_fifo():
    """prepare() k times, then collect() k times: the plans come back in
    the order their batches went in, each equal to a synchronous plan."""
    t = tapi.get_strategy("dhp", plan_cache=False).bind(TCM, 8, BUDGET)
    ref = tapi.get_strategy("dhp", plan_cache=False).bind(TCM, 8, BUDGET)
    batches = _stream(tcore, 3)
    t.prepare_many(batches)
    assert t.n_pending == len(batches)
    for seqs in batches:
        assert t.collect().structural_hash() == \
            ref.plan(seqs).structural_hash()
    with pytest.raises(RuntimeError):
        t.collect()
    t.close()


def test_register_new_strategy_is_one_entry():
    @tapi.register_strategy("all-ones-port-test")
    class AllOnes(tapi.Strategy):
        def _plan(self, seqs):
            groups = [tcore.GroupPlan([s.seq_id], 1,
                                      self.cm.group_time([s], 1), s.length)
                      for s in seqs]
            mk = max(g.est_time for g in groups)
            return tcore.ExecutionPlan(
                [tcore.MicroBatchPlan(groups, mk, len(groups))], mk, 0.0,
                0.0)
    try:
        plan = tapi.get_strategy("all-ones-port-test").bind(
            TCM, 8, 1e4).plan([tcore.SeqInfo(length=n, seq_id=i)
                               for i, n in enumerate((100, 200))])
        assert plan.strategy_name == "all-ones-port-test"
        assert plan.degree_histogram == {1: 2} and plan.n_groups == 2
    finally:
        del tapi.STRATEGY_REGISTRY["all-ones-port-test"]


# ------------------------------------------------------------ allocator
def _groups(pkg, group_cls, seed, n_groups, n_ranks, with_spans):
    """tests/test_allocator.py's random feasible instance, built in each
    package from one seed."""
    rng = np.random.default_rng(seed)
    if with_spans:
        seqs = [m.seq_info for m in pkg.sample_mm_batch(
            "openvid", n_groups, rng, max_tokens=4096)]
    else:
        seqs = [pkg.SeqInfo(length=int(rng.integers(64, 4096)),
                            eta=float(rng.choice([0.0, 0.25, 1.0])),
                            seq_id=i) for i in range(n_groups)]
    slack = n_ranks - n_groups
    groups = []
    for s in seqs:
        d_min = 1 + int(rng.integers(0, slack + 1)) if slack > 0 else 1
        slack -= d_min - 1
        groups.append(group_cls(seqs=[s], d_min=d_min, capacity=1e12,
                                used=0.0))
    return groups


@pytest.mark.parametrize("use_all_ranks", (True, False))
@pytest.mark.parametrize("seed", range(4))
def test_solvers_equal_the_jax_solvers(seed, use_all_ranks):
    n_groups, n_ranks = 2 + seed, 6 + 2 * seed
    spans = seed % 2 == 1
    jg = _groups(jcore, JAtomicGroup, seed, n_groups, n_ranks, spans)
    tg = _groups(tcore, TAtomicGroup, seed, n_groups, n_ranks, spans)
    for fn in ("allocate", "allocate_reference"):
        j = getattr(jcore, fn)(jg, n_ranks, JCM.group_time,
                               use_all_ranks=use_all_ranks)
        t = getattr(tcore, fn)(tg, n_ranks, TCM.group_time,
                               use_all_ranks=use_all_ranks)
        _same_alloc(t, j)
        _same_alloc(t, tcore.allocate_reference(
            tg, n_ranks, TCM.group_time, use_all_ranks=use_all_ranks))
    bf = tcore.allocate_bruteforce(tg, n_ranks, TCM.group_time)
    _same_alloc(bf, jcore.allocate_bruteforce(jg, n_ranks, JCM.group_time))
    # the exhaustive optimum never beats the DP (which leaves ranks idle
    # when that is better)
    assert tcore.allocate(tg, n_ranks, TCM.group_time,
                          use_all_ranks=False).makespan == bf.makespan
    ev = tcore.evaluate_degrees([g.seqs for g in tg], bf.degrees,
                                TCM.group_time)
    assert ev.makespan == bf.makespan
    assert ev.makespan == jcore.evaluate_degrees(
        [g.seqs for g in jg], bf.degrees, JCM.group_time).makespan


@pytest.mark.parametrize("use_all_ranks", (True, False))
def test_allocate_many_and_incremental_equal(use_all_ranks):
    tb = [_groups(tcore, TAtomicGroup, 11 + i, 5, 16, i % 2 == 0)
          for i in range(3)]
    jb = [_groups(jcore, JAtomicGroup, 11 + i, 5, 16, i % 2 == 0)
          for i in range(3)]
    tb.append(tb[0])
    jb.append(jb[0])
    tm = tcore.allocate_many(tb, 16, TCM.group_time,
                             use_all_ranks=use_all_ranks)
    jm = jcore.allocate_many(jb, 16, JCM.group_time,
                             use_all_ranks=use_all_ranks)
    tinc, jinc = tcore.IncrementalAllocator(), jcore.IncrementalAllocator()
    for t, j, tg, jg in zip(tm, jm, tb, jb):
        _same_alloc(t, j)
        assert (t.mode, t.rows_reused) == (j.mode, j.rows_reused)
        ti = tinc(tg, 16, TCM.group_time, use_all_ranks=use_all_ranks)
        ji = jinc(jg, 16, JCM.group_time, use_all_ranks=use_all_ranks)
        _same_alloc(ti, ji)
        assert (ti.mode, ti.rows_reused) == (ji.mode, ji.rows_reused)
    assert tm[-1].mode == "incremental"


# ------------------------------------------------------------ scheduler
SCHEDULER_OPTIONS = (
    dict(use_all_ranks=False),
    dict(balance_packing=False, serial_fallback=False),
    dict(incremental=False),
    dict(allocator="allocate_bruteforce", serial_fallback=False),
)


@pytest.mark.parametrize("opts", range(len(SCHEDULER_OPTIONS)))
def test_scheduler_options_equal(opts):
    kw = dict(SCHEDULER_OPTIONS[opts])
    jkw, tkw = dict(kw), dict(kw)
    if "allocator" in kw:
        jkw["allocator"] = getattr(jcore, kw["allocator"])
        tkw["allocator"] = getattr(tcore, kw["allocator"])
    js = jcore.DHPScheduler(JCM, 6, BUDGET, **jkw)
    ts = tcore.DHPScheduler(TCM, 6, BUDGET, **tkw)
    for jseqs, tseqs in zip(_stream(jcore, 20 + opts),
                            _stream(tcore, 20 + opts)):
        jp, tp = js.schedule(jseqs), ts.schedule(tseqs)
        assert _plan_doc(tp) == _plan_doc(jp)
        assert tp.n_groups == jp.n_groups


@pytest.mark.parametrize("degree,power_of_two",
                         [(None, False), (None, True), (3, False), (3, True),
                          (16, False)])
def test_static_plan_options_equal(degree, power_of_two):
    jseqs, tseqs = _stream(jcore, 5, 1)[0], _stream(tcore, 5, 1)[0]
    jp = jcore.static_plan(jseqs, JCM, 8, BUDGET, degree=degree,
                           power_of_two=power_of_two)
    tp = tcore.static_plan(tseqs, TCM, 8, BUDGET, degree=degree,
                           power_of_two=power_of_two)
    assert _plan_doc(tp) == _plan_doc(jp)
    if power_of_two:
        assert all(d & (d - 1) == 0 for d in tp.degree_histogram)


def test_plan_cache_nearest_and_delta_summary_equal():
    """PlanCache.nearest on the same stored plans (none, fallback and
    exact, with their counters), GroupDelta.summary and n_groups."""
    caches = []
    for pkg, cm in ((jcore, JCM), (tcore, TCM)):
        sched = pkg.DHPScheduler(cm, 8, mem_budget=4096.0)
        cache = pkg.PlanCache()
        got = [cache.nearest([pkg.SeqInfo(length=256, seq_id=0)])]
        a = [pkg.SeqInfo(length=256, seq_id=i) for i in range(4)]
        b = [pkg.SeqInfo(length=1024, seq_id=i) for i in range(4)]
        pa, pb = sched.schedule(a), sched.schedule(b)
        cache.store(a, pa)
        cache.store(b, pb)
        near = [pkg.SeqInfo(length=1024, seq_id=i) for i in range(3)] + \
            [pkg.SeqInfo(length=256, seq_id=3)]
        got += [cache.nearest(near), cache.nearest(b)]
        delta = pkg.diff_plans(pa, pb, 8)
        caches.append(([None if p is None else p.structural_hash()
                        for p in got], dict(cache.stats), delta.summary(),
                       pa.n_groups, pb.n_groups))
    assert caches[1] == caches[0]
    assert caches[1][0][1] == caches[1][0][2] is not None


# ------------------------------------------------------------ plan files
@pytest.mark.parametrize("saver", ("port", "jax"))
def test_plan_files_cross_over(saver, tmp_path):
    """One package saves a stream's plans, the other loads them: the
    same JSON and hashes; the loaded plans save back to the same file."""
    j = japi.get_strategy("dhp").bind(JCM, 8, BUDGET)
    t = tapi.get_strategy("dhp").bind(TCM, 8, BUDGET)
    jplans = [j.plan(s) for s in _stream(jcore, 31)]
    tplans = [t.plan(s) for s in _stream(tcore, 31)]
    path, again = str(tmp_path / "plans.json"), str(tmp_path / "again.json")
    (save, load) = ((tcore.save_plans, jcore.load_plans) if saver == "port"
                    else (jcore.save_plans, tcore.load_plans))
    save(path, tplans if saver == "port" else jplans)
    loaded = load(path)
    for got, want in zip(loaded, jplans):
        assert got.structural_hash() == want.structural_hash()
        assert _plan_doc(got) == _plan_doc(want)
    (jcore if saver == "port" else tcore).save_plans(again, loaded)
    with open(path) as f, open(again) as g:
        assert json.load(f) == json.load(g)


def test_replay_of_a_jax_saved_trace(tmp_path):
    """ReplayStrategy over a JAX-saved file: each plan's hash and rank
    slots equal the recorded ones (its own span table kept), the cursor
    runs out after the last; a batch with one more sequence than the
    recorded plan covers raises."""
    n = 6
    j = japi.get_strategy("dhp").bind(JCM, n, BUDGET)
    jstream, tstream = _stream(jcore, 41), _stream(tcore, 41)
    jplans = [j.plan(s) for s in jstream]
    path = str(tmp_path / "plans.json")
    jcore.save_plans(path, jplans)
    rs = tapi.ReplayStrategy(plans=tcore.load_plans(path)).bind(
        TCM, n, BUDGET)
    assert len(rs) == len(jplans)
    for seqs, want in zip(tstream, jplans):
        got = rs.plan(seqs)
        assert got.strategy_name == "replay"
        assert got.structural_hash() == want.structural_hash()
        assert got.group_slots(n) == want.group_slots(n)
    assert len(rs) == 0
    with pytest.raises(RuntimeError, match="exhausted"):
        rs.plan(tstream[0])
    drifted = tapi.ReplayStrategy(plans=tcore.load_plans(path)).bind(
        TCM, n, BUDGET)
    extra = tstream[0] + [tcore.SeqInfo(length=64, seq_id=999)]
    with pytest.raises(tcore.PlanValidationError, match="coverage"):
        drifted.plan(extra)


# ------------------------------------------------------------ the oracle
def _timings(plan, seed):
    """Per-group timing dicts as the executor writes them, the first
    group of each wave compile-tainted."""
    rng = np.random.default_rng(seed)
    out = []
    for mb in plan.micro_batches:
        for gi, g in enumerate(mb.groups):
            out.append({"seq_ids": list(g.seq_ids), "degree": g.degree,
                        "tokens": g.tokens,
                        "seconds": float(rng.uniform(0.01, 0.2)),
                        "compiled": gi == 0})
    return out


def test_measured_cost_model_equal():
    jm, tm = japi.MeasuredCostModel(JCM), tapi.MeasuredCostModel(TCM)
    probes = [([1000], 2), ([8000], 4), ([300, 700], 1), ([5000], 8)]
    for m in (jm, tm):
        m.record(tokens=1000, degree=2, seconds=42.0)
        m.record(tokens=1024, degree=2, seconds=40.0)
        m.record(tokens=6000, degree=4, seconds=3.0)
    got = []
    for pkg, m in ((jcore, jm), (tcore, tm)):
        got.append([m.group_time([pkg.SeqInfo(length=n, seq_id=i)
                                  for i, n in enumerate(lens)], d)
                    for lens, d in probes] + [m.n_samples, m.cost_version])
    assert got[1] == got[0]


def test_oracle_observe_and_plan_cost_equal():
    """observe() skips compile-tainted timings (one sample per clean
    group), and plan_cost prices a static plan and the oracle's own
    under the measured table as the JAX oracle does; the oracle's next
    plan, made from those measurements, is the JAX one."""
    j = japi.get_strategy("oracle").bind(JCM, 8, BUDGET)
    t = tapi.get_strategy("oracle").bind(TCM, 8, BUDGET)
    jseqs, tseqs = _stream(jcore, 51, 2), _stream(tcore, 51, 2)
    jp, tp = j.plan(jseqs[0]), t.plan(tseqs[0])
    assert _plan_doc(tp) == _plan_doc(jp)
    timings = _timings(tp, 3)
    j.observe(jp, timings)
    t.observe(tp, timings)
    assert t.measured.n_samples == sum(not x["compiled"] for x in timings)
    assert t.measured.n_samples == j.measured.n_samples > 0
    jst = jcore.static_plan(jseqs[0], JCM, 8, BUDGET)
    tst = tcore.static_plan(tseqs[0], TCM, 8, BUDGET)
    assert t.plan_cost(tst, tseqs[0]) == j.plan_cost(jst, jseqs[0])
    assert t.plan_cost(tp, tseqs[0]) == j.plan_cost(jp, jseqs[0])
    assert _plan_doc(t.plan(tseqs[1])) == _plan_doc(j.plan(jseqs[1]))


# ------------------------------------------------------------ the report
def _close(got, want, path="doc"):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=REPORT_RTOL, abs=0.0), path
    else:
        assert got == want, path


def _recorded(pkg_api, pkg_core, pkg_obs, step_cls, cm, stream):
    strat = pkg_api.get_strategy("dhp").bind(cm, 8, BUDGET)
    rec = pkg_obs.RunRecorder(8)
    history = []
    for step, seqs in enumerate(stream):
        plan = strat.plan(seqs)
        timings = _timings(plan, 60 + step)
        if step == 0:
            for x in timings:
                x["compiled"] = True       # a cold first step
        rec.record_step(step, plan, timings)
        history.append(step_cls(
            step=step, loss=1.0 / (step + 1), tokens=plan.n_groups,
            step_time_s=0.5, strategy="dhp", schedule_ms=0.0,
            solver_ms=0.0, stage_ms={}, degree_histogram=dict(
                plan.degree_histogram),
            model_error_pct=pkg_obs.step_model_error(plan, timings)))
    return rec, history


def test_build_report_equal_on_the_same_records():
    jrec, jhist = _recorded(japi, jcore, jobs, JStepMetrics, JCM,
                            _stream(jcore, 71, 4))
    trec, thist = _recorded(tapi, tcore, tobs, TStepMetrics, TCM,
                            _stream(tcore, 71, 4))
    assert [r.to_json() for r in trec.records] == \
        [r.to_json() for r in jrec.records]
    metrics = {"train/steps": 4}
    jr = jobs.build_report(jrec, jhist, metrics=metrics)
    tr = tobs.build_report(trec, thist, metrics=metrics)
    tdoc = json.loads(json.dumps(tr.to_json()))
    _close(tdoc, json.loads(json.dumps(jr.to_json())))
    assert tr.summary() == jr.summary()
    _close(tobs.wave_stats(trec.records), jobs.wave_stats(jrec.records))
    _close({str(k): v for k, v in tobs.straggler_scores(
        trec.records, 8).items()}, {str(k): v for k, v in
                                    jobs.straggler_scores(
                                        jrec.records, 8).items()})
    assert tdoc["model_error"]["n_samples"] > 0
    assert tobs.scale_fit_mape([1.0, 1.0], [0.0, 2.0]) == \
        jobs.scale_fit_mape([1.0, 1.0], [0.0, 2.0])


def test_report_save_and_group_record_round_trip(tmp_path):
    trec, thist = _recorded(tapi, tcore, tobs, TStepMetrics, TCM,
                            _stream(tcore, 72, 2))
    path = str(tmp_path / "report.json")
    tobs.build_report(trec, thist).save(path)
    with open(path) as f:
        doc = json.load(f)
    assert doc["version"] == 1 and doc["n_steps"] == 2
    back = [jobs.GroupRecord.from_json(r.to_json()) for r in trec.records]
    assert [tobs.GroupRecord.from_json(b.to_json()) for b in back] == \
        trec.records


# ------------------------------------------------------------ traces
def test_validate_trace_agrees_with_jax():
    tracer = tobs.Tracer()
    with tobs.tracing(tracer):
        tapi.get_strategy("dhp").bind(TCM, 8, BUDGET).plan(
            _stream(tcore, 81, 1)[0])
    doc = json.loads(json.dumps(tracer.to_json()))
    assert tobs.validate_trace(doc) == jobs.validate_trace(doc) > 0
    bad = [{"traceEvents": [{"name": "x", "ph": "X", "pid": 0, "tid": 0,
                             "ts": 1.0}]},
           {"traceEvents": [{"name": "x", "ph": "Q", "pid": 0, "tid": 0}]},
           {"traceEvents": [{"name": "x", "ph": "i", "pid": 0, "tid": 0,
                             "ts": -1}]},
           {"events": []}]
    for obj in bad:
        with pytest.raises(ValueError) as te:
            tobs.validate_trace(obj)
        with pytest.raises(ValueError) as je:
            jobs.validate_trace(obj)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("kw", [
    dict(dataset="openvid"),
    dict(dataset="msrvtt", arrival_rate=4.0, deadline_s=2.0),
    dict(dataset="internvid", with_spans=False, min_prompt=64,
         max_prompt=128),
])
def test_sample_trace_equal(kw):
    kw = dict(kw)
    ds = kw.pop("dataset")
    j = jsample_trace(ds, 12, np.random.default_rng(5), **kw)
    t = tsample_trace(ds, 12, np.random.default_rng(5), **kw)
    assert len(t) == len(j) == 12
    for a, b in zip(t, j):
        assert (a.request_id, a.max_new_tokens, a.arrival_s, a.deadline_s,
                a.eta) == (b.request_id, b.max_new_tokens, b.arrival_s,
                           b.deadline_s, b.eta)
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert (None if a.spans is None else [s.to_json() for s in a.spans]
                ) == (None if b.spans is None else
                      [s.to_json() for s in b.spans])
