"""The port's front door on the CPU: `python -m repro_torch.api.cli`
trains and serves reduced internvl3-2b (`--reduced --device cpu`), and
what it writes is what the JAX package reads.

  * a training run (2 steps, `--save-plans`, `--report`, `--metrics`,
    `--trace`): the JAX `load_plans` reads the plans, whose JSON and
    hashes equal the JAX planner's on the JAX loader's batches (the
    reference, built once a module, with the deltas the JAX
    `diff_plans` gives); the JAX `metrics_from_json` reads the history;
    the report is the JAX `RunReport`'s document; the JAX
    `validate_trace` takes the trace;
  * `--replay-plans` runs the saved plans again: the same hashes and
    rank slots, and the same losses to the bit (both runs on one CPU
    thread);
  * `serve` through `serve_main`: every sampled request finishes with
    its tokens, the serving trace validates;
  * the parsers take every JAX option (plus `--device`) with the JAX
    defaults, `--list-strategies` prints the JAX list, `make_engine`
    builds every registered strategy;
  * `Engine.train(lookahead=2, report=True)` with a loader runs the
    reference's plans and keeps the report on `last_report`.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.api.cli import build_parser as jax_build_parser
from repro.api.cli import build_serve_parser as jax_build_serve_parser
from repro.api.cli import main as jax_main
from repro.api.engine import demo_cost_model as jax_demo_cost_model
from repro.api.engine import metrics_from_json as jax_metrics_from_json
from repro.api.strategies import get_strategy as jax_get_strategy
from repro.configs import get_config as jax_get_config
from repro.core.scheduler import diff_plans as jax_diff_plans
from repro.core.scheduler import load_plans as jax_load_plans
from repro.data.pipeline import HeterogeneousLoader as JaxLoader
from repro.obs.report import RunReport as JaxRunReport
from repro.obs.trace import validate_trace as jax_validate_trace
from repro_torch.api import (ClusterSpec, Engine, available_strategies,
                             load_plans)
from repro_torch.api.cli import (build_parser, build_serve_parser, main,
                                 make_engine)
from repro_torch.data.pipeline import HeterogeneousLoader

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
#: the runs' data: small batches of short openvid sequences
STEPS, BATCH, SEQ_LEN, BUDGET = 2, 4, 128, 1024.0
TRAIN = ["--arch", "internvl3-2b", "--reduced", "--device", "cpu",
         "--steps", str(STEPS), "--batch", str(BATCH),
         "--seq-len", str(SEQ_LEN), "--mem-budget", str(BUDGET)]
#: plan fields that hold measured host time, not plan content
HOST_TIME_FIELDS = ("schedule_ms", "solver_ms", "stage_ms")


def _cli(*args):
    """`python -m repro_torch.api.cli ARGS` on one CPU thread; returns
    its standard output."""
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-m", "repro_torch.api.cli",
                        *args], env=env, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    return r.stdout


def _doc(plan) -> dict:
    doc = plan.to_json()
    for k in HOST_TIME_FIELDS:
        doc.pop(k)
    return doc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One training run of the CLI with every output, its replay, and
    the JAX reference: the JAX planner's plans of the JAX loader's
    first batches at one rank, each with its delta from the one before."""
    d = tmp_path_factory.mktemp("cli")
    out = {k: str(d / f"{k}.json") for k in ("plans", "report", "metrics",
                                              "trace", "replayed",
                                              "replay_metrics")}
    train_out = _cli(*TRAIN, "--save-plans", out["plans"], "--report",
                     out["report"], "--metrics", out["metrics"],
                     "--trace", out["trace"])
    replay_out = _cli(*TRAIN, "--replay-plans", out["plans"],
                      "--save-plans", out["replayed"], "--metrics",
                      out["replay_metrics"])
    cfg = jax_get_config("internvl3-2b").reduced()
    cfg = cfg.with_(family="dense", vlm=None)
    strat = jax_get_strategy("dhp").bind(jax_demo_cost_model(cfg), 1,
                                         BUDGET)
    loader = JaxLoader("openvid", BATCH, cfg.vocab, seed=0,
                       max_tokens=SEQ_LEN, tokens_per_frame=16)
    ref, prev = [], None
    for _ in range(STEPS):
        plan = strat.plan(next(iter(loader)).infos)
        plan.delta = jax_diff_plans(prev, plan, 1)
        ref.append(plan)
        prev = plan
    return dict(out=out, train_out=train_out, replay_out=replay_out,
                ref=ref)


def test_cli_plans_load_in_jax_and_equal_its_planner(runs):
    loaded = jax_load_plans(runs["out"]["plans"])
    assert len(loaded) == STEPS
    for got, want in zip(loaded, runs["ref"]):
        assert got.structural_hash() == want.structural_hash()
        assert _doc(got) == _doc(want)
    assert f"saved {STEPS} plans" in runs["train_out"]


def test_cli_metrics_and_report_load_in_jax(runs):
    with open(runs["out"]["metrics"]) as f:
        hist = jax_metrics_from_json(json.load(f))
    assert [m.step for m in hist] == list(range(STEPS))
    assert all(np.isfinite(m.loss) and m.strategy == "dhp" for m in hist)
    assert [m.degree_histogram for m in hist] == \
        [p.degree_histogram for p in runs["ref"]]
    with open(runs["out"]["report"]) as f:
        doc = json.load(f)
    fields = {k: doc[k] for k in ("n_ranks", "n_steps", "waves",
                                  "imbalance", "stragglers", "model_error",
                                  "steps", "metrics")}
    assert json.loads(json.dumps(JaxRunReport(**fields).to_json())) == doc
    assert doc["n_ranks"] == 1 and doc["n_steps"] == STEPS
    assert [s["loss"] for s in doc["steps"]] == [m.loss for m in hist]
    assert doc["model_error"]["n_samples"] > 0
    assert "run report:" in runs["train_out"]
    with open(runs["out"]["trace"]) as f:
        assert jax_validate_trace(json.load(f)) > 0


def test_cli_replay_reproduces_the_run(runs):
    saved = load_plans(runs["out"]["plans"])
    replayed = jax_load_plans(runs["out"]["replayed"])
    assert [p.structural_hash() for p in replayed] == \
        [p.structural_hash() for p in saved]
    assert [p.group_slots(1) for p in replayed] == \
        [p.group_slots(1) for p in saved]
    assert all(p.strategy_name == "replay" for p in replayed)
    with open(runs["out"]["metrics"]) as f, \
            open(runs["out"]["replay_metrics"]) as g:
        want, got = json.load(f)["steps"], json.load(g)["steps"]
    assert [m["loss"] for m in got] == [m["loss"] for m in want]
    assert f"replaying {STEPS} recorded plans" in runs["replay_out"]


def test_cli_serves_a_sampled_trace(tmp_path):
    """Every sampled request finishes. The sampled prompts carry their
    modality spans, so they prefill in chunks."""
    trace = str(tmp_path / "serve_trace.json")
    out = _cli("serve", "--arch", "internvl3-2b", "--reduced", "--device",
               "cpu", "--requests", "4", "--max-prompt", "48",
               "--max-new", "4", "--trace", trace)
    assert "family=dense" in out and "requests=4" in out
    assert sum(line.startswith("request ") and "finished" in line
               for line in out.splitlines()) == 4
    assert "4 requests" in out and "kv: peak_blocks=" in out
    with open(trace) as f:
        doc = json.load(f)
    assert jax_validate_trace(doc) > 0
    names = {e["name"] for e in doc["traceEvents"]}
    assert "prefill_chunk" in names and "prefill_batch" not in names


# ------------------------------------------------------------ in process
def test_parsers_take_the_jax_options():
    for ours, theirs in ((build_parser(), jax_build_parser()),
                         (build_serve_parser(), jax_build_serve_parser())):
        want = {a.dest: a.default for a in theirs._actions}
        got = {a.dest: a.default for a in ours._actions}
        assert set(got) - set(want) == {"device"}
        assert set(want) <= set(got)
        assert {k: got[k] for k in want} == want
        assert got["device"] == "cuda"


def test_list_strategies_equal(capsys):
    jax_main(["--list-strategies"])
    want = capsys.readouterr().out
    main(["--list-strategies"])
    assert capsys.readouterr().out == want
    assert want.split() == available_strategies()


@pytest.mark.parametrize("name", available_strategies())
def test_make_engine_builds_every_strategy(name):
    args = build_parser().parse_args(TRAIN + ["--strategy", name])
    eng = make_engine(args)
    assert eng.strategy.name == name and eng.strategy.is_bound
    assert eng.device.type == "cpu" and eng.cluster.mem_budget == BUDGET
    assert callable(eng.optimizer.lr)
    eng.close()


def test_engine_train_takes_a_loader_a_window_and_a_report(runs):
    """Engine.train with a loader and lookahead=2 (two plans in flight)
    runs the reference's plans; report=True keeps the run report."""
    eng = Engine("internvl3-2b", ClusterSpec.auto(mem_budget=BUDGET,
                                                  device="cpu"),
                 reduced=True)
    loader = HeterogeneousLoader("openvid", BATCH, eng.cfg.vocab, seed=0,
                                 max_tokens=SEQ_LEN, tokens_per_frame=16)
    plans, lines = [], []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # as the CLI runs above
    try:
        hist = eng.train(loader, steps=STEPS, lookahead=2, plan_log=plans,
                         log=lines.append, report=True)
    finally:
        torch.set_num_threads(threads)
    assert [p.structural_hash() for p in plans] == \
        [p.structural_hash() for p in runs["ref"]]
    assert len(lines) == STEPS and lines[0].startswith("step   0")
    assert eng.last_report is not None and eng.last_report.n_steps == STEPS
    assert eng.last_tracer is None
    assert all(m.model_error_pct >= 0 for m in hist)
    eng.close()
