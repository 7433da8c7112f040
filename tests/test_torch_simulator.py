"""The port's cluster simulator and legacy launcher on the CPU.

  * `end_to_end_table` (64 ranks, the three datasets) and
    `scaling_table` (8 and 16 ranks) on the reference tests' analytic
    coefficients give rows equal to the JAX package's, key for key, to
    1e-12 relative; the reference's own assertions hold (DHP faster than
    the best static baseline, openvid gaining more than msrvtt, DHP's
    tokens/s a rank above 0.95x DeepSpeed's);
  * `ClusterSimulator.compare` on one batch gives every method's
    iteration time, tokens and degree histogram equal to the JAX
    package's;
  * `repro_torch.launch.train`: the parser takes `--mode`, `main` trains
    under `static` by default (reduced internvl3-2b on the CPU) and
    raises without a card unless given `--device cpu`, and the
    deprecated `run_static` / `run_dhp` warn and return the losses.
"""
import math

import numpy as np
import pytest
import torch

import repro.core as jcore
import repro_torch.core as tcore

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

#: the rows are sums and ratios of the same plan times
RTOL = 1e-12
#: the reference tests' models (test_simulated_speedup_reproduces_paper
#: _range, test_scaling_table_runs)
E2E_SHAPE = dict(hidden=3584, n_layers=28, n_heads=28, kv_heads=4,
                 ffn=18944, vocab=152000)
SCALING_SHAPE = dict(hidden=2048, n_layers=24, n_heads=16, kv_heads=8,
                     ffn=8192, vocab=50000)
METHODS = ("dhp", "dhp-faithful", "megatron-lm", "deepspeed")


def _models(shape):
    return (jcore.CostModel(jcore.analytic_coeffs(**shape)),
            tcore.CostModel(tcore.analytic_coeffs(**shape)))


def _assert_rows_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, str):
                assert g[k] == v
            else:
                assert math.isclose(g[k], v, rel_tol=RTOL), (k, g[k], v)


def test_end_to_end_table_equals_reference():
    jcm, tcm = _models(E2E_SHAPE)
    kw = dict(n_ranks=64, mem_budget=8e9, gbs=256, iters=2,
              max_tokens=262144)
    rows = tcore.end_to_end_table(tcm, **kw)
    _assert_rows_equal(rows, jcore.end_to_end_table(jcm, **kw))
    by = {r["dataset"]: r for r in rows}
    for ds in ("msrvtt", "internvid", "openvid"):
        assert by[ds]["speedup_vs_best_static"] > 1.0, by[ds]
    assert (by["openvid"]["speedup_vs_best_static"]
            > by["msrvtt"]["speedup_vs_best_static"])


def test_scaling_table_equals_reference():
    jcm, tcm = _models(SCALING_SHAPE)
    kw = dict(rank_counts=(8, 16), mem_budget=8e9, gbs=64, iters=1,
              max_tokens=131072)
    rows = tcore.scaling_table(tcm, **kw)
    _assert_rows_equal(rows, jcore.scaling_table(jcm, **kw))
    assert [r["ranks"] for r in rows] == [8, 16]
    for r in rows:
        assert r["dhp_vs_deepspeed"] > 0.95


@pytest.mark.parametrize("dataset,n_ranks", [("openvid", 32),
                                             ("msrvtt", 8)])
def test_compare_equals_reference(dataset, n_ranks):
    jcm, tcm = _models(E2E_SHAPE)
    jseqs = jcore.sample_batch(dataset, 128, np.random.default_rng(13),
                               max_tokens=100_000)
    tseqs = tcore.sample_batch(dataset, 128, np.random.default_rng(13),
                               max_tokens=100_000)
    assert [(s.length, s.eta) for s in tseqs] == \
        [(s.length, s.eta) for s in jseqs]
    want = jcore.ClusterSimulator(jcm, n_ranks, 8e9).compare(jseqs)
    got = tcore.ClusterSimulator(tcm, n_ranks, 8e9).compare(tseqs)
    assert tuple(got) == METHODS == tuple(want)
    for m in METHODS:
        g, w = got[m], want[m]
        assert g.method == w.method
        assert g.iter_time_s == w.iter_time_s, m
        assert g.tokens == w.tokens
        assert g.degree_histogram == w.degree_histogram, m
        assert g.throughput_tokens_per_s == w.throughput_tokens_per_s
    best_static = min(got["megatron-lm"].iter_time_s,
                      got["deepspeed"].iter_time_s)
    assert got["dhp"].iter_time_s <= best_static


# ---------------------------------------------------------------- launcher
#: reduced internvl3-2b on the CPU, one short step
CPU_RUN = ["--reduced", "--device", "cpu", "--steps", "1", "--batch", "2",
           "--seq-len", "64", "--mem-budget", "256"]


@pytest.fixture
def one_thread():
    """torch on one thread, restored after: the suite's workers share the
    machine's cores, and a reduced model's many small ops slow down most
    when every worker's threads contend for them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_launch_train_parser_takes_mode():
    from repro.launch.train import build_parser as jbuild_parser
    from repro_torch.launch.train import build_parser
    argv = ["--mode", "dhp", "--steps", "1"]
    args = build_parser().parse_args(argv)
    assert (args.strategy or args.mode) == "dhp"
    jargs = jbuild_parser().parse_args(argv)
    assert (args.mode, args.steps, args.batch) == \
        (jargs.mode, jargs.steps, jargs.batch)


def test_launch_train_main_defaults_to_static(one_thread, capsys):
    from repro_torch.launch.train import main
    main(CPU_RUN)
    out = capsys.readouterr().out
    assert "strategy=static" in out and "device=cpu" in out
    assert "step   0 loss=" in out


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_launch_train_needs_a_card_without_device_cpu():
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--reduced", "--steps", "1"])


@pytest.mark.parametrize("shim,strategy", [("run_static", "static"),
                                           ("run_dhp", "dhp")])
def test_launch_train_shims_warn(one_thread, shim, strategy, capsys):
    from repro_torch.launch import train
    args = train.build_parser().parse_args(CPU_RUN)
    with pytest.warns(DeprecationWarning, match=shim):
        losses = getattr(train, shim)(args)
    assert len(losses) == 1 and all(math.isfinite(x) for x in losses)
    assert f"strategy={strategy}" in capsys.readouterr().out
