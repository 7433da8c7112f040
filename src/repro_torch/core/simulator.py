"""Cluster simulator: the paper's end-to-end and scaling tables.

The speedup experiments (Figs. 4/5/6, Table 4) need a cluster of 64
accelerators; they are reproduced by *simulation under one shared cost
model*: DHP's dynamic plans and the static Megatron-LM / DeepSpeed-style
plans are priced with identical Eq. (7)-(10) costs, so the comparison
isolates what the paper isolates, the scheduling policy. The absolute
scale is that of the cost model given: its coefficients (fitted by the
Profiler from timed groups, or analytic ones) and its `Hardware` links.

Megatron-LM baseline: static ring-CP degree sized for the longest
sequence, any integer degree allowed, CP groups of fixed size.
DeepSpeed baseline:  static Ulysses-style SP, degree restricted to
powers of two (head divisibility, §4.1), all-to-all comm with the same
linear volume model.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence as Seq

import numpy as np

from .cost_model import CostModel, SeqInfo
from .distributions import sample_batch
from .scheduler import DHPScheduler, ExecutionPlan, static_plan


@dataclasses.dataclass
class IterationResult:
    method: str
    iter_time_s: float
    tokens: int
    schedule_ms: float
    solver_ms: float
    degree_histogram: Dict[int, int]

    @property
    def throughput_tokens_per_s(self) -> float:
        return self.tokens / self.iter_time_s


class ClusterSimulator:
    """Evaluates scheduling policies on one global batch."""

    def __init__(self, cost_model: CostModel, n_ranks: int,
                 mem_budget: float):
        self.cm = cost_model
        self.n_ranks = n_ranks
        self.budget = mem_budget

    def _result(self, name: str, plan: ExecutionPlan,
                seqs: Seq[SeqInfo]) -> IterationResult:
        return IterationResult(
            method=name,
            iter_time_s=plan.total_time_est,
            tokens=sum(s.length for s in seqs),
            schedule_ms=plan.schedule_ms,
            solver_ms=plan.solver_ms,
            degree_histogram=plan.degree_histogram,
        )

    def run_dhp(self, seqs: Seq[SeqInfo]) -> IterationResult:
        sched = DHPScheduler(self.cm, self.n_ranks, self.budget)
        return self._result("dhp", sched.schedule(seqs), seqs)

    def run_dhp_faithful(self, seqs: Seq[SeqInfo]) -> IterationResult:
        """Paper-faithful DHP: BFD + 2D-DP only, no beyond-paper
        refinements (balance-aware packing, serial fallback)."""
        sched = DHPScheduler(self.cm, self.n_ranks, self.budget,
                             balance_packing=False, serial_fallback=False)
        return self._result("dhp-faithful", sched.schedule(seqs), seqs)

    def run_megatron(self, seqs: Seq[SeqInfo]) -> IterationResult:
        plan = static_plan(seqs, self.cm, self.n_ranks, self.budget,
                           power_of_two=False)
        return self._result("megatron-lm", plan, seqs)

    def run_deepspeed(self, seqs: Seq[SeqInfo]) -> IterationResult:
        plan = static_plan(seqs, self.cm, self.n_ranks, self.budget,
                           power_of_two=True)
        return self._result("deepspeed", plan, seqs)

    def compare(self, seqs: Seq[SeqInfo]) -> Dict[str, IterationResult]:
        return {
            "dhp": self.run_dhp(seqs),
            "dhp-faithful": self.run_dhp_faithful(seqs),
            "megatron-lm": self.run_megatron(seqs),
            "deepspeed": self.run_deepspeed(seqs),
        }


def end_to_end_table(
    cost_model: CostModel,
    *,
    n_ranks: int = 64,
    mem_budget: float,
    datasets: Seq[str] = ("msrvtt", "internvid", "openvid"),
    gbs: int = 512,
    iters: int = 5,
    seed: int = 0,
    max_tokens: int | None = None,
) -> List[dict]:
    """Fig. 4/6 reproduction: iteration time + speedup per dataset."""
    rng = np.random.default_rng(seed)
    sim = ClusterSimulator(cost_model, n_ranks, mem_budget)
    rows = []
    for ds in datasets:
        acc = {m: 0.0 for m in ("dhp", "dhp-faithful", "megatron-lm",
                                "deepspeed")}
        for _ in range(iters):
            seqs = sample_batch(ds, gbs, rng, max_tokens=max_tokens)
            res = sim.compare(seqs)
            for m, r in res.items():
                acc[m] += r.iter_time_s
        best_static = min(acc["megatron-lm"], acc["deepspeed"])
        rows.append({
            "dataset": ds,
            "dhp_s": acc["dhp"] / iters,
            "dhp_faithful_s": acc["dhp-faithful"] / iters,
            "megatron_s": acc["megatron-lm"] / iters,
            "deepspeed_s": acc["deepspeed"] / iters,
            "speedup_vs_best_static": best_static / acc["dhp"],
            "speedup_faithful_vs_best_static": best_static
            / acc["dhp-faithful"],
            "speedup_vs_megatron": acc["megatron-lm"] / acc["dhp"],
        })
    return rows


def scaling_table(
    cost_model: CostModel,
    *,
    rank_counts: Seq[int] = (8, 16, 32, 64),
    mem_budget: float,
    dataset: str = "openvid",
    gbs: int = 512,
    iters: int = 3,
    seed: int = 0,
    max_tokens: int | None = None,
) -> List[dict]:
    """Fig. 5 reproduction: throughput vs cluster size."""
    rng = np.random.default_rng(seed)
    rows = []
    for n in rank_counts:
        sim = ClusterSimulator(cost_model, n, mem_budget)
        acc = {m: [0.0, 0] for m in ("dhp", "dhp-faithful",
                                     "megatron-lm", "deepspeed")}
        for _ in range(iters):
            seqs = sample_batch(dataset, gbs, rng, max_tokens=max_tokens)
            for m, r in sim.compare(seqs).items():
                acc[m][0] += r.iter_time_s
                acc[m][1] += r.tokens
        row = {"ranks": n}
        for m, (t, tok) in acc.items():
            row[f"{m}_tokens_per_s_per_rank"] = tok / t / n
        row["dhp_vs_deepspeed"] = (
            row["dhp_tokens_per_s_per_rank"]
            / row["deepspeed_tokens_per_s_per_rank"])
        rows.append(row)
    return rows
