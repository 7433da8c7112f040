"""Parallelism strategies — the planner half of an Engine.

Every backend implements the same `Strategy` surface (`bind`, `plan`,
async `prepare`/`collect`, `observe`) and is registered under a name, so
the Engine and the serving runtime select a planner with
`get_strategy("dhp" | "static")`.

Strategies are constructed *unbound* (no cluster context) and attached
to a cost model / rank count / memory budget via `bind(...)`. The other
backends of the JAX package (megatron, deepspeed, dhp-faithful,
bruteforce, the measured-cost oracle, replay) are not ported yet.
"""
from __future__ import annotations

import concurrent.futures
import time
from typing import Dict, List, Optional, Sequence as Seq

from ..core.cost_model import CostModel, SeqInfo
from ..core.scheduler import (DHPScheduler, ExecutionPlan, PlanCache,
                              static_plan)
from ..obs.trace import get_tracer


class Strategy:
    """One parallelism policy: turns a batch of SeqInfo into an
    ExecutionPlan. Subclasses implement `_plan`.

    The base class provides the async producer-consumer surface
    (`prepare` plans the NEXT batch on a host thread while the card runs
    the current one — paper §5 Implementation (2)) and the `observe`
    hook fed with measured per-group timings after execution."""

    name = "strategy"
    #: engines pass per-group measured timings to observe() only when
    #: this is True (measuring serialises group execution)
    wants_measurement = False

    def __init__(self):
        self.cm: Optional[CostModel] = None
        self.n_ranks: Optional[int] = None
        self.budget: Optional[float] = None
        #: cross-batch plan reuse keyed on the structural histogram
        self.plan_cache = PlanCache()
        self._executor: Optional[
            concurrent.futures.ThreadPoolExecutor] = None
        #: the plan in flight on the planner thread (lookahead)
        self._pending: Optional[concurrent.futures.Future] = None
        #: ms collect() actually blocked waiting for the planner thread —
        #: the NON-hidden share of schedule_ms
        self.last_wait_ms: float = 0.0

    # -- binding ---------------------------------------------------------
    def bind(self, cost_model: CostModel, n_ranks: int,
             mem_budget: float) -> "Strategy":
        """Attach cluster context. Returns self for chaining."""
        self.cm, self.n_ranks, self.budget = cost_model, n_ranks, mem_budget
        self._rebind()
        return self

    def _rebind(self) -> None:
        """Subclass hook: invalidate planner caches after bind()."""

    def _require_bound(self) -> None:
        if self.cm is None:
            raise RuntimeError(
                f"strategy {self.name!r} is unbound — call "
                f".bind(cost_model, n_ranks, mem_budget) first")

    # -- planning --------------------------------------------------------
    def plan(self, seqs: Seq[SeqInfo]) -> ExecutionPlan:
        """Plan one batch of `SeqInfo`s. Span-bearing sequences are
        planned at their derived length and Eq. 8 eta, and the span
        table is attached to the plan (`seq_spans`)."""
        self._require_bound()
        seqs = list(seqs)
        t0 = time.perf_counter()
        plan = self.plan_cache.lookup(seqs, cost_model=self.cm,
                                      n_ranks=self.n_ranks,
                                      mem_budget=self.budget)
        if plan is not None:
            ms = (time.perf_counter() - t0) * 1e3
            plan.schedule_ms = ms
            plan.stage_ms = {"cache": ms}
        else:
            plan = self._plan(seqs)
            self.plan_cache.store(seqs, plan)
        spans = {s.seq_id: tuple(s.spans) for s in seqs if s.spans}
        plan.seq_spans = spans or None
        plan.strategy_name = self.name
        tr = get_tracer()
        if tr.enabled:
            tr.complete("plan", t0, time.perf_counter() - t0, "planner",
                        args={"strategy": self.name,
                              "seqs": len(seqs),
                              "cache_hit": plan.from_cache,
                              "replan_mode": plan.replan_mode,
                              "schedule_ms": plan.schedule_ms})
        return plan

    def _plan(self, seqs: List[SeqInfo]) -> ExecutionPlan:
        raise NotImplementedError

    # -- async producer-consumer ----------------------------------------
    def prepare(self, seqs: Seq[SeqInfo]) -> None:
        """Start planning the next batch on the planner thread (one
        thread, so consecutive solves share the scheduler's warm
        allocator state). One plan is in flight at a time."""
        if self._pending is not None:
            raise RuntimeError("prepare() while a plan is in flight; "
                               "collect() it first")
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1)
        self._pending = self._executor.submit(self.plan, list(seqs))

    def collect(self) -> ExecutionPlan:
        """Block until the prepared plan is ready; records
        `last_wait_ms`, the time this call actually blocked."""
        if self._pending is None:
            raise RuntimeError("collect() without a prior prepare()")
        t0 = time.perf_counter()
        fut, self._pending = self._pending, None
        plan = fut.result()
        self.last_wait_ms = (time.perf_counter() - t0) * 1e3
        return plan

    # -- feedback --------------------------------------------------------
    def observe(self, plan: ExecutionPlan, timings: List[dict]) -> None:
        """Post-execution hook with measured per-group timings
        ({seq_ids, degree, tokens, seconds, compiled} dicts). Default:
        ignored."""

    def close(self) -> None:
        self._pending = None
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None


# ---------------------------------------------------------------------------
class StaticStrategy(Strategy):
    """Fixed-degree baseline (Megatron-LM style): one global CP degree
    sized for the longest sequence of each batch."""

    name = "static"

    def _plan(self, seqs):
        return static_plan(seqs, self.cm, self.n_ranks, self.budget)


class DHPStrategy(Strategy):
    """The paper's system: memory-aware BFD packing (Stage 1) + 2D-DP
    resource assignment (Stage 2), re-planned every batch."""

    name = "dhp"

    def __init__(self):
        super().__init__()
        self._scheduler: Optional[DHPScheduler] = None

    def _rebind(self):
        self._scheduler = None

    @property
    def scheduler(self) -> DHPScheduler:
        self._require_bound()
        if self._scheduler is None:
            self._scheduler = DHPScheduler(self.cm, self.n_ranks,
                                           self.budget)
        return self._scheduler

    def _plan(self, seqs):
        return self.scheduler.schedule(seqs)


STRATEGY_REGISTRY: Dict[str, type] = {"dhp": DHPStrategy,
                                      "static": StaticStrategy}


def available_strategies() -> List[str]:
    return sorted(STRATEGY_REGISTRY)


def get_strategy(name: str) -> Strategy:
    """Registry round-trip: name -> unbound Strategy instance."""
    if name not in STRATEGY_REGISTRY:
        raise KeyError(
            f"unknown strategy {name!r}; registered: "
            f"{available_strategies()}")
    return STRATEGY_REGISTRY[name]()
