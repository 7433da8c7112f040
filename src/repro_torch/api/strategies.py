"""Pluggable parallelism strategies — the planner half of an Engine.

The paper's core claim is that the parallelism layout should be a
*per-batch, swappable decision*. Every backend implements the same
`Strategy` surface (`plan`, async `prepare`/`collect`, `observe`) and is
registered under a name, so the Engine, the serving runtime and the CLI
select a planner with `get_strategy("dhp" | "dhp-faithful" | "static" |
"megatron" | "deepspeed" | "bruteforce" | "oracle", **options)`: the
JAX package's registry, with its defaults and tie-breaks. A new
strategy is one class and one `@register_strategy` line.
`ReplayStrategy` (not registered: it is made from the plans it replays)
runs a saved plan trace instead of planning.

Strategies are constructed *unbound* (no cluster context) and attached
to a cost model / rank count / memory budget via `bind(...)`, which the
Engine does from its ClusterSpec.
"""
from __future__ import annotations

import collections
import concurrent.futures
import threading
import time
from typing import (Callable, Dict, List, Optional, Sequence as Seq,
                    Tuple, Union)

import numpy as np

from ..core.allocator import allocate_bruteforce, evaluate_degrees
from ..core.cost_model import CostModel, SeqInfo, as_seq_infos
from ..core.group_pool import pow2_bucket
from ..core.scheduler import (DHPScheduler, ExecutionPlan, PlanCache,
                              static_plan)
from ..obs.trace import get_tracer

# name -> (class, constructor defaults). Aliases ("megatron") are just
# extra entries with different defaults.
STRATEGY_REGISTRY: Dict[str, Tuple[type, dict]] = {}


def register_strategy(name: str, **defaults):
    """Class decorator registering a Strategy backend under `name`."""
    def deco(cls):
        STRATEGY_REGISTRY[name] = (cls, dict(defaults))
        return cls
    return deco


def available_strategies() -> List[str]:
    return sorted(STRATEGY_REGISTRY)


def get_strategy(name: str, **options) -> "Strategy":
    """Registry round-trip: name -> configured Strategy instance.

    `options` override the registered defaults (e.g.
    `get_strategy("static", degree=4)`)."""
    if name not in STRATEGY_REGISTRY:
        raise KeyError(
            f"unknown strategy {name!r}; registered: "
            f"{available_strategies()}")
    cls, defaults = STRATEGY_REGISTRY[name]
    strat = cls(**{**defaults, **options})
    strat.name = name
    return strat


class Strategy:
    """One parallelism policy: turns a batch of SeqInfo into an
    ExecutionPlan the executor can run.

    Subclasses implement `_plan`. The base class provides the uniform
    async producer-consumer surface (`prepare` schedules the NEXT batch
    on a host thread while devices crunch the current one — paper §5
    Implementation (2)) and the `observe` hook fed with measured
    per-group timings after execution.
    """

    name = "strategy"
    #: engines pass per-group measured timings to observe() only when
    #: this is True (measuring serialises group dispatch).
    wants_measurement = False
    #: planners derive the plan's span table from the input batch;
    #: strategies that return externally RECORDED plans (replay) keep
    #: the plan's own seq_spans — overwriting would change the
    #: structural hash the trace was saved (and verified) with.
    attaches_spans = True

    def __init__(self, cost_model: Optional[CostModel] = None,
                 n_ranks: Optional[int] = None,
                 mem_budget: Optional[float] = None,
                 plan_cache: Union[None, bool, PlanCache] = None):
        """`plan_cache` controls cross-batch plan reuse: True/None
        enables the structural-histogram PlanCache (None defers to the
        class default — off for measuring strategies, whose cost model
        drifts under observation), False disables it, or pass a
        PlanCache instance to share one across strategies."""
        self.cm = cost_model
        self.n_ranks = n_ranks
        self.budget = mem_budget
        self._plan_cache_opt = plan_cache
        self._cache: Optional[PlanCache] = (
            plan_cache if isinstance(plan_cache, PlanCache) else None)
        self._executor: Optional[
            concurrent.futures.ThreadPoolExecutor] = None
        #: FIFO of in-flight background plans (lookahead window): each
        #: prepare() appends a future, collect() pops the oldest.
        self._pending: "collections.deque[concurrent.futures.Future]" = \
            collections.deque()
        #: ms collect() actually blocked waiting for the background
        #: planner — the NON-hidden share of schedule_ms.
        self.last_wait_ms: float = 0.0

    # -- binding ---------------------------------------------------------
    @property
    def is_bound(self) -> bool:
        return (self.cm is not None and self.n_ranks is not None
                and self.budget is not None)

    def bind(self, cost_model: CostModel, n_ranks: int,
             mem_budget: float) -> "Strategy":
        """Attach cluster context; fields already set (e.g. passed to the
        constructor explicitly) win. Returns self for chaining."""
        if self.cm is None:
            self.cm = cost_model
        if self.n_ranks is None:
            self.n_ranks = n_ranks
        if self.budget is None:
            self.budget = mem_budget
        self._rebind()
        return self

    def _rebind(self) -> None:
        """Subclass hook: invalidate planner caches after bind()."""

    def _require_bound(self) -> None:
        if not self.is_bound:
            raise RuntimeError(
                f"strategy {self.name!r} is unbound — call "
                f".bind(cost_model, n_ranks, mem_budget) or hand it to "
                f"an Engine first")

    # -- plan cache ------------------------------------------------------
    @property
    def plan_cache(self) -> Optional[PlanCache]:
        """The strategy's PlanCache, or None when caching is off."""
        if self._cache is None and self._plan_cache_opt is not False:
            if self._plan_cache_opt is None and self.wants_measurement:
                return None     # measured costs drift; never serve stale
            self._cache = PlanCache()
        return self._cache

    # -- planning --------------------------------------------------------
    def plan(self, seqs: Seq[SeqInfo]) -> ExecutionPlan:
        """Plan one batch. Accepts `SeqInfo`s, `MMSequence`s, or a mix —
        multimodal sequences are planned through their SeqInfo view
        (length and Eq. 8 eta derived from the span geometry) and the
        span table is attached to the resulting plan (`seq_spans`), so
        saved traces record the structure their costs came from."""
        self._require_bound()
        seqs = as_seq_infos(seqs)
        t0 = time.perf_counter()
        cache = self.plan_cache
        plan = None
        if cache is not None:
            plan = cache.lookup(seqs, cost_model=self.cm,
                                n_ranks=self.n_ranks,
                                mem_budget=self.budget)
            if plan is not None:
                ms = (time.perf_counter() - t0) * 1e3
                plan.schedule_ms = ms
                plan.stage_ms = {"cache": ms}
        if plan is None:
            plan = self._plan(seqs)
            if cache is not None:
                cache.store(seqs, plan)
        if self.attaches_spans:
            spans = {s.seq_id: tuple(s.spans) for s in seqs
                     if getattr(s, "spans", None)}
            plan.seq_spans = spans or None
        plan.strategy_name = self.name
        tr = get_tracer()
        if tr.enabled:
            # emitted from whichever thread ran the solve — the
            # lookahead planner thread gets its own trace track
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
    @property
    def n_pending(self) -> int:
        """In-flight background plans (the current lookahead depth)."""
        return len(self._pending)

    def prepare(self, seqs: Seq[SeqInfo]) -> None:
        """Kick off planning of the NEXT batch on the host thread.

        May be called several times before the matching collect()s: the
        futures form a FIFO lookahead window, all served by ONE planner
        thread so a window of batches t+1..t+k is solved back-to-back —
        consecutive solves share the scheduler's incremental-allocator
        state (warm DP rows, cost tables), which is what makes the
        batched lookahead cheap)."""
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(
                max_workers=1)
        self._pending.append(self._executor.submit(self.plan, list(seqs)))

    def prepare_many(self, batches: Seq[Seq[SeqInfo]]) -> None:
        """Enqueue a whole lookahead window t+1..t+k at once."""
        for seqs in batches:
            self.prepare(seqs)

    def collect(self) -> ExecutionPlan:
        """Block until the OLDEST prepared plan is ready (usually is).

        Records `last_wait_ms`, the time this call actually blocked —
        `schedule_ms - last_wait_ms` is the planning latency hidden
        behind device execution (StepMetrics.plan_overlap_ms)."""
        if not self._pending:
            raise RuntimeError("collect() without a prior prepare()")
        t0 = time.perf_counter()
        plan = self._pending.popleft().result()
        self.last_wait_ms = (time.perf_counter() - t0) * 1e3
        return plan

    # -- feedback --------------------------------------------------------
    def observe(self, plan: ExecutionPlan,
                timings: List[dict]) -> None:
        """Post-execution hook with measured per-group timings
        ({seq_ids, degree, tokens, seconds, compiled} dicts). Default:
        ignored; OracleStrategy learns its cost table from these."""

    def close(self) -> None:
        self._pending.clear()
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None


# ---------------------------------------------------------------------------
@register_strategy("static")
@register_strategy("megatron", power_of_two=False)
@register_strategy("deepspeed", power_of_two=True)
class StaticStrategy(Strategy):
    """Fixed-degree baseline (Megatron-LM / DeepSpeed style).

    `degree=None` sizes the one global CP degree for the longest
    sequence of each batch (how a practitioner must configure a static
    system); `power_of_two=True` adds the Ulysses head-divisibility
    rounding (§4.1)."""

    def __init__(self, cost_model=None, n_ranks=None, mem_budget=None, *,
                 degree: Optional[int] = None, power_of_two: bool = False,
                 plan_cache=None):
        super().__init__(cost_model, n_ranks, mem_budget, plan_cache)
        self.degree = degree
        self.power_of_two = power_of_two

    def _plan(self, seqs):
        return static_plan(seqs, self.cm, self.n_ranks, self.budget,
                           degree=self.degree,
                           power_of_two=self.power_of_two)


@register_strategy("dhp")
@register_strategy("dhp-faithful", balance_packing=False,
                   serial_fallback=False)
class DHPStrategy(Strategy):
    """The paper's system: memory-aware BFD packing (Stage 1) + 2D-DP
    resource assignment (Stage 2), re-planned every global batch."""

    def __init__(self, cost_model=None, n_ranks=None, mem_budget=None, *,
                 use_all_ranks: bool = True, balance_packing: bool = True,
                 serial_fallback: bool = True,
                 allocator: Optional[Callable] = None,
                 plan_cache=None):
        super().__init__(cost_model, n_ranks, mem_budget, plan_cache)
        self.options = dict(use_all_ranks=use_all_ranks,
                            balance_packing=balance_packing,
                            serial_fallback=serial_fallback,
                            allocator=allocator)
        self._scheduler: Optional[DHPScheduler] = None

    def _rebind(self):
        self._scheduler = None

    @property
    def scheduler(self) -> DHPScheduler:
        self._require_bound()
        if self._scheduler is None:
            self._scheduler = DHPScheduler(
                self.cm, self.n_ranks, self.budget, **self.options)
        return self._scheduler

    def _plan(self, seqs):
        return self.scheduler.schedule(seqs)


@register_strategy("bruteforce")
class BruteForceStrategy(DHPStrategy):
    """DHP with the exact exhaustive Stage-2 solver instead of the 2D-DP
    — the optimality oracle for the allocator (only tractable on small
    waves; used by tests and regret analyses)."""

    def __init__(self, cost_model=None, n_ranks=None, mem_budget=None, *,
                 balance_packing: bool = True, plan_cache=None):
        super().__init__(cost_model, n_ranks, mem_budget,
                         balance_packing=balance_packing,
                         serial_fallback=False,
                         allocator=allocate_bruteforce,
                         plan_cache=plan_cache)


# ---------------------------------------------------------------------------
class MeasuredCostModel(CostModel):
    """Cost model backed by post-hoc measurements.

    Keeps a running mean of measured group seconds keyed by
    (pow2 token bucket, degree) — the same key space as the executable
    pool, so every shape the executor has actually run has an entry —
    plus a global measured/predicted calibration ratio that scales the
    analytic estimate for shapes never measured."""

    def __init__(self, base: CostModel):
        super().__init__(base.coeffs, base.hw)
        self._base = base
        self._meas: Dict[Tuple[int, int], List[float]] = {}  # key -> [sum, n]
        self._ratio_sum = 0.0
        self._ratio_n = 0
        # record() runs on the engine's main thread while the strategy's
        # background planning thread reads group_time() concurrently
        self._lock = threading.Lock()

    @staticmethod
    def _key(tokens: int, degree: int) -> Tuple[int, int]:
        return (pow2_bucket(int(tokens), 64), int(degree))

    @property
    def n_samples(self) -> int:
        return int(sum(n for _, n in self._meas.values()))

    def record(self, tokens: int, degree: int, seconds: float) -> None:
        pred = self._base.group_time(
            [SeqInfo(length=int(tokens))], int(degree))
        key = self._key(tokens, degree)
        with self._lock:
            ent = self._meas.setdefault(key, [0.0, 0])
            ent[0] += seconds
            ent[1] += 1
            if pred > 0:
                self._ratio_sum += seconds / pred
                self._ratio_n += 1
            # predictions just changed: invalidate warm-started
            # allocator states keyed to the previous version
            self.cost_version += 1

    def group_time(self, seqs, degree):
        if not seqs:
            return 0.0
        tokens = sum(s.length for s in seqs)
        with self._lock:
            ent = self._meas.get(self._key(tokens, degree))
            if ent is not None:
                return ent[0] / ent[1]
            ratio = (self._ratio_sum / self._ratio_n
                     if self._ratio_n else 1.0)
        return self._base.group_time(seqs, degree) * ratio

    def group_time_vector(self, seqs, degrees):
        """Measured lookups are per-(bucket, degree) — no closed form to
        vectorize, so the bulk cost-table path degrades to scalar calls
        (still one call per table CELL, not per DP probe)."""
        return np.array([self.group_time(seqs, int(d)) for d in degrees])


@register_strategy("oracle")
class OracleStrategy(DHPStrategy):
    """DHP planning against *measured* costs instead of the analytic
    model — the hindsight planner for regret analysis.

    Engines running this strategy execute in measuring mode; every
    finished group feeds `observe()`, which updates a MeasuredCostModel
    (compile-tainted first executions, which build the group's step
    and its kernels, are skipped). Plans therefore
    converge to what a scheduler with a perfect cost oracle would have
    chosen; `plan_cost(plan, seqs)` evaluates ANY plan under the measured
    costs, so `plan_cost(model_plan) - plan_cost(oracle_plan)` is the
    cost-model regret."""

    wants_measurement = True

    def __init__(self, cost_model=None, n_ranks=None, mem_budget=None, *,
                 use_all_ranks: bool = True, balance_packing: bool = True,
                 serial_fallback: bool = True, plan_cache=None):
        super().__init__(cost_model, n_ranks, mem_budget,
                         use_all_ranks=use_all_ranks,
                         balance_packing=balance_packing,
                         serial_fallback=serial_fallback,
                         plan_cache=plan_cache)

    def bind(self, cost_model, n_ranks, mem_budget):
        if self.cm is None and not isinstance(cost_model,
                                              MeasuredCostModel):
            self.cm = MeasuredCostModel(cost_model)
        return super().bind(cost_model, n_ranks, mem_budget)

    @property
    def measured(self) -> MeasuredCostModel:
        self._require_bound()
        if not isinstance(self.cm, MeasuredCostModel):
            self.cm = MeasuredCostModel(self.cm)
            self._rebind()
        return self.cm

    def observe(self, plan, timings):
        for t in timings:
            if t.get("compiled"):
                continue           # first run pays the build, not the step
            self.measured.record(t["tokens"], t["degree"], t["seconds"])

    def plan_cost(self, plan: ExecutionPlan,
                  seqs: Seq[SeqInfo]) -> float:
        """Evaluate an arbitrary plan under the measured cost table."""
        by_id = {s.seq_id: s for s in seqs}
        total = 0.0
        for mb in plan.micro_batches:
            total += evaluate_degrees(
                [[by_id[i] for i in g.seq_ids] for g in mb.groups],
                [g.degree for g in mb.groups],
                self.measured.group_time).makespan
        return total


# ---------------------------------------------------------------------------
class ReplayStrategy(Strategy):
    """Replays a saved plan trace instead of planning.

    Constructed directly (NOT in the registry — it is parameterized by
    the plans to replay): `ReplayStrategy(plans=load_plans(path))`, or
    via `python -m repro_torch.api.cli --replay-plans plans.json`. Each `plan()` call pops
    the next recorded plan and validates its seq-id coverage against the
    batch it is about to execute, so a drifted data stream fails loudly
    instead of silently misassigning sequences. Replay is bit-identical:
    structural hashes, rank slots and executable keys match the run the
    plans were saved from (given the same loader seed/state).
    """

    name = "replay"
    attaches_spans = False      # recorded plans keep their saved hash

    def __init__(self, cost_model=None, n_ranks=None, mem_budget=None, *,
                 plans: Optional[Seq[ExecutionPlan]] = None):
        super().__init__(cost_model, n_ranks, mem_budget,
                         plan_cache=False)
        self._plans = list(plans or [])
        self._cursor = 0

    def __len__(self) -> int:
        return len(self._plans) - self._cursor

    def _plan(self, seqs):
        if self._cursor >= len(self._plans):
            raise RuntimeError(
                f"replay exhausted after {len(self._plans)} plans")
        recorded = self._plans[self._cursor]
        self._cursor += 1
        if isinstance(recorded, dict):
            recorded = ExecutionPlan.from_json(recorded)
        recorded.validate(seqs, n_ranks=self.n_ranks)
        return recorded
