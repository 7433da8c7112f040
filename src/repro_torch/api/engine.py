"""Engine — the public entry point of the port.

    ClusterSpec  ──►  Engine(model, cluster, strategy="dhp")
                         │ plan(batch)     -> ExecutionPlan
                         │ execute(plan)   -> StepMetrics
                         │ train(...)      -> [StepMetrics]  (lookahead)
                         │ serve(...)      -> one-shot batched decode
                         │ serving(...)    -> continuous-batching runtime
                         ▼
                      Strategy registry (dhp / dhp-faithful / static /
                      megatron / deepspeed / bruteforce / oracle)

`train()` is the one training loop every strategy runs through:
heterogeneous batches -> strategy plan -> executor -> AdamW, with the
next batches planned on a host thread while the card runs the current
one (paper §5 Implementation (2)). `train(report=...)` builds the run
report (obs/report: wave imbalance, rank stragglers, cost-model MAPE).
`save_checkpoint` / `load_checkpoint` keep the full train state in the
JAX package's file format. `api/cli.py` drives all of it from the
command line.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, Iterable, Iterator, List, Optional, Union

import torch

from ..configs import get_config
from ..configs.base import ModelConfig
from ..core.cost_model import CostModel, SeqInfo, analytic_coeffs
from ..core.executor import DHPExecutor
from ..core.scheduler import ExecutionPlan, diff_plans
from ..data.pipeline import HeterogeneousLoader, RaggedBatch
from ..obs import (MetricsRegistry, RunRecorder, RunReport, Tracer,
                   build_report, step_model_error, tracing)
from ..training.optimizer import AdamW
from ..training.train_step import TrainState
from .cluster import ClusterSpec
from .strategies import Strategy, get_strategy

Batch = Union[RaggedBatch, List[SeqInfo]]


@dataclasses.dataclass
class StepMetrics:
    """What one executed plan produced — the uniform result row every
    caller prints and every benchmark aggregates."""

    step: int
    loss: float
    tokens: int
    step_time_s: float
    strategy: str
    schedule_ms: float
    solver_ms: float
    stage_ms: Dict[str, float]
    degree_histogram: Dict[int, int]
    #: real/padded token ratio of the executed step (1.0 = no padding)
    padding_efficiency: float = 1.0
    #: step functions built during this step (0 once the pool is warm)
    exe_misses: int = 0
    #: True when the plan came from the strategy's PlanCache (the DP
    #: solver was skipped for a recurring batch shape)
    plan_cache_hit: bool = False
    #: group slots created/resized vs the previous plan (GroupDelta)
    groups_reconfigured: int = 0
    #: planning latency hidden behind device execution by the lookahead
    #: pipeline (schedule_ms minus the time collect() actually blocked)
    plan_overlap_ms: float = 0.0
    #: tokens per modality in the executed batch ({"text": .., "vision":
    #: ..}); sequences without span structure count as "text"
    modality_tokens: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    #: Stage-2 allocator time for this plan (cost table + DP), in us —
    #: the millisecond-class-planning budget check_regression gates
    allocate_us: float = 0.0
    #: which planning path produced the plan: "full" | "incremental"
    #: (warm-started DP suffix) | "cache" (PlanCache hit)
    replan_mode: str = "full"
    #: mean next-token NLL per label-token modality class for
    #: span-bearing batches ({"text": .., "vision": ..}). Classes whose
    #: labels are excluded from the TRAINING loss (bidirectional spans)
    #: still report their NLL here for monitoring.
    modality_loss: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    #: cost-model MAPE of this step's scaled predicted vs measured
    #: group times (obs.report.step_model_error); 0.0 on unmeasured
    #: steps and steps where every group paid its first build
    model_error_pct: float = 0.0
    #: the strategy's PlanCache.stats snapshot after this step (hits,
    #: misses, size, nearest_* reference counters); {} when caching off
    plan_cache: Dict[str, int] = dataclasses.field(default_factory=dict)

    def summary(self) -> str:
        cached = " cached" if self.plan_cache_hit else ""
        return (f"step {self.step:3d} loss={self.loss:.4f} "
                f"degrees={self.degree_histogram} "
                f"sched={self.schedule_ms:.1f}ms{cached} "
                f"reconf={self.groups_reconfigured} "
                f"({self.step_time_s:.2f}s)")

    # -- serialization: THE StepMetrics wire format ---------------------
    def to_json(self) -> dict:
        """JSON-serializable dict; `from_json` round-trips it exactly.
        Every consumer (Engine history dumps, benchmarks, the obs run
        report) uses this instead of ad-hoc field plucking."""
        d = dataclasses.asdict(self)
        # JSON object keys are strings; stringify the int degree keys
        d["degree_histogram"] = {str(k): v for k, v
                                 in self.degree_histogram.items()}
        return d

    @classmethod
    def from_json(cls, obj: dict) -> "StepMetrics":
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in obj.items() if k in names}
        kw["degree_histogram"] = {
            int(k): int(v)
            for k, v in (kw.get("degree_histogram") or {}).items()}
        return cls(**kw)


def metrics_to_json(history: List["StepMetrics"]) -> dict:
    """A training history as one JSON document (the --metrics file)."""
    return {"version": 1, "steps": [m.to_json() for m in history]}


def metrics_from_json(obj: dict) -> List["StepMetrics"]:
    steps = obj["steps"] if isinstance(obj, dict) else obj
    return [StepMetrics.from_json(s) for s in steps]




def demo_cost_model(cfg: ModelConfig) -> CostModel:
    """Roofline coefficients for the model shape, with memory accounting
    in plain tokens (m_token=1, m_ms=0) so `mem_budget` reads as a
    per-rank token budget."""
    coeffs = dataclasses.replace(
        analytic_coeffs(
            hidden=cfg.d_model, n_layers=cfg.n_layers,
            n_heads=max(cfg.n_heads, 1), kv_heads=max(cfg.kv_heads, 1),
            ffn=max(cfg.d_ff, 1), vocab=cfg.vocab),
        m_ms=0.0, m_token=1.0)
    return CostModel(coeffs)


class Engine:
    """A training/serving session on one cluster with one swappable
    parallelism strategy.

    >>> eng = Engine("internvl3-2b", ClusterSpec.auto(mem_budget=4096))
    >>> history = eng.train(steps=3, dataset="openvid", global_batch=8)
    >>> rep = eng.serving(slots=4).run(trace)

    `model` is an arch id or a ModelConfig: every arch of the JAX
    package. Each trains and serves; whisper-small (the audio family)
    trains through `training.train_step.make_train_step` on fixed-shape
    batches with frames, not `train`, which the reference's `Engine.train`
    cannot run either. VLM configs run in token-stream mode (the LM decoder
    over pre-counted tokens), as in the JAX package. `device=None`
    places the model on the card and raises when there is none;
    `device="cpu"` runs on the host.
    `state` is a `TrainState`; its optimizer moments are allocated at
    the first training step, so a serving-only engine holds none.
    """

    def __init__(self, model: Union[str, ModelConfig],
                 cluster: Optional[ClusterSpec] = None, *,
                 strategy: Union[str, Strategy] = "dhp",
                 optimizer: Optional[AdamW] = None,
                 cost_model: Optional[CostModel] = None,
                 reduced: bool = False, seed: int = 0,
                 device: Optional[str] = None):
        """`strategy` is a registry name or a Strategy instance (a
        configured `get_strategy(name, **options)`, a ReplayStrategy).
        `optimizer` defaults to AdamW at a constant 3e-4."""
        cfg = get_config(model) if isinstance(model, str) else model
        if reduced:
            cfg = cfg.reduced()
        if cfg.family == "vlm":
            cfg = cfg.with_(family="dense", vlm=None)
        self.cfg = cfg
        self.cluster = cluster or ClusterSpec.auto(device=device)
        self.device = self.cluster.primary
        self.cost_model = cost_model or demo_cost_model(cfg)
        self.strategy = (get_strategy(strategy)
                         if isinstance(strategy, str) else strategy)
        self.strategy.bind(self.cost_model, self.cluster.n_replicas,
                           self.cluster.mem_budget)
        self.seed = seed
        self.optimizer = optimizer or AdamW(lr=3e-4)
        self._state: Optional[TrainState] = None
        self._executor: Optional[DHPExecutor] = None
        self._step = 0
        self._prev_plan: Optional[ExecutionPlan] = None
        #: session-lifetime counters/gauges/histograms (obs.metrics)
        self.metrics = MetricsRegistry()
        #: per-group (predicted, measured, rank-slot) records feeding
        #: the run report; installed by train(trace=/report=)
        self._recorder: Optional[RunRecorder] = None
        #: the RunReport of the last traced/reported train() call
        self.last_report: Optional[RunReport] = None
        #: the loader train() last built or was given
        self.loader: Optional[Iterable[RaggedBatch]] = None
        #: the stream position a checkpoint left for the next train()
        self._loader_state: Optional[dict] = None
        self.last_tracer: Optional[Tracer] = None

    @property
    def executor(self) -> DHPExecutor:
        if self._executor is None:
            self._executor = DHPExecutor(self.cfg, self.cluster.pool())
        return self._executor

    @property
    def state(self) -> TrainState:
        if self._state is None:
            self._state = self.init_state(self.seed)
        return self._state

    @state.setter
    def state(self, value: TrainState) -> None:
        self._state = value

    def init_state(self, seed: int = 0) -> TrainState:
        """Random parameters from `seed` on the engine's device; the
        optimizer state comes with the first update."""
        from ..models.model import init_params
        return TrainState(params=init_params(self.cfg, seed=seed,
                                             device=self.device),
                          opt=None)

    # -- plan -----------------------------------------------------------
    def plan(self, batch: Batch) -> ExecutionPlan:
        """Plan one global batch with the session's strategy."""
        infos = batch.infos if isinstance(batch, RaggedBatch) else batch
        return self.strategy.plan(infos)

    # -- execute --------------------------------------------------------
    def execute(self, plan: ExecutionPlan,
                data: RaggedBatch) -> StepMetrics:
        """Run a plan on the cluster and apply the AdamW update. Groups
        are timed one by one when the strategy asks for measurements
        (the oracle) or while train(trace=/report=) records the run."""
        measure = (self.strategy.wants_measurement
                   or self._recorder is not None)
        # group-reconfiguration delta vs the previously executed plan:
        # the pool consumes it instead of re-deriving every group
        if plan.delta is None:
            plan.delta = diff_plans(self._prev_plan, plan,
                                    self.cluster.n_replicas)
        self.executor.pool.reconfigure(plan.delta)
        self._prev_plan = plan
        timings: Optional[List[dict]] = [] if measure else None
        t0 = time.perf_counter()
        state = self.state
        loss, grads = self.executor.run_plan(state.params, plan, data,
                                             timings=timings)
        opt = state.opt if state.opt is not None \
            else self.optimizer.init(state.params)
        params, opt = self.optimizer.update(grads, opt, state.params)
        self.state = TrainState(params=params, opt=opt)
        del grads
        loss = float(loss)                  # waits for the device
        step_time = time.perf_counter() - t0
        model_error = 0.0
        if timings:
            self.strategy.observe(plan, timings)
            model_error = step_model_error(plan, timings)
            if self._recorder is not None:
                self._recorder.record_step(self._step, plan, timings)
        mod_tokens: Dict[str, int] = {}
        for s in data.infos:
            if s.spans:
                for sp in s.spans:
                    mod_tokens[sp.modality] = (
                        mod_tokens.get(sp.modality, 0) + sp.length)
            else:
                mod_tokens["text"] = mod_tokens.get("text", 0) + s.length
        stats = self.executor.last_run_stats
        metrics = StepMetrics(
            step=self._step,
            loss=loss,
            tokens=sum(g.tokens for mb in plan.micro_batches
                       for g in mb.groups),
            step_time_s=step_time,
            strategy=plan.strategy_name or self.strategy.name,
            schedule_ms=plan.schedule_ms,
            solver_ms=plan.solver_ms,
            stage_ms=dict(plan.stage_ms),
            degree_histogram=plan.degree_histogram,
            padding_efficiency=stats.get("padding_efficiency", 1.0),
            exe_misses=stats.get("exe_misses", 0),
            plan_cache_hit=plan.from_cache,
            groups_reconfigured=plan.delta.n_reconfigured,
            modality_tokens=mod_tokens,
            allocate_us=plan.stage_ms.get("allocate", 0.0) * 1e3,
            replan_mode=plan.replan_mode,
            modality_loss=dict(stats.get("modality_loss", {})),
            model_error_pct=model_error,
            plan_cache=(dict(self.strategy.plan_cache.stats)
                        if self.strategy.plan_cache is not None else {}),
        )
        self._step += 1
        self._update_metrics(metrics, measured=bool(timings))
        return metrics

    def _update_metrics(self, m: StepMetrics, *, measured: bool) -> None:
        """Fold one step's signals into the session metrics registry."""
        reg = self.metrics
        reg.counter("train/steps").inc()
        reg.counter("train/tokens").inc(m.tokens)
        reg.counter("pool/exe_misses").inc(m.exe_misses)
        reg.counter("pool/groups_reconfigured").inc(
            m.groups_reconfigured)
        reg.counter("plan/steps_from_cache").inc(int(m.plan_cache_hit))
        reg.histogram("plan/schedule_ms").observe(m.schedule_ms)
        reg.histogram("plan/allocate_us").observe(m.allocate_us)
        reg.histogram("exec/step_time_s").observe(m.step_time_s)
        reg.histogram("exec/padding_efficiency").observe(
            m.padding_efficiency)
        if measured:
            reg.histogram("cost_model/error_pct").observe(
                m.model_error_pct)
        reg.update_from(m.plan_cache, "plan/cache_")
        reg.update_from(vars(self.executor.pool.stats), "pool/total_")

    # -- train: THE loop ------------------------------------------------
    def train(self, loader: Optional[Iterable[RaggedBatch]] = None, *,
              steps: int = 10, dataset: str = "openvid",
              global_batch: int = 8, max_tokens: int = 512,
              tokens_per_frame: int = 16,
              lookahead: Union[bool, int] = True,
              plan_log: Optional[List[ExecutionPlan]] = None,
              log=None,
              trace: Union[None, bool, str, Tracer] = None,
              report: Union[None, bool, str] = None
              ) -> List[StepMetrics]:
        """The training loop: heterogeneous batches -> strategy plan ->
        executor -> AdamW. Every strategy runs through it.

        `loader`: an iterable of RaggedBatch (default: a
        HeterogeneousLoader over `dataset` from the engine's seed).
        `lookahead=True` (default) plans batch t+1 on a background host
        thread while the card runs batch t (`StepMetrics.plan_overlap_ms`
        reports the hidden planning time); an int k keeps the plans of
        batches t+1..t+k in flight on that thread, solved back to back
        on the scheduler's warm allocator state; `False` plans
        synchronously. `plan_log`: a list that receives every executed
        plan (the `--save-plans` trace). `log`: called with each step's
        summary line.

        `trace`: a path (Chrome trace-event JSON is saved there), True,
        or a Tracer — records the run's timeline (planner thread,
        scheduler stages, one span per group on its rank's track;
        `self.last_tracer`). `report`: a path or True — builds the
        RunReport (per-wave imbalance, per-rank straggler scores,
        cost-model MAPE), kept on `self.last_report` and saved as JSON
        when a path is given. Either option runs every group
        synchronously and timed, so each span and record holds its
        device time."""
        self.executor      # refuses a family it cannot run, before planning
        tracer: Optional[Tracer] = None
        trace_path: Optional[str] = None
        if trace is not None and trace is not False:
            if isinstance(trace, str):
                trace_path, tracer = trace, Tracer()
            elif trace is True:
                tracer = Tracer()
            else:
                tracer = trace
        self.last_tracer = tracer
        observing = tracer is not None or bool(report)
        if observing:
            self._recorder = RunRecorder(self.cluster.n_replicas)
        if loader is None:
            loader = HeterogeneousLoader(
                dataset, global_batch, self.cfg.vocab, seed=self.seed,
                max_tokens=max_tokens, tokens_per_frame=tokens_per_frame)
        if self._loader_state is not None and hasattr(loader, "set_state"):
            # a checkpoint restore left a stream position to resume from
            loader.set_state(self._loader_state)
            self._loader_state = None
        self.loader = loader
        history: List[StepMetrics] = []
        try:
            if tracer is not None:
                with tracing(tracer):
                    self._train_loop(loader, steps, lookahead, plan_log,
                                     log, history)
            else:
                self._train_loop(loader, steps, lookahead, plan_log, log,
                                 history)
        finally:
            if observing:
                self.last_report = build_report(
                    self._recorder, history,
                    metrics=self.metrics.snapshot())
                self._recorder = None
                if isinstance(report, str):
                    self.last_report.save(report)
            if trace_path is not None:
                tracer.save(trace_path)
        return history

    def _train_loop(self, loader, steps, lookahead, plan_log, log,
                    history: List[StepMetrics]) -> None:
        it: Iterator[RaggedBatch] = iter(loader)
        # lookahead depth: 0 = synchronous, k >= 1 = plans for batches
        # t+1..t+k kept in flight on the planner thread
        depth = (1 if lookahead is True
                 else 0 if lookahead is False else max(0, int(lookahead)))
        try:
            data = next(it)
        except StopIteration:
            return
        n_fetched = 1
        if depth:
            self.strategy.prepare(data.infos)
        queue: "collections.deque[RaggedBatch]" = collections.deque()
        for _ in range(steps):
            if depth:
                plan = self.strategy.collect()
                overlap = max(
                    0.0, plan.schedule_ms - self.strategy.last_wait_ms)
            else:
                plan = self.strategy.plan(data.infos)
                overlap = 0.0
            # top up the prefetch window only with batches that WILL run:
            # a batch (or a replayed plan) fetched and never run would
            # desync a resumable loader and ReplayStrategy's cursor
            while n_fetched < steps and len(queue) < max(depth, 1):
                try:
                    nxt = next(it)
                except StopIteration:
                    break
                queue.append(nxt)
                n_fetched += 1
                if depth:
                    self.strategy.prepare(nxt.infos)
            metrics = self.execute(plan, data)
            metrics.plan_overlap_ms = overlap
            if plan_log is not None:
                plan_log.append(plan)
            history.append(metrics)
            if log is not None:
                log(metrics.summary())
            if not queue:
                break
            data = queue.popleft()

    # -- serve ----------------------------------------------------------
    @torch.no_grad()
    def serve(self, prompts=None, *, batch: int = 8, prompt_len: int = 96,
              gen_tokens: int = 32, cache_len: Optional[int] = None):
        """Batched prefill + greedy decode (the one-shot fixed-batch
        path). `prompts`: [B, S] token ids (drawn from the seed when
        None). The dense and MoE families prefill a K/V cache (MoE
        routing the batch's tokens jointly, as the reference does); the
        SSM, hybrid and audio families start from a fresh cache with the
        prompts' last token as the first decode input, as the JAX
        package does; the audio family's cache first takes the cross K/V
        of `serving_frames` (a row of frames a prompt) through the
        encoder.
        Returns (decoded [B, gen_tokens], dict of timings)."""
        from ..models.model import (PREFILL_FAMILIES, init_cache, prefill,
                                    prefill_cross_kv, serving_frames)
        from ..serving.serve_step import greedy_generate, make_serve_step

        if prompts is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.seed + 1)
            prompts = torch.randint(0, self.cfg.vocab, (batch, prompt_len),
                                    generator=gen, device=self.device)
        prompts = torch.as_tensor(prompts, device=self.device).long()
        batch, prompt_len = prompts.shape
        cache_len = cache_len or prompt_len + gen_tokens

        t0 = time.perf_counter()
        if self.cfg.family in PREFILL_FAMILIES:
            logits, cache = prefill(self.state.params, self.cfg,
                                    {"tokens": prompts},
                                    cache_len=cache_len)
            first = torch.argmax(logits[:, 0], dim=-1)
        else:
            cache = init_cache(self.cfg, batch, cache_len,
                               device=self.device)
            if self.cfg.family == "audio":
                frames = serving_frames(self.cfg, batch, self.seed,
                                        self.device)
                cache = prefill_cross_kv(self.state.params, self.cfg,
                                         frames, cache)
            first = prompts[:, -1]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_prefill = time.perf_counter() - t0

        step, step_miss = self.cluster.pool().executable_for(
            ("serve", self.cfg.arch_id, self.cfg.family, batch, cache_len),
            lambda: make_serve_step(self.cfg))
        t0 = time.perf_counter()
        out, cache = greedy_generate(self.state.params, self.cfg, cache,
                                     first, gen_tokens, step=step)
        out = out.cpu()
        t_decode = time.perf_counter() - t0
        report = {
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "ms_per_token": t_decode / max(gen_tokens, 1) * 1e3,
            "batch": batch,
            "prompt_len": prompt_len,
            "exe_miss": step_miss,
        }
        return out, report

    # -- serving ---------------------------------------------------------
    def serving(self, *, slots: int = 4, prefill_chunk: int = 128,
                cache_len: Optional[int] = None, block_size: int = 16,
                n_blocks: Optional[int] = None, strategy: str = "dhp"):
        """The continuous-batching runtime over this engine's model and
        cluster (serving/runtime.py): paged KV slots, chunked prefill
        planned by `strategy` ("dhp" or "static"), iteration-level
        batching."""
        from ..serving.runtime import ServingEngine
        return ServingEngine(
            self.cfg, self.state.params, self.cluster, self.cost_model,
            slots=slots, cache_len=cache_len, block_size=block_size,
            n_blocks=n_blocks, prefill_chunk=prefill_chunk,
            strategy=strategy, seed=self.seed)

    # -- checkpointing ---------------------------------------------------
    def save_checkpoint(self, path: str) -> None:
        """Full train-state snapshot (format 2): params, optimizer state,
        the step counter and, once train() ran, the loader's stream
        position: what a resume that equals an unbroken run needs. The
        file is written before this returns, so later in-place updates
        of the moments do not reach it. Before the first update the
        state has no optimizer state (`opt` is None): the file then
        holds the parameters alone beside the meta blob, and
        `load_checkpoint` leaves `opt` None, so the first step after the
        resume allocates fresh moments, as it would have without the
        break."""
        from ..training.checkpoint import save
        meta = {"format": 2, "step": self._step}
        if self.loader is not None and hasattr(self.loader, "state"):
            meta["loader"] = self.loader.state()
        save(path, {"params": self.state.params, "opt": self.state.opt},
             meta=meta)

    def load_checkpoint(self, path: str) -> None:
        """Restore a `save_checkpoint` file (or the JAX package's) into
        this engine: new tensors on its device in its dtypes. A file
        without a meta blob is the old params-only format."""
        from ..training.checkpoint import SEP, entries, load_meta, restore
        meta = load_meta(path)
        params = self.state.params
        if meta is None:
            self.state = TrainState(params=restore(path, params),
                                    opt=self.state.opt)
            return
        opt = None
        if f"opt{SEP}step" in entries(path):
            opt = (self.state.opt if self.state.opt is not None
                   else self.optimizer.init(params))
        tree = restore(path, {"params": params, "opt": opt})
        self.state = TrainState(params=tree["params"], opt=tree["opt"])
        self._step = int(meta.get("step", self._step))
        self._loader_state = meta.get("loader")

    def close(self) -> None:
        self.strategy.close()
