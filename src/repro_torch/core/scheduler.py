"""DHP Scheduler — overall workflow of Fig. 3.

Global batch --(micro-batch planner)--> micro-batches
 --(Stage 1: memory-aware BFD packing)--> atomic groups
 --(Stage 2: 2D-DP allocator)--> CP degrees + assignment
 --> ExecutionPlan consumed by the executor.

The scheduler is pure host-side Python (numpy-free hot path) so it can
run on the host while the device computes — `prepare()` schedules the
*next* batch on a background thread while the card runs the current
one (the paper's producer-consumer decoupling, §5 Implementation (2)).
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import threading
import time
from collections import OrderedDict
from typing import (Any, Callable, Dict, List, Optional, Sequence as Seq,
                    Tuple)

from ..obs.trace import get_tracer
from .allocator import Allocation, IncrementalAllocator, allocate
from .cost_model import CostModel, ModalitySpan, SeqInfo
from .packing import AtomicGroup, pack_sequences

#: Plan IR version stamped into every serialized plan (v3: with the
#: optional per-sequence modality-span table `seq_spans`); a span-free
#: plan hashes identically to its v2 form.
PLAN_IR_VERSION = 3


class PlanValidationError(ValueError):
    """An ExecutionPlan violated a scheduling invariant (Eq. 3/6 or
    seq-id coverage)."""


@dataclasses.dataclass
class GroupPlan:
    """One CP group within a micro-batch: which sequences, what degree."""

    seq_ids: List[int]
    degree: int
    est_time: float
    tokens: int

    def to_json(self) -> dict:
        return {"seq_ids": list(self.seq_ids), "degree": self.degree,
                "est_time": self.est_time, "tokens": self.tokens}

    @classmethod
    def from_json(cls, obj: dict) -> "GroupPlan":
        return cls(seq_ids=[int(i) for i in obj["seq_ids"]],
                   degree=int(obj["degree"]),
                   est_time=float(obj["est_time"]),
                   tokens=int(obj["tokens"]))


@dataclasses.dataclass
class MicroBatchPlan:
    groups: List[GroupPlan]
    makespan: float            # max est_time (the DP objective, Eq. 2)
    ranks_used: int

    def to_json(self) -> dict:
        return {"groups": [g.to_json() for g in self.groups],
                "makespan": self.makespan, "ranks_used": self.ranks_used}

    @classmethod
    def from_json(cls, obj: dict) -> "MicroBatchPlan":
        return cls(groups=[GroupPlan.from_json(g) for g in obj["groups"]],
                   makespan=float(obj["makespan"]),
                   ranks_used=int(obj["ranks_used"]))


@dataclasses.dataclass
class GroupDelta:
    """What changed in the communication-group layout vs the PREVIOUS
    plan.

    Groups are named by their (start, degree) rank slot — the same key
    the GroupPool caches meshes/executables under — so a delta tells the
    pool exactly which artifacts to reuse and which to (re)create:

      reused   — slot occupied by both plans (zero reconfiguration cost);
      resized  — start rank kept, CP degree changed (new ring size);
      created  — slot that did not exist in the previous plan;
      released — previous slot whose start rank the new plan leaves
                 entirely (kept pooled, not destroyed).
    """

    created: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    reused: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    resized: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)
    released: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)

    @property
    def n_reconfigured(self) -> int:
        """Slots needing (re)creation — the paper's per-batch group
        setup cost the pool amortises."""
        return len(self.created) + len(self.resized)

    def summary(self) -> str:
        return (f"groups: {len(self.reused)} reused, "
                f"{len(self.created)} created, "
                f"{len(self.resized)} resized, "
                f"{len(self.released)} released")

    def to_json(self) -> dict:
        return {k: [list(s) for s in getattr(self, k)]
                for k in ("created", "reused", "resized", "released")}

    @classmethod
    def from_json(cls, obj: dict) -> "GroupDelta":
        return cls(**{k: [tuple(int(x) for x in s) for s in obj[k]]
                      for k in ("created", "reused", "resized",
                                "released")})


@dataclasses.dataclass
class ExecutionPlan:
    micro_batches: List[MicroBatchPlan]
    total_time_est: float
    schedule_ms: float         # end-to-end scheduling latency (Table 1/2)
    solver_ms: float           # 2D-DP time alone (Table 1/2)
    strategy_name: str = ""    # which registered strategy produced this
    stage_ms: Dict[str, float] = dataclasses.field(default_factory=dict)
    # per-stage scheduling latency, e.g. {"microbatch": .., "pack": ..,
    # "allocate": ..} — lets benchmarks attribute plan cost per stage
    # and per strategy from one code path.
    version: int = PLAN_IR_VERSION
    from_cache: bool = False   # True when a PlanCache hit produced this
    replan_mode: str = "full"
    # which planning path produced this plan: "full" (cold solve),
    # "incremental" (warm-started DP suffix re-solve) or "cache"
    # (PlanCache structural hit). Telemetry only — excluded from the
    # structural hash, so plans from different paths still compare
    # equal when their structure is equal.
    seq_spans: Optional[Dict[int, Tuple[ModalitySpan, ...]]] = None
    # per-sequence modality layout (seq_id -> spans) for span-bearing
    # batches; Strategy.plan attaches it from the input sequences so a
    # saved trace records the structure its costs were derived from.
    delta: Optional[GroupDelta] = None
    # group reconfiguration vs the previously executed plan; filled by
    # diff_plans (the Engine does it before execution).

    @property
    def n_groups(self) -> int:
        return sum(len(mb.groups) for mb in self.micro_batches)

    @property
    def degree_histogram(self) -> dict:
        """{degree: count} across all micro-batches — Table 4 case study."""
        h: dict = {}
        for mb in self.micro_batches:
            for g in mb.groups:
                h[g.degree] = h.get(g.degree, 0) + 1
        return dict(sorted(h.items(), reverse=True))

    # -- rank-slot geometry ---------------------------------------------
    def group_slots(self, n_ranks: int) -> List[Tuple[int, int, int, int]]:
        """(mb_index, group_index, start_rank, degree) per group, using
        the SAME cursor rule as the executor (including the defensive
        wrap for oversubscribed micro-batches) — the single source of
        truth for which rank slice a group runs on, shared by the
        executor, diff_plans and replay equality checks."""
        slots = []
        for mi, mb in enumerate(self.micro_batches):
            start = 0
            for gi, g in enumerate(mb.groups):
                if start + g.degree > n_ranks:
                    start = 0
                slots.append((mi, gi, start, g.degree))
                start += g.degree
        return slots

    # -- structural identity --------------------------------------------
    def _spans_tree(self) -> Optional[list]:
        if not self.seq_spans:
            return None
        return sorted(
            [int(sid), [sp.to_json() for sp in spans]]
            for sid, spans in self.seq_spans.items())

    def structural_hash(self) -> str:
        """Stable digest of the plan STRUCTURE (micro-batch tree of
        (seq_ids, degree), plus the modality-span table when present —
        two plans over batches of equal lengths but different span
        layouts have different costs, so they must hash apart)."""
        tree = [[[list(g.seq_ids), g.degree] for g in mb.groups]
                for mb in self.micro_batches]
        spans = self._spans_tree()
        # structure only — no version salt, and span-free plans keep the
        # exact v2 blob, so traces saved by older IR versions still
        # hash-verify
        blob = json.dumps(tree if spans is None else [tree, spans],
                          separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # -- invariants ------------------------------------------------------
    def validate(self, seqs: Optional[Seq[SeqInfo]] = None, *,
                 n_ranks: Optional[int] = None,
                 cost_model: Optional[CostModel] = None,
                 mem_budget: Optional[float] = None) -> "ExecutionPlan":
        """Check scheduling invariants; raises PlanValidationError.

        Checks are keyed to what context is supplied:
          * always        — degrees >= 1, non-empty groups;
          * `n_ranks`     — wave feasibility, Eq. 6: per micro-batch
                            sum(degrees) <= N and each degree <= N;
          * `seqs`        — coverage: every seq_id scheduled exactly once;
          * `seqs` + `cost_model` + `mem_budget`
                          — memory, Eq. 3: M(C_p) <= E * d_p per group.
        Returns self so call sites can chain."""
        by_id = {s.seq_id: s for s in seqs} if seqs is not None else None
        seen: Dict[int, int] = {}
        for mi, mb in enumerate(self.micro_batches):
            wave_degrees = 0
            for g in mb.groups:
                if g.degree < 1:
                    raise PlanValidationError(
                        f"mb{mi}: group degree {g.degree} < 1")
                if not g.seq_ids:
                    raise PlanValidationError(f"mb{mi}: empty group")
                wave_degrees += g.degree
                for i in g.seq_ids:
                    seen[i] = seen.get(i, 0) + 1
                if (by_id is not None and cost_model is not None
                        and mem_budget is not None):
                    try:
                        gseqs = [by_id[i] for i in g.seq_ids]
                    except KeyError as e:
                        raise PlanValidationError(
                            f"mb{mi}: unknown seq_id {e.args[0]}") from e
                    mem = cost_model.memory(gseqs)
                    if mem > mem_budget * g.degree + 1e-6:
                        raise PlanValidationError(
                            f"mb{mi}: memory {mem:.3g} > budget "
                            f"{mem_budget:.3g} x degree {g.degree} "
                            f"(Eq. 3)")
            if n_ranks is not None and wave_degrees > n_ranks:
                raise PlanValidationError(
                    f"mb{mi}: sum of degrees {wave_degrees} > ranks "
                    f"{n_ranks} (Eq. 6 wave feasibility)")
        if by_id is not None:
            dup = {i: c for i, c in seen.items() if c > 1}
            missing = set(by_id) - set(seen)
            extra = set(seen) - set(by_id)
            if dup or missing or extra:
                raise PlanValidationError(
                    f"seq-id coverage broken: duplicated={sorted(dup)} "
                    f"missing={sorted(missing)} extra={sorted(extra)}")
        return self

    # -- serialization ---------------------------------------------------
    def to_json(self) -> dict:
        """JSON-serializable dict, version-stamped and hash-stamped."""
        return {
            "version": PLAN_IR_VERSION,
            "strategy_name": self.strategy_name,
            "structural_hash": self.structural_hash(),
            "total_time_est": self.total_time_est,
            "schedule_ms": self.schedule_ms,
            "solver_ms": self.solver_ms,
            "stage_ms": dict(self.stage_ms),
            "from_cache": self.from_cache,
            "replan_mode": self.replan_mode,
            "micro_batches": [mb.to_json() for mb in self.micro_batches],
            "delta": self.delta.to_json() if self.delta else None,
            "seq_spans": (None if not self.seq_spans else {
                str(sid): [sp.to_json() for sp in spans]
                for sid, spans in self.seq_spans.items()}),
        }

    @classmethod
    def from_json(cls, obj: dict) -> "ExecutionPlan":
        v = int(obj.get("version", 1))
        if v > PLAN_IR_VERSION:
            raise ValueError(
                f"plan IR version {v} is newer than supported "
                f"{PLAN_IR_VERSION}")
        plan = cls(
            micro_batches=[MicroBatchPlan.from_json(mb)
                           for mb in obj["micro_batches"]],
            total_time_est=float(obj["total_time_est"]),
            schedule_ms=float(obj.get("schedule_ms", 0.0)),
            solver_ms=float(obj.get("solver_ms", 0.0)),
            strategy_name=obj.get("strategy_name", ""),
            stage_ms=dict(obj.get("stage_ms", {})),
            version=PLAN_IR_VERSION,
            from_cache=bool(obj.get("from_cache", False)),
            replan_mode=str(obj.get("replan_mode", "full")),
            delta=(GroupDelta.from_json(obj["delta"])
                   if obj.get("delta") else None),
            seq_spans=(None if not obj.get("seq_spans") else {
                int(sid): tuple(ModalitySpan.from_json(sp)
                                for sp in spans)
                for sid, spans in obj["seq_spans"].items()}),
        )
        want = obj.get("structural_hash")
        if want is not None and plan.structural_hash() != want:
            raise ValueError(
                f"plan structural hash mismatch: stored {want}, "
                f"reconstructed {plan.structural_hash()} — corrupt or "
                f"hand-edited plan file")
        return plan


def diff_plans(prev: Optional[ExecutionPlan], cur: ExecutionPlan,
               n_ranks: int) -> GroupDelta:
    """Group-reconfiguration delta between two consecutive plans.

    Slots are the deduplicated (start, degree) rank slices each plan
    occupies (via `group_slots`); `prev=None` means cold start — every
    slot is `created`."""
    cur_slots = sorted({(s, d) for _, _, s, d
                        in cur.group_slots(n_ranks)})
    if prev is None:
        return GroupDelta(created=list(cur_slots))
    prev_slots = {(s, d) for _, _, s, d in prev.group_slots(n_ranks)}
    prev_starts = {s for s, _ in prev_slots}
    delta = GroupDelta()
    for slot in cur_slots:
        if slot in prev_slots:
            delta.reused.append(slot)
        elif slot[0] in prev_starts:
            delta.resized.append(slot)
        else:
            delta.created.append(slot)
    cur_starts = {s for s, _ in cur_slots}
    delta.released = sorted(slot for slot in prev_slots
                            if slot[0] not in cur_starts)
    return delta


# -- persistence -------------------------------------------------------------
def plans_to_json(plans: Seq[ExecutionPlan]) -> dict:
    """A run's plan trace as one JSON document (the --save-plans file,
    in the JAX package's format: either package loads the other's)."""
    return {"version": PLAN_IR_VERSION,
            "plans": [p.to_json() for p in plans]}


def plans_from_json(obj: dict) -> List[ExecutionPlan]:
    v = int(obj.get("version", 1))
    if v > PLAN_IR_VERSION:
        raise ValueError(f"plan file version {v} > {PLAN_IR_VERSION}")
    return [ExecutionPlan.from_json(p) for p in obj["plans"]]


def save_plans(path: str, plans: Seq[ExecutionPlan]) -> None:
    with open(path, "w") as f:
        json.dump(plans_to_json(plans), f, indent=1)


def load_plans(path: str) -> List[ExecutionPlan]:
    with open(path) as f:
        return plans_from_json(json.load(f))


# -- plan cache --------------------------------------------------------------
def _default_cache_bucket(n: int) -> int:
    b = 64
    while b < n:
        b *= 2
    return b


class PlanCache:
    """LRU cache of ExecutionPlans keyed on the batch's bucketed length
    histogram.

    Recurring batch *shapes* — the common case under bucketed data
    sampling — skip Stage 1 + the 2D-DP solver entirely: the cached
    plan's structure is reused with seq_ids remapped onto the new batch
    (both batches sorted by descending length, matched positionally) and
    per-group time estimates re-evaluated for the actual lengths. A
    remap whose memory invariant (Eq. 3) fails — same bucket, different
    d_min — is treated as a miss, so hits are always feasible plans.
    """

    def __init__(self, capacity: int = 64,
                 bucket_fn: Optional[Callable[[int], int]] = None,
                 salt: Any = None):
        """`salt` namespaces the key space so one cache can be shared
        across planning phases (e.g. training batches vs serving
        chunked-prefill batches) without a same-shape batch from one
        phase serving a plan tuned for the other."""
        self.capacity = capacity
        self.bucket_fn = bucket_fn or _default_cache_bucket
        self.salt = salt
        self._entries: "OrderedDict[Any, Tuple[ExecutionPlan, List[SeqInfo]]]" \
            = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        # nearest() warm-reference accounting (separate from hit/miss:
        # a reference is never served as a plan)
        self.nearest_exact = 0
        self.nearest_fallback = 0
        self.nearest_none = 0

    # ------------------------------------------------------------------
    def _span_sig(self, s: SeqInfo) -> Any:
        """Coarse span-layout signature: (bidirectional span count,
        bucketed bidirectional token total, bucketed largest block).
        Two sequences of equal length whose span layouts differ (and
        hence whose DERIVED eta/cost differ) land in different cache
        buckets; scalar SeqInfos keep signature None, so pre-span
        callers see the exact old key space. Deliberately O(1)-sized —
        a long video is hundreds of frame spans, and this tuple is
        hashed/sorted on every plan() call."""
        spans = getattr(s, "spans", None)
        if not spans:
            return None
        n = total = biggest = 0
        for sp in spans:
            if sp.attn == "bidirectional":
                n += 1
                total += sp.length
                biggest = max(biggest, sp.length)
        if n == 0:
            return (0, 0, 0)
        return (n, self.bucket_fn(total), self.bucket_fn(biggest))

    def key(self, seqs: Seq[SeqInfo]) -> Any:
        """Structural key: histogram over (length bucket, coarse eta,
        span signature), namespaced by `salt`."""
        h: Dict[Any, int] = {}
        for s in seqs:
            k = (self.bucket_fn(s.length), round(s.eta, 2),
                 self._span_sig(s))
            h[k] = h.get(k, 0) + 1
        return (self.salt, tuple(sorted(h.items(), key=repr)))

    @staticmethod
    def _order(seqs: Seq[SeqInfo]) -> List[SeqInfo]:
        return sorted(seqs, key=lambda s: (-s.length, s.seq_id))

    # ------------------------------------------------------------------
    def lookup(self, seqs: Seq[SeqInfo], *,
               cost_model: Optional[CostModel] = None,
               n_ranks: Optional[int] = None,
               mem_budget: Optional[float] = None
               ) -> Optional[ExecutionPlan]:
        """Return a plan for `seqs` remapped from a cached same-shape
        batch, or None (miss)."""
        k = self.key(seqs)
        with self._lock:
            entry = self._entries.get(k)
            if entry is not None:
                self._entries.move_to_end(k)
        if entry is None:
            self.misses += 1
            return None
        cached_plan, cached_seqs = entry
        remap = {old.seq_id: new.seq_id
                 for old, new in zip(self._order(cached_seqs),
                                     self._order(seqs))}
        by_id = {s.seq_id: s for s in seqs}
        micro = []
        for mb in cached_plan.micro_batches:
            groups = []
            for g in mb.groups:
                ids = [remap[i] for i in g.seq_ids]
                gseqs = [by_id[i] for i in ids]
                est = (cost_model.group_time(gseqs, g.degree)
                       if cost_model is not None else g.est_time)
                groups.append(GroupPlan(
                    seq_ids=ids, degree=g.degree, est_time=est,
                    tokens=sum(s.length for s in gseqs)))
            micro.append(MicroBatchPlan(
                groups=groups,
                makespan=max(g.est_time for g in groups),
                ranks_used=mb.ranks_used))
        plan = ExecutionPlan(
            micro_batches=micro,
            total_time_est=sum(m.makespan for m in micro),
            schedule_ms=0.0, solver_ms=0.0,
            strategy_name=cached_plan.strategy_name,
            stage_ms={}, from_cache=True, replan_mode="cache")
        try:
            plan.validate(seqs, n_ranks=n_ranks, cost_model=cost_model,
                          mem_budget=mem_budget)
        except PlanValidationError:
            # same histogram bucket but a different d_min — do not serve
            # an infeasible plan; replan (and let store() refresh it).
            self.misses += 1
            return None
        self.hits += 1
        return plan

    def nearest(self, seqs: Seq[SeqInfo]) -> Optional[ExecutionPlan]:
        """The stored plan whose batch histogram is CLOSEST to `seqs`:
        the exact-key entry when one exists, else the entry with the
        largest multiset overlap of (length-bucket, eta, span-sig)
        items. Unlike `lookup` this neither remaps seq_ids nor
        validates — the result is a warm REFERENCE for incremental
        replanning (which groups/degrees a near-identical batch used),
        not an executable plan. Accounted separately from hit/miss
        (`nearest_exact` / `nearest_fallback` / `nearest_none` in
        `stats`): a reference is never served as a plan, so it must not
        distort the cache's hit rate."""
        k = self.key(seqs)
        with self._lock:
            entry = self._entries.get(k)
            if entry is not None:
                self.nearest_exact += 1
                return entry[0]
            if not self._entries:
                self.nearest_none += 1
                return None
            want = dict(k[1])
            best, score = None, -1
            for (_, items), (plan, _) in self._entries.items():
                ov = sum(min(c, want.get(kk, 0)) for kk, c in items)
                if ov > score:
                    best, score = plan, ov
            self.nearest_fallback += 1
            return best

    def store(self, seqs: Seq[SeqInfo], plan: ExecutionPlan) -> None:
        # Deep-copy through the IR so later telemetry mutations on the
        # live plan (delta, schedule_ms) never leak into the cache.
        snapshot = ExecutionPlan.from_json(plan.to_json())
        snapshot.from_cache = False
        with self._lock:
            self._entries[self.key(seqs)] = (snapshot, list(seqs))
            self._entries.move_to_end(self.key(seqs))
            while len(self._entries) > self.capacity:
                self._entries.popitem(last=False)

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "size": len(self._entries),
                "nearest_exact": self.nearest_exact,
                "nearest_fallback": self.nearest_fallback,
                "nearest_none": self.nearest_none}


class MicroBatchPlanner:
    """Chunks a global batch into micro-batches under a token budget.

    Sequences are sorted descending and bucketed so each micro-batch's
    total activation footprint fits the cluster (N ranks x E budget) —
    the necessary feasibility condition for Stage 1.
    """

    def __init__(self, cost_model: CostModel, n_ranks: int, budget: float):
        self.cm = cost_model
        self.n_ranks = n_ranks
        self.budget = budget

    def plan(self, seqs: Seq[SeqInfo]) -> List[List[SeqInfo]]:
        c = self.cm.coeffs
        cap = (self.budget - c.m_ms) * self.n_ranks
        order = sorted(seqs, key=lambda s: s.length, reverse=True)
        micro: List[List[SeqInfo]] = []
        cur: List[SeqInfo] = []
        used = 0.0
        for s in order:
            need = s.length * c.m_token
            if cur and used + need > cap:
                micro.append(cur)
                cur, used = [], 0.0
            cur.append(s)
            used += need
        if cur:
            micro.append(cur)
        return micro


def _feasible_waves(groups, n_ranks):
    """Partition atomic groups into waves with sum(d_min) <= n_ranks.

    Greedy first-fit-decreasing on d_min; each wave is scheduled by one
    2D-DP call and waves execute back-to-back.
    """
    waves, loads = [], []
    for g in sorted(groups, key=lambda g: g.d_min, reverse=True):
        for i, load in enumerate(loads):
            if load + g.d_min <= n_ranks:
                waves[i].append(g)
                loads[i] += g.d_min
                break
        else:
            waves.append([g])
            loads.append(g.d_min)
    return waves


class DHPScheduler:
    """The paper's Scheduler class (§5): plans one global batch."""

    def __init__(
        self,
        cost_model: CostModel,
        n_ranks: int,
        mem_budget: float,
        *,
        use_all_ranks: bool = True,
        balance_packing: bool = True,
        serial_fallback: bool = True,
        allocator: Optional[Callable] = None,
        incremental: bool = True,
    ):
        """`balance_packing` (packing balances groups over the ranks)
        and `serial_fallback` (a wave runs as serial full-degree groups
        when that is faster) are BEYOND-PAPER refinements; disable both
        for the paper-faithful scheduler.

        `allocator` swaps the Stage-2 solver (default: the 2D-DP
        `allocate`; pass `allocate_bruteforce` for the exact oracle —
        only tractable on small waves).

        `incremental` (default on, only with the default solver) keeps
        one `IncrementalAllocator` per wave ordinal so consecutive
        batches warm-start each other's DP: only suffix rows whose
        atomic groups changed are re-solved. Plans are bit-equal to
        the cold solve; `ExecutionPlan.replan_mode` reports which path
        ran."""
        self.cm = cost_model
        self.n_ranks = n_ranks
        self.budget = mem_budget
        self.use_all_ranks = use_all_ranks
        self.balance_packing = balance_packing
        self.serial_fallback = serial_fallback
        self.incremental = incremental and allocator is None
        self._wave_solvers: Dict[int, IncrementalAllocator] = {}
        self.allocator = allocator if allocator is not None else allocate
        self.planner = MicroBatchPlanner(cost_model, n_ranks, mem_budget)
        import inspect
        self._alloc_kwargs = (
            {"use_all_ranks": use_all_ranks}
            if "use_all_ranks" in inspect.signature(
                self.allocator).parameters else {})
        # scheduler-level async surface (the Strategy carries its own
        # lookahead thread); created lazily on first prepare() so the
        # schedule()-only path allocates no thread pool.
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pending: Optional[concurrent.futures.Future] = None

    # -- synchronous API ----------------------------------------------------
    def schedule(self, seqs: Seq[SeqInfo]) -> ExecutionPlan:
        tr = get_tracer()
        t0 = time.perf_counter()
        micro_plans: List[MicroBatchPlan] = []
        solver_ms = 0.0
        micro_batches = self.planner.plan(seqs)
        t_micro = time.perf_counter()
        if tr.enabled:
            tr.complete("microbatch", t0, t_micro - t0, "sched",
                        args={"seqs": len(seqs),
                              "micro_batches": len(micro_batches)})
        stage_ms = {"microbatch": (t_micro - t0) * 1e3,
                    "pack": 0.0, "allocate": 0.0,
                    # the allocate split: cost-table build (time_fn
                    # evaluation) vs the DP itself (+ backtrack)
                    "allocate_cost": 0.0, "allocate_dp": 0.0}
        wave_idx = 0
        rows_reused = 0
        for mb in micro_batches:
            t_pack = time.perf_counter()
            all_groups = pack_sequences(
                mb, self.cm, self.budget, max_degree=self.n_ranks,
                balance_over=self.n_ranks if self.balance_packing
                else None)
            t_packed = time.perf_counter()
            stage_ms["pack"] += (t_packed - t_pack) * 1e3
            if tr.enabled:
                tr.complete("pack", t_pack, t_packed - t_pack, "sched",
                            args={"seqs": len(mb),
                                  "groups": len(all_groups)})
            # BFD fragmentation can leave sum(d_min) > N for one wave;
            # partition atomic groups into sequential feasible waves.
            for groups in _feasible_waves(all_groups, self.n_ranks):
                t_alloc = time.perf_counter()
                if self.incremental:
                    solver = self._wave_solvers.setdefault(
                        wave_idx, IncrementalAllocator())
                    alloc: Allocation = solver(
                        groups, self.n_ranks, self.cm.group_time,
                        use_all_ranks=self.use_all_ranks)
                else:
                    alloc = self.allocator(
                        groups, self.n_ranks, self.cm.group_time,
                        **self._alloc_kwargs)
                wave_idx += 1
                rows_reused += alloc.rows_reused
                stage_ms["allocate"] += (
                    time.perf_counter() - t_alloc) * 1e3
                stage_ms["allocate_cost"] += alloc.cost_ms
                stage_ms["allocate_dp"] += alloc.dp_ms
                solver_ms += alloc.solver_ms
                if tr.enabled:
                    # the allocate split, laid out consecutively from
                    # t_alloc using the allocator's own sub-timers
                    tr.complete("allocate_cost", t_alloc,
                                alloc.cost_ms / 1e3, "sched",
                                args={"wave": wave_idx - 1,
                                      "groups": len(groups)})
                    tr.complete("allocate_dp",
                                t_alloc + alloc.cost_ms / 1e3,
                                alloc.dp_ms / 1e3, "sched",
                                args={"wave": wave_idx - 1,
                                      "mode": alloc.mode,
                                      "rows_reused": alloc.rows_reused,
                                      "makespan_s": alloc.makespan})
                # BEYOND-PAPER: serial fallback. The DP runs the wave's
                # groups CONCURRENTLY on disjoint rank sets (Eq. 2-6);
                # when per-group imbalance exceeds the ring-comm cost of
                # width-N groups, running them back-to-back at full
                # degree is faster (dominates at small N). Take the min.
                serial = [self.cm.group_time(g.seqs, self.n_ranks)
                          for g in groups]
                if self.serial_fallback and sum(serial) < alloc.makespan:
                    for g, t in zip(groups, serial):
                        micro_plans.append(MicroBatchPlan(
                            groups=[GroupPlan(
                                seq_ids=[s.seq_id for s in g.seqs],
                                degree=self.n_ranks, est_time=t,
                                tokens=g.total_tokens)],
                            makespan=t, ranks_used=self.n_ranks))
                    continue
                gplans = [
                    GroupPlan(
                        seq_ids=[s.seq_id for s in g.seqs],
                        degree=d,
                        est_time=self.cm.group_time(g.seqs, d),
                        tokens=g.total_tokens,
                    )
                    for g, d in zip(groups, alloc.degrees)
                ]
                micro_plans.append(MicroBatchPlan(
                    groups=gplans, makespan=alloc.makespan,
                    ranks_used=alloc.ranks_used))
        schedule_ms = (time.perf_counter() - t0) * 1e3
        return ExecutionPlan(
            micro_batches=micro_plans,
            total_time_est=sum(m.makespan for m in micro_plans),
            schedule_ms=schedule_ms,
            solver_ms=solver_ms,
            strategy_name="dhp",
            stage_ms=stage_ms,
            replan_mode="incremental" if rows_reused else "full",
        )

    # -- asynchronous producer-consumer API ----------------------------------
    def prepare(self, next_seqs: Seq[SeqInfo]) -> None:
        """Kick off scheduling of the NEXT batch on the host thread."""
        if self._pool is None:
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1)
        self._pending = self._pool.submit(self.schedule, list(next_seqs))

    def collect(self) -> ExecutionPlan:
        """Block until the prepared plan is ready (usually already done)."""
        if self._pending is None:
            raise RuntimeError("collect() without a prior prepare()")
        plan = self._pending.result()
        self._pending = None
        return plan

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None


def static_plan(
    seqs: Seq[SeqInfo],
    cost_model: CostModel,
    n_ranks: int,
    mem_budget: float,
    *,
    degree: Optional[int] = None,
    power_of_two: bool = False,
) -> ExecutionPlan:
    """Static-parallelism baseline (Megatron-LM / DeepSpeed style).

    One fixed CP degree for every group, sized for the LONGEST sequence
    in the batch (how a practitioner must configure a static system).
    `power_of_two=True` additionally rounds the degree up to a power of
    two (DeepSpeed-Ulysses head-divisibility restriction, §4.1).

    The cluster forms floor(N/d) concurrent DP x CP groups; sequences are
    dealt round-robin in arrival order (static systems are not
    load-aware — this IS the pathology of Fig. 2). Each group chunks its
    share into memory-feasible micro-batches processed sequentially; the
    iteration time is the max over groups (synchronous gradient update).

    The plan emits one MicroBatchPlan per *wave* (chunk j of every
    lane), so each wave satisfies Eq. 6 (sum of degrees <= N) and the
    executor's host sync between micro-batches gives the sequential
    chunks their sequential semantics — per-rank memory stays within
    budget. `total_time_est` is still max-over-lanes of the lane total
    (DP lanes run independently; they do not barrier per chunk).

    Stage attribution mirrors the DHP pipeline's keys so benchmarks
    read baseline plan cost through the same code path: degree sizing
    is "allocate", dealing sequences into lanes is "pack", chunking
    lanes into memory-feasible waves is "microbatch".
    """
    t0 = time.perf_counter()
    cm = cost_model
    if degree is None:
        degree = max(cm.min_degree([s], mem_budget) for s in seqs)
    if power_of_two:
        d = 1
        while d < degree:
            d *= 2
        degree = d
    degree = min(degree, n_ranks)
    cap = (mem_budget - cm.coeffs.m_ms) * degree
    n_groups = max(1, n_ranks // degree)
    t_alloc = time.perf_counter()

    shares: List[List[SeqInfo]] = [[] for _ in range(n_groups)]
    for i, s in enumerate(seqs):
        shares[i % n_groups].append(s)
    t_pack = time.perf_counter()

    def group_total(share: List[SeqInfo]) -> tuple[float, List[GroupPlan]]:
        """Sequentially process micro-batches that fit d*E_act memory."""
        total, plans = 0.0, []
        cur: List[SeqInfo] = []
        used = 0.0
        for s in share:
            need = s.length * cm.coeffs.m_token
            if cur and used + need > cap:
                t = cm.group_time(cur, degree)
                plans.append(GroupPlan([x.seq_id for x in cur], degree, t,
                                       sum(x.length for x in cur)))
                total += t
                cur, used = [], 0.0
            cur.append(s)
            used += need
        if cur:
            t = cm.group_time(cur, degree)
            plans.append(GroupPlan([x.seq_id for x in cur], degree, t,
                                   sum(x.length for x in cur)))
            total += t
        return total, plans

    lane_plans: List[List[GroupPlan]] = []
    lane_times = []
    for share in shares:
        t, plans = group_total(share)
        lane_times.append(t)
        lane_plans.append(plans)
    total = max(lane_times)
    micro = []
    for wave in range(max(len(p) for p in lane_plans)):
        groups = [p[wave] for p in lane_plans if wave < len(p)]
        micro.append(MicroBatchPlan(
            groups=groups,
            makespan=max(g.est_time for g in groups),
            ranks_used=len(groups) * degree))
    t_micro = time.perf_counter()
    ms = (t_micro - t0) * 1e3
    return ExecutionPlan(
        micro_batches=micro, total_time_est=total,
        schedule_ms=ms, solver_ms=0.0, strategy_name="static",
        stage_ms={"microbatch": (t_micro - t_pack) * 1e3,
                  "pack": (t_pack - t_alloc) * 1e3,
                  "allocate": (t_alloc - t0) * 1e3})
