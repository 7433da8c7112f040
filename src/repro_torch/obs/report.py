"""Post-run analytics — imbalance, stragglers, cost-model error.

The raw material is the per-group timing record the executor already
produces in measuring mode ({seq_ids, degree, seconds, compiled, ...}),
joined with the plan's rank-slot geometry (`ExecutionPlan.group_slots`)
and predicted group times (`GroupPlan.est_time`). `RunRecorder` captures
that join per executed step; `build_report` turns the records into the
three analyses the paper's evaluation revolves around:

  * per-wave load imbalance — max/mean measured group time within each
    wave (micro-batch), the Fig. 2 metric DHP exists to drive to 1.0;
  * per-rank straggler score — the mean of (group time / wave mean) over
    the waves a rank participates in; a healthy rank sits near 1.0, a
    straggler consistently above (the signal an elastic runtime needs
    for exclusion decisions);
  * cost-model error — MAPE between predicted and measured group times.
    The analytic CostModel predicts *modelled device* seconds while the
    engine measures *host wall* seconds, so predictions are first scaled
    by the least-squares factor fit over the whole run (`scale`); MAPE
    of the scaled predictions is scale-free and measures exactly what
    the planner relies on — RELATIVE cost fidelity. This residual stream
    is the input signal for Entrain-style online recalibration.

Compile-tainted measurements (a group's first execution builds its step
and kernels, often 100x the step) are excluded the same way
OracleStrategy excludes them: waves containing any compiled group are
dropped from imbalance/straggler statistics and compiled groups from the
MAPE sample — unless that would leave nothing, in which case everything
is used and the report says so (`clean=False` waves).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence as Seq, Tuple

REPORT_VERSION = 1


@dataclasses.dataclass
class GroupRecord:
    """One executed group: where it ran, what the planner predicted,
    what the clock measured."""

    step: int
    wave: int            # micro-batch index within the step's plan
    group: int           # group index within the wave
    start_rank: int
    degree: int
    tokens: int
    predicted_s: float
    measured_s: float
    compiled: bool = False

    @property
    def ranks(self) -> range:
        return range(self.start_rank, self.start_rank + self.degree)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: dict) -> "GroupRecord":
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in obj.items() if k in names})


class RunRecorder:
    """Collects GroupRecords across a run.

    `Engine.train(trace=... / report=...)` installs one and feeds it
    from `execute()`; tests can also append synthetic records directly
    via `add()`."""

    def __init__(self, n_ranks: int):
        self.n_ranks = n_ranks
        self.records: List[GroupRecord] = []

    def add(self, record: GroupRecord) -> None:
        self.records.append(record)

    def record_step(self, step: int, plan, timings: Seq[dict]) -> None:
        """Join one executed plan with its measured per-group timings
        (executor dispatch order == plan group order == group_slots
        order)."""
        groups = [g for mb in plan.micro_batches for g in mb.groups]
        slots = plan.group_slots(self.n_ranks)
        for (mi, gi, start, degree), g, t in zip(slots, groups, timings):
            self.records.append(GroupRecord(
                step=step, wave=mi, group=gi, start_rank=start,
                degree=degree, tokens=g.tokens,
                predicted_s=float(g.est_time),
                measured_s=float(t["seconds"]),
                compiled=bool(t.get("compiled", False))))

    def __len__(self) -> int:
        return len(self.records)


# -- core statistics ----------------------------------------------------------
def scale_fit(pred: Seq[float], meas: Seq[float]) -> float:
    """Least-squares scale alpha minimizing sum((alpha*p - m)^2) — the
    modelled-seconds -> wall-seconds calibration factor."""
    num = sum(p * m for p, m in zip(pred, meas))
    den = sum(p * p for p in pred)
    return num / den if den > 0 else 0.0


def scale_fit_mape(pred: Seq[float], meas: Seq[float],
                   scale: Optional[float] = None
                   ) -> Tuple[float, float, int]:
    """(mape_pct, scale, n_samples) of scaled predictions vs
    measurements. Pairs with measured_s <= 0 are skipped; pass `scale`
    to reuse a fit from a larger sample (per-wave MAPE under the global
    calibration)."""
    pairs = [(p, m) for p, m in zip(pred, meas) if m > 0]
    if not pairs:
        return 0.0, 0.0, 0
    if scale is None:
        scale = scale_fit([p for p, _ in pairs], [m for _, m in pairs])
    errs = [abs(scale * p - m) / m for p, m in pairs]
    return 100.0 * sum(errs) / len(errs), scale, len(errs)


def step_model_error(plan, timings: Seq[dict]) -> float:
    """One step's cost-model MAPE (the StepMetrics.model_error_pct
    feed): scaled-prediction error over the step's non-compile-tainted
    groups; 0.0 when every group compiled (nothing clean to score)."""
    groups = [g for mb in plan.micro_batches for g in mb.groups]
    pred = [g.est_time for g, t in zip(groups, timings)
            if not t.get("compiled", False)]
    meas = [float(t["seconds"]) for t in timings
            if not t.get("compiled", False)]
    mape, _, n = scale_fit_mape(pred, meas)
    return mape if n else 0.0


def _waves(records: Seq[GroupRecord]) -> "Dict[Tuple[int, int], List[GroupRecord]]":
    by_wave: Dict[Tuple[int, int], List[GroupRecord]] = {}
    for r in records:
        by_wave.setdefault((r.step, r.wave), []).append(r)
    return by_wave


def wave_stats(records: Seq[GroupRecord]) -> List[dict]:
    """Per-wave load statistics, one dict per (step, wave):
    makespan (max measured group time), mean, and imbalance = max/mean —
    the paper's Fig. 2 metric. `clean` marks waves free of
    compile-tainted groups."""
    out = []
    for (step, wave), recs in sorted(_waves(records).items()):
        times = [r.measured_s for r in recs]
        mean = sum(times) / len(times)
        mx = max(times)
        out.append({
            "step": step, "wave": wave, "n_groups": len(recs),
            "makespan_s": mx, "mean_s": mean,
            "imbalance": mx / mean if mean > 0 else 1.0,
            "clean": not any(r.compiled for r in recs),
        })
    return out


def straggler_scores(records: Seq[GroupRecord], n_ranks: int
                     ) -> Dict[int, dict]:
    """Per-rank straggler score: mean over waves of (the rank's group
    time / the wave's mean group time). 1.0 = perfectly average; the
    injected-slow-rank test expects its ranks to score highest. Only
    clean (compile-free) waves count when any exist. Ranks that never
    participated report score 0.0 with waves=0."""
    by_wave = _waves(records)
    clean = {k: v for k, v in by_wave.items()
             if not any(r.compiled for r in v)}
    used = clean or by_wave
    ratios: Dict[int, List[float]] = {r: [] for r in range(n_ranks)}
    for recs in used.values():
        mean = sum(r.measured_s for r in recs) / len(recs)
        if mean <= 0:
            continue
        for rec in recs:
            for rank in rec.ranks:
                if 0 <= rank < n_ranks:
                    ratios[rank].append(rec.measured_s / mean)
    return {rank: {"score": (sum(v) / len(v)) if v else 0.0,
                   "waves": len(v)}
            for rank, v in ratios.items()}


# -- the report ---------------------------------------------------------------
@dataclasses.dataclass
class RunReport:
    """The post-run analytics document: JSON via to_json()/save(),
    humans via summary()."""

    n_ranks: int
    n_steps: int
    waves: List[dict]
    imbalance: Dict[str, float]
    stragglers: Dict[str, Any]
    model_error: Dict[str, Any]
    steps: List[dict] = dataclasses.field(default_factory=list)
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "version": REPORT_VERSION,
            "n_ranks": self.n_ranks,
            "n_steps": self.n_steps,
            "waves": self.waves,
            "imbalance": self.imbalance,
            "stragglers": {
                **self.stragglers,
                "scores": {str(r): s for r, s in
                           self.stragglers.get("scores", {}).items()},
            },
            "model_error": self.model_error,
            "steps": self.steps,
            "metrics": self.metrics,
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    def summary(self) -> str:
        imb = self.imbalance
        me = self.model_error
        st = self.stragglers
        worst = st.get("worst_rank")
        worst_score = (st["scores"][worst]["score"]
                       if worst is not None and worst in st.get(
                           "scores", {}) else 0.0)
        lines = [
            f"run report: {self.n_steps} steps, {len(self.waves)} waves,"
            f" {self.n_ranks} ranks",
            f"  imbalance (max/mean group time per wave): "
            f"mean={imb.get('mean', 0.0):.3f} "
            f"max={imb.get('max', 0.0):.3f} "
            f"over {imb.get('n_waves', 0)} waves"
            + ("" if imb.get("clean", True) else
               " [compile-tainted: no clean wave available]"),
            f"  stragglers: worst rank={worst} "
            f"score={worst_score:.3f} "
            f"flagged(>{st.get('threshold', 0.0):.2f})="
            f"{st.get('flagged', [])}",
            f"  cost model: MAPE={me.get('mape_pct', 0.0):.1f}% over "
            f"{me.get('n_samples', 0)} groups "
            f"(wall/predicted scale={me.get('scale', 0.0):.3g})",
        ]
        return "\n".join(lines)


def build_report(recorder: RunRecorder,
                 history: Optional[Seq[Any]] = None,
                 metrics: Optional[Dict[str, Any]] = None,
                 straggler_threshold: float = 1.2) -> RunReport:
    """Records (+ optional StepMetrics history and a MetricsRegistry
    snapshot) -> RunReport."""
    records = recorder.records
    waves = wave_stats(records)
    clean_waves = [w for w in waves if w["clean"]] or waves
    imbalances = [w["imbalance"] for w in clean_waves]
    imbalance = {
        "mean": (sum(imbalances) / len(imbalances)) if imbalances else 0.0,
        "max": max(imbalances) if imbalances else 0.0,
        "n_waves": len(imbalances),
        "clean": bool(clean_waves) and all(w["clean"]
                                           for w in clean_waves),
    }

    scores = straggler_scores(records, recorder.n_ranks)
    active = {r: s for r, s in scores.items() if s["waves"] > 0}
    worst = (max(active, key=lambda r: active[r]["score"])
             if active else None)
    stragglers: Dict[str, Any] = {
        "scores": scores,
        "worst_rank": worst,
        "threshold": straggler_threshold,
        "flagged": sorted(r for r, s in active.items()
                          if s["score"] > straggler_threshold),
    }

    clean_recs = [r for r in records if not r.compiled] or list(records)
    mape, scale, n = scale_fit_mape(
        [r.predicted_s for r in clean_recs],
        [r.measured_s for r in clean_recs])
    per_wave = []
    for (step, wave), recs in sorted(_waves(clean_recs).items()):
        w_mape, _, w_n = scale_fit_mape(
            [r.predicted_s for r in recs],
            [r.measured_s for r in recs], scale=scale)
        if w_n:
            per_wave.append({"step": step, "wave": wave,
                             "mape_pct": w_mape})
    model_error = {"mape_pct": mape, "scale": scale, "n_samples": n,
                   "per_wave": per_wave}

    steps = [m.to_json() for m in history] if history else []
    return RunReport(
        n_ranks=recorder.n_ranks,
        n_steps=len({r.step for r in records}),
        waves=waves,
        imbalance=imbalance,
        stragglers=stragglers,
        model_error=model_error,
        steps=steps,
        metrics=dict(metrics or {}),
    )
