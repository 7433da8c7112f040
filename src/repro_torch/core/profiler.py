"""Profiler: fits the cost-model coefficients (§5 Implementation (3)).

Before training, the paper's Profiler runs forward/backward passes over a
grid of (sequence length, CP degree) and fits the functional relationship
T(s, d). The same here:

  * `collect(measure_fn, lengths, degrees)` gathers samples by calling a
    measurement function the caller supplies (a timed training group on
    the card, or any cost model's own predictions).
  * `fit()` solves the least-squares system for (a1, a2, b1) on the
    compute samples and a3 on the comm samples.
  * `predict(length, d)` then evaluates Eq. (10), and `error(samples)`
    reports the mean absolute percentage error (the paper's Table 3).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence as Seq, Tuple

import numpy as np

from .cost_model import CostCoeffs, CostModel, Hardware, SeqInfo


@dataclasses.dataclass
class Sample:
    length: int
    degree: int
    eta: float
    time_s: float


MeasureFn = Callable[[int, int, float], float]   # (length, degree, eta) -> s


class Profiler:
    """Fits CostCoeffs from timed samples; serves predictions to the DP."""

    def __init__(self, hw: Hardware | None = None,
                 m_token: float = 1.0, m_ms: float = 0.0):
        self.hw = hw or Hardware()
        self.m_token = m_token
        self.m_ms = m_ms
        self.samples: List[Sample] = []
        self.coeffs: CostCoeffs | None = None

    # ------------------------------------------------------------------
    def collect(self, measure_fn: MeasureFn,
                lengths: Seq[int], degrees: Seq[int],
                etas: Seq[float] = (0.0,)) -> None:
        for L in lengths:
            for d in degrees:
                for eta in etas:
                    self.samples.append(
                        Sample(L, d, eta, measure_fn(L, d, eta)))

    def add_sample(self, length: int, degree: int, eta: float,
                   time_s: float) -> None:
        self.samples.append(Sample(length, degree, eta, time_s))

    # ------------------------------------------------------------------
    def fit(self) -> CostCoeffs:
        """Least squares on  T ~ a1*(1+eta)L^2/d + a2*L/d + b1
                               + [a3*L*(d-1)/(d*v) + b2]_{d>1}
        with the ring-overlap min() term linearized by assuming compute
        dominates (true for the profiling grid: long sequences).
        """
        if not self.samples:
            raise RuntimeError("no samples collected")
        rows, y = [], []
        for s in self.samples:
            v = self.hw.ring_bandwidth(s.degree)
            comm = (s.length * (s.degree - 1) / s.degree / v
                    if s.degree > 1 else 0.0)
            rows.append([
                (1 + s.eta) * s.length ** 2 / s.degree,   # a1
                s.length / s.degree,                       # a2
                1.0,                                       # b1 (+b2 folded)
                comm,                                      # a3
            ])
            y.append(s.time_s)
        A = np.asarray(rows)
        try:
            from scipy.optimize import nnls
            coef, _ = nnls(A, np.asarray(y))
        except ImportError:     # pragma: no cover
            coef, *_ = np.linalg.lstsq(A, np.asarray(y), rcond=None)
        a1, a2, b1, a3 = [max(float(c), 0.0) for c in coef]
        self.coeffs = CostCoeffs(a1=a1, a2=a2, b1=b1, a3=a3, b2=0.0,
                                 m_token=self.m_token, m_ms=self.m_ms)
        return self.coeffs

    # ------------------------------------------------------------------
    def cost_model(self) -> CostModel:
        if self.coeffs is None:
            self.fit()
        return CostModel(self.coeffs, self.hw)

    def predict(self, length: int, degree: int, eta: float = 0.0) -> float:
        cm = self.cost_model()
        # overlap credit applies only where comm exists
        return cm.group_time([SeqInfo(length=length, eta=eta)], degree)

    def error(self, holdout: Seq[Sample] | None = None) -> float:
        """Mean absolute percentage error of the fit (Table 3)."""
        data = list(holdout) if holdout is not None else self.samples
        errs = []
        for s in data:
            pred = self.predict(s.length, s.degree, s.eta)
            if s.time_s > 0:
                errs.append(abs(pred - s.time_s) / s.time_s)
        return 100.0 * float(np.mean(errs))


def profiling_grid(max_len: int) -> Tuple[List[int], List[int]]:
    """The (length, degree) grid the paper's profile function sweeps."""
    lengths, L = [], 512
    while L <= max_len:
        lengths.append(L)
        L *= 2
    return lengths, [1, 2, 3, 4, 6, 8]
