"""Stage 2 — Optimal Resource Assignment via 2D Dynamic Programming (Alg. 1).

DP[i][j] = minimum achievable makespan for the first i atomic groups using
a total of exactly j ranks:

    DP[i][j] = min_{d in [d_min_i, j - d']} max(DP[i-1][j-d], T(G_i, d))

with d' = sum_{m<i} d_min_m reserving feasibility for the prefix.
Backtracking from the best final state recovers the CP degrees {d_p}.

Complexity O(K' * N^2) — the paper reports <= 86 ms at K'~512, N=64.

The solver is NumPy-vectorized. The key index identity: row k of
the DP only has finite states at j in [pre[k-1], N - (pre[-1]-pre[k-1])],
a window of n = N - pre[-1] + 1 states for EVERY row, and the feasible
degrees for group k span [d_min_k, d_min_k + n - 1] — the candidate
matrix M[a][b] = max(DP[k-1][j_b - d_a], T(G_k, d_a)) is square. We
materialize it as a reversed sliding-window (Hankel) view over the
previous DP row padded with +inf (b < a ⇒ +inf), take the columnwise
min for the new row and the columnwise argmin for the backtrack path.
`np.argmin`'s first-occurrence rule reproduces the pure-Python triple
loop's smallest-degree tie-break exactly, so degrees and makespan are
bit-equal to that solver (kept in the JAX package as
`allocate_reference`, the certification oracle).

The cost table T(G_i, d) is built in bulk: when `time_fn` is a bound
`CostModel.group_time`, each group row is one `group_time_vector` call
(per-group aggregates reduced once, Eq. 10 evaluated elementwise over
the whole degree range — bit-identical to the scalar path).

`IncrementalAllocator` adds cross-batch warm starts: consecutive
batches with near-identical bucketed histograms share a prefix of
(group-signature) rows, and only the DP/cost suffix from the first
changed row is re-solved.

Alg. 1 as printed backtracks from DP[K'][N], i.e. uses all N ranks
(falling back to the largest feasible j when DP[K'][N] is infinite);
that is the JAX package's default and the only mode here.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, List, Optional, Sequence as Seq, Tuple

import numpy as np

from .packing import AtomicGroup

INF = float("inf")

# T(G_i, d): estimated execution time of atomic group i at CP degree d.
TimeFn = Callable[[Seq, int], float]


@dataclasses.dataclass
class Allocation:
    degrees: List[int]          # d_p per atomic group (same order as input)
    makespan: float             # max_p T(G_p, d_p)
    ranks_used: int
    solver_ms: float            # cost_ms + dp_ms (total host time)
    cost_ms: float = 0.0        # cost-table build (the time_fn calls)
    dp_ms: float = 0.0          # DP rows + backtrack
    mode: str = "full"          # "full" | "incremental"
    rows_reused: int = 0        # warm-started prefix rows (incremental)


def _group_sig(g: AtomicGroup) -> tuple:
    """Content signature of one atomic group — two groups with equal
    signatures have identical cost rows and identical DP transitions."""
    return (g.d_min, tuple((s.length, s.eta) for s in g.seqs))


def _vector_time_fn(time_fn: TimeFn):
    """Return the (seqs, degrees[]) -> times[] companion of `time_fn`
    when one exists: a bound `group_time` whose owner also exposes
    `group_time_vector` (CostModel and subclasses). Arbitrary callables
    (test lambdas, measured closures) fall back to per-degree calls."""
    owner = getattr(time_fn, "__self__", None)
    if owner is None:
        return None
    if getattr(time_fn, "__func__", None) is not getattr(
            type(owner), "group_time", None):
        return None
    return getattr(owner, "group_time_vector", None)


def _prefix_check(d_min: List[int], pre: List[int], n_ranks: int) -> None:
    if pre[-1] > n_ranks:
        raise ValueError(
            f"infeasible: sum of minimum degrees {pre[-1]} > ranks {n_ranks}")


def _fill_cost_rows(
    cost: np.ndarray,
    groups: Seq[AtomicGroup],
    n_ranks: int,
    d_min: List[int],
    pre: List[int],
    time_fn: TimeFn,
    *,
    start: int = 0,
) -> None:
    """Build cost rows [start, K'): cost[i][d] = T(G_i, d) over the
    feasible degree range."""
    vec = _vector_time_fn(time_fn)
    for i in range(start, len(groups)):
        hi = n_ranks - (pre[-1] - pre[i])
        if hi < d_min[i]:
            continue
        if vec is not None:
            cost[i, d_min[i]:hi + 1] = vec(
                groups[i].seqs, np.arange(d_min[i], hi + 1))
        else:
            cost[i, d_min[i]:hi + 1] = [
                time_fn(groups[i].seqs, d) for d in range(d_min[i], hi + 1)]


def _dp_rows(
    dp: np.ndarray,
    path: np.ndarray,
    cost: np.ndarray,
    d_min: List[int],
    pre: List[int],
    n_ranks: int,
    *,
    start: int = 1,
) -> None:
    """Fill DP rows [start, K'] (row k consumes cost row k-1).

    Each row is one square min-max: with n = N - pre[-1] + 1,
    M[a][b] = max(dp[k-1][prev_base + b - a], cost[k-1][d_lo + a]) for
    b >= a (else +inf); dp row = M.min(axis=0), path = argmin + d_lo.
    """
    kp = cost.shape[0]
    n = n_ranks - pre[-1] + 1
    win = np.lib.stride_tricks.sliding_window_view
    pad = np.full(n - 1, INF)
    for k in range(start, kp + 1):
        lo = pre[k - 1]
        prev_base = pre[k - 2] if k >= 2 else 0
        dlo = d_min[k - 1]
        v = dp[k - 1, prev_base:prev_base + n]
        ck = cost[k - 1, dlo:dlo + n]
        # Reversed Hankel view: G[a][b] = v[b-a] for b >= a else +inf.
        g = win(np.concatenate((pad, v)), n)[::-1]
        m = np.maximum(g, ck[:, None])
        dp[k, lo:lo + n] = m.min(axis=0)
        path[k, lo:lo + n] = m.argmin(axis=0) + dlo


def _backtrack(
    dp: np.ndarray,
    path: np.ndarray,
    kp: int,
    n_ranks: int,
) -> Tuple[List[int], int]:
    j_best = n_ranks
    if not dp[kp, j_best] < INF:  # hi_j < N for the last row
        finite = np.nonzero(dp[kp] < INF)[0]
        if finite.size == 0:
            raise ValueError("no feasible allocation")
        j_best = int(finite[-1])
    degrees = [0] * kp
    p, q = kp, j_best
    while p > 0:
        d = int(path[p, q])
        degrees[p - 1] = d
        p, q = p - 1, q - d
    return degrees, j_best


def _solve(
    groups: Seq[AtomicGroup],
    n_ranks: int,
    time_fn: TimeFn,
    *,
    sigs: Optional[List[tuple]] = None,
    warm: Optional["SolverState"] = None,
) -> Tuple[Allocation, "SolverState"]:
    kp = len(groups)
    d_min = [g.d_min for g in groups]
    pre = list(itertools.accumulate(d_min))
    _prefix_check(d_min, pre, n_ranks)
    if sigs is None:
        sigs = [_group_sig(g) for g in groups]

    # Longest reusable prefix: rows of a warm state stay valid while the
    # rank budget, the TOTAL reserved minimum (pre[-1], which shapes every
    # row's feasible window) and the group-signature prefix all match.
    reuse = 0
    if (warm is not None and warm.n_ranks == n_ranks
            and warm.pre[-1] == pre[-1]):
        limit = min(kp, len(warm.sigs))
        while reuse < limit and sigs[reuse] == warm.sigs[reuse]:
            reuse += 1

    t0 = time.perf_counter()
    cost = np.full((kp, n_ranks + 1), INF)
    if reuse:
        cost[:reuse] = warm.cost[:reuse]
    _fill_cost_rows(cost, groups, n_ranks, d_min, pre, time_fn,
                    start=reuse)
    t1 = time.perf_counter()
    dp = np.full((kp + 1, n_ranks + 1), INF)
    path = np.zeros((kp + 1, n_ranks + 1), np.int64)
    dp[0, 0] = 0.0
    if reuse:
        dp[1:reuse + 1] = warm.dp[1:reuse + 1]
        path[1:reuse + 1] = warm.path[1:reuse + 1]
    _dp_rows(dp, path, cost, d_min, pre, n_ranks, start=reuse + 1)
    degrees, j_best = _backtrack(dp, path, kp, n_ranks)
    t2 = time.perf_counter()

    cost_ms = (t1 - t0) * 1e3
    dp_ms = (t2 - t1) * 1e3
    alloc = Allocation(
        degrees=degrees, makespan=float(dp[kp, j_best]),
        ranks_used=sum(degrees), solver_ms=cost_ms + dp_ms,
        cost_ms=cost_ms, dp_ms=dp_ms,
        mode="incremental" if reuse else "full", rows_reused=reuse)
    state = SolverState(n_ranks=n_ranks, sigs=tuple(sigs), d_min=d_min,
                        pre=pre, cost=cost, dp=dp, path=path)
    return alloc, state


@dataclasses.dataclass
class SolverState:
    """Everything needed to warm-start the next solve: per-group content
    signatures plus the cost table and DP/path rows they produced."""

    n_ranks: int
    sigs: Tuple[tuple, ...]
    d_min: List[int]
    pre: List[int]
    cost: np.ndarray            # [K', N+1]
    dp: np.ndarray              # [K'+1, N+1]
    path: np.ndarray            # [K'+1, N+1]


class IncrementalAllocator:
    """Stage-2 solver with cross-batch warm starts (incremental replanning).

    Keeps the last `capacity` solved instances; each call picks the
    stored state sharing the longest group-signature prefix with the new
    instance (the "nearest" previous plan) and re-solves only the cost /
    DP suffix from the first changed row. A large histogram diff means a
    short (possibly empty) shared prefix, which degrades gracefully to
    the full vectorized solve — `Allocation.mode` / `rows_reused` report
    which path ran.

    States are keyed to the cost model identity AND its `cost_version`
    (MeasuredCostModel bumps the version on every record()), so warm
    rows are never reused across cost-model updates. Plans are bit-equal
    to the cold solve by construction: reused rows are the rows the cold
    solve would have recomputed from identical inputs.
    """

    def __init__(self, capacity: int = 4):
        self.capacity = capacity
        self._states: List[Tuple[object, int, SolverState]] = []

    def _token(self, time_fn: TimeFn) -> Tuple[object, int]:
        owner = getattr(time_fn, "__self__", time_fn)
        return owner, getattr(owner, "cost_version", 0)

    def __call__(
        self,
        groups: Seq[AtomicGroup],
        n_ranks: int,
        time_fn: TimeFn,
    ) -> Allocation:
        if len(groups) == 0:
            return Allocation([], 0.0, 0, 0.0)
        owner, version = self._token(time_fn)
        sigs = [_group_sig(g) for g in groups]
        total = sum(g.d_min for g in groups)

        best_i, best_len = -1, 0
        for i, (o, ver, st) in enumerate(self._states):
            if o is not owner or ver != version or st.n_ranks != n_ranks:
                continue
            if st.pre[-1] != total:
                continue
            p, limit = 0, min(len(sigs), len(st.sigs))
            while p < limit and sigs[p] == st.sigs[p]:
                p += 1
            if p > best_len:
                best_i, best_len = i, p
        warm = self._states[best_i][2] if best_i >= 0 else None

        alloc, state = _solve(groups, n_ranks, time_fn, sigs=sigs,
                              warm=warm)
        if best_i >= 0 and self._states[best_i][2].sigs == state.sigs:
            self._states.pop(best_i)       # identical instance: replace
        self._states.append((owner, version, state))
        if len(self._states) > self.capacity:
            del self._states[:len(self._states) - self.capacity]
        return alloc
