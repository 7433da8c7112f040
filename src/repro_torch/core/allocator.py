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
`np.argmin`'s first-occurrence rule reproduces the reference solver's
smallest-degree tie-break exactly, so degrees and makespan are
bit-equal to `allocate_reference` (the pure-Python triple loop, kept
as the certification oracle).

The cost table T(G_i, d) is built in bulk: when `time_fn` is a bound
`CostModel.group_time`, each group row is one `group_time_vector` call
(per-group aggregates reduced once, Eq. 10 evaluated elementwise over
the whole degree range — bit-identical to the scalar path).

`IncrementalAllocator` adds cross-batch warm starts: consecutive
batches with near-identical bucketed histograms share a prefix of
(group-signature) rows, and only the DP/cost suffix from the first
changed row is re-solved. `allocate_many` solves a lookahead window of
batches in one call with a shared cost-row memo.

Deviation from Alg. 1 as printed: the pseudocode backtracks from
DP[K'][N], i.e. forces sum d_p == N. Because T(G,d) is not monotone in d
(ring comm grows with d for short sequences), using *all* ranks can be
strictly worse than leaving some idle; constraint (6) is an inequality.
We therefore backtrack from argmin_j DP[K'][j]. With `use_all_ranks=True`
the exact printed behaviour is available (and is what the paper's
executor wants when idle ranks would otherwise sit in the DP group
anyway — we default to True but surface both).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Callable, Dict, List, Optional, Sequence as Seq, Tuple

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
    memo: Optional[Dict[tuple, np.ndarray]] = None,
    sigs: Optional[List[tuple]] = None,
) -> None:
    """Build cost rows [start, K'): cost[i][d] = T(G_i, d) over the
    feasible degree range. `memo` (keyed by group signature + range)
    shares rows across the instances of a lookahead window."""
    vec = _vector_time_fn(time_fn)
    for i in range(start, len(groups)):
        hi = n_ranks - (pre[-1] - pre[i])
        if hi < d_min[i]:
            continue
        key = None
        if memo is not None:
            key = (sigs[i] if sigs else _group_sig(groups[i]), d_min[i], hi)
            row = memo.get(key)
            if row is not None:
                cost[i, d_min[i]:hi + 1] = row
                continue
        if vec is not None:
            cost[i, d_min[i]:hi + 1] = vec(
                groups[i].seqs, np.arange(d_min[i], hi + 1))
        else:
            cost[i, d_min[i]:hi + 1] = [
                time_fn(groups[i].seqs, d) for d in range(d_min[i], hi + 1)]
        if memo is not None:
            memo[key] = cost[i, d_min[i]:hi + 1].copy()


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
    use_all_ranks: bool,
) -> Tuple[List[int], int]:
    if use_all_ranks:
        j_best = n_ranks
        if not dp[kp, j_best] < INF:  # hi_j < N for the last row
            finite = np.nonzero(dp[kp] < INF)[0]
            if finite.size == 0:
                raise ValueError("no feasible allocation")
            j_best = int(finite[-1])
    else:
        j_best = int(np.argmin(dp[kp]))  # first occurrence = smallest j
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
    use_all_ranks: bool,
    sigs: Optional[List[tuple]] = None,
    warm: Optional["SolverState"] = None,
    memo: Optional[Dict[tuple, np.ndarray]] = None,
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
                    start=reuse, memo=memo, sigs=sigs)
    t1 = time.perf_counter()
    dp = np.full((kp + 1, n_ranks + 1), INF)
    path = np.zeros((kp + 1, n_ranks + 1), np.int64)
    dp[0, 0] = 0.0
    if reuse:
        dp[1:reuse + 1] = warm.dp[1:reuse + 1]
        path[1:reuse + 1] = warm.path[1:reuse + 1]
    _dp_rows(dp, path, cost, d_min, pre, n_ranks, start=reuse + 1)
    degrees, j_best = _backtrack(dp, path, kp, n_ranks, use_all_ranks)
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


def allocate(
    groups: Seq[AtomicGroup],
    n_ranks: int,
    time_fn: TimeFn,
    *,
    use_all_ranks: bool = True,
) -> Allocation:
    """2D-DP resource allocation (paper Alg. 1), vectorized.

    Bit-equal degrees and makespan to the pure-Python solver
    `allocate_reference`, at a fraction of its host time.
    """
    if len(groups) == 0:
        return Allocation([], 0.0, 0, 0.0)
    alloc, _ = _solve(groups, n_ranks, time_fn, use_all_ranks=use_all_ranks)
    return alloc


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
        *,
        use_all_ranks: bool = True,
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

        alloc, state = _solve(groups, n_ranks, time_fn,
                              use_all_ranks=use_all_ranks,
                              sigs=sigs, warm=warm)
        if best_i >= 0 and self._states[best_i][2].sigs == state.sigs:
            self._states.pop(best_i)       # identical instance: replace
        self._states.append((owner, version, state))
        if len(self._states) > self.capacity:
            del self._states[:len(self._states) - self.capacity]
        return alloc


def allocate_many(
    batches: Seq[Seq[AtomicGroup]],
    n_ranks: int,
    time_fn: TimeFn,
    *,
    use_all_ranks: bool = True,
) -> List[Allocation]:
    """Solve a lookahead WINDOW of Stage-2 instances in one call.

    The batched-lookahead contract: cost rows are shared across the
    window through a signature memo (groups recurring at t+1..t+k price
    their degree range exactly once) and each instance additionally
    warm-starts from the nearest already-solved instance. Results are
    bit-equal to calling `allocate` per batch.
    """
    inc = IncrementalAllocator(capacity=max(4, len(batches)))
    memo: Dict[tuple, np.ndarray] = {}
    out: List[Allocation] = []
    for groups in batches:
        if len(groups) == 0:
            out.append(Allocation([], 0.0, 0, 0.0))
            continue
        owner, version = inc._token(time_fn)
        sigs = [_group_sig(g) for g in groups]
        total = sum(g.d_min for g in groups)
        warm = None
        best_len = 0
        for o, ver, st in inc._states:
            if (o is not owner or ver != version or st.n_ranks != n_ranks
                    or st.pre[-1] != total):
                continue
            p, limit = 0, min(len(sigs), len(st.sigs))
            while p < limit and sigs[p] == st.sigs[p]:
                p += 1
            if p > best_len:
                warm, best_len = st, p
        alloc, state = _solve(groups, n_ranks, time_fn,
                              use_all_ranks=use_all_ranks,
                              sigs=sigs, warm=warm, memo=memo)
        inc._states.append((owner, version, state))
        out.append(alloc)
    return out


def allocate_reference(
    groups: Seq[AtomicGroup],
    n_ranks: int,
    time_fn: TimeFn,
    *,
    use_all_ranks: bool = True,
) -> Allocation:
    """The original pure-Python 2D-DP solver, kept verbatim.

    The certification oracle the vectorized solver must match
    bit-for-bit, and a fixed host-time workload (its meaning must not
    drift when `allocate` gets faster).
    """
    t0 = time.perf_counter()
    kp = len(groups)
    if kp == 0:
        return Allocation([], 0.0, 0, 0.0)
    d_min = [g.d_min for g in groups]
    pre = list(itertools.accumulate(d_min))          # sum_{i<=k} d_min_i
    _prefix_check(d_min, pre, n_ranks)

    # Memoize T(G_i, d) — the DP probes each (i, d) many times.
    cost: List[List[float]] = []
    for i, g in enumerate(groups):
        row = [INF] * (n_ranks + 1)
        for d in range(d_min[i], n_ranks - (pre[-1] - pre[i]) + 1):
            row[d] = time_fn(g.seqs, d)
        cost.append(row)
    t1 = time.perf_counter()

    dp = [[INF] * (n_ranks + 1) for _ in range(kp + 1)]
    path = [[0] * (n_ranks + 1) for _ in range(kp + 1)]
    dp[0][0] = 0.0
    for k in range(1, kp + 1):
        r_remain = pre[-1] - pre[k - 1]              # ranks still owed to suffix
        lo_j = pre[k - 1]
        hi_j = n_ranks - r_remain
        prev_base = pre[k - 2] if k >= 2 else 0
        dpk, dpk1 = dp[k], dp[k - 1]
        ck, pk = cost[k - 1], path[k]
        for j in range(lo_j, hi_j + 1):
            best, best_d = INF, 0
            for d in range(d_min[k - 1], j - prev_base + 1):
                prev = dpk1[j - d]
                if prev >= best:
                    continue
                c = ck[d] if ck[d] > prev else prev  # max(prev, T(G,d))
                if c < best:
                    best, best_d = c, d
            dpk[j] = best
            pk[j] = best_d

    if use_all_ranks:
        j_best = n_ranks
        if dp[kp][j_best] == INF:   # can happen if hi_j < N for the last row
            j_best = max(j for j in range(n_ranks + 1) if dp[kp][j] < INF)
    else:
        j_best = min(range(n_ranks + 1), key=lambda j: (dp[kp][j], j))
    degrees = [0] * kp
    p, q = kp, j_best
    while p > 0:
        d = path[p][q]
        degrees[p - 1] = d
        p, q = p - 1, q - d
    t2 = time.perf_counter()
    return Allocation(degrees=degrees, makespan=dp[kp][j_best],
                      ranks_used=sum(degrees),
                      solver_ms=(t2 - t0) * 1e3,
                      cost_ms=(t1 - t0) * 1e3, dp_ms=(t2 - t1) * 1e3)


def evaluate_degrees(
    seq_groups: Seq[Seq],
    degrees: Seq[int],
    time_fn: TimeFn,
) -> Allocation:
    """Evaluate a FIXED degree vector — the no-search path.

    Used when the degrees are already known (a cached or replayed plan
    names them), by OracleStrategy.plan_cost to price any plan under
    measured costs, and by tests to certify the DP's reported makespan
    equals the evaluation of its own degree vector.
    """
    t0 = time.perf_counter()
    times = [time_fn(seqs, d) for seqs, d in zip(seq_groups, degrees)]
    ms = (time.perf_counter() - t0) * 1e3
    return Allocation(degrees=list(degrees),
                      makespan=max(times, default=0.0),
                      ranks_used=sum(degrees), solver_ms=ms,
                      cost_ms=ms, dp_ms=0.0)


def allocate_bruteforce(
    groups: Seq[AtomicGroup],
    n_ranks: int,
    time_fn: TimeFn,
) -> Allocation:
    """Exhaustive search over degree vectors — oracle for correctness tests.

    Only tractable for tiny instances (used by tests/property checks to
    certify the DP is exactly optimal for the separable makespan
    objective).
    """
    t0 = time.perf_counter()
    kp = len(groups)
    d_min = [g.d_min for g in groups]
    best: Tuple[float, List[int]] = (INF, [])

    def rec(i: int, left: int, cur_max: float, acc: List[int]):
        nonlocal best
        if cur_max >= best[0]:
            return
        if i == kp:
            best = (cur_max, list(acc))
            return
        reserve = sum(d_min[i + 1:])
        for d in range(d_min[i], left - reserve + 1):
            t = time_fn(groups[i].seqs, d)
            acc.append(d)
            rec(i + 1, left - d, max(cur_max, t), acc)
            acc.pop()

    rec(0, n_ranks, 0.0, [])
    ms = (time.perf_counter() - t0) * 1e3
    return Allocation(degrees=best[1], makespan=best[0],
                      ranks_used=sum(best[1]), solver_ms=ms)
