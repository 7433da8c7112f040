"""Ring context parallelism: the counterpart of the JAX package's
`parallel/ring_attention.py`, with its names.

A CP group of degree d holds a packed sequence as d contiguous shards of
S_loc tokens: rank r holds tokens [r S_loc, (r + 1) S_loc). The ring
works for any integer d, which is what DHP needs (§4.1).

`ring_attention` runs d hops. At hop h, rank r's queries meet the keys of
shard src = (r + h) % d through the packed kernel K1, given that shard's
segment and span tables and `kv_offset = (src - r) * S_loc`. K1's masks
compare key index `kv_offset + j` with query index i; in a contiguous
layout a segment's positions rise by one an index, so on every
same-segment pair this is the reference's position test. Between hops
K/V and their tables move one step along the ring, rank i receiving rank
i + 1's (JAX's `ppermute` i -> i - 1). The hops' outputs are merged in
fp32 by their LSEs. The backward runs d hops of K1's backward under the
merged o and LSE, which makes each hop's (dq, dk, dv) that key block's
share of the whole gradient: dq adds up where it is, dk and dv add up in
fp32 buffers that travel with their K/V and come home with one more
shift.

The ring's transport is the small interface `Ring`, in two forms:
  * `LocalRing(d)`: all d ranks in one process, as d equal blocks of rows
    of one tensor on one device (`[d * b, S_loc, ...]`, rank r's rows
    [r b, (r + 1) b)); a shift is `torch.roll` along the rows. This is
    the executor's single-controller form, one to one with the JAX
    executor's `shard_map` over `P(None, "cp")`. A hop is at most two K1
    launches: the rows whose source shard wrapped past d have another
    offset than the rows before them.
  * `DistRing(group)`: one rank a process over `torch.distributed`; a
    shift is `batch_isend_irecv` to (r - 1) % d and from (r + 1) % d, the
    reductions `all_reduce` (gloo on the CPU, NCCL on cards).

Only the contiguous layout runs: K1's index masks cannot express the
striped layout's positions under a sliding window, so `striped=True`
raises. `make_positions` and `shard_sequence` give both layouts, as the
JAX helpers do.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from ..kernels.flash_attention_packed import (_check_args, _table,
                                              flash_attention_packed,
                                              flash_attention_packed_bwd)

NEG_INF = -1e30


def make_positions(seq_len: int, degree: int, rank: int,
                   striped: bool = False) -> torch.Tensor:
    """Global token positions owned by `rank` (local order)."""
    per = seq_len // degree
    if striped:
        return torch.arange(per) * degree + rank
    return rank * per + torch.arange(per)


def shard_sequence(x, degree: int, rank: int, axis: int = 1,
                   striped: bool = False) -> torch.Tensor:
    """The tokens `rank` owns along `axis` (host-side dispatch helper)."""
    x = torch.as_tensor(x)
    per = x.shape[axis] // degree
    if striped:
        idx = torch.arange(per, device=x.device) * degree + rank
        return torch.index_select(x, axis, idx)
    return x.narrow(axis, rank * per, per)


# ----------------------------------------------------------------- rings
class Ring:
    """A ring of `size` ranks. `hops(h, rows)` names, for hop h, the
    blocks of the local rows (a slice of the leading dim) and each
    block's shard distance src - rank; `shift` moves tensors one step
    (rank i receives rank i + 1's); `max` and `sum` reduce over the
    ranks, every rank getting the result."""

    size: int

    def hops(self, h: int, rows: int) -> List[Tuple[slice, int]]:
        raise NotImplementedError

    def shift(self, *ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        raise NotImplementedError

    def max(self, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class LocalRing(Ring):
    """Every rank in this process: a tensor's leading dim is `size` equal
    blocks of rows, block r being rank r's."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"a ring needs at least one rank, not {size}")
        self.size = size

    def _block(self, rows: int) -> int:
        if rows % self.size:
            raise ValueError(f"{rows} rows do not split over {self.size} "
                             f"ranks")
        return rows // self.size

    def hops(self, h, rows):
        # ranks [0, size - h) hold shard r + h; the rest wrapped past
        # size and hold shard r + h - size
        split = (self.size - h) * self._block(rows)
        return [(s, dist) for s, dist in ((slice(0, split), h),
                                          (slice(split, rows),
                                           h - self.size))
                if s.stop > s.start]

    def shift(self, *ts):
        return tuple(torch.roll(t, -self._block(t.shape[0]), dims=0)
                     for t in ts)

    def _reduce(self, t, op):
        b = self._block(t.shape[0])
        r = op(t.reshape(self.size, b, *t.shape[1:]), 0)
        return r.expand(self.size, *r.shape).reshape(t.shape)

    def max(self, t):
        return self._reduce(t, torch.amax)

    def sum(self, t):
        return self._reduce(t, torch.sum)


class DistRing(Ring):
    """One rank a process, over a `torch.distributed` process group
    (default: the whole world)."""

    def __init__(self, group=None):
        import torch.distributed as dist
        self._dist = dist
        self.group = group if group is not None else dist.group.WORLD
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self._prev = dist.get_global_rank(self.group,
                                          (self.rank - 1) % self.size)
        self._next = dist.get_global_rank(self.group,
                                          (self.rank + 1) % self.size)

    def hops(self, h, rows):
        return [(slice(0, rows), (self.rank + h) % self.size - self.rank)]

    def shift(self, *ts):
        if self.size == 1:
            return ts
        dist = self._dist
        sent = [t.contiguous() for t in ts]
        got = [torch.empty_like(t) for t in sent]
        ops = []
        for s, g in zip(sent, got):
            ops.append(dist.P2POp(dist.isend, s, self._prev, self.group))
            ops.append(dist.P2POp(dist.irecv, g, self._next, self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return tuple(got)

    def _reduce(self, t, op):
        t = t.clone()
        self._dist.all_reduce(t, op=op, group=self.group)
        return t

    def max(self, t):
        return self._reduce(t, self._dist.ReduceOp.MAX)

    def sum(self, t):
        return self._reduce(t, self._dist.ReduceOp.SUM)


# ------------------------------------------------------------- attention
def _merge_(o, lse, o_h, lse_h) -> None:
    """Fold one hop's (o_h [R,S,H,D], lse_h [R,H,S]) into the fp32
    running (o, lse), in place. Rows with -inf on both sides stay 0."""
    new = torch.logaddexp(lse, lse_h)
    ref = torch.where(torch.isfinite(new), new, 0.0)
    w_old = torch.exp(lse - ref).transpose(1, 2)[..., None]
    w_h = torch.exp(lse_h - ref).transpose(1, 2)[..., None]
    o.mul_(w_old).add_(o_h.float() * w_h)
    lse.copy_(new)


def _hop_kw(seg, span, segh, spanh, rows, dist, S, mode, window):
    return dict(mode=mode, window=window,
                span_ids=None if span is None else span[rows],
                kv_segment_ids=segh[rows],
                kv_span_ids=None if spanh is None else spanh[rows],
                kv_offset=dist * S)


class _RingAttention(torch.autograd.Function):
    """The ring's forward and backward, each hop through K1's wrappers:
    the kernels on CUDA tensors, their plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, seg, span, ring, mode, window):
        R, S, H, _ = q.shape
        o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        lse = torch.full((R, H, S), float("-inf"), device=q.device)
        kh, vh, segh, spanh = k, v, seg, span
        for h in range(ring.size):
            for rows, dist in ring.hops(h, R):
                o_h, lse_h = flash_attention_packed(
                    q[rows], kh[rows], vh[rows], seg[rows], return_lse=True,
                    **_hop_kw(seg, span, segh, spanh, rows, dist, S, mode,
                              window))
                _merge_(o[rows], lse[rows], o_h, lse_h)
            if h < ring.size - 1:
                kh, vh, segh = ring.shift(kh, vh, segh)
                if span is not None:
                    spanh, = ring.shift(spanh)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, seg, span, o, lse)
        ctx.cfg = (ring, mode, window)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, seg, span, o, lse = ctx.saved_tensors
        ring, mode, window = ctx.cfg
        R, S = q.shape[:2]
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        kh, vh, segh, spanh = k, v, seg, span
        for h in range(ring.size):
            for rows, dist in ring.hops(h, R):
                g = flash_attention_packed_bwd(
                    q[rows], kh[rows], vh[rows], o[rows], lse[rows],
                    do[rows], seg[rows],
                    **_hop_kw(seg, span, segh, spanh, rows, dist, S, mode,
                              window))
                for acc, g_h in zip((dq, dk, dv), g):
                    acc[rows] += g_h
            if h < ring.size - 1:
                kh, vh, segh, dk, dv = ring.shift(kh, vh, segh, dk, dv)
                if span is not None:
                    spanh, = ring.shift(spanh)
        if ring.size > 1:
            dk, dv = ring.shift(dk, dv)          # home
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def ring_attention(q, k, v, segment_ids=None, *, ring: Ring,
                   mode: str = "causal", window: Optional[int] = None,
                   span_ids=None, striped: bool = False,
                   return_lse: bool = False):
    """Attention of a sharded packed sequence over `ring`. q [R, S_loc, H,
    D], k/v [R, S_loc, Hkv, D], `segment_ids` and `span_ids` [R, S_loc]
    (or [S_loc]) of the local rows, as K1 takes them (segments -1 =
    padding, default one segment; spans -1 = causal). R is every rank's
    rows in a `LocalRing`, this rank's in a `DistRing`. Returns o in q's
    dtype, and with `return_lse` also the merged fp32 LSE [R, H, S_loc].
    Differentiable in q, k, v."""
    if striped:
        raise ValueError(
            "ring_attention runs the contiguous layout only: K1 masks by "
            "index, which the striped layout's positions do not follow "
            "under a sliding window")
    _check_args(q, k, v, mode, window)
    R, S = q.shape[:2]
    seg = _table(segment_ids, R, S, q.device, fill=0)
    span = _table(span_ids, R, S, q.device)
    o, lse = _RingAttention.apply(q.contiguous(), k.contiguous(),
                                  v.contiguous(), seg, span, ring, mode,
                                  window)
    return (o, lse) if return_lse else o


def ring_decode_attention(q1, k_cache, v_cache, local_valid, *,
                          ring: Ring) -> torch.Tensor:
    """Decode against a KV cache sharded along the sequence over `ring`
    (CP serving): each rank's partial (max, sum, acc) over its shard,
    combined by the ring's reductions in one round. q1 [R, 1, H, D] (the
    same query on every rank), caches [R, T_loc, Hkv, D], `local_valid`
    [R] live entries of each local shard."""
    R, _, H, D = q1.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qg = (q1.reshape(R, 1, Hkv, G, D) / math.sqrt(D)).float()
    s = torch.einsum("bskgd,btkd->bskgt", qg, k_cache.float())
    live = (torch.arange(T, device=q1.device)[None, :]
            < torch.as_tensor(local_valid, device=q1.device)[:, None])
    s = torch.where(live[:, None, None, None, :], s, NEG_INF)
    m = ring.max(s.amax(dim=-1))
    p = torch.exp(s - m[..., None])
    l = ring.sum(p.sum(dim=-1))
    acc = ring.sum(torch.einsum("bskgt,btkd->bskgd", p, v_cache.float()))
    o = acc / torch.clamp(l[..., None], min=1e-30)
    return o.reshape(R, 1, H, D).to(q1.dtype)
