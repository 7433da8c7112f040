"""Continuous-batching scheduler — the serving analogue of DHPScheduler.

Heterogeneous prompt lengths at inference are the same data-variability
problem DHP solves for training, so the serving scheduler reuses the
training planner stack wholesale: pending prefill work (one chunk per
request per iteration) is described as `SeqInfo`s and handed to a bound
`Strategy` (DHP by default), whose `ExecutionPlan` — `validate()`-checked
and `PlanCache`-cached — groups same-bucket prompts into co-executed
prefill batches and assigns each group a CP degree from the cost model,
exactly as the training path does for ragged global batches.

The scheduler itself is pure host-side Python (no torch): an
iteration-level loop that

  1. joins finished requests (slots + KV blocks recycled),
  2. admits queued requests while decode slots and KV blocks last,
  3. plans this iteration's prefill chunks with the DHP planner,
  4. names the decode set (every slot whose prefill is complete).

The runtime (serving/runtime.py) executes what `step()` returns.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from ..core.cost_model import SeqInfo, slice_spans
from ..core.scheduler import ExecutionPlan
from .kv_cache import KVCacheManager

# request lifecycle states
QUEUED, PREFILL, DECODE, FINISHED = "queued", "prefill", "decode", "finished"


@dataclasses.dataclass
class ServeRequest:
    """One inference request with arrival/deadline metadata."""

    request_id: int
    tokens: np.ndarray                  # prompt token ids [L] int32
    max_new_tokens: int = 32
    arrival_s: float = 0.0              # offset from trace start
    deadline_s: Optional[float] = None  # completion deadline (offset)
    eos_id: Optional[int] = None        # early-stop token id
    eta: float = 0.0                    # mask-efficiency factor (Eq. 8)
    #: modality layout of the prompt (ModalitySpan tuple; None = pure
    #: causal text). Span-bearing requests are prefetched through the
    #: span-aware chunked-prefill path so bidirectional vision/audio
    #: blocks are masked correctly, and the planner sees per-chunk
    #: derived eta instead of one scalar per request.
    spans: Optional[tuple] = None

    @property
    def prompt_len(self) -> int:
        return int(len(self.tokens))

    @property
    def context_len(self) -> int:
        """KV capacity the request may touch: prompt + generation."""
        return self.prompt_len + self.max_new_tokens


@dataclasses.dataclass
class RequestState:
    """Scheduler-side lifecycle record of one request."""

    request: ServeRequest
    status: str = QUEUED
    slot: int = -1
    #: prompt tokens whose KV is already in cache. Prefill covers
    #: prompt[:L-1]; prompt[L-1] is the first decode input (it produces
    #: the first generated token), so prefill is done at L-1.
    prefill_pos: int = 0
    generated: List[int] = dataclasses.field(default_factory=list)
    # timing (runtime fills these; offsets from trace start)
    enqueued_s: float = 0.0
    admitted_s: float = 0.0
    first_token_s: Optional[float] = None
    finished_s: Optional[float] = None

    @property
    def prefill_target(self) -> int:
        return max(self.request.prompt_len - 1, 0)

    @property
    def prefill_done(self) -> bool:
        return self.prefill_pos >= self.prefill_target

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.enqueued_s


@dataclasses.dataclass
class PrefillChunk:
    """One request's prefill work this iteration."""

    request_id: int
    start: int          # first prompt position of the chunk
    length: int         # chunk token count (== SeqInfo.length planned)


@dataclasses.dataclass
class PrefillGroup:
    """Co-executed prefill chunks (one GroupPlan of the plan): the
    runtime pads them to one bucket and runs them as a batch. `degree`
    is the planner-assigned CP degree for the group."""

    chunks: List[PrefillChunk]
    degree: int


@dataclasses.dataclass
class IterationSchedule:
    """What the runtime executes for one loop iteration."""

    admitted: List[int]
    prefill_groups: List[PrefillGroup]
    decode_ids: List[int]               # request ids in decode this iter
    plan: Optional[ExecutionPlan]       # validated chunked-prefill plan
    queue_depth: int
    kv_occupancy: float


class ContinuousBatchingScheduler:
    """Iteration-level admission + planning over a KVCacheManager.

    `planner` is any bound `repro_torch.api.Strategy` (its PlanCache makes
    recurring chunk-length histograms skip the 2D-DP solver — the
    serving reuse of the training plan cache). `prefill_chunk` bounds
    per-request prefill work per iteration so long prompts are chunked
    and decode iterations interleave between chunks instead of stalling
    behind a monolithic prefill.
    """

    def __init__(self, kv: KVCacheManager, planner, *,
                 prefill_chunk: int = 256,
                 max_prefill_seqs: Optional[int] = None,
                 prefill_needed: bool = True):
        """`prefill_needed=False` for state-cache families (ssm/hybrid/
        audio): the repo's serving convention (Engine.serve) starts them
        from a fresh state with the last prompt token as first decode
        input, so admission jumps straight to DECODE."""
        self.kv = kv
        self.planner = planner
        self.prefill_chunk = prefill_chunk
        self.max_prefill_seqs = max_prefill_seqs or kv.n_slots
        self.prefill_needed = prefill_needed
        self.queue: Deque[int] = deque()
        self.states: Dict[int, RequestState] = {}
        self.plans_validated = 0
        self.schedule_ms_total = 0.0

    # -- intake ----------------------------------------------------------
    def submit(self, request: ServeRequest, now: float = 0.0) -> None:
        if request.request_id in self.states:
            raise ValueError(
                f"duplicate request_id {request.request_id}")
        need = self.kv.blocks_for(request.context_len)
        if need > self.kv.allocator.n_blocks:
            # fail loudly NOW: this request can never be admitted, and
            # FIFO admission would otherwise head-of-line-block the
            # queue until the runtime's iteration cap trips
            raise ValueError(
                f"request {request.request_id} needs {need} KV blocks "
                f"for its {request.context_len}-token context; the "
                f"pool only has {self.kv.allocator.n_blocks}")
        st = RequestState(request=request, enqueued_s=now)
        self.states[request.request_id] = st
        self.queue.append(request.request_id)

    def has_work(self) -> bool:
        return bool(self.queue) or any(
            s.status in (PREFILL, DECODE) for s in self.states.values())

    @property
    def active(self) -> List[RequestState]:
        return [s for s in self.states.values()
                if s.status in (PREFILL, DECODE)]

    # -- lifecycle transitions driven by the runtime ---------------------
    def mark_prefilled(self, request_id: int, n_tokens: int) -> None:
        """Advance a request's prefill cursor by `n_tokens`."""
        st = self.states[request_id]
        st.prefill_pos = min(st.prefill_pos + n_tokens,
                             st.prefill_target)
        if st.prefill_done:
            st.status = DECODE

    def finish(self, request_id: int, now: float) -> None:
        """Join a finished request: recycle its slot + KV blocks."""
        st = self.states[request_id]
        assert st.status in (PREFILL, DECODE), st.status
        self.kv.release(request_id)
        st.status = FINISHED
        st.slot = -1
        st.finished_s = now

    # -- one scheduling iteration ---------------------------------------
    def step(self, now: float = 0.0) -> IterationSchedule:
        import time

        admitted = self._admit(now)
        t0 = time.perf_counter()
        groups, plan = self._plan_prefills()
        self.schedule_ms_total += (time.perf_counter() - t0) * 1e3
        decode_ids = sorted(
            rid for rid, s in self.states.items() if s.status == DECODE)
        return IterationSchedule(
            admitted=admitted,
            prefill_groups=groups,
            decode_ids=decode_ids,
            plan=plan,
            queue_depth=len(self.queue),
            kv_occupancy=self.kv.occupancy,
        )

    # -- admission -------------------------------------------------------
    def _admit(self, now: float) -> List[int]:
        """FIFO admission while a slot + blocks for the full context are
        available. Head-of-line blocking is intentional: admitting a
        short request past a starved long one would let long prompts
        starve forever under sustained load."""
        admitted: List[int] = []
        while self.queue:
            rid = self.queue[0]
            st = self.states[rid]
            if not self.kv.can_admit(st.request.context_len):
                break
            self.queue.popleft()
            st.slot = self.kv.admit(rid, st.request.context_len)
            if not self.prefill_needed:
                st.prefill_pos = st.prefill_target
            st.status = PREFILL if (self.prefill_needed
                                    and st.prefill_target > 0) else DECODE
            st.admitted_s = now
            admitted.append(rid)
        return admitted

    # -- prefill planning ------------------------------------------------
    def _chunk_len(self, st: RequestState) -> int:
        """Next chunk length for one request: at most `prefill_chunk`,
        but snapped FORWARD to the end of any bidirectional modality
        span the boundary would split — the chunk-level invariant that
        makes span-aware chunked prefill exact (a vision block's K/V
        must all be resident before any of its queries run)."""
        remaining = st.prefill_target - st.prefill_pos
        end = st.prefill_pos + min(self.prefill_chunk, remaining)
        for sp in st.request.spans or ():
            if (sp.attn == "bidirectional"
                    and sp.start < end < sp.start + sp.length):
                end = min(sp.start + sp.length, st.prefill_target)
                break
        return end - st.prefill_pos

    def _next_chunks(self) -> List[PrefillChunk]:
        chunks = []
        for rid, st in sorted(self.states.items()):
            if st.status != PREFILL:
                continue
            chunks.append(PrefillChunk(
                request_id=rid, start=st.prefill_pos,
                length=self._chunk_len(st)))
            if len(chunks) >= self.max_prefill_seqs:
                break
        return chunks

    def _plan_prefills(self):
        """Group this iteration's prefill chunks with the DHP planner.

        SeqInfo.seq_id carries the request id, SeqInfo.length the chunk
        length, so the plan's groups read directly as co-batched prefill
        sets; the plan is validated (coverage + Eq. 3/6) before the
        runtime may execute it."""
        chunks = self._next_chunks()
        if not chunks:
            return [], None
        by_id = {c.request_id: c for c in chunks}

        def chunk_info(c: PrefillChunk) -> SeqInfo:
            req = self.states[c.request_id].request
            if req.spans:
                # span-bearing request: the chunk's OWN layout drives
                # the derived eta the planner costs, not the request's
                # whole-prompt scalar
                return SeqInfo(length=0, seq_id=c.request_id,
                               spans=slice_spans(req.spans, c.start,
                                                 c.length))
            return SeqInfo(length=c.length, eta=req.eta,
                           seq_id=c.request_id)

        seqs = [chunk_info(c) for c in chunks]
        plan = self.planner.plan(seqs)
        plan.validate(seqs, n_ranks=self.planner.n_ranks,
                      cost_model=self.planner.cm,
                      mem_budget=self.planner.budget)
        self.plans_validated += 1
        groups = [
            PrefillGroup(chunks=[by_id[i] for i in g.seq_ids],
                         degree=g.degree)
            for mb in plan.micro_batches for g in mb.groups
        ]
        return groups, plan

    # -- reporting -------------------------------------------------------
    def finished_states(self) -> List[RequestState]:
        return [s for s in self.states.values() if s.status == FINISHED]
