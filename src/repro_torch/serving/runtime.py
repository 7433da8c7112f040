"""ServingEngine — the continuous-batching serving runtime.

One event loop joins the three subsystems:

  ContinuousBatchingScheduler  (admission + DHP-planned chunked prefill)
  KVCacheManager               (decode slots + paged block accounting)
  slot decode step             (serve_step.make_slot_decode_step)

Per iteration: admit arrivals, execute the planner's prefill groups
(bounded chunks, so decode never stalls behind a long prompt), then run
ONE decode step for every live slot. Step functions live in the
cluster's shared GroupPool keyed on bucketed shapes.

Request streams are greedy and deterministic: a request decoded here
yields exactly the token ids `greedy_generate` produces for the same
prompt. Co-batched one-shot prefill and the exact-length prefill (of
sliding-window caches and of the MoE family) run the flash-attention
kernel (`cfg.attn_impl="cuda"`); chunked prefill and decode are plain
PyTorch.

State-cache families (ssm, hybrid) and the audio family are never
prefilled, as in the JAX package: a request starts from a fresh
`init_cache` and decodes from its prompt's last token, so the earlier
prompt tokens do not reach its stream. An audio request's cache first
takes the cross K/V of its frames (`ServeRequest.frames`, or
`serving_frames`) at admission: the encoder runs once a request, its
full attention through K2; the slot cache holds the cross K/V in the
parameters' dtype, as the reference's `write_slot` casts them.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional, Sequence as Seq

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.group_pool import pow2_bucket
from ..core.packing import fill_modality_row
from ..models.model import PREFILL_FAMILIES
from ..obs.metrics import MetricsRegistry
from ..obs.trace import Tracer, get_tracer, tracing
from .kv_cache import KVCacheManager
from .scheduler import (DECODE, ContinuousBatchingScheduler, PrefillGroup,
                        ServeRequest)


@dataclasses.dataclass
class RequestMetrics:
    request_id: int
    prompt_len: int
    n_generated: int
    tokens: List[int]                # the greedy-decoded output ids
    ttft_s: Optional[float]          # first token - arrival
    mean_tpot_s: float               # mean time per output token
    queue_s: float                   # arrival -> admission
    deadline_met: Optional[bool]     # None when no deadline was set


@dataclasses.dataclass
class ServeReport:
    """Aggregate + per-request serving telemetry for one trace."""

    requests: List[RequestMetrics]
    wall_s: float
    total_tokens: int
    tokens_per_s: float
    mean_ttft_s: float
    max_ttft_s: float
    n_iterations: int
    n_decode_steps: int
    n_prefill_chunks: int
    schedule_ms: float               # host planning latency, summed
    plan_cache: Dict[str, int]
    exe_misses: int                  # step functions built during the run
    queue_depth: List[int]           # sampled per iteration
    kv_occupancy: List[float]        # sampled per iteration
    peak_kv_blocks: int
    n_slots: int
    cache_len: int

    def summary(self) -> str:
        return (f"{len(self.requests)} requests, "
                f"{self.total_tokens} tokens in {self.wall_s:.2f}s "
                f"({self.tokens_per_s:.1f} tok/s) "
                f"ttft mean={self.mean_ttft_s * 1e3:.0f}ms "
                f"max={self.max_ttft_s * 1e3:.0f}ms "
                f"iters={self.n_iterations} "
                f"(decode={self.n_decode_steps} "
                f"prefill_chunks={self.n_prefill_chunks}) "
                f"built={self.exe_misses}")


class ServingEngine:
    """Continuous-batching runtime over one model on one device.

    Build via `Engine.serving(...)`. The decode slot count and cache
    capacity are bucketed through the cluster ladder
    (`ClusterSpec.decode_shape`). Serves the dense family (full or
    sliding-window attention), the MoE family, the SSM family, the
    hybrid family and the audio family.
    `strategy` names the prefill planner (any `get_strategy` name);
    the plan only groups prefill chunks, so it never changes a stream.
    """

    def __init__(self, cfg: ModelConfig, params, cluster, cost_model, *,
                 slots: int = 4, cache_len: Optional[int] = None,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 prefill_chunk: int = 128, strategy: str = "dhp",
                 seed: int = 0):
        from ..api.strategies import get_strategy
        self.cfg = cfg
        self.params = params
        self.cluster = cluster
        self.device = cluster.primary
        self.pool = cluster.pool()
        self.block_size = block_size
        # MoE capacity routing runs over the routed token set (padding or
        # chunking a prompt changes which tokens an expert drops) and
        # sliding-window caches rotate on prefill: such a prompt prefills
        # whole at its exact length, and its first token comes from the
        # prefill logits (see _run_prefill_group)
        self.exact_prefill = (cfg.family == "moe"
                              or cfg.sliding_window is not None)
        self.prefill_chunk = (10 ** 9 if self.exact_prefill
                              else prefill_chunk)
        self.seed = seed
        self._cache_len = cache_len
        self._n_blocks = n_blocks
        self.n_slots, _ = cluster.decode_shape(slots, 1)
        self.attention_family = cfg.family in PREFILL_FAMILIES
        # its own planner: serving plans must not evict training plans,
        # and the salt keeps the two key spaces apart
        self.planner = get_strategy(strategy).bind(
            cost_model, cluster.n_replicas, cluster.mem_budget)
        cache = self.planner.plan_cache
        if cache is not None:          # the measuring oracle keeps none
            cache.salt = "serve-prefill"
        #: counters/gauges/histograms (queue depth, KV occupancy,
        #: decode/prefill volume), folded in at the end of run()
        self.metrics = MetricsRegistry()

    # -- pooled step functions -------------------------------------------
    def _exe(self, key, build):
        exe, _ = self.pool.executable_for(key, build)
        return exe

    def _decode_step(self, n_slots: int, T: int):
        from .serve_step import make_slot_decode_step
        return self._exe(
            ("pserve", self.cfg.arch_id, self.cfg.family, n_slots, T),
            lambda: make_slot_decode_step(self.cfg))

    def _writer(self, n_slots: int, T: int):
        from .serve_step import write_slot
        return self._exe(
            ("slot_write", self.cfg.arch_id, self.cfg.family, n_slots, T),
            lambda: functools.partial(write_slot, self.cfg))

    def _group_prefill(self, rows: int, Sb: int, T: int):
        from ..models.model import prefill
        cfg = self.cfg

        def fn(params, toks):
            return prefill(params, cfg, {"tokens": toks}, cache_len=T)
        return self._exe(("gprefill", cfg.arch_id, rows, Sb, T),
                         lambda: fn)

    def _chunk_prefill(self, Cb: int, T: int, with_spans: bool = False):
        from ..models.model import prefill_chunk
        cfg = self.cfg

        def fn(params, cache, toks, start, span_ids=None,
               cache_span_ids=None):
            return prefill_chunk(params, cfg, cache, toks, start,
                                 span_ids=span_ids,
                                 cache_span_ids=cache_span_ids)
        key = ("cprefill", cfg.arch_id, Cb, T) + (
            ("spans",) if with_spans else ())
        return self._exe(key, lambda: fn)

    def _span_row(self, request: ServeRequest, T: int) -> np.ndarray:
        """[1,T] cache-row modality table for one request: absolute
        positions of its bidirectional blocks, -1 elsewhere (including
        the generation region — decode is causal)."""
        row = np.full((1, T), -1, np.int64)
        fill_modality_row(row[0], request.spans, 0,
                          min(request.prompt_len, T), 0)
        return row

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _fresh_cache(self, request: ServeRequest, T: int):
        """B=1 starting cache of one admitted request; an audio request's
        holds the cross K/V of its frames, or of `serving_frames` (the
        same for every request), as Engine.serve's do."""
        from ..models.model import (init_cache, prefill_cross_kv,
                                    serving_frames)
        cache = init_cache(self.cfg, 1, T, device=self.device)
        if self.cfg.family != "audio":
            return cache
        if request.frames is not None:
            frames = self._tensor(request.frames)[None]
            if frames.dtype == torch.float64:     # as JAX without x64
                frames = frames.float()
        else:
            frames = serving_frames(self.cfg, 1, self.seed, self.device)
        with get_tracer().span("encode", "serve",
                               args={"request": request.request_id}):
            return prefill_cross_kv(self.params, self.cfg, frames, cache)

    # -- prefill execution -----------------------------------------------
    def _run_prefill_group(self, group: PrefillGroup, sched, staging,
                           pending_first, T: int) -> int:
        """Execute one planner group; returns chunk count executed."""
        tr = get_tracer()
        one_shot, chunked = [], []
        for c in group.chunks:
            st = sched.states[c.request_id]
            if (c.start == 0 and c.length == st.prefill_target
                    and not self.exact_prefill
                    and st.request.spans is None):
                # span-bearing prompts always take the chunked path so
                # their bidirectional blocks are masked (the co-batched
                # one-shot prefill is causal-only)
                one_shot.append(c)
            else:
                chunked.append(c)

        if one_shot:
            # co-batched full-prompt prefill, padded to one bucket. Rows
            # are right-padded: causal attention makes KV[0:L-1] of a
            # padded row identical to the exact-length computation, and
            # decode re-derives position L-1 itself, so padding never
            # leaks into a request's stream.
            Sb = self.pool.bucket(max(c.length for c in one_shot))
            rows = pow2_bucket(len(one_shot), minimum=1)
            toks = np.zeros((rows, Sb), np.int64)
            for r, c in enumerate(one_shot):
                toks[r, :c.length] = \
                    sched.states[c.request_id].request.tokens[:c.length]
            with tr.span("prefill_batch", "serve",
                         args={"rows": rows, "bucket": Sb,
                               "prompts": len(one_shot)}):
                _, cache = self._group_prefill(rows, Sb, T)(
                    self.params, self._tensor(toks))
            for r, c in enumerate(one_shot):
                staging[c.request_id] = {
                    "k": cache["k"][:, r:r + 1],
                    "v": cache["v"][:, r:r + 1],
                    "pos": torch.tensor(c.length, device=self.device)}
                sched.mark_prefilled(c.request_id, c.length)

        for c in chunked:
            st = sched.states[c.request_id]
            if self.exact_prefill:
                self._exact_prefill(c, st, staging, pending_first, T)
                sched.mark_prefilled(c.request_id, c.length)
                continue
            Cb = pow2_bucket(c.length, minimum=16)
            toks = np.zeros((1, Cb), np.int64)
            toks[0, :c.length] = \
                st.request.tokens[c.start:c.start + c.length]
            with tr.span("prefill_chunk", "serve",
                         args={"request": c.request_id,
                               "start": c.start, "length": c.length,
                               "bucket": Cb}):
                spans = {}
                if st.request.spans is not None:
                    row = self._span_row(st.request, T)
                    cs = np.full((1, Cb), -1, np.int64)
                    cs[0, :c.length] = row[0, c.start:c.start + c.length]
                    spans = {"span_ids": self._tensor(cs),
                             "cache_span_ids": self._tensor(row)}
                cache = self._chunk_prefill(Cb, T, bool(spans))(
                    self.params, staging[c.request_id],
                    self._tensor(toks), c.start, **spans)
            # pos is owned by the bookkeeping here, not the padded chunk
            cache["pos"] = torch.tensor(c.start + c.length,
                                        device=self.device)
            staging[c.request_id] = cache
            sched.mark_prefilled(c.request_id, c.length)
        return len(group.chunks)

    def _exact_prefill(self, c, st, staging, pending_first, T: int):
        """The whole prompt through `prefill` at its exact length against
        the cache the slot holds (T rows, or a ring of min(window, T),
        rotated so that position p sits in row p % window), staged at
        pos = L; the first token comes from the prefill logits."""
        if not (c.start == 0 and c.length == st.prefill_target):
            raise AssertionError(
                f"request {c.request_id}: an exact-length prefill takes "
                f"the whole prompt in one chunk")
        W = self.cfg.sliding_window
        Tring = T if W is None else min(W, T)
        L = st.request.prompt_len
        with get_tracer().span("prefill_exact", "serve",
                               args={"request": c.request_id,
                                     "length": L}):
            logits, cache = self._group_prefill(1, L, Tring)(
                self.params, self._tensor(st.request.tokens[None, :]))
        pending_first[c.request_id] = int(torch.argmax(logits[0, 0]))
        staging[c.request_id] = {
            "k": cache["k"], "v": cache["v"],
            "pos": torch.tensor(L, device=self.device)}

    # -- the loop ---------------------------------------------------------
    def run(self, requests: Seq[ServeRequest], *,
            log=None, trace=None) -> ServeReport:
        """Serve a trace to completion; returns the ServeReport.

        `trace`: a path, True, or a Tracer — records a Chrome
        trace-event timeline of the loop (prefill batches/chunks,
        decode steps, queue-depth and KV-occupancy counter tracks);
        saved to the path when one is given."""
        tracer: Optional[Tracer] = None
        trace_path: Optional[str] = None
        if trace is not None and trace is not False:
            if isinstance(trace, str):
                trace_path, tracer = trace, Tracer()
            elif trace is True:
                tracer = Tracer()
            else:
                tracer = trace
        if tracer is not None:
            try:
                with tracing(tracer):
                    report = self._run(requests, log=log)
            finally:
                if trace_path is not None:
                    tracer.save(trace_path)
            return report
        return self._run(requests, log=log)

    @torch.no_grad()
    def _run(self, requests: Seq[ServeRequest], *,
             log=None) -> ServeReport:
        from .serve_step import make_slot_cache
        tr = get_tracer()

        requests = sorted(requests, key=lambda r: (r.arrival_s,
                                                   r.request_id))
        if not requests:
            raise ValueError("empty trace")
        max_ctx = max(r.context_len for r in requests)
        _, T = self.cluster.decode_shape(self.n_slots, max_ctx)
        if self._cache_len is not None:
            T = max(T, self._cache_len)
        n_blocks = self._n_blocks or max(
            1, (self.n_slots * T) // self.block_size)
        kv = KVCacheManager(self.n_slots, n_blocks, self.block_size)
        sched = ContinuousBatchingScheduler(
            kv, self.planner, prefill_chunk=self.prefill_chunk,
            prefill_needed=self.attention_family)

        exe_misses0 = self.pool.stats.exe_misses
        slots = make_slot_cache(self.cfg, self.n_slots, T,
                                device=self.device)
        decode = self._decode_step(self.n_slots, T)
        writer = self._writer(self.n_slots, T)
        staging: Dict[int, Any] = {}
        pending_first: Dict[int, int] = {}
        next_token: Dict[int, int] = {}
        slot_of: Dict[int, int] = {}
        queue_depth: List[int] = []
        kv_occ: List[float] = []
        token_times: Dict[int, List[float]] = {}
        n_iters = n_decode = n_chunks = 0
        arrivals = list(requests)
        t0 = time.perf_counter()
        skip = 0.0                      # virtual fast-forward while idle

        def now() -> float:
            return time.perf_counter() - t0 + skip

        max_iters = 10 * sum(r.max_new_tokens for r in requests) + \
            10 * len(requests) + 100
        while arrivals or sched.has_work():
            n_iters += 1
            if n_iters > max_iters:
                raise RuntimeError(
                    f"serving loop did not converge in {max_iters} "
                    f"iterations")
            t = now()
            while arrivals and arrivals[0].arrival_s <= t:
                r = arrivals.pop(0)
                sched.submit(r, now=r.arrival_s)
            if not sched.has_work():
                skip += arrivals[0].arrival_s - t   # idle: fast-forward
                continue

            it = sched.step(t)
            queue_depth.append(it.queue_depth)
            kv_occ.append(it.kv_occupancy)
            if tr.enabled:
                tr.counter("queue_depth", {"waiting": it.queue_depth})
                tr.counter("kv_occupancy",
                           {"fraction": it.kv_occupancy})

            for rid in it.admitted:
                st = sched.states[rid]
                staging[rid] = self._fresh_cache(st.request, T)
                next_token[rid] = int(st.request.tokens[-1])
                token_times[rid] = []

            for group in it.prefill_groups:
                with tr.span("prefill_group", "serve",
                             args={"iter": n_iters,
                                   "chunks": len(group.chunks)}):
                    n_chunks += self._run_prefill_group(
                        group, sched, staging, pending_first, T)

            # prefill-complete requests move into their decode slot. The
            # staged cache carries the pos of its path: L-1 after chunked
            # or co-batched prefill (the last prompt token is the first
            # decode input), L after an exact-length prefill (the first
            # token came from its logits), 0 for a fresh cache (a state
            # cache, or a 1-token prompt), as Engine.serve starts them.
            for rid in list(sched.states):
                st = sched.states[rid]
                if not (st.status == DECODE and rid in staging):
                    continue
                slots = writer(slots, staging.pop(rid), st.slot)
                slot_of[rid] = st.slot
                if rid in pending_first:
                    tok = pending_first.pop(rid)
                    t_tok = now()
                    st.generated.append(tok)
                    next_token[rid] = tok
                    token_times[rid].append(t_tok)
                    st.first_token_s = t_tok
                    req = st.request
                    if (len(st.generated) >= req.max_new_tokens
                            or (req.eos_id is not None
                                and tok == req.eos_id)):
                        sched.finish(rid, t_tok)
                        del slot_of[rid]

            # decode set derived AFTER the insert pass, not from the
            # schedule: the step advances every slot, so a slot whose
            # request was inserted this iteration must decode this
            # iteration too — otherwise the step feeds it a pad token
            # and shifts the request's stream by one garbage write.
            decode_ids = sorted(
                rid for rid, s in sched.states.items()
                if s.status == DECODE and rid in slot_of)
            if decode_ids:
                toks = np.zeros((self.n_slots, 1), np.int64)
                for rid in decode_ids:
                    toks[slot_of[rid], 0] = next_token[rid]
                with tr.span("decode", "serve",
                             args={"iter": n_iters,
                                   "live": len(decode_ids)}):
                    out, slots = decode(self.params, slots,
                                        self._tensor(toks))
                    out = out.cpu().numpy()
                n_decode += 1
                t_tok = now()
                for rid in decode_ids:
                    st = sched.states[rid]
                    tok = int(out[slot_of[rid]])
                    st.generated.append(tok)
                    next_token[rid] = tok
                    token_times[rid].append(t_tok)
                    if st.first_token_s is None:
                        st.first_token_s = t_tok
                    req = st.request
                    if (len(st.generated) >= req.max_new_tokens
                            or (req.eos_id is not None
                                and tok == req.eos_id)):
                        sched.finish(rid, t_tok)
                        del slot_of[rid]
                        if log is not None:
                            log(f"request {rid} finished: "
                                f"{len(st.generated)} tokens, "
                                f"ttft={st.ttft_s * 1e3:.0f}ms")

        wall = time.perf_counter() - t0
        return self._report(sched, token_times, wall, T,
                            n_iters, n_decode, n_chunks,
                            queue_depth, kv_occ, kv,
                            self.pool.stats.exe_misses - exe_misses0)

    # -- reporting --------------------------------------------------------
    def _report(self, sched, token_times, wall, T, n_iters, n_decode,
                n_chunks, queue_depth, kv_occ, kv,
                exe_misses) -> ServeReport:
        reqs = []
        for st in sched.finished_states():
            times = token_times.get(st.request.request_id, [])
            gaps = np.diff(times) if len(times) > 1 else []
            r = st.request
            reqs.append(RequestMetrics(
                request_id=r.request_id,
                prompt_len=r.prompt_len,
                n_generated=len(st.generated),
                tokens=list(st.generated),
                ttft_s=st.ttft_s,
                mean_tpot_s=float(np.mean(gaps)) if len(gaps) else 0.0,
                queue_s=st.admitted_s - st.enqueued_s,
                deadline_met=(None if r.deadline_s is None
                              else st.finished_s <= r.deadline_s)))
        total = sum(m.n_generated for m in reqs)
        ttfts = [m.ttft_s for m in reqs if m.ttft_s is not None]
        cache = self.planner.plan_cache
        reg = self.metrics
        reg.counter("serve/requests").inc(len(reqs))
        reg.counter("serve/tokens").inc(total)
        reg.counter("serve/iterations").inc(n_iters)
        reg.counter("serve/decode_steps").inc(n_decode)
        reg.counter("serve/prefill_chunks").inc(n_chunks)
        reg.counter("serve/exe_misses").inc(exe_misses)
        for t in ttfts:
            reg.histogram("serve/ttft_s").observe(t)
        for q in queue_depth:
            reg.histogram("serve/queue_depth").observe(q)
        for occ in kv_occ:
            reg.histogram("serve/kv_occupancy").observe(occ)
        reg.gauge("serve/peak_kv_blocks").set(kv.stats.peak_blocks)
        if cache is not None:
            reg.update_from(dict(cache.stats), "plan/cache_")
        return ServeReport(
            requests=sorted(reqs, key=lambda m: m.request_id),
            wall_s=wall,
            total_tokens=total,
            tokens_per_s=total / max(wall, 1e-9),
            mean_ttft_s=float(np.mean(ttfts)) if ttfts else 0.0,
            max_ttft_s=float(np.max(ttfts)) if ttfts else 0.0,
            n_iterations=n_iters,
            n_decode_steps=n_decode,
            n_prefill_chunks=n_chunks,
            schedule_ms=sched.schedule_ms_total,
            plan_cache=dict(cache.stats) if cache is not None else {},
            exe_misses=exe_misses,
            queue_depth=queue_depth,
            kv_occupancy=kv_occ,
            peak_kv_blocks=kv.stats.peak_blocks,
            n_slots=self.n_slots,
            cache_len=T,
        )
