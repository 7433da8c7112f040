"""DHP Executor — runs an ExecutionPlan on the card (§5 workflow (4)).

For each planned CP group the executor:
  1. lays the group's sequences out in one batch: PACKED (the
     `PACKABLE_FAMILIES`) flattens them into ONE token buffer
     (`core/packing.flatten_group`): tokens concatenated, positions
     reset per segment, a segment table making attention block-diagonal,
     a span table for the bidirectional vision/audio blocks, padding only
     at the TAIL to a pooled bucket. PADDED (the SSM and hybrid
     families, whose recurrent state crosses segment boundaries) gives
     each sequence its own row, padded to the bucket of the longest
     (`data/pipeline.padded_batch`);
  2. fetches the group's rank slot (`GroupPool.mesh_for`) and its step
     function from the pool, keyed ("pgrad", start, degree, bucket[,
     "mm"]) when packed and ("grad", start, degree, n_seqs, bucket[,
     "mm"]) when padded, as the JAX package keys its executables;
  3. runs forward and backward of the batch; attention is the packed
     kernel K1 in every layer (`cfg.attn_impl="cuda"`), or the
     full-matrix reference (`"reference"`); an SSM layer runs the SSD
     chunk kernel K3, a recurrent layer the RG-LRU scan kernel K4, or
     their plain versions;
  4. adds the group's gradient, weighted by its loss tokens, into an
     fp32 accumulator on the device.
The result is the token-weighted mean gradient of the global batch:
dynamic regrouping changes where sequences run, never the math.

Against the JAX executor: that one sets `cp_axis="cp"`, so its attention
is always `parallel/ring_attention.ring_attention` and never the Pallas
K1. At degree 1 the ring is one `_partial_update`, which leaves a
tail-padding row as the mean of V (all its scores are -1e30) where K1
gives zeros. Padding rows carry mask 0 and no real row attends them, so
losses and gradients agree; hidden states agree at real tokens only.

A packed group of degree d > 1 runs its [1, bucket] buffer as [d,
bucket / d]: row r is rank r's contiguous shard (the bucket is rounded up
to a multiple of d), every per-token layer runs on the rows unchanged,
attention runs ring context parallelism over a `LocalRing(d)` (K1 a hop,
parallel/ring_attention.py), and the loss and the aux table sum over the
rows, as the JAX executor runs the group under `shard_map` with the
batch split `P(None, "cp")` and `psum`s them. That runs when all of the
group's ranks are one device (one card, or the host in the tests); ranks
on several devices need an executor with one process a card over NCCL
(`DistRing`), which is not written yet. The padded families refuse a
degree > 1: the reference's scan and conv restart from zero at every
shard's first token, so its result at degree d is not the result at
degree 1. The MoE family packs but refuses a degree > 1 too
(`models.model.forward_hidden` says why): the reference routes each
shard alone, and cannot run the family under `shard_map` at all.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..data.pipeline import RaggedBatch, padded_batch
from ..models.model import _head, forward_hidden, position_nll
from ..obs.trace import get_tracer
from ..parallel.ring_attention import LocalRing
from ..training.optimizer import tree_leaves, tree_map
from .group_pool import GroupPool
from .packing import MODALITY_CLASSES, flatten_group
from .scheduler import ExecutionPlan

#: families whose attention layers take block-diagonal segment masks;
#: recurrent state (ssm, hybrid) crosses segment boundaries
PACKABLE_FAMILIES = ("dense", "moe")
#: families the executor runs
EXECUTABLE_FAMILIES = ("dense", "moe", "ssm", "hybrid")


#: fp32 logits of one piece of a padded batch's loss (see `token_nll`)
LOSS_PIECE_BYTES = 1 << 30


def token_nll(params, cfg: ModelConfig, batch, pieces: bool = False,
              ring=None) -> torch.Tensor:
    """Per-position NLL [B, S] of the batch, differentiable in `params`.
    With `pieces` (the padded path) the head and the NLL run over pieces
    of the batch's tokens, each under `torch.utils.checkpoint`, so that
    only one piece's fp32 logits (at most LOSS_PIECE_BYTES: 1048 tokens
    of recurrentgemma-2b's 256000-word vocabulary) are alive at once, in
    the forward and again in the backward, which recomputes them. The
    sums are the same. Without (every packed group) the head runs on the
    whole batch. `ring` passes to `forward_hidden`."""
    x, _ = forward_hidden(params, cfg, batch, ring=ring)
    labels = batch["labels"]
    B, S = labels.shape
    if not pieces:
        return position_nll(_head(params, cfg, x), labels)

    def piece_nll(xp, lp):
        return position_nll(_head(params, cfg, xp), lp)
    n = max(1, LOSS_PIECE_BYTES // (4 * cfg.vocab))
    xs, ls = x.reshape(B * S, -1), labels.reshape(B * S)
    return torch.cat([checkpoint(piece_nll, xs[i:i + n], ls[i:i + n],
                                 use_reentrant=False)
                      for i in range(0, B * S, n)]).reshape(B, S)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class DHPExecutor:
    def __init__(self, cfg: ModelConfig, pool: GroupPool):
        """`pool` is the cluster's GroupPool: its devices are the ranks,
        its ladder buckets the batches, its cache keeps one step
        function per group shape. `PACKABLE_FAMILIES` run packed, the
        others padded."""
        if cfg.family == "audio":
            raise NotImplementedError(
                "the audio family does not run in the executor: the "
                "reference's Engine.train fails on it (KeyError: 'frames'; "
                "its padded groups carry no encoder frames); train it on "
                "fixed-shape batches with training.train_step."
                "make_train_step, as the reference does")
        if cfg.family not in EXECUTABLE_FAMILIES:
            raise NotImplementedError(
                f"execution of family {cfg.family!r} is not ported")
        self.cfg = cfg
        self.pool = pool
        self.packed = cfg.family in PACKABLE_FAMILIES
        #: padding/build telemetry of the most recent run_plan()
        #: (+ "modality_loss" sub-dict for span-bearing runs)
        self.last_run_stats: Dict[str, Any] = {}
        #: step-pool keys run by the most recent run_plan(), in order
        self.last_exe_keys: List[Tuple] = []

    # ------------------------------------------------------------------
    def _build_step(self, with_spans: bool, degree: int = 1):
        """(loss, grads[, modality nll table]) of one group's batch.

        `with_spans` adds the span-masked attention, the `loss_mask`
        (labels inside bidirectional spans carry no NLL — they attend
        their own future) and the per-class [n_classes, 2] (nll_sum,
        label_count) aux table over every valid label. A `degree` > 1
        runs the batch's rows as the shards of a `LocalRing`; the sums
        run over every row."""
        cfg = self.cfg
        ring = LocalRing(degree) if degree > 1 else None

        def step(params, batch):
            leaves = [t.detach().requires_grad_(True)
                      for t in tree_leaves(params)]
            it = iter(leaves)
            p = tree_map(lambda _: next(it), params)
            nll = token_nll(p, cfg, batch, pieces=not self.packed,
                            ring=ring)
            aux = None
            if not with_spans:
                s, c = (nll * batch["mask"]).sum(), batch["mask"].sum()
            else:
                lm = batch["loss_mask"]
                s, c = (nll * lm).sum(), lm.sum()
                cls = batch["modality_classes"]
                with torch.no_grad():
                    rows = []
                    for k in range(len(MODALITY_CLASSES)):
                        mk = batch["mask"] * (cls == k)
                        rows.append(torch.stack([(nll * mk).sum(),
                                                 mk.sum()]))
                    aux = torch.stack(rows).double()
            loss = s / torch.clamp(c, min=1.0)
            del nll
            grads = torch.autograd.grad(loss, leaves)
            it = iter(grads)
            g = tree_map(lambda _: next(it), params)
            return loss.detach(), g, aux

        return lambda: step

    def _group_step(self, start: int, degree: int, n_seqs: int,
                    bucket: int, with_spans: bool):
        """The group's step function. Packed: ONE [1, bucket] buffer
        whatever the group holds, keyed without n_seqs; padded: an
        [n_seqs, bucket] batch. Span-bearing groups get a distinct "mm"
        key; causal groups keep the span-free key (and the span-free
        kernel). A packed group of degree > 1 runs as a `LocalRing` when
        its ranks are one device; see the module docstring."""
        if degree > 1 and not self.packed:
            raise NotImplementedError(
                f"a {self.cfg.family!r} group of degree {degree}: the "
                f"reference restarts its recurrent state (scan and conv) "
                f"from zero at every shard's first token, so degree "
                f"{degree} is another computation than degree 1; the port "
                f"runs this family at degree 1 only")
        ranks = self.pool.mesh_for(start, degree)
        if len(set(ranks)) > 1:
            raise NotImplementedError(
                f"a CP group of degree {degree} over devices {ranks}: "
                f"ranks on several devices need the executor with one "
                f"process a card over NCCL (parallel.DistRing), which is "
                f"not written yet; this executor runs a group's ranks on "
                f"one device")
        key = (("pgrad", start, degree, bucket) if self.packed
               else ("grad", start, degree, n_seqs, bucket)) \
            + (("mm",) if with_spans else ())
        exe, miss = self.pool.executable_for(
            key, self._build_step(with_spans, degree))
        return exe, miss, key, ranks[0]

    def _group_batch(self, seqs, degree: int, spans=None):
        """(np_batch, real_tokens, padded_tokens, bucket) for one group.
        Both layouts emit the same per-sequence modality table, so
        packed and padded execution apply the same mixed mask. A packed
        group of degree d comes as [d, bucket / d], row r rank r's
        contiguous shard."""
        if self.packed:
            total = sum(len(s) for s in seqs)
            bucket = self.pool.bucket(total)
            bucket += (-bucket) % degree       # shardable over cp
            np_batch, cu = flatten_group(seqs, bucket, spans=spans)
            np_batch = {k: a.reshape(degree, bucket // degree)
                        for k, a in np_batch.items()}
            return np_batch, int(cu[-1]), bucket, bucket
        bucket = self.pool.bucket(max(len(s) for s in seqs))
        bucket += (-bucket) % degree           # shardable over cp
        np_batch = padded_batch(seqs, bucket, spans=spans)
        real = sum(min(len(s), bucket) for s in seqs)
        return np_batch, real, len(seqs) * bucket, bucket

    # ------------------------------------------------------------------
    def run_plan(self, params, plan: ExecutionPlan, data: RaggedBatch, *,
                 timings: Optional[List[Dict[str, Any]]] = None
                 ) -> Tuple[torch.Tensor, Any]:
        """Execute every micro-batch of the plan; returns (mean loss,
        token-weighted mean gradient, fp32) for the global batch, both on
        the device.

        With `timings` (a caller-owned list) every group is timed
        synchronously and a record {seq_ids, degree, tokens, bucket,
        seconds, compiled, real_tokens, padded_tokens,
        padding_efficiency} is appended per group.

        `self.last_run_stats` aggregates {real_tokens, padded_tokens,
        padding_efficiency, exe_misses, groups}; span-bearing runs add
        "modality_loss": {class name: mean NLL} over every class that had
        a valid label (classes masked out of the training loss, such as
        bidirectional vision spans, still report)."""
        tr = get_tracer()
        t_run = time.perf_counter()
        total_tokens = 0.0
        g_acc = None
        loss_acc = None
        aux_acc = None       # [n_classes, 2] (nll_sum, label_count)
        agg: Dict[str, Any] = {"real_tokens": 0, "padded_tokens": 0,
                               "exe_misses": 0, "groups": 0}
        # rank slots come from the plan IR itself, so executor and
        # GroupDelta diffing agree on which rank slice a group runs on
        slots = iter(plan.group_slots(self.pool.n_replicas))
        self.last_exe_keys = []
        spans_by_id = data.spans_by_id()
        device = None
        for mb in plan.micro_batches:
            n_groups = 0
            for g in mb.groups:
                mi, gi, start, _ = next(slots)
                seqs = [data.by_id(i) for i in g.seq_ids]
                spans = ([spans_by_id.get(i) for i in g.seq_ids]
                         if spans_by_id else None)
                np_batch, real, padded, bucket = self._group_batch(
                    seqs, g.degree, spans=spans)
                with_spans = "modality_ids" in np_batch
                step, compiled, key, device = self._group_step(
                    start, g.degree, len(seqs), bucket, with_spans)
                self.last_exe_keys.append(key)
                batch = {k: torch.as_tensor(v, device=device)
                         for k, v in np_batch.items()}
                # weight groups by LOSS tokens when a loss mask exists —
                # bidirectional-span labels carry no NLL, so counting
                # them would dilute the span-bearing groups' gradients
                n_tok = float(np_batch.get(
                    "loss_mask", np_batch["mask"]).sum())
                agg["real_tokens"] += real
                agg["padded_tokens"] += padded
                agg["exe_misses"] += int(compiled)
                agg["groups"] += 1
                n_groups += 1
                args = {"mb": mi, "group": gi, "degree": g.degree,
                        "start_rank": start, "n_seqs": len(seqs),
                        "bucket": bucket, "spans": with_spans}
                if timings is not None:
                    _sync(device)
                t0 = time.perf_counter()
                loss, grads, aux = step(params, batch)
                w = n_tok
                total_tokens += w
                loss_acc = (loss.double() * w if loss_acc is None
                            else loss_acc + loss.double() * w)
                if aux is not None:
                    aux_acc = aux if aux_acc is None else aux_acc + aux
                if g_acc is None:
                    g_acc = tree_map(lambda a: a.float() * w, grads)
                else:
                    tree_map(lambda acc, a: acc.add_(a.float(), alpha=w),
                             g_acc, grads)
                del grads
                if timings is None:
                    if tr.enabled:
                        # host-side enqueue cost only: the device work
                        # runs asynchronously
                        tr.complete("dispatch", t0,
                                    time.perf_counter() - t0, "exec",
                                    args=args)
                else:
                    _sync(device)
                    dt = time.perf_counter() - t0
                    timings.append({
                        "seq_ids": list(g.seq_ids),
                        "degree": g.degree,
                        "tokens": g.tokens,
                        "bucket": bucket,
                        "seconds": dt,
                        "compiled": compiled,
                        "real_tokens": real,
                        "padded_tokens": padded,
                        "padding_efficiency": real / max(padded, 1),
                    })
                    if tr.enabled:
                        # the measured group time is ONE span on the
                        # track of every rank the group occupies
                        for rank in range(start, start + g.degree):
                            tr.rank_span(
                                "execute", rank, t0, dt,
                                args={**args, "tokens": g.tokens,
                                      "compiled": compiled})
            t_collect = time.perf_counter()
            if device is not None:
                _sync(device)        # the wave barrier
            if tr.enabled:
                tr.complete("collect", t_collect,
                            time.perf_counter() - t_collect, "exec",
                            args={"groups": n_groups})
        agg["padding_efficiency"] = (
            agg["real_tokens"] / max(agg["padded_tokens"], 1))
        if aux_acc is not None:
            a = aux_acc.cpu().numpy()
            agg["modality_loss"] = {
                name: float(a[k, 0] / a[k, 1])
                for k, name in enumerate(MODALITY_CLASSES) if a[k, 1] > 0}
        self.last_run_stats = agg
        denom = max(total_tokens, 1.0)
        grads = tree_map(lambda a: a.div_(denom), g_acc)
        loss = (loss_acc / denom).float()
        if tr.enabled:
            tr.complete("run_plan", t_run, time.perf_counter() - t_run,
                        "exec", args={"groups": agg["groups"],
                                      "exe_misses": agg["exe_misses"],
                                      "measured": timings is not None})
        return loss, grads
