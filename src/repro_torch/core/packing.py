"""Stage 1 — Memory-aware Sequence Packing via Best-Fit Decreasing (§4.3).

Transforms K heterogeneous sequences into K' <= K *atomic groups*.
Sequences are sorted by descending memory requirement; each sequence
either best-fits into an existing bin's headroom or opens a new bin with
capacity d_min * E_act where d_min = ceil(M(s)/E_act) (its minimum CP
degree under the per-rank activation budget E_act = E - M_ms).

Each atomic group is subsequently treated as ONE scheduling unit by the
2D-DP allocator; this both shrinks the DP's decision-variable count and
avoids the redundant-communication pathology of spreading many short
sequences across a wide CP group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence as Seq, Tuple

import numpy as np

from .cost_model import ATTN_BIDIRECTIONAL, CostModel, SeqInfo

#: Label-modality classes reported in per-modality loss telemetry.
#: Fixed and ordered so the device-side per-class reduction has a
#: static shape; unknown modalities fold into "other".
MODALITY_CLASSES = ("text", "vision", "audio", "other")


def modality_class(name: str) -> int:
    try:
        return MODALITY_CLASSES.index(name)
    except ValueError:
        return len(MODALITY_CLASSES) - 1


@dataclasses.dataclass
class AtomicGroup:
    """A bin of sequences schedulable as one unit on >= d_min ranks."""

    seqs: List[SeqInfo]
    d_min: int               # minimum CP degree to satisfy Eq. (3)
    capacity: float          # d_min * E_act (bytes)
    used: float              # activation bytes currently packed

    @property
    def headroom(self) -> float:
        return self.capacity - self.used

    @property
    def total_tokens(self) -> int:
        return sum(s.length for s in self.seqs)


def pack_sequences(
    seqs: Seq[SeqInfo],
    cost_model: CostModel,
    budget: float,
    *,
    max_degree: int | None = None,
    balance_over: int | None = None,
) -> List[AtomicGroup]:
    """Best-Fit-Decreasing memory-aware packing (paper §4.3 Stage 1).

    Args:
      seqs: the micro-batch B of K sequences.
      cost_model: supplies M_token / M_ms (Eq. 7).
      budget: per-rank memory budget E in bytes (Eq. 3).
      max_degree: optional cap on d_min (e.g. the rank count N).
      balance_over: BEYOND-PAPER refinement — when set to the rank count
        N, bin capacity is clipped to ~total/N so low memory pressure
        still yields >= N atomic groups. The paper's capacity d_min*E is
        memory-driven only; with K' << N groups the DP has no freedom
        left and DHP can lose to plain round-robin DP (observed in the
        Fig.-5 8-rank point). Memory feasibility (Eq. 3) is unaffected:
        the clip only ever SHRINKS bins.

    Returns K' atomic groups, each with its minimum CP degree.
    """
    c = cost_model.coeffs
    e_act = budget - c.m_ms
    if e_act <= 0:
        raise ValueError("memory budget smaller than model states")

    order = sorted(seqs, key=lambda s: s.length * c.m_token, reverse=True)
    cap_clip = float("inf")
    if balance_over:
        total = sum(s.length for s in seqs) * c.m_token
        biggest = max((s.length for s in seqs), default=0) * c.m_token
        cap_clip = max(total / balance_over, biggest)

    bins: List[AtomicGroup] = []
    for s in order:
        need = s.length * c.m_token
        # Best fit: the bin whose headroom is smallest but sufficient.
        best: AtomicGroup | None = None
        for b in bins:
            if b.headroom >= need and (best is None or b.headroom < best.headroom):
                best = b
        if best is not None:
            best.seqs.append(s)
            best.used += need
            continue
        d_min = max(1, math.ceil(need / e_act))
        if max_degree is not None:
            if d_min > max_degree:
                raise ValueError(
                    f"sequence of {s.length} tokens needs CP degree {d_min} "
                    f"> available ranks {max_degree}")
        bins.append(AtomicGroup(
            seqs=[s], d_min=d_min,
            capacity=min(d_min * e_act, max(cap_clip, need)), used=need))
    return bins


def fill_modality_row(row: np.ndarray, spans, offset: int, length: int,
                      next_id: int) -> int:
    """Write one sequence's bidirectional-span ids into a modality table
    row: tokens of the SAME bidirectional block share a nonnegative id
    (unique within the row as numbered from `next_id`); causal text and
    padding stay -1. Returns the next free id."""
    if spans:
        for sp in spans:
            if sp.attn != "bidirectional":
                continue
            a = offset + sp.start
            b = min(offset + sp.start + sp.length, offset + length)
            if b > a:
                row[a:b] = next_id
                next_id += 1
    return next_id


def fill_loss_row(cls_row: np.ndarray, lm_row: np.ndarray, spans,
                  offset: int, length: int) -> None:
    """Label-token modality classes + NLL loss mask for ONE sequence's
    slice of a batch row.

    Position i predicts token i+1 (the label), so a span covering
    tokens [start, end) owns LABEL positions [start-1, end-1). Classes
    default to "text" (scalar sequences have no structure); spans
    override with their modality. Labels inside a BIDIRECTIONAL span
    are zeroed out of `lm_row`: those tokens attend their own future
    within the block, so next-token NLL on them is leaky (and a vision
    patch / audio window id is not a meaningful LM target anyway) —
    they stay visible to telemetry through `cls_row` + the base mask."""
    if length > 1:
        cls_row[offset:offset + length - 1] = 0        # causal text default
    if not spans:
        return
    for sp in spans:
        a = max(sp.start - 1, 0)
        b = min(sp.end - 1, length - 1)
        if b <= a:
            continue
        cls_row[offset + a:offset + b] = modality_class(sp.modality)
        if sp.attn == ATTN_BIDIRECTIONAL:
            lm_row[offset + a:offset + b] = 0.0


def flatten_group(
    seqs: Seq[np.ndarray],
    bucket: int,
    pad_id: int = 0,
    spans: Optional[Seq] = None,
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Concatenate an atomic group's sequences into ONE packed buffer.

    The executor's packed varlen path: all tokens live in a single
    [1, bucket] row padded only at the TAIL, so the step's shape does
    not depend on n_seqs.

    `spans` (optional) is a per-sequence list of `ModalitySpan` tuples
    (parallel to `seqs`; entries may be None) describing each
    sequence's modality layout. The `modality_ids` table is emitted
    ONLY when at least one entry is non-None — pure-causal batches
    keep the exact pre-span batch dict, so they never pay for the
    mixed-mask attention path.

    Returns `(batch, cu_seqlens)`:
      batch = {tokens, labels, mask, positions, segment_ids
        [, modality_ids, loss_mask, modality_classes]}, all [1, bucket].
        positions reset at every segment boundary (RoPE sees each
        sequence at its own offsets); segment_ids is the block-diagonal
        attention table (-1 = tail padding); modality_ids marks
        bidirectional modality blocks — tokens of one vision/audio span
        share a nonnegative id unique within the buffer, causal text
        and padding are -1 (the mixed mask lets i attend j>i only
        inside one block); labels are next-token WITHIN each segment —
        the last token of a segment is masked, never predicting across
        a boundary. For span-bearing groups, `loss_mask` is `mask` with
        labels inside bidirectional spans zeroed (those tokens attend
        their own future — training on them is leaky; see
        fill_loss_row) and `modality_classes` is the label token's
        MODALITY_CLASSES index (-1 where no label) for per-modality
        loss reporting.
      cu_seqlens = int32 [n_seqs + 1] cumulative offsets (the standard
        varlen format: segment i spans [cu[i], cu[i+1])). Host-side
        metadata only; it is not shipped to the device.
    """
    total = int(sum(len(s) for s in seqs))
    if total > bucket:
        raise ValueError(f"packed tokens {total} exceed bucket {bucket}")
    if spans is not None and not any(spans):
        spans = None
    tokens = np.full((1, bucket), pad_id, np.int32)
    labels = np.full((1, bucket), pad_id, np.int32)
    mask = np.zeros((1, bucket), np.float32)
    positions = np.zeros((1, bucket), np.int32)
    segment_ids = np.full((1, bucket), -1, np.int32)
    modality_ids = (np.full((1, bucket), -1, np.int32)
                    if spans is not None else None)
    classes = (np.full((1, bucket), -1, np.int32)
               if spans is not None else None)
    cu = np.zeros(len(seqs) + 1, np.int32)
    off = 0
    next_mod = 0
    for i, s in enumerate(seqs):
        L = len(s)
        tokens[0, off:off + L] = s
        if L > 1:
            labels[0, off:off + L - 1] = s[1:]
            mask[0, off:off + L - 1] = 1.0
        positions[0, off:off + L] = np.arange(L, dtype=np.int32)
        segment_ids[0, off:off + L] = i
        if modality_ids is not None:
            next_mod = fill_modality_row(
                modality_ids[0], spans[i], off, L, next_mod)
        off += L
        cu[i + 1] = off
    batch = {"tokens": tokens, "labels": labels, "mask": mask,
             "positions": positions, "segment_ids": segment_ids}
    if modality_ids is not None:
        loss_mask = mask.copy()
        for i in range(len(seqs)):
            fill_loss_row(classes[0], loss_mask[0], spans[i],
                          int(cu[i]), int(cu[i + 1] - cu[i]))
        batch["modality_ids"] = modality_ids
        batch["loss_mask"] = loss_mask
        batch["modality_classes"] = classes
    return batch, cu
