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
from typing import List, Sequence as Seq

import numpy as np

from .cost_model import CostModel, SeqInfo

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
