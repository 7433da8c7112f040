"""Synthetic serving traces from the paper's length distributions.

The same dataset profiles that drive training heterogeneity
(core/dataset_profiles.py, paper Fig. 1) generate serving prompts — a
request's "prompt" stands in for a multimodal context whose token count
follows the dataset's long tail, and whose MODALITY LAYOUT follows the
dataset's span convention (interleaved vision frames for OpenVid/
InternVid, an audio-prefix window for MSRVTT). Requests therefore carry
`ModalitySpan`s: the serving scheduler plans chunked prefill against
per-chunk derived eta and masks bidirectional blocks correctly, instead
of treating every prompt as causal text. Output lengths and Poisson
arrivals are drawn independently so a trace exercises both dimensions
continuous batching exploits: ragged prefill cost and ragged decode
lifetimes.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.cost_model import (ATTN_CAUSAL, ModalitySpan, slice_spans,
                               spans_eta)
from ..core.distributions import sample_mm_batch
from .scheduler import ServeRequest


def sample_trace(
    dataset: str,
    n: int,
    rng: np.random.Generator,
    *,
    vocab: int = 1024,
    max_prompt: int = 256,
    min_prompt: int = 4,
    mean_new_tokens: int = 16,
    max_new_tokens: int = 64,
    arrival_rate: Optional[float] = None,
    tokens_per_frame: int = 16,
    deadline_s: Optional[float] = None,
    with_spans: bool = True,
) -> List[ServeRequest]:
    """Draw `n` requests with heterogeneous prompt/output lengths.

    Prompt lengths come from the dataset's duration distribution
    (clipped to [min_prompt, max_prompt]); output lengths are geometric
    with mean `mean_new_tokens` (clipped to max_new_tokens) — the
    classic heavy-tailed decode-lifetime model; arrivals are Poisson
    with `arrival_rate` requests/s (None = everything arrives at t=0,
    the closed-batch case benchmarks use). `with_spans=False` strips
    the modality layout (legacy causal-prompt traces).
    """
    mms = sample_mm_batch(dataset, n, rng, max_tokens=max_prompt,
                          tokens_per_frame=tokens_per_frame)
    arrival = 0.0
    out: List[ServeRequest] = []
    for i, mm in enumerate(mms):
        prompt_len = max(min_prompt, min(mm.length, max_prompt))
        spans = slice_spans(mm.spans, 0, min(prompt_len, mm.length))
        if prompt_len > mm.length:
            # min_prompt padding joins the trailing causal text
            spans = spans + (ModalitySpan(
                "text", mm.length, prompt_len - mm.length, ATTN_CAUSAL),)
        tokens = rng.integers(0, vocab, size=prompt_len, dtype=np.int32)
        new = int(np.clip(rng.geometric(1.0 / max(mean_new_tokens, 1)),
                          1, max_new_tokens))
        if arrival_rate:
            arrival += float(rng.exponential(1.0 / arrival_rate))
        out.append(ServeRequest(
            request_id=i, tokens=tokens, max_new_tokens=new,
            arrival_s=arrival,
            deadline_s=(arrival + deadline_s) if deadline_s else None,
            eta=spans_eta(spans),
            spans=spans if with_spans else None))
    return out
