"""Synthetic multimodal sequence sampling (paper Fig. 1).

Duration statistics live in core/dataset_profiles.py; this module turns
sampled durations into STRUCTURED multimodal sequences:

  tokens = duration * fps * tokens_per_frame  (vision, bidirectional)
         + text_tokens                        (caption, causal)

`sample_mm_batch` lays the tokens out as `ModalitySpan`s per the
dataset's layout convention — interleaved frame/text blocks for
OpenVid/InternVid, an audio-prefix window for MSRVTT — and returns
`MMSequence`s; Eq. 8's eta is derived from that span geometry.
`sample_batch` returns the `SeqInfo` view (spans attached). The numpy
draws are the JAX package's, in the same order, so one seed gives the
same batches in both packages.
"""
from __future__ import annotations

from typing import List, Optional, Union

import numpy as np

from .cost_model import (ATTN_BIDIRECTIONAL, ATTN_CAUSAL, MMSequence,
                         ModalitySpan, SeqInfo)
from .dataset_profiles import (LAYOUT_AUDIO_PREFIX, LAYOUT_INTERLEAVED,
                               LAYOUT_PREFIX, DatasetProfile, get_profile)


def _layout_spans(profile: DatasetProfile, vis: int, text: int,
                  tokens_per_frame: int) -> tuple:
    """Arrange `vis` bidirectional + `text` causal tokens per the
    dataset's layout convention. Always ends on a causal span when any
    text exists (the trailing caption), so next-token prediction has a
    causal tail."""
    spans: List[ModalitySpan] = []
    start = 0

    def add(mod: str, ln: int, attn: str):
        nonlocal start
        if ln > 0:
            spans.append(ModalitySpan(mod, start, ln, attn))
            start += ln

    if (profile.layout in (LAYOUT_AUDIO_PREFIX, LAYOUT_PREFIX)
            or vis == 0 or text == 0):
        add(profile.modality, vis, ATTN_BIDIRECTIONAL)
        add("text", text, ATTN_CAUSAL)
        return tuple(spans)
    if profile.layout != LAYOUT_INTERLEAVED:
        raise ValueError(f"unknown layout {profile.layout!r}")
    frames: List[int] = []
    left = vis
    while left > 0:
        m = min(tokens_per_frame, left)
        frames.append(m)
        left -= m
    # text split across the k+1 slots around the frames; the remainder
    # lands on the LAST slot so the stream ends with the caption
    base, rem = divmod(text, len(frames) + 1)
    for f in frames:
        add("text", base, ATTN_CAUSAL)
        add(profile.modality, f, ATTN_BIDIRECTIONAL)
    add("text", base + rem, ATTN_CAUSAL)
    return tuple(spans)


def sample_mm_batch(
    dataset: Union[str, DatasetProfile],
    n: int,
    rng: np.random.Generator,
    *,
    fps: Optional[float] = None,
    tokens_per_frame: Optional[int] = None,
    text_tokens: Optional[int] = None,
    max_tokens: Optional[int] = None,
) -> List[MMSequence]:
    """Draw a global batch of n structured multimodal sequences."""
    ds = get_profile(dataset)
    fps = ds.fps if fps is None else fps
    tokens_per_frame = (ds.tokens_per_frame if tokens_per_frame is None
                        else tokens_per_frame)
    text_tokens = ds.text_tokens if text_tokens is None else text_tokens
    dur = rng.lognormal(ds.mu, ds.sigma, size=n)
    dur = np.clip(dur, ds.min_s, ds.max_s)
    out: List[MMSequence] = []
    for i, t in enumerate(dur):
        vis = int(t * fps) * tokens_per_frame
        total = vis + text_tokens
        if max_tokens is not None:
            total = min(total, max_tokens)
            vis = min(vis, total - 1)
        spans = _layout_spans(ds, vis, total - vis, tokens_per_frame)
        out.append(MMSequence(spans=spans, seq_id=i))
    return out


def sample_batch(
    dataset: Union[str, DatasetProfile],
    n: int,
    rng: np.random.Generator,
    *,
    fps: Optional[float] = None,
    tokens_per_frame: Optional[int] = None,
    text_tokens: Optional[int] = None,
    max_tokens: Optional[int] = None,
) -> List[SeqInfo]:
    """The same batch as `sample_mm_batch`, as SeqInfos (spans attached,
    eta derived from the span geometry)."""
    return [m.seq_info for m in sample_mm_batch(
        dataset, n, rng, fps=fps, tokens_per_frame=tokens_per_frame,
        text_tokens=text_tokens, max_tokens=max_tokens)]
