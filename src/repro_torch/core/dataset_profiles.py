"""Dataset profiles — the ONE place the paper's evaluated datasets are
described (Fig. 1 duration statistics + modality-layout conventions).

The training-side length/span sampler (core/distributions.py) draws
from this table.

Layouts (how a clip's tokens are arranged into modality spans):
  * "interleaved"  — per-frame bidirectional vision blocks interleaved
                     with causal text (OpenVid / InternVid style
                     frame-caption streams);
  * "audio_prefix" — one bidirectional audio window up front, followed
                     by the causal caption (MSRVTT-style transcription);
  * "prefix"       — same geometry for any modality: one bidirectional
                     block then causal text (image-QA's images-then-
                     question convention).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Union

LAYOUT_INTERLEAVED = "interleaved"
LAYOUT_AUDIO_PREFIX = "audio_prefix"
LAYOUT_PREFIX = "prefix"


@dataclasses.dataclass(frozen=True)
class DatasetProfile:
    """Duration distribution (truncated lognormal, Fig. 1) plus the
    modality-layout convention of one evaluated dataset."""

    name: str
    mu: float        # lognormal mean of log-duration (seconds)
    sigma: float     # lognormal sigma — the long-tail knob
    min_s: float
    max_s: float
    layout: str = LAYOUT_INTERLEAVED
    modality: str = "vision"        # the bidirectional modality
    fps: float = 1.0
    tokens_per_frame: int = 256
    text_tokens: int = 128


MSRVTT = DatasetProfile("msrvtt", mu=math.log(15.0), sigma=0.35,
                        min_s=10, max_s=32,
                        layout=LAYOUT_AUDIO_PREFIX, modality="audio")
INTERNVID = DatasetProfile("internvid", mu=math.log(6.0), sigma=0.8,
                           min_s=1, max_s=128)
OPENVID = DatasetProfile("openvid", mu=math.log(5.0), sigma=1.25,
                         min_s=1, max_s=512)
# Image-QA (LLaVA-Instruct / VQAv2-style): "duration" counts IMAGES —
# mostly single-image turns, occasionally multi-image (<= 4). Each image
# is one bidirectional block of 576 tokens (CLIP ViT-L/14 @ 336px =
# 24x24 patches, the LLaVA-1.5 projector output); ~80 causal text
# tokens of question + answer. The near-degenerate length spread is the
# point: DHP's win case is heterogeneity, and a homogeneous dataset
# must not regress vs static parallelism.
IMAGEQA = DatasetProfile("imageqa", mu=math.log(1.0), sigma=0.4,
                         min_s=1, max_s=4, layout=LAYOUT_PREFIX,
                         modality="vision", fps=1.0,
                         tokens_per_frame=576, text_tokens=80)
# Long-form speech recognition (LibriLight / earnings-call style):
# clips of 30 s .. 15 min, median ~3 min. 25 audio tokens per second
# (Whisper-style encoder: 50 frame/s mel front-end, 2x conv
# downsampling), transcript ~400 causal text tokens. The heavy upper
# tail (sigma 0.7 over minutes-long durations) stresses the allocator's
# high-d_min path the video sets never reach.
LONGAUDIO = DatasetProfile("longaudio", mu=math.log(180.0), sigma=0.7,
                           min_s=30, max_s=900,
                           layout=LAYOUT_AUDIO_PREFIX, modality="audio",
                           fps=1.0, tokens_per_frame=25,
                           text_tokens=400)

PROFILES = {d.name: d for d in (MSRVTT, INTERNVID, OPENVID,
                                IMAGEQA, LONGAUDIO)}


def get_profile(dataset: Union[str, DatasetProfile]) -> DatasetProfile:
    if isinstance(dataset, DatasetProfile):
        return dataset
    if dataset not in PROFILES:
        raise KeyError(
            f"unknown dataset {dataset!r}; known: {sorted(PROFILES)}")
    return PROFILES[dataset]
