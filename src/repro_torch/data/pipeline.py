"""Heterogeneous multimodal data pipeline (synthetic, deterministic).

`HeterogeneousLoader` yields global batches of variable-length
multimodal sequences drawn from the paper's dataset distributions
(core/distributions.py): the DHP planner's input. Its numpy random
stream is the JAX package's draw for draw, so a seed yields the same
batches, bit for bit, in both packages. `padded_batch` pads one group's
sequences to a bucket, one per row (the SSM family's path: its state
crosses segment boundaries, so its sequences cannot be packed).
`synthetic_batch` is the JAX package's fixed-shape batch (tokens,
labels and, for the VLM family, patch embeddings and their positions;
for the audio family, encoder frames), draw for draw.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence as Seq

import numpy as np

from ..configs.base import ModelConfig
from ..core.cost_model import SeqInfo
from ..core.distributions import sample_batch
from ..core.packing import fill_loss_row, fill_modality_row


@dataclasses.dataclass
class RaggedBatch:
    infos: List[SeqInfo]
    tokens: List[np.ndarray]       # per-sequence token ids (int32)

    def by_id(self, seq_id: int) -> np.ndarray:
        return self.tokens[seq_id]

    def spans_by_id(self) -> Dict[int, tuple]:
        """seq_id -> ModalitySpan tuple (only span-bearing sequences)."""
        return {s.seq_id: s.spans for s in self.infos
                if getattr(s, "spans", None)}


class HeterogeneousLoader:
    """Iterator of ragged global batches from a video-length distribution.

    Resumable: `state()` / `set_state()` snapshot and restore the exact
    stream position (rng bit-generator state + batch index), so a
    lookahead planner prefetching batch t+1 sees the same batches a
    synchronous run does.
    """

    def __init__(self, dataset: str, gbs: int, vocab: int, *,
                 seed: int = 0, max_tokens: Optional[int] = None,
                 tokens_per_frame: int = 256):
        self.dataset = dataset
        self.gbs = gbs
        self.vocab = vocab
        self.max_tokens = max_tokens
        self.tokens_per_frame = tokens_per_frame
        self.rng = np.random.default_rng(seed)
        self.batch_index = 0

    def __iter__(self) -> Iterator[RaggedBatch]:
        return self

    def __next__(self) -> RaggedBatch:
        infos = sample_batch(self.dataset, self.gbs, self.rng,
                             max_tokens=self.max_tokens,
                             tokens_per_frame=self.tokens_per_frame)
        toks = [self.rng.integers(0, self.vocab, size=s.length,
                                  dtype=np.int32) for s in infos]
        self.batch_index += 1
        return RaggedBatch(infos=infos, tokens=toks)

    # -- resumability ----------------------------------------------------
    def state(self) -> Dict:
        """JSON-serializable snapshot of the stream position."""
        return {"batch_index": self.batch_index,
                "rng_state": self.rng.bit_generator.state}

    def set_state(self, state: Dict) -> None:
        """Restore a `state()` snapshot; the next `__next__` yields the
        same batch it would have in the original run."""
        self.rng.bit_generator.state = state["rng_state"]
        self.batch_index = int(state["batch_index"])


def padded_batch(seqs: Seq[np.ndarray], bucket: int,
                 pad_id: int = 0,
                 spans: Optional[Seq] = None) -> Dict[str, np.ndarray]:
    """Pad ragged sequences to [n, bucket]: tokens/labels/mask/positions
    + modality_ids / loss_mask / modality_classes when `spans` carries
    any layout (per-row bidirectional-span table, -1 = causal/pad;
    `spans` is a per-sequence list of ModalitySpan tuples, entries may
    be None). The same mixed-mask and loss-mask semantics, and the same
    emit-only-when-present rule, as the packed path (`flatten_group`);
    the JAX package's `padded_batch`, array for array."""
    n = len(seqs)
    if spans is not None and not any(spans):
        spans = None
    tokens = np.full((n, bucket), pad_id, np.int32)
    mask = np.zeros((n, bucket), np.float32)
    modality_ids = (np.full((n, bucket), -1, np.int32)
                    if spans is not None else None)
    classes = (np.full((n, bucket), -1, np.int32)
               if spans is not None else None)
    loss_mask = np.zeros((n, bucket), np.float32) \
        if spans is not None else None
    for i, s in enumerate(seqs):
        L = min(len(s), bucket)
        tokens[i, :L] = s[:L]
        mask[i, :L] = 1.0
        mask[i, L - 1] = 0.0   # last valid token has no next-token label
        if modality_ids is not None:
            fill_modality_row(modality_ids[i], spans[i], 0, L, 0)
            loss_mask[i] = mask[i]
            fill_loss_row(classes[i], loss_mask[i], spans[i], 0, L)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = pad_id
    positions = np.tile(np.arange(bucket, dtype=np.int32), (n, 1))
    batch = {"tokens": tokens, "labels": labels, "mask": mask,
             "positions": positions}
    if modality_ids is not None:
        batch["modality_ids"] = modality_ids
        batch["loss_mask"] = loss_mask
        batch["modality_classes"] = classes
    return batch


def synthetic_batch(cfg: ModelConfig, global_batch: int, seq_len: int,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """Fixed-shape (global_batch, seq_len) batch from `seed` (numpy): the
    JAX package's `synthetic_batch` of an `InputShape` of that batch and
    length, array for array. A VLM batch adds
    `patch_embeds` [B, P, vision_dim] (standard normal) and `patch_pos`
    [B, P] = 0..P-1 in every row, P = max(1, int(S *
    patches_per_seq_frac)); an audio batch adds `frames` [B, F, d_model]
    (standard normal, float32), F = n_audio_frames."""
    rng = np.random.default_rng(seed)
    B, S = global_batch, seq_len
    batch = {
        "tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
    }
    if cfg.family == "vlm":
        P = max(1, int(S * cfg.vlm.patches_per_seq_frac))
        batch["patch_embeds"] = rng.normal(
            0, 1, (B, P, cfg.vlm.vision_dim)).astype(np.float32)
        batch["patch_pos"] = np.tile(np.arange(P, dtype=np.int32), (B, 1))
    if cfg.family == "audio":
        F = cfg.encdec.n_audio_frames
        batch["frames"] = rng.normal(0, 1, (B, F, cfg.d_model)).astype(
            np.float32)
    return batch
