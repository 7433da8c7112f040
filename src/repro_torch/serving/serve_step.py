"""Serving steps: batched one-token decode, and the slot decode of the
continuous-batching runtime.

The JAX package `vmap`s the B=1 decode over a leading slot axis. Here the
slot axis is the cache's batch axis: a slot cache is one
`[L, n_slots, T, Hkv, D]` cache whose `pos` is a `[n_slots]` tensor, so
every slot keeps its own depth, ring-write row `pos % T` and valid
length, and one `decode_step` advances all of them.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..configs.base import ModelConfig
from ..models.model import decode_step, init_cache


def make_serve_step(cfg: ModelConfig):
    def serve_step(params, cache: Dict[str, Any], tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        logits, cache = decode_step(params, cfg, cache, tokens)
        return torch.argmax(logits, dim=-1), cache
    return serve_step


def make_slot_cache(cfg: ModelConfig, n_slots: int, cache_len: int,
                    dtype=None, device="cuda") -> Dict[str, Any]:
    """Physical store of `n_slots` independent decode caches (batch axis
    = slot axis) with one `pos` per slot."""
    cache = init_cache(cfg, n_slots, cache_len, dtype, device=device)
    cache["pos"] = torch.zeros(n_slots, dtype=torch.long, device=device)
    return cache


def make_slot_decode_step(cfg: ModelConfig):
    """One decode iteration over every slot at once: per-slot positions
    and ring writes batch into one step whose shape depends only on
    (n_slots, cache_len). Returns (next_tokens [n_slots], slots), greedy
    argmax applied. Empty slots decode a pad token harmlessly: inserting
    a request resets its slot's rows and pos."""
    step = make_serve_step(cfg)

    def slot_step(params, slots, tokens):
        # tokens: [n_slots, 1] (one token per slot)
        return step(params, slots, tokens[:, 0])
    return slot_step


def write_slot(slots, cache, idx: int):
    """Copy one B=1 request cache (same capacity T) into slot `idx`, in
    place: its K/V rows and its pos."""
    slots["k"][:, idx] = cache["k"][:, 0]
    slots["v"][:, idx] = cache["v"][:, 0]
    slots["pos"][idx] = cache["pos"]
    return slots


def greedy_generate(params, cfg: ModelConfig, cache, first_token,
                    n_tokens: int, step=None):
    """Host-loop generation (the reference the runtime is held to).

    `step`: a prebuilt serve step (default `make_serve_step(cfg)`)."""
    if step is None:
        step = make_serve_step(cfg)
    tok = first_token
    out = []
    for _ in range(n_tokens):
        tok, cache = step(params, cache, tok)
        out.append(tok)
    return torch.stack(out, dim=1), cache
