"""Top-level model API, dense path (the serving slice).

  init_params(cfg, seed=, device=)               -> params dict
  prefill(params, cfg, batch, cache_len)         -> (last logits, cache)
  prefill_chunk(params, cfg, cache, tokens, pos) -> cache
  init_cache(cfg, batch_size, cache_len, device) -> decode cache
  decode_step(params, cfg, cache, tokens [B])    -> (logits [B,V], cache)

Caches are {"k", "v": [L,B,T,Hkv,D], "pos": int64 tensor}. `pos` is 0-d
for a batch at one depth, or [B] for the serving slot cache, where every
row is its own request at its own depth. Unlike the JAX package, which
returns new caches, `prefill_chunk` and `decode_step` write K/V into the
cache they are given (no second copy of a cache in device memory) and
return it with `pos` advanced.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ModelConfig
from .attention import (attention, attn_decode, attn_prefill_chunk,
                        project_qkv_decode)
from .layers import (_dtype, apply_rope, dense_init, embed, init_embedding,
                     init_rmsnorm, mlp, rms_norm, unembed)
from .transformer import (_attn_kwargs, _init_dense_layer, _rope_frac,
                          init_stack, layer, n_stacked)


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (dense only; Engine "
            f"runs VLM configs as dense)")


# ==========================================================================
# Init
# ==========================================================================
def init_params(cfg: ModelConfig, *, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Random parameters drawn from a `torch.Generator` seeded with
    `seed` on `device`, keyed and laid out as the JAX package's
    `init_params` (the numbers differ: the generators differ)."""
    _check_family(cfg)
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = _dtype(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": init_embedding(gen, cfg.vocab, cfg.d_model, dt, device),
        "ln_f": init_rmsnorm(cfg.d_model, dt, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = dense_init(gen, cfg.d_model, cfg.vocab, dt, device)
    params["layers"] = init_stack(gen, cfg, cfg.n_layers,
                                  _init_dense_layer, device)
    return params


# ==========================================================================
# Embedding / head
# ==========================================================================
def _input_embeddings(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Token embeddings (the dense family's text stream)."""
    tokens = torch.as_tensor(batch["tokens"],
                             device=params["embed"].device).long()
    return embed(params["embed"], tokens)


def _head(params, cfg: ModelConfig, x) -> torch.Tensor:
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x, tied=True)
    return unembed(params["head"], x, tied=False)


# ==========================================================================
# Serving prefill: last-token logits + filled KV cache
# ==========================================================================
@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch,
            cache_len: Optional[int] = None):
    """Returns (last_logits [B,1,V], cache). Sliding-window archs keep a
    ring buffer holding the final `window` positions (slot p % W);
    full-attention caches are padded to `cache_len` capacity."""
    _check_family(cfg)
    x = _input_embeddings(params, cfg, batch)
    B, S, _ = x.shape
    positions = batch.get("positions")
    if positions is not None:
        positions = torch.as_tensor(positions, device=x.device)
    mode = "sliding" if cfg.sliding_window else "causal"
    kw = _attn_kwargs(cfg, mode, cfg.sliding_window)
    stack = params["layers"]
    ks, vs = [], []
    for i in range(n_stacked(stack)):
        p = layer(stack, i)
        g = rms_norm(p["ln1"], x, cfg.norm_eps)
        o, (k, v) = attention(p["attn"], g, positions=positions,
                              return_kv=True, **kw)
        x = x + o
        g = rms_norm(p["ln2"], x, cfg.norm_eps)
        x = x + mlp(p["mlp"], g, cfg.activation)
        ks.append(k)
        vs.append(v)
    logits = _head(params, cfg, x[:, -1:])

    W = cfg.sliding_window
    if W is not None and W < S:
        # keep last W positions, rotated so slot(p) = p % W
        ck = torch.roll(torch.stack(ks)[:, :, S - W:], (S - W) % W, dims=2)
        cv = torch.roll(torch.stack(vs)[:, :, S - W:], (S - W) % W, dims=2)
    else:
        T = max(cache_len or S, S)
        shape = (len(ks), B, T) + tuple(ks[0].shape[2:])
        ck = torch.zeros(shape, dtype=ks[0].dtype, device=x.device)
        cv = torch.zeros(shape, dtype=vs[0].dtype, device=x.device)
        for i, (k, v) in enumerate(zip(ks, vs)):
            ck[i, :, :S] = k
            cv[i, :, :S] = v
    pos = torch.tensor(S, dtype=torch.long, device=x.device)
    return logits, {"k": ck, "v": cv, "pos": pos}


@torch.no_grad()
def prefill_chunk(params, cfg: ModelConfig, cache: Dict[str, Any],
                  tokens, start_pos: int, span_ids=None,
                  cache_span_ids=None) -> Dict[str, Any]:
    """Extend a full-attention KV cache by one prompt chunk.

    `tokens` [B, C] are prompt positions start_pos..start_pos+C-1; their
    K/V are written into cache rows [start_pos, start_pos+C) and each
    chunk token attends causally over everything written so far. Rows of
    a bucketed final chunk past the cache capacity are DROPPED (not
    clamped or wrapped), so earlier rows are never overwritten.

    `span_ids` [B,C] / `cache_span_ids` [B,T] (-1 = causal) switch on the
    mixed modality mask (see attn_prefill_chunk). Needs a non-sliding
    cache. Writes into `cache` and returns it with pos = start_pos + C.
    """
    _check_family(cfg)
    if cfg.sliding_window is not None:
        raise ValueError("chunked prefill needs a non-rotating cache")
    start_pos = int(start_pos)
    x = _input_embeddings(params, cfg, {"tokens": tokens})
    B, C, _ = x.shape
    hd = cfg.resolved_head_dim
    rope_frac = _rope_frac(cfg)
    positions = start_pos + torch.arange(C, device=x.device)[None, :]
    T = cache["k"].shape[2]
    n_write = max(0, min(C, T - start_pos))      # drop-mode scatter
    stack = params["layers"]
    for i in range(n_stacked(stack)):
        p = layer(stack, i)
        ck, cv = cache["k"][i], cache["v"][i]      # [B,T,Hkv,D] views
        g = rms_norm(p["ln1"], x, cfg.norm_eps)
        q = (g @ p["attn"]["wq"]).reshape(B, C, cfg.n_heads, hd)
        k = (g @ p["attn"]["wk"]).reshape(B, C, cfg.kv_heads, hd)
        v = (g @ p["attn"]["wv"]).reshape(B, C, cfg.kv_heads, hd)
        q = apply_rope(q, positions, cfg.rope_theta, rope_frac)
        k = apply_rope(k, positions, cfg.rope_theta, rope_frac)
        ck[:, start_pos:start_pos + n_write] = k[:, :n_write]
        cv[:, start_pos:start_pos + n_write] = v[:, :n_write]
        o = attn_prefill_chunk(q, ck, cv, start_pos,
                               chunk_span_ids=span_ids,
                               cache_span_ids=cache_span_ids)
        x = x + o.reshape(B, C, -1) @ p["attn"]["wo"]
        g = rms_norm(p["ln2"], x, cfg.norm_eps)
        x = x + mlp(p["mlp"], g, cfg.activation)
    pos = torch.tensor(start_pos + C, dtype=torch.long, device=x.device)
    return {**cache, "pos": pos}


# ==========================================================================
# Decode caches
# ==========================================================================
def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               device="cuda") -> Dict[str, Any]:
    """cache_len = context capacity; sliding-window archs allocate only
    min(window, cache_len) slots (ring buffer)."""
    _check_family(cfg)
    dt = dtype or _dtype(cfg.param_dtype)
    T = min(cfg.sliding_window or cache_len, cache_len)
    shape = (cfg.n_layers, batch, T, cfg.kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.zeros((), dtype=torch.long, device=device)}


# ==========================================================================
# Decode step
# ==========================================================================
def _dense_decode_layer(p, x1, ck, cv, pos, cfg: ModelConfig):
    """x1 [B,d]; ck/cv [B,T,Hkv,D] (written in place); pos [B]."""
    B = x1.shape[0]
    h = rms_norm(p["ln1"], x1, cfg.norm_eps)
    q, k1, v1 = project_qkv_decode(
        p["attn"], h, n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        position=pos, rope_frac=_rope_frac(cfg))
    T = ck.shape[1]
    rows = torch.arange(B, device=x1.device)
    slot = pos % T                                  # ring-buffer row
    ck[rows, slot] = k1[:, 0].to(ck.dtype)
    cv[rows, slot] = v1[:, 0].to(cv.dtype)
    o = attn_decode(q, ck, cv, torch.clamp(pos + 1, max=T))
    x1 = x1 + o.reshape(B, -1) @ p["attn"]["wo"]
    h = rms_norm(p["ln2"], x1, cfg.norm_eps)
    return x1 + mlp(p["mlp"], h, cfg.activation)


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, cache: Dict[str, Any],
                tokens) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens: [B] -> (logits [B,V], cache with pos + 1)."""
    _check_family(cfg)
    tokens = torch.as_tensor(tokens,
                             device=params["embed"].device).long()
    B = tokens.shape[0]
    pos = cache["pos"]
    pos_b = pos.expand(B) if pos.dim() == 0 else pos
    x1 = embed(params["embed"], tokens)
    stack = params["layers"]
    for i in range(n_stacked(stack)):
        x1 = _dense_decode_layer(layer(stack, i), x1, cache["k"][i],
                                 cache["v"][i], pos_b, cfg)
    logits = _head(params, cfg, x1)
    return logits, {**cache, "pos": pos + 1}
