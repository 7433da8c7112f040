"""Top-level model API: the dense family (training and serving), the SSM
and hybrid families (training).

  init_params(cfg, seed=, device=)               -> params dict
  forward(params, cfg, batch)                    -> (logits [B,S,V], aux)
  forward_hidden(params, cfg, batch)             -> (hidden [B,S,D], aux)
  prefill(params, cfg, batch, cache_len)         -> (last logits, cache)
  prefill_chunk(params, cfg, cache, tokens, pos) -> cache
  init_cache(cfg, batch_size, cache_len, device) -> decode cache
  decode_step(params, cfg, cache, tokens [B])    -> (logits [B,V], cache)

Caches are {"k", "v": [L,B,T,Hkv,D], "pos": int64 tensor}. `pos` is 0-d
for a batch at one depth, or [B] for the serving slot cache, where every
row is its own request at its own depth. Unlike the JAX package, which
returns new caches, `prefill_chunk` and `decode_step` write K/V into the
cache they are given (no second copy of a cache in device memory) and
return it with `pos` advanced. The serving functions take the dense
family only; the SSM family's state cache and decode step come with the
SSM serving slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .attention import (attention, attn_decode, attn_prefill_chunk,
                        project_qkv_decode)
from .layers import (_dtype, apply_rope, dense_init, embed, init_embedding,
                     init_rmsnorm, mlp, rms_norm, unembed)
from .transformer import (_BLOCK, _LAYER_INIT, _attn_kwargs,
                          _dense_block, _init_dense_layer, _init_rec_layer,
                          _rec_block, _rope_frac, hybrid_layout, init_stack,
                          unstack)

#: families `forward` runs
FAMILIES = (*_BLOCK, "hybrid")


def _check_family(cfg: ModelConfig, *, serving: bool = False) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ported: "
            f"{sorted(FAMILIES)}; Engine runs VLM configs as dense)")
    if serving and cfg.family != "dense":
        name = "SSM" if cfg.family == "ssm" else cfg.family
        raise NotImplementedError(
            f"family {cfg.family!r} trains but does not serve yet: its "
            f"state cache and decode step come with the {name} serving "
            f"slice of the port")


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
    if cfg.family != "hybrid":
        params["layers"] = init_stack(gen, cfg, cfg.n_layers,
                                      _LAYER_INIT[cfg.family], device)
        return params
    # hybrid: stacked [n_units] pattern units, then an unstacked tail
    n_units, tail = hybrid_layout(cfg)
    init = {"rec": _init_rec_layer, "attn": _init_dense_layer}
    params["units"] = {
        f"{i}_{kind}": init_stack(gen, cfg, n_units, init[kind], device)
        for i, kind in enumerate(cfg.hybrid.pattern)}
    params["tail"] = {f"{i}_{kind}": init[kind](gen, cfg, device)
                      for i, kind in enumerate(tail)}
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
# Forward (train)
# ==========================================================================
def _table(batch, key, device):
    t = batch.get(key)
    return None if t is None else torch.as_tensor(t, device=device)


def forward(params, cfg: ModelConfig, batch,
            mode: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward -> (logits [B,S,V] in the param dtype, aux loss): the
    final hidden states of `forward_hidden` through the head."""
    x, aux = forward_hidden(params, cfg, batch, mode)
    return _head(params, cfg, x), aux


def forward_hidden(params, cfg: ModelConfig, batch,
                   mode: Optional[str] = None, ring=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward up to the head -> (hidden [B,S,d_model], aux loss). `batch`
    holds `tokens` and optionally `positions` (per-segment positions of a
    packed buffer), `segment_ids` (the packed block-diagonal table, -1 =
    tail padding) and `modality_ids` (the mixed-mask table of
    bidirectional blocks, -1 = causal), as `core/packing.flatten_group`
    emits them; the SSM family and the hybrid's recurrent layers ignore
    the tables (one sequence per row). Differentiable; layers run in a
    Python loop over the unstacked parameters. With `cfg.remat` each
    layer (each pattern unit of the hybrid family, whose tail is not
    checkpointed) keeps only its input for the backward and is run again
    there (`torch.utils.checkpoint`), as the JAX package wraps each scan
    step in `jax.checkpoint`.

    With a `ring` (parallel/ring_attention.Ring; the dense family only)
    the batch's rows are the ring's contiguous shards of one packed
    buffer and every attention layer runs ring context parallelism, as
    the JAX package's `cp_axis` does; the other layers are per token."""
    _check_family(cfg)
    if ring is not None and cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} does not run on a ring: its recurrent "
            f"state crosses shard borders, and the JAX reference restarts "
            f"it from zero on every shard")
    x = _input_embeddings(params, cfg, batch)
    attn_mode = mode or ("sliding" if cfg.sliding_window else "causal")
    tables = dict(positions=_table(batch, "positions", x.device),
                  segment_ids=_table(batch, "segment_ids", x.device),
                  span_ids=_table(batch, "modality_ids", x.device))
    if cfg.family == "hybrid":
        block, stacked, kw = _hybrid_block, params["units"], tables
    else:
        block, stacked = _BLOCK[cfg.family], params["layers"]
        kw = dict(mode=attn_mode, window=cfg.sliding_window, ring=ring,
                  **tables)
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p in unstack(stacked):
        if remat:
            x, a = checkpoint(block, p, x, cfg, use_reentrant=False, **kw)
        else:
            x, a = block(p, x, cfg, **kw)
        aux = aux + a
    if cfg.family == "hybrid":
        x, a = _hybrid_block(params["tail"], x, cfg, **kw)
        aux = aux + a
    return x, aux


def _hybrid_block(p_unit, x, cfg: ModelConfig, positions=None,
                  segment_ids=None, span_ids=None):
    """One pattern unit (or the tail) of the hybrid family, its layers in
    sorted-key order ("0_rec", "1_rec", "2_attn"); attention layers run
    sliding at the hybrid window."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for name in sorted(p_unit):
        if name.split("_")[1] == "rec":
            x, a = _rec_block(p_unit[name], x, cfg)
        else:
            x, a = _dense_block(p_unit[name], x, cfg, mode="sliding",
                                window=cfg.hybrid.window,
                                positions=positions,
                                segment_ids=segment_ids, span_ids=span_ids)
        aux = aux + a
    return x, aux


# ==========================================================================
# Serving prefill: last-token logits + filled KV cache
# ==========================================================================
@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch,
            cache_len: Optional[int] = None):
    """Returns (last_logits [B,1,V], cache). Sliding-window archs keep a
    ring buffer holding the final `window` positions (slot p % W);
    full-attention caches are padded to `cache_len` capacity."""
    _check_family(cfg, serving=True)
    x = _input_embeddings(params, cfg, batch)
    B, S, _ = x.shape
    positions = batch.get("positions")
    if positions is not None:
        positions = torch.as_tensor(positions, device=x.device)
    mode = "sliding" if cfg.sliding_window else "causal"
    kw = _attn_kwargs(cfg, mode, cfg.sliding_window)
    ks, vs = [], []
    for p in unstack(params["layers"]):
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
    _check_family(cfg, serving=True)
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
    for i, p in enumerate(unstack(params["layers"])):
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
    _check_family(cfg, serving=True)
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
    _check_family(cfg, serving=True)
    tokens = torch.as_tensor(tokens,
                             device=params["embed"].device).long()
    B = tokens.shape[0]
    pos = cache["pos"]
    pos_b = pos.expand(B) if pos.dim() == 0 else pos
    x1 = embed(params["embed"], tokens)
    for i, p in enumerate(unstack(params["layers"])):
        x1 = _dense_decode_layer(p, x1, cache["k"][i], cache["v"][i],
                                 pos_b, cfg)
    logits = _head(params, cfg, x1)
    return logits, {**cache, "pos": pos + 1}
