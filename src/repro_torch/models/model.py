"""Top-level model API: the dense, VLM, MoE, SSM, hybrid and audio
families, training and serving (audio trains through
`training.train_step.make_train_step`, not the DHP executor).

  init_params(cfg, seed=, device=)               -> params dict
  forward(params, cfg, batch)                    -> (logits [B,S,V], aux)
  forward_hidden(params, cfg, batch)             -> (hidden [B,S,D], aux)
  prefill(params, cfg, batch, cache_len)         -> (last logits, cache)
  prefill_chunk(params, cfg, cache, tokens, pos) -> cache
  init_cache(cfg, batch_size, cache_len, device) -> decode cache
  prefill_cross_kv(params, cfg, frames, cache)   -> cache (audio)
  decode_step(params, cfg, cache, tokens [B])    -> (logits [B,V], cache)

A VLM batch holds `patch_embeds` [B,P,vision_dim] and `patch_pos`
[B,P] beside its tokens: `connector` projects the patches, which take
the place of the token embeddings at those rows (`forward`, `prefill`);
otherwise the VLM family is the dense one. An audio batch holds `frames`
[B,F,d_model] (the conv frontend's output, stubbed) beside its tokens:
whisper's encoder runs full attention over the frames, and each decoder
layer attends causally over the tokens and fully over the encoder's
output (`forward`; in serving, `prefill_cross_kv` runs the encoder once
and stores each layer's cross K/V in the cache). `prefill_chunk` and
`decode_step` take tokens only, as the JAX package's do (its
`prefill_chunk` then fails on a VLM config for want of patches; the
port's embeds the tokens alone).

Caches hold `pos`, an int64 tensor: 0-d for a batch at one depth, or [B]
for the serving slot cache, where every row is its own request at its
own depth. Their other leaves, by family (`cache_batch_axes` names each
one's batch axis):

  dense, vlm, moe — k, v [L,B,T,Hkv,D], T = min(sliding_window,
                    cache_len)
  ssm    — h [L,B,H,N,P] fp32, conv_buf [L,B,conv_width-1,d_inner+2N]
  hybrid — rec_h [U,R,B,W] fp32, rec_conv [U,R,B,conv_width-1,W],
           k, v [U,A,B,T,Hkv,D] (a ring of T = min(window, cache_len)),
           tail_h [max(Rt,1),B,W] fp32, tail_conv [max(Rt,1),B,cw-1,W]
  audio  — k, v [L,B,T,Hkv,D] (the decoder's self-attention), cross_k,
           cross_v [L,B,F,Hkv,D] (F frames; `prefill_cross_kv` replaces
           them with the encoder's, in the dtype it computed in)

(U pattern units of R recurrent and A attention layers, Rt recurrent
layers in the tail.) Unlike the JAX package, which returns new caches,
`prefill_chunk` and `decode_step` write into the cache they are given
(no second copy of a cache in device memory) and return it with `pos`
advanced. `prefill` and `prefill_chunk` take the attention families
(dense, vlm, moe) only, as the JAX package's do: the SSM, hybrid and
audio families serve from a fresh `init_cache` (audio's with its cross
K/V) and the prompt's last token, through `decode_step`.

The audio encoder runs in the frames' dtype where that is the wider
one, as the reference promotes `frames.astype(param_dtype) +
sinusoidal(...).astype(frames.dtype)`: fp32 frames make an fp32 encoder
(its weights, and the cross projections', cast to fp32 a layer at a
time, as the reference's matmuls promote them) and fp32 cross K/V,
which the decoder's bf16 queries attend at fp32.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from .attention import (attention, attn_decode, attn_prefill_chunk,
                        project_qkv_decode)
from .layers import (_dtype, apply_rope, dense_init, embed, init_embedding,
                     init_layernorm, init_rmsnorm, layer_norm, mlp, rms_norm,
                     unembed)
from .rglru import rglru_decode_step
from .ssm import ssm_decode_step
from .transformer import (_BLOCK, _LAYER_INIT, _attn_kwargs,
                          _dense_block, _init_dense_layer, _init_enc_layer,
                          _init_encdec_layer, _init_rec_layer, _rec_block,
                          _rope_frac, ffn, hybrid_layout, init_stack,
                          unstack)

#: families `forward` runs
FAMILIES = (*_BLOCK, "hybrid", "audio")
#: families that fill a K/V cache from the prompt (`prefill`)
PREFILL_FAMILIES = ("dense", "vlm", "moe")


def _check_family(cfg: ModelConfig, *, prefill: bool = False) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ported: "
            f"{sorted(FAMILIES)})")
    if prefill and cfg.family not in PREFILL_FAMILIES:
        name = "SSM" if cfg.family == "ssm" else cfg.family
        fresh = ("a fresh init_cache with the encoder's cross K/V "
                 "(prefill_cross_kv)" if cfg.family == "audio"
                 else "a fresh init_cache")
        raise NotImplementedError(
            f"family {cfg.family!r} has no prefill: {name} serving starts "
            f"each request from {fresh} and decodes from the prompt's last "
            f"token, as the JAX package's runtime does (its prefill takes "
            f"the attention families only)")


# ==========================================================================
# Sinusoidal positions (whisper: no RoPE)
# ==========================================================================
def _sinusoidal_at(pos, dim: int) -> torch.Tensor:
    """`sinusoidal`'s row at each position: a scalar `pos` gives [dim],
    a [B] tensor (the slot cache's one depth a row) gives [B, dim]."""
    pos = torch.as_tensor(pos)
    # the reference's fp32 log(10000) / dim, formed on the host
    scale = (torch.log(torch.tensor(10_000.0)) / dim).item()
    inv = torch.exp(-torch.arange(0, dim, 2, dtype=torch.float32,
                                  device=pos.device) * scale)
    ang = pos.float()[..., None] * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)[..., :dim]


def sinusoidal(seq: int, dim: int, device=None) -> torch.Tensor:
    """[seq, dim] fp32 absolute positions: sin of position x 10000^(-2i
    / dim) in the first half, cos in the second."""
    return _sinusoidal_at(torch.arange(seq, device=device), dim)


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
    if cfg.family == "audio":
        params["enc_layers"] = init_stack(gen, cfg, cfg.encdec.n_enc_layers,
                                          _init_enc_layer, device)
        params["ln_enc"] = init_layernorm(cfg.d_model, dt, device)
        params["dec_layers"] = init_stack(gen, cfg, cfg.n_layers,
                                          _init_encdec_layer, device)
        return params
    if cfg.family != "hybrid":
        params["layers"] = init_stack(gen, cfg, cfg.n_layers,
                                      _LAYER_INIT[cfg.family], device)
        if cfg.family == "vlm":
            params["connector"] = dense_init(gen, cfg.vlm.vision_dim,
                                             cfg.d_model, dt, device)
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
def _token_embeddings(params, tokens) -> torch.Tensor:
    dev = params["embed"].device
    return embed(params["embed"], torch.as_tensor(tokens, device=dev).long())


def _input_embeddings(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Token embeddings; for the VLM family `patch_embeds` [B,P,
    vision_dim] (required, as in the JAX package) through `connector`,
    written over rows `patch_pos` [B,P] of each sequence (the JAX
    package's `vmap` of `.at[pos].set`; out of place, so gradients reach
    both)."""
    dev = params["embed"].device
    x = _token_embeddings(params, batch["tokens"])
    if cfg.family == "vlm":
        patches = torch.as_tensor(batch["patch_embeds"], device=dev)
        proj = patches.to(x.dtype) @ params["connector"]
        pos = torch.as_tensor(batch["patch_pos"], device=dev).long()
        rows = torch.arange(x.shape[0], device=dev)[:, None]
        x = x.index_put((rows, pos), proj)
    return x


def _head(params, cfg: ModelConfig, x) -> torch.Tensor:
    x = rms_norm(params["ln_f"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x, tied=True)
    return unembed(params["head"], x, tied=False)


def position_nll(logits, labels) -> torch.Tensor:
    """Per-position next-token NLL in fp32 over the whole vocabulary (no
    mask): the logsumexp minus the gold logit. A gather gives the gold
    logit the reference takes with a one-hot multiply-reduce (which
    exists there for GSPMD); the number is the same, and at whisper-
    small's [8, 448, 51865] logits a one-hot would be 743 MB more."""
    logits = logits.float()
    labels = torch.as_tensor(labels, device=logits.device).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return logz - gold


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

    With a `ring` (parallel/ring_attention.Ring; the dense and VLM
    families) the batch's rows are the ring's shards of one packed
    buffer, in the ring's layout (contiguous, or striped with
    `ring.striped`; the tables and `positions` laid out the same way),
    and every attention layer runs ring context parallelism, as the JAX
    package's `cp_axis` does; the other layers are per token."""
    _check_family(cfg)
    if ring is not None and cfg.family == "moe":
        raise NotImplementedError(
            "the MoE family does not run on a ring yet: the reference "
            "routes each CP shard's rows as their own set, with a capacity "
            "a shard, and its own executor cannot run the family under "
            "shard_map (the aux loss in its layer scan's carry varies over "
            "the shards where the carry's initial zero does not), so there "
            "is no reference to hold a degree > 1 to")
    if ring is not None and cfg.family == "audio":
        raise NotImplementedError(
            "the audio family does not run on a ring: the reference's ring "
            "takes self-attention only")
    if ring is not None and cfg.family not in ("dense", "vlm"):
        raise NotImplementedError(
            f"family {cfg.family!r} does not run on a ring: its recurrent "
            f"state crosses shard borders, and the JAX reference restarts "
            f"it from zero on every shard")
    if cfg.family == "audio":
        return _forward_audio(params, cfg, batch)
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


def _enc_block(p, h, cfg: ModelConfig):
    """One whisper encoder layer: full self-attention, GELU MLP."""
    g = layer_norm(p["ln1"], h, cfg.norm_eps)
    h = h + attention(p["attn"], g, **_attn_kwargs(cfg, "full"))
    g = layer_norm(p["ln2"], h, cfg.norm_eps)
    return h + mlp(p["mlp"], g, "gelu")


def _encode(params, cfg: ModelConfig, frames) -> torch.Tensor:
    """The encoder over `frames` [B,F,d_model] -> [B,F,d_model], in the
    wider of the frames' and the parameters' dtypes (see the module
    docstring)."""
    dev = params["embed"].device
    frames = torch.as_tensor(frames, device=dev)
    F = frames.shape[1]
    enc = frames.to(_dtype(cfg.param_dtype)) \
        + sinusoidal(F, cfg.d_model, dev).to(frames.dtype)
    for p in unstack(params["enc_layers"]):
        enc = _enc_block(_as_dtype(p, enc.dtype), enc, cfg)
    return layer_norm(params["ln_enc"], enc, cfg.norm_eps)


def _as_dtype(tree, dtype):
    """`tree`'s tensors in `dtype` (the same tensors where they are in
    it already)."""
    if isinstance(tree, dict):
        return {k: _as_dtype(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def _cross_kv(p_x, enc, cfg: ModelConfig):
    """One decoder layer's cross K/V [B,F,Hkv,D] from the encoder's
    output, in its dtype."""
    B, F, _ = enc.shape
    shape = (B, F, cfg.kv_heads, cfg.resolved_head_dim)
    return ((enc @ p_x["wk"].to(enc.dtype)).reshape(shape),
            (enc @ p_x["wv"].to(enc.dtype)).reshape(shape))


def _dec_block(p, h, cfg: ModelConfig, enc):
    """One whisper decoder layer: causal self-attention, cross-attention
    over `enc`, GELU MLP."""
    g = layer_norm(p["ln1"], h, cfg.norm_eps)
    h = h + attention(p["attn"], g, **_attn_kwargs(cfg, "causal"))
    g = layer_norm(p["ln_x"], h, cfg.norm_eps)
    h = h + attention(p["xattn"], g, cross_kv=_cross_kv(p["xattn"], enc, cfg),
                      **_attn_kwargs(cfg, "full"))
    g = layer_norm(p["ln2"], h, cfg.norm_eps)
    return h + mlp(p["mlp"], g, "gelu")


def _forward_audio(params, cfg: ModelConfig, batch):
    """Whisper: the encoder over `batch["frames"]`, then the decoder over
    `batch["tokens"]` at sinusoidal positions -> (hidden, aux 0).
    Differentiable: under autograd the encoder's full self-attention and
    the cross-attention run K1 (fp32 from fp32 frames), the decoder's
    causal self-attention K1 in the parameters' dtype; gradients reach
    bf16 leaves through the encoder's per-layer casts. No remat:
    whisper-small's step at 8 x 448 tokens over 1500 frames fits the card
    without it."""
    enc = _encode(params, cfg, batch["frames"])
    x = _token_embeddings(params, batch["tokens"])
    x = x + sinusoidal(x.shape[1], cfg.d_model, x.device).to(x.dtype)
    for p in unstack(params["dec_layers"]):
        x = _dec_block(p, x, cfg, enc)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ==========================================================================
# Serving prefill: last-token logits + filled KV cache
# ==========================================================================
@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch,
            cache_len: Optional[int] = None):
    """Returns (last_logits [B,1,V], cache). Sliding-window archs keep a
    ring buffer holding the final `window` positions (slot p % W);
    full-attention caches are padded to `cache_len` capacity."""
    _check_family(cfg, prefill=True)
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
        x = x + ffn(p, g, cfg)[0]
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
    _check_family(cfg, prefill=True)
    if cfg.sliding_window is not None:
        raise ValueError("chunked prefill needs a non-rotating cache")
    start_pos = int(start_pos)
    x = _token_embeddings(params, tokens)      # a chunk holds no patches
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
        x = x + ffn(p, g, cfg)[0]
    pos = torch.tensor(start_pos + C, dtype=torch.long, device=x.device)
    return {**cache, "pos": pos}


# ==========================================================================
# Decode caches
# ==========================================================================
def init_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype=None,
               device="cuda") -> Dict[str, Any]:
    """Zero decode cache of `batch` rows at context capacity `cache_len`
    (leaves in the module docstring). Sliding-window attention allocates
    only min(window, cache_len) rows (ring buffer); recurrent state is
    fp32, K/V and conv buffers are in `dtype` (the parameters')."""
    _check_family(cfg)
    dt = dtype or _dtype(cfg.param_dtype)
    kw = dict(dtype=dt, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    cache = {"pos": torch.zeros((), dtype=torch.long, device=device)}
    if cfg.family in (*PREFILL_FAMILIES, "audio"):
        T = min(cfg.sliding_window or cache_len, cache_len)
        shape = (cfg.n_layers, batch, T, cfg.kv_heads,
                 cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, **kw)
        cache["v"] = torch.zeros(shape, **kw)
        if cfg.family == "audio":
            shape = shape[:2] + (cfg.encdec.n_audio_frames,) + shape[3:]
            cache["cross_k"] = torch.zeros(shape, **kw)
            cache["cross_v"] = torch.zeros(shape, **kw)
    elif cfg.family == "ssm":
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        L = cfg.n_layers
        cache["h"] = torch.zeros(L, batch, d_inner // s.head_dim,
                                 s.d_state, s.head_dim, **f32)
        cache["conv_buf"] = torch.zeros(
            L, batch, s.conv_width - 1, d_inner + 2 * s.d_state, **kw)
    else:
        n_units, tail = hybrid_layout(cfg)
        h = cfg.hybrid
        W = h.lru_width or cfg.d_model
        n_rec = sum(k == "rec" for k in h.pattern)
        n_attn = sum(k == "attn" for k in h.pattern)
        n_tail = max(sum(k == "rec" for k in tail), 1)
        T = min(h.window, cache_len)
        cache["rec_h"] = torch.zeros(n_units, n_rec, batch, W, **f32)
        cache["rec_conv"] = torch.zeros(n_units, n_rec, batch,
                                        h.conv_width - 1, W, **kw)
        shape = (n_units, n_attn, batch, T, cfg.kv_heads,
                 cfg.resolved_head_dim)
        cache["k"] = torch.zeros(shape, **kw)
        cache["v"] = torch.zeros(shape, **kw)
        cache["tail_h"] = torch.zeros(n_tail, batch, W, **f32)
        cache["tail_conv"] = torch.zeros(n_tail, batch, h.conv_width - 1,
                                         W, **kw)
    return cache


def cache_batch_axes(cfg: ModelConfig) -> Dict[str, int]:
    """The batch axis of every leaf of `init_cache(cfg, ...)` but `pos`:
    1, behind the layer axis, except where the hybrid's leaves stack
    [unit, layer in the unit]."""
    if cfg.family == "hybrid":
        return {"rec_h": 2, "rec_conv": 2, "k": 2, "v": 2, "tail_h": 1,
                "tail_conv": 1}
    if cfg.family == "ssm":
        return {"h": 1, "conv_buf": 1}
    if cfg.family == "audio":
        return {"k": 1, "v": 1, "cross_k": 1, "cross_v": 1}
    return {"k": 1, "v": 1}


@torch.no_grad()
def prefill_cross_kv(params, cfg: ModelConfig, frames,
                     cache: Dict[str, Any]) -> Dict[str, Any]:
    """Audio: run the encoder once over `frames` [B,F,d_model] and
    return `cache` with every decoder layer's cross K/V in place of its
    `cross_k` / `cross_v`, in the dtype the encoder computed in (fp32
    for fp32 frames, as the reference's)."""
    enc = _encode(params, cfg, frames)
    ks, vs = zip(*(_cross_kv(p["xattn"], enc, cfg)
                   for p in unstack(params["dec_layers"])))
    return {**cache, "cross_k": torch.stack(ks), "cross_v": torch.stack(vs)}


def serving_frames(cfg: ModelConfig, batch: int, seed: int,
                   device) -> torch.Tensor:
    """The frames audio serving encodes when a request brings none:
    [batch, F, d_model] fp32 standard normal from a `torch.Generator`
    on `device` seeded with `seed + 2`, as the reference draws them
    from `PRNGKey(seed + 2)` (the numbers differ: the generators do).
    `Engine.serve` draws one a row; the runtime one row, the same for
    every request."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    return torch.randn(batch, cfg.encdec.n_audio_frames, cfg.d_model,
                       generator=gen, device=device)


# ==========================================================================
# Decode step
# ==========================================================================
def _decode_self(p_attn, h, x1, ck, cv, pos, cfg: ModelConfig):
    """x1 plus one token's self-attention over its cache: the normed h
    [B,d] projects q, k, v at positions `pos` [B]; k and v go to ring row
    pos % T of ck/cv [B,T,Hkv,D], in place."""
    B = x1.shape[0]
    q, k1, v1 = project_qkv_decode(
        p_attn, h, n_heads=cfg.n_heads, kv_heads=cfg.kv_heads,
        head_dim=cfg.resolved_head_dim, rope_theta=cfg.rope_theta,
        position=pos, rope_frac=_rope_frac(cfg))
    T = ck.shape[1]
    rows = torch.arange(B, device=x1.device)
    slot = pos % T                                  # ring-buffer row
    ck[rows, slot] = k1[:, 0].to(ck.dtype)
    cv[rows, slot] = v1[:, 0].to(cv.dtype)
    o = attn_decode(q, ck, cv, torch.clamp(pos + 1, max=T))
    return x1 + o.reshape(B, -1) @ p_attn["wo"]


def _dense_decode_layer(p, x1, ck, cv, pos, cfg: ModelConfig,
                        per_row: bool = False):
    """x1 [B,d]; ck/cv [B,T,Hkv,D] (written in place); pos [B]. A MoE
    layer routes the B tokens jointly, or each alone with `per_row`."""
    x1 = _decode_self(p["attn"], rms_norm(p["ln1"], x1, cfg.norm_eps), x1,
                      ck, cv, pos, cfg)
    h = rms_norm(p["ln2"], x1, cfg.norm_eps)
    return x1 + ffn(p, h[:, None], cfg, per_row)[0][:, 0]


def _rec_decode_layer(p, x1, h, conv_buf, cfg: ModelConfig):
    """One Griffin recurrent layer for one token: x1 [B,d]; its state
    h [B,W] and conv_buf [B,cw-1,W] are written in place."""
    g = rms_norm(p["ln1"], x1, cfg.norm_eps)
    y, st = rglru_decode_step(p["rec"], g, {"h": h, "conv_buf": conv_buf})
    h.copy_(st["h"])
    conv_buf.copy_(st["conv_buf"])
    x1 = x1 + y
    g = rms_norm(p["ln2"], x1, cfg.norm_eps)
    return x1 + mlp(p["mlp"], g, cfg.activation)


def _audio_decode(params, cfg: ModelConfig, cache, x1, pos):
    """Whisper's decoder for one token: each layer's self-attention
    writes row pos % T of its K/V in place, then attends over every
    frame of its cross K/V (plain, as the reference's `attn_decode`)."""
    B = x1.shape[0]
    for i, p in enumerate(unstack(params["dec_layers"])):
        x1 = _decode_self(p["attn"], layer_norm(p["ln1"], x1, cfg.norm_eps),
                          x1, cache["k"][i], cache["v"][i], pos, cfg)
        xk, xv = cache["cross_k"][i], cache["cross_v"][i]
        g = layer_norm(p["ln_x"], x1, cfg.norm_eps)
        q = (g @ p["xattn"]["wq"]).reshape(B, 1, cfg.n_heads,
                                           cfg.resolved_head_dim)
        o = attn_decode(q, xk, xv,
                        torch.full((B,), xk.shape[1], device=x1.device))
        x1 = x1 + o.reshape(B, -1) @ p["xattn"]["wo"]
        x1 = x1 + mlp(p["mlp"], layer_norm(p["ln2"], x1, cfg.norm_eps),
                      "gelu")
    return x1


def _hybrid_decode(params, cfg: ModelConfig, cache, x1, pos):
    """The hybrid's layers for one token, each unit's (and then the
    tail's) in sorted-key order as `_hybrid_block` runs them; attention
    layers write row pos % T of their ring at the rows' own `pos` [B]."""
    for u, p_u in enumerate(unstack(params["units"])):
        ri = ai = 0
        for name in sorted(p_u):
            if name.split("_")[1] == "rec":
                x1 = _rec_decode_layer(p_u[name], x1, cache["rec_h"][u, ri],
                                       cache["rec_conv"][u, ri], cfg)
                ri += 1
            else:
                x1 = _dense_decode_layer(p_u[name], x1, cache["k"][u, ai],
                                         cache["v"][u, ai], pos, cfg)
                ai += 1
    # the tail is a prefix of the pattern short of its attention layer
    for ti, name in enumerate(sorted(params["tail"])):
        x1 = _rec_decode_layer(params["tail"][name], x1,
                               cache["tail_h"][ti], cache["tail_conv"][ti],
                               cfg)
    return x1


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, cache: Dict[str, Any],
                tokens, per_row: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """tokens: [B] -> (logits [B,V], cache with pos + 1); the cache's
    K/V rows and recurrent state are written in place. `per_row` routes
    each row's token through a MoE layer alone, as the serving slots do
    (`moe_ffn`); by default the B tokens route jointly."""
    _check_family(cfg)
    tokens = torch.as_tensor(tokens,
                             device=params["embed"].device).long()
    B = tokens.shape[0]
    pos = cache["pos"]
    pos_b = pos.expand(B) if pos.dim() == 0 else pos
    x1 = embed(params["embed"], tokens)
    if cfg.family in PREFILL_FAMILIES:
        for i, p in enumerate(unstack(params["layers"])):
            x1 = _dense_decode_layer(p, x1, cache["k"][i], cache["v"][i],
                                     pos_b, cfg, per_row)
    elif cfg.family == "ssm":
        s = cfg.ssm
        for i, p in enumerate(unstack(params["layers"])):
            h, conv_buf = cache["h"][i], cache["conv_buf"][i]
            g = rms_norm(p["ln1"], x1, cfg.norm_eps)
            y, st = ssm_decode_step(
                p["ssm"], g, {"h": h, "conv_buf": conv_buf},
                d_state=s.d_state, head_dim=s.head_dim, expand=s.expand)
            h.copy_(st["h"])
            conv_buf.copy_(st["conv_buf"])
            x1 = x1 + y
    elif cfg.family == "audio":
        x1 = x1 + _sinusoidal_at(pos_b, cfg.d_model).to(x1.dtype)
        x1 = _audio_decode(params, cfg, cache, x1, pos_b)
    else:
        x1 = _hybrid_decode(params, cfg, cache, x1, pos_b)
    logits = _head(params, cfg, x1)
    return logits, {**cache, "pos": pos + 1}
