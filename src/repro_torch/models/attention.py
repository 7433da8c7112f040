"""Attention: GQA projections + causal/full/sliding cores.

Implementations (`cfg.attn_impl`):
  * reference — full score matrix, with optional segment and span tables.
  * cuda      — the hand-written kernels: without tables and without a
                gradient the flash-attention kernel K2
                (kernels/flash_attention.py), cross-attention included;
                with segment/span tables, or
                when a gradient is needed, the packed kernel K1
                (kernels/flash_attention_packed.py, forward and backward;
                one segment per row when no table is given, the
                cross-attention at Sq != Sk included); their plain
                versions on CPU tensors.

The serving-only cores `attn_prefill_chunk` (chunked prefill against a
KV cache, with the mixed modality mask) and `attn_decode` (one token
against a cache) are plain PyTorch, as they are plain jnp in the JAX
package. The chunked and banded cores are not ported.

With a `ring` (parallel/ring_attention.Ring), `attention` runs ring
context parallelism whatever `impl` says, as the JAX package's `cp_axis`
does: x is the ring's local rows of a contiguously sharded packed buffer,
and every hop runs K1 (its plain version on CPU tensors).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ..kernels.flash_attention import flash_attention
from ..kernels.flash_attention_packed import flash_attention_packed
from ..parallel.ring_attention import ring_attention
from .layers import apply_rope, dense_init

NEG_INF = -1e30


def init_attention(gen, d_model: int, n_heads: int, kv_heads: int,
                   head_dim: int, dtype, device, stack: tuple = ()) -> dict:
    return {
        "wq": dense_init(gen, d_model, n_heads * head_dim, dtype, device,
                         stack),
        "wk": dense_init(gen, d_model, kv_heads * head_dim, dtype, device,
                         stack),
        "wv": dense_init(gen, d_model, kv_heads * head_dim, dtype, device,
                         stack),
        "wo": dense_init(gen, n_heads * head_dim, d_model, dtype, device,
                         stack),
    }


# --------------------------------------------------------------------------
# Cores. q: [B,S,H,D], k/v: [B,T,Hkv,D]. Positions are absolute.
# --------------------------------------------------------------------------
def _pos_mask(qpos, kpos, mode: str, window: Optional[int]):
    """[S,T] positional (causal/full/sliding) boolean mask."""
    if mode == "full":
        return torch.ones(qpos.shape[0], kpos.shape[0], dtype=torch.bool,
                          device=qpos.device)
    m = kpos[None, :] <= qpos[:, None]
    if mode == "sliding":
        if window is None:
            raise ValueError("sliding mode needs a window")
        m = m & (kpos[None, :] > (qpos[:, None] - window))
    return m


def _span_mask(span_q, span_k):
    """[B,S,T] bool: (q, k) lie in the SAME bidirectional modality
    block. Span ids >= 0 name a block (vision frame / audio window); -1
    marks causal text and padding."""
    return (span_q[:, :, None] >= 0) \
        & (span_q[:, :, None] == span_k[:, None, :])


def _norm_table(t, B, S, device):
    """[S] or [B,S] id table -> [B,S] int64 on `device`."""
    t = torch.as_tensor(t, device=device).long()
    if t.dim() == 1:
        t = t[None].expand(B, S)
    return t


def attn_reference(q, k, v, *, mode: str, window=None, q_offset=0,
                   kv_offset=0, segment_ids=None, span_ids=None):
    """Full-matrix attention. `span_ids` ([B,S] or [S]; -1 = causal) adds
    the mixed mask: tokens sharing a nonnegative span id attend
    bidirectionally within the block. `segment_ids` (-1 = padding)
    makes attention block-diagonal; padding rows come out as zeros."""
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, D).float()
    s = torch.einsum("bskgd,btkd->bskgt", qg, k.float()) / math.sqrt(D)
    qpos = q_offset + torch.arange(S, device=q.device)
    kpos = kv_offset + torch.arange(T, device=q.device)
    allowed = _pos_mask(qpos, kpos, mode, window)[None].expand(B, S, T)
    if span_ids is not None:
        if T != S:
            raise ValueError("span-masked attention is self-attention")
        sp = _norm_table(span_ids, B, S, q.device)
        allowed = allowed | _span_mask(sp, sp)
    seg = None
    if segment_ids is not None:
        seg = _norm_table(segment_ids, B, S, q.device)
        allowed = allowed & (seg[:, :, None] == seg[:, None, :]) \
            & (seg >= 0)[:, :, None]
    s = torch.where(allowed[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bskgt,btkd->bskgd", p, v.float())
    if seg is not None:
        o = torch.where((seg >= 0)[:, :, None, None, None], o, 0.0)
    return o.reshape(B, S, H, D).to(q.dtype)


def attn_decode(q1, k_cache, v_cache, valid_len):
    """One-token decode: q1 [B,1,H,D] vs cache [B,T,Hkv,D].

    `valid_len` [B] — number of live cache entries per row. For
    sliding-window caches the ring buffer already holds only the window,
    so every live entry is attendable."""
    B, _, H, D = q1.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qg = (q1.reshape(B, 1, Hkv, G, D) / math.sqrt(D)).float()
    s = torch.einsum("bskgd,btkd->bskgt", qg, k_cache.float())
    live = torch.arange(T, device=q1.device)[None, :] < valid_len[:, None]
    s = torch.where(live[:, None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bskgt,btkd->bskgd", p, v_cache.float())
    return o.reshape(B, 1, H, D).to(q1.dtype)


def attn_prefill_chunk(q, k_cache, v_cache, start_pos: int,
                       chunk_span_ids=None, cache_span_ids=None):
    """Chunked-prefill attention: q [B,C,H,D] at absolute positions
    start_pos..start_pos+C-1 vs a KV cache [B,T,Hkv,D] whose rows
    [0, start_pos+C) are live (the chunk's own K/V already written).
    Causal over absolute position: query i attends rows j <= start_pos+i,
    so garbage past the written prefix never leaks in.

    `chunk_span_ids` [B,C] / `cache_span_ids` [B,T] (-1 = causal) switch
    on the mixed modality mask: a query inside a bidirectional block also
    attends same-block rows of the written region [0, start_pos+C) —
    exact while the scheduler never splits a block across chunks."""
    B, C, H, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    dev = q.device
    qg = (q.reshape(B, C, Hkv, G, D) / math.sqrt(D)).float()
    s = torch.einsum("bckgd,btkd->bckgt", qg, k_cache.float())
    qpos = start_pos + torch.arange(C, device=dev)
    rows = torch.arange(T, device=dev)
    allowed = (rows[None, :] <= qpos[:, None])[None].expand(B, C, T)
    if chunk_span_ids is not None:
        bidir = _span_mask(torch.as_tensor(chunk_span_ids, device=dev),
                           torch.as_tensor(cache_span_ids, device=dev))
        written = rows[None, None, :] < start_pos + C
        allowed = allowed | (bidir & written)
    s = torch.where(allowed[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bckgt,btkd->bckgd", p, v_cache.float())
    return o.reshape(B, C, H, D).to(q.dtype)


# --------------------------------------------------------------------------
# Full attention block (projections + rope + core dispatch)
# --------------------------------------------------------------------------
def attention(params: dict, x: torch.Tensor, *, n_heads: int,
              kv_heads: int, head_dim: int, rope_theta: float,
              positions=None, mode: str = "causal",
              window: Optional[int] = None, impl: str = "cuda",
              rope_frac: float = 1.0, segment_ids=None, span_ids=None,
              return_kv: bool = False, ring=None, cross_kv=None):
    """Self-attention block on x [B,S,d_model]. `segment_ids` ([B,S],
    -1 = padding) selects the packed varlen path: x is a packed buffer of
    concatenated sequences and attention is block-diagonal over segments;
    pass per-segment `positions` so RoPE matches. `span_ids` ([B,S], -1 =
    causal) adds the mixed modality mask. `impl="cuda"` runs kernel K1
    when a table is given or a gradient is needed, and K2 otherwise;
    `impl="reference"` the full matrix. With a `ring`, x's rows are the
    ring's contiguous shards and the core is `ring_attention` (K1 a
    hop), whatever `impl` says.

    `cross_kv` = (k, v) [B,T,Hkv,D] makes it cross-attention (whisper's
    decoder over its encoder): x gives only the queries, unrotated, and
    the mode is "full". K/V computed from fp32 frames through bf16
    weights stay fp32 beside bf16 queries, as in the reference; the core
    then runs at the wider dtype and returns q's (the reference's plain
    cores compute in fp32 and cast to q's dtype; the cast's backward
    returns dq in q's dtype, as the reference's convert transposes). The
    core runs at Sq != Sk: K2 without a gradient (serving, `forward`
    under no_grad), K1 in full mode, one segment a row on each side,
    when one is needed (training)."""
    B, S, _ = x.shape
    q = (x @ params["wq"]).reshape(B, S, n_heads, head_dim)
    if cross_kv is None:
        k = (x @ params["wk"]).reshape(B, S, kv_heads, head_dim)
        v = (x @ params["wv"]).reshape(B, S, kv_heads, head_dim)
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :].expand(
                B, S)
        q = apply_rope(q, positions, rope_theta, rope_frac)
        k = apply_rope(k, positions, rope_theta, rope_frac)
    else:
        k, v = cross_kv
        mode = "full"

    # K2 has no backward: a table-free call that needs a gradient (a
    # padded text-only group, whisper's encoder and cross-attention in
    # training) runs K1 with one segment per row
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if cross_kv is not None and impl == "cuda":
        wide = torch.promote_types(q.dtype, k.dtype)
        qc, kc, vc = (t.to(wide).contiguous() for t in (q, k, v))
        if needs_grad:
            o = flash_attention_packed(
                qc, kc, vc, torch.zeros(B, S, dtype=torch.int32,
                                        device=x.device),
                kv_segment_ids=torch.zeros(B, k.shape[1], dtype=torch.int32,
                                           device=x.device), mode="full")
        else:
            o = flash_attention(qc, kc, vc, mode="full")
        o = o.to(q.dtype)
    elif ring is not None:
        o = ring_attention(q, k, v, segment_ids, ring=ring, mode=mode,
                           window=window, span_ids=span_ids)
    elif impl == "cuda":
        if segment_ids is not None or span_ids is not None or needs_grad:
            seg = (segment_ids if segment_ids is not None
                   else torch.zeros(B, S, dtype=torch.int32,
                                    device=x.device))
            o = flash_attention_packed(q, k, v, seg, span_ids=span_ids,
                                       mode=mode, window=window)
        else:
            o = flash_attention(q.contiguous(), k.contiguous(),
                                v.contiguous(), mode=mode, window=window)
    elif impl == "reference":
        o = attn_reference(q, k, v, mode=mode, window=window,
                           segment_ids=segment_ids, span_ids=span_ids)
    else:
        raise ValueError(f"unknown attention impl {impl!r}")
    out = o.reshape(B, S, n_heads * head_dim) @ params["wo"]
    if return_kv:
        return out, (k, v)
    return out


def project_qkv_decode(params, x1, *, n_heads, kv_heads, head_dim,
                       rope_theta, position, rope_frac: float = 1.0):
    """Projections for one decode token; x1 [B,d_model], position [B]
    absolute."""
    B = x1.shape[0]
    q = (x1 @ params["wq"]).reshape(B, 1, n_heads, head_dim)
    k = (x1 @ params["wk"]).reshape(B, 1, kv_heads, head_dim)
    v = (x1 @ params["wv"]).reshape(B, 1, kv_heads, head_dim)
    pos = position[:, None]
    q = apply_rope(q, pos, rope_theta, rope_frac)
    k = apply_rope(k, pos, rope_theta, rope_frac)
    return q, k, v
