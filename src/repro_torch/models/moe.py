"""Mixture-of-Experts FFN: top-k router + capacity-bounded dispatch.

Expert weights are stacked [E, d_model, d_ff]. Tokens over an expert's
capacity are dropped (the block's residual keeps them alive), and the
Switch load-balance loss comes back beside the output, as in the JAX
package's `models/moe.py`.

Routing is discontinuous, so three details follow the reference exactly:
  * the router is fp32 whatever the model's dtype, and its forward
    product runs in IEEE fp32 (TF32 off for it, whatever the caller set;
    its backward takes the caller's setting: it moves no routing);
  * a (token, choice) pair's place in its expert's queue is its arrival
    order, token-major and choice-minor (a stable sort over the choices);
  * every token is routed, padding included: a packed buffer's padding
    comes last, so it takes only capacity that no real token wanted.
"""
from __future__ import annotations

import contextlib
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .layers import dense_init


def init_moe(gen, d_model: int, n_experts: int, expert_ff: int, dtype,
             device, stack: tuple = ()) -> dict:
    return {
        "router": dense_init(gen, d_model, n_experts, torch.float32,
                             device, stack),
        "gate": _expert_init(gen, stack, n_experts, d_model, expert_ff,
                             dtype, device),
        "up": _expert_init(gen, stack, n_experts, d_model, expert_ff,
                           dtype, device),
        "down": _expert_init(gen, stack, n_experts, expert_ff, d_model,
                             dtype, device),
    }


def _expert_init(gen, stack: tuple, n_experts: int, d_in: int, d_out: int,
                 dtype, device) -> torch.Tensor:
    """N(0, 1/d_in) weights [*stack, E, d_in, d_out] in `dtype`, drawn in
    fp32 one layer's [E, d_in, d_out] at a time: olmoe-1b-7b's stacked
    expert leaf is 4.3 GB in bf16 and would be an 8.6 GB fp32 draw."""
    out = torch.empty(*stack, n_experts, d_in, d_out, dtype=dtype,
                      device=device)
    for layer in out.view(-1, n_experts, d_in, d_out):
        w = torch.randn(n_experts, d_in, d_out, generator=gen,
                        dtype=torch.float32, device=device)
        layer.copy_(w.mul_(1.0 / math.sqrt(d_in)))
    return out


@contextlib.contextmanager
def _ieee_fp32():
    """fp32 products in IEEE fp32 (no TF32 on the card) inside."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def _capacity(capacity_factor: float, n_tokens: int, top_k: int,
              n_experts: int) -> int:
    return int(capacity_factor * n_tokens * top_k / n_experts) or 1


def moe_ffn(params: dict, x: torch.Tensor, *, top_k: int,
            capacity_factor: float = 1.25, dispatch: str = "sort",
            dispatch_group: int = 0, per_row: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B,S,D] -> (out [B,S,D], aux loss).

    `dispatch`:
      "sort"   — a stable argsort over the choices' experts fills
                 [E, cap, D] expert buffers by gathers: O(T·k·D) data
                 movement, no dispatch products. Tokens go in groups of
                 the largest divisor of T at most `dispatch_group` (0:
                 one group), each with its own capacity.
      "einsum" — the one-hot [T,E,cap] baseline, quadratic in T (tests).
    Both fill each expert first come, first served in token order, with
    capacity int(capacity_factor * tokens * top_k / E) or 1.

    `per_row` routes every row of x on its own, as B calls on [1,S,D]
    would: capacity, queues and the aux loss are a row's, and aux is
    [B]. The JAX package's serving runtime `vmap`s its B=1 decode over
    the slots, so each slot routes alone: the slot decode step
    (`serving/serve_step.make_slot_decode_step`) passes it, so that no
    slot, empty ones included, takes another's capacity. `decode_step`,
    `prefill` and `Engine.serve` route the batch jointly (aux a scalar),
    as the reference's do."""
    B, S, D = x.shape
    E = params["router"].shape[-1]
    k = top_k
    T = B * S
    xt = x.reshape(T, D)
    probs, gate_vals, idx = route(params, xt, k)

    # load-balance loss (Switch), E * sum_e f_e * p_e, a routing unit's
    R = B if per_row else 1
    Tr = T // R
    me = probs.view(R, Tr, E).mean(1)                          # [R,E]
    ce = torch.zeros(R, E, dtype=torch.float32, device=x.device)
    ce.scatter_add_(1, idx.view(R, Tr * k),
                    torch.ones(R, Tr * k, device=x.device))
    aux = E * (me * ce / (Tr * k)).sum(-1)
    aux = aux if per_row else aux[0]

    if dispatch == "sort":
        # groups align with the rows (B·S flatten); per row, a row's
        # groups are what a [1,S,D] call makes
        Tg = min(dispatch_group or Tr, Tr)
        while Tr % Tg:                    # largest divisor <= requested
            Tg -= 1
        G = T // Tg
        out = _moe_sort_dispatch(
            params, xt.view(G, Tg, D), idx.view(G, Tg, k),
            gate_vals.view(G, Tg, k), _capacity(capacity_factor, Tg, k, E))
    elif dispatch == "einsum":
        out = _moe_einsum_dispatch(
            params, xt.view(R, Tr, D), idx.view(R, Tr, k),
            gate_vals.view(R, Tr, k), _capacity(capacity_factor, Tr, k, E))
    else:
        raise ValueError(f"unknown MoE dispatch {dispatch!r}")
    return out.reshape(B, S, D), aux


def route(params: dict, xt: torch.Tensor, top_k: int):
    """xt [T,D] -> (router probabilities [T,E], the top-k's gates
    normalised to sum 1 [T,k], their experts [T,k]), all fp32."""
    with _ieee_fp32():
        logits = xt.float() @ params["router"]                # [T,E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, idx


def queue_positions(slot_expert: torch.Tensor, n_experts: int):
    """slot_expert [G,S] (each group's choices' experts, token-major) ->
    (order [G,S], starts [G,E], counts [G,E], pos [G,S]): the stable sort
    by expert, where each expert's run of slots starts in it and how
    long it is (`searchsorted`, no host sync), and each slot's position
    in its expert's queue: its rank in the order less its expert's
    start."""
    G, S = slot_expert.shape
    dev = slot_expert.device
    order = torch.argsort(slot_expert, dim=-1, stable=True)
    sorted_e = torch.gather(slot_expert, 1, order)
    experts = torch.arange(n_experts, device=dev).expand(G, -1).contiguous()
    starts = torch.searchsorted(sorted_e, experts)
    counts = torch.searchsorted(sorted_e, experts, right=True) - starts
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(S, device=dev).expand(G, S))
    return order, starts, counts, rank - torch.gather(starts, 1, slot_expert)


def _expert_mlps(params: dict, ex_in: torch.Tensor) -> torch.Tensor:
    """[E,N,D] -> [E,N,D] through each expert's SwiGLU MLP."""
    h = torch.bmm(ex_in, params["gate"])
    u = torch.bmm(ex_in, params["up"])
    return torch.bmm(F.silu(h) * u, params["down"])


class _GatherRows(torch.autograd.Function):
    """out[i] = x[fwd[i]], a zero row where fwd[i] < 0; its backward is a
    gather too: grad_x[j] = sum over r of grad_out[bwd[j, r]], a term
    dropped where bwd[j, r] < 0. `bwd` must name every i with fwd[i] ==
    j, so that the two are the forward's exact transpose: the dispatch's
    and the combine's row maps are each other's inverse, and neither
    way needs atomics (`index_select`'s backward is an atomic
    `index_add_`)."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.save_for_backward(bwd)
        out = x[fwd.clamp(min=0)]
        return out.masked_fill_((fwd < 0)[:, None], 0)

    @staticmethod
    def backward(ctx, grad):
        bwd, = ctx.saved_tensors
        g = grad[bwd.clamp(min=0)]                       # [N, r, D]
        return g.masked_fill_((bwd < 0)[..., None], 0).sum(1), None, None


def _moe_sort_dispatch(params: dict, xt: torch.Tensor, idx: torch.Tensor,
                       gate_vals: torch.Tensor, cap: int) -> torch.Tensor:
    """Sort dispatch of G groups at once: xt [G,T,D], idx and gate_vals
    [G,T,k] -> [G,T,D]. A group's choices ("slots", token-major) are
    sorted stably by expert (`queue_positions`), and expert e's buffer
    row c holds the slot at sorted position start_e + c. The buffers are
    filled and read back by row gathers whose backward gathers too
    (`_GatherRows`), and the combine sums each token's k contiguous
    slots: no atomics on values either way."""
    G, T, D = xt.shape
    E = params["router"].shape[-1]
    k = idx.shape[-1]
    S = T * k
    dev = xt.device
    slot_expert = idx.reshape(G, S)
    order, starts, counts, pos = queue_positions(slot_expert, E)
    keep = pos < cap
    gate_kept = (gate_vals.reshape(G, S) * keep).to(xt.dtype)

    # buffer rows [E, G, cap], row (e, g, c) at (e G + g) cap + c; slots
    # numbered g S + s over the groups; -1 for an empty row or a dropped
    # slot
    grp = torch.arange(G, device=dev)
    c = torch.arange(cap, device=dev)
    at = (starts[..., None] + c).clamp(max=S - 1).view(G, E * cap)
    slot_of_row = torch.gather(order, 1, at).view(G, E, cap)
    slot_of_row = torch.where(c < counts[..., None],
                              slot_of_row + S * grp[:, None, None], -1)
    slot_of_row = slot_of_row.transpose(0, 1).reshape(-1)
    row_of_slot = torch.where(
        keep, (slot_expert * G + grp[:, None]) * cap + pos, -1).view(-1)
    token_of_row = torch.where(slot_of_row >= 0, slot_of_row // k, -1)

    ex_in = _GatherRows.apply(xt.reshape(G * T, D), token_of_row,
                              row_of_slot.view(G * T, k))
    ex_out = _expert_mlps(params, ex_in.view(E, G * cap, D))
    slot_out = _GatherRows.apply(ex_out.view(E * G * cap, D), row_of_slot,
                                 slot_of_row[:, None])
    slot_out = slot_out.view(G, S, D) * gate_kept[..., None]
    return slot_out.view(G, T, k, D).sum(2)


def _moe_einsum_dispatch(params: dict, xt: torch.Tensor, idx: torch.Tensor,
                         gate_vals: torch.Tensor, cap: int) -> torch.Tensor:
    """The one-hot baseline for G groups at once: xt [G,T,D], idx and
    gate_vals [G,T,k] -> [G,T,D], through a [G,T,E,cap] dispatch
    tensor."""
    G, T, D = xt.shape
    E = params["router"].shape[-1]
    k = idx.shape[-1]
    dt = xt.dtype
    onehot = F.one_hot(idx, E)                                # [G,T,k,E]
    flat = onehot.view(G, T * k, E)
    pos = flat.cumsum(1) - 1                                  # queue index
    pos = (pos * flat).sum(-1).view(G, T, k)
    keep = pos < cap
    gate_vals = gate_vals * keep
    disp = (onehot.to(dt)[..., :, None]
            * F.one_hot(pos.clamp(max=cap - 1), cap).to(dt)[..., None, :]
            * keep.to(dt)[..., None, None]).sum(2)             # [G,T,E,cap]
    ex_in = torch.einsum("gtd,gtec->egcd", xt, disp)
    ex_out = _expert_mlps(params, ex_in.reshape(E, G * cap, D))
    comb = torch.einsum("gtec,egcd->gted", disp,
                        ex_out.view(E, G, cap, D))
    gate_e = (onehot.to(dt) * gate_vals[..., None].to(dt)).sum(2)
    return torch.einsum("gte,gted->gtd", gate_e, comb)
