"""The loss and the train step of one fixed-shape batch, as the JAX
package's `training/train_step.py` writes them, and the training state
an Engine holds.

`make_train_step` is the reference's one way to train the audio family
(whisper: frames beside the tokens), whose batches the DHP executor
cannot carry; it takes any family's `synthetic_batch`. `dp_axis` and
`grad_constraint` of the reference are `shard_map` / GSPMD hooks and are
not ported: the step runs on one device.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from ..configs.base import ModelConfig
from ..models.model import forward, position_nll
from .optimizer import (AdamW, AdamWState, clip_by_global_norm,
                        tree_leaves, tree_map)


class TrainState(NamedTuple):
    """Parameters and optimizer state; `opt` is None until the first
    update (a serving engine never allocates it)."""

    params: Any
    opt: Optional[AdamWState] = None


def cross_entropy(logits, labels, mask=None) -> torch.Tensor:
    """Mean next-token NLL of logits [B,S,V] against labels [B,S]; with
    `mask` [B,S] the mask-weighted mean (at least one token's weight in
    the denominator)."""
    nll = position_nll(logits, labels)
    if mask is None:
        return nll.mean()
    mask = torch.as_tensor(mask, device=nll.device).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Any]):
    """(loss + aux coefficient x aux / n_layers, (loss, aux))."""
    logits, aux = forward(params, cfg, batch)
    aux_coef = cfg.moe.aux_loss_coef if cfg.moe else 0.0
    loss = cross_entropy(logits, batch["labels"], batch.get("mask"))
    return loss + aux_coef * aux / max(cfg.n_layers, 1), (loss, aux)


def value_and_grad(params, cfg: ModelConfig, batch):
    """(total, loss, aux, gradient tree of the total) of one batch: one
    autograd pass over detached copies of the leaves."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params)
    total, (loss, aux) = loss_fn(p, cfg, batch)
    grads = iter(torch.autograd.grad(total, leaves))
    return (total.detach(), loss.detach(), aux.detach(),
            tree_map(lambda _: next(grads), params))


def make_train_step(cfg: ModelConfig, opt: AdamW, *, grad_clip: float = 1.0,
                    accum_steps: int = 1):
    """Returns train_step(state, batch) -> (state, metrics).

    `accum_steps > 1` splits the batch along its leading axis into that
    many micro-batches, one autograd pass each; their gradients are
    summed in fp32 and cast to each parameter's dtype after the
    division, and the metrics are the micro-batches' means, as the
    reference's `lax.scan` forms them. Then the gradient is clipped to
    global norm `grad_clip` and AdamW updates the parameters (the
    moments in place, so `state.opt` is the new state's too; a state
    without one gets fresh moments). metrics: `loss`, `aux`,
    `grad_norm` (before the clip) and `total`, 0-d tensors on the
    device."""

    def train_step(state: TrainState, batch):
        if accum_steps == 1:
            total, loss, aux, grads = value_and_grad(state.params, cfg,
                                                     batch)
        else:
            def micro(x, i):
                b = x.shape[0]
                assert b % accum_steps == 0, (b, accum_steps)
                n = b // accum_steps
                return x[i * n:(i + 1) * n]
            acc, sums = None, None
            for i in range(accum_steps):
                ti, li, ai, gi = value_and_grad(
                    state.params, cfg,
                    {k: micro(v, i) for k, v in batch.items()})
                if acc is None:
                    acc = tree_map(lambda g: g.float(), gi)
                    sums = [ti, li, ai]
                else:
                    tree_map(lambda a, g: a.add_(g.float()), acc, gi)
                    sums = [s + x for s, x in zip(sums, (ti, li, ai))]
                del gi
            total, loss, aux = (s / accum_steps for s in sums)
            grads = tree_map(lambda g, p: (g / accum_steps).to(p.dtype),
                             acc, state.params)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        opt_state = state.opt if state.opt is not None \
            else opt.init(state.params)
        params, opt_state = opt.update(grads, opt_state, state.params)
        metrics = {"loss": loss, "aux": aux, "grad_norm": gnorm,
                   "total": total}
        return TrainState(params, opt_state), metrics

    return train_step


def make_eval_step(cfg: ModelConfig):
    """Returns eval_step(params, batch) -> the batch's loss (no
    gradient: the cross-attention runs K2, as in serving)."""
    @torch.no_grad()
    def eval_step(params, batch):
        _, (loss, _aux) = loss_fn(params, cfg, batch)
        return loss
    return eval_step
