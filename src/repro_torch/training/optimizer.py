"""AdamW + schedules on parameter dicts, as the JAX package writes them.

Not `torch.optim.AdamW`, which differs on two counts: here the moments
are fp32 whatever the parameter dtype (the reference's default), the update is
computed in fp32 and cast to the parameter's dtype, and the decoupled
weight decay is folded into the update (`delta + wd * p`, scaled by lr)
for every leaf with `ndim >= 2` only. Layer leaves are stacked `[L, ...]`,
so a stacked norm scale (`layers.ln1.scale`, `[L, d]`) IS decayed while
`ln_f.scale` (`[d]`) is not — the rule of the reference, kept.

Trees are nested dicts of tensors. `update` returns new parameter
tensors (a caller's reference to the old parameters stays valid) and
updates the fp32 moments in place: they belong to the optimizer state,
and new copies beside the old ones would take twice their memory (the
moments of recurrentgemma-2b's 3.34 B parameters are 26.7 GB).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Tuple, Union

import torch


def tree_map(fn, *trees):
    """Apply `fn` leafwise over nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from tree_leaves(v)
    else:
        yield tree


class AdamWState(NamedTuple):
    step: torch.Tensor       # int64 0-d, on the parameters' device
    m: Any
    v: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params) -> AdamWState:
        """Zero fp32 moments beside each parameter."""
        leaf = next(tree_leaves(params))

        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32,
                               device=p.device)
        return AdamWState(
            step=torch.zeros((), dtype=torch.int64, device=leaf.device),
            m=tree_map(zeros, params), v=tree_map(zeros, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Dict[str, Any], AdamWState]:
        step = state.step + 1
        stepf = step.to(torch.float32)
        lr = self.lr(step) if callable(self.lr) else self.lr
        b1, b2 = self.b1, self.b2
        bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                           device=step.device), stepf)
        bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                           device=step.device), stepf)

        def upd(g, m, v, p):
            gf = g.float()
            m.mul_(b1).add_((1 - b1) * gf)              # in place
            v.mul_(b2).add_((1 - b2) * gf * gf)
            delta = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if p.dim() >= 2:   # decoupled weight decay on matrices only
                delta = delta + self.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype)

        new_params = tree_map(upd, grads, state.m, state.v, params)
        return new_params, AdamWState(step=step, m=state.m, v=state.v)


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    """Linear warmup to `peak`, then cosine decay to `floor_frac*peak`;
    a function of the (tensor) step."""
    def lr(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = peak * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak * (floor_frac + (1 - floor_frac)
                      * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float()))
                          for l in tree_leaves(tree)))


def clip_by_global_norm(tree, max_norm: float):
    """(tree scaled to global norm <= max_norm, the norm before)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return tree_map(lambda l: (l.float() * scale).to(l.dtype), tree), norm
