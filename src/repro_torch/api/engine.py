"""Engine — the public entry point of the port.

    ClusterSpec  ──►  Engine(model, cluster)
                         │ state.params    -> parameter dict on the card
                         │ serve(...)      -> one-shot batched decode
                         │ serving(...)    -> continuous-batching runtime
                         ▼                    (DHP-planned prefill)

Training (`strategy=`, `plan`/`execute`/`train`) and checkpoints arrive
with the training slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Union

import torch

from ..configs import get_config
from ..configs.base import ModelConfig
from ..core.cost_model import CostModel, analytic_coeffs
from .cluster import ClusterSpec


def demo_cost_model(cfg: ModelConfig) -> CostModel:
    """Roofline coefficients for the model shape, with memory accounting
    in plain tokens (m_token=1, m_ms=0) so `mem_budget` reads as a
    per-rank token budget."""
    coeffs = dataclasses.replace(
        analytic_coeffs(
            hidden=cfg.d_model, n_layers=cfg.n_layers,
            n_heads=max(cfg.n_heads, 1), kv_heads=max(cfg.kv_heads, 1),
            ffn=max(cfg.d_ff, 1), vocab=cfg.vocab),
        m_ms=0.0, m_token=1.0)
    return CostModel(coeffs)


@dataclasses.dataclass
class EngineState:
    """What a serving engine holds: the parameter dict."""

    params: Dict[str, Any]


class Engine:
    """A serving session on one cluster.

    >>> eng = Engine("internvl3-2b")                 # on the card
    >>> rep = eng.serving(slots=4).run(trace)

    `model` is an arch id or a ModelConfig. VLM configs run in
    token-stream mode (the LM decoder over pre-counted tokens), as in
    the JAX package. `device=None` places the model on the card and
    raises when there is none; `device="cpu"` runs on the host.
    """

    def __init__(self, model: Union[str, ModelConfig],
                 cluster: Optional[ClusterSpec] = None, *,
                 cost_model: Optional[CostModel] = None,
                 reduced: bool = False, seed: int = 0,
                 device: Optional[str] = None):
        cfg = get_config(model) if isinstance(model, str) else model
        if reduced:
            cfg = cfg.reduced()
        if cfg.family == "vlm":
            cfg = cfg.with_(family="dense", vlm=None)
        self.cfg = cfg
        self.cluster = cluster or ClusterSpec.auto(device=device)
        self.device = self.cluster.primary
        self.cost_model = cost_model or demo_cost_model(cfg)
        self.seed = seed
        self._state: Optional[EngineState] = None

    @property
    def state(self) -> EngineState:
        if self._state is None:
            from ..models.model import init_params
            self._state = EngineState(params=init_params(
                self.cfg, seed=self.seed, device=self.device))
        return self._state

    @state.setter
    def state(self, value: EngineState) -> None:
        self._state = value

    # -- serve ----------------------------------------------------------
    @torch.no_grad()
    def serve(self, prompts=None, *, batch: int = 8, prompt_len: int = 96,
              gen_tokens: int = 32, cache_len: Optional[int] = None):
        """Batched prefill + greedy decode (the one-shot fixed-batch
        path). `prompts`: [B, S] token ids (drawn from the seed when
        None). Returns (decoded [B, gen_tokens], dict of timings)."""
        from ..models.model import prefill
        from ..serving.serve_step import greedy_generate, make_serve_step

        if prompts is None:
            gen = torch.Generator(device=self.device).manual_seed(
                self.seed + 1)
            prompts = torch.randint(0, self.cfg.vocab, (batch, prompt_len),
                                    generator=gen, device=self.device)
        prompts = torch.as_tensor(prompts, device=self.device).long()
        batch, prompt_len = prompts.shape
        cache_len = cache_len or prompt_len + gen_tokens

        t0 = time.perf_counter()
        logits, cache = prefill(self.state.params, self.cfg,
                                {"tokens": prompts}, cache_len=cache_len)
        first = torch.argmax(logits[:, 0], dim=-1)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t_prefill = time.perf_counter() - t0

        step, step_miss = self.cluster.pool().executable_for(
            ("serve", self.cfg.arch_id, self.cfg.family, batch, cache_len),
            lambda: make_serve_step(self.cfg))
        t0 = time.perf_counter()
        out, cache = greedy_generate(self.state.params, self.cfg, cache,
                                     first, gen_tokens, step=step)
        out = out.cpu()
        t_decode = time.perf_counter() - t0
        report = {
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "ms_per_token": t_decode / max(gen_tokens, 1) * 1e3,
            "batch": batch,
            "prompt_len": prompt_len,
            "exe_miss": step_miss,
        }
        return out, report

    # -- serving ---------------------------------------------------------
    def serving(self, *, slots: int = 4, prefill_chunk: int = 128,
                cache_len: Optional[int] = None, block_size: int = 16,
                n_blocks: Optional[int] = None):
        """The continuous-batching runtime over this engine's model and
        cluster (serving/runtime.py): paged KV slots, DHP-planned
        chunked prefill, iteration-level batching."""
        from ..serving.runtime import ServingEngine
        return ServingEngine(
            self.cfg, self.state.params, self.cluster, self.cost_model,
            slots=slots, cache_len=cache_len, block_size=block_size,
            n_blocks=n_blocks, prefill_chunk=prefill_chunk,
            seed=self.seed)
