"""The port's MoE serving (reduced granite-moe-1b-a400m and olmoe-1b-7b,
fp32) against the JAX package on the CPU, on weights converted from the
JAX `init_params`:

  * `ServingEngine` streams equal the JAX package's (slots=2, prompts of
    21, 5, 1, 9 and 7 tokens, a slot reused, a late arrival), and the
    port's own reference: `prefill` of the whole prompt at its exact
    length (the first token from its logits), then `greedy_generate`;
    every prompt of more than one token is prefilled once, whole, and
    nothing is chunked or co-batched (capacity routing depends on the
    routed set, so the reference prefills MoE at exact length);
  * the slot decode routes every slot alone, as the reference's `vmap`
    of B=1 decodes does: on these traces joint routing over the slots
    gives other streams, and other logits in one step;
  * `Engine.serve` (prefill and decode joint over the batch, drops and
    all) gives the JAX package's tokens;
  * `init_cache` has the JAX leaves.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.models import model as jm
from repro_torch.configs import get_config
from repro_torch.models import model as tm
from repro_torch.obs.trace import Tracer
from repro_torch.serving import serve_step
from repro_torch.serving.scheduler import ServeRequest
from repro_torch.serving.serve_step import greedy_generate

from _torch_state_serving import (REQUESTS, assert_cache_like_jax,
                                  assert_engine_serve_like_jax, engines,
                                  serve_both, streams, trace)

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

ARCHS = ("granite-moe-1b-a400m", "olmoe-1b-7b")


@pytest.fixture(scope="module")
def both():
    """Each arch's JAX engine and the port's on its weights, built once."""
    return {arch: engines(jax_get_config(arch).reduced(),
                          get_config(arch).reduced().with_(
                              attn_impl="cuda"))
            for arch in ARCHS}


@pytest.fixture(scope="module")
def served(both):
    """Both runtimes over the shared trace, once an arch."""
    return {arch: serve_both(*pair, slots=2) for arch, pair in both.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_serving_streams_match_jax(served, arch):
    jrep, rep = served[arch]
    assert streams(rep) == streams(jrep)
    assert [len(t) for t in streams(rep)] == [n for _, n, _ in REQUESTS]
    # one exact-length prefill for each prompt of more than one token
    assert rep.n_prefill_chunks == jrep.n_prefill_chunks == 4
    assert rep.n_decode_steps == jrep.n_decode_steps


def _reference(eng, prompt, n_new, T):
    """Exact prefill (B=1) against a T-row cache, first token from its
    logits, then greedy decode (a 1-token prompt decodes from a fresh
    cache, as the runtime starts it)."""
    cfg, params = eng.cfg, eng.state.params
    toks = torch.as_tensor(prompt)[None].long()
    if len(prompt) == 1:
        cache = tm.init_cache(cfg, 1, T, device="cpu")
        out, _ = greedy_generate(params, cfg, cache, toks[:, 0], n_new)
        return out[0].tolist()
    logits, cache = tm.prefill(params, cfg, {"tokens": toks}, cache_len=T)
    assert cache["k"].shape[2] == T
    first = torch.argmax(logits[:, 0], dim=-1)
    out, _ = greedy_generate(params, cfg, cache, first, n_new - 1)
    return [int(first[0])] + out[0].tolist()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_streams_equal_exact_prefill_and_greedy(both, arch):
    _, eng = both[arch]
    reqs = trace(ServeRequest, eng.cfg.vocab)
    tracer = Tracer()
    srv = eng.serving(slots=2, prefill_chunk=8)
    assert srv.exact_prefill and srv.prefill_chunk == 10 ** 9
    rep = srv.run(reqs, trace=tracer)
    for m in rep.requests:
        r = reqs[m.request_id]
        assert m.tokens == _reference(eng, r.tokens, r.max_new_tokens,
                                      rep.cache_len), m.request_id
    events = tracer.to_json()["traceEvents"]
    exact = [ev["args"] for ev in events if ev["name"] == "prefill_exact"]
    assert sorted(a["length"] for a in exact) == \
        sorted(L for L, _, _ in REQUESTS if L > 1)
    assert not any(ev["name"] in ("prefill_batch", "prefill_chunk")
                   for ev in events)


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_decode_routes_each_slot_alone(both, served, arch,
                                            monkeypatch):
    """The runtime's streams are the reference's per-slot ones (above);
    the same runtime with a slot decode that routes the slots jointly
    (as `decode_step` routes a batch) gives other streams, and one step
    of it other logits, where the per-row step equals the JAX package's
    B=1 decodes."""
    jeng, eng = both[arch]
    jrep, _ = served[arch]
    monkeypatch.setattr(serve_step, "make_slot_decode_step",
                        lambda cfg: lambda params, slots, toks:
                        serve_step.make_serve_step(cfg)(params, slots,
                                                        toks[:, 0]))
    # another cache capacity: a step key the pool has not built yet
    joint = eng.serving(slots=2, cache_len=128).run(
        trace(ServeRequest, eng.cfg.vocab))
    assert joint.cache_len == 128
    assert streams(joint) != streams(jrep)

    # one step over 4 slots at different depths, jointly and per row
    cfg, params = eng.cfg, eng.state.params
    n, T = 4, 16
    rng = np.random.default_rng(5)
    depth = [3, 0, 7, 5]
    toks = rng.integers(0, cfg.vocab, size=(n, 8), dtype=np.int32)
    logits = {}
    for per_row in (True, False):
        slots = serve_step.make_slot_cache(cfg, n, T, device="cpu")
        for i, d in enumerate(depth):
            c = tm.init_cache(cfg, 1, T, device="cpu")
            for t in range(d):
                _, c = tm.decode_step(params, cfg, c,
                                      torch.as_tensor(toks[i:i + 1, t]))
            serve_step.write_slot(cfg, slots, c, i)
        step = torch.as_tensor([toks[i, d] for i, d in enumerate(depth)])
        logits[per_row], _ = tm.decode_step(params, cfg, slots, step,
                                            per_row=per_row)
    assert (logits[True] - logits[False]).abs().max() > 1e-3
    # the reference: each slot a B=1 decode at its own depth
    jcfg = jeng.cfg
    jstep = jax.jit(lambda p, c, t: jm.decode_step(p, jcfg, c, t))
    for i, d in enumerate(depth):
        c = jm.init_cache(jcfg, 1, T)
        for t in range(d + 1):
            lg, c = jstep(jeng.state.params, c,
                          jnp.asarray(toks[i:i + 1, t]))
        np.testing.assert_allclose(logits[True][i].numpy(),
                                   np.asarray(lg)[0], atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_engine_serve_matches_jax(both, arch):
    """Batched prefill and decode route the batch jointly in both
    packages, drops included (at batch 4 a decode step's capacity is
    int(1.25 * 4 * 2 / 4) = 2 an expert)."""
    prompts = np.random.default_rng(3).integers(
        0, get_config(arch).reduced().vocab, size=(4, 21), dtype=np.int32)
    assert_engine_serve_like_jax(*both[arch], prompts)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_cache_like_jax(arch):
    assert_cache_like_jax(jax_get_config(arch).reduced(),
                          get_config(arch).reduced())
    assert tm.cache_batch_axes(get_config(arch)) == {"k": 1, "v": 1}
