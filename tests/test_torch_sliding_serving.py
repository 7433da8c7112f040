"""The runtime's exact-length prefill for sliding-window caches (reduced
internvl3-2b as dense with `sliding_window=16`, fp32) against the JAX
package on the CPU, on weights converted from the JAX `init_params`:

  * `ServingEngine` streams equal the JAX package's for prompts of 21
    (longer than the window: its ring is rotated), 9, 5 and 1 (straight
    to decode) tokens, with a slot reused and a late arrival;
  * each stream equals the port's own reference: `prefill` of the whole
    prompt against a ring of min(window, T) rows, its first token from
    the prefill logits, then `greedy_generate`;
  * every prompt longer than one token is prefilled once, whole, at its
    exact length, and the staged ring is what `prefill` returns;
  * `Engine.serve` tokens equal the JAX package's.
"""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config
from repro_torch.models import model as tm
from repro_torch.obs.trace import Tracer
from repro_torch.serving.scheduler import ServeRequest
from repro_torch.serving.serve_step import greedy_generate

from _torch_state_serving import (REQUESTS, assert_engine_serve_like_jax,
                                  engines, serve_both, streams, trace)

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

WINDOW = 16
JCFG = jax_get_config("internvl3-2b").reduced().with_(
    sliding_window=WINDOW)
TCFG = get_config("internvl3-2b").reduced().with_(
    attn_impl="cuda", sliding_window=WINDOW)


@pytest.fixture(scope="module")
def both():
    return engines(JCFG, TCFG)


def test_sliding_serving_streams_match_jax(both):
    jrep, rep = serve_both(*both, slots=2)
    assert streams(rep) == streams(jrep)
    assert [len(t) for t in streams(rep)] == [n for _, n, _ in REQUESTS]
    # one exact-length prefill for each prompt of more than one token
    assert rep.n_prefill_chunks == jrep.n_prefill_chunks == 4
    assert rep.n_decode_steps == jrep.n_decode_steps


def _reference(eng, prompt, n_new, T):
    """Exact prefill against the slot's ring, first token from its
    logits, then greedy decode (a 1-token prompt decodes from a fresh
    cache, as the runtime starts it)."""
    cfg, params = eng.cfg, eng.state.params
    toks = torch.as_tensor(prompt)[None].long()
    if len(prompt) == 1:
        cache = tm.init_cache(cfg, 1, T, device="cpu")
        out, _ = greedy_generate(params, cfg, cache, toks[:, 0], n_new)
        return out[0].tolist()
    logits, cache = tm.prefill(params, cfg, {"tokens": toks},
                               cache_len=min(WINDOW, T))
    assert cache["k"].shape[2] == min(WINDOW, T)
    first = torch.argmax(logits[:, 0], dim=-1)
    out, _ = greedy_generate(params, cfg, cache, first, n_new - 1)
    return [int(first[0])] + out[0].tolist()


def test_sliding_streams_equal_exact_prefill_and_greedy(both):
    _, eng = both
    reqs = trace(ServeRequest, TCFG.vocab)
    tracer = Tracer()
    rep = eng.serving(slots=2).run(reqs, trace=tracer)
    for m in rep.requests:
        r = reqs[m.request_id]
        assert m.tokens == _reference(eng, r.tokens, r.max_new_tokens,
                                      rep.cache_len), m.request_id
    exact = [ev["args"] for ev in tracer.to_json()["traceEvents"]
             if ev["name"] == "prefill_exact"]
    assert sorted(a["length"] for a in exact) == \
        sorted(L for L, _, _ in REQUESTS if L > 1)
    assert not any(ev["name"] in ("prefill_batch", "prefill_chunk")
                   for ev in tracer.to_json()["traceEvents"])


def test_sliding_engine_serve_matches_jax(both):
    prompts = np.random.default_rng(3).integers(
        0, TCFG.vocab, size=(2, 21), dtype=np.int32)
    assert_engine_serve_like_jax(*both, prompts)


def test_sliding_window_refuses_chunked_prefill(both):
    _, eng = both
    cache = tm.init_cache(eng.cfg, 1, 64, device="cpu")
    assert cache["k"].shape[2] == WINDOW
    with pytest.raises(ValueError, match="non-rotating"):
        tm.prefill_chunk(eng.state.params, eng.cfg, cache,
                         torch.zeros(1, 4, dtype=torch.long), 0)
    srv = eng.serving(slots=2, prefill_chunk=8)
    assert srv.exact_prefill and srv.prefill_chunk == 10 ** 9
