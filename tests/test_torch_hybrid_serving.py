"""The port's hybrid serving (recurrentgemma-2b, reduced: one (rec, rec,
attn) unit, window 64, fp32) against the JAX package on the CPU, on
weights converted from the JAX `init_params`:

  * `rglru_decode_step` against the JAX function over several steps from
    the same random state: outputs and states within 1e-5 x max(1, |ref|);
  * `init_cache`'s leaves against the JAX `init_cache`'s, and a cache's
    slot axis (axis 2 of the unit leaves) through `write_slot`;
  * 80 `decode_step` logits, past the attention layer's 64-row ring,
    against the JAX `decode_step`'s (1e-4 x max(1, |ref|)) and against the
    port's own `forward` (2e-3), also with the rows at different depths;
  * `ServingEngine` streams (slots=2, a slot reused, a late arrival) and
    `Engine.serve` tokens equal the JAX package's;
  * the reference's behaviour, carried over as it is: a request starts
    from a fresh state and its last prompt token, so changing every
    other prompt token changes no stream, in either package.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.models import rglru as jrg
from repro_torch.api import Engine
from repro_torch.configs import get_config
from repro_torch.models import model as tm
from repro_torch.models import rglru as trg
from repro_torch.models.transformer import unstack
from repro_torch.serving.serve_step import make_slot_cache, write_slot

from _torch_state_serving import (FWD_TOL, JAX_TOL, STEP_TOL,
                                  assert_cache_like_jax,
                                  assert_engine_serve_like_jax,
                                  decode_both, engines, scaled_err,
                                  serve_both, streams)

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

JCFG = jax_get_config("recurrentgemma-2b").reduced()
TCFG = get_config("recurrentgemma-2b").reduced()


@pytest.fixture(scope="module")
def both():
    return engines(JCFG, TCFG)


def test_rglru_decode_step_matches_jax(both):
    jeng, eng = both
    h = TCFG.hybrid
    tp = unstack(eng.state.params["units"]["1_rec"])[0]["rec"]
    jp = {k: v[0] for k, v in
          jeng.state.params["units"]["1_rec"]["rec"].items()}
    rng = np.random.default_rng(0)
    shapes = {k: tuple(v.shape) for k, v in trg.rglru_init_state(
        2, h.lru_width, h.conv_width, device="cpu").items()}
    state = {k: rng.standard_normal(v).astype(np.float32)
             for k, v in shapes.items()}
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: torch.as_tensor(v) for k, v in state.items()}
    for _ in range(4):
        x1 = rng.standard_normal((2, TCFG.d_model)).astype(np.float32)
        jy, jstate = jrg.rglru_decode_step(jp, jnp.asarray(x1), jstate)
        y, tstate = trg.rglru_decode_step(tp, torch.as_tensor(x1), tstate)
        assert scaled_err(y, jy) <= STEP_TOL
        for k in state:
            assert scaled_err(tstate[k], jstate[k]) <= STEP_TOL, k


def test_hybrid_init_cache_matches_jax():
    assert_cache_like_jax(JCFG, TCFG)
    assert_cache_like_jax(JCFG, TCFG, cache_len=40)
    cache = tm.init_cache(TCFG, 2, 200, dtype=torch.bfloat16,
                          device="cpu")
    assert cache["k"].shape[3] == TCFG.hybrid.window
    assert cache["rec_h"].dtype == cache["tail_h"].dtype == torch.float32
    assert cache["k"].dtype == cache["rec_conv"].dtype == torch.bfloat16
    # write_slot fills every leaf of one slot and no other
    slots = make_slot_cache(TCFG, 3, 200, device="cpu")
    one = tm.init_cache(TCFG, 1, 200, device="cpu")
    for name, leaf in one.items():
        leaf.fill_(5)
    write_slot(TCFG, slots, one, 1)
    for name, axis in tm.cache_batch_axes(TCFG).items():
        assert bool((slots[name].select(axis, 1) == 5).all()), name
        assert int(slots[name].ne(0).sum()) == one[name].numel(), name
    assert slots["pos"].tolist() == [0, 5, 0]


def test_hybrid_decode_logits_match_jax_and_forward(both):
    jeng, eng = both
    toks, jlogits, logits = decode_both(jeng, eng)
    assert toks.shape[1] > TCFG.hybrid.window
    assert scaled_err(logits, jlogits) <= JAX_TOL
    full, _ = tm.forward(eng.state.params, TCFG,
                         {"tokens": torch.as_tensor(toks)})
    assert scaled_err(logits, full.numpy()) <= FWD_TOL


def test_hybrid_decode_rows_at_their_own_depths(both):
    """A [2] pos: row 1 starts 9 tokens after row 0, so every step writes
    the rows' rings at different rows, and both run past the window."""
    _, eng = both
    params = eng.state.params
    toks = np.random.default_rng(4).integers(
        0, TCFG.vocab, size=(2, 80), dtype=np.int32)
    cache = tm.init_cache(TCFG, 2, 96, device="cpu")
    cache["pos"] = torch.zeros(2, dtype=torch.long)
    one = tm.init_cache(TCFG, 1, 96, device="cpu")
    lag = 9
    for t in range(toks.shape[1] + lag):
        row1 = toks[1, t - lag] if t >= lag else 0
        lg, cache = tm.decode_step(
            params, TCFG, cache,
            torch.as_tensor([toks[0, min(t, 79)], row1]))
        if t == lag - 1:   # row 1 starts now: a fresh slot
            write_slot(TCFG, cache, one, 1)
        if t >= lag:
            last = lg[1]
    full, _ = tm.forward(params, TCFG, {"tokens": torch.as_tensor(toks)})
    assert int(cache["pos"][1]) == toks.shape[1]
    assert scaled_err(last, full[1, -1]) <= FWD_TOL


def test_hybrid_serving_streams_match_jax(both):
    jrep, rep = serve_both(*both, slots=2)
    assert streams(rep) == streams(jrep)
    assert [len(t) for t in streams(rep)] == [4, 6, 3, 5, 4]
    assert rep.n_prefill_chunks == jrep.n_prefill_chunks == 0
    assert rep.n_decode_steps == jrep.n_decode_steps


def test_hybrid_streams_ignore_all_but_the_last_prompt_token(both):
    jeng, eng = both
    jrep, rep = serve_both(jeng, eng, slots=2)
    jrep7, rep7 = serve_both(jeng, eng, slots=2, fill=7)
    assert streams(rep7) == streams(rep)
    assert streams(jrep7) == streams(jrep)


def test_hybrid_engine_serve_matches_jax(both):
    prompts = np.random.default_rng(3).integers(
        0, TCFG.vocab, size=(3, 12), dtype=np.int32)
    assert_engine_serve_like_jax(*both, prompts)


def test_hybrid_serving_needs_a_card_unless_cpu_asked(both):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default placement succeeds")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine("recurrentgemma-2b", reduced=True)
    with pytest.raises(NotImplementedError, match="hybrid serving"):
        tm.prefill(both[1].state.params, TCFG,
                   {"tokens": torch.zeros(1, 4, dtype=torch.long)})
