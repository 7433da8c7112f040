"""The port's SSM serving (mamba2-370m, reduced, fp32) against the JAX
package on the CPU, on weights converted from the JAX `init_params`:

  * `ssm_decode_step` against the JAX function over several steps from
    the same random state: outputs and states within 1e-5 x max(1, |ref|);
  * `init_cache`'s leaves against the JAX `init_cache`'s;
  * 80 `decode_step` logits against the JAX `decode_step`'s (1e-4 x
    max(1, |ref|)) and against the port's own `forward` (2e-3);
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
from repro.models import ssm as jssm
from repro_torch.api import Engine
from repro_torch.configs import get_config
from repro_torch.models import model as tm
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import unstack

from _torch_state_serving import (FWD_TOL, JAX_TOL, STEP_TOL,
                                  assert_cache_like_jax,
                                  assert_engine_serve_like_jax,
                                  decode_both, engines, scaled_err,
                                  serve_both, streams)

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

JCFG = jax_get_config("mamba2-370m").reduced()
TCFG = get_config("mamba2-370m").reduced()


@pytest.fixture(scope="module")
def both():
    return engines(JCFG, TCFG)


def test_ssm_decode_step_matches_jax(both):
    jeng, eng = both
    s = TCFG.ssm
    kw = dict(d_state=s.d_state, head_dim=s.head_dim, expand=s.expand)
    tp = unstack(eng.state.params["layers"])[1]["ssm"]
    jp = {k: v[1] for k, v in jeng.state.params["layers"]["ssm"].items()}
    rng = np.random.default_rng(0)
    shapes = {k: tuple(v.shape) for k, v in tssm.ssm_init_state(
        2, TCFG.d_model, conv_width=s.conv_width, device="cpu",
        **kw).items()}
    state = {k: rng.standard_normal(v).astype(np.float32)
             for k, v in shapes.items()}
    jstate = {k: jnp.asarray(v) for k, v in state.items()}
    tstate = {k: torch.as_tensor(v) for k, v in state.items()}
    for _ in range(4):
        x1 = rng.standard_normal((2, TCFG.d_model)).astype(np.float32)
        jy, jstate = jssm.ssm_decode_step(jp, jnp.asarray(x1), jstate, **kw)
        y, tstate = tssm.ssm_decode_step(tp, torch.as_tensor(x1), tstate,
                                         **kw)
        assert scaled_err(y, jy) <= STEP_TOL
        for k in state:
            assert scaled_err(tstate[k], jstate[k]) <= STEP_TOL, k


def test_ssm_init_cache_matches_jax():
    assert_cache_like_jax(JCFG, TCFG)
    state = tssm.ssm_init_state(3, 64, d_state=16, head_dim=32, expand=2,
                                conv_width=4, dtype=torch.bfloat16,
                                device="cpu")
    assert state["h"].dtype == torch.float32
    assert state["conv_buf"].dtype == torch.bfloat16


def test_ssm_decode_logits_match_jax_and_forward(both):
    jeng, eng = both
    toks, jlogits, logits = decode_both(jeng, eng)
    assert scaled_err(logits, jlogits) <= JAX_TOL
    full, _ = tm.forward(eng.state.params, TCFG,
                         {"tokens": torch.as_tensor(toks)})
    assert scaled_err(logits, full.numpy()) <= FWD_TOL


def test_ssm_serving_streams_match_jax(both):
    jrep, rep = serve_both(*both, slots=2)
    assert streams(rep) == streams(jrep)
    assert [len(t) for t in streams(rep)] == [4, 6, 3, 5, 4]
    assert rep.n_prefill_chunks == jrep.n_prefill_chunks == 0
    assert rep.n_decode_steps == jrep.n_decode_steps


def test_ssm_streams_ignore_all_but_the_last_prompt_token(both):
    jeng, eng = both
    jrep, rep = serve_both(jeng, eng, slots=2)
    jrep7, rep7 = serve_both(jeng, eng, slots=2, fill=7)
    assert streams(rep7) == streams(rep)
    assert streams(jrep7) == streams(jrep)


def test_ssm_engine_serve_matches_jax(both):
    prompts = np.random.default_rng(3).integers(
        0, TCFG.vocab, size=(3, 12), dtype=np.int32)
    assert_engine_serve_like_jax(*both, prompts)


def test_ssm_serving_needs_a_card_unless_cpu_asked(both):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default placement succeeds")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine("mamba2-370m", reduced=True)
    with pytest.raises(NotImplementedError, match="SSM serving"):
        tm.prefill(both[1].state.params, TCFG,
                   {"tokens": torch.zeros(1, 4, dtype=torch.long)})
