"""The port's audio serving (whisper-small, reduced, fp32) against the JAX
package on the CPU, on weights converted from the JAX `init_params`:

  * `ServingEngine` streams (slots=2, prompts of 21, 5 and 1 tokens, 4
    new tokens each, the third request in a reused slot) equal the JAX
    runtime's, each request bringing its own `ServeRequest.frames`; a
    request without frames encodes `serving_frames`, the same for every
    request;
  * `Engine.serve` tokens equal a JAX reference built from `init_cache`,
    `prefill_cross_kv` and `greedy_generate` on the port's frames;
  * the reference's behaviour, carried over as it is: a request starts
    from its cross K/V and its last prompt token, so changing every other
    prompt token changes no stream, in either package;
  * other frames give another stream: the cross-attention is wired.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.models import model as jm
from repro.serving.scheduler import ServeRequest as JaxRequest
from repro.serving.serve_step import greedy_generate as jax_greedy
from repro_torch.configs import get_config
from repro_torch.models import model as tm
from repro_torch.serving.scheduler import ServeRequest

from _torch_state_serving import engines

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

JCFG = jax_get_config("whisper-small").reduced()
TCFG = get_config("whisper-small").reduced().with_(attn_impl="cuda")
#: (prompt length, new tokens): at slots=2 the third request waits for
#: the slot the second frees
REQUESTS = ((21, 4), (5, 4), (1, 4))


@pytest.fixture(scope="module")
def both():
    return engines(JCFG, TCFG)


def _frames(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((TCFG.encdec.n_audio_frames, TCFG.d_model)
                                ).astype(np.float32) for _ in range(n)]


def _trace(cls, frames, fill=None):
    """REQUESTS as `cls` (either package's ServeRequest), request i with
    frames[i] (None: no frames). With `fill`, every prompt token but the
    last is `fill`."""
    rng = np.random.default_rng(1)
    out = []
    for i, (L, n_new) in enumerate(REQUESTS):
        toks = rng.integers(0, TCFG.vocab, size=L, dtype=np.int32)
        if fill is not None:
            toks[:-1] = fill
        out.append(cls(request_id=i, tokens=toks, max_new_tokens=n_new,
                       frames=frames[i]))
    return out


def _streams(eng, frames, fill=None, cls=ServeRequest):
    rep = eng.serving(slots=2).run(_trace(cls, frames, fill))
    return [m.tokens for m in rep.requests], rep


def test_audio_serving_streams_match_jax(both):
    jeng, eng = both
    frames = _frames(0, len(REQUESTS))
    want, jrep = _streams(jeng, frames, cls=JaxRequest)
    got, rep = _streams(eng, frames)
    assert got == want
    assert [len(t) for t in got] == [n for _, n in REQUESTS]
    assert rep.n_prefill_chunks == jrep.n_prefill_chunks == 0
    assert rep.n_decode_steps == jrep.n_decode_steps
    assert rep.n_slots == 2


def test_requests_without_frames_encode_serving_frames(both):
    _, eng = both
    drawn = tm.serving_frames(TCFG, 1, eng.seed, "cpu")[0].numpy()
    assert drawn.shape == (TCFG.encdec.n_audio_frames, TCFG.d_model)
    assert drawn.dtype == np.float32
    got, _ = _streams(eng, [None] * len(REQUESTS))
    want, _ = _streams(eng, [drawn] * len(REQUESTS))
    assert got == want


def test_audio_engine_serve_matches_jax(both):
    jeng, eng = both
    prompts = np.random.default_rng(3).integers(
        0, TCFG.vocab, size=(3, 12), dtype=np.int32)
    got, rep = eng.serve(prompts, gen_tokens=6)
    frames = tm.serving_frames(TCFG, 3, eng.seed, "cpu").numpy()
    cache = jm.prefill_cross_kv(jeng.state.params, JCFG,
                                jnp.asarray(frames),
                                jm.init_cache(JCFG, 3, 12 + 6))
    want, _ = jax_greedy(jeng.state.params, JCFG, cache,
                         jnp.asarray(prompts[:, -1]), 6)
    assert got.tolist() == np.asarray(want).tolist()
    assert rep["batch"] == 3


def test_audio_streams_ignore_all_but_the_last_prompt_token(both):
    jeng, eng = both
    frames = _frames(0, len(REQUESTS))
    for e, cls in ((eng, ServeRequest), (jeng, JaxRequest)):
        assert _streams(e, frames, fill=7, cls=cls)[0] == \
            _streams(e, frames, cls=cls)[0]


def test_other_frames_change_the_stream(both):
    _, eng = both
    got, _ = _streams(eng, _frames(0, len(REQUESTS)))
    other, _ = _streams(eng, _frames(5, len(REQUESTS)))
    assert all(a != b for a, b in zip(got, other))
