"""Checks shared by the port's serving tests against the JAX package
(tests/test_torch_ssm_serving.py, test_torch_hybrid_serving.py and
test_torch_sliding_serving.py): engines on converted weights, traces
whose slots are reused, decode logits over many tokens, token streams.
"""
import numpy as np
import torch

import jax
import jax.numpy as jnp
from repro.api import Engine as JaxEngine
from repro.models import model as jm
from repro.serving.scheduler import ServeRequest as JaxRequest
from repro_torch.api import Engine
from repro_torch.convert import params_from_numpy
from repro_torch.models import model as tm
from repro_torch.serving.scheduler import ServeRequest
from repro_torch.training import TrainState

#: a decode step's outputs and states against the JAX function's
STEP_TOL = 1e-5
#: decode_step logits against the JAX decode_step's
JAX_TOL = 1e-4
#: decode_step logits against the port's own forward (the JAX package's
#: test_ssm_decode_equals_chunked_scan / test_hybrid_decode_equals_forward)
FWD_TOL = 2e-3


def scaled_err(got, want) -> float:
    """Largest |got - want| / max(1, |want|)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want) / np.maximum(1.0,
                                                        np.abs(want))))


def engines(jcfg, tcfg):
    """The JAX engine, and the port's on the CPU with its weights."""
    jeng = JaxEngine(jcfg, seed=0)
    eng = Engine(tcfg, device="cpu", seed=0)
    eng.state = TrainState(params=params_from_numpy(
        jax.tree.map(np.asarray, jeng.state.params)))
    return jeng, eng


#: (prompt length, new tokens, arrival): at slots=2 requests 2-3 wait for
#: a slot that an earlier request frees; the last arrives (on the
#: runtime's virtual clock) after every earlier request has finished
REQUESTS = ((21, 4, 0.0), (5, 6, 0.0), (1, 3, 0.0), (9, 5, 0.0),
            (7, 4, 1e3))


def trace(cls, vocab: int, requests=REQUESTS, fill=None):
    """The requests as `cls` (either package's ServeRequest). With
    `fill`, every prompt token but the last is `fill`."""
    rng = np.random.default_rng(1)
    out = []
    for i, (L, n_new, arrival) in enumerate(requests):
        toks = rng.integers(0, vocab, size=L, dtype=np.int32)
        if fill is not None:
            toks[:-1] = fill
        out.append(cls(request_id=i, tokens=toks, max_new_tokens=n_new,
                       arrival_s=arrival))
    return out


def streams(rep):
    return [m.tokens for m in rep.requests]


def serve_both(jeng, eng, requests=REQUESTS, fill=None, **kw):
    """Both runtimes over the same trace: (JAX report, port report)."""
    jrep = jeng.serving(**kw).run(
        trace(JaxRequest, jeng.cfg.vocab, requests, fill))
    rep = eng.serving(**kw).run(
        trace(ServeRequest, eng.cfg.vocab, requests, fill))
    return jrep, rep


def decode_both(jeng, eng, n_tokens: int = 80, batch: int = 2,
                cache_len: int = 96):
    """`n_tokens` decode steps of both packages from a zero cache on the
    same tokens: (tokens [B,S], JAX logits [B,S,V], port logits)."""
    jcfg, tcfg = jeng.cfg, eng.cfg
    toks = np.random.default_rng(2).integers(
        0, tcfg.vocab, size=(batch, n_tokens), dtype=np.int32)
    jstep = jax.jit(lambda p, c, t: jm.decode_step(p, jcfg, c, t))
    jparams = jeng.state.params
    jcache = jm.init_cache(jcfg, batch, cache_len)
    cache = tm.init_cache(tcfg, batch, cache_len, device="cpu")
    jout, out = [], []
    for t in range(n_tokens):
        lg, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t]))
        jout.append(np.asarray(lg))
        lg, cache = tm.decode_step(eng.state.params, tcfg, cache,
                                   torch.as_tensor(toks[:, t]))
        out.append(lg.numpy())
    return toks, np.stack(jout, 1), np.stack(out, 1)


def assert_cache_like_jax(jcfg, tcfg, batch: int = 3,
                          cache_len: int = 40):
    """init_cache's leaves: the JAX names, shapes and float dtypes (pos
    is the port's int64 where the JAX package's is int32)."""
    want = jm.init_cache(jcfg, batch, cache_len)
    got = tm.init_cache(tcfg, batch, cache_len, device="cpu")
    assert sorted(got) == sorted(want)
    for name, leaf in want.items():
        assert tuple(got[name].shape) == tuple(leaf.shape), name
        if name == "pos":
            assert got[name].dtype == torch.long
        else:
            assert str(got[name].dtype).split(".")[-1] == str(leaf.dtype)
    for name, axis in tm.cache_batch_axes(tcfg).items():
        assert got[name].shape[axis] == batch, name


def assert_engine_serve_like_jax(jeng, eng, prompts, gen_tokens=6):
    jout, _ = jeng.serve(jnp.asarray(prompts), gen_tokens=gen_tokens)
    out, rep = eng.serve(prompts, gen_tokens=gen_tokens)
    assert out.tolist() == np.asarray(jout).tolist()
    assert rep["batch"] == prompts.shape[0]
