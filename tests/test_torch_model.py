"""The port's layers and dense model vs the JAX package on the same
weights (JAX `init_params` converted through `repro_torch.convert`) and
the same numpy inputs: layers, one-shot `prefill` logits and cache,
chunked `prefill_chunk` caches (including a bucketed final chunk that
runs past the cache capacity) and several `decode_step` logits. Reduced
internvl3-2b as dense (2 layers, d_model 256), fp32; the JAX side runs
attention through the Pallas kernel in interpret mode, the port through
the kernel's plain version. atol 1e-4: sums over d_model and vocab are
taken in different orders."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.models import layers as jl
from repro.models import model as jm
from repro_torch.api import Engine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as tl
from repro_torch.models import model as tm

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

ATOL = 1e-4
JCFG = jax_get_config("internvl3-2b").reduced().with_(
    family="dense", vlm=None, attn_impl="pallas")
TCFG = get_config("internvl3-2b").reduced().with_(
    family="dense", vlm=None, attn_impl="cuda")


@pytest.fixture(scope="module")
def weights():
    jp = jm.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, TCFG.vocab, size=shape).astype(np.int32)


# ------------------------------------------------------------------ layers
def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    _close(tl.rms_norm({"scale": torch.from_numpy(scale)},
                       torch.from_numpy(x)),
           jl.rms_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
           atol=1e-6)
    p = jl.init_mlp(jax.random.PRNGKey(1), 32, 48, "swiglu", jnp.float32)
    _close(tl.mlp(params_from_numpy(jax.tree.map(np.asarray, p)),
                  torch.from_numpy(x), "swiglu"),
           jl.mlp(p, jnp.asarray(x), "swiglu"), atol=1e-5)
    table = rng.standard_normal((50, 32)).astype(np.float32)
    ids = rng.integers(0, 50, (2, 7))
    _close(tl.embed(torch.from_numpy(table), torch.from_numpy(ids)),
           jl.embed(jnp.asarray(table), jnp.asarray(ids)), atol=0)
    for tied in (True, False):
        w = table if tied else table.T.copy()
        _close(tl.unembed(torch.from_numpy(w), torch.from_numpy(x),
                          tied),
               jl.unembed(jnp.asarray(w), jnp.asarray(x), tied), atol=1e-5)


@pytest.mark.parametrize("rope_frac", [1.0, 0.5, 0.0])
def test_interleaved_rope_matches_jax(rope_frac):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 9))
    _close(tl.rope_frequencies(16, 5e5, rope_frac),
           jl.rope_frequencies(16, 5e5, rope_frac), atol=1e-7)
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 5e5,
                         rope_frac),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 5e5, rope_frac),
           atol=1e-5)


def test_init_params_tree_matches_jax(weights):
    """The port's own init draws different numbers but the same keys,
    shapes and dtypes as the JAX package's init_params."""
    jp, _ = weights
    ours = tm.init_params(TCFG, seed=0, device="cpu")
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = {jax.tree_util.keystr(p): leaf for p, leaf in
           jax.tree_util.tree_flatten_with_path(ours)[0]}
    assert len(got) == len(want)
    for path, leaf in want:
        t = got[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)


# ---------------------------------------------------------------- model
def test_prefill_logits_and_cache_match_jax(weights):
    jp, tp = weights
    toks = _tokens(2, (3, 45))
    jl_, jc = jm.prefill(jp, JCFG, {"tokens": jnp.asarray(toks)},
                         cache_len=64)
    tl_, tc = tm.prefill(tp, TCFG, {"tokens": torch.from_numpy(toks)},
                         cache_len=64)
    _close(tl_, jl_)
    _close(tc["k"], jc["k"])
    _close(tc["v"], jc["v"])
    assert int(tc["pos"]) == int(jc["pos"]) == 45


def test_chunked_prefill_caches_match_jax(weights):
    """Chunks (0,16), (16,16), then a 16-bucket final chunk at 32 whose
    last 8 rows lie past the 40-row capacity: they must be dropped."""
    jp, tp = weights
    T = 40
    toks = _tokens(3, (1, 48))
    jc = jm.init_cache(JCFG, 1, T)
    tc = tm.init_cache(TCFG, 1, T, device="cpu")
    for start in (0, 16, 32):
        chunk = toks[:, start:start + 16]
        jc = jm.prefill_chunk(jp, JCFG, jc, jnp.asarray(chunk), start)
        tc = tm.prefill_chunk(tp, TCFG, tc, torch.from_numpy(chunk), start)
        _close(tc["k"], jc["k"])
        _close(tc["v"], jc["v"])
    assert int(tc["pos"]) == int(jc["pos"]) == 48


def test_decode_steps_match_jax(weights):
    jp, tp = weights
    toks = _tokens(4, (2, 20))
    _, jc = jm.prefill(jp, JCFG, {"tokens": jnp.asarray(toks)},
                       cache_len=32)
    _, tc = tm.prefill(tp, TCFG, {"tokens": torch.from_numpy(toks)},
                       cache_len=32)
    nxt = _tokens(5, (4, 2))
    for step in range(4):
        jlog, jc = jm.decode_step(jp, JCFG, jc, jnp.asarray(nxt[step]))
        tlog, tc = tm.decode_step(tp, TCFG, tc, torch.from_numpy(nxt[step]))
        _close(tlog, jlog)
    _close(tc["k"], jc["k"])
    assert int(tc["pos"]) == int(jc["pos"]) == 24


def test_engine_without_card_raises_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default placement succeeds")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine("internvl3-2b", reduced=True)
    eng = Engine("internvl3-2b", reduced=True, device="cpu")
    assert eng.device.type == "cpu" and eng.cfg.family == "dense"


def test_engine_serve_one_shot_batch(weights):
    """Engine.serve (fixed batch: prefill + greedy decode) equals the JAX
    Engine.serve on converted weights."""
    from repro.api import Engine as JaxEngine
    from repro_torch.training import TrainState
    jp, tp = weights
    prompts = _tokens(6, (2, 12))
    jeng = JaxEngine(JCFG, seed=0)
    jeng.state = jeng.state._replace(params=jp)
    jout, _ = jeng.serve(jnp.asarray(prompts), gen_tokens=5)
    eng = Engine(TCFG, device="cpu")
    eng.state = TrainState(params=tp)
    out, rep = eng.serve(prompts, gen_tokens=5)
    assert out.tolist() == np.asarray(jout).tolist()
    assert rep["batch"] == 2 and rep["prompt_len"] == 12
