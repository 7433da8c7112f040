"""Checkpoints of the port's train state (`training/checkpoint.py`,
`Engine.save_checkpoint` / `load_checkpoint`), on the CPU.

  * the file format is the JAX package's: a checkpoint its `save` wrote
    restores in the port bit for bit, fp32, bf16 and int leaves (the
    AdamW step: int32 there, int64 here); one the port wrote restores in
    the JAX package (fp32), and its bf16 entries are the JAX package's
    own, raw 2-byte words (whose `restore` refuses a bf16 entry from
    any file, its own included);
  * an engine resume equals an unbroken run, as
    tests/test_training.py::test_checkpoint_full_state_resume holds the
    JAX engine: reduced internvl3-2b, 2 steps, save, a fresh engine
    restores and trains 2 more, against 4 straight (parameters and
    moments bit for bit on one CPU thread, where that test holds 1e-6;
    the step counters, the loader's stream position);
  * the old params-only format loads; a state saved before its first
    update (no optimizer state yet) resumes as an unbroken run;
  * aliasing: the port's AdamW updates its moments in place, so an
    earlier state's moments are the later state's; what `restore`
    returns shares no storage with `like`, and stays as the file held
    it when the engine's moments are updated again.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.training import checkpoint as jckpt
from repro.training import optimizer as jopt
from repro_torch.api import Engine
from repro_torch.training import AdamW, AdamWState, TrainState
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import tree_leaves, tree_map

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

TRAIN_KW = dict(dataset="openvid", global_batch=4, max_tokens=64,
                lookahead=False)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Every run of this module on one CPU thread: with several, two
    identical 4-step runs in one process read up to 2.2e-4 apart in the
    parameters when the machine is loaded (the threads' share of each
    reduction varies, and AdamW's first steps turn a last-bit gradient
    difference into lr x a sign), which no checkpoint could remove; on
    one thread they are equal bit for bit, and so is a resume."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jax_tree(dtype):
    """A train-state tree as the JAX package holds one: params of
    `dtype` (a stacked layer leaf among them), AdamWState with an int32
    step and fp32 moments."""
    rng = np.random.default_rng(0)
    params = {"embed": rng.normal(0, 1, (6, 4)),
              "layers": {"wq": rng.normal(0, 1, (2, 4, 4)),
                         "scale": rng.normal(0, 1, (2, 4))},
              "ln_f": rng.normal(0, 1, (4,))}
    params = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    opt = jopt.AdamW().init(params)
    opt = opt._replace(step=jnp.asarray(7, jnp.int32),
                       m=jax.tree.map(lambda p: p.astype(jnp.float32) / 3,
                                      params))
    return {"params": params, "opt": opt}


def _like(jtree):
    """The port's tree of the same structure: zeros of each leaf's dtype,
    the port's AdamWState with its int64 step."""
    def zeros(a):
        dt = TORCH_DTYPES.get(str(a.dtype), torch.float32)
        return torch.zeros(a.shape, dtype=dt)

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        return zeros(t)
    o = jtree["opt"]
    return {"params": tree(jtree["params"]),
            "opt": AdamWState(step=torch.zeros((), dtype=torch.int64),
                              m=tree(o.m), v=tree(o.v))}


def _state_leaves(tree):
    """The tensors of {"params": ..., "opt": AdamWState}."""
    return [*tree_leaves(tree["params"]), tree["opt"].step,
            *tree_leaves(tree["opt"].m), *tree_leaves(tree["opt"].v)]


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes (bf16 as its 16-bit words)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint8)
        return x.numpy().view(np.uint8)
    return np.asarray(x).view(np.uint8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, dtype):
    jtree = _jax_tree(dtype)
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, jtree, meta={"format": 2, "step": 7})
    got = ckpt.restore(path, _like(jtree))
    assert ckpt.load_meta(path) == {"format": 2, "step": 7}
    jp, jo = jtree["params"], jtree["opt"]
    for a, b in zip(tree_leaves(got["params"]), jax.tree.leaves(jp)):
        assert a.dtype == TORCH_DTYPES[dtype]
        np.testing.assert_array_equal(_bits(a), _bits(np.asarray(b)))
    for a, b in zip(tree_leaves(got["opt"].m), jax.tree.leaves(jo.m)):
        np.testing.assert_array_equal(_bits(a), _bits(np.asarray(b)))
    assert got["opt"].step.dtype == torch.int64
    assert int(got["opt"].step) == 7


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_jax(tmp_path, dtype):
    """The port's file holds the JAX package's entries: the same names,
    types and bytes. fp32 restores through the JAX `restore`; a bf16
    entry it refuses from its own file as from the port's (numpy has no
    cast from raw 2-byte words to ml_dtypes' bfloat16), so that half is
    held entry for entry and through the port's `restore`."""
    jtree = _jax_tree(dtype)
    like = _like(jtree)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save(jpath, jtree, meta={"step": 7})
    tree = ckpt.restore(jpath, like)
    ckpt.save(tpath, tree, meta={"step": 7})
    with np.load(jpath) as want, np.load(tpath) as got:
        assert sorted(got.files) == sorted(want.files)
        for name in want.files:
            if name == "opt::step":      # int32 there, int64 here
                assert got[name].shape == want[name].shape == ()
                assert int(got[name]) == int(want[name]) == 7
                continue
            assert got[name].dtype == want[name].dtype, name
            assert got[name].tobytes() == want[name].tobytes(), name
    if dtype == "float32":
        back = jckpt.restore(tpath, jtree)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        for path in (jpath, tpath):
            with pytest.raises(ValueError, match="No cast function"):
                jckpt.restore(path, jtree)
        again = ckpt.restore(tpath, like)
        for a, b in zip(_state_leaves(again), _state_leaves(tree)):
            assert torch.equal(a, b)


def _engine():
    """Reduced internvl3-2b on the CPU at the JAX test's lr of 1e-3."""
    eng = Engine("internvl3-2b", reduced=True, seed=0, device="cpu")
    eng.optimizer = AdamW(lr=1e-3)
    return eng


def _assert_equal(a_tree, b_tree):
    for a, b in zip(tree_leaves(a_tree), tree_leaves(b_tree)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def unbroken():
    """Four steps straight, and the engine's params after two."""
    eng = _engine()
    eng.train(steps=2, **TRAIN_KW)
    at_two = [t.clone() for t in tree_leaves(eng.state.params)]
    full = _engine()
    full.train(steps=4, **TRAIN_KW)
    eng.close()
    full.close()
    return eng, at_two, full


def test_engine_resume_equals_unbroken_run(tmp_path, unbroken):
    eng, _, full = unbroken
    path = str(tmp_path / "ckpt.npz")
    eng.save_checkpoint(path)
    assert ckpt.load_meta(path)["loader"]["batch_index"] == 2
    resumed = _engine()
    resumed.load_checkpoint(path)
    assert resumed._step == 2
    assert int(resumed.state.opt.step) == 2      # the moments came back
    resumed.train(steps=2, **TRAIN_KW)
    resumed.close()
    assert resumed.loader.batch_index == 4       # continued the stream
    assert resumed._step == 4 and int(resumed.state.opt.step) == 4
    _assert_equal(full.state.params, resumed.state.params)
    _assert_equal(full.state.opt.m, resumed.state.opt.m)
    _assert_equal(full.state.opt.v, resumed.state.opt.v)


def test_old_params_only_format_loads(tmp_path):
    eng = _engine()
    path = str(tmp_path / "old.npz")
    ckpt.save(path, eng.state.params)             # no meta blob
    other = Engine("internvl3-2b", reduced=True, seed=1, device="cpu")
    other.load_checkpoint(path)
    for a, b in zip(tree_leaves(eng.state.params),
                    tree_leaves(other.state.params)):
        assert torch.equal(a, b)
    assert other.state.opt is None and other._step == 0
    eng.close()
    other.close()


def test_state_saved_before_its_first_update_resumes(tmp_path, unbroken):
    """No optimizer state yet: the file holds the parameters alone; the
    engine that loads it allocates fresh moments at its first step, so
    two steps after the resume equal two steps straight."""
    _, at_two, _ = unbroken
    fresh = _engine()
    path = str(tmp_path / "fresh.npz")
    fresh.save_checkpoint(path)
    fresh.close()
    assert not any(n.startswith("opt") for n in ckpt.entries(path))
    assert ckpt.load_meta(path) == {"format": 2, "step": 0}
    other = _engine()           # the same seed: the same loader stream
    other.state = TrainState(params=tree_map(torch.zeros_like,
                                             other.state.params))
    other.load_checkpoint(path)
    assert other.state.opt is None
    other.train(steps=2, **TRAIN_KW)
    other.close()
    for a, b in zip(tree_leaves(other.state.params), at_two):
        assert torch.equal(a, b)


def test_saved_state_is_a_snapshot(tmp_path):
    """The moments are updated in place: the state before a step shares
    them with the state after it. A restored tree shares no storage with
    `like`, and keeps the file's values when the engine steps again."""
    eng = _engine()
    eng.train(steps=1, **TRAIN_KW)
    before = eng.state
    m_before = [t.clone() for t in tree_leaves(before.opt.m)]
    path = str(tmp_path / "one.npz")
    eng.save_checkpoint(path)
    like = {"params": before.params, "opt": before.opt}
    back = ckpt.restore(path, like)
    ptrs = {t.untyped_storage().data_ptr() for t in _state_leaves(like)}
    assert not ptrs & {t.untyped_storage().data_ptr()
                       for t in _state_leaves(back)}
    eng.train(steps=1, **TRAIN_KW)
    eng.close()
    after = eng.state
    assert all(a is b for a, b in zip(tree_leaves(before.opt.m),
                                      tree_leaves(after.opt.m)))
    assert any(not torch.equal(a, b)
               for a, b in zip(tree_leaves(before.opt.m), m_before))
    for a, b in zip(tree_leaves(back["opt"].m), m_before):
        assert torch.equal(a, b)
    assert int(back["opt"].step) == 1 and int(after.opt.step) == 2
    assert os.path.exists(path)
