"""The port's SSM training slice against the JAX package on the CPU.

Same weights (JAX `init_params` converted through `repro_torch.convert`),
same numpy inputs, fp32:

  * the mamba2-370m config, full and reduced, field for field;
  * `padded_batch` array for array;
  * K3's plain version (the CPU path of `kernels/ssd_chunk`) against the
    Pallas kernel in interpret mode and `ssd_chunk_ref`: forward at
    1e-4 (bf16 inputs 5e-2), the gradient against `jax.grad` of
    `ssd_chunk_ref` at 1e-4 where that gradient is finite (c <= 64);
  * at mamba2-370m's own chunk (c = 256, the model's dt) the JAX
    gradient is NaN, the port's is finite and equals `jax.grad` of a
    sequential-recurrence oracle;
  * `ssd_chunk_scan` and `ssm_forward` against the JAX versions (2e-4);
  * the reduced model's logits, loss (2e-5) and gradient (1e-4) on a
    padded batch, and two `Engine.train` steps, against a reference
    composed from JAX package functions: `padded_batch`, `forward`,
    `executor._masked_nll`, `jax.value_and_grad` and the JAX `AdamW`.
    The JAX `Engine.train` itself is not the reference: inside its
    `shard_map` the SSM's `lax.scan` fails (a scan-carry error), so the
    reference runs the same functions without it;
  * the executor's padded path for the SSM family: its step keys and
    padded token counts.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.api import Engine as JaxEngine
from repro.configs import get_config as jax_get_config
from repro.core import executor as jexec
from repro.data.pipeline import HeterogeneousLoader as JaxLoader
from repro.data.pipeline import padded_batch as jax_padded_batch
from repro.kernels.ops import ssd_chunk_scan as jax_ssd_chunk_scan
from repro.kernels.ref import ssd_chunk_ref as jax_ssd_chunk_ref
from repro.kernels.ssd_chunk import ssd_chunk_pallas
from repro.models import model as jm
from repro.models import ssm as jssm
from repro.training import optimizer as jopt
from repro_torch.api import Engine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import HeterogeneousLoader, padded_batch
from repro_torch.kernels.ssd_chunk import (ssd_chunk, ssd_chunk_ref,
                                           ssd_chunk_scan)
from repro_torch.models import model as tm
from repro_torch.models.ssm import ssm_forward
from repro_torch.training import TrainState
from repro_torch.training.optimizer import tree_map

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

LOSS_TOL, GRAD_TOL = 2e-5, 1e-4
RUN = dict(dataset="openvid", global_batch=4, max_tokens=256,
           tokens_per_frame=16)
JCFG = jax_get_config("mamba2-370m").reduced()
TCFG = get_config("mamba2-370m").reduced()


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return np.asarray(tree, np.float32)


def _assert_trees_close(a, b, atol):
    a, b = _np_tree(a), _np_tree(b)
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_close(a[k], b[k], atol)
        else:
            np.testing.assert_allclose(a[k], b[k], atol=atol, err_msg=k)


def _close(a, b, tol):
    """Every element within tol * max(1, |b|) of b."""
    a = a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    assert a.shape == b.shape
    assert np.all(np.abs(a - b) <= tol * np.maximum(1.0, np.abs(b))), \
        float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))


def _loader(cls, vocab=TCFG.vocab):
    return cls(RUN["dataset"], RUN["global_batch"], vocab, seed=0,
               max_tokens=RUN["max_tokens"],
               tokens_per_frame=RUN["tokens_per_frame"])


# ------------------------------------------------------------- config
@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_matches_jax(which):
    ours, theirs = get_config("mamba2-370m"), jax_get_config("mamba2-370m")
    if which == "reduced":
        ours, theirs = ours.reduced(), theirs.reduced()
    for f in dataclasses.fields(ours):
        if f.name == "attn_impl" and which == "full":
            # the port's default runs its kernels ("cuda"), the JAX
            # package's its chunked attention
            continue
        mine = getattr(ours, f.name)
        want = getattr(theirs, f.name)
        if dataclasses.is_dataclass(mine):
            assert dataclasses.asdict(mine) == dataclasses.asdict(want), \
                f.name
        else:
            assert mine == want, f.name
    assert ours.ssm.d_state == (128 if which == "full" else 16)


# --------------------------------------------------------------- data
@pytest.mark.parametrize("bucket", [256, 512])
def test_padded_batch_equals_jax(bucket):
    a, b = next(_loader(HeterogeneousLoader)), next(_loader(JaxLoader))
    for ids in ([0, 1, 2], [3]):
        for with_spans in (True, False):
            spans = ([a.infos[i].spans for i in ids] if with_spans
                     else None)
            jspans = ([b.infos[i].spans for i in ids] if with_spans
                      else None)
            ours = padded_batch([a.by_id(i) for i in ids], bucket,
                                spans=spans)
            theirs = jax_padded_batch([b.by_id(i) for i in ids], bucket,
                                      spans=jspans)
            assert sorted(ours) == sorted(theirs)
            assert ("modality_ids" in ours) == with_spans
            for k in theirs:
                assert ours[k].dtype == theirs[k].dtype, k
                assert np.array_equal(ours[k], theirs[k]), k


# ------------------------------------------------------------- kernel K3
def _ssd_inputs(G, c, N, P, seed=0, model_dt=False):
    """C, B, x, da, dt in the JAX layout, fp32 numpy. `model_dt`: dt as
    the model makes it at init (softplus(.) + 1e-3, A = -1), whose sum
    over a 256-token chunk is about 200; else da = -dt * U(0.05, 1), as
    the JAX kernel tests draw it."""
    rng = np.random.default_rng(seed)
    C = (rng.standard_normal((G, c, N)) * 0.3).astype(np.float32)
    B = (rng.standard_normal((G, c, N)) * 0.3).astype(np.float32)
    x = rng.standard_normal((G, c, P)).astype(np.float32)
    dt = (np.logaddexp(rng.standard_normal((G, c)), 0.0) + 1e-3)
    if model_dt:
        da = -dt
    else:
        da = -dt * rng.uniform(0.05, 1.0, (G, c))
    return C, B, x, da.astype(np.float32), dt.astype(np.float32)


def _t(arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


SHAPES = [(3, 64, 32, 16), (2, 128, 128, 64), (1, 128, 64, 128),
          (4, 32, 16, 8)]


@pytest.mark.parametrize("G,c,N,P", SHAPES)
def test_plain_forward_matches_pallas_and_ref(G, c, N, P):
    ins = _ssd_inputs(G, c, N, P)
    want_k = ssd_chunk_pallas(*map(jnp.asarray, ins))   # interpret mode
    want_r = jax_ssd_chunk_ref(*map(jnp.asarray, ins))
    got = ssd_chunk_ref(*_t(ins))
    # the model layout's CPU path is the same function (H = 1, Bsz = G)
    C, B, x, da, dt = _t(ins)
    got_m = ssd_chunk(C, B, x[:, :, None], da[..., None], dt[..., None],
                      chunk=c)
    for name, a, m, k, r in zip(("y", "states", "cum"), got, got_m,
                                want_k, want_r):
        _close(a, k, 1e-4)
        _close(a, r, 1e-4)
        _close(m.reshape(a.shape), k, 1e-4)


def test_plain_forward_bf16_matches_pallas():
    ins = _ssd_inputs(2, 64, 32, 16, seed=1)
    jins = [jnp.asarray(a, jnp.bfloat16) for a in ins]
    want = ssd_chunk_pallas(*jins)
    got = ssd_chunk_ref(*_t(ins, torch.bfloat16))
    for a, k in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(k, np.float32),
                                   atol=5e-2, rtol=5e-2)


def _jax_vjp(fn, ins, cots):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, ins))
    return vjp(tuple(map(jnp.asarray, cots)))


def _port_grad(ins, cots):
    ts = [t.requires_grad_(True) for t in _t(ins)]
    outs = ssd_chunk_ref(*ts)
    return torch.autograd.grad(outs, ts, _t(cots))


def _cotangents(G, c, N, P, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((G, c, P), (G, N, P), (G, c))]


@pytest.mark.parametrize("G,c,N,P", [s for s in SHAPES if s[1] <= 64])
def test_plain_gradient_matches_jax_grad(G, c, N, P):
    ins = _ssd_inputs(G, c, N, P, seed=2)
    cots = _cotangents(G, c, N, P, seed=3)
    want = _jax_vjp(jax_ssd_chunk_ref, ins, cots)
    got = _port_grad(ins, cots)
    for a, w in zip(got, want):
        assert np.isfinite(np.asarray(w)).all()
        _close(a, w, 1e-4)


def _recurrence_oracle(C, B, x, da, dt):
    """The SSD chunk as its sequential recurrence, per cell: h_t =
    exp(da_t) h_{t-1} + dt_t B_t x_t^T, y_t = C_t h_t; states = h_c.
    Its gradient holds no exp of a positive sum."""
    def cell(Cg, Bg, xg, dag, dtg):
        def step(h, inp):
            Ct, Bt, xt, at, dtt = inp
            h = jnp.exp(at) * h + dtt * jnp.outer(Bt, xt)
            return h, Ct @ h
        h0 = jnp.zeros((Cg.shape[1], xg.shape[1]), jnp.float32)
        h, ys = jax.lax.scan(step, h0, (Cg, Bg, xg, dag, dtg))
        return ys, h, jnp.cumsum(dag)
    return jax.vmap(cell)(C, B, x, da, dt)


def test_gradient_at_full_chunk_is_finite_where_jax_is_nan():
    """mamba2-370m's chunk, 256, with the model's dt: above the diagonal
    cum_i - cum_j reaches some 200 and exp overflows. JAX's ref takes it
    there and its gradient is NaN; the port's mask keeps it finite, equal
    to the gradient of the recurrence."""
    G, c, N, P = 2, 256, 16, 8
    ins = _ssd_inputs(G, c, N, P, seed=4, model_dt=True)
    assert ins[4].sum(axis=1).min() > 150
    cots = _cotangents(G, c, N, P, seed=5)
    jax_grad = _jax_vjp(jax_ssd_chunk_ref, ins, cots)
    assert np.isnan(np.asarray(jax_grad[3])).any()       # dda
    want = _jax_vjp(_recurrence_oracle, ins, cots)
    got = _port_grad(ins, cots)
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        assert np.isfinite(np.asarray(w)).all()
        _close(a, w, 1e-4)
    # the forward agrees with the recurrence too
    for a, w in zip(ssd_chunk_ref(*_t(ins)), _recurrence_oracle(
            *map(jnp.asarray, ins))):
        _close(a, w, 1e-4)


def test_ssd_chunk_scan_matches_jax_and_recurrence():
    Bsz, S, H, P, N, c = 2, 96, 2, 8, 16, 32
    nc, G = S // c, Bsz * H
    rng = np.random.default_rng(6)
    Cm = (rng.standard_normal((Bsz, S, N)) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((Bsz, S, N)) * 0.3).astype(np.float32)
    xh = rng.standard_normal((Bsz, S, H, P)).astype(np.float32)
    dt = (np.logaddexp(rng.standard_normal((Bsz, S, H)), 0)
          + 1e-3).astype(np.float32)
    A = -rng.uniform(0.1, 1.0, H).astype(np.float32)
    da = dt * A
    got = ssd_chunk_scan(*_t((Cm, Bm, xh, da, dt)), chunk=c)
    got_plain = ssd_chunk_scan(*_t((Cm, Bm, xh, da, dt)), chunk=c,
                               plain=True)
    # JAX layout [G, nc, c, .] with C and B broadcast to the heads
    rep = lambda t: np.broadcast_to(  # noqa: E731
        t.reshape(Bsz, 1, nc, c, N), (Bsz, H, nc, c, N)).reshape(
            G, nc, c, N)
    per_head = lambda t: np.moveaxis(t, 2, 1).reshape(  # noqa: E731
        (G, nc, c) + t.shape[3:])
    want = jax_ssd_chunk_scan(rep(Cm), rep(Bm), per_head(xh),
                              per_head(da), per_head(dt))
    want = np.moveaxis(np.asarray(want).reshape(Bsz, H, S, P), 1, 2)
    _close(got, want, 1e-4)
    _close(got_plain, want, 1e-4)
    # the whole sequence as one recurrence per head
    ys, _, _ = _recurrence_oracle(*(jnp.asarray(a) for a in (
        rep(Cm).reshape(G, S, N), rep(Bm).reshape(G, S, N),
        per_head(xh).reshape(G, S, P), per_head(da).reshape(G, S),
        per_head(dt).reshape(G, S))))
    oracle = np.moveaxis(np.asarray(ys).reshape(Bsz, H, S, P), 1, 2)
    _close(got, oracle, 1e-4)


@pytest.mark.parametrize("D,dS,hd,chunk,S", [(32, 16, 8, 16, 40),
                                             (64, 16, 32, 32, 70)])
def test_ssm_forward_matches_jax(D, dS, hd, chunk, S):
    params = jssm.init_ssm(jax.random.PRNGKey(21), D, d_state=dS,
                           head_dim=hd, expand=2, conv_width=4,
                           dtype=jnp.float32)
    # the JAX init leaves A_log, dt_bias at 0 and D at 1: move them off
    # so that the test sees each one's role
    rng = np.random.default_rng(7)
    H = 2 * D // hd
    params = dict(params, A_log=jnp.asarray(rng.uniform(-1, 1, H),
                                            jnp.float32),
                  dt_bias=jnp.asarray(rng.uniform(-1, 1, H), jnp.float32),
                  D=jnp.asarray(rng.uniform(0.5, 1.5, H), jnp.float32))
    x = (rng.standard_normal((2, S, D)) * 0.5).astype(np.float32)
    kw = dict(d_state=dS, head_dim=hd, expand=2, chunk=chunk)
    tp = params_from_numpy(jax.tree.map(np.asarray, params))
    got = ssm_forward(tp, torch.from_numpy(x), **kw)
    got_ref = ssm_forward(tp, torch.from_numpy(x), impl="reference", **kw)
    for impl in ("pallas", "jnp"):
        want = jssm.ssm_forward(params, jnp.asarray(x), impl=impl, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(got_ref.numpy(), np.asarray(want),
                                   atol=2e-4, rtol=2e-4)


# ------------------------------------------------ model and training
def _jax_loss_fn(with_spans):
    """The JAX executor's per-group loss, without its shard_map."""
    def loss_fn(params, batch):
        logits, _ = jm.forward(params, JCFG, batch)
        if not with_spans:
            s, c = jexec._masked_nll(logits, batch["labels"],
                                     batch["mask"])
        else:
            nll = jexec._token_nll(logits, batch["labels"])
            s, c = (nll * batch["loss_mask"]).sum(), batch["loss_mask"].sum()
        return s / jnp.maximum(c, 1.0)
    return loss_fn


_VG = {w: jax.jit(jax.value_and_grad(_jax_loss_fn(w))) for w in (0, 1)}


def _jax_batch_grad(params, plan, data, bucket_of):
    """(mean loss, token-weighted mean gradient) of a plan, the groups
    padded with the JAX `padded_batch` to `bucket_of(longest)`, weighted
    as the executor weights them."""
    spans_by_id = data.spans_by_id()
    loss_acc, g_acc, total = 0.0, None, 0.0
    for mb in plan.micro_batches:
        for g in mb.groups:
            seqs = [data.by_id(i) for i in g.seq_ids]
            bucket = bucket_of(max(len(s) for s in seqs))
            b = jax_padded_batch(seqs, bucket, spans=[
                spans_by_id.get(i) for i in g.seq_ids])
            w = float(b.get("loss_mask", b["mask"]).sum())
            loss, grads = _VG["modality_ids" in b](
                params, {k: jnp.asarray(v) for k, v in b.items()})
            total += w
            loss_acc += float(loss) * w
            gw = jax.tree.map(lambda a: np.asarray(a, np.float32) * w, grads)
            g_acc = gw if g_acc is None else jax.tree.map(np.add, g_acc, gw)
    return loss_acc / total, jax.tree.map(lambda a: a / total, g_acc)


@pytest.fixture(scope="module")
def reference():
    """JAX reference on reduced mamba2-370m (one CPU device): the first
    batch's logits, loss and gradient, then two training steps with the
    JAX AdamW, on the JAX engine's plans."""
    params0 = jm.init_params(jax.random.PRNGKey(0), JCFG)
    jeng = JaxEngine("mamba2-370m", reduced=True)
    bucket_of = jeng.cluster.pool().bucket
    loader = _loader(JaxLoader)
    data0 = next(loader)
    plan0 = jeng.plan(data0)
    b0 = jax_padded_batch([data0.by_id(i) for i in range(2)], 256)
    logits0, _ = jm.forward(params0, JCFG, {k: jnp.asarray(v)
                                            for k, v in b0.items()})
    loss0, grads0 = _jax_batch_grad(params0, plan0, data0, bucket_of)
    # two steps: AdamW(lr=3e-4), as the Engine's optimizer
    opt = jopt.AdamW(lr=3e-4)
    params, state = params0, opt.init(params0)
    losses, hashes = [], []
    data = _loader(JaxLoader)
    for _ in range(2):
        d = next(data)
        plan = jeng.plan(d)
        hashes.append(plan.structural_hash())
        loss, grads = _jax_batch_grad(params, plan, d, bucket_of)
        params, state = opt.update(jax.tree.map(jnp.asarray, grads), state,
                                   params)
        losses.append(loss)
    jeng.close()
    # what the JAX executor keys for the first batch's groups
    jx = jexec.DHPExecutor(JCFG, pool=jeng.cluster.pool())
    keys0 = []
    spans_by_id = data0.spans_by_id()
    for mi, gi, start, _ in plan0.group_slots(jx.pool.n_replicas):
        g = plan0.micro_batches[mi].groups[gi]
        seqs = [data0.by_id(i) for i in g.seq_ids]
        b, _, _, bucket = jx._group_batch(
            seqs, g.degree, spans=[spans_by_id.get(i) for i in g.seq_ids])
        keys0.append(jx._group_grad_fn(start, g.degree, len(seqs), bucket,
                                       "modality_ids" in b)[2])
    return dict(params0=jax.tree.map(np.asarray, params0), b0=b0,
                logits0=np.asarray(logits0), loss0=loss0, grads0=grads0,
                losses=losses, hashes=hashes, keys0=keys0,
                params=jax.tree.map(np.asarray, params))


def _port_engine(params0, **kw):
    eng = Engine("mamba2-370m", reduced=True, device="cpu", **kw)
    eng.state = TrainState(params=params_from_numpy(params0))
    return eng


def test_ssm_leaves_convert_unchanged(reference):
    p = params_from_numpy(reference["params0"])
    L, H = TCFG.n_layers, 2 * TCFG.d_model // TCFG.ssm.head_dim
    ssm = p["layers"]["ssm"]
    for k in ("A_log", "D", "dt_bias"):
        assert ssm[k].dtype == torch.float32 and ssm[k].shape == (L, H)
    W, Cw = TCFG.ssm.conv_width, 2 * TCFG.d_model + 2 * TCFG.ssm.d_state
    assert ssm["conv"].shape == (L, W, Cw)
    mine = tm.init_params(TCFG, seed=0, device="cpu")
    assert jax.tree.structure(tree_map(lambda t: 0, mine)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, reference["params0"]))
    for a, b in zip(jax.tree.leaves(tree_map(lambda t: tuple(t.shape), mine),
                                    is_leaf=lambda t: isinstance(t, tuple)),
                    jax.tree.leaves(jax.tree.map(lambda a: a.shape,
                                                 reference["params0"]),
                                    is_leaf=lambda t: isinstance(t, tuple))):
        assert a == b


@pytest.mark.parametrize("impl", ["cuda", "reference"])
def test_logits_loss_and_gradient_match_jax(reference, impl):
    eng = _port_engine(reference["params0"])
    eng.cfg = eng.cfg.with_(attn_impl=impl)
    b0 = {k: torch.from_numpy(v) for k, v in reference["b0"].items()}
    with torch.no_grad():
        logits, _ = tm.forward(eng.state.params, eng.cfg, b0)
    np.testing.assert_allclose(logits.numpy(), reference["logits0"],
                               atol=1e-4)
    data0 = next(_loader(HeterogeneousLoader))
    loss0, grads0 = eng.executor.run_plan(eng.state.params,
                                          eng.plan(data0), data0)
    eng.close()
    assert abs(float(loss0) - reference["loss0"]) <= LOSS_TOL
    _assert_trees_close(grads0, reference["grads0"], GRAD_TOL)
    assert eng.executor.last_exe_keys == reference["keys0"]


def test_engine_train_matches_jax_reference(reference):
    eng = _port_engine(reference["params0"])
    plans = []
    history = eng.train(steps=2, lookahead=True, plan_log=plans, **RUN)
    eng.close()
    assert [p.structural_hash() for p in plans] == reference["hashes"]
    np.testing.assert_allclose([m.loss for m in history],
                               reference["losses"], atol=LOSS_TOL)
    _assert_trees_close(eng.state.params, reference["params"], GRAD_TOL)
    assert all(m.padding_efficiency < 1.0 for m in history)


def test_executor_runs_ssm_padded():
    eng = Engine("mamba2-370m", reduced=True, device="cpu")
    assert eng.executor.packed is False
    data = next(_loader(HeterogeneousLoader))
    timings = []
    eng.executor.run_plan(eng.state.params, eng.plan(data), data,
                          timings=timings)
    keys = eng.executor.last_exe_keys
    assert keys and all(k[0] == "grad" and len(k) >= 5 for k in keys)
    for k, t in zip(keys, timings):
        n_seqs, bucket = k[3], k[4]
        assert n_seqs == len(t["seq_ids"]) and bucket == t["bucket"]
        assert t["padded_tokens"] == n_seqs * bucket
    cache = tm.init_cache(eng.cfg, 1, 16, device="cpu")
    assert cache["h"].shape[:2] == (eng.cfg.n_layers, 1)
    with pytest.raises(NotImplementedError, match="SSM serving"):
        tm.prefill(eng.state.params, eng.cfg,
                   {"tokens": torch.zeros(1, 4, dtype=torch.long)})

