"""The model's ring path on striped shards against the JAX package on the
CPU.

Reduced internvl3-2b as the executors run it (`family="dense",
vlm=None`), the JAX `init_params` taken through
`convert.params_from_numpy`. One packed group of the `openvid` stream
(segments, bidirectional frame spans, tail padding; the bucket a
multiple of 3) is laid over a ring of degree 3 in both layouts: the
striped one permutes the buffer so that shard r holds tokens i 3 + r,
every table (`positions` per segment, `segment_ids`, `modality_ids`,
labels, masks) permuted alike. The JAX side is the JAX executor's own
span-bearing step (`DHPExecutor._build_grad_fn`: the model with
`cp_axis="cp"` under `shard_map` over `P(None, "cp")`, the loss-masked
NLL summed by `psum`) on 3 forced host devices, in one module-scoped
subprocess (`tests/conftest.py::run_in_subprocess`). The port runs
`executor.token_nll` with `ring=LocalRing(3, striped=...)`, every hop
through K1's plain version, and the same masked mean.

Limits are the executor tests' (`tests/test_torch_ring_executor.py`):
loss 2e-5, gradients 1e-4.
"""
import numpy as np
import pytest
import torch

from conftest import run_in_subprocess
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.executor import token_nll
from repro_torch.core.packing import flatten_group
from repro_torch.data.pipeline import HeterogeneousLoader
from repro_torch.parallel import LocalRing
from repro_torch.training.optimizer import tree_leaves, tree_map

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

LOSS_TOL, GRAD_TOL = 2e-5, 1e-4
DEGREE = 3
#: the group: the first GROUP_SEQS sequences of the stream's first batch
#: (each with frames, cut at 96 tokens), packed into a bucket of BUCKET
#: tokens
STREAM = dict(dataset="openvid", global_batch=8, seed=1, max_tokens=96,
              tokens_per_frame=16)
GROUP_SEQS, BUCKET = 3, 3 * 104
#: the batch's tables, each [1, BUCKET]
KEYS = ("tokens", "labels", "mask", "positions", "segment_ids",
        "modality_ids", "loss_mask", "modality_classes")

JAX_SCRIPT = """
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.core.executor import DHPExecutor
from repro.models.model import init_params

cfg = get_config("internvl3-2b").reduced().with_(family="dense", vlm=None)
params = init_params(jax.random.PRNGKey(0), cfg)
exe = DHPExecutor(cfg, devices=jax.devices()[:{d}])
step = exe._build_grad_fn(exe.pool.mesh_for(0, {d}), True)()
inp = dict(np.load({inp!r}))
out = {{}}

def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(p.key for p in path)] = np.asarray(leaf,
                                                                 np.float32)

put("params/", params)
for layout in ("contiguous", "striped"):
    batch = {{k: jnp.asarray(inp[layout + "/" + k]) for k in {keys!r}}}
    loss, grads, _ = step(params, batch)
    out[layout + "/loss"] = np.float64(loss)
    put(layout + "/grads/", grads)
np.savez({out!r}, **out)
print("jax striped model reference ok")
"""


def _tree(flat, prefix):
    out = {}
    for key, arr in flat.items():
        if key.startswith(prefix):
            *path, leaf = key[len(prefix):].split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = arr
    return out


def _stripe(S):
    """The striped order: place r S_loc + i holds token i d + r."""
    return np.arange(S).reshape(S // DEGREE, DEGREE).T.reshape(-1)


def _group(vocab):
    """{layout: {key: [1, BUCKET] array}}: the packed group in token order
    and permuted into the striped order."""
    kw = dict(STREAM)
    data = next(HeterogeneousLoader(kw.pop("dataset"),
                                    kw.pop("global_batch"), vocab, **kw))
    spans = data.spans_by_id()
    ids = [s.seq_id for s in data.infos[:GROUP_SEQS]]
    batch, cu = flatten_group([data.by_id(i) for i in ids], BUCKET,
                              spans=[spans.get(i) for i in ids])
    idx = _stripe(BUCKET)
    return {"contiguous": batch,
            "striped": {k: a[:, idx] for k, a in batch.items()}}, int(cu[-1])


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring_striped")
    cfg = get_config("internvl3-2b").reduced().with_(family="dense",
                                                     vlm=None)
    group, real = _group(cfg.vocab)
    np.savez(tmp / "inputs.npz", **{f"{layout}/{k}": group[layout][k]
                                    for layout in group for k in KEYS})
    run_in_subprocess(JAX_SCRIPT.format(
        d=DEGREE, inp=str(tmp / "inputs.npz"), out=str(tmp / "jax.npz"),
        keys=KEYS), n_devices=DEGREE)
    flat = dict(np.load(tmp / "jax.npz"))
    return dict(cfg=cfg, group=group, real=real,
                params=params_from_numpy(_tree(flat, "params/")),
                jax={layout: (float(flat[layout + "/loss"]),
                              _tree(flat, layout + "/grads/"))
                     for layout in group})


def _ring_loss(reference, striped):
    """(loss, gradient tree) of the group over LocalRing(DEGREE) in the
    layout `striped` says, as the port's executor forms a span-bearing
    group's loss."""
    batch = reference["group"]["striped" if striped else "contiguous"]
    rows = {k: torch.from_numpy(np.ascontiguousarray(a)).reshape(
        DEGREE, BUCKET // DEGREE) for k, a in batch.items()}
    params = reference["params"]
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    it = iter(leaves)
    p = tree_map(lambda _: next(it), params)
    nll = token_nll(p, reference["cfg"], rows,
                    ring=LocalRing(DEGREE, striped=striped))
    lm = rows["loss_mask"]
    loss = (nll * lm).sum() / lm.sum().clamp(min=1.0)
    it = iter(g.numpy() for g in torch.autograd.grad(loss, leaves))
    return float(loss.detach()), tree_map(lambda _: next(it), params)


@pytest.fixture(scope="module")
def port(reference):
    """{layout: (loss, gradients)} of the port's ring path."""
    return {layout: _ring_loss(reference, layout == "striped")
            for layout in ("contiguous", "striped")}


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(tree[k], np.float32)


def _assert_close(got, want):
    """(loss, gradients) within LOSS_TOL / GRAD_TOL of `want`'s."""
    assert abs(got[0] - want[0]) <= LOSS_TOL, (got[0], want[0])
    g, w = list(_leaves(got[1])), list(_leaves(want[1]))
    assert [k for k, _ in g] == [k for k, _ in w]
    for (k, x), (_, y) in zip(g, w):
        np.testing.assert_allclose(x, y, atol=GRAD_TOL, err_msg=k)


def test_group_spans_crosses_the_shards(reference):
    """The group holds segments, frames and tail padding, and its striped
    shards each hold real tokens of every segment."""
    batch = reference["group"]["contiguous"]
    assert (batch["modality_ids"] >= 0).any()
    assert reference["real"] < BUCKET
    seg = reference["group"]["striped"]["segment_ids"].reshape(DEGREE, -1)
    for r in range(DEGREE):
        assert set(seg[r][seg[r] >= 0]) == set(range(GROUP_SEQS))


@pytest.mark.parametrize("layout", ["contiguous", "striped"])
def test_ring_loss_matches_jax_model_under_shard_map(reference, port,
                                                     layout):
    _assert_close(port[layout], reference["jax"][layout])


def test_striped_loss_matches_contiguous_jax(reference, port):
    """The layout changes where tokens run, not the loss."""
    _assert_close(port["striped"], reference["jax"]["contiguous"])
