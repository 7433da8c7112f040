"""Ring context parallelism (`repro_torch.parallel`) against the JAX
package's `parallel/ring_attention.py` on the CPU.

The same numpy-seeded fp32 inputs go through both. The JAX outputs and
`jax.grad`s come from one module-scoped subprocess over 5 forced host
devices (`tests/conftest.py::run_in_subprocess`), `ring_attention` under
`shard_map` with the sequence axis split `P(None, "cp")`, written to an
`.npz`. Every case runs in both layouts: the striped one gives the JAX
ring the global arrays permuted so that shard r holds tokens i d + r,
with their per-segment positions permuted alike. The port runs:

  * `ring_attention` in a `LocalRing` (all ranks as blocks of rows of one
    tensor): causal at d = 3, 4, 5 (two batch rows a rank), sliding with
    the window below and above S_loc at d = 3, a window of 2 at d = 3
    without tables and with them (striped: hops past the window, skipped
    without spans, launched for the span pairs with them), packed
    segments with bidirectional spans crossing shard borders and tail
    padding at d = 3; GQA (4 query heads over 2 KV heads) throughout;
    each striped output, put back in token order, also against the
    contiguous JAX output;
  * the d = 3 cases again through `DistRing` over gloo, both layouts,
    one process a rank (`torch.multiprocessing` spawn, a file rendezvous
    under the test's temp dir, timeouts on the group and the join);
  * `striped_hop` against the position test of the JAX ring's
    `_partial_update` at d = 1..6, and two faults planted in it (the
    offset without its +1, the window W where W' belongs), each of which
    must break that test and the ring's limits;
  * `ring_decode_attention` at d = 4 in both forms;
  * `make_positions` and `shard_sequence`, both layouts.

Limits are the JAX tests' (`tests/test_parallel.py`): forward 3e-5,
gradients 5e-4. Each hop runs K1's plain version here (CPU tensors).
"""
import datetime
import functools
import importlib
import itertools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.parallel.ring_attention import _partial_update

import _ring_faults as hop_faults
from conftest import run_in_subprocess
from repro_torch.kernels.flash_attention_packed import pair_mask
from repro_torch.parallel import (DistRing, LocalRing, make_positions,
                                  ring_attention, ring_decode_attention,
                                  shard_sequence, striped_hop)

# the module itself: the package's `ring_attention` is the function
ring_module = importlib.import_module("repro_torch.parallel.ring_attention")

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

FWD_TOL, GRAD_TOL = 3e-5, 5e-4
H, HKV, D = 4, 2, 16
#: name -> (degree, batch rows, S_loc, mode, window, packed)
CASES = {
    "causal_d3": (3, 2, 20, "causal", None, False),
    "causal_d4": (4, 2, 16, "causal", None, False),
    "causal_d5": (5, 2, 12, "causal", None, False),
    "sliding_short_d3": (3, 1, 24, "sliding", 10, False),
    "sliding_long_d3": (3, 1, 24, "sliding", 40, False),
    "packed_spans_d3": (3, 1, 32, "causal", None, True),
    "sliding_w2_d3": (3, 1, 24, "sliding", 2, False),
    "sliding_w2_spans_d3": (3, 1, 32, "sliding", 2, True),
}
DIST_CASES = [n for n, c in CASES.items() if c[0] == 3]
#: ring_decode_attention: degree, batch rows, cache entries a rank
DECODE = (4, 2, 16)
#: segment lengths of the packed case (96 tokens: 91 and 5 of padding)
#: and its bidirectional spans, [start, end) in the buffer; both cross
#: the shard borders at 32 and 64
PACKED_LENS = [25, 40, 14, 12]
PACKED_SPANS = [(4, 12), (28, 40), (60, 70), (80, 90)]

JAX_SCRIPT = """
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.parallel.compat import shard_map
from repro.parallel.ring_attention import (make_positions, ring_attention,
                                           ring_decode_attention,
                                           shard_sequence)

inp = dict(np.load({inp!r}))
cases = {cases!r}
out = {{}}
devs = jax.devices()
for name, (d, B, S_loc, mode, window, packed) in cases.items():
    mesh = Mesh(np.array(devs[:d]), ("cp",))

    def f(q, k, v, p, *t):
        kw = dict(q_seg=t[0], q_span=t[1]) if t else {{}}
        return ring_attention(q, k, v, p, axis_name="cp", mode=mode,
                              window=window, **kw)
    fm = jax.jit(shard_map(f, mesh=mesh,
                           in_specs=(P(None, "cp"),)
                           * (4 + 2 * int(packed)),
                           out_specs=P(None, "cp")))
    gm = jax.jit(jax.grad(
        lambda q, k, v, pos, live, *t: ((fm(q, k, v, pos, *t)
                                         * live) ** 2).sum(),
        argnums=(0, 1, 2)))
    # the striped layout: the global arrays permuted so that shard r
    # holds tokens i d + r, positions (per segment) permuted alike
    stripe = np.arange(d * S_loc).reshape(S_loc, d).T.reshape(-1)
    for tag, idx in (("", slice(None)), ("/striped", stripe)):
        q, k, v, pos = (jnp.asarray(inp[name + "/" + t][:, idx])
                        for t in ("q", "k", "v", "pos"))
        tables = tuple(jnp.asarray(inp[name + "/" + t][:, idx])
                       for t in (("seg", "span") if packed else ()))
        live = jnp.asarray(inp[name + "/live"][:, idx])[:, :, None, None]
        out[name + tag + "/o"] = np.asarray(fm(q, k, v, pos, *tables))
        grads = gm(q, k, v, pos, live, *tables)
        for t, g in zip(("dq", "dk", "dv"), grads):
            out[name + tag + "/" + t] = np.asarray(g)

d = {decode_d}
mesh = Mesh(np.array(devs[:d]), ("cp",))
gm = jax.jit(shard_map(
    lambda q1, kc, vc, lv: ring_decode_attention(q1, kc, vc, lv[0],
                                                 axis_name="cp"),
    mesh=mesh, in_specs=(P(), P(None, "cp"), P(None, "cp"), P("cp")),
    out_specs=P()))
out["decode/o"] = np.asarray(gm(*(jnp.asarray(inp["decode/" + t])
                                  for t in ("q1", "kc", "vc", "valid"))))

x = jnp.asarray(inp["shard/x"])
for striped in (False, True):
    for rank in range(3):
        tag = f"{{int(striped)}}/{{rank}}"
        out["positions/" + tag] = np.asarray(make_positions(12, 3, rank,
                                                            striped))
        out["shard/" + tag] = np.asarray(shard_sequence(x, 3, rank, 1,
                                                        striped))
np.savez({out!r}, **out)
print("jax ring reference ok")
"""


def _packed_tables(S):
    seg = np.full(S, -1, np.int32)
    pos = np.zeros(S, np.int32)
    off = 0
    for i, L in enumerate(PACKED_LENS):
        seg[off:off + L] = i
        pos[off:off + L] = np.arange(L)
        off += L
    span = np.full(S, -1, np.int32)
    for sid, (a, b) in enumerate(PACKED_SPANS):
        span[a:b] = sid
    return seg, pos, span


def _inputs():
    """Every case's global arrays ([B, S, ...]), keyed "case/name"."""
    rng = np.random.default_rng(0)
    inp = {}
    for name, (d, B, S_loc, mode, window, packed) in CASES.items():
        S = d * S_loc
        inp[name + "/q"] = rng.standard_normal((B, S, H, D))
        for t in ("k", "v"):
            inp[name + "/" + t] = rng.standard_normal((B, S, HKV, D))
        if packed:
            seg, pos, span = _packed_tables(S)
            inp[name + "/seg"], inp[name + "/span"] = seg[None], span[None]
            inp[name + "/pos"] = pos[None]
            inp[name + "/live"] = (seg >= 0)[None].astype(np.float32)
        else:
            inp[name + "/pos"] = np.tile(np.arange(S, dtype=np.int32), (B, 1))
            inp[name + "/live"] = np.ones((B, S), np.float32)
    d, B, T = DECODE
    inp["decode/q1"] = rng.standard_normal((B, 1, H, D))
    inp["decode/kc"] = rng.standard_normal((B, d * T, HKV, D))
    inp["decode/vc"] = rng.standard_normal((B, d * T, HKV, D))
    inp["decode/valid"] = rng.integers(0, T + 1, size=(d, B)).astype(
        np.int32)
    inp["decode/valid"][0] = T                   # a live entry per row
    inp["shard/x"] = rng.standard_normal((2, 12, 3))
    return {k: (a.astype(np.float32) if a.dtype == np.float64 else a)
            for k, a in inp.items()}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ring")
    inp = _inputs()
    np.savez(tmp / "inputs.npz", **inp)
    run_in_subprocess(JAX_SCRIPT.format(
        inp=str(tmp / "inputs.npz"), out=str(tmp / "jax.npz"), cases=CASES,
        decode_d=DECODE[0]), n_devices=5)
    return dict(inp=inp, out=dict(np.load(tmp / "jax.npz")),
                tmp=tmp)


# ---------------------------------------------------------- layouts
def _to_rows(a, d):
    """[B, d * S_loc, ...] -> the LocalRing's [d * B, S_loc, ...], rank
    r's rows [r B, (r + 1) B)."""
    B, S = a.shape[:2]
    a = a.reshape(B, d, S // d, *a.shape[2:])
    return np.ascontiguousarray(np.swapaxes(a, 0, 1)).reshape(
        d * B, S // d, *a.shape[3:])


def _from_rows(a, d):
    R, S_loc = a.shape[:2]
    a = a.reshape(d, R // d, S_loc, *a.shape[2:])
    return np.swapaxes(a, 0, 1).reshape(R // d, d * S_loc, *a.shape[3:])


def _shard(a, d, rank, striped=False):
    if striped:                              # tokens i d + rank
        return np.ascontiguousarray(a[:, rank::d])
    S_loc = a.shape[1] // d
    return np.ascontiguousarray(a[:, rank * S_loc:(rank + 1) * S_loc])


def _stripe(d, S_loc):
    """The striped order: place r S_loc + i holds token i d + r."""
    return np.arange(d * S_loc).reshape(S_loc, d).T.reshape(-1)


def _run_ring(ring, q, k, v, seg, span, live, mode, window):
    """(o, dq, dk, dv) as numpy, for the loss sum((o * live) ** 2)."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = ring_attention(q, k, v, None if seg is None
                       else torch.from_numpy(seg), ring=ring, mode=mode,
                       window=window, span_ids=None if span is None
                       else torch.from_numpy(span))
    w = torch.from_numpy(live)[:, :, None, None]
    ((o * w) ** 2).sum().backward()
    return [t.detach().numpy() for t in (o, q.grad, k.grad, v.grad)]


def _check(name, got, reference, live):
    want = [reference["out"][f"{name}/{t}"] for t in ("o", "dq", "dk",
                                                      "dv")]
    real = live.astype(bool)
    np.testing.assert_allclose(got[0][real], want[0][real], atol=FWD_TOL,
                               rtol=FWD_TOL, err_msg=f"{name} o")
    # padding rows: zeros here, the mean of V in the reference
    assert not got[0][~real].any(), name
    for t, g, w in zip(("dq", "dk", "dv"), got[1:], want[1:]):
        np.testing.assert_allclose(g, w, atol=GRAD_TOL, rtol=GRAD_TOL,
                                   err_msg=f"{name} {t}")


# ------------------------------------------------------------- tests
@pytest.mark.parametrize("name", sorted(CASES))
def test_local_ring_matches_jax_ring_attention(reference, name):
    d, B, S_loc, mode, window, packed = CASES[name]
    inp = reference["inp"]
    rows = {t: _to_rows(inp[f"{name}/{t}"], d)
            for t in ("q", "k", "v", "live")
            + (("seg", "span") if packed else ())}
    got = _run_ring(LocalRing(d), rows["q"], rows["k"], rows["v"],
                    rows.get("seg"), rows.get("span"), rows["live"], mode,
                    window)
    _check(name, [_from_rows(a, d) for a in got], reference,
           inp[f"{name}/live"])


def _striped_local(reference, name):
    """The LocalRing's striped (o, dq, dk, dv) of case `name`, in the
    striped order, and the live table in that order."""
    d, B, S_loc, mode, window, packed = CASES[name]
    inp, idx = reference["inp"], _stripe(d, S_loc)
    rows = {t: _to_rows(inp[f"{name}/{t}"][:, idx], d)
            for t in ("q", "k", "v", "live")
            + (("seg", "span") if packed else ())}
    got = _run_ring(LocalRing(d, striped=True), rows["q"], rows["k"],
                    rows["v"], rows.get("seg"), rows.get("span"),
                    rows["live"], mode, window)
    return [_from_rows(a, d) for a in got], inp[f"{name}/live"][:, idx]


@pytest.mark.parametrize("name", sorted(CASES))
def test_local_ring_striped_matches_jax_ring_attention(reference, name):
    d, S_loc = CASES[name][0], CASES[name][2]
    got, live = _striped_local(reference, name)
    _check(f"{name}/striped", got, reference, live)
    # back in token order: the contiguous layout's JAX outputs
    back = np.argsort(_stripe(d, S_loc))
    _check(name, [a[:, back] for a in got], reference,
           reference["inp"][f"{name}/live"])


def _dist_worker(rank, world, init_file, in_path, out_path):
    """One rank of the gloo run: ranks 0-2 form the d = 3 ring of every
    DIST_CASES case, in both layouts; all four run
    ring_decode_attention."""
    import torch.distributed as dist
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        inp = dict(np.load(in_path))
        out = {}
        three = dist.new_group([0, 1, 2])
        for striped in (False, True) if rank < 3 else ():
            ring = DistRing(three, striped=striped)
            tag = "/striped" if striped else ""
            for name in DIST_CASES:
                d, B, S_loc, mode, window, packed = CASES[name]
                part = {t: _shard(inp[f"{name}/{t}"], d, rank, striped)
                        for t in ("q", "k", "v", "live")
                        + (("seg", "span") if packed else ())}
                got = _run_ring(ring, part["q"], part["k"], part["v"],
                                part.get("seg"), part.get("span"),
                                part["live"], mode, window)
                for t, a in zip(("o", "dq", "dk", "dv"), got):
                    out[f"{name}{tag}/{t}"] = a
        d, B, T = DECODE
        kc, vc = (torch.from_numpy(_shard(inp[f"decode/{t}"], d, rank))
                  for t in ("kc", "vc"))
        out["decode/o"] = ring_decode_attention(
            torch.from_numpy(inp["decode/q1"]), kc, vc,
            torch.from_numpy(inp["decode/valid"][rank]),
            ring=DistRing()).numpy()
        np.savez(out_path.format(rank=rank), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def dist_run(reference):
    """Four gloo processes, one a rank; their outputs by rank."""
    import torch.multiprocessing as mp
    tmp = reference["tmp"]
    world = DECODE[0]
    out_path = str(tmp / "dist_rank{rank}.npz")
    ctx = mp.start_processes(
        _dist_worker, args=(world, str(tmp / "rendezvous"),
                            str(tmp / "inputs.npz"), out_path),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + 240
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise AssertionError("the gloo ring did not finish in 240 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
    return [dict(np.load(out_path.format(rank=r))) for r in range(world)]


@pytest.mark.parametrize("name", DIST_CASES)
def test_dist_ring_over_gloo_matches_jax_ring_attention(reference,
                                                        dist_run, name):
    d = CASES[name][0]
    got = [np.concatenate([dist_run[r][f"{name}/{t}"] for r in range(d)],
                          axis=1) for t in ("o", "dq", "dk", "dv")]
    _check(name, got, reference, reference["inp"][f"{name}/live"])


@pytest.mark.parametrize("name", DIST_CASES)
def test_dist_ring_striped_over_gloo_matches_jax_ring_attention(
        reference, dist_run, name):
    d, S_loc = CASES[name][0], CASES[name][2]
    got = [np.concatenate([dist_run[r][f"{name}/striped/{t}"]
                           for r in range(d)], axis=1)
           for t in ("o", "dq", "dk", "dv")]
    live = reference["inp"][f"{name}/live"][:, _stripe(d, S_loc)]
    _check(f"{name}/striped", got, reference, live)


def test_ring_decode_matches_jax_in_both_forms(reference, dist_run):
    d, B, T = DECODE
    inp, want = reference["inp"], reference["out"]["decode/o"]
    rows = LocalRing(d)
    o = ring_decode_attention(
        torch.from_numpy(np.tile(inp["decode/q1"], (d, 1, 1, 1))),
        torch.from_numpy(_to_rows(inp["decode/kc"], d)),
        torch.from_numpy(_to_rows(inp["decode/vc"], d)),
        torch.from_numpy(inp["decode/valid"].reshape(-1)), ring=rows)
    for r in range(d):
        np.testing.assert_allclose(o[r * B:(r + 1) * B].numpy(), want,
                                   atol=FWD_TOL, rtol=FWD_TOL)
        np.testing.assert_allclose(dist_run[r]["decode/o"], want,
                                   atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("striped", [False, True])
def test_positions_and_shards_match_jax(reference, striped):
    x = reference["inp"]["shard/x"]
    for rank in range(3):
        tag = f"{int(striped)}/{rank}"
        np.testing.assert_array_equal(
            make_positions(12, 3, rank, striped).numpy(),
            reference["out"]["positions/" + tag])
        np.testing.assert_array_equal(
            shard_sequence(torch.from_numpy(x), 3, rank, 1,
                           striped).numpy(),
            reference["out"]["shard/" + tag])


# --------------------------------------------- the striped hop's mask
#: degrees, local shard lengths and sliding windows of the hop check
#: (causal too)
HOP_DEGREES = tuple(range(1, 7))
HOP_S_LOC = (1, 2, 3, 5, 8)
HOP_WINDOWS = tuple(range(1, 30))


@functools.partial(jax.jit, static_argnums=2)
def _jax_pair_mask(q_pos, k_pos, mode, window):
    """[B, S, T]: 1 where `_partial_update`'s position test lets the pair
    through, read out of one accumulation step from an empty carry (zero
    scores; V the identity, so acc holds each key's weight; a row without
    a pair keeps m at -1e30). `window` is [B, 1, 1] (sliding) or None."""
    B, S = q_pos.shape
    T = k_pos.shape[1]
    carry = (jnp.full((B, S, 1, 1), ring_module.NEG_INF),
             jnp.zeros((B, S, 1, 1)), jnp.zeros((B, S, 1, 1, T)))
    v = jnp.broadcast_to(jnp.eye(T)[None, :, None, :], (B, T, 1, T))
    m, _, acc = _partial_update(carry, jnp.zeros((B, S, 1, 1, 1)),
                                jnp.zeros((B, T, 1, 1)), v, q_pos, k_pos,
                                mode, window)
    return (acc[:, :, 0, 0] > 0.5) \
        & (m[:, :, 0, 0, None] > ring_module.NEG_INF / 2)


@functools.lru_cache(maxsize=None)
def _jax_hop_masks():
    """{(d, S_loc, window, rank, src): [S_loc, S_loc] mask} of the JAX
    position test on the tokens i d + rank (queries) and j d + src (keys)
    of every striped hop of the check: one call a mode, every hop padded
    to the longest shard with keys no query reaches."""
    P = max(HOP_S_LOC)
    out = {}
    for windows in ((None,), HOP_WINDOWS):
        hops = list(itertools.product(HOP_DEGREES, HOP_S_LOC, windows))
        hops = [(d, S, w, r, src) for d, S, w in hops for r in range(d)
                for src in range(d)]
        q_pos = np.zeros((len(hops), P), np.int32)
        k_pos = np.full((len(hops), P), 1 << 20, np.int32)
        for b, (d, S, w, r, src) in enumerate(hops):
            q_pos[b, :S] = np.arange(S) * d + r
            k_pos[b, :S] = np.arange(S) * d + src
        mode = "causal" if windows == (None,) else "sliding"
        masks = np.asarray(_jax_pair_mask(
            jnp.asarray(q_pos), jnp.asarray(k_pos), mode,
            None if mode == "causal"
            else jnp.asarray([h[2] for h in hops])[:, None, None]))
        out.update((h, m[:h[1], :h[1]]) for h, m in zip(hops, masks))
    return out


def _hop_mismatches(hop, d):
    """(S_loc, window, rank, src) of every striped hop of a degree-d ring
    where `hop`'s (kv_offset, window) through K1's mask (`pair_mask`, no
    pair where it gives None) differs from the JAX ring's position
    test."""
    bad = []
    for (dd, S_loc, w, r, src), want in _jax_hop_masks().items():
        if dd != d:
            continue
        mode = "causal" if w is None else "sliding"
        kw = hop(src - r, d, mode, w)
        one = torch.zeros(1, S_loc, dtype=torch.int32)
        got = (np.zeros((S_loc, S_loc), bool) if kw is None
               else pair_mask(S_loc, S_loc, one, one, mode=mode,
                              window=kw[1], kv_offset=kw[0])[0].numpy())
        if not np.array_equal(got, want):
            bad.append((S_loc, w, r, src))
    return bad


@pytest.mark.parametrize("d", HOP_DEGREES)
def test_striped_hop_matches_the_jax_position_test(d):
    assert _hop_mismatches(striped_hop, d) == []


#: fault -> (the planted striped_hop, the case whose limits it breaks)
HOP_FAULTS = {"no_plus_one": (hop_faults.no_plus_one, "causal_d3"),
              "raw_window": (hop_faults.raw_window, "sliding_short_d3")}


@pytest.mark.parametrize("fault", sorted(HOP_FAULTS))
def test_planted_hop_fault_breaks_the_limits(reference, monkeypatch, fault):
    hop, name = HOP_FAULTS[fault]
    assert _hop_mismatches(hop, 3)
    monkeypatch.setattr(ring_module, "striped_hop", hop)
    got, live = _striped_local(reference, name)
    with pytest.raises(AssertionError):
        _check(f"{name}/striped", got, reference, live)
