"""The algebra K3's forward kernels run, as torch ops, on the CPU.

The kernels (`csrc/ssd_chunk.cu`, `k3_cb`, `k3_fwd_heads`) form C B^T
once per (sequence, chunk), in 64-wide tile pairs (it, jt), jt <= it,
and a block takes a group of heads: row tile by row tile, each head of
the group walks the column tiles of the row by segments of four (the C
B^T tiles the block holds at once), forms S = C B^T * L * dt_j and adds
S x to y; in the last row each step also adds (B w)^T x of its column
tile to the head's states, w = exp(cum_end - cum) dt. The decay L is
exp(cum_i - cum_j) taken only where i >= j on the diagonal tile pairs,
and off them the product E_i D F_j of three factors of at most 1 (see
`_decay`). `grouped_fwd` below writes that walk in the model layout and
is held to:

  * `ssd_chunk_plain` at mamba2-370m's chunk, c = 256, with the model's
    dt, where exp above the diagonal would overflow, and at chunks whose
    last tile is short (c = 32, 96) or whose rows take several segments
    (c = 640): finite, and equal in fp64;
  * the JAX package's Pallas kernel `ssd_chunk_pallas` (interpret mode)
    and its oracle `ssd_chunk_ref` at c = 64 and c = 256 (the JAX
    forward is finite at 256; only its gradient is NaN), with C and B
    broadcast to the heads, at test_torch_ssm.py's tolerance (1e-4 x
    max(1, |jax|)).

Groups of heads that divide the heads, that do not, one head a group
and all heads in one group give the same outputs.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.ref import ssd_chunk_ref as jax_ssd_chunk_ref
from repro.kernels.ssd_chunk import ssd_chunk_pallas
from repro_torch.kernels.ssd_chunk import ssd_chunk_plain

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

TOL = 1e-4          # test_torch_ssm.py's tolerance
TILE, SLAB = 64, 4  # the kernels' tile width and C B^T tiles a block holds


def grouped_fwd(C, B, x, da, dt, *, chunk, group):
    """(y, states, cum) of the SSD chunk step in the model layout (C, B
    [Bsz,S,N], x [Bsz,S,H,P], da, dt [Bsz,S,H]) by the walk the kernels
    run, in the inputs' float type: C B^T once a chunk by tile pairs,
    then per group of `group` heads, per row tile, per segment of SLAB
    column tiles, per head, the segment's tiles in turn."""
    Bsz, S, H, P = x.shape
    N, c = C.shape[-1], chunk
    nc, nt = S // c, -(-chunk // TILE)
    pad = nt * TILE - c

    def cells(t):   # [Bsz, S, ...] -> [Bsz, nc, cpad, ...], zeros past c
        t = t.reshape(Bsz, nc, c, *t.shape[2:])
        return torch.cat([t, t.new_zeros(Bsz, nc, pad, *t.shape[3:])], 2)
    Cc, Bc = cells(C), cells(B)                            # [b,k,cpad,N]
    xc = cells(x).permute(0, 1, 3, 2, 4)                   # [b,k,h,cpad,P]
    dac, dtc = (cells(t).permute(0, 1, 3, 2) for t in (da, dt))
    cum = torch.cumsum(dac, -1)                            # [b,k,h,cpad]
    tile = lambda t: slice(t * TILE, (t + 1) * TILE)  # noqa: E731
    cb = {(it, jt): Cc[:, :, tile(it)] @ Bc[:, :, tile(jt)].transpose(-1, -2)
          for it in range(nt) for jt in range(it + 1)}      # once a chunk
    w = torch.exp(cum[..., c - 1:c] - cum) * dtc           # 0 past c
    y = torch.zeros_like(xc)
    st = x.new_zeros(Bsz, nc, H, N, P)
    rows = torch.arange(TILE)
    for h0 in range(0, H, group):
        for it in range(nt):
            gi = it * TILE + rows
            for s0 in range(0, it + 1, SLAB):
                for h in range(h0, min(h0 + group, H)):
                    acc = y[:, :, h, tile(it)]             # 0 at s0 == 0
                    for jt in range(s0, min(s0 + SLAB, it + 1)):
                        gj = jt * TILE + rows
                        L = _decay(cum[:, :, h], it, jt, c)
                        Sm = cb[it, jt] * L * dtc[:, :, h, None, gj]
                        acc = acc + Sm @ xc[:, :, h, tile(jt)]
                        if it == nt - 1:
                            Bw = Bc[:, :, tile(jt)] * w[:, :, h, gj, None]
                            st[:, :, h] += Bw.transpose(-1, -2) @ \
                                xc[:, :, h, tile(jt)]
                    y[:, :, h, tile(it)] = acc
    y = y[:, :, :, :c].permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, P)
    cum = cum[..., :c].permute(0, 1, 3, 2).reshape(Bsz, S, H)
    return y, st, cum


def _decay(cum, it, jt, c):
    """L of tile pair (it, jt) from cum [b,k,cpad]: on the diagonal
    exp(cum_i - cum_j) where i >= j (and i < c), else 0; off it E_i D F_j
    with E_i = exp(cum_i - cum_s) (0 from c on), D = exp(cum_s - cum_r),
    F_j = exp(cum_r - cum_j), s the token before row tile it and r the
    last of column tile jt."""
    rows = torch.arange(TILE)
    gi, gj = it * TILE + rows, jt * TILE + rows
    if it == jt:
        keep = (gi[:, None] >= gj[None, :]) & (gi[:, None] < c)
        diff = cum[..., gi, None] - cum[..., None, gj]
        return diff.masked_fill(~keep, float("-inf")).exp()
    s, r = it * TILE - 1, jt * TILE + TILE - 1
    E = (cum[..., gi] - cum[..., s:s + 1]).exp().masked_fill(gi >= c, 0.0)
    D = (cum[..., s] - cum[..., r]).exp()
    F = (cum[..., r:r + 1] - cum[..., gj]).exp()
    return E[..., :, None] * D[..., None, None] * F[..., None, :]


def _inputs(Bsz, S, H, N, P, seed, model_dt):
    """fp32 numpy inputs in the model layout. `model_dt`: dt as the
    model makes it at init (softplus(.) + 1e-3, A = -1), whose sum over
    a 256-token chunk is about 200; else da = -dt * U(0.05, 1), as the
    JAX kernel tests draw it."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    C, B = f(Bsz, S, N) * 0.3, f(Bsz, S, N) * 0.3
    x = f(Bsz, S, H, P)
    dt = (np.logaddexp(f(Bsz, S, H), 0.0) + 1e-3).astype(np.float32)
    da = -dt if model_dt else \
        (-dt * rng.uniform(0.05, 1.0, dt.shape)).astype(np.float32)
    return [C, B, x, da, dt]


def _close(a, b, tol):
    """Every element within tol * max(1, |b|) of b."""
    a = a.detach().double().numpy()
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.isfinite(a).all()
    err = np.abs(a - b) / np.maximum(1.0, np.abs(b))
    assert err.max() <= tol, float(err.max())


@pytest.mark.parametrize("c,H,group", [
    (256, 4, 4), (256, 5, 4), (256, 3, 1), (256, 6, 6),
    (32, 3, 2), (96, 5, 2), (640, 2, 2),
])
def test_grouped_walk_equals_plain_forward(c, H, group):
    """The model's dt, so exp above the diagonal would overflow at c >=
    256: the walk, by groups and segments, is finite and equals the
    plain version (both in fp64), chunks whose last tile is short (32,
    96) and rows of several segments (640: ten tiles) included."""
    N, P = 16, 8
    ins = _inputs(1, 2 * c, H, N, P, seed=21, model_dt=True)
    if c >= 256:
        assert ins[4].reshape(2, c, H).sum(1).min() > 150
    ins64 = [torch.from_numpy(a).double() for a in ins]
    got = grouped_fwd(*ins64, chunk=c, group=group)
    want = ssd_chunk_plain(*ins64, chunk=c)
    for a, w in zip(got, want):
        _close(a, w.numpy(), 1e-9)


#: (Bsz, S, H, N, P, chunk, group) held to the JAX package's forward
JAX_CASES = [(2, 128, 3, 16, 8, 64, 2), (1, 512, 3, 16, 8, 256, 2)]


def _jax_forward(ins, c):
    """(ssd_chunk_pallas in interpret mode, ssd_chunk_ref) over the cells
    of the model layout, C and B broadcast to every head, back in the
    model layout."""
    C, B, x, da, dt = ins
    Bsz, S, H, P = x.shape
    N, nc = C.shape[-1], S // c
    cb = lambda t: np.broadcast_to(  # noqa: E731
        t.reshape(Bsz, nc, 1, c, N), (Bsz, nc, H, c, N)).reshape(-1, c, N)
    xs = x.reshape(Bsz, nc, c, H, P).transpose(0, 1, 3, 2, 4)
    sc = lambda t: t.reshape(Bsz, nc, c, H).transpose(  # noqa: E731
        0, 1, 3, 2).reshape(-1, c)
    cells = [jnp.asarray(a) for a in (cb(C), cb(B), xs.reshape(-1, c, P),
                                      sc(da), sc(dt))]
    out = []
    for fn in (ssd_chunk_pallas, jax_ssd_chunk_ref):
        y, st, cum = (np.asarray(a) for a in fn(*cells))
        y = y.reshape(Bsz, nc, H, c, P).transpose(0, 1, 3, 2, 4)
        cum = cum.reshape(Bsz, nc, H, c).transpose(0, 1, 3, 2)
        out.append((y.reshape(Bsz, S, H, P), st.reshape(Bsz, nc, H, N, P),
                    cum.reshape(Bsz, S, H)))
    return out


@pytest.fixture(scope="module")
def jax_reference():
    """Each case's inputs and the JAX package's outputs, built once for
    the module."""
    refs = {}
    for case in JAX_CASES:
        Bsz, S, H, N, P, c, _ = case
        ins = _inputs(Bsz, S, H, N, P, seed=22, model_dt=c == 256)
        refs[case] = (ins, _jax_forward(ins, c))
    return refs


@pytest.mark.parametrize("case", JAX_CASES)
@pytest.mark.parametrize("which", ["pallas", "ref"])
def test_grouped_walk_matches_jax_forward(jax_reference, case, which):
    ins, (pallas, ref) = jax_reference[case]
    *_, c, group = case
    want = pallas if which == "pallas" else ref
    got = grouped_fwd(*[torch.from_numpy(a) for a in ins], chunk=c,
                      group=group)
    for a, w in zip(got, want):
        assert np.isfinite(w).all()
        _close(a, w, TOL)
