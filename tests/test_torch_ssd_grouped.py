"""The algebra K3's backward kernel runs, as torch ops, on the CPU.

The kernel (`csrc/ssd_chunk.cu`, `k3_bwd_cb`, `k3_bwd_heads`,
`k3_bwd_dcb`) forms what the heads share once: C B^T once per
(sequence, chunk), and the score gradient M = dS * L * dt summed over a
group of heads (then over the groups, in order) before its products
with B and C, so dC and dB are one product each a chunk instead of one
a head. `grouped_bwd` below writes that closed form in the model layout
and is held to:

  * `ssd_chunk_bwd_plain` (the autograd gradient of the plain forward)
    at mamba2-370m's chunk, c = 256, with the model's dt, where exp
    above the diagonal would overflow: finite, and equal in fp64;
  * `jax.grad` (`jax.vjp`) of the JAX package's `ssd_chunk_ref` at
    c <= 64, where that gradient is finite, with C and B broadcast to
    the heads and their gradients summed over heads, at
    test_torch_ssm.py's tolerance (1e-4 x max(1, |jax|)).

Group sizes that divide the heads, that do not, one head a group and
all heads in one group give the same gradient.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.kernels.ref import ssd_chunk_ref as jax_ssd_chunk_ref
from repro_torch.kernels.ssd_chunk import ssd_chunk_bwd_plain

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

TOL = 1e-4          # test_torch_ssm.py's gradient tolerance


def grouped_bwd(C, B, x, da, dt, dy, dst, dcum, *, chunk, group):
    """(dC, dB, dx, dda, ddt) of the SSD chunk step in the model layout
    (C, B [Bsz,S,N], x [Bsz,S,H,P], da, dt [Bsz,S,H]; dy [Bsz,S,H,P],
    dst [Bsz,nc,H,N,P], dcum [Bsz,S,H]) by the closed form the kernel
    runs, in the inputs' float type. With S = CB L dt_j, M = dS L dt_j,
    Q = dS CB L (i >= j, else 0), dS = dy x^T, e = exp(cum_end - cum),
    w = e dt:

        dx   = S^T dy + w (B dst)             per head
        q    = rowsum(x * (B dst))            per head
        dC   = (sum_h M_h) B                  once a chunk
        dB   = (sum_h M_h)^T C + sum_h w_h x_h dst_h^T
        ddt  = colsum(Q) + e q
        dcum' = dcum + rowsum(Q dt) - dt colsum(Q) - w q
                + [last token] sum(w q);  dda = reverse cumsum(dcum')

    The sums over heads run by groups of `group` heads, each group's sum
    first and then the groups in order, as the kernel's blocks and its
    last stage sum them."""
    Bsz, S, H, P = x.shape
    N, c = C.shape[-1], chunk
    nc = S // c
    Cc, Bc = (t.reshape(Bsz, nc, c, N) for t in (C, B))
    heads = lambda t: t.reshape(Bsz, nc, c, H, -1).permute(  # noqa: E731
        0, 1, 3, 2, 4)                                     # [b,k,h,c,*]
    xc, dyc = heads(x), heads(dy)
    dac, dtc, dcc = (heads(t[..., None])[..., 0] for t in (da, dt, dcum))
    cum = torch.cumsum(dac, -1)                            # [b,k,h,c]
    CB = torch.einsum("bkin,bkjn->bkij", Cc, Bc)           # once a chunk
    tril = torch.ones(c, c, dtype=torch.bool).tril()
    diff = cum[..., :, None] - cum[..., None, :]
    L = diff.masked_fill(~tril, float("-inf")).exp()       # 0 above
    dS = torch.einsum("bkhip,bkhjp->bkhij", dyc, xc)
    sdt = L * dtc[..., None, :]
    Sm = CB[:, :, None] * sdt
    M = dS * sdt
    Q = dS * CB[:, :, None] * L
    e = torch.exp(cum[..., -1:] - cum)
    w = e * dtc
    Bdst = torch.einsum("bkjn,bkhnp->bkhjp", Bc, dst)
    xw = xc * w[..., None]
    Msum, Xd = 0, 0
    for g0 in range(0, H, group):                          # groups in order
        hs = slice(g0, g0 + group)
        Msum = Msum + M[:, :, hs].sum(2)
        Xd = Xd + torch.einsum("bkhjp,bkhnp->bkjn", xw[:, :, hs],
                               dst[:, :, hs])
    dC = torch.einsum("bkij,bkjn->bkin", Msum, Bc)
    dB = torch.einsum("bkij,bkin->bkjn", Msum, Cc) + Xd
    dx = torch.einsum("bkhij,bkhip->bkhjp", Sm, dyc) + w[..., None] * Bdst
    q = (xc * Bdst).sum(-1)
    rowR = (M * CB[:, :, None]).sum(-1)
    colQ = Q.sum(-2)
    ddt = colQ + e * q
    u = w * q
    v = dcc + rowR - dtc * colQ - u
    v[..., -1] += u.sum(-1)
    dda = torch.flip(torch.cumsum(torch.flip(v, [-1]), -1), [-1])
    back = lambda t: t.permute(0, 1, 3, 2).reshape(Bsz, S, H)  # noqa: E731
    return (dC.reshape(Bsz, S, N), dB.reshape(Bsz, S, N),
            dx.permute(0, 1, 3, 2, 4).reshape(Bsz, S, H, P), back(dda),
            back(ddt))


def _inputs(Bsz, S, H, N, P, c, seed, model_dt):
    """fp32 numpy inputs and output gradients in the model layout.
    `model_dt`: dt as the model makes it at init (softplus(.) + 1e-3,
    A = -1), whose sum over a 256-token chunk is about 200; else da =
    -dt * U(0.05, 1), as the JAX kernel tests draw it."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    C, B = f(Bsz, S, N) * 0.3, f(Bsz, S, N) * 0.3
    x = f(Bsz, S, H, P)
    dt = (np.logaddexp(f(Bsz, S, H), 0.0) + 1e-3).astype(np.float32)
    da = -dt if model_dt else \
        (-dt * rng.uniform(0.05, 1.0, dt.shape)).astype(np.float32)
    douts = [f(Bsz, S, H, P), f(Bsz, S // c, H, N, P), f(Bsz, S, H)]
    return [C, B, x, da, dt], douts


def _close(a, b, tol):
    """Every element within tol * max(1, |b|) of b."""
    a = a.detach().double().numpy()
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.isfinite(a).all()
    err = np.abs(a - b) / np.maximum(1.0, np.abs(b))
    assert err.max() <= tol, float(err.max())


@pytest.mark.parametrize("H,group", [(4, 4), (5, 4), (3, 1), (6, 6)])
def test_grouped_form_equals_plain_gradient_at_full_chunk(H, group):
    """c = 256 with the model's dt: the closed form, summed by groups,
    is finite and equals the plain version's autograd gradient (both in
    fp64)."""
    c, N, P = 256, 16, 8
    ins, douts = _inputs(1, 2 * c, H, N, P, c, seed=11, model_dt=True)
    assert ins[4].reshape(2, c, H).sum(1).min() > 150
    ins64 = [torch.from_numpy(a).double() for a in ins]
    douts64 = [torch.from_numpy(a).double() for a in douts]
    got = grouped_bwd(*ins64, *douts64, chunk=c, group=group)
    want = ssd_chunk_bwd_plain(*ins64, *douts64, chunk=c)
    for a, w in zip(got, want):
        _close(a, w.numpy(), 1e-9)


def _jax_grad(ins, douts, c):
    """jax.vjp of ssd_chunk_ref over the cells of the model layout, C and
    B broadcast to every head and their gradients summed over heads."""
    C, B, x, da, dt = ins
    Bsz, S, H, P = x.shape
    N, nc = C.shape[-1], S // c

    def fn(C, B, x, da, dt):
        cb = lambda t: jnp.broadcast_to(  # noqa: E731
            t.reshape(Bsz, nc, 1, c, N), (Bsz, nc, H, c, N)).reshape(-1, c, N)
        xs = x.reshape(Bsz, nc, c, H, P).transpose(0, 1, 3, 2, 4)
        sc = lambda t: t.reshape(Bsz, nc, c, H).transpose(  # noqa: E731
            0, 1, 3, 2).reshape(-1, c)
        y, st, cum = jax_ssd_chunk_ref(cb(C), cb(B), xs.reshape(-1, c, P),
                                       sc(da), sc(dt))
        y = y.reshape(Bsz, nc, H, c, P).transpose(0, 1, 3, 2, 4)
        cum = cum.reshape(Bsz, nc, H, c).transpose(0, 1, 3, 2)
        return (y.reshape(Bsz, S, H, P), st.reshape(Bsz, nc, H, N, P),
                cum.reshape(Bsz, S, H))

    _, vjp = jax.vjp(fn, *map(jnp.asarray, ins))
    return vjp(tuple(map(jnp.asarray, douts)))


@pytest.mark.parametrize("Bsz,S,H,N,P,c,group", [
    (2, 128, 4, 16, 8, 32, 4),
    (1, 128, 5, 32, 16, 64, 4),
    (1, 64, 3, 16, 32, 64, 2),
])
def test_grouped_form_matches_jax_grad(Bsz, S, H, N, P, c, group):
    ins, douts = _inputs(Bsz, S, H, N, P, c, seed=12, model_dt=False)
    want = _jax_grad(ins, douts, c)
    got = grouped_bwd(*[torch.from_numpy(a) for a in ins],
                      *[torch.from_numpy(a) for a in douts], chunk=c,
                      group=group)
    for a, w in zip(got, want):
        assert np.isfinite(np.asarray(w)).all()
        _close(a, np.asarray(w), TOL)
