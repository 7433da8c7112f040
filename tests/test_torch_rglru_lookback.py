"""The algorithm K4's forward kernel runs, as torch ops, on the CPU.

The kernel (`csrc/rglru_scan.cu`, `k4_fwd_lookback`) is one pass over
a and b. A block takes a tile of FWD_WARPS x FWD_STEPS time steps (and
32 x V channels, which do not mix): each warp forms the map h_end =
A h_start + B of its FWD_STEPS steps, and the warps' maps compose in
time order into the tile's. Tiles form groups of FWD_GROUP along time.
The carry into a tile is the inclusive prefix (the state) incl at the
end of the group before, taken through the map (Al, Bl) of its group's
earlier tiles, Al incl + Bl; that map is composed in rounds of
FWD_WARPS x FWD_LOOK maps, each warp composing its FWD_LOOK into a
partial map and the partials composed in order. Only a group's last
tile publishes an inclusive prefix: its group's map (Al, Bl, then its
own) taken on the one before. Each warp then takes its carry by composing the
earlier warps' maps onto the tile's, and scans its own steps from it.
`lookback_scan` below writes that, at the sizes the source declares
(read from the `.cu`), and is held to:

  * `rglru_scan_plain` in fp64, to rounding, at ragged S and W, S = 1
    and several groups of tiles, with a as the gates make it (0.3,
    0.999) and with a long memory (0.95, 0.9999), where the carries
    decide h across many tiles;
  * the same in fp32 and bf16 inputs (the state in fp32) at K4's card
    limits (1e-5 and 2e-2 x max(1, |plain|)), and the JAX package's
    Pallas `rglru_scan_pallas` in interpret mode, as
    tests/test_torch_hybrid.py runs it;
  * at each stopping point the look-back can meet (the maps of its
    group it takes the inclusive prefix through, 0 to FWD_GROUP - 1),
    the carry into the tile equals the plain state before it;
  * any group size gives the same h: the stopping point decides the
    rounding, not the value.
"""
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels.rglru_scan import rglru_scan_pallas
from repro_torch.kernels.rglru_scan import rglru_scan_plain

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

SOURCE = open(os.path.join(os.path.dirname(__file__), "..", "src",
                           "repro_torch", "kernels", "csrc",
                           "rglru_scan.cu")).read()
CONST = {k: int(v) for k, v in
         re.findall(r"constexpr int (FWD_[A-Z_]+) = (\d+);", SOURCE)}
WARPS, STEPS, GROUP, LOOK = (CONST[f"FWD_{k}"] for k in
                             ("WARPS", "STEPS", "GROUP", "LOOK"))
TILE = WARPS * STEPS
#: K4's card limits, x max(1, |plain|) (tests/test_torch_cuda.py)
K4_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
#: case -> (B, S, W): ragged S and W; three groups of tiles (the last
#: tile part full); exactly two groups; one step of 7 channels
CASES = {
    "ragged": (2, 300, 70),
    "groups": (1, (3 * GROUP - 1) * TILE + 5, 24),
    "two_groups": (2, 2 * GROUP * TILE, 16),
    "one_step": (1, 1, 7),
}
#: a as the model's gates make it, and a long memory
A_RANGES = {"gates": (0.3, 0.999), "long": (0.95, 0.9999)}


def _inputs(case, a_range, seed=0):
    B, S, W = CASES[case]
    lo, hi = A_RANGES[a_range]
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, hi, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    return a, b


def tile_maps(a, b, warps=WARPS, steps=STEPS):
    """a, b padded with the identity to whole tiles, shaped [B, ntt,
    warps, steps, W], each warp's map (A, B) [B, ntt, warps, W] and each
    tile's [B, ntt, W], composed in time order as the kernel does."""
    B, S, W = a.shape
    ntt = -(-S // (warps * steps))
    pad = ntt * warps * steps - S
    a = torch.cat([a, a.new_ones(B, pad, W)], 1)
    b = torch.cat([b, b.new_zeros(B, pad, W)], 1)
    a = a.reshape(B, ntt, warps, steps, W)
    b = b.reshape(B, ntt, warps, steps, W)
    wa, wb = a.new_ones(B, ntt, warps, W), a.new_zeros(B, ntt, warps, W)
    for i in range(steps):
        wb = a[:, :, :, i] * wb + b[:, :, :, i]
        wa = wa * a[:, :, :, i]
    ta, tb = a.new_ones(B, ntt, W), a.new_zeros(B, ntt, W)
    for u in range(warps):
        tb = wa[:, :, u] * tb + wb[:, :, u]
        ta = ta * wa[:, :, u]
    return a, b, wa, wb, ta, tb


def compose(maps_a, maps_b):
    """The map of the given maps [B, n, W] applied in order."""
    B, _, W = maps_a.shape
    A, Bm = maps_a.new_ones(B, W), maps_a.new_zeros(B, W)
    for j in range(maps_a.shape[1]):
        Bm = maps_a[:, j] * Bm + maps_b[:, j]
        A = A * maps_a[:, j]
    return A, Bm


def compose_records(maps_a, maps_b):
    """`compose` in the kernel's order: rounds of WARPS x LOOK records,
    each warp's LOOK records composed into a partial map, the partials
    composed in order."""
    B, n, W = maps_a.shape
    A, Bm = maps_a.new_ones(B, W), maps_a.new_zeros(B, W)
    for base in range(0, n, WARPS * LOOK):
        for w in range(WARPS):
            lo = min(n, base + w * LOOK)
            hi = min(n, lo + LOOK)
            pa, pb = compose(maps_a[:, lo:hi], maps_b[:, lo:hi])
            Bm = pa * Bm + pb
            A = A * pa
    return A, Bm


def carries(ta, tb, group=GROUP):
    """The carry into each tile [B, ntt, W]: the map (Al, Bl) of its
    group's earlier tiles (composed as the kernel's warps do) taken on
    the inclusive prefix at the end of the group before (0 in the first
    group), Al incl + Bl. A group's last tile makes its own inclusive
    prefix from its group's map (Al, Bl, then its own) and the one
    before."""
    B, ntt, W = ta.shape
    out = ta.new_zeros(B, ntt, W)
    incl = {}
    for tt in range(ntt):
        first = tt - tt % group
        al, bl = compose_records(ta[:, first:tt], tb[:, first:tt])
        prev = incl[first - 1] if first > 0 else ta.new_zeros(B, W)
        out[:, tt] = al * prev + bl
        if tt % group == group - 1:
            ga, gb = ta[:, tt] * al, ta[:, tt] * bl + tb[:, tt]
            incl[tt] = ga * prev + gb
    return out


def lookback_scan(a, b, group=GROUP):
    """h of the kernel's algorithm: state in fp32 (fp64 for fp64
    inputs), h in a's dtype."""
    B, S, W = a.shape
    sd = torch.float64 if a.dtype == torch.float64 else torch.float32
    at, bt, wa, wb, ta, tb = tile_maps(a.to(sd), b.to(sd))
    hw = carries(ta, tb, group)
    h = torch.empty_like(at)
    for u in range(WARPS):
        hs = hw
        for i in range(STEPS):
            hs = at[:, :, u, i] * hs + bt[:, :, u, i]
            h[:, :, u, i] = hs
        hw = wa[:, :, u] * hw + wb[:, :, u]
    return h.reshape(B, -1, W)[:, :S].to(a.dtype)


def _err(x, ref):
    ref = ref.double()
    assert torch.isfinite(x).all()
    return ((x.double() - ref).abs() / ref.abs().clamp_min(1.0)).max().item()


@pytest.fixture(scope="module")
def pallas():
    """The Pallas kernel (interpret mode) on every case's gate inputs, in
    fp32 and in bf16, built once for the module."""
    out = {}
    for case in CASES:
        a, b = _inputs(case, "gates")
        for dtype, jdt in ((torch.float32, jnp.float32),
                           (torch.bfloat16, jnp.bfloat16)):
            ja, jb = (jnp.asarray(x).astype(jdt) for x in (a, b))
            out[case, dtype] = np.asarray(rglru_scan_pallas(ja, jb),
                                          np.float32)
    return out


def test_the_mirror_runs_the_kernels_tile():
    """The constants come from the kernel's source, and a tile holds
    whole warps of whole steps, a group at least one tile."""
    assert set(CONST) >= {"FWD_WARPS", "FWD_STEPS", "FWD_GROUP",
                          "FWD_LOOK"}
    assert min(WARPS, STEPS, GROUP, LOOK) >= 1
    assert "constexpr int FWD_TILE = FWD_WARPS * FWD_STEPS;" in SOURCE


@pytest.mark.parametrize("a_range", sorted(A_RANGES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_lookback_matches_plain_in_fp64(case, a_range):
    a, b = (torch.from_numpy(x).double() for x in _inputs(case, a_range))
    got = lookback_scan(a, b)
    want = rglru_scan_plain(a, b)
    assert got.shape == want.shape and got.dtype == torch.float64
    assert _err(got, want) < 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_lookback_matches_plain_and_pallas(pallas, case, dtype):
    a, b = (torch.from_numpy(x).to(dtype) for x in _inputs(case, "gates"))
    got = lookback_scan(a, b)
    assert got.dtype == dtype
    want = rglru_scan_plain(a.double(), b.double())
    assert _err(got, want) <= K4_TOL[dtype]
    assert _err(got.float(), torch.tensor(pallas[case, dtype])) <= \
        K4_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lookback_long_memory_within_the_card_limit(dtype):
    """With a near 1 the carries cross many tiles and groups: the fp32
    state still holds K4's card limit."""
    a, b = (torch.from_numpy(x).to(dtype) for x in _inputs("groups",
                                                            "long"))
    got = lookback_scan(a, b)
    assert _err(got, rglru_scan_plain(a.double(), b.double())) <= \
        K4_TOL[dtype]


@pytest.mark.parametrize("p", range(GROUP))
def test_each_stopping_point_gives_the_state_before_the_tile(p):
    """A tile at position p of its group takes the inclusive prefix that
    ends the group before (0 in the first group) through the map of its
    group's p earlier tiles: its carry is the plain state at the step
    before it, in the first group and in later ones."""
    a, b = (torch.from_numpy(x).double() for x in _inputs("groups",
                                                          "long"))
    *_, ta, tb = tile_maps(a, b)
    got = carries(ta, tb)
    h = rglru_scan_plain(a, b)
    tiles = [tt for tt in range(got.shape[1]) if tt % GROUP == p]
    assert any(tt < GROUP for tt in tiles) and \
        any(tt >= 2 * GROUP for tt in tiles)
    for tt in tiles:
        want = h[:, tt * TILE - 1] if tt > 0 else torch.zeros_like(h[:, 0])
        assert _err(got[:, tt], want) < 1e-12, tt


@pytest.mark.parametrize("group", [1, 2, 3, GROUP + 1, 64])
def test_any_group_size_gives_the_same_h(group):
    """One tile a group (a serial chain of inclusive prefixes) up to
    one group for the whole row (every map composed from 0)."""
    a, b = (torch.from_numpy(x).double() for x in _inputs("groups",
                                                          "long"))
    assert _err(lookback_scan(a, b, group),
                rglru_scan_plain(a, b)) < 1e-12
    a32, b32 = a.float(), b.float()
    assert _err(lookback_scan(a32, b32, group),
                rglru_scan_plain(a, b)) <= K4_TOL[torch.float32]
