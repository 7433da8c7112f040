"""K3, forward and backward: its whole-tensor limit against planted
faults, and both directions timed against other source trees, on one
card.

    python3 k3_fault_check.py [--out FILE]
    python3 k3_fault_check.py --time [--tree LABEL=DIR ...]
                              [--variant LABEL=TREE:EDIT[+EDIT...] ...]
                              [--shape BSZxS ...] [--rounds N] [--out FILE]

The shape is mamba2-370m's SSD: 32 heads of 64, d_state 128, chunk 256,
C and B shared by the heads, in the model layout (C, B [Bsz, S, N], x
[Bsz, S, H, P]). Both modes build copies of `ssd_chunk.cu` with nvcc in
a temporary directory, one nvcc per copy, all at once, each with `-I`
at its tree's `csrc`. The checkout itself is never edited. Needs one
NVIDIA GPU and nvcc; prints the card's name and power limit.

Fault mode (the default): for each planted fault of FAULTS, the port's
K3 wrappers (`ssd_chunk`, `ssd_chunk_bwd`) run on that copy's library
against the plain versions run in fp64, over the fp32 cases of CASES.
Per case and output (y, states, cum) or gradient it prints max|err| /
max|plain| (`whole`, the form tests/test_torch_cuda.py holds every fp32
gradient to, K3_TOL = 1e-4). The limit is sound when every "sound"
reading lies below it and each fault reads above it in every output it
must show in, in every case. Exits non-zero otherwise.

Time mode: the checkout's tree is "change"; `--tree` adds another
checkout root (for example the parent commit unpacked with `git
archive`), and `--variant` a tree's source with the named EDITS applied
(measurements only). At each shape (`--shape`, default TIME_SHAPES: one
4096-token row and the shapes of chip_smoke.py phase 14), bf16 inputs
with the model's dt, each library's backward and forward are called as
the port's wrappers call them (outputs and scratch allocated, the C
functions `k3_backward` and `k3_forward` by the library's own signature,
and for a library that writes per-head fp32 partials of dC and dB,
their sum over heads in the input type), held to the plain versions
(whole error of each output and gradient; whether two calls give the
same bits), their kernels timed apart (`bwd_by_kernel`,
`fwd_by_kernel`), and both directions timed in turns, `--rounds` times:
`ms` by CUDA events around 10 back-to-back calls (after 2), `device_ms`
the kernels' own time per call from torch.profiler. Beside them: the
change's wrappers `ssd_chunk_bwd` and `ssd_chunk` (the host's cost of a
call from Python), and chip_smoke.py's bounds (also with the products
that run on the tensor cores at the TF32 peak).
"""
import argparse
import ctypes
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
from k1_fault_check import build, build_trees, plant  # noqa: E402

CU = os.path.join("src", "repro_torch", "kernels", "csrc", "ssd_chunk.cu")
K3_TOL = 1e-4               # tests/test_torch_cuda.py's whole-tensor limit
H, N, P, CHUNK = 32, 128, 64, 256   # mamba2-370m's SSD
KEYS = ("k3_",)             # ptxas lines of K3's kernels
OUTS = ("y", "states", "cum")
GRADS = ("dC", "dB", "dx", "dda", "ddt")

#: case -> Bsz, S, heads; fp32 inputs, mamba2-370m's N, P and chunk.
#: Shapes whose launch takes several heads a block (the backward picks
#: the count by its waves of blocks): one 4096-token row (4 heads a
#: block) and 4 x 2048 at 5 heads (2, in groups of 2, 2, 1)
CASES = {
    "1x4096": (1, 4096, H),
    "4x2048_h5": (4, 2048, 5),
}

#: fault -> (the outputs or gradients it must show in, [(text,
#: replacement)]), planted in the forward's kernel (fwd_) or the
#: backward's. Each sits next to the diagonal: with the model's dt the
#: decay across a 64-token tile is some exp(-45), so a fault farther off
#: reads 0.
FAULTS = {
    "sound": ((), []),
    # y leaves out tile pair (2, 1), the pair under the diagonal tile (1, 1)
    "fwd_drops_pair_next_to_diagonal": (("y",), [(
        "    wmm<NY, true, false, true, F32>(yacc, BT, sS, LDT, xs, LDP, wm,\n",
        "    if (cur.it != 2 || cur.jt != 1)\n"
        "    wmm<NY, true, false, true, F32>(yacc, BT, sS, LDT, xs, LDP, wm,\n")]),
    # every pair's C B^T read from the diagonal tile of its row
    "fwd_cb_from_wrong_tile": (("y",), [(
        "                     cbw + (bk * npairs + pair_id(s.it, s.jt)) *\n"
        "                               (long)(BT * BT),\n"
        "                     BT, BT);",
        "                     cbw + (bk * npairs + pair_id(s.it, s.it)) *\n"
        "                               (long)(BT * BT),\n"
        "                     BT, BT);")]),
    # a step's x read from the stage being filled for the next step
    "fwd_x_from_next_stage": (("y", "states"), [(
        "    const float* xs = sX + st * BT * LDP;\n    const bool last_row",
        "    const float* xs = sX + (st ^ 1) * BT * LDP;\n"
        "    const bool last_row")]),
    # each head's y written to the next head of its group
    "fwd_y_to_neighbour_head": (("y",), [(
        "    float* yg = y + (tok0 + i0) * ldh + (long)h * P;",
        "    float* yg = y + (tok0 + i0) * ldh + "
        "(long)(h0 + (cur.g + 1) % Gv) * P;")]),
    # the decay off the diagonal one token off: D from the row tile's
    # first token, not the one before it
    "fwd_decay_off_by_a_token": (("y",), [(
        "const float D = expf(cum[i0 - 1] - cum[j0 + BT - 1]);",
        "const float D = expf(cum[i0] - cum[j0 + BT - 1]);")]),
    # the states' w taken from the chunk's last token but one
    "fwd_states_w_off_by_one": (("states",), [(
        "expf(cum[c - 1] - cum[i]) * sDt[t]",
        "expf(cum[c - 2] - cum[i]) * sDt[t]")]),
    # dS zero on tile pair (2, 1), the pair under the diagonal tile (1, 1)
    "drops_pair_next_to_diagonal": (("dC", "dB", "dda", "ddt"), [(
        "        wmm<4, true, true, true, F32>(dsc, P, dys, LDP, xs, LDP, wm, "
        "wh * 32);\n",
        "        wmm<4, true, true, true, F32>(dsc, P, dys, LDP, xs, LDP, wm, "
        "wh * 32);\n        if (it == 2 && jt == 1) zero(dsc);\n")]),
    # the group's sum of M leaves out its second head
    "group_sum_drops_a_head": (("dC", "dB"), [(
        "            msum[n][e] += m;\n",
        "            if (g != 1) msum[n][e] += m;\n")]),
    # C B^T of every pair read from the diagonal tile of its row
    "cb_from_wrong_tile": (("dx", "dda", "ddt"), [(
        "                       cbw + (bk * npairs + pair_id(s.it, s.jt)) *",
        "                       cbw + (bk * npairs + pair_id(s.it, s.it)) *")]),
    # each head's dx written to the next head of its group
    "dx_to_neighbour_head": (("dx",), [(
        "(long)(h0 + g) * P + p, sDX[q]);",
        "(long)(h0 + (g + 1) % Gv) * P + p, sDX[q]);")]),
    # a tile pair's dy read from the stage being filled for the next step
    "dy_from_next_stage": (("dC", "dB", "dx", "dda", "ddt"), [(
        "        const float* dys = sA + st * BT * LDP;",
        "        const float* dys = sA + (st ^ 1) * BT * LDP;")]),
    # dB's sum over groups of w x dst^T leaves out the first group
    "xd_drops_first_group": (("dB",), [(
        "      for (int g = 0; g < ngroups; ++g)\n        v += xd[",
        "      for (int g = 1; g < ngroups; ++g)\n        v += xd[")]),
}

#: measurement-only edits of this tree's kernel for `--time --variant`
_BWD_G = "  return heads_per_block(BG, 0.55,"
_FWD_G = "  return heads_per_block(FG, 0.12,"
EDITS = {
    # the backward's heads a block fixed, not chosen by the waves of
    # blocks: one (32 blocks a chunk: C B^T read and M written once a
    # head), two, four
    "one_head_a_block": [(_BWD_G, "  return 1;\n" + _BWD_G)],
    "two_heads_a_block": [(_BWD_G, "  return 2;\n" + _BWD_G)],
    "four_heads_a_block": [(_BWD_G, "  return 4;\n" + _BWD_G)],
    # what the backward's two stages bought: each step's loads waited
    # for at once
    "serial_loads": [("    cp_async_commit();\n  };",
                      "    cp_async_commit();\n    cp_async_wait<0>();\n  };")],
    # what the backward's exponentials cost: L = cum_i - cum_j (wrong)
    "no_exp": [("? expf(ci[e >> 1] - cj) : 0.f;", "? (ci[e >> 1] - cj) : 0.f;")],
    # what each of the backward's products costs (wrong): dS = dy x^T,
    # dx += S^T dy, and the end-state steps' B dst and w x dst^T
    "no_ds_product": [(
        "        wmm<4, true, true, true, F32>(dsc, P, dys, LDP, xs, LDP, wm, "
        "wh * 32);\n", "")],
    "no_dx_product": [(
        "        mm<4, RP, false>(dacc, BT, sS, LDT, dys, LDP);\n",
        "")],
    # the backward's last stage at 32 rows a block (half the blocks)
    "dcb_32_rows": [("constexpr int RB = 16;", "constexpr int RB = 32;")],
    "no_state_products": [(
        "        wmm<NP, true, false, F32, true>(bd, NH, sBt + hf * NH, LDN, ds, "
        "LDP,\n", "        if (Gv < 0) wmm<NP, true, false, F32, true>(bd, NH, "
        "sBt + hf * NH, LDN, ds, LDP,\n"), (
        "        wmm<NQ, true, true, F32, true>(tp, P, xs, LDP, ds, LDP, wm,\n",
        "        if (Gv < 0) wmm<NQ, true, true, F32, true>(tp, P, xs, LDP, ds, "
        "LDP, wm,\n")],
    # the forward's heads a block fixed: one (C B^T's tiles loaded once a
    # head), two, four
    "fwd_one_head_a_block": [(_FWD_G, "  return 1;\n" + _FWD_G)],
    "fwd_two_heads_a_block": [(_FWD_G, "  return 2;\n" + _FWD_G)],
    "fwd_four_heads_a_block": [(_FWD_G, "  return 4;\n" + _FWD_G)],
    # what the forward's overlap of loads buys: every step's loads
    # issued after the step before and waited for at once
    "fwd_serial_loads": [(
        "const bool late = nx.it >= 0 && nx.g == 0 && nx.jt % SLAB == slot;",
        "const bool late = nx.it >= 0;")],
    # what the forward's exponentials cost: L = cum_i - cum_j on the
    # diagonal pairs, D = cum_s - cum_r off it (wrong)
    "fwd_no_exp": [("? expf(ci - cj[u]) : 0.f;", "? (ci - cj[u]) : 0.f;"), (
        "const float D = expf(cum[i0 - 1] - cum[j0 + BT - 1]);",
        "const float D = (cum[i0 - 1] - cum[j0 + BT - 1]);")],
    # every pair's decay by an exponential an element, as on the diagonal
    "fwd_direct_exp": [("    if (cur.it == cur.jt) {\n      float cj[4], dj[4];",
                        "    if (true) {\n      float cj[4], dj[4];")],
    # what the forward's products cost (wrong): y += S x, the states
    "fwd_no_y_product": [(
        "    wmm<NY, true, false, true, F32>(yacc, BT, sS, LDT, xs, LDP, wm,\n"
        "                                    wh * (P / 2));\n", "")],
    "fwd_no_states_product": [("    if (last_row && 16 * warp < N)\n",
                               "    if (last_row && 16 * warp < 0)\n")],
    # y += S x on the CUDA cores, not the tensor cores: each thread a 4 x
    # P/16 register tile fed by 16-byte shared reads (mm<>)
    "fwd_sx_simt": [
        ("float yacc[NY][4],", "float yacc[4][P / TX],"),
        ("        frag_io(yacc, yg, ldh, wm, wh * (P / 2), c - i0, false);",
         """        for (int a = 0; a < 4; ++a)
          if (i0 + tid / TX * 4 + a < c)
            ldv<P / TX>(yacc[a], yg + (tid / TX * 4 + a) * ldh +
                                     tid % TX * (P / TX));"""),
        ("    wmm<NY, true, false, true, F32>(yacc, BT, sS, LDT, xs, LDP, wm,\n"
         "                                    wh * (P / 2));\n",
         "    mm<4, P / TX, true>(yacc, BT, sS, LDT, xs, LDP);\n"),
        ("      frag_io(yacc, yg, ldh, wm, wh * (P / 2), c - i0, true);",
         """      for (int a = 0; a < 4; ++a)
        if (i0 + tid / TX * 4 + a < c)
          stv<P / TX>(yg + (tid / TX * 4 + a) * ldh + tid % TX * (P / TX),
                      yacc[a]);""")],
    # the states' product on the CUDA cores: each thread N/16 x P/16
    "fwd_states_simt": [
        ("  if constexpr (V == 4) {\n"
         "    const float4 v = *reinterpret_cast<const float4*>(p);",
         """  if constexpr (V == 8) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    const float4 v = *reinterpret_cast<const float4*>(p + 4);
    o[0] = u.x, o[1] = u.y, o[2] = u.z, o[3] = u.w;
    o[4] = v.x, o[5] = v.y, o[6] = v.z, o[7] = v.w;
  } else if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);"""),
        ("sacc[NS][4];", "sacc[N / TY][P / TX];"),
        ("        if (last_row) frag_io(sacc, sg, P, 16 * warp, 0, N, false);",
         """        if (last_row)
          for (int a = 0; a < N / TY; ++a)
            ldv<P / TX>(sacc[a], sg + (tid / TX * (N / TY) + a) * P +
                                     tid % TX * (P / TX));"""),
        ("    if (last_row && 16 * warp < N)\n"
         "      wmm<NS, false, false, true, F32>(sacc, BT, sB + st * BT * LDB, "
         "LDB,\n                                       xs, LDP, 16 * warp, "
         "0);\n",
         "    if (last_row)\n      mm<N / TY, P / TX, false>(sacc, BT, "
         "sB + st * BT * LDB, LDB, xs, LDP);\n"),
        ("      if (last_row) frag_io(sacc, sg, P, 16 * warp, 0, N, true);",
         """      if (last_row)
        for (int a = 0; a < N / TY; ++a)
          stv<P / TX>(sg + (tid / TX * (N / TY) + a) * P +
                          tid % TX * (P / TX), sacc[a]);""")],
}

#: (Bsz, S) timed: one 4096-token row and the other shapes of
#: chip_smoke.py phase 14 (mamba2-370m's openvid groups)
TIME_SHAPES = [(1, 4096), (2, 2048), (3, 2048), (5, 2048), (4, 4096)]


def _inputs(torch, Bsz, S, heads, dtype, seed):
    """(C, B, x, da, dt) as chip_smoke.ssd_inputs makes them, and the
    output gradients (dy, dstates, dcum), fp32."""
    from chip_smoke import ssd_inputs
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    ins = ssd_inputs(dev, gen, Bsz, S, heads, N, P, dtype)
    nc = S // CHUNK
    douts = [torch.randn(s, generator=gen, device=dev)
             for s in ((Bsz, S, heads, P), (Bsz, nc, heads, N, P),
                       (Bsz, S, heads))]
    return list(ins), douts


def _whole(a, r):
    """max|err| / max|plain|; a value that is not finite counts as an
    infinite error."""
    d = (a.double() - r.double()).abs().nan_to_num(nan=float("inf"))
    return d.max().item() / max(r.double().abs().max().item(), 1e-30)


def _reference(torch, ins, douts):
    """The plain forward's (y, states, cum) and backward's gradients, run
    in fp64."""
    from repro_torch.kernels.ssd_chunk import (ssd_chunk_bwd_plain,
                                               ssd_chunk_plain)
    ins64 = [t.double() for t in ins]
    return (ssd_chunk_plain(*ins64, chunk=CHUNK),
            ssd_chunk_bwd_plain(*ins64, *douts, chunk=CHUNK))


# ------------------------------------------------------------ fault mode
def readings(torch):
    """One row of whole errors a case, of every output and gradient,
    through the port's wrappers and whatever library `build.load` hands
    them."""
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_bwd
    rows = []
    for i, (name, (Bsz, S, heads)) in enumerate(CASES.items()):
        ins, douts = _inputs(torch, Bsz, S, heads, torch.float32, 20 + i)
        got = (*ssd_chunk(*ins, chunk=CHUNK),
               *ssd_chunk_bwd(*ins, *douts, chunk=CHUNK))
        ref_fwd, ref_bwd = _reference(torch, ins, douts)
        torch.cuda.synchronize()
        rows.append({"case": name, **{k: _whole(a, r) for k, a, r in
                                      zip(OUTS + GRADS, got,
                                          (*ref_fwd, *ref_bwd))}})
    return rows


def fault_mode(torch, tmp):
    from repro_torch.kernels import build as kbuild
    src = open(os.path.join(ROOT, CU)).read()
    libs = build({f: plant(src, edits, f)
                  for f, (_, edits) in FAULTS.items()}, tmp, keys=KEYS)
    result, ok = {}, True
    for fault, (must, _) in FAULTS.items():
        # the wrappers load "ssd_chunk" through build.load
        kbuild._libs["ssd_chunk"] = libs[fault]
        rows = readings(torch)
        for r in rows:
            print(json.dumps({"fault": fault, **r}), flush=True)
        if fault == "sound":
            caught = []
            ok &= all(r[k] <= K3_TOL for r in rows for k in OUTS + GRADS)
        else:
            caught = [r[k] > K3_TOL for r in rows for k in must]
            ok &= all(caught)
        print(f"{fault:32s} " + " ".join(
            f"{k} {min(r[k] for r in rows):.3g}-{max(r[k] for r in rows):.3g}"
            for k in OUTS + GRADS))
        result[fault] = {"rows": rows, "caught_in": sum(caught),
                         "readings": len(caught)}
    return {"ok": ok, "k3_tol": K3_TOL, "faults": result}


# ------------------------------------------------------------- time mode
def _bind(lib):
    """The C functions' types, bound once a library (as the wrapper
    does). Returns (whether the backward takes a scratch buffer and
    writes dC and dB summed over heads, else per-head fp32 partials;
    whether the forward takes a scratch buffer, the C B^T it shares)."""
    grouped = hasattr(lib, "k3_backward_work")
    fwd_work = hasattr(lib, "k3_forward_work")
    if lib.k3_backward.argtypes is None:
        for fn, n_ptr in ((lib.k3_backward, 14 if grouped else 13),
                          (lib.k3_forward, 9 if fwd_work else 8)):
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + \
                [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        for name in ["k3_backward_work"] * grouped + \
                ["k3_forward_work"] * fwd_work:
            getattr(lib, name).argtypes = [ctypes.c_int] * 7
            getattr(lib, name).restype = ctypes.c_longlong
    return grouped, fwd_work


def backward(torch, lib, ins, douts):
    """(dC, dB, dx, dda, ddt) of `lib`, as the port's wrapper makes
    them: bf16 dC, dB, dx; fp32 dda, ddt."""
    C, B, x, da, dt = ins
    Bsz, S, heads, _ = x.shape
    grouped, _ = _bind(lib)
    dev, f32 = x.device, dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    dda, ddt = (torch.empty(Bsz, S, heads, **f32) for _ in range(2))
    ptrs = [C, B, x, da, dt, *douts]
    if grouped:
        dC, dB = (torch.empty(Bsz, S, N, dtype=x.dtype, device=dev)
                  for _ in range(2))
        nbytes = lib.k3_backward_work(Bsz, S, heads, N, P, CHUNK, 1)
        work = torch.empty(max(nbytes, 1), dtype=torch.uint8, device=dev)
        ptrs += [dC, dB, dx, dda, ddt, work]
    else:
        dC, dB = (torch.empty(Bsz, S, heads, N, **f32) for _ in range(2))
        ptrs += [dC, dB, dx, dda, ddt]
    err = lib.k3_backward(*[t.data_ptr() for t in ptrs], Bsz, S, heads, N,
                          P, CHUNK, C.stride(1), x.stride(1), 1,
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"k3_backward returned {err}")
    if not grouped:
        dC, dB = dC.sum(2).to(x.dtype), dB.sum(2).to(x.dtype)
    return dC, dB, dx, dda, ddt


def forward(torch, lib, ins):
    """(y, states, cum) of `lib`, fp32, as the port's wrapper makes
    them."""
    C, B, x, da, dt = ins
    Bsz, S, heads, _ = x.shape
    _, fwd_work = _bind(lib)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty(Bsz, S, heads, P, **f32)
    st = torch.empty(Bsz, S // CHUNK, heads, N, P, **f32)
    cum = torch.empty(Bsz, S, heads, **f32)
    ptrs = [C, B, x, da, dt, y, st, cum]
    if fwd_work:
        nbytes = lib.k3_forward_work(Bsz, S, heads, N, P, CHUNK, 1)
        ptrs.append(torch.empty(max(nbytes, 1), dtype=torch.uint8,
                                device=x.device))
    err = lib.k3_forward(*[t.data_ptr() for t in ptrs],
                         Bsz, S, heads, N, P, CHUNK, C.stride(1),
                         x.stride(1), 1,
                         torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"k3_forward returned {err}")
    return y, st, cum


def kernel_ms(torch, fn, iters=10, warmup=2):
    """Device time per call of each kernel `fn` launches, by name (up to
    its template arguments), from one torch.profiler session."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            # "void (anonymous namespace)::k3_bwd_heads<...>(...)"
            name = ev.name.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("<")[0].split("(")[0]
            out[name] = out.get(name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3 / iters
    return out


def time_shape(torch, libs, Bsz, S, rounds):
    from chip_smoke import cuda_ms, device_ms, ssd_bound
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_bwd
    ins, douts = _inputs(torch, Bsz, S, H, torch.bfloat16, 0)
    ref_fwd, ref = _reference(torch, ins, douts)
    rows = {}
    for label, lib in libs.items():
        g1, g2 = (backward(torch, lib, ins, douts) for _ in range(2))
        o1, o2 = (forward(torch, lib, ins) for _ in range(2))
        torch.cuda.synchronize()
        rows[label] = {
            "whole": {g: _whole(a, r) for g, a, r in zip(GRADS, g1, ref)},
            "same_bits": all(torch.equal(a, b) for a, b in zip(g1, g2)),
            "fwd_whole": {k: _whole(a, r)
                          for k, a, r in zip(OUTS, o1, ref_fwd)},
            "fwd_same_bits": all(torch.equal(a, b) for a, b in zip(o1, o2)),
            "bwd_by_kernel": kernel_ms(torch, lambda lib=lib: backward(
                torch, lib, ins, douts)),
            "fwd_by_kernel": kernel_ms(torch, lambda lib=lib: forward(
                torch, lib, ins)),
            "bwd_ms": [], "bwd_device_ms": [], "fwd_ms": [],
            "fwd_device_ms": []}
        del g1, g2, o1, o2
    del ref, ref_fwd
    order = list(libs) + list(libs)[::-1]
    for _ in range(rounds):
        for label in order:
            for which, fn in (
                    ("bwd", lambda lib=libs[label]: backward(
                        torch, lib, ins, douts)),
                    ("fwd", lambda lib=libs[label]: forward(
                        torch, lib, ins))):
                rows[label][f"{which}_ms"].append(
                    cuda_ms(fn, iters=10, warmup=2))
                rows[label][f"{which}_device_ms"].append(
                    device_ms(fn, iters=10, warmup=2)[0])
    out = {"shape": f"Bsz={Bsz} S={S} H={H} N={N} P={P} c={CHUNK} bf16"}
    for which, fn in (("bwd", lambda: ssd_chunk_bwd(*ins, *douts,
                                                     chunk=CHUNK)),
                      ("fwd", lambda: ssd_chunk(*ins, chunk=CHUNK))):
        b, by = ssd_bound(Bsz, S, H, N, P, CHUNK, torch.bfloat16,
                          which == "bwd")
        out[f"{which}_bound_ms"], out[f"{which}_bound_by"] = b, by
        out[f"{which}_bound_tc_ms"], out[f"{which}_bound_tc_by"] = \
            ssd_bound(Bsz, S, H, N, P, CHUNK, torch.bfloat16,
                      which == "bwd", tensor_cores=True)
        out[f"{which}_wrapper_ms"] = cuda_ms(fn, iters=10, warmup=2)
        out[f"{which}_wrapper_device_ms"], \
            out[f"{which}_wrapper_kernels_per_call"] = device_ms(
                fn, iters=10, warmup=2)
    out["kernels"] = rows
    for label, row in rows.items():
        print(f"{Bsz}x{S} {label:20s} " + json.dumps(row))
    print(f"{Bsz}x{S} " + json.dumps({k: v for k, v in out.items()
                                      if k != "kernels"}))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true",
                    help="time the kernels of trees and variants")
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--shape", action="append", default=[],
                    help="BSZxS, e.g. 1x4096; repeatable")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", help="write every reading to this JSON file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k3_fault_check: no CUDA device visible", file=sys.stderr)
        return 1
    from chip_smoke import card_line
    card = card_line()
    print(card)
    tmp = tempfile.mkdtemp()
    try:
        if args.time:
            trees = {"change": ROOT}
            trees.update(t.split("=", 1) for t in args.tree)
            libs = build_trees(tmp, trees, dict(v.split("=", 1)
                                                for v in args.variant),
                               cu=CU, edits=EDITS, keys=KEYS)
            # the wrappers' calls run this tree's library
            from repro_torch.kernels import build as kbuild
            kbuild._libs["ssd_chunk"] = libs["change"]
            shapes = ([tuple(int(v) for v in s.split("x"))
                       for s in args.shape] or TIME_SHAPES)
            result = {"times": [time_shape(torch, libs, Bsz, S, args.rounds)
                                for Bsz, S in shapes]}
        else:
            result = fault_mode(torch, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result["card"] = card
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    if "faults" in result:
        print(json.dumps({"card": card, "ok": result["ok"], "caught": {
            f: f"{r['caught_in']}/{r['readings']}"
            for f, r in result["faults"].items() if f != "sound"}}))
    return 0 if result.get("ok", True) else 1


if __name__ == "__main__":
    sys.exit(main())
