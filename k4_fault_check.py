"""K4, forward and backward: its fp32 limit against planted faults of the
forward, and both directions timed against other source trees, on one
card.

    python3 k4_fault_check.py [--out FILE]
    python3 k4_fault_check.py --time [--tree LABEL=DIR ...]
                              [--variant LABEL=TREE:EDIT[+EDIT...] ...]
                              [--shape BxS[:bf16] ...] [--rounds N]
                              [--out FILE]
    python3 k4_fault_check.py --timeline [--shape BxS[:bf16] ...]
                              [--out FILE]

The width is recurrentgemma-2b's lru_width, 2560 channels. Both modes
build copies of `rglru_scan.cu` with nvcc in a temporary directory, one
nvcc per copy, all at once. The checkout itself is never edited. Needs
one NVIDIA GPU and nvcc; prints the card's name and power limit.

Fault mode (the default): for each planted fault of FAULTS, the port's
K4 wrappers (`rglru_scan`, `rglru_scan_bwd`) run on that copy's library
against the plain versions run in fp64, over the fp32 cases of CASES.
Per case it prints, for h, da and db, max |err| / max(1, |plain|) (the
form tests/test_torch_cuda.py holds K4 to, K4_TOL = 1e-5). The limit is
sound when every "sound" reading of h lies below it, and of da and db
where a is as the gates make it (the backward is not planted here, and
at a long memory its da reads above the limit: PERF.md), and each fault
reads above it in h in every case it must show in. Exits non-zero
otherwise. With a as the gates make it (0.3, 0.999) the product A of a
tile's 64 steps is some exp(-15), so a fault in A alone shows only
where the memory is long (a in (0.95, 0.9999)).

Time mode: the checkout's tree is "change"; `--tree` adds another
checkout root (for example the parent commit unpacked with `git
archive`), and `--variant` a tree's source with the named EDITS applied
(measurements only). At each shape (`--shape`, default TIME_SHAPES: one
4096-token row and the other shapes of chip_smoke.py phase 19 in fp32,
and one 4096-token row in bf16), a in (0.3, 0.999), each library's
forward and backward are called as the port's wrappers call them (the C
function `k4_forward` by the library's own signature), held to the plain
versions (the error of h, da and db; whether two calls give h the same
bits), their kernels timed apart (`fwd_by_kernel`, `bwd_by_kernel`),
and both directions timed in turns, `--rounds` times: `ms` by CUDA
events around 20 back-to-back calls (after 3), `device_ms` the kernels'
own time per call from torch.profiler. Beside them: the change's
wrappers (the host's cost of a call from Python) and chip_smoke.py's
byte bound.

Timeline mode: the checkout's forward with a %globaltimer stamp (thread
0 of each block, ns) at each of STAMPS: the ticket taken, the tile's
data in and its maps met, its map published, its carry in, its end, and
at a group's last tile its inclusive prefix published. Per shape
(default 1x4096 in fp32 and bf16) and call, the percentiles (10, 50,
90) in us of each phase, of a tile's life, and of its lateness: the
latest publication among the records its carry needs less the time its
own data was in (above 0: it waited for a predecessor's data, not for
its own), with the blocks resident mid-call and the span of the call.
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

CU = os.path.join("src", "repro_torch", "kernels", "csrc", "rglru_scan.cu")
K4_TOL = 1e-5               # tests/test_torch_cuda.py's fp32 limit
W = 2560                    # recurrentgemma-2b's lru_width
KEYS = ("k4_",)             # ptxas lines of K4's kernels
OUTS = ("h", "da", "db")
GATES, LONG = (0.3, 0.999), (0.95, 0.9999)

#: case -> B, S, W, the range of a; fp32. A 4096-token row at the
#: model's width, a long memory over two rows, and a ragged width (the
#: kernel's scalar path) with a part tile at the end of the row
CASES = {
    "gates_1x4096": (1, 4096, W, GATES),
    "long_2x2048": (2, 2048, W, LONG),
    "long_ragged_3x1000x301": (3, 1000, 301, LONG),
}
_ALL = tuple(CASES)
_LONG = tuple(c for c, v in CASES.items() if v[3] == LONG)

#: fault -> (the cases it must show in, in h, [(text, replacement)]),
#: each planted in k4_fwd_lookback. Each keeps every record it waits on
#: one that the call publishes with that tag, so none can hang
FAULTS = {
    "sound": ((), []),
    # the look-back takes one tile fewer of its group: it stops before
    # the group's first
    "fwd_lookback_stops_one_tile_early": (_ALL, [(
        "const int n_look = tt - first; ",
        "const int n_look = tt - first - 1; ")]),
    # the inclusive prefix read from the tile before the group's last
    # (that tile's own map)
    "fwd_carry_from_wrong_predecessor": (_ALL, [(
        "wait_record<V>(at(first - 1) + 2 * lane * V, INCL,",
        "wait_record<V>(at(first - 2) + 2 * lane * V, MAP,")]),
    # the tile's A leaves out its last warp's steps
    "fwd_aggregate_a_misses_last_steps": (_LONG, [(
        "      At[j] *= x[j];",
        "      if (u < FWD_WARPS - 1) At[j] *= x[j];")]),
    # a group's last tile publishes its carry as its inclusive prefix,
    # without its own map
    "fwd_inclusive_without_own_map": (_ALL, [(
        "incl[j] = fmaf(ga[j], prev[j], gb[j]);",
        "incl[j] = fmaf(Al[j], prev[j], Bl[j]);")]),
    # the carry into a warp's steps leaves out the tile's first warp
    "fwd_warp_carry_skips_first_warp": (_ALL, [(
        "for (int u = 0; u < warp; ++u) {",
        "for (int u = 1; u < warp; ++u) {")]),
}

#: measurement-only edits of this tree's kernel for `--time --variant`
_STEPS = "constexpr int FWD_STEPS = 8; "
_WARPS = "constexpr int FWD_WARPS = 8; "
_GROUP = "constexpr int FWD_GROUP = 4; "
_LOOK = "constexpr int FWD_LOOK = 1; "
EDITS = {
    # steps a thread holds (tile = 8 warps x steps)
    "steps_4": [(_STEPS, "constexpr int FWD_STEPS = 4; ")],
    # warps along time a block (tile = warps x 8 steps)
    "warps_4": [(_WARPS, "constexpr int FWD_WARPS = 4; ")],
    # tiles a group: 1 is a serial chain of inclusive prefixes
    "group_1": [(_GROUP, "constexpr int FWD_GROUP = 1; ")],
    "group_8": [(_GROUP, "constexpr int FWD_GROUP = 8; ")],
    "group_16": [(_GROUP, "constexpr int FWD_GROUP = 16; ")],
    # records a warp looks back at a round
    "look_2": [(_LOOK, "constexpr int FWD_LOOK = 2; ")],
    # fp32 at three blocks an SM (at most 85 registers), as bf16 runs
    "fp32_min_blocks_3": [(
        "  static constexpr int MIN_BLOCKS = 2; ",
        "  static constexpr int MIN_BLOCKS = 3; ")],
    # the polls' backoff: at most 1024 ns
    "sleep_1024": [("constexpr unsigned FWD_SLEEP_NS = 64; ",
                    "constexpr unsigned FWD_SLEEP_NS = 1024; ")],
    # what the look-back costs (wrong results): every carry 0
    "no_lookback": [("const int n_look = tt - first; ",
                     "const int n_look = 0; "),
                    ("    if (first > 0)\n      wait_record",
                     "    if (false)\n      wait_record")],
    # every load of a and b one element at a time (the ragged path)
    "scalar_loads": [("if (W % Elt<T>::V == 0 && aligned(a, step)",
                      "if (false && W % Elt<T>::V == 0 && aligned(a, step)")],
}

#: timeline stamps: (index, name, the text of the source a stamp goes
#: right after)
STAMPS = [
    (0, "ticket", "  const unsigned ticket = s_ticket;\n"),
    (1, "data", "    sput<V>(&sB[warp][lane * V], Bm);\n  }\n"
                "  __syncthreads();\n"),
    (2, "published", "    if (!last) publish<V>(at(tt) + 2 * lane * V, At, "
                     "Bt, MAP, nv);\n  }\n"),
    (5, "incl_published", "      publish<V>(at(tt) + 2 * lane * V, one, incl, "
                          "INCL, nv);\n"),
    (3, "carry", "  sget<V>(&sPB[0][lane * V], hc);\n"),
    (4, "end", "    store_step<T, VEC>(h + ((int64_t)r * f.S + t0 + i) * f.W "
               "+ c0, hc, n);\n  }\n"),
]
_STAMP_HEAD = '''__device__ unsigned long long* k4_timeline = nullptr;
#define K4_STAMP(i)                                                   \\
  if (k4_timeline && threadIdx.x == 0) {                              \\
    unsigned long long t_;                                            \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));            \\
    k4_timeline[(size_t)ticket * 8 + (i)] = t_;                       \\
  }
'''
_STAMP_TAIL = '''
extern "C" int k4_set_timeline(void* p) {
  return (int)cudaMemcpyToSymbol(k4_timeline, &p, sizeof(p));
}
'''

#: (B, S, dtype) timed: one 4096-token row and the other shapes of
#: chip_smoke.py phase 19 (recurrentgemma-2b's openvid groups) in fp32,
#: one 4096-token row in bf16
TIME_SHAPES = [(1, 4096, "fp32"), (2, 2048, "fp32"), (3, 2048, "fp32"),
               (4, 4096, "fp32"), (5, 2048, "fp32"), (1, 4096, "bf16")]


def _dtype(torch, name):
    return {"fp32": torch.float32, "bf16": torch.bfloat16}[name]


def _inputs(torch, B, S, Wd, a_range, dtype, seed):
    """a in `a_range`, b and the output gradient standard normal."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo, hi = a_range
    a = (lo + (hi - lo) * torch.rand(B, S, Wd, generator=gen, device=dev))
    b, dh = (torch.randn(B, S, Wd, generator=gen, device=dev)
             for _ in range(2))
    return [t.to(dtype) for t in (a, b, dh)]


def _err(x, r):
    """max |err| / max(1, |plain|); a value that is not finite counts as
    an infinite error."""
    r = r.double()
    d = (x.double() - r).abs().nan_to_num(nan=float("inf"))
    return (d / r.abs().clamp_min(1.0)).max().item()


def _reference(torch, a, b, dh):
    from repro_torch.kernels.rglru_scan import (rglru_scan_bwd_plain,
                                                rglru_scan_plain)
    rh = rglru_scan_plain(a.double(), b.double())
    return (rh, *rglru_scan_bwd_plain(a.double(), rh, dh.double()))


# ------------------------------------------------------------ fault mode
def _held(row):
    """The outputs a sound reading of `row` is held to: h everywhere,
    the gradients where a is as the gates make it."""
    return OUTS if CASES[row["case"]][3] == GATES else ("h",)


def readings(torch):
    """One row of errors a case, of h, da and db, through the port's
    wrappers and whatever library `build.load` hands them."""
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
    rows = []
    for i, (name, (B, S, Wd, a_range)) in enumerate(CASES.items()):
        a, b, dh = _inputs(torch, B, S, Wd, a_range, torch.float32, 30 + i)
        h = rglru_scan(a, b)
        got = (h, *rglru_scan_bwd(a, h, dh))
        ref = _reference(torch, a, b, dh)
        torch.cuda.synchronize()
        rows.append({"case": name, **{k: _err(x, r) for k, x, r in
                                      zip(OUTS, got, ref)}})
    return rows


def fault_mode(torch, tmp):
    from repro_torch.kernels import build as kbuild
    src = open(os.path.join(ROOT, CU)).read()
    libs = build({f: plant(src, edits, f)
                  for f, (_, edits) in FAULTS.items()}, tmp, keys=KEYS)
    result, ok = {}, True
    for fault, (must, _) in FAULTS.items():
        # the wrappers load "rglru_scan" through build.load
        kbuild._libs["rglru_scan"] = libs[fault]
        rows = readings(torch)
        for r in rows:
            print(json.dumps({"fault": fault, **r}), flush=True)
        if fault == "sound":
            caught = []
            ok &= all(r[k] <= K4_TOL for r in rows for k in _held(r))
        else:
            caught = [r["h"] > K4_TOL for r in rows if r["case"] in must]
            ok &= bool(caught) and all(caught)
        print(f"{fault:36s} " + " ".join(
            f"{r['case']} h {r['h']:.3g}" for r in rows))
        result[fault] = {"rows": rows, "caught_in": sum(caught),
                         "readings": len(caught)}
    return {"ok": ok, "k4_tol": K4_TOL, "faults": result}


# ------------------------------------------------------------- time mode
_STATES = {}   # library -> the forward's state (zeroed once, kept)


def _bind(lib):
    """The C functions' types, bound once a library (as the wrapper
    does). Returns whether the forward takes a state buffer (the
    single-pass forward) or a scratch of chunk maps (its parent)."""
    lookback = hasattr(lib, "k4_forward_state_words")
    if lib.k4_backward.argtypes is None:
        lib.k4_forward.argtypes = [ctypes.c_void_p] * 4 + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.k4_backward.argtypes = [ctypes.c_void_p] * 6 + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.k4_forward.restype = lib.k4_backward.restype = ctypes.c_int
        if lookback:
            lib.k4_forward_state_words.argtypes = [ctypes.c_int] * 4
            lib.k4_forward_state_words.restype = ctypes.c_longlong
    return lookback


def _code(torch, dtype):
    return 0 if dtype == torch.float32 else 1


def forward(torch, lib, a, b):
    """h of `lib`'s forward, as the port's wrapper makes it."""
    B, S, Wd = a.shape
    dt = _code(torch, a.dtype)
    h = torch.empty_like(a)
    if _bind(lib):
        words = lib.k4_forward_state_words(B, S, Wd, dt)
        state = _STATES.get(lib)
        if state is None or state.numel() < words:
            state = _STATES[lib] = torch.zeros(words, dtype=torch.int32,
                                               device=a.device)
    else:
        state = torch.empty(2 * B * (-(-S // 64)) * Wd,
                            dtype=torch.float32, device=a.device)
    err = lib.k4_forward(*[t.data_ptr() for t in (a, b, h, state)], B, S,
                         Wd, dt, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"k4_forward returned {err}")
    return h


def backward(torch, lib, a, h, dh):
    """(da, db) of `lib`'s backward."""
    B, S, Wd = a.shape
    _bind(lib)
    da, db = torch.empty_like(a), torch.empty_like(a)
    scratch = torch.empty(2 * B * (-(-S // 64)) * Wd, dtype=torch.float32,
                          device=a.device)
    err = lib.k4_backward(*[t.data_ptr() for t in (a, dh, h, da, db,
                                                   scratch)],
                          B, S, Wd, _code(torch, a.dtype),
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"k4_backward returned {err}")
    return da, db


def _traced_ms(device_ms, fn):
    """`device_ms` of fn, or None where torch.profiler traced no kernel
    in three sessions (seen late in a long process): a reading lost, not
    the run."""
    try:
        return device_ms(fn, each_once=True)[0]
    except AssertionError as e:
        print(f"no device time: {e}", flush=True)
        return None


def time_shape(torch, libs, B, S, dname, rounds):
    from chip_smoke import cuda_ms, device_ms, rglru_bound
    from k3_fault_check import kernel_ms
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
    dtype = _dtype(torch, dname)
    a, b, dh = _inputs(torch, B, S, W, GATES, dtype, 0)
    ref = _reference(torch, a, b, dh)
    rows = {}
    for label, lib in libs.items():
        h1, h2 = (forward(torch, lib, a, b) for _ in range(2))
        da, db = backward(torch, lib, a, h1, dh)
        torch.cuda.synchronize()
        rows[label] = {
            "err": {k: _err(x, r) for k, x, r in zip(OUTS, (h1, da, db),
                                                     ref)},
            "fwd_same_bits": torch.equal(h1, h2),
            "fwd_by_kernel": kernel_ms(torch, lambda lib=lib: forward(
                torch, lib, a, b)),
            "bwd_by_kernel": kernel_ms(torch, lambda lib=lib, h=h1:
                                       backward(torch, lib, a, h, dh)),
            "fwd_ms": [], "fwd_device_ms": [], "bwd_ms": [],
            "bwd_device_ms": []}
        rows[label]["h"] = h1
        del h2, da, db
    del ref
    order = list(libs) + list(libs)[::-1]
    for _ in range(rounds):
        for label in order:
            lib, h = libs[label], rows[label]["h"]
            for which, fn in (
                    ("fwd", lambda lib=lib: forward(torch, lib, a, b)),
                    ("bwd", lambda lib=lib, h=h: backward(torch, lib, a,
                                                          h, dh))):
                rows[label][f"{which}_ms"].append(cuda_ms(fn))
                rows[label][f"{which}_device_ms"].append(
                    _traced_ms(device_ms, fn))
    for row in rows.values():
        del row["h"]
    out = {"shape": f"B={B} S={S} W={W} {dname}"}
    h = rglru_scan(a, b)
    for which, fn in (("fwd", lambda: rglru_scan(a, b)),
                      ("bwd", lambda: rglru_scan_bwd(a, h, dh))):
        out[f"{which}_bound_ms"], out[f"{which}_bound_by"] = rglru_bound(
            B, S, W, dtype, which == "bwd")
        out[f"{which}_wrapper_ms"] = cuda_ms(fn)
        out[f"{which}_wrapper_device_ms"] = _traced_ms(device_ms, fn)
    out["kernels"] = rows
    for label, row in rows.items():
        print(f"{B}x{S} {dname} {label:16s} " + json.dumps(row))
    print(f"{B}x{S} {dname} " + json.dumps({k: v for k, v in out.items()
                                           if k != "kernels"}))
    return out


# --------------------------------------------------------- timeline mode
def timeline_source(src):
    """`src` with STAMPS planted and the setter of the stamps' buffer."""
    src = src.replace("namespace {\n", _STAMP_HEAD + "namespace {\n", 1)
    for i, name, text in STAMPS:
        src = plant(src, [(text, text + f"  K4_STAMP({i});\n")], name)
    return src + _STAMP_TAIL


def _tile_geometry(src):
    import re
    c = {k: int(v) for k, v in
         re.findall(r"constexpr int (FWD_[A-Z_]+) = (\d+);", src)}
    return c["FWD_WARPS"] * c["FWD_STEPS"], c["FWD_GROUP"]


def timeline(torch, lib, src, B, S, dname, calls=3):
    import numpy as np
    tile, group = _tile_geometry(src)
    dtype = _dtype(torch, dname)
    a, b, _ = _inputs(torch, B, S, W, GATES, dtype, 0)
    chains, ntt = B * -(-W // 128), -(-S // tile)
    tiles = chains * ntt
    buf = torch.zeros(tiles * 8, dtype=torch.int64, device=a.device)
    lib.k4_set_timeline.argtypes = [ctypes.c_void_p]
    for _ in range(3):
        forward(torch, lib, a, b)
    rows = []
    for _ in range(calls):
        buf.zero_()
        lib.k4_set_timeline(buf.data_ptr())
        forward(torch, lib, a, b)
        torch.cuda.synchronize()
        lib.k4_set_timeline(None)
        t = buf.view(tiles, 8).cpu().numpy().astype(np.float64)
        t[t == 0] = np.nan
        t = (t - np.nanmin(t[:, 0])) / 1e3                    # us
        tt = np.arange(tiles) // chains
        first = tt - tt % group
        late = []
        for k in range(tiles):
            deps = [t[(j * chains) + k % chains, 2]
                    for j in range(first[k], tt[k])]
            if first[k] > 0:
                deps.append(t[(first[k] - 1) * chains + k % chains, 5])
            if deps:
                late.append(np.nanmax(deps) - t[k, 1])
        span = np.nanmax(t[:, 4])
        grid = np.linspace(0, span, 64)
        q = lambda v: [round(float(np.nanpercentile(v, p)), 2)
                       for p in (10, 50, 90)]
        rows.append(dict(
            span_us=round(float(span), 2),
            data=q(t[:, 1] - t[:, 0]), publish=q(t[:, 2] - t[:, 1]),
            carry=q(t[:, 3] - t[:, 2]), rest=q(t[:, 4] - t[:, 3]),
            life=q(t[:, 4] - t[:, 0]), late=q(late),
            late_share=round(float(np.mean(np.array(late) > 0)), 3),
            resident=int(np.median([np.sum((t[:, 0] <= x) & (t[:, 4] >= x))
                                    for x in grid]))))
        print(f"{B}x{S} {dname} timeline " + json.dumps(rows[-1]),
              flush=True)
    return {"shape": f"B={B} S={S} W={W} {dname}", "calls": rows}


def _shape(spec):
    size, _, dname = spec.partition(":")
    B, S = (int(v) for v in size.split("x"))
    return B, S, dname or "fp32"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true",
                    help="time the kernels of trees and variants")
    ap.add_argument("--timeline", action="store_true",
                    help="stamp the forward's phases, tile by tile")
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--shape", action="append", default=[],
                    help="BxS or BxS:bf16, e.g. 1x4096; repeatable")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", help="write every reading to this JSON file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k4_fault_check: no CUDA device visible", file=sys.stderr)
        return 1
    from chip_smoke import card_line
    card = card_line()
    print(card)
    tmp = tempfile.mkdtemp()
    try:
        if args.timeline:
            src = timeline_source(open(os.path.join(ROOT, CU)).read())
            lib = build({"timeline": src}, tmp, keys=KEYS)["timeline"]
            shapes = ([_shape(s) for s in args.shape]
                      or [(1, 4096, "fp32"), (1, 4096, "bf16")])
            result = {"timeline": [timeline(torch, lib, src, B, S, d)
                                   for B, S, d in shapes]}
        elif args.time:
            trees = {"change": ROOT}
            trees.update(t.split("=", 1) for t in args.tree)
            libs = build_trees(tmp, trees, dict(v.split("=", 1)
                                                for v in args.variant),
                               cu=CU, edits=EDITS, keys=KEYS)
            # the wrappers' calls run this tree's library
            from repro_torch.kernels import build as kbuild
            kbuild._libs["rglru_scan"] = libs["change"]
            shapes = [_shape(s) for s in args.shape] or TIME_SHAPES
            result = {"times": [time_shape(torch, libs, B, S, d,
                                           args.rounds)
                                for B, S, d in shapes]}
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
