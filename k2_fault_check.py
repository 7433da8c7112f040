"""K2's limits against planted faults, and K2 timed against other source
trees, on one card.

    python3 k2_fault_check.py [--out FILE]
    python3 k2_fault_check.py --time [--tree LABEL=DIR ...]
                              [--variant LABEL=TREE:EDIT[+EDIT...] ...]
                              [--rounds N] [--out FILE]

The bf16 shapes are internvl3-2b's attention on the serving path: 12
query heads over 2 KV heads of 128, bf16, in the model layout [B, S, H,
D]; the fault mode adds pixtral-12b's, 32 over 8 heads of 160 (tiles of
192 columns in shared memory, the upper 32 zero-filled). The fp32 shapes
are whisper-small's (12:12 heads of 64, full mode over its 1500 frames,
what its encoder and cross-attention run from fp32 frames), and in the
fault mode also internvl3-2b's heads (GQA at D = 128).
Both modes build copies of `flash_attention.cu` with nvcc in a temporary
directory, one nvcc per copy, all at once, each with `-I` at its tree's
`csrc` for the headers it includes. The checkout itself is never edited.
Needs one NVIDIA GPU and nvcc; prints the card's name and power limit.

Fault mode (the default): for each planted fault of FAULTS, the port's
K2 wrapper runs on that copy's library against the plain version over
the cases of CASES: in bf16 chip_smoke.py phase 3's 4x2048 causal, 4x256
causal at kv_offset 96 and 2x512 sliding at window 128, at D = 160
4x2048 causal, 1x1500 causal and 2x512 sliding; in fp32 whisper-small's
1x1500 full, 4x256 causal at kv_offset 96, 2x512 sliding at window 128
and 2x512 causal at 12:2 heads of 128. Per case it prints max|err| /
max(1, |plain|) (`elementwise`, the form phase 3 holds to 2e-2 in bf16
and 1e-4 in fp32) and max|err| / max|plain| (`whole`). A fault named
`f32_*` is planted in the fp32 kernel and read in the fp32 cases, the
others in the bf16 kernel and the bf16 cases. The limits are sound when
every "sound" reading lies below its dtype's limit and each fault reads
above it in every case it must show in. Exits non-zero otherwise.

Time mode: the checkout's tree is "change"; `--tree` adds another
checkout root (for example the parent commit unpacked with `git
archive`), and `--variant` a tree's source with the named EDITS applied
(measurements only: some drop work on purpose, and their errors show
it). Each is called through its C interface `flash_attention_fwd` at
the shapes of TIME_SHAPES (bf16 causal: phases 3 and 6; fp32 full:
phase 35's AUDIO_SHAPES at whisper-small's heads), held to the plain
version (elementwise error, and whether two calls give the same bits),
and timed in turns, `--rounds` times: `ms` by CUDA events around 20
back-to-back calls (after 3), `device_ms` the kernels' own time per
call from torch.profiler. Beside them: the port's wrapper around the
change's library (`wrapper_ms`: the host's cost of a call from Python),
SDPA both ways, and chip_smoke.py's bound (for fp32 at split TF32, the
kernel's own arithmetic, with the CUDA-core bound beside it).
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
from chip_smoke import (AUDIO_SHAPES, WHISPER_FRAMES,  # noqa: E402
                        WHISPER_HEADS)
from k1_fault_check import build, build_trees, plant  # noqa: E402

CU = os.path.join("src", "repro_torch", "kernels", "csrc",
                  "flash_attention.cu")
REL_TOL_BF16 = 2e-2     # chip_smoke.py phase 3's bf16 limit
REL_TOL_F32 = 1e-4      # and its fp32 one
H, HKV, D = 12, 2, 128  # internvl3-2b's attention heads
KEYS = ("flash_fwd",)   # ptxas lines of K2's kernels
#: the kernel of flash_attention.cu each dtype runs
KERNELS = {"bfloat16": "flash_fwd_wg_kernel",
           "float32": "flash_fwd_f32_kernel"}

#: case -> B, S, mode, window, kv_offset, tags; the cases tagged "f32"
#: run in fp32, the others in bf16; those tagged "d160" run at
#: pixtral-12b's heads (CASE_HEADS), "d64" at whisper-small's, the others
#: at internvl3-2b's
CASES = {
    "4x2048_causal": (4, 2048, "causal", None, 0, {"causal"}),
    "4x256_causal_offset96": (4, 256, "causal", None, 96, {"causal"}),
    "2x512_sliding128": (2, 512, "sliding", 128, 0, {"sliding"}),
    "4x2048_causal_d160": (4, 2048, "causal", None, 0, {"causal", "d160"}),
    "1x1500_causal_d160": (1, 1500, "causal", None, 0, {"causal", "d160"}),
    "2x512_sliding128_d160": (2, 512, "sliding", 128, 0,
                              {"sliding", "d160"}),
    "f32_1x1500_full_d64": (1, WHISPER_FRAMES, "full", None, 0,
                            {"f32", "full", "d64"}),
    "f32_4x256_causal_offset96_d64": (4, 256, "causal", None, 96,
                                      {"f32", "causal", "d64"}),
    "f32_2x512_sliding128_d64": (2, 512, "sliding", 128, 0,
                                 {"f32", "sliding", "d64"}),
    "f32_2x512_causal_gqa": (2, 512, "causal", None, 0,
                             {"f32", "causal", "gqa"}),
}
#: (query heads, KV heads, head_dim) of a case: pixtral-12b's for "d160",
#: whisper-small's for "d64", else internvl3-2b's
CASE_HEADS = {name: (32, 8, 160) if "d160" in case[5] else
              WHISPER_HEADS if "d64" in case[5] else (H, HKV, D)
              for name, case in CASES.items()}


def case_dtype(tags) -> str:
    return "float32" if "f32" in tags else "bfloat16"


def fault_dtype(fault: str) -> str:
    """The dtype whose kernel a fault is planted in (and whose cases it
    is read in): `f32_*` the fp32 kernel, the others the bf16 one."""
    return "float32" if fault.startswith("f32_") else "bfloat16"


def limit(dtype: str) -> float:
    return REL_TOL_F32 if dtype == "float32" else REL_TOL_BF16

#: fault -> (the tags of the cases it must show in (None: every case of
#: its dtype), [(text, replacement)]), planted in the kernel of its dtype
#: (fault_dtype): flash_fwd_f32_kernel for `f32_*`, else
#: flash_fwd_wg_kernel
FAULTS = {
    "sound": (None, []),
    # key tile 2 (keys 128-191) never computed
    "drops_key_tile": (None, [(
        "    if (!mine(j)) continue;",
        "    if (!mine(j) || j == 2) continue;")]),
    # the unmasked path one key tile past the diagonal: the tile whose
    # keys reach past some of the warpgroup's rows
    "unmasked_causal_edge": ({"causal"}, [(
        "            (kp0 + W_BK - 1 <= r0 &&",
        "            (kp0 - 1 <= r0 &&")]),
    # the unmasked path within the window of the warpgroup's first row
    # but not of its last
    "unmasked_window_edge": ({"sliding"}, [(
        "             (mode != kSliding || kp0 > r0 + 63 - window)));",
        "             (mode != kSliding || kp0 > r0 - 1 - window)));")]),
    # V read from the ring's other stage (the tile before, or the one
    # landing)
    "ring_stage_stale": (None, [(
        "    const uint32_t ka = smem_u32(ring + st * 2 * TB), va = ka + TB;",
        "    const uint32_t ka = smem_u32(ring + st * 2 * TB),\n"
        "                   va = smem_u32(ring + (st ^ 1) * 2 * TB) + TB;")]),
    # the second warpgroup's rows formed from the first's queries
    "second_wg_reads_first_q": (None, [(
        "  const uint32_t qa = smem_u32(Qs + wg * TB);",
        "  const uint32_t qa = smem_u32(Qs);")]),
    # each query head reads the next group's KV head
    "kv_head_off_by_one": (None, [(
        "  const int h = blockIdx.x, b = blockIdx.z;\n"
        "  const int hk = h / (H / Hkv);",
        "  const int h = blockIdx.x, b = blockIdx.z;\n"
        "  const int hk = (h / (H / Hkv) + 1) % Hkv;")]),
    # D = 160 alone, the tiles' third, half-used 64-column block: O's
    # columns 128-159 formed from V's second block
    "d160_v_third_block": ({"d160"}, [(
        "        const uint32_t v3 = va + 2 * SW_BLOCK + kk * 2048;",
        "        const uint32_t v3 = va + SW_BLOCK + kk * 2048;")]),
    # Q's and K's upper 32 columns not zero-filled: they read their first
    # 8 again, and the scores gain their product
    "d160_zero_fill_left_out": ({"d160"}, [
        ("               qp < Sq && c < CH);", "               qp < Sq);"),
        ("      cp_async16(Ks + sw128<W_BK>(r, c), kb + off, "
         "kp < Sk && c < CH);",
         "      cp_async16(Ks + sw128<W_BK>(r, c), kb + off, kp < Sk);")]),
    # the softmax scale taken at the tiles' 192 columns, not 160
    "d160_scale_at_192": ({"d160"}, [(
        "  const float sl2 = scale * 1.4426950408889634f;",
        "  const float sl2 = rsqrtf((float)DP) * 1.4426950408889634f;")]),
    # fp32: the lo terms dropped, every product hi hi' alone (plain TF32,
    # some 2e-4 to 4e-4 off at whisper's 1500 keys): every lo is 0, by a
    # test the compiler cannot fold, so the build keeps the sound one's
    # products and registers (deleting the lo products instead gave a
    # build whose P operands overwrote Q's lo registers: 0.3 off)
    "f32_lo_dropped": ({"full"}, [(
        "    return tf32(x - __uint_as_float(hi));",
        "    return Sq < 0 ? tf32(x - __uint_as_float(hi)) : 0u;")]),
    # fp32: the last key tile of each block's walk never formed (over
    # 1500 keys the partial one of 28; at the diagonal under causal order)
    "f32_last_key_tile_dropped": (None, [(
        "  const int jt_hi = (j_hi + F_BK - 1) / F_BK;",
        "  const int jt_hi = (j_hi + F_BK - 1) / F_BK - 1;")]),
    # fp32: V^T's keys in their own order, not in the order of P's A
    # operand (a key's probability meets another key's values)
    "f32_v_keys_unpermuted": (None, [(
        "      const int kap = (r & ~7) + ((w & 1) ? 4 + (w >> 1) : "
        "(w >> 1));",
        "      const int kap = r + 0 * w;")]),
    # fp32: O not rescaled when a row's running max rises
    "f32_max_correction_skipped": (None, [(
        "      for (int e = 0; e < 4; ++e) acc[nd][e] *= corr[e >> 1];",
        "      for (int e = 0; e < 4; ++e) acc[nd][e] *= 1.f;")]),
}

#: the fp32 kernel's four lo products, S's two and P V's two, each as
#: (its line, "")
_F32_LO_PRODUCTS = [
    (f"      wgmma_tf32<{n}>({acc}, {a}[kk], "
     f"wg_desc({b} + off, 16, SW_GROUP));\n", "")
    for n, acc, a, b in (("F_BK", "&s[0][0]", "ql", "ka"),
                         ("F_BK", "&s[0][0]", "qh", "kl"),
                         ("D", "&acc[0][0]", "pl", "vh"),
                         ("D", "&acc[0][0]", "ph", "vl"))]

#: measurement-only edits of this tree's kernel for `--time --variant`
EDITS = {
    # what the unmasked path bought: every tile tests every pair
    "masked": [("    if (whole(j)) {", "    if (false && whole(j)) {")],
    # what the pair mask still costs: every tile unmasked
    "unmasked": [("    if (whole(j)) {", "    if (true || whole(j)) {")],
    # what the ring bought: one stage, each tile loaded after the last is
    # formed
    "one_stage": [
        ("constexpr int W_STAGES = 2;", "constexpr int W_STAGES = 1;"),
        ("  for (; j < jt_hi; ++j, st ^= 1) {\n",
         "  for (; j < jt_hi; ++j) {\n    if (j > j_lo / W_BK) {\n"
         "      __syncthreads();\n      load_kv(j, 0);\n    }\n"),
        ("    if (j + 1 < jt_hi) load_kv(j + 1, st ^ 1);  // lands while j "
         "is formed\n", "")],
    # what the exponentials cost: p = s - m, no ex2 (o is wrong)
    "no_exp": [("        s[n][e] = ex2(s[n][e] - mu[e >> 1]);",
                "        s[n][e] = s[n][e] - mu[e >> 1];")],
    # what O += P V costs: the product never issued (o is wrong)
    "no_pv": [("        wgmma_rs_n128<1>(&acc[0][0], a[kk], dsc);",
               "        if (Sq < 0) wgmma_rs_n128<1>(&acc[0][0], a[kk], dsc);")],
    # one block an SM: up to 255 registers a thread, no spill
    "one_block_per_sm": [
        ("__launch_bounds__(W_THREADS, WgTile<D>::MIN_BLOCKS)",
         "__launch_bounds__(W_THREADS, 1)")],
    # what the order bought: the first query tiles issued first
    "light_first": [(
        "  const int q0 = ((Sq + W_BQ - 1) / W_BQ - 1 - (int)blockIdx.y) * "
        "W_BQ;",
        "  const int q0 = (int)blockIdx.y * W_BQ;")],
    # fp32: what the split products cost: plain TF32 (o is off by ~3e-4)
    "f32_plain_tf32": FAULTS["f32_lo_dropped"][1],
    # fp32: the lo products deleted, not zeroed (S's two, then P V's
    # two): with nvcc 12.9 a build whose P operands take registers that
    # hold Q's lo, so o is far off from the second key tile on (see the
    # source note); P V's two alone do the same
    "f32_lo_products_deleted": _F32_LO_PRODUCTS,
    "f32_pv_lo_products_deleted": _F32_LO_PRODUCTS[2:],
    # fp32: what splitting the K and V tiles costs: neither split pass
    # runs (o is wrong)
    "f32_no_split_pass": [
        ("    for (int i = tid; i < F_BK * CH; i += F_THREADS) {\n"
         "      const uint32_t off = sw128<F_BK>(i / CH, i % CH);",
         "    for (int i = tid; i < 0; i += F_THREADS) {\n"
         "      const uint32_t off = sw128<F_BK>(i / CH, i % CH);"),
        ("    for (int i = tid; i < F_BK * CH; i += F_THREADS) {\n"
         "      const int r = i % F_BK, c = i / F_BK, w = r & 7;",
         "    for (int i = tid; i < 0; i += F_THREADS) {\n"
         "      const int r = i % F_BK, c = i / F_BK, w = r & 7;")],
}

#: shapes timed: (B, Sq, Sk, (H, Hkv, D), dtype, mode); bf16 causal at
#: internvl3-2b's heads (phases 3 and 6), fp32 full at whisper-small's
#: (phase 35's AUDIO_SHAPES over its 1500 frames)
TIME_SHAPES = [(B, S, S, (H, HKV, D), "bfloat16", "causal")
               for B, S in ((1, 64), (1, 128), (4, 256), (4, 2048))] + [
    (B, Sq, WHISPER_FRAMES, WHISPER_HEADS, "float32", "full")
    for B, Sq in AUDIO_SHAPES]


def _inputs(torch, B, S, seed, heads=(H, HKV, D), dtype="bfloat16",
            Sk=None):
    h, hkv, d = heads
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    q = torch.randn(B, S, h, d, generator=gen, device=dev).to(dt)
    k, v = (torch.randn(B, Sk or S, hkv, d, generator=gen,
                        device=dev).to(dt) for _ in range(2))
    return q, k, v


def _errs(out, ref):
    """Elementwise and whole errors; a value that is not finite (a read of
    shared memory never written) counts as an infinite error."""
    ref = ref.float()
    d = (out.float() - ref).abs().nan_to_num(nan=float("inf"))
    return {"elementwise": (d / ref.abs().clamp_min(1.0)).max().item(),
            "whole": d.max().item() / ref.abs().max().item()}


# ------------------------------------------------------------ fault mode
def readings(torch):
    """One row of readings a case, through the port's wrapper and
    whatever library `build.load` hands it."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    rows = []
    for i, (name, (B, S, mode, window, off, tags)) in enumerate(
            CASES.items()):
        q, k, v = _inputs(torch, B, S, 10 + i, CASE_HEADS[name],
                          case_dtype(tags))
        kw = dict(mode=mode, window=window, kv_offset=off)
        out = flash_attention(q, k, v, **kw)
        ref = flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        rows.append({"case": name, "tags": sorted(tags),
                     "dtype": case_dtype(tags), **_errs(out, ref)})
    return rows


def must_show_in(fault, rows):
    """The rows of the cases a fault must read above its limit in: its
    dtype's cases whose tags meet the fault's (all of them for None)."""
    tags = FAULTS[fault][0]
    return [r for r in rows if r["dtype"] == fault_dtype(fault)
            and (tags is None or tags & set(r["tags"]))]


def fault_mode(torch, tmp):
    from repro_torch.kernels import build as kbuild
    src = open(os.path.join(ROOT, CU)).read()
    libs = build({f: plant(src, edits, f)
                  for f, (_, edits) in FAULTS.items()}, tmp, keys=KEYS)
    result, ok = {}, True
    for fault in FAULTS:
        # the wrapper loads "flash_attention" through build.load
        kbuild._libs["flash_attention"] = libs[fault]
        rows = readings(torch)
        must = rows if fault == "sound" else must_show_in(fault, rows)
        for r in rows:
            print(json.dumps({"fault": fault, **r}), flush=True)
        elt = [r["elementwise"] for r in must]
        print(f"{fault:28s} elementwise {min(elt):.4g}-{max(elt):.4g} "
              f"({len(must)} cases)")
        if fault == "sound":
            caught = [False]
            ok &= all(r["elementwise"] <= limit(r["dtype"]) for r in rows)
        else:
            caught = [r["elementwise"] > limit(r["dtype"]) for r in must]
            ok &= all(caught)
        result[fault] = {"rows": rows, "caught_in": sum(caught),
                         "cases": len(must)}
    return {"ok": ok, "rel_tol_bf16": REL_TOL_BF16,
            "rel_tol_f32": REL_TOL_F32, "faults": result}


# ------------------------------------------------------------- time mode
def call(torch, lib, q, k, v, o, mode):
    """o <- flash_attention_fwd of `lib` in `mode`, no offset, in q's
    dtype at q's and k's shapes."""
    from repro_torch.kernels.flash_attention import MODES
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:     # bound once a library, as the wrapper does
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    B, Sq, h, d = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq,
             k.shape[1], h, k.shape[2], d,
             int(q.dtype == torch.bfloat16), MODES[mode], 0, 0,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd returned {err}")
    return o


def time_shape(torch, libs, B, Sq, Sk, heads, dtype, mode, rounds):
    import torch.nn.functional as F
    from chip_smoke import SPLIT_TF32, attention_bound, cuda_ms, device_ms
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    q, k, v = _inputs(torch, B, Sq, 0, heads, dtype, Sk)
    ref = flash_attention_ref(q, k, v, mode=mode)
    rows = {}
    for label, lib in libs.items():
        o1, o2 = (call(torch, lib, q, k, v, torch.empty_like(q), mode)
                  for _ in range(2))
        torch.cuda.synchronize()
        rows[label] = {"err": _errs(o1, ref)["elementwise"],
                       "same_bits": bool(torch.equal(o1, o2)),
                       "ms": [], "device_ms": []}
    o = torch.empty_like(q)
    for _ in range(rounds):
        for label in list(libs) + list(libs)[::-1]:
            fn = (lambda lib=libs[label]: call(torch, lib, q, k, v, o,
                                               mode))
            rows[label]["ms"].append(cuda_ms(fn))
            rows[label]["device_ms"].append(device_ms(fn)[0])
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=(mode == "causal"), enable_gqa=True)
    wrap = (lambda: flash_attention(q, k, v, mode=mode))
    fp32 = q.dtype == torch.float32
    bound, bound_by = attention_bound(B, Sq, Sk, *heads, q.dtype, mode,
                                      None, 0, SPLIT_TF32 if fp32 else None)
    tag = f"{B}x{Sq}" + (f"x{Sk}" if Sk != Sq else "") + f" {dtype}"
    out = {"shape": f"B={B} Sq={Sq} Sk={Sk} H={heads[0]} Hkv={heads[1]} "
                    f"D={heads[2]} {dtype} {mode}",
           "bound_ms": bound, "bound_by": bound_by}
    if fp32:
        out["bound_cuda_core_ms"] = attention_bound(
            B, Sq, Sk, *heads, q.dtype, mode, None, 0)[0]
    for name, fn in (("wrapper", wrap), ("sdpa", sdpa)):
        out[f"{name}_ms"] = cuda_ms(fn)
        out[f"{name}_device_ms"], out[f"{name}_kernels_per_call"] = \
            device_ms(fn)
    out["kernels"] = rows
    for label, row in rows.items():
        print(f"{tag} {label:22s} ms {row['ms']} device_ms "
              f"{row['device_ms']} err {row['err']:.4g} same_bits "
              f"{row['same_bits']}")
    print(f"{tag} " + json.dumps({k: w for k, w in out.items()
                                  if k != "kernels"}))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true",
                    help="time the kernels of trees and variants")
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", help="write every reading to this JSON file")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k2_fault_check: no CUDA device visible", file=sys.stderr)
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
            # the wrapper's calls run this tree's library
            from repro_torch.kernels import build as kbuild
            kbuild._libs["flash_attention"] = libs["change"]
            result = {"times": [time_shape(torch, libs, *shape, args.rounds)
                                for shape in TIME_SHAPES]}
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
            f: f"{r['caught_in']}/{r['cases']}"
            for f, r in result["faults"].items() if f != "sound"}}))
    return 0 if result.get("ok", True) else 1


if __name__ == "__main__":
    sys.exit(main())
