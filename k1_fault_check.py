"""Holds the bf16 limits of K1's checks between sound and faulty kernels.

    python3 k1_fault_check.py [--out FILE]

For each planted fault below, copies `src/repro_torch` into a temporary
directory, edits one line of the copy's `flash_attention_packed.cu`,
builds it there on the card and runs K1 forward and backward against
the plain versions at internvl3-2b's heads (12 query, 2 KV, head_dim
128) over packed layouts of 1024 and 4096 tokens. For each of o, dq,
dk, dv it prints, per case, max|err| / max(1, |plain|) (`elementwise`,
the form `chip_smoke.py` holds to 2e-2 / 4e-2) and max|err| / max|plain|
(`whole`, held to 2e-2 in bf16). A limit is sound when every "sound"
reading lies below it and every fault reads above it on the tensor it
touches. The checkout itself is never edited. Needs one NVIDIA GPU and
nvcc; exits non-zero when a fault passes the whole-tensor limit.
"""
import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
CU = os.path.join("src", "repro_torch", "kernels", "csrc",
                  "flash_attention_packed.cu")
REL_TOL_BF16 = 2e-2     # as in chip_smoke.py

#: fault name -> (the tensors it must show in, [(text, replacement)])
FAULTS = {
    "sound": ((), []),
    "dq_drops_key_tile": (("dq",), [(
        "            if (row < Sq)\n              atomicAdd(dqb",
        "            if (row < Sq && k0 != 128)\n"
        "              atomicAdd(dqb")]),
    "bwd_skips_query_tile": (("dq", "dk", "dv"), [(
        "if (!tile_live<SPANS>(p, b, q0, q1, k0, k1)) continue;",
        "if (!tile_live<SPANS>(p, b, q0, q1, k0, k1) || q0 == 160) "
        "continue;")]),
    "dk_skips_query_tile": (("dk",), [(
        "          mma_bf16(dka[nd], as, bq);",
        "          if (q0 != 160) mma_bf16(dka[nd], as, bq);")]),
    "query_start_one_tile_late": (("dq", "dk", "dv"), [(
        "  i_lo = (i_lo / B_BQ) * B_BQ;\n",
        "  i_lo = (i_lo / B_BQ) * B_BQ + B_BQ;\n")]),
    "fwd_drops_key_tile": (("o",), [(
        "if (!tile_live<SPANS>(p, b, q0, q1, j0, min(j0 + F_BK, Sk))) "
        "continue;",
        "if (!tile_live<SPANS>(p, b, q0, q1, j0, min(j0 + F_BK, Sk)) || "
        "j0 == 128) continue;")]),
}


def cases():
    """(name, S, lens, frame, text, mode, window): the layouts of
    chip_smoke.py phase 7 plus a long and a single segment."""
    out = []
    for S, lens in ((1024, [400, 300, 250]),
                    (4096, [1500, 900, 1200, 400])):
        for frame in (None, 256):
            out.append((f"S{S}_spans{frame is not None}", S, lens, frame,
                        32, "causal", None))
    out.append(("full1024", 1024, [400, 300, 250], 128, 32, "full", None))
    out.append(("sliding1024", 1024, [400, 300, 250], 128, 32, "sliding",
                256))
    out.append(("S4096_long", 4096, [2600, 1200], 256, 32, "causal", None))
    out.append(("S4096_one", 4096, [3900], 256, 64, "causal", None))
    return out


def worker(fault: str) -> None:
    """Runs in the copy's directory: readings of every case."""
    import torch
    sys.path.insert(0, os.path.join(os.getcwd(), "src"))
    sys.path.insert(0, ROOT)
    from chip_smoke import packed_layout
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed, flash_attention_packed_bwd,
        flash_attention_packed_bwd_ref, flash_attention_packed_ref)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    H, HKV, D, bf16 = 12, 2, 128, torch.bfloat16
    for name, S, lens, frame, text, mode, window in cases():
        seg, span = packed_layout(S, lens, frame, text)
        q, do = (torch.randn(1, S, H, D, generator=gen, device=dev).to(bf16)
                 for _ in range(2))
        k, v = (torch.randn(1, S, HKV, D, generator=gen, device=dev)
                .to(bf16) for _ in range(2))
        segt = torch.as_tensor(seg, device=dev)
        kw = dict(mode=mode, window=window, span_ids=None if span is None
                  else torch.as_tensor(span, device=dev))
        o, lse = flash_attention_packed(q, k, v, segt, return_lse=True, **kw)
        got = (o,) + tuple(flash_attention_packed_bwd(q, k, v, o, lse, do,
                                                      segt, **kw))
        want = (flash_attention_packed_ref(q, k, v, segt, **kw)[0],) + \
            tuple(flash_attention_packed_bwd_ref(q, k, v, do, segt, **kw))
        row = {"case": name}
        for t, a, r in zip(("o", "dq", "dk", "dv"), got, want):
            r = r.float()
            d = (a.float() - r).abs()
            row[t] = {
                "elementwise": (d / r.abs().clamp_min(1.0)).max().item(),
                "whole": d.max().item() / r.abs().max().item()}
        print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="write every reading to this JSON file")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("k1_fault_check: no CUDA device visible", file=sys.stderr)
        return 1
    readings, ok = {}, True
    for fault, (shows, edits) in FAULTS.items():
        with tempfile.TemporaryDirectory() as tmp:
            shutil.copytree(os.path.join(ROOT, "src", "repro_torch"),
                            os.path.join(tmp, "src", "repro_torch"),
                            ignore=shutil.ignore_patterns("__pycache__"))
            path = os.path.join(tmp, CU)
            src = open(path).read()
            for text, new in edits:
                if text not in src:
                    raise SystemExit(f"{fault}: line to edit not found")
                src = src.replace(text, new, 1)
            with open(path, "w") as f:
                f.write(src)
            run = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--worker", fault], cwd=tmp,
                                 capture_output=True, text=True)
        if run.returncode != 0:
            print(run.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"{fault}: the run failed")
        rows = [json.loads(line) for line in run.stdout.splitlines()]
        readings[fault] = rows
        for t in ("o", "dq", "dk", "dv"):
            whole = [r[t]["whole"] for r in rows]
            elt = [r[t]["elementwise"] for r in rows]
            print(f"{fault:26s} {t:2s} whole {min(whole):.4f}-"
                  f"{max(whole):.4f}  elementwise {min(elt):.4f}-"
                  f"{max(elt):.4f}")
        if fault == "sound":
            ok &= all(r[t]["whole"] <= REL_TOL_BF16 for r in rows
                      for t in ("o", "dq", "dk", "dv"))
        else:
            ok &= all(max(r[t]["whole"] for t in shows) > REL_TOL_BF16
                      for r in rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(readings, f)
    print(json.dumps({"ok": ok, "rel_tol_bf16": REL_TOL_BF16}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
