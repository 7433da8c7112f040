"""Repeats the CPU `torch.exp` fault of a process's first threaded exp.

    python3 exp_fault_check.py [--runs N] [--parallel P]
                               [--timeout SECONDS] [--variants NAME,...]
                               [--out FILE]

Each run is a fresh Python process on the CPU (JAX_PLATFORMS=cpu) that
sets up torch (and JAX, by variant) and then compares `torch.exp` on
200001 float32 values in [-30, 10] (numpy, seed 0) with numpy's float64
`exp`. A sound run reads a largest relative error near 6e-8 (float32
rounding); the fault reads about 1.5e-4 on the part of the elements
one or two of torch's threads computed. It was first seen in test
processes that also run JAX; the variants show JAX plays no part.
Variants, each in its own processes:

  baseline     JAX computes, then torch.exp (torch's default threads)
  jax_first    as baseline, JAX imported before torch
  import_only  JAX is imported but computes nothing
  no_jax       JAX is never imported
  threads1     torch.set_num_threads(1) before JAX computes
  torch_first  torch.exp runs once on the same input (starting torch's
               thread pool) before JAX computes
  small_first  as torch_first on 1000 elements (one thread)
  one_first    no JAX; one exp of a single element (one thread) first

At most `--runs` processes a variant, `--parallel` at a time (as a test
run's workers share the machine), each cut after `--timeout` seconds.
Prints one line a run and a JSON summary; exits 0 whatever the readings
(it reproduces a fault and is no test), 1 if a run fails to complete.
The fault shows only under load: in 7 of 240 and 10 of 240 fresh
processes without JAX at `--parallel 6` on an 8-core CPU, in none of 24
run one at a time, and in none of 240 after a one-element exp.
"""
import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

BAD = 1e-5      # a relative error this large is no float32 rounding

CHILD = r"""
import os, sys, json
variant = sys.argv[1]
import numpy as np
if variant == "jax_first":
    import jax
import torch
if variant == "threads1":
    torch.set_num_threads(1)
x = np.random.default_rng(0).uniform(-30, 10, 200001).astype(np.float32)
if variant == "torch_first":
    torch.exp(torch.from_numpy(x))
if variant == "small_first":
    torch.exp(torch.from_numpy(x[:1000]))
if variant == "one_first":
    torch.exp(torch.zeros(1))
if variant not in ("no_jax", "one_first"):
    import jax
    import jax.numpy as jnp
    if variant != "import_only":
        jnp.exp(jnp.linspace(-3.0, 3.0, 1024)).block_until_ready()
got = torch.exp(torch.from_numpy(x)).numpy().astype(np.float64)
want = np.exp(x.astype(np.float64))
rel = np.abs(got - want) / want
print(json.dumps({"max_rel": float(rel.max()),
                  "n_bad": int((rel > %r).sum()),
                  "threads": torch.get_num_threads()}))
""" % BAD

VARIANTS = ("baseline", "jax_first", "import_only", "no_jax", "threads1",
            "torch_first", "small_first", "one_first")


def run_one(variant: str, timeout: float) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", CHILD, variant], env=env,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise RuntimeError(f"{variant}: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=12)
    ap.add_argument("--parallel", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--out", help="write the readings to this JSON file")
    args = ap.parse_args()
    summary, failed = {}, False
    for variant in args.variants.split(","):
        rows = []
        with ThreadPoolExecutor(args.parallel) as pool:
            futures = [pool.submit(run_one, variant, args.timeout)
                       for _ in range(args.runs)]
            for i, fut in enumerate(futures):
                try:
                    row = fut.result()
                except (RuntimeError, subprocess.TimeoutExpired) as err:
                    print(f"{variant} run {i}: failed: {err}",
                          file=sys.stderr)
                    failed = True
                    continue
                rows.append(row)
                print(f"{variant} run {i}: max rel {row['max_rel']:.3g}, "
                      f"{row['n_bad']} elements above {BAD}", flush=True)
        bad = [r for r in rows if r["n_bad"]]
        summary[variant] = {
            "runs": len(rows), "bad_runs": len(bad),
            "max_rel": max((r["max_rel"] for r in rows), default=None),
            "bad_elements": [r["n_bad"] for r in bad]}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)
    print(json.dumps(summary))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
