"""Where the time of full-width serving goes on the card.

    python3 profile_serving.py [--arch ARCH] [--out DIR]

Serves chip_smoke.py's full-width trace (bf16, `Engine(ARCH).serving(
slots=4, prefill_chunk=256)`; ARCH internvl3-2b, as dense, by default,
or mamba2-370m or recurrentgemma-2b, which decode from a fresh state
cache) three times on one CUDA card: cold, warm with the port's host tracer on, and warm under
`torch.profiler`. Prints each run's wall time, tokens/s and TTFT; the
host-span totals by name; over the profiled run the device's busy share
(summed time of kernels and copies over wall time), device ops per
decode step and the device ops with the most time. Writes the
profiler's op tables to DIR/ops.txt (default build/profile_serving/).
Needs one NVIDIA GPU; exits 1 without one.
"""
import argparse
import collections
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internvl3-2b",
                    choices=("internvl3-2b", "mamba2-370m",
                             "recurrentgemma-2b"))
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "profile_serving"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from chip_smoke import card_line, full_width_trace
    from repro_torch.api import Engine
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.obs.trace import Tracer

    card = card_line()
    print(card)
    os.makedirs(args.out, exist_ok=True)
    eng = Engine(args.arch, seed=0)
    trace = full_width_trace(eng.cfg.vocab)
    srv = eng.serving(slots=4, prefill_chunk=256)

    def report(tag, rep):
        print(f"{tag}: wall_s={rep.wall_s} tokens_per_s={rep.tokens_per_s} "
              f"mean_ttft_s={rep.mean_ttft_s} max_ttft_s={rep.max_ttft_s} "
              f"decode_steps={rep.n_decode_steps} "
              f"prefill_chunks={rep.n_prefill_chunks} ({card})")

    report("cold", srv.run(trace))

    tracer = Tracer()
    report("warm+tracer", srv.run(trace, trace=tracer))
    spans = collections.defaultdict(lambda: [0, 0.0])
    for ev in tracer.to_json()["traceEvents"]:
        if ev.get("ph") == "X":
            spans[ev["name"]][0] += 1
            spans[ev["name"]][1] += ev["dur"] / 1e3
    for name, (n, ms) in sorted(spans.items(), key=lambda kv: -kv[1][1]):
        print(f"  host span {name}: n={n} total_ms={ms} ({card})")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    flash_attention.launches = 0
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        rep = srv.run(trace)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    report("warm+profiler", rep)

    kernels = collections.defaultdict(lambda: [0, 0.0])
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name][0] += 1
            kernels[ev.name][1] += ev.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in kernels.values())
    n_kernels = sum(n for n, _ in kernels.values())
    summary = {
        "card": card, "arch": args.arch, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_busy_share": busy_ms / wall_ms,
        "device_ops": n_kernels,
        "device_ops_per_decode_step": n_kernels / max(rep.n_decode_steps, 1),
        "flash_attention_launches": flash_attention.launches,
        "top_device_ops": [
            {"name": name[:90], "n": n, "ms": ms}
            for name, (n, ms) in sorted(kernels.items(),
                                        key=lambda kv: -kv[1][1])[:12]],
    }
    print(json.dumps(summary, indent=1))
    with open(os.path.join(args.out, "ops.txt"), "w") as f:
        f.write(prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=40))
        f.write("\n")
        f.write(prof.key_averages().table(
            sort_by="self_cpu_time_total", row_limit=40))
    return 0


if __name__ == "__main__":
    sys.exit(main())
