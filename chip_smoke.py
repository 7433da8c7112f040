"""Chip smoke test of the PyTorch/CUDA port: builds the hand-written
kernels, holds each against its plain PyTorch version on the card, then
drives the port's main path — continuous-batching serving of
internvl3-2b at full width — and checks what comes out.

    python3 chip_smoke.py

Needs one NVIDIA GPU and the CUDA toolkit (nvcc); exits non-zero
without them, or when any phase fails. Imports nothing of JAX or of the
JAX package `repro`. Prints, second to last, one JSON line with each
kernel's launches on the main path, error, times and bound; and, last,
`{"ok": true, "device": {...}}`.

Phases:
  1. device   — card name and power limit (nvidia-smi)
  2. build    — nvcc of every kernel source, all at once
  3. kernels  — kernel vs plain version at the serving path's usual
                shapes and more, with times. Each output element must lie
                within tol * max(1, |plain|) of the plain version's (bf16
                tol 2e-2: the two round at different points, and a bf16
                step is up to 2^-7 of |o|; fp32 tol 1e-4: sums in a
                different order)
  4. parity   — reduced internvl3-2b, fp32, attn_impl="cuda": the
                ServingEngine's token streams equal greedy_generate's
  5. serving  — full-width internvl3-2b, bf16, through
                Engine(...).serving(slots=4, prefill_chunk=256).run(),
                traced: the (rows, bucket) shape of every co-batched
                prefill is read back from the runtime's spans
  6. path     — kernel vs plain version at each shape the serving run
                launched, with times; these feed the kernels line
"""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_FLOPS = {torch.bfloat16: 989e12,   # H100 SXM dense tensor-core bf16
              torch.float32: 67e12}     # H100 SXM fp32 (CUDA cores)
PEAK_BYTES = 3.35e12                    # H100 SXM HBM3
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls (CUDA
    events), after `warmup` calls. Inputs stay resident in L2 where
    they fit, as they are after the projections on the serving path."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(B, Sq, Sk, H, Hkv, D, dtype, mode, window, kv_offset):
    """Least time the card could take for the same work: each input read
    once and the output written once at HBM rate, vs 4*D flops per valid
    (query, key) pair per head at the peak rate for the input type."""
    from repro_torch.kernels.flash_attention import _valid_mask
    pairs = int(_valid_mask(Sq, Sk, mode, window, kv_offset,
                            "cpu").sum())
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * D * (2 * B * Sq * H + 2 * B * Sk * Hkv)
    flops = 4.0 * D * pairs * B * H
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def library_ms(q, k, v, mode):
    """One PyTorch call computing the same function (a yardstick only;
    the port never calls it): SDPA in [B, H, S, D] layout."""
    import torch.nn.functional as F
    if mode not in ("causal", "full"):
        return None
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def call():
        return F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=(mode == "causal"), enable_gqa=True)
    return cuda_ms(call)


H, HKV, D = 12, 2, 128     # internvl3-2b's attention heads


def check_kernel(dev, card, gen, B, S, dtype, mode="causal", window=None,
                 off=0):
    """Hold the kernel against its plain version on one random input at
    [B, S, H, D] / [B, S, HKV, D]; time both and the library call."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref)
    q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, S, HKV, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, S, HKV, D, generator=gen, device=dev).to(dtype)
    kw = dict(mode=mode, window=window, kv_offset=off)
    out = flash_attention(q, k, v, **kw).float()
    ref = flash_attention_ref(q, k, v, **kw).float()
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    err = diff.max().item()
    scaled = (diff / ref.abs().clamp_min(1.0)).max().item()
    if not (math.isfinite(scaled) and scaled <= TOL[dtype]):
        raise AssertionError(
            f"kernel disagrees with its plain version: B={B} S={S} "
            f"{dtype} {mode} kv_offset={off}: max|err|/max(1,|ref|) "
            f"{scaled} > {TOL[dtype]} (max|err| {err})")
    ms = cuda_ms(lambda: flash_attention(q, k, v, **kw))
    plain = cuda_ms(lambda: flash_attention_ref(q, k, v, **kw),
                    iters=5, warmup=1)
    lib = library_ms(q, k, v, mode) if off == 0 else None
    bound, bound_by = attention_bound(B, S, S, H, HKV, D, dtype, mode,
                                      window, off)
    row = dict(B=B, S=S, H=H, Hkv=HKV, D=D,
               dtype=str(dtype).split(".")[-1], mode=mode, window=window,
               kv_offset=off, max_abs_err=err, max_scaled_err=scaled,
               tol=TOL[dtype], ms=ms, plain_ms=plain, library_ms=lib,
               bound_ms=bound, bound_by=bound_by)
    print(f"  kernel {json.dumps(row)} ({card})")
    return row


def phase_kernels(dev, card):
    gen = torch.Generator(device=dev).manual_seed(0)
    bf16, fp32 = torch.bfloat16, torch.float32
    # the serving path's usual one-shot prefill shapes: rows x pow2 bucket
    cases = [(B, S, bf16) for B in (1, 4) for S in (64, 256)]
    cases += [(4, 2048, bf16), (2, 256, fp32),
              (2, 256, bf16, "full"), (2, 256, fp32, "full"),
              (2, 512, bf16, "sliding", 128),
              (2, 256, bf16, "causal", None, 96),
              (2, 256, fp32, "causal", None, -64)]
    return [check_kernel(dev, card, gen, *c) for c in cases]


def phase_path(dev, card, shapes, n_layers):
    """The kernel vs its plain version at every (rows, bucket) shape the
    serving run launched it with (bf16, causal, as on the path)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    out = []
    for (rows, bucket), n_batches in sorted(shapes.items()):
        row = check_kernel(dev, card, gen, rows, bucket, torch.bfloat16)
        row["launches"] = n_batches * n_layers
        out.append(row)
    return out


def phase_parity(dev):
    """Reduced internvl3-2b in fp32: ServingEngine streams vs the port's
    own one-shot greedy_generate, token for token (kernel in both)."""
    from repro_torch.api import Engine
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.model import prefill
    from repro_torch.serving.scheduler import ServeRequest
    from repro_torch.serving.serve_step import greedy_generate

    cfg = get_config("internvl3-2b").reduced().with_(attn_impl="cuda")
    eng = Engine(cfg, seed=0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, eng.cfg.vocab, size=L, dtype=np.int32)
               for L in (21, 5, 1)]
    n_new = 4

    def reference(prompt):
        toks = torch.as_tensor(prompt, device=dev)[None].long()
        logits, cache = prefill(eng.state.params, eng.cfg,
                                {"tokens": toks},
                                cache_len=len(prompt) + n_new + 1)
        first = torch.argmax(logits[:, 0], dim=-1)
        out, _ = greedy_generate(eng.state.params, eng.cfg, cache, first,
                                 n_new - 1)
        return [int(first[0])] + [int(t) for t in out[0].cpu()]

    before = flash_attention.launches
    for chunk in (8, 64):
        trace = [ServeRequest(request_id=i, tokens=p, max_new_tokens=n_new)
                 for i, p in enumerate(prompts)]
        rep = eng.serving(slots=2, prefill_chunk=chunk).run(trace)
        for m in rep.requests:
            want = reference(prompts[m.request_id])
            if m.tokens != want:
                raise AssertionError(
                    f"chunk {chunk} request {m.request_id}: serving "
                    f"stream {m.tokens} != greedy_generate {want}")
        print(f"  parity chunk={chunk}: "
              f"{[m.tokens for m in rep.requests]} == greedy_generate")
    if flash_attention.launches == before:
        raise AssertionError("reduced serving never launched the kernel")


def full_width_trace(vocab: int, seed: int = 0):
    """Five span-free prompts of 40-250 tokens (one-shot prefill through
    the kernel), prompts of 600 and 1500 tokens (chunked) and a 512-token
    prompt with two 128-token bidirectional spans; 32 new tokens each."""
    from repro_torch.core.cost_model import ModalitySpan
    from repro_torch.serving.scheduler import ServeRequest
    rng = np.random.default_rng(seed)
    lens = [int(n) for n in rng.integers(40, 251, size=5)] + [600, 1500]
    reqs = [ServeRequest(request_id=i,
                         tokens=rng.integers(0, vocab, size=L,
                                             dtype=np.int32),
                         max_new_tokens=32)
            for i, L in enumerate(lens)]
    spans = (ModalitySpan("text", 0, 64),
             ModalitySpan("vision", 64, 128, "bidirectional"),
             ModalitySpan("text", 192, 64),
             ModalitySpan("vision", 256, 128, "bidirectional"),
             ModalitySpan("text", 384, 128))
    reqs.append(ServeRequest(request_id=len(reqs),
                             tokens=rng.integers(0, vocab, size=512,
                                                 dtype=np.int32),
                             max_new_tokens=32, spans=spans))
    return reqs


def phase_serving(dev, card):
    """Returns the kernel's launches in the run and the number of
    co-batched prefills at each (rows, bucket) shape."""
    from repro_torch.api import Engine
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.model import prefill
    from repro_torch.obs.trace import Tracer

    t0 = time.perf_counter()
    eng = Engine("internvl3-2b", seed=0)
    params = eng.state.params
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  internvl3-2b as {eng.cfg.family}: {eng.cfg.n_layers} layers "
          f"d_model {eng.cfg.d_model}, {n_params / 1e9:.3f} B params "
          f"{eng.cfg.param_dtype}, init {time.perf_counter() - t0:.1f} s")
    trace = full_width_trace(eng.cfg.vocab)
    srv = eng.serving(slots=4, prefill_chunk=256)

    tracer = Tracer()
    torch.cuda.reset_peak_memory_stats(dev)
    flash_attention.launches = 0
    rep = srv.run(trace, trace=tracer)
    torch.cuda.synchronize()
    launches = flash_attention.launches
    peak = torch.cuda.max_memory_allocated(dev)

    shapes = {}
    for ev in tracer.to_json()["traceEvents"]:
        if ev["name"] == "prefill_batch":
            key = (ev["args"]["rows"], ev["args"]["bucket"])
            shapes[key] = shapes.get(key, 0) + 1
    if tracer.dropped:
        raise AssertionError(f"the tracer dropped {tracer.dropped} events")
    if launches != eng.cfg.n_layers * sum(shapes.values()):
        raise AssertionError(
            f"{launches} kernel launches, but {sum(shapes.values())} "
            f"co-batched prefills of {eng.cfg.n_layers} layers")

    by_id = {m.request_id: m for m in rep.requests}
    for r in trace:
        m = by_id.get(r.request_id)
        if m is None or m.n_generated != r.max_new_tokens:
            raise AssertionError(f"request {r.request_id} did not finish "
                                 f"with {r.max_new_tokens} tokens")
        if not all(0 <= t < eng.cfg.vocab for t in m.tokens):
            raise AssertionError(f"request {r.request_id}: token out of "
                                 f"vocab: {m.tokens}")
    if launches <= 0:
        raise AssertionError("the serving run never launched the kernel")
    logits, _ = prefill(params, eng.cfg,
                        {"tokens": torch.as_tensor(trace[0].tokens,
                                                   device=dev)[None]})
    if not torch.isfinite(logits).all():
        raise AssertionError("full-width prefill logits are not finite")
    stats = dict(requests=len(rep.requests), tokens=rep.total_tokens,
                 tokens_per_s=rep.tokens_per_s, mean_ttft_s=rep.mean_ttft_s,
                 max_ttft_s=rep.max_ttft_s, wall_s=rep.wall_s,
                 decode_steps=rep.n_decode_steps,
                 prefill_chunks=rep.n_prefill_chunks,
                 schedule_ms=rep.schedule_ms, cache_len=rep.cache_len,
                 max_memory_allocated_bytes=peak,
                 flash_attention_launches=launches,
                 prefill_batch_shapes={f"{r}x{b}": n for (r, b), n
                                       in sorted(shapes.items())})
    for key, val in stats.items():
        print(f"  serving {key} = {val} ({card})")
    return launches, shapes, eng.cfg.n_layers


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 parity phases
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1/6] device: {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(card)

    t0 = time.perf_counter()
    build.build_all()
    print(f"[2/6] build: {time.perf_counter() - t0:.1f} s for "
          f"{build.sources()}")
    for src, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    print("[3/6] kernels vs plain versions")
    rows = phase_kernels(dev, card)
    print("[4/6] parity at reduced size (fp32)")
    phase_parity(dev)
    print("[5/6] full-width serving (bf16)")
    launches, shapes, n_layers = phase_serving(dev, card)
    print("[6/6] kernels vs plain versions at the serving run's shapes")
    path = phase_path(dev, card, shapes, n_layers)

    # the shape launched most often stands for the kernel; every shape
    # the run launched is listed with its own numbers
    main_row = max(path, key=lambda r: (r["launches"], r["B"] * r["S"]))
    usual = [r for r in rows if r["dtype"] == "bfloat16"
             and r["mode"] == "causal" and r["kv_offset"] == 0
             and r["S"] <= 256]
    keys = ("launches", "max_abs_err", "max_scaled_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:295",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in path + usual),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": f"B={main_row['B']} S={main_row['S']} H={H} Hkv={HKV} "
                 f"D={D} bf16 causal",
        "path_shapes": [dict(rows=r["B"], bucket=r["S"],
                             **{k: r[k] for k in keys}) for r in path],
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
