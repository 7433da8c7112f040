"""Chip smoke test of the PyTorch/CUDA port: builds the hand-written
kernels, holds each against its plain PyTorch version on the card, then
drives the port's main paths — continuous-batching serving and DHP
training of internvl3-2b, DHP training of mamba2-370m and of
recurrentgemma-2b, at full width, internvl3-2b's groups of degree > 1
as rings on the one card, the serving of mamba2-370m and
recurrentgemma-2b at full width, the exact-length prefill of
sliding-window caches, the MoE family (granite-moe-1b-a400m's DHP
training, granite-moe-1b-a400m's and olmoe-1b-7b's serving, at full
width), and the remaining dense and VLM configs (pixtral-12b's and
qwen3vl-8b's DHP training at full width, depth cut, and their serving
whole; chatglm3-6b, glm4-9b, minitron-4b and llama3-405b, 2 layers,
through Engine.serve; pixtral-12b's forward with patch embeddings), and
the audio family (whisper-small's serving, forward and training through
make_train_step, whole, and a checkpoint resume) — and checks what comes
out.

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
                different order). Times by CUDA events around 20 calls
                (`ms`, the host's cost included where it is the larger)
                and by the kernels' own time (`device_ms`,
                torch.profiler), for K2 and for SDPA; each bf16 call's
                launch (grid, threads, shared memory) beside the SMs
  4. parity   — reduced internvl3-2b, fp32, attn_impl="cuda": the
                ServingEngine's token streams equal greedy_generate's
  5. serving  — full-width internvl3-2b, bf16, through
                Engine(...).serving(slots=4, prefill_chunk=256).run(),
                traced: the (rows, bucket) shape of every co-batched
                prefill is read back from the runtime's spans
  6. path     — kernel vs plain version at each shape the serving run
                launched, with times and launches as phase 3; these feed
                the kernels line
  7. packed   — the packed kernel K1, forward and backward, vs its plain
                versions (the plain forward and its autograd gradient):
                bf16 and fp32, with and without span tables, causal,
                full and sliding, a ring hop (kv tables + kv_offset), at
                internvl3-2b's heads and S in {1024, 4096}, with times.
                o within tol * max(1, |plain|) as above; dq/dk/dv within
                grad tol * max(1, |plain|) (bf16 4e-2: P and dS are
                rounded to bf16 before their products and delta is
                formed from the bf16 output; fp32 1e-4). In bf16 each of
                o, dq, dk, dv is also held as a whole: its largest error
                within 2e-2 of its largest plain value (most gradient
                elements are far below 1, so the elementwise limit alone
                is about as large as a typical gradient). Prints the
                bf16 D=128 forward's and backward's design facts at one
                4096-token row: each one's stage, and the grid, threads
                and shared memory of the launch that ran, with the query
                heads a forward block takes and the backward's fp32
                scratch (the heads' dK / dV)
  8. train parity — reduced internvl3-2b, fp32: two DHP training steps
                with the kernels (attn_impl="cuda") vs the same steps
                through the plain full-matrix attention: losses, the
                first batch's gradient and the gradient at the
                parameters the two steps reach within 1e-4 (the
                parameters are printed: AdamW normalises each gradient
                element, so one as small as the paths' difference can
                turn its step around)
  9. training — full-width internvl3-2b, bf16, through
                Engine(..., ClusterSpec.auto(mem_budget=4096)).train(
                steps=3, dataset="openvid", global_batch=8,
                max_tokens=4096, tokens_per_frame=256, trace=True): per
                step loss, time, tokens/s, padding efficiency, degrees;
                peak memory; K1 launches == layers x groups each way; the
                (bucket, spans) of every group read back from the
                executor's spans; one more step under torch.profiler for
                the device busy share and the device time by kernel
 10. train path — K1 forward and backward vs plain at each (bucket,
                spans) shape the training run launched, on that run's own
                tables, with times and bounds; these feed the kernels line
 11. ssd        — the SSD chunk kernel K3, forward and backward, vs its
                plain versions (the plain forward and its autograd
                gradient): mamba2-370m's full-width cell (c=256, N=128,
                P=64, 32 heads) over a 4096-token row, its reduced cell
                (c=32, N=16, P=32) and a ragged cell count, fp32 and bf16
                inputs, with the model's dt (the sum of dt over a
                256-token chunk is about 200, where exp above the
                diagonal overflows), against the plain versions run in
                fp64: every output and gradient finite; y, states, cum
                within 1e-4 * max(1, |plain|) (fp32 arithmetic whatever
                the input type); the gradients within 1e-3 * max(1,
                |plain|) and, as whole tensors, 1e-4 * max|plain|; dC,
                dB, dx returned in bf16 within 1e-2 both ways (one bf16
                rounding of nearly the same value). Prints each
                forward's and backward's launch (the kernel that took
                the heads, its grid, threads, shared memory, heads a
                block and scratch) beside the card's SMs, and times
                forward and backward by events (`fwd_ms`, `bwd_ms`) and
                by the kernels' own time (`fwd_device_ms`,
                `bwd_device_ms`) beside the bounds (also with the
                products each runs on the tensor cores at the TF32 peak,
                `bound_tc_fwd_ms`, `bound_tc_bwd_ms`)
 12. ssm parity — reduced mamba2-370m, fp32: two DHP training steps with
                K3 (attn_impl="cuda") vs the same steps through its plain
                version: losses, the first batch's gradient and the
                gradient at the parameters the two steps reach within 1e-4
 13. ssm train  — full-width mamba2-370m, bf16, through
                Engine("mamba2-370m", ClusterSpec.auto(mem_budget=4096))
                .train(steps=3, dataset="openvid", global_batch=8,
                max_tokens=4096, tokens_per_frame=256, trace=True): per
                step loss, time, tokens/s, padding efficiency, degrees;
                peak memory; the (n_seqs, bucket) of every group; K3
                backward launches == layers x groups and forward twice
                that (each layer is run again in the backward: remat);
                losses and parameters finite; one more step under
                torch.profiler for the busy share and the device time by
                kernel (K3's forward, its backward and the C B^T kernel
                both share apart, each with its launches) and of the
                inter-chunk scan
 14. ssd path   — K3 forward and backward vs plain at each (n_seqs,
                bucket) shape the SSM run launched, with launches, times
                and bounds as phase 11 and the inter-chunk scan's time;
                these feed the kernels line
 15. rglru      — the RG-LRU scan kernel K4, forward and backward, vs its
                plain versions (sequential loops over time, run in fp64):
                one 4096-token row at recurrentgemma-2b's width (2560)
                and a ragged shape, fp32 and bf16, a in (0.3, 0.999) as
                the gates make it; h, da, db within 1e-5 * max(1,
                |plain|) in fp32, 2e-2 in bf16; with times (events and
                each direction's device time from torch.profiler) and
                bounds
 16. packed 256 — K1 in bf16 at recurrentgemma-2b's heads (10 query heads
                over one KV head, D = 256), sliding at window 2048 over a
                4096-token row with and without 256-token frames, and a
                span longer than its window; phase 7's limits. Prints the
                bf16 D=256 forward's and backward's launches at the row
                with frames: grid, threads, shared memory (and the
                backward's fp32 scratch), with the card's SMs
 17. hybrid parity — reduced recurrentgemma-2b, fp32: two DHP training
                steps with K4 and K1 vs the same steps through their
                plain versions, limits as phase 8
 18. hybrid train — full-width recurrentgemma-2b, bf16, through
                Engine("recurrentgemma-2b", ClusterSpec.auto(
                mem_budget=4096)).train(steps=3, dataset="openvid",
                global_batch=8, max_tokens=4096, tokens_per_frame=256,
                trace=True), padded (the recurrence crosses segment
                boundaries): per step loss, time, tokens/s, padding
                efficiency; peak memory; the (n_seqs, bucket, spans) of
                every group; K4 and K1 launches equal to the count from
                the run's own groups (remat: each unit's layers run
                forward twice, the tail's once); losses and parameters
                finite; each step's groups (n_seqs, bucket) with each
                group's time, its peak memory, the caching allocator's
                retries and the time in Python's garbage collector
                during it; one more step under torch.profiler for the
                busy share and the device time by kernel (K4 forward
                and backward apart, K1 forward, backward and its group
                sum apart)
 19. hybrid path — K4 (fp32) and K1 (bf16, D = 256) forward and backward
                vs plain at every shape the hybrid run launched, K1 on
                the run's own span tables, with times (K4's device
                times too) and bounds; these feed the kernels line
 20. ring       — ring context parallelism (parallel/ring_attention.py),
                bf16: ring_attention in a LocalRing on the card (K1 a
                hop, at most two launches a hop), forward (o, lse) and
                backward, on phase 9's full-width 4096-token openvid
                layout (segments and spans; the bucket rounded up to a
                multiple of d) at internvl3-2b's heads (12:2, D = 128,
                causal) for d = 2, 3, 4 and recurrentgemma-2b's (10:1,
                D = 256, sliding 2048) for d = 2, 3, held with phase 7's
                limits against K1 unsharded on the same inputs and
                against the same ring on the plain versions (CPU
                tensors); one hop's K1 backward under the merged o and
                lse against the plain backward; the ring's forward +
                backward ms beside K1 unsharded's. Then full-width
                internvl3-2b, bf16, through Engine("internvl3-2b",
                ClusterSpec(devices=[cuda:0] * 6, mem_budget=1408)): the
                stream's first batch's DHP plan (rings of degree 2, 3, 4,
                6) against its static plan at degree 1 (run twice: the
                spread of degree 1), loss within RING_LOSS_RTOL; then
                3 steps of .train(dataset="openvid", global_batch=8,
                max_tokens=4096, tokens_per_frame=256): per step loss,
                time, tokens/s, degrees, peak memory, K1 launches ==
                layers x the groups' hop launches each way; losses and
                parameters finite. The ranks share one card: the ring's
                shifts are device copies, no NCCL and no link is run

 21. state parity — reduced mamba2-370m and recurrentgemma-2b, fp32,
                attn_impl="cuda": the ServingEngine's streams (slots=2,
                four requests, so that a slot is reused) equal
                greedy_generate's from a fresh cache and each prompt's
                last token (the JAX runtime never feeds a state-cache
                family's prompt into its state); 80 decode_step logits,
                past the hybrid's window of 64, against forward through
                the kernels (K3; K4 and K1) within DECODE_TOL x max(1,
                |forward|). Then reduced internvl3-2b as dense with a
                sliding window of 16: streams equal the exact-length
                prefill plus greedy_generate; K2's launches on that path
                (layers x prompts of more than one token), and K2 vs
                plain at each exact length it ran, with times; these
                feed the kernels line (`exact_prefill_launches`)
 22. state serving — full-width mamba2-370m, then recurrentgemma-2b,
                bf16, after the earlier phases' memory is released:
                full_width_trace through Engine(arch).serving(slots=4)
                .run(): every request finishes with 32 in-vocab tokens;
                tokens/s, mean and max TTFT, wall, decode steps, peak
                memory, the slot cache's bytes and the kernels' launches
                in the run (none: decode is torch ops);
                Engine(arch).serve(batch=4, prompt_len=96,
                gen_tokens=32)'s ms a token; the largest relative error
                of 64 decode logits against forward, printed and not
                held (bf16), both finite
 23. moe parity — reduced granite-moe-1b-a400m, fp32, attn_impl="cuda":
                the ServingEngine's streams (slots=2, a slot reused)
                equal the exact-length prefill + greedy_generate's (the
                reference prefills MoE whole: capacity routing depends on
                the routed set), K2's launches on that path == layers x
                prompts of more than one token; then phase 8's two
                training steps through K1 vs the plain attention
 24. moe train  — full-width granite-moe-1b-a400m (24 layers, 32 experts
                of 512, top-8, 16:8 heads of 64), bf16, through
                Engine(..., ClusterSpec.auto(mem_budget=4096)).train(
                steps=3, dataset="openvid", global_batch=8,
                max_tokens=4096, tokens_per_frame=256, trace=True),
                packed, no remat: per step loss, time, tokens/s; peak
                memory; K1 launches at D=64 == layers x groups each way;
                losses and parameters finite; one more step under
                torch.profiler (busy share, K1, the dispatch's sort,
                search, gather and scatter kernels, the GEMMs); one MoE
                layer at the run's largest bucket, forward and backward,
                against its expert GEMMs alone (events and device time)
 25. moe serving — full-width granite-moe-1b-a400m, then olmoe-1b-7b (16
                layers, 64 experts of 1024, 16:16 heads of 128), bf16:
                init's peak above the weights; full_width_trace through
                Engine(arch, ClusterSpec.auto(mem_budget=4096)).serving(
                slots=4).run() (a prompt prefills whole on one rank, so
                the budget holds the longest, 1500 tokens), traced: every
                request finishes with 32 in-vocab tokens, each prompt
                prefilled once at its exact length (no chunk, no
                co-batch), K2 launches == layers x prompts; tokens/s,
                TTFT, wall, peak memory; one slot decode step's device
                ops and times; Engine.serve(batch=4, prompt_len=96,
                gen_tokens=32)'s ms a token
 26. moe kernels — K1 (bf16, 16:8 heads of 64) forward and backward vs
                plain with phase 7's limits on a synthetic 4096-token
                row with frames and at every (bucket, spans) shape of
                phase 24's run; K2 (bf16, causal, B = 1) vs plain at each
                exact length phase 25 prefilled, at each arch's heads;
                with times, bounds and SDPA; these feed the kernels line
                (`flash_attention_packed_d64*`; K2's
                `moe_exact_prefill_*`)
 27. dense kernels — K1 (bf16) forward and backward on one 4096-token
                row, causal, with and without 256-token frames, and K2
                (bf16, causal) at 4x2048 and at exact lengths 1x96-1x1500,
                vs plain with phase 7's and phase 3's limits, at each new
                head grouping: 32:2, 24:8, 32:8, 128:8 at D = 128 and
                32:8 at D = 160 (128 query heads run the plain versions a
                KV head at a time); ms, device_ms, plain, SDPA, bound and
                each launch beside the SMs (`dense_rows_4096`,
                `dense_shapes`)
 28. dense parity — phase 8 for reduced chatglm3-6b (2D RoPE) and for
                reduced pixtral-12b at head_dim 160 over 4:2 heads (K1's
                fp32 kernels at D = 160)
 29-30. dense train — phase 9 for pixtral-12b (7 of 40 layers: 32:8
                heads of 160, K1 at D = 160) and qwen3vl-8b (10 of 36
                layers: 32:8 heads of 128) at full width, bf16, the card
                emptied between; parameters finite after 3 steps
 31. train path — phase 10 for the pixtral-12b run: K1 at D = 160 vs
                plain at each (bucket, spans) shape it launched; these
                feed `flash_attention_packed_d160*`
 32. dense serving — phases 5 and 6 for pixtral-12b (40 layers, K2 at
                D = 160) and qwen3vl-8b (36 layers) whole, bf16
                (`flash_attention_d160`; K2's `qwen3vl_*`)
 33. short serves — Engine(arch).serve(batch=2, prompt_len=96,
                gen_tokens=8) at full width for chatglm3-6b, glm4-9b,
                minitron-4b (whole) and llama3-405b (2 of 126 layers):
                in-vocab tokens, K2 once a layer, finite prefill logits,
                init, prefill and decode times, peak memory
 34. vlm forward — pixtral-12b at full width and 2 layers through
                `forward` with synthetic_batch's patch embeddings, against
                the same weights in fp32 (plain attention): finite logits
                through K2 at D = 160, elementwise at most 1.25 times as
                far from fp32 as the plain attention path's bf16 logits,
                three faults of the D = 160 layout planted around K2
                farther; the patches reach the logits
 35. audio kernels — K2 in full mode (fp32 and bf16) vs plain with phase
                3's limits at whisper-small's 12:12 heads of 64 over 1500
                keys: the encoder at 1x1500, 2x1500 and 4x1500, the
                cross-attention at 1, 96 and 448 queries and 2 x 448; K2
                causal at 2x448 in bf16 (the decoder); ms, device_ms,
                plain, SDPA, bound and each launch
                (`flash_attention_full_d64`, `_bf16`)
 36. audio parity — reduced whisper-small (fp32, kernels on): serving
                streams (slots=2, a slot reused) vs greedy_generate from
                init_cache + prefill_cross_kv and the last prompt token,
                K2 once an encoder layer a request; 12 decode_step logits
                vs forward through K2 (2e-3)
 37. audio serving — whisper-small whole at full width, bf16:
                full_width_trace through Engine.serving(slots=4).run(),
                traced: 32 in-vocab tokens a request, no prefill, one
                encoder pass an admission (K2's fp32 kernel once an
                encoder layer, no other kernel); tokens/s, TTFT, wall,
                peak memory, the slot cache's bytes, an encoder pass's
                time, one slot decode step's device ops, finite logits;
                Engine.serve(batch=4, prompt_len=96, gen_tokens=32)'s ms
                a token, K2's fp32 kernel once an encoder layer
 38. audio forward — whisper-small whole, `forward` with synthetic_batch
                (2 x 448 tokens, 1500 frames), frames in fp32 and then
                bf16: K2's launches counted by kernel and mode (24 full
                of the frames' dtype's kernel, 12 causal bf16), every
                shape launched one that phase 35 held; elementwise at
                most 1.25 times as far from the same weights in fp32 as
                the plain attention path; two faults planted around the
                fp32 kernel (the last key tile dropped, the scale at
                D = 128) farther; other frames move the logits
 39. audio train kernels — K1 forward and backward vs plain with phase
                7's limits at whisper-small's training shapes, 12:12 heads
                of 64, 1 and 8 rows: fp32 full 1500 x 1500 (the encoder),
                fp32 full 448 over 1500 with the frames' own segment
                table (the cross-attention, Sq != Sk), bf16 causal 448
                (the decoder); ms, device_ms, plain, SDPA (forward, and
                backward through autograd), bound (fp32's split-TF32
                bound beside), each launch; fp32's split-TF32 backward
                also its dQ kernel's launch, each kernel's device time,
                SDPA's backward on the device clock and dQ's own bound
 40. audio train parity — reduced whisper-small, fp32, one set of
                weights: loss and every gradient leaf through the kernels
                vs the plain attention within 1e-4; one make_train_step
                each (loss, grad_norm); K1's launches by kernel and mode
                (fp32's backward: its dK / dV and its dQ kernel)
 41. audio training — whisper-small whole at full width, bf16 parameters,
                fp32 frames: make_train_step, 3 steps on 8 x 448 tokens
                over 1500 frames and a profiled fourth: loss finite and
                falling, step time, tokens/s (frames beside), peak
                memory, busy share, K1's launches by kernel and mode (2 x
                12 fp32 full and 12 bf16 causal a step, each way, fp32's
                backward as its two kernels; no K2)
                and by shape, each shape one phase 39 held; then at 2 + 2
                layers on 2 rows the gradient through the kernels at
                most 1.25 times as far (per leaf, max|err| / max|fp32|)
                from the same weights in fp32 as the plain attention
                path's, a planted fault (the last partial key tile left
                out of K1) beyond that
 42. audio resume — whisper-small at 2 + 2 layers, bf16, 2 rows: 2 steps,
                checkpoint.save, restore (bit for bit what was saved), 2
                more, against 2 more from the state saved: losses within
                2e-4 relative and at most 2% of the parameters differing
                at all (the bf16 decoder's dQ atomics); two faults planted in copies of
                the restored state (moments zeroed, step counter reset)
                beyond the share, the first beyond the loss limit too;
                the file's bytes and the ms to save and to restore. Then
                the run's wall
Phases 27-38 run in a process of their own (`--late-phases`), and
phases 39-42 in another (`--audio-train-phases`), each started by the
first on the same card after it has released its memory: after some
400 profiler sessions in one process torch.profiler drops kernels'
events and then traces none, so their device times are read from a
fresh one.

Each full-width training phase (9, 13, 18, 24) first collects what the
earlier phases left in reference cycles (the profiler's event trees
among it) and prints what that took: left to the garbage collector, its
full pass over that heap lands inside one of the run's timed steps.
"""
import dataclasses
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
PEAK_TF32 = 495e12                      # H100 SXM dense tensor-core TF32
#: fp32 as split TF32 on the tensor cores: each product formed three
#: times (hi hi', hi lo', lo hi') at PEAK_TF32
SPLIT_TF32 = PEAK_TF32 / 3
SPLIT_TF32_AT = "split TF32: 3 TF32 products at 495 TFLOP/s"
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


def device_ms(fn, iters: int = 20, warmup: int = 3, each_once=False):
    """(device time per call, kernels traced per call) of `fn` over
    `iters` back-to-back calls after `warmup`: the summed durations of
    the kernels the calls launched, as torch.profiler traces them on the
    card. Beside `cuda_ms` (the time between two events around the
    calls, the host's enqueue included where it is the slower), it
    splits a call's time into the host's and the device's. A session
    that traces no kernel at all (seen some 50 and some 400 sessions into
    a process) is run again, up to three times; after three the device
    time is not measured: (None, None), said so on a line of its own.

    `each_once`: every call launches each of its kernels once, on the
    same inputs, so a call's device time is the sum over kernel names of
    each kernel's mean traced duration. That reading stands where the
    profiler drops some launches' events (seen in this script's process
    after many sessions: 1 to 8 of 10 launches traced); the kernels
    traced per call say how many it saw."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
        if not evs:
            continue
        if each_once:
            by_name = {}
            for ev in evs:
                by_name.setdefault(ev.name, []).append(
                    ev.time_range.elapsed_us())
            ms = sum(sum(d) / len(d) for d in by_name.values()) / 1e3
        else:
            ms = sum(ev.time_range.elapsed_us() for ev in evs) / 1e3 / iters
        return ms, len(evs) / iters
    print("  device_ms: torch.profiler traced no device time in three "
          "sessions; device time not measured (null)")
    return None, None


def device_ms_by_kernel(fn, iters: int = 5, warmup: int = 1) -> dict:
    """Device time per call of each kernel `fn` launches, by name (its
    first 60 characters), from one torch.profiler session over `iters`
    calls after `warmup`; {} when the profiler traced no device time."""
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
            name = ev.name[:60]
            out[name] = out.get(name, 0.0) + \
                ev.time_range.elapsed_us() / 1e3 / iters
    return out


def roofline(nbytes, flops, rate):
    """(ms, "bytes" or "operations"): the larger of `nbytes` at HBM rate
    and `flops` at `rate` (flop/s)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attention_bound(B, Sq, Sk, H, Hkv, D, dtype, mode, window, kv_offset,
                    rate=None):
    """Least time the card could take for the same work: each input read
    once and the output written once at HBM rate, vs 4*D flops per valid
    (query, key) pair per head at `rate`, the peak rate for the input
    type by default: (ms, "bytes" or "operations"). K2's fp32 kernel
    does its products in split TF32 (rate=SPLIT_TF32)."""
    from repro_torch.kernels.flash_attention import _valid_mask
    pairs = int(_valid_mask(Sq, Sk, mode, window, kv_offset,
                            "cpu").sum())
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * D * (2 * B * Sq * H + 2 * B * Sk * Hkv)
    return roofline(nbytes, 4.0 * D * pairs * B * H,
                    rate or PEAK_FLOPS[dtype])


def library_ms(q, k, v, mode, window=None):
    """(events ms, device ms) of one PyTorch call computing the same
    function (a yardstick only; the port never calls it): SDPA in [B, H,
    S, D] layout, `is_causal` for the causal mode and a boolean mask
    (built outside the timing) for the sliding one."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import _valid_mask
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    mask = (_valid_mask(q.shape[1], k.shape[1], mode, window, 0, q.device)
            if mode == "sliding" else None)

    def call():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=(mode == "causal"),
            enable_gqa=True)
    return cuda_ms(call), device_ms(call)[0]


H, HKV, D = 12, 2, 128     # internvl3-2b's attention heads


def check_kernel(dev, card, gen, B, S, dtype, mode="causal", window=None,
                 off=0, heads=(H, HKV, D), Sk=None):
    """Hold the kernel against its plain version on one random input at
    [B, S, H, D] / [B, Sk, HKV, D] (`heads` = (H, HKV, D), internvl3-2b's
    by default; Sk = S unless given); time both and the library call,
    the kernel and the library call also by device time
    (torch.profiler), and print the kernel's launch beside the card's
    SMs."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_ref,
                                                     last_launch)
    H, HKV, D = heads
    Sk = Sk or S
    q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Sk, HKV, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Sk, HKV, D, generator=gen, device=dev).to(dtype)
    kw = dict(mode=mode, window=window, kv_offset=off)
    out = flash_attention(q, k, v, **kw).float()
    ref = flash_attention_ref(q, k, v, **kw).float()
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    err = diff.max().item()
    scaled = (diff / ref.abs().clamp_min(1.0)).max().item()
    if not (math.isfinite(scaled) and scaled <= TOL[dtype]):
        raise AssertionError(
            f"kernel disagrees with its plain version: B={B} S={S} Sk={Sk} "
            f"{dtype} {mode} kv_offset={off}: max|err|/max(1,|ref|) "
            f"{scaled} > {TOL[dtype]} (max|err| {err})")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"  kernel launch B={B} S={S} Sk={Sk} {dtype} "
          f"{json.dumps(dict(**last_launch(), sms=sms))} ({card})")
    ms = cuda_ms(lambda: flash_attention(q, k, v, **kw))
    dev_ms, _ = device_ms(lambda: flash_attention(q, k, v, **kw))
    plain = cuda_ms(lambda: flash_attention_ref(q, k, v, **kw),
                    iters=5, warmup=1)
    lib, lib_dev = (library_ms(q, k, v, mode, window) if off == 0
                    else (None, None))
    # fp32: split TF32 (the kernel's own arithmetic), the CUDA-core
    # figure beside it
    fp32 = dtype == torch.float32
    bound, bound_by = attention_bound(B, S, Sk, H, HKV, D, dtype, mode,
                                      window, off,
                                      SPLIT_TF32 if fp32 else None)
    bound_cc = (attention_bound(B, S, Sk, H, HKV, D, dtype, mode, window,
                                off)[0] if fp32 else None)
    row = dict(B=B, S=S, Sk=Sk, H=H, Hkv=HKV, D=D,
               dtype=str(dtype).split(".")[-1], mode=mode, window=window,
               kv_offset=off, max_abs_err=err, max_scaled_err=scaled,
               tol=TOL[dtype], ms=ms, device_ms=dev_ms, plain_ms=plain,
               library_ms=lib, library_device_ms=lib_dev, bound_ms=bound,
               bound_by=bound_by, bound_cuda_core_ms=bound_cc)
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


def phase_path(dev, card, shapes, n_layers, heads=(H, HKV, D)):
    """The kernel vs its plain version at every (rows, bucket) shape the
    serving run launched it with (bf16, causal, as on the path), at the
    model's `heads` (internvl3-2b's by default)."""
    gen = torch.Generator(device=dev).manual_seed(1)
    out = []
    for (rows, bucket), n_batches in sorted(shapes.items()):
        row = check_kernel(dev, card, gen, rows, bucket, torch.bfloat16,
                           heads=heads)
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


def phase_serving(dev, card, arch="internvl3-2b"):
    """Full-width serving of `arch`; returns the kernel's launches in the
    run, the number of co-batched prefills at each (rows, bucket) shape,
    the model's layers and its heads (query, KV, head_dim)."""
    from repro_torch.api import Engine
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.model import prefill
    from repro_torch.obs.trace import Tracer

    t0 = time.perf_counter()
    eng = Engine(arch, seed=0)
    params = eng.state.params
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  {arch} as {eng.cfg.family}: {eng.cfg.n_layers} layers "
          f"d_model {eng.cfg.d_model}, {eng.cfg.n_heads}:{eng.cfg.kv_heads}"
          f" heads of {eng.cfg.resolved_head_dim}, {n_params / 1e9:.3f} B "
          f"params {eng.cfg.param_dtype}, init "
          f"{time.perf_counter() - t0:.1f} s")
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
    label = "serving" if arch == "internvl3-2b" else f"{arch} serving"
    for key, val in stats.items():
        print(f"  {label} {key} = {val} ({card})")
    return launches, shapes, eng.cfg.n_layers, (
        eng.cfg.n_heads, eng.cfg.kv_heads, eng.cfg.resolved_head_dim)


# ------------------------------------------------------------ kernel K1
GRAD_TOL = {torch.bfloat16: 4e-2, torch.float32: 1e-4}
#: bf16 K1 outputs and gradients, as whole tensors: max|err| / max|plain|.
#: Sound kernels read up to 0.0067 on an H100 (S 1024 and 4096, every
#: mode, with and without spans); a planted fault that drops one 64-key
#: tile from dQ, one 64-query tile from dK or from the whole backward,
#: shifts the query start by a tile, leaves one query head out of the
#: group sum of dK and dV, or drops one key tile from the forward, reads
#: 0.09 or more on the tensor it must show in (k1_fault_check.py)
REL_TOL_BF16 = 2e-2


def _scaled_err(out, ref):
    """(max|err|, max of |err| / max(1, |ref|), max|err| / max|ref|)."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    top = diff.max().item()
    return (top, (diff / ref.abs().clamp_min(1.0)).max().item(),
            top / max(ref.abs().max().item(), 1e-30))


def packed_layout(S, lens, frame=None, text=32):
    """Segment table of `lens` then tail padding (-1); with `frame`, span
    ids of `frame`-token bidirectional blocks after every `text` causal
    tokens (ids unique per buffer)."""
    seg = np.full(S, -1, np.int32)
    span = np.full(S, -1, np.int32)
    off, sid = 0, 0
    for i, L in enumerate(lens):
        seg[off:off + L] = i
        p = text
        while frame and p < L:
            f = min(frame, L - p)
            span[off + p:off + p + f] = sid
            sid += 1
            p += f + text
        off += L
    return seg, (span if frame else None)


def packed_bound(B, Sq, Sk, H, Hkv, D, dtype, pairs, backward, n_tables,
                 rate=None):
    """Least time for the same work: q, k, v, o (+ dO, and dq, dk, dv
    written), the fp32 LSE and the int32 tables (`n_tables` per side:
    segments, and spans when given) cross HBM once, against 4*D
    (forward) or 10*D (backward) flops per valid (query, key) pair per
    head at `rate`, the peak rate for the input type by default: (ms,
    "bytes" or "operations"). fp32's kernels at head_dim 64 do their
    products in split TF32 (rate=SPLIT_TF32)."""
    elt = torch.finfo(dtype).bits // 8
    qo = B * Sq * H * D
    kv = B * Sk * Hkv * D
    nbytes = elt * (2 * qo + 2 * kv) + 4 * B * H * Sq \
        + 4 * n_tables * B * (Sq + Sk)
    if backward:
        nbytes += elt * (2 * qo + 2 * kv)          # dO read; dq, dk, dv
    flops = (10.0 if backward else 4.0) * D * pairs * H
    return roofline(nbytes, flops, rate or PEAK_FLOPS[dtype])


def packed_dq_bound(B, Sq, Sk, H, Hkv, D, pairs, n_tables,
                    rate=SPLIT_TF32):
    """Least time for dQ alone in fp32 (what fp32's dQ kernel computes):
    q, k, v, dO, the LSE, delta and the tables read once, dq written once,
    against 6*D flops per valid pair per head (S, dP, dQ) at `rate`,
    split TF32 (the kernel's own arithmetic) by default: (ms, "bytes" or
    "operations")."""
    qo, kv = B * Sq * H * D, B * Sk * Hkv * D
    nbytes = 4 * (3 * qo + 2 * kv) + 8 * B * H * Sq \
        + 4 * n_tables * B * (Sq + Sk)
    return roofline(nbytes, 6.0 * D * pairs * H, rate)


def _by_kv_heads(fn, n, q, k, v, *rest, **kw):
    """`fn` (a plain version of K1, forward or backward) over `n` equal
    slices of the KV heads, each with its query heads, joined: the same
    function at 1/n of its fp32 score matrices' memory (128 query heads
    over a 4096-token row need 8.6 GB a matrix whole). `rest`: o, lse,
    dO of the backward."""
    if n == 1:
        return fn(q, k, v, *rest, **kw)
    hq, hk = q.shape[2] // n, k.shape[2] // n
    outs = []
    for i in range(n):
        qs, ks = slice(i * hq, (i + 1) * hq), slice(i * hk, (i + 1) * hk)
        r = rest if len(rest) == 1 else (
            rest[0][:, :, qs], rest[1][:, qs], rest[2][:, :, qs], *rest[3:])
        outs.append(fn(q[:, :, qs], k[:, :, ks], v[:, :, ks], *r, **kw))
    if len(outs[0]) == 2:                          # forward: o, lse
        return torch.cat([o[0] for o in outs], 2), torch.cat(
            [o[1] for o in outs], 1)
    return tuple(torch.cat([o[j] for o in outs], 2) for j in range(3))


def check_packed(dev, card, gen, S, dtype, seg, span=None, mode="causal",
                 window=None, off=0, kseg=None, kspan=None, Sk=None,
                 tag="", heads=(H, HKV, D), detail=False):
    """K1 forward and backward vs plain on one random input with the
    given tables ([S], one row, or [B, S]) at `heads` = (query heads, KV
    heads, head_dim), internvl3-2b's by default; times kernel, plain and
    SDPA (boolean mask from the tables, built outside the timing). Above
    32 query heads the plain versions run a KV head at a time
    (`_by_kv_heads`). `detail`: also each direction's device time
    (torch.profiler) and launch (grid, threads, shared memory) beside
    the card's SMs, and SDPA's device time each way; for fp32's
    split-TF32 backward (head_dim 64) also the dQ kernel's launch
    (`bwd_dq`) and each kernel's device time
    (`bwd_device_ms_by_kernel`)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention_packed import (
        F32_TC_HEAD_DIM, _tables, flash_attention_packed,
        flash_attention_packed_bwd, flash_attention_packed_bwd_ref,
        flash_attention_packed_ref, last_bwd_dq_launch, last_bwd_kv_launch,
        last_fwd_launch, pair_mask)
    H, HKV, D = heads
    split = HKV if H > 32 else 1
    plain_fwd_fn = (lambda *a, **k: _by_kv_heads(  # noqa: E731
        flash_attention_packed_ref, split, *a, **k))
    plain_bwd_fn = (lambda *a, **k: _by_kv_heads(  # noqa: E731
        flash_attention_packed_bwd_ref, split, *a, **k))
    Sk = Sk or S
    B = 1 if np.ndim(seg) == 1 else len(seg)
    q = torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
    do = torch.randn(B, S, H, D, generator=gen, device=dev).to(dtype)
    k = torch.randn(B, Sk, HKV, D, generator=gen, device=dev).to(dtype)
    v = torch.randn(B, Sk, HKV, D, generator=gen, device=dev).to(dtype)
    t = lambda a: None if a is None else torch.as_tensor(a, device=dev)  # noqa: E731
    segt = t(seg)
    kw = dict(mode=mode, window=window, span_ids=t(span),
              kv_segment_ids=t(kseg), kv_span_ids=t(kspan), kv_offset=off)
    o, lse = flash_attention_packed(q, k, v, segt, return_lse=True, **kw)
    launch = dict(fwd=last_fwd_launch())
    grads = flash_attention_packed_bwd(q, k, v, o, lse, do, segt, **kw)
    launch["bwd"] = last_bwd_kv_launch()
    # fp32 at head_dim 64: both ways split TF32, the backward in two
    # kernels
    tc = dtype == torch.float32 and D == F32_TC_HEAD_DIM
    if tc:
        launch["bwd_dq"] = last_bwd_dq_launch()
    ro, rlse = plain_fwd_fn(q, k, v, segt, **kw)
    rgrads = plain_bwd_fn(q, k, v, ro, rlse, do, segt, **kw)
    torch.cuda.synchronize()
    errs = {"o": _scaled_err(o, ro)}
    for name, a, r in zip(("dq", "dk", "dv"), grads, rgrads):
        errs[name] = _scaled_err(a, r)
    fin = torch.isfinite(rlse)
    if not torch.equal(fin, torch.isfinite(lse)):
        raise AssertionError(f"K1 {tag}: rows with keys differ (LSE)")
    lse_err = (lse[fin] - rlse[fin]).abs().max().item() if fin.any() else 0.
    for name, (_, scaled, rel) in errs.items():
        tol = TOL[dtype] if name == "o" else GRAD_TOL[dtype]
        what = (f"K1 disagrees with its plain version ({tag} S={S} "
                f"{dtype} {mode} spans={span is not None} kv_offset={off})")
        if not (math.isfinite(scaled) and scaled <= tol):
            raise AssertionError(f"{what}: {name} max|err|/max(1,|ref|) "
                                 f"{scaled} > {tol}")
        if dtype == torch.bfloat16 and not rel <= REL_TOL_BF16:
            raise AssertionError(f"{what}: {name} max|err|/max|ref| {rel} "
                                 f"> {REL_TOL_BF16}")
    if not lse_err <= 1e-3:
        raise AssertionError(f"K1 {tag}: LSE off by {lse_err}")
    tabs = _tables(q, k, segt, kw["span_ids"], kw["kv_segment_ids"],
                   kw["kv_span_ids"])
    mask = pair_mask(S, Sk, *tabs, mode=mode, window=window, kv_offset=off)
    pairs = int(mask.sum())
    fwd_ms = cuda_ms(lambda: flash_attention_packed(q, k, v, segt, **kw),
                     iters=10, warmup=2)
    bwd_ms = cuda_ms(lambda: flash_attention_packed_bwd(
        q, k, v, o, lse, do, segt, **kw), iters=10, warmup=2)
    plain_fwd = cuda_ms(lambda: plain_fwd_fn(q, k, v, segt, **kw), iters=3,
                        warmup=1)
    plain_bwd = cuda_ms(lambda: plain_bwd_fn(q, k, v, ro, rlse, do, segt,
                                             **kw), iters=3, warmup=1)
    # yardstick: SDPA with the tables' boolean mask, GQA in place
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))
    am = mask[:, None]
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am,
                                             enable_gqa=True)
    dot = do.transpose(1, 2)
    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=am, enable_gqa=True), iters=10, warmup=2)
    lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True), iters=10,
        warmup=2)
    del lib_out
    n_tables = 1 if span is None else 2
    # at the rate of the kernels' own arithmetic: split TF32 (the
    # CUDA-core figure beside it), else the input type's peak
    shape = (B, S, Sk, H, HKV, D, dtype, pairs)
    bf, bf_by = packed_bound(*shape, False, n_tables,
                             SPLIT_TF32 if tc else None)
    bb, bb_by = packed_bound(*shape, True, n_tables,
                             SPLIT_TF32 if tc else None)
    row = dict(tag=tag, B=B, S=S, Sk=Sk, H=H, Hkv=HKV, D=D,
               dtype=str(dtype).split(".")[-1], mode=mode, window=window,
               spans=span is not None, kv_offset=off, pairs=pairs,
               err={n: e[1] for n, e in errs.items()},
               rel_err={n: e[2] for n, e in errs.items()},
               err_abs={n: e[0] for n, e in errs.items()},
               max_abs_err_fwd=errs["o"][0],
               max_abs_err_bwd=max(errs[n][0] for n in ("dq", "dk", "dv")),
               lse_err=lse_err, fwd_ms=fwd_ms, bwd_ms=bwd_ms,
               plain_fwd_ms=plain_fwd, plain_bwd_ms=plain_bwd,
               library_fwd_ms=lib_fwd, library_bwd_ms=lib_bwd,
               bound_fwd_ms=bf, bound_fwd_by=bf_by, bound_bwd_ms=bb,
               bound_bwd_by=bb_by)
    if tc:
        row["bound_fwd_cuda_core_ms"] = packed_bound(*shape, False,
                                                     n_tables)[0]
        row["bound_bwd_cuda_core_ms"] = packed_bound(*shape, True,
                                                     n_tables)[0]
    if detail:
        row["fwd_device_ms"] = device_ms(lambda: flash_attention_packed(
            q, k, v, segt, **kw), iters=5, warmup=1)[0]
        row["bwd_device_ms"] = device_ms(lambda: flash_attention_packed_bwd(
            q, k, v, o, lse, do, segt, **kw), iters=5, warmup=1)[0]
        # SDPA on the card's own clock beside the kernels'
        row["library_fwd_device_ms"] = device_ms(
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=am, enable_gqa=True), iters=5,
            warmup=1)[0]
        lib_out = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=am, enable_gqa=True)
        row["library_bwd_device_ms"] = device_ms(lambda: (
            torch.autograd.grad(lib_out, (qt, kt, vt), dot,
                                retain_graph=True)), iters=5, warmup=1)[0]
        del lib_out
        if tc:
            row["bound_dq_ms"], row["bound_dq_by"] = packed_dq_bound(
                B, S, Sk, H, HKV, D, pairs, n_tables)
            row["bound_dq_cuda_core_ms"] = packed_dq_bound(
                B, S, Sk, H, HKV, D, pairs, n_tables,
                PEAK_FLOPS[torch.float32])[0]
            # each of the backward's kernels apart
            row["bwd_device_ms_by_kernel"] = device_ms_by_kernel(
                lambda: flash_attention_packed_bwd(q, k, v, o, lse, do, segt,
                                                   **kw))
        row["launch"] = dict(**launch, sms=torch.cuda.get_device_properties(
            0).multi_processor_count)
        print(f"  K1 launch {tag} S={S} H={H} Hkv={HKV} D={D} "
              f"{json.dumps(row['launch'])} ({card})")
    print(f"  K1 {json.dumps(row)} ({card})")
    return row


#: how far the redesign of K1's bf16 backward at D = 64 / 128 went: 1 a
#: (query head, 64-key tile) grid with the heads' dK / dV summed after
#: it, 2 cp.async tiles and no transposed copies, 3 16-byte vector
#: atomics for dQ, 4 every product by wgmma (its source note)
K1_BWD_STAGE = 4
#: how far the redesign of K1's bf16 forward (every head dim) went: 1
#: every product by wgmma, 2 a cp.async ring of K/V tiles found by
#: ballot, 3 the unmasked path, 4 two warpgroups a block, the heaviest
#: query tiles first (its source note)
K1_FWD_STAGE = 4


def phase_packed(dev, card):
    gen = torch.Generator(device=dev).manual_seed(2)
    bf16, fp32 = torch.bfloat16, torch.float32
    rows = []
    for S, lens in ((1024, [400, 300, 250]),
                    (4096, [1500, 900, 1200, 400])):
        for frame in (None, 256):
            seg, span = packed_layout(S, lens, frame)
            rows.append(check_packed(dev, card, gen, S, bf16, seg, span,
                                     tag="synthetic"))
            if S == 4096 and frame:
                # the training path's shape: one 4096-token row, 12:2
                # heads, D = 128; the launch as the library recorded it
                from repro_torch.kernels.flash_attention_packed import (
                    last_bwd_kv_launch, last_fwd_launch)
                sms = torch.cuda.get_device_properties(
                    0).multi_processor_count
                for which, stage, launch in (
                        ("fwd", K1_FWD_STAGE, last_fwd_launch),
                        ("bwd", K1_BWD_STAGE, last_bwd_kv_launch)):
                    facts = dict(stage=stage, **launch(), sms=sms)
                    print(f"  K1 {which} design at S={S} H={H} Hkv={HKV} "
                          f"D={D} {json.dumps(facts)} ({card})")
    S, lens = 1024, [400, 300, 250]
    seg, span = packed_layout(S, lens, 128)
    rows.append(check_packed(dev, card, gen, S, fp32, seg, span,
                             tag="synthetic"))
    rows.append(check_packed(dev, card, gen, S, fp32, seg, None,
                             tag="synthetic"))
    for mode, window in (("full", None), ("sliding", 256)):
        for dt in (bf16, fp32):
            rows.append(check_packed(dev, card, gen, S, dt, seg, span,
                                     mode=mode, window=window,
                                     tag="synthetic"))
    # a ring hop: the second half of the buffer's queries against the
    # first half's keys, which bring their own tables (kv padding -2)
    half = S // 2
    kseg = seg[:half].copy()
    kseg[kseg < 0] = -2
    for dt in (bf16, fp32):
        rows.append(check_packed(dev, card, gen, half, dt, seg[half:],
                                 span[half:], off=-half, kseg=kseg,
                                 kspan=span[:half], Sk=half, tag="hop"))
    return rows


def phase_train_parity(dev, arch="internvl3-2b", cfg=None):
    """Reduced `arch` (a packed family), fp32, or the reduced config
    `cfg` under that name: the first batch's loss and gradient, two
    training steps, and the gradient at the parameters they reach,
    through the kernels vs through the plain attention."""
    from repro_torch.api import Engine
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed, flash_attention_packed_bwd)
    from repro_torch.data.pipeline import HeterogeneousLoader
    from repro_torch.training import TrainState
    from repro_torch.training.optimizer import tree_leaves, tree_map

    run = dict(dataset="openvid", global_batch=8, max_tokens=512,
               tokens_per_frame=16)
    out = {}
    params0 = None
    for impl in ("cuda", "reference"):
        eng = (Engine(arch, reduced=True, seed=0) if cfg is None
               else Engine(cfg, seed=0))
        eng.cfg = eng.cfg.with_(attn_impl=impl)
        if params0 is None:
            params0 = eng.state.params
        eng.state = TrainState(params=tree_map(torch.clone, params0))
        data = next(HeterogeneousLoader(run["dataset"], 8, eng.cfg.vocab,
                                        seed=0, max_tokens=512,
                                        tokens_per_frame=16))
        n0 = (flash_attention_packed.launches,
              flash_attention_packed_bwd.launches)
        loss0, grads0 = eng.executor.run_plan(eng.state.params,
                                              eng.plan(data), data)
        n1 = (flash_attention_packed.launches,
              flash_attention_packed_bwd.launches)
        groups = len(eng.executor.last_exe_keys)
        hist = eng.train(steps=2, lookahead=False, **run)
        data2 = next(eng.loader)
        loss2, grads2 = eng.executor.run_plan(eng.state.params,
                                              eng.plan(data2), data2)
        eng.close()
        out[impl] = ([float(loss0)] + [m.loss for m in hist]
                     + [float(loss2)], (grads0, grads2), eng.state.params)
        want = (eng.cfg.n_layers * groups,) * 2 if impl == "cuda" \
            else (0, 0)
        if (n1[0] - n0[0], n1[1] - n0[1]) != want:
            raise AssertionError(f"{impl}: K1 launches {n1} - {n0}, want "
                                 f"{want} for {groups} groups")
    (ls, gs, p), (rls, rgs, rp) = out["cuda"], out["reference"]
    lerr = max(abs(a - b) for a, b in zip(ls, rls))
    gerr = [max((a - b).abs().max().item()
                for a, b in zip(tree_leaves(g), tree_leaves(rg)))
            for g, rg in zip(gs, rgs)]
    perr = max((a - b).abs().max().item()
               for a, b in zip(tree_leaves(p), tree_leaves(rp)))
    print(f"  {arch} losses kernel {ls} plain {rls}: max diff {lerr}; "
          f"grads max diff {gerr[0]} (first batch), {gerr[1]} (after 2 "
          f"steps); params after 2 steps max diff {perr}")
    if not (lerr <= 1e-4 and max(gerr) <= 1e-4):
        raise AssertionError("training through the kernels differs from "
                             "the plain path by more than 1e-4")
    # The parameters are printed, not held to a limit: both paths share
    # the optimizer, and AdamW divides each moment by its root mean
    # square, so an element whose gradient is as small as the paths'
    # difference (1e-7) may step up to 2 lr apart. The gradient at the
    # parameters the two steps reach is what tells the paths apart.


def packed_tables(eng, plans, run, groups):
    """{(bucket, spans): [(segment table, span table or None)]} of every
    packed group of a training run, rebuilt from its plans and batches,
    held to the run's own `execute` spans' (bucket, spans) `groups`."""
    from repro_torch.core.packing import flatten_group
    from repro_torch.data.pipeline import HeterogeneousLoader
    loader = HeterogeneousLoader(run["dataset"], run["global_batch"],
                                 eng.cfg.vocab, seed=eng.seed,
                                 max_tokens=run["max_tokens"],
                                 tokens_per_frame=run["tokens_per_frame"])
    tables = {}
    for plan in plans:
        data = next(loader)
        spans_by_id = data.spans_by_id()
        for mb in plan.micro_batches:
            for g in mb.groups:
                seqs = [data.by_id(i) for i in g.seq_ids]
                bucket = eng.cluster.pool().bucket(sum(map(len, seqs)))
                b, _ = flatten_group(seqs, bucket, spans=[
                    spans_by_id.get(i) for i in g.seq_ids])
                key = (bucket, "modality_ids" in b)
                tables.setdefault(key, []).append(
                    (b["segment_ids"][0], b.get("modality_ids",
                                                [None])[0]))
    if sorted(tables) != sorted(set(groups)) or \
            sum(map(len, tables.values())) != len(groups):
        raise AssertionError(f"rebuilt groups {sorted(tables)} differ from "
                             f"the run's {sorted(set(groups))}")
    return tables


def phase_training(dev, card, arch="internvl3-2b", depth=None):
    """Full-width DHP training of `arch`, its layers cut to `depth` where
    given; returns (launches fwd, bwd, group tables by (bucket, spans),
    n_layers)."""
    from repro_torch.api import ClusterSpec, Engine
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed, flash_attention_packed_bwd)

    run = dict(dataset="openvid", global_batch=8, max_tokens=4096,
               tokens_per_frame=256)
    label = "train" if arch == "internvl3-2b" else f"{arch} train"
    t0 = time.perf_counter()
    cfg = get_config(arch)
    if depth is not None:
        cfg = cfg.with_(n_layers=depth)
    eng = Engine(cfg, ClusterSpec.auto(mem_budget=4096), seed=0)
    params = eng.state.params
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  {arch} as {eng.cfg.family}: {eng.cfg.n_layers} layers "
          f"d_model {eng.cfg.d_model}, {eng.cfg.n_heads}:{eng.cfg.kv_heads}"
          f" heads of {eng.cfg.resolved_head_dim}, {n_params / 1e9:.3f} B "
          f"params {eng.cfg.param_dtype}, init "
          f"{time.perf_counter() - t0:.1f} s")
    plans = []
    torch.cuda.reset_peak_memory_stats(dev)
    flash_attention_packed.launches = 0
    flash_attention_packed_bwd.launches = 0
    hist = eng.train(steps=3, lookahead=True, plan_log=plans, trace=True,
                     **run)
    torch.cuda.synchronize()
    n_fwd = flash_attention_packed.launches
    n_bwd = flash_attention_packed_bwd.launches
    peak = torch.cuda.max_memory_allocated(dev)

    tracer = eng.last_tracer
    if tracer.dropped:
        raise AssertionError(f"the tracer dropped {tracer.dropped} events")
    groups = [(e["args"]["bucket"], e["args"]["spans"])
              for e in tracer.to_json()["traceEvents"]
              if e.get("name") == "execute"]
    want = eng.cfg.n_layers * len(groups)
    runs = 2 if eng.cfg.remat else 1       # remat runs each layer again
    if not (n_bwd == want and n_fwd == runs * want and want > 0):
        raise AssertionError(f"K1 launches fwd {n_fwd} bwd {n_bwd}, want "
                             f"{runs} x {want} and {want} for "
                             f"{eng.cfg.n_layers} layers x {len(groups)} "
                             f"groups")
    for m in hist:
        if not math.isfinite(m.loss):
            raise AssertionError(f"step {m.step}: loss {m.loss}")
        tok_s = m.tokens / m.step_time_s
        print(f"  {label} step {m.step}: loss={m.loss} "
              f"step_time_s={m.step_time_s} tokens={m.tokens} "
              f"tokens_per_s={tok_s} padding_efficiency="
              f"{m.padding_efficiency} degrees={m.degree_histogram} "
              f"groups={sum(m.degree_histogram.values())} "
              f"schedule_ms={m.schedule_ms} plan_overlap_ms="
              f"{m.plan_overlap_ms} ({card})")
    if len(hist) != 3:
        raise AssertionError(f"{len(hist)} training steps, want 3")
    if not all(torch.isfinite(t).all() for t in _leaves(
            eng.state.params)):
        raise AssertionError("parameters are not finite after 3 steps")
    print(f"  {label} max_memory_allocated_bytes = {peak} ({card})")
    print(f"  {label} group shapes (bucket, spans): {groups}")

    tables = packed_tables(eng, plans, run, groups)

    # one more step under the profiler: the device's busy share
    profile_step(eng, run, card, label,
                 {"k1": "packed_", "k1_fwd": "packed_fwd",
                  "k1_bwd": "packed_bwd", "k1_bwd_sum": "bwd_kv_reduce"})
    eng.close()
    return n_fwd, n_bwd, tables, eng.cfg.n_layers


def phase_train_path(dev, card, tables, n_layers, heads=(H, HKV, D),
                     tag="train"):
    """K1 forward and backward vs plain at each (bucket, spans) shape of
    the training run, on the first group's own tables of that shape, at
    the model's `heads` (internvl3-2b's by default)."""
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    for (bucket, spans), groups in sorted(tables.items()):
        seg, span = groups[0]
        row = check_packed(dev, card, gen, bucket, torch.bfloat16, seg,
                           span, tag=tag, heads=heads)
        row["launches"] = n_layers * len(groups)
        rows.append(row)
    return rows


# ------------------------------------------------------------ kernel K3
#: K3 against its plain version run in fp64 on the same inputs (the
#: function's exact value): y, states, cum within SSD_TOL * max(1,
#: |plain|), whatever the input type (bf16 inputs are upcast exactly, all
#: arithmetic is fp32); the gradients within SSD_GRAD_TOL elementwise and
#: SSD_TOL as whole tensors (max|err| / max|plain|): at c = 256 each
#: gradient element sums some 256 products of both signs, and the plain
#: version itself in fp32 lies up to 2.1e-4 from the fp64 value there;
#: dC, dB, dx returned in bf16 within SSD_BF16_GRAD_TOL both ways (one
#: bf16 rounding)
SSD_TOL = 1e-4
SSD_GRAD_TOL = 1e-3
SSD_BF16_GRAD_TOL = 1e-2
SSD_HEADS, SSD_N, SSD_P, SSD_C = 32, 128, 64, 256   # mamba2-370m


def ssd_inputs(dev, gen, Bsz, S, H, N, P, dtype):
    """C, B, x in `dtype`, fp32 da and dt as the model makes them (dt =
    softplus(.) + 1e-3, A = -1 at init): the sum of dt over a 256-token
    chunk is about 200, so exp above the diagonal would overflow."""
    f = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    C, B = f(Bsz, S, N) * 0.3, f(Bsz, S, N) * 0.3
    x = f(Bsz, S, H, P)
    dt = torch.nn.functional.softplus(f(Bsz, S, H)) + 1e-3
    return C.to(dtype), B.to(dtype), x.to(dtype), -dt, dt


def ssd_bound(Bsz, S, H, N, P, c, dtype, backward, tensor_cores=False):
    """Least time for the same work: inputs read once and outputs written
    once (C and B once for all heads) against the products over the
    lower triangle of each cell's c x c scores at the fp32 peak (the
    kernel's arithmetic is fp32 whatever the input type). C and B are
    shared by the heads, so C B^T is counted once per (sequence, chunk),
    and so are dC and dB, which the backward forms from the score
    gradient summed over heads. Forward: C B^T (2N flops a pair), the
    scores times x (2P a pair and head), the states (2cNP a cell).
    Backward: C B^T again, dC, dB (6N a pair), dS and dx (4P a pair and
    head), the states' terms of dx and dB (4cNP a cell).

    `tensor_cores`: the products a direction runs on the tensor cores
    at the TF32 peak, the rest at the fp32 peak, the two units side by
    side. Forward: every product (C B^T, the scores times x, the
    states). Backward: C B^T, dS and the states' terms on the tensor
    cores; dC, dB and dx on the CUDA cores."""
    elt = torch.finfo(dtype).bits // 8
    cells = Bsz * (S // c) * H
    pairs = c * (c + 1) // 2 * Bsz * (S // c)      # per (sequence, chunk)
    toks = Bsz * S
    ins = elt * (2 * toks * N + toks * H * P) + 4 * 2 * toks * H
    y, st, cum = 4 * toks * H * P, 4 * cells * N * P, 4 * toks * H
    if backward:
        nbytes = ins + (y + st + cum) + ins
        flops = 6 * N * pairs + 4 * P * pairs * H + 4 * c * N * P * cells
    else:
        nbytes = ins + y + st + cum
        flops = 2 * N * pairs + 2 * P * pairs * H + 2 * c * N * P * cells
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[torch.float32]
    if tensor_cores:
        tc = (2 * N * pairs + 2 * P * pairs * H + 4 * c * N * P * cells
              if backward else flops)
        t_ops = max(tc / PEAK_TF32,
                    (flops - tc) / PEAK_FLOPS[torch.float32])
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_ssd(dev, card, gen, Bsz, S, H, N, P, c, dtype, tag, time_it=True):
    """K3 forward and backward vs plain on one random input; times
    kernel, plain, and the inter-chunk part of `ssd_chunk_scan`."""
    from repro_torch.kernels.ssd_chunk import (
        last_bwd_launch, last_fwd_launch, ssd_chunk, ssd_chunk_bwd,
        ssd_chunk_bwd_plain, ssd_chunk_plain, ssd_chunk_scan)
    C, B, x, da, dt = ssd_inputs(dev, gen, Bsz, S, H, N, P, dtype)
    outs = ssd_chunk(C, B, x, da, dt, chunk=c)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fwd_launch = dict(**last_fwd_launch(), sms=sms)
    douts = [torch.randn(o.shape, generator=gen, device=dev) for o in outs]
    grads = ssd_chunk_bwd(C, B, x, da, dt, *douts, chunk=c)
    launch = dict(**last_bwd_launch(), sms=sms)
    what = (f"{tag} Bsz={Bsz} S={S} H={H} N={N} P={P} c={c} "
            f"{str(dtype).split('.')[-1]}")
    print(f"  K3 forward launch {what}: {json.dumps(fwd_launch)} ({card})")
    print(f"  K3 backward launch {what}: {json.dumps(launch)} ({card})")
    ins64 = [t.double() for t in (C, B, x, da, dt)]
    refs = ssd_chunk_plain(*ins64, chunk=c)
    rgrads = ssd_chunk_bwd_plain(*ins64, *douts, chunk=c)
    torch.cuda.synchronize()
    errs = {}
    names = ("y", "states", "cum", "dC", "dB", "dx", "dda", "ddt")
    for name, a, r in zip(names, list(outs) + list(grads),
                          list(refs) + list(rgrads)):
        if not torch.isfinite(a).all():
            raise AssertionError(f"K3 {tag}: {name} is not finite")
        r = r.double()
        diff = (a.double() - r).abs()
        top = diff.max().item()
        errs[name] = (top, (diff / r.abs().clamp_min(1.0)).max().item(),
                      top / max(r.abs().max().item(), 1e-30))
        if name in names[:3]:
            tol, whole = SSD_TOL, None
        elif dtype == torch.bfloat16 and name in ("dC", "dB", "dx"):
            tol = whole = SSD_BF16_GRAD_TOL
        else:
            tol, whole = SSD_GRAD_TOL, SSD_TOL
        _, scaled, rel = errs[name]
        what = (f"K3 disagrees with its plain version ({tag} Bsz={Bsz} "
                f"S={S} H={H} N={N} P={P} c={c} {dtype}): {name}")
        if not (math.isfinite(scaled) and scaled <= tol):
            raise AssertionError(f"{what} max|err|/max(1,|ref|) {scaled} "
                                 f"> {tol}")
        if whole is not None and not rel <= whole:
            raise AssertionError(f"{what} max|err|/max|ref| {rel} > "
                                 f"{whole}")
    del ins64, refs, rgrads
    row = dict(tag=tag, Bsz=Bsz, S=S, H=H, N=N, P=P, chunk=c,
               dtype=str(dtype).split(".")[-1],
               err={n: e[1] for n, e in errs.items()},
               rel_err={n: e[2] for n, e in errs.items()},
               max_abs_err_fwd=max(errs[n][0] for n in names[:3]),
               max_abs_err_bwd=max(errs[n][0] for n in names[3:]),
               fwd_launch=fwd_launch, bwd_launch=launch)
    if time_it:
        # each call launches each of its kernels once (the forward two,
        # the backward three)
        for which, fn in (
                ("fwd", lambda: ssd_chunk(C, B, x, da, dt, chunk=c)),
                ("bwd", lambda: ssd_chunk_bwd(C, B, x, da, dt, *douts,
                                              chunk=c))):
            row[f"{which}_ms"] = cuda_ms(fn, iters=10, warmup=2)
            row[f"{which}_device_ms"], row[f"{which}_kernels_traced"] = \
                device_ms(fn, iters=10, warmup=2, each_once=True)
        row["plain_fwd_ms"] = cuda_ms(lambda: ssd_chunk_plain(
            C, B, x, da, dt, chunk=c), iters=3, warmup=1)
        row["plain_bwd_ms"] = cuda_ms(lambda: ssd_chunk_bwd_plain(
            C, B, x, da, dt, *douts, chunk=c), iters=3, warmup=1)
        # the inter-chunk scan and product around the kernel, forward and
        # backward: ssd_chunk_scan's time less the kernel's
        ins = [t.detach().requires_grad_(True) for t in (C, B, x, da, dt)]
        dy = torch.randn(x.shape, generator=gen, device=dev)

        def scan_fb():
            y = ssd_chunk_scan(*ins, chunk=c)
            torch.autograd.grad(y, ins, dy)
        row["scan_fwd_bwd_ms"] = cuda_ms(scan_fb, iters=5, warmup=1)
        row["inter_chunk_fwd_bwd_ms"] = (row["scan_fwd_bwd_ms"]
                                         - row["fwd_ms"] - row["bwd_ms"])
        for which in ("fwd", "bwd"):
            for tc in ("", "tc_"):
                row[f"bound_{tc}{which}_ms"], row[f"bound_{tc}{which}_by"] = \
                    ssd_bound(Bsz, S, H, N, P, c, dtype, which == "bwd",
                              tensor_cores=bool(tc))
    print(f"  K3 {json.dumps(row)} ({card})")
    return row


def phase_ssd(dev, card):
    gen = torch.Generator(device=dev).manual_seed(4)
    bf16, fp32 = torch.bfloat16, torch.float32
    rows = []
    for dt in (bf16, fp32):
        # mamba2-370m's full-width cell over one 4096-token row
        rows.append(check_ssd(dev, card, gen, 1, 4096, SSD_HEADS, SSD_N,
                              SSD_P, SSD_C, dt, "full"))
        # its reduced cell, and a ragged cell count
        rows.append(check_ssd(dev, card, gen, 2, 256, 8, 16, 32, 32, dt,
                              "reduced", time_it=False))
        rows.append(check_ssd(dev, card, gen, 3, 768, 5, SSD_N, SSD_P,
                              SSD_C, dt, "ragged", time_it=False))
    return rows


def phase_ssm_parity(dev):
    """Reduced mamba2-370m, fp32: the first batch's loss and gradient,
    two training steps, and the gradient at the parameters they reach,
    through K3 vs through its plain version."""
    from repro_torch.api import Engine
    from repro_torch.data.pipeline import HeterogeneousLoader
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_bwd
    from repro_torch.training import TrainState
    from repro_torch.training.optimizer import tree_leaves, tree_map

    run = dict(dataset="openvid", global_batch=8, max_tokens=512,
               tokens_per_frame=16)
    out = {}
    params0 = None
    for impl in ("cuda", "reference"):
        eng = Engine("mamba2-370m", reduced=True, seed=0)
        eng.cfg = eng.cfg.with_(attn_impl=impl)
        if params0 is None:
            params0 = eng.state.params
        eng.state = TrainState(params=tree_map(torch.clone, params0))
        data = next(HeterogeneousLoader(run["dataset"], 8, eng.cfg.vocab,
                                        seed=0, max_tokens=512,
                                        tokens_per_frame=16))
        n0 = (ssd_chunk.launches, ssd_chunk_bwd.launches)
        loss0, grads0 = eng.executor.run_plan(eng.state.params,
                                              eng.plan(data), data)
        n1 = (ssd_chunk.launches, ssd_chunk_bwd.launches)
        groups = len(eng.executor.last_exe_keys)
        hist = eng.train(steps=2, lookahead=False, **run)
        data2 = next(eng.loader)
        loss2, grads2 = eng.executor.run_plan(eng.state.params,
                                              eng.plan(data2), data2)
        eng.close()
        out[impl] = ([float(loss0)] + [m.loss for m in hist]
                     + [float(loss2)], (grads0, grads2), eng.state.params)
        want = (eng.cfg.n_layers * groups,) * 2 if impl == "cuda" \
            else (0, 0)
        if (n1[0] - n0[0], n1[1] - n0[1]) != want:
            raise AssertionError(f"{impl}: K3 launches {n1} - {n0}, want "
                                 f"{want} for {groups} groups")
    (ls, gs, p), (rls, rgs, rp) = out["cuda"], out["reference"]
    lerr = max(abs(a - b) for a, b in zip(ls, rls))
    gerr = [max((a - b).abs().max().item()
                for a, b in zip(tree_leaves(g), tree_leaves(rg)))
            for g, rg in zip(gs, rgs)]
    perr = max((a - b).abs().max().item()
               for a, b in zip(tree_leaves(p), tree_leaves(rp)))
    print(f"  losses kernel {ls} plain {rls}: max diff {lerr}; grads max "
          f"diff {gerr[0]} (first batch), {gerr[1]} (after 2 steps); "
          f"params after 2 steps max diff {perr}")
    if not (lerr <= 1e-4 and max(gerr) <= 1e-4):
        raise AssertionError("SSM training through K3 differs from the "
                             "plain path by more than 1e-4")


def collect_garbage(label):
    """Collect what earlier phases left in reference cycles (the
    profiler's event trees among it) before a timed training run, so
    that the collector's full pass over it does not land inside one of
    the run's steps; prints what it found and took."""
    import gc
    t0 = time.perf_counter()
    n = gc.collect()
    print(f"  {label}: gc.collect() before the run found {n} unreachable "
          f"objects in {(time.perf_counter() - t0) * 1e3:.1f} ms")


def profile_step(eng, run, card, label, kernel_keys, ranges=()):
    """One more training step of `eng` under torch.profiler; see
    `profile_call`."""
    return profile_call(lambda: eng.train(steps=1, lookahead=False, **run),
                        card, label, kernel_keys, ranges)


def profile_call(step, card, label, kernel_keys, ranges=()):
    """`step()` (one training step) under torch.profiler: wall, device
    busy share, the 15 kernels with the most device time, and for each
    name -> key of `kernel_keys` the device time and the launches of
    kernels whose name holds the key (printed as `<name>_device_ms` and
    `<name>_launches`). `ranges` names profiler
    ranges of the code: each appears on the device's timeline as a span
    over its kernels, which is reported apart and kept out of the busy
    time."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t1 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    dev_evs = [ev for ev in prof.events()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    for name in ranges:
        spans = [ev.time_range.elapsed_us() / 1e3 for ev in dev_evs
                 if ev.name == name]
        print(f"  {label} range {name}: {len(spans)} spans on the device "
              f"timeline, {sum(spans)} ms from first to last kernel "
              f"({card})")
    cuda_evs = [ev for ev in dev_evs if ev.name not in ranges]
    busy_ms = sum(ev.time_range.elapsed_us() / 1e3 for ev in cuda_evs)
    by_name = {}
    for ev in cuda_evs:
        t, n = by_name.get(ev.name, (0.0, 0))
        by_name[ev.name] = (t + ev.time_range.elapsed_us() / 1e3, n + 1)
    for kname, (t, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:15]:
        print(f"  {label} device time {t:.1f} ms over {n} launches: "
              f"{kname[:110]}")
    sums = {name: [sum(v[i] for n, v in by_name.items() if key in n)
                   for i in (0, 1)] for name, key in kernel_keys.items()}
    k_ms = " ".join(f"{name}_device_ms={t} {name}_launches={k}"
                    for name, (t, k) in sums.items())
    print(f"  {label} profiled step: wall_ms={wall_ms} device_busy_ms="
          f"{busy_ms} device_busy_share={busy_ms / wall_ms} {k_ms} "
          f"({card})")
    return prof


def phase_ssm_training(dev, card):
    """Full-width mamba2-370m DHP training; returns (launches fwd, bwd,
    {(n_seqs, bucket): groups}, n_layers, chunk)."""
    from repro_torch.api import ClusterSpec, Engine
    from repro_torch.kernels.ssd_chunk import (INTER_CHUNK, ssd_chunk,
                                               ssd_chunk_bwd)
    from repro_torch.training.optimizer import tree_leaves

    run = dict(dataset="openvid", global_batch=8, max_tokens=4096,
               tokens_per_frame=256)
    t0 = time.perf_counter()
    eng = Engine("mamba2-370m", ClusterSpec.auto(mem_budget=4096), seed=0)
    params = eng.state.params
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    s = eng.cfg.ssm
    print(f"  mamba2-370m: {eng.cfg.n_layers} layers d_model "
          f"{eng.cfg.d_model} d_state {s.d_state} head_dim {s.head_dim} "
          f"chunk {s.chunk} vocab {eng.cfg.vocab}, {n_params / 1e6:.1f} M "
          f"params {eng.cfg.param_dtype}, remat {eng.cfg.remat}, init "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats(dev)
    ssd_chunk.launches = 0
    ssd_chunk_bwd.launches = 0
    hist = eng.train(steps=3, lookahead=True, trace=True, **run)
    torch.cuda.synchronize()
    n_fwd, n_bwd = ssd_chunk.launches, ssd_chunk_bwd.launches
    peak = torch.cuda.max_memory_allocated(dev)

    tracer = eng.last_tracer
    if tracer.dropped:
        raise AssertionError(f"the tracer dropped {tracer.dropped} events")
    groups = [(e["args"]["n_seqs"], e["args"]["bucket"])
              for e in tracer.to_json()["traceEvents"]
              if e.get("name") == "execute"]
    want = eng.cfg.n_layers * len(groups)
    runs = 2 if eng.cfg.remat else 1       # remat runs each layer again
    if not (n_bwd == want and n_fwd == runs * want and want > 0):
        raise AssertionError(f"K3 launches fwd {n_fwd} bwd {n_bwd}, want "
                             f"{runs} x {want} and {want} for "
                             f"{eng.cfg.n_layers} layers x {len(groups)} "
                             f"groups")
    for m in hist:
        if not math.isfinite(m.loss):
            raise AssertionError(f"step {m.step}: loss {m.loss}")
        tok_s = m.tokens / m.step_time_s
        print(f"  ssm train step {m.step}: loss={m.loss} "
              f"step_time_s={m.step_time_s} tokens={m.tokens} "
              f"tokens_per_s={tok_s} padding_efficiency="
              f"{m.padding_efficiency} degrees={m.degree_histogram} "
              f"groups={sum(m.degree_histogram.values())} "
              f"schedule_ms={m.schedule_ms} plan_overlap_ms="
              f"{m.plan_overlap_ms} ({card})")
    if len(hist) != 3:
        raise AssertionError(f"{len(hist)} training steps, want 3")
    if not all(torch.isfinite(t).all() for t in tree_leaves(
            eng.state.params)):
        raise AssertionError("parameters are not finite after 3 steps")
    print(f"  ssm train max_memory_allocated_bytes = {peak} ({card})")
    print(f"  ssm train group shapes (n_seqs, bucket): {groups}")
    print(f"  ssm train K3 launches: forward {n_fwd}, backward {n_bwd}")

    # k3_cb forms C B^T for both directions: its time is neither's alone
    prof = profile_step(eng, run, card, "ssm train",
                        {"k3_fwd": "k3_fwd", "k3_bwd": "k3_bwd",
                         "k3_cb": "k3_cb"},
                        ranges=(INTER_CHUNK,))
    inter = [e for e in prof.key_averages() if e.key == INTER_CHUNK]
    if inter:
        # kernel time launched inside the forward ranges (the backward of
        # the inter-chunk part runs outside them; phase 14 times both)
        ev = inter[0]
        dev_ms = getattr(ev, "device_time_total",
                         getattr(ev, "cuda_time_total", 0.0)) / 1e3
        print(f"  ssm train {INTER_CHUNK} forward kernels: {ev.count} "
              f"calls, device_ms={dev_ms} ({card})")
    eng.close()
    shapes = {}
    for g in groups:
        shapes[g] = shapes.get(g, 0) + 1
    return n_fwd, n_bwd, shapes, eng.cfg.n_layers, s.chunk


def phase_ssd_path(dev, card, shapes, n_layers, chunk):
    """K3 forward and backward vs plain at each (n_seqs, bucket) shape of
    the SSM training run (its buffers are padded to a chunk multiple)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    for (n_seqs, bucket), n_groups in sorted(shapes.items()):
        S = -(-bucket // chunk) * chunk
        row = check_ssd(dev, card, gen, n_seqs, S, SSD_HEADS, SSD_N, SSD_P,
                        chunk, torch.bfloat16, "train")
        row["launches"] = n_layers * n_groups
        row["bucket"] = bucket
        rows.append(row)
    return rows


# ------------------------------------------------------------ kernel K4
#: K4 against its plain version run in fp64 on the same inputs: fp32 h,
#: da, db within RG_TOL[fp32] * max(1, |plain|) (the state is carried in
#: fp32; the chunked scan composes the same products in another order),
#: bf16 within RG_TOL[bf16] (one bf16 rounding of the output, and da is
#: formed from the saved bf16 h)
RG_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
RG_WIDTH = 2560                      # recurrentgemma-2b's lru_width


def rglru_bound(B, S, W, dtype, backward):
    """Least time for the same work: a and b read and h written once
    (backward: a, dh, h read, da and db written), against 2 flops an
    element forward (3 backward) at the fp32 peak."""
    elt = torch.finfo(dtype).bits // 8
    n = B * S * W
    nbytes = elt * n * (5 if backward else 3)
    flops = (3 if backward else 2) * n
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[torch.float32]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_rglru(dev, card, gen, B, S, W, dtype, tag, time_it=True):
    """K4 forward and backward vs plain (fp64) on one random input: a as
    the model's gates make it, in (0.3, 0.999); times kernel and plain
    (the plain loops in the input type)."""
    from repro_torch.kernels.rglru_scan import (rglru_scan, rglru_scan_bwd,
                                                rglru_scan_bwd_plain,
                                                rglru_scan_plain)
    a = (0.3 + 0.699 * torch.rand(B, S, W, generator=gen,
                                  device=dev)).to(dtype)
    b = torch.randn(B, S, W, generator=gen, device=dev).to(dtype)
    dh = torch.randn(B, S, W, generator=gen, device=dev).to(dtype)
    h = rglru_scan(a, b)
    da, db = rglru_scan_bwd(a, h, dh)
    rh = rglru_scan_plain(a.double(), b.double())
    rda, rdb = rglru_scan_bwd_plain(a.double(), rh, dh.double())
    torch.cuda.synchronize()
    errs = {}
    for name, x, r in (("h", h, rh), ("da", da, rda), ("db", db, rdb)):
        if not torch.isfinite(x).all():
            raise AssertionError(f"K4 {tag}: {name} is not finite")
        diff = (x.double() - r).abs()
        errs[name] = (diff.max().item(),
                      (diff / r.abs().clamp_min(1.0)).max().item())
        if not errs[name][1] <= RG_TOL[dtype]:
            raise AssertionError(
                f"K4 disagrees with its plain version ({tag} B={B} S={S} "
                f"W={W} {dtype}): {name} max|err|/max(1,|ref|) "
                f"{errs[name][1]} > {RG_TOL[dtype]}")
    del rh, rda, rdb
    row = dict(tag=tag, B=B, S=S, W=W, dtype=str(dtype).split(".")[-1],
               err={n: e[1] for n, e in errs.items()},
               max_abs_err_fwd=errs["h"][0],
               max_abs_err_bwd=max(errs["da"][0], errs["db"][0]))
    if time_it:
        for which, fn in (("fwd", lambda: rglru_scan(a, b)),
                          ("bwd", lambda: rglru_scan_bwd(a, h, dh))):
            row[f"{which}_ms"] = cuda_ms(fn, iters=20)
            row[f"{which}_device_ms"] = device_ms(fn, iters=20,
                                                  each_once=True)[0]
        row["plain_fwd_ms"] = cuda_ms(lambda: rglru_scan_plain(a, b),
                                      iters=2, warmup=1)
        row["plain_bwd_ms"] = cuda_ms(lambda: rglru_scan_bwd_plain(a, h, dh),
                                      iters=2, warmup=1)
        for which in ("fwd", "bwd"):
            bnd, by = rglru_bound(B, S, W, dtype, which == "bwd")
            row[f"bound_{which}_ms"], row[f"bound_{which}_by"] = bnd, by
    print(f"  K4 {json.dumps(row)} ({card})")
    return row


def phase_rglru(dev, card):
    gen = torch.Generator(device=dev).manual_seed(6)
    rows = []
    for dt in (torch.float32, torch.bfloat16):
        # one 4096-token row at recurrentgemma-2b's width; a ragged shape
        rows.append(check_rglru(dev, card, gen, 1, 4096, RG_WIDTH, dt,
                                "full"))
        rows.append(check_rglru(dev, card, gen, 3, 100, 300, dt, "ragged",
                                time_it=False))
    return rows


# ------------------------------------------------- K1 at head_dim 256
RG_HEADS = (10, 1, 256)              # recurrentgemma-2b: MQA, D = 256
RG_WINDOW = 2048


def hybrid_tables(n_rows, S, frame, text=32):
    """The padded hybrid batch's tables: one segment per row (no segment
    table is emitted; attention takes segment 0 everywhere) and span ids
    of `frame`-token bidirectional blocks after every `text` causal
    tokens."""
    _, span = packed_layout(S, [S], frame, text)
    return (np.zeros((n_rows, S), np.int32),
            np.repeat(span[None], n_rows, axis=0))


def phase_packed_wide(dev, card):
    """K1 in bf16 at recurrentgemma-2b's heads, sliding at its window,
    against the plain versions with phase 7's limits."""
    from repro_torch.kernels.flash_attention_packed import (
        last_bwd_kv_launch, last_fwd_launch)
    gen = torch.Generator(device=dev).manual_seed(7)
    bf16 = torch.bfloat16
    rows = []
    seg, span = hybrid_tables(1, 4096, 256)
    rows.append(check_packed(dev, card, gen, 4096, bf16, seg, span,
                             mode="sliding", window=RG_WINDOW,
                             tag="synthetic", heads=RG_HEADS))
    # the hybrid path's shape: one 4096-token row, 10:1 heads, D = 256;
    # the launches as the library recorded them
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for which, stage, launch in (("fwd", K1_FWD_STAGE, last_fwd_launch),
                                 ("bwd", K1_BWD_STAGE, last_bwd_kv_launch)):
        facts = dict(stage=stage, **launch(), sms=sms)
        print(f"  K1 {which} design at S=4096 H={RG_HEADS[0]} "
              f"Hkv={RG_HEADS[1]} D={RG_HEADS[2]} {json.dumps(facts)} "
              f"({card})")
    rows.append(check_packed(dev, card, gen, 4096, bf16, seg, None,
                             mode="sliding", window=RG_WINDOW,
                             tag="synthetic", heads=RG_HEADS))
    # a span longer than the window
    seg, span = hybrid_tables(2, 1024, 300, text=100)
    rows.append(check_packed(dev, card, gen, 1024, bf16, seg, span,
                             mode="sliding", window=128, tag="long span",
                             heads=RG_HEADS))
    return rows


# ------------------------------------------------ the hybrid family
def hybrid_launches(cfg):
    """Kernel launches of one group of the hybrid family: {kernel:
    (forward, backward)} for K4 (the recurrent layers) and K1 (the
    attention layers); remat runs each unit's layers forward twice, the
    tail's once."""
    from repro_torch.models.transformer import hybrid_layout
    n_units, tail = hybrid_layout(cfg)
    runs = 2 if cfg.remat else 1
    out = {}
    for kind, kernel in (("rec", "k4"), ("attn", "k1")):
        per_unit = cfg.hybrid.pattern.count(kind)
        n_tail = tail.count(kind)
        out[kernel] = (runs * n_units * per_unit + n_tail,
                       n_units * per_unit + n_tail)
    return out


def _k4_k1_counts():
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed, flash_attention_packed_bwd)
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
    return {"k4": (rglru_scan.launches, rglru_scan_bwd.launches),
            "k1": (flash_attention_packed.launches,
                   flash_attention_packed_bwd.launches)}


def _zero_k4_k1_counts():
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed, flash_attention_packed_bwd)
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
    for fn in (rglru_scan, rglru_scan_bwd, flash_attention_packed,
               flash_attention_packed_bwd):
        fn.launches = 0


def phase_hybrid_parity(dev):
    """Reduced recurrentgemma-2b, fp32: the first batch's loss and
    gradient and two training steps through K4 and K1 vs through their
    plain versions, then the next batch's loss and gradient through both
    at the parameters the kernel path reached. (Phases 8 and 12 take
    each path's gradient at its own parameters. Here AdamW's first step,
    lr x g / (|g| + 1e-8), sets elements whose gradient lies within the
    paths' 1e-7 difference of 0 up to 2 lr apart, and the gradient at
    parameters that far apart differs by about 1e-4: a difference of
    the parameters, not of the kernels, so both paths take the same
    parameters there.)"""
    from repro_torch.api import Engine
    from repro_torch.data.pipeline import HeterogeneousLoader
    from repro_torch.training import TrainState
    from repro_torch.training.optimizer import tree_leaves, tree_map

    run = dict(dataset="openvid", global_batch=8, max_tokens=512,
               tokens_per_frame=16)
    out = {}
    params0 = None
    for impl in ("cuda", "reference"):
        eng = Engine("recurrentgemma-2b", reduced=True, seed=0)
        eng.cfg = eng.cfg.with_(attn_impl=impl)
        if params0 is None:
            params0 = eng.state.params
        eng.state = TrainState(params=tree_map(torch.clone, params0))
        data = next(HeterogeneousLoader(run["dataset"], 8, eng.cfg.vocab,
                                        seed=0, max_tokens=512,
                                        tokens_per_frame=16))
        _zero_k4_k1_counts()
        loss0, grads0 = eng.executor.run_plan(eng.state.params,
                                              eng.plan(data), data)
        n = _k4_k1_counts()
        groups = len(eng.executor.last_exe_keys)
        hist = eng.train(steps=2, lookahead=False, **run)
        out[impl] = ([float(loss0)] + [m.loss for m in hist], [grads0],
                     eng.state.params, eng)
        want = {k: ((f * groups, b * groups) if impl == "cuda" else (0, 0))
                for k, (f, b) in hybrid_launches(eng.cfg).items()}
        if n != want:
            raise AssertionError(f"{impl}: K4/K1 launches {n}, want {want} "
                                 f"for {groups} groups")
    for impl in ("cuda", "reference"):
        eng = out[impl][3]
        data2 = next(eng.loader)
        loss2, grads2 = eng.executor.run_plan(out["cuda"][2],
                                              eng.plan(data2), data2)
        eng.close()
        out[impl][0].append(float(loss2))
        out[impl][1].append(grads2)
    (ls, gs, p, _), (rls, rgs, rp, _) = out["cuda"], out["reference"]
    lerr = max(abs(a - b) for a, b in zip(ls, rls))
    gerr = [max((a - b).abs().max().item()
                for a, b in zip(tree_leaves(g), tree_leaves(rg)))
            for g, rg in zip(gs, rgs)]
    perr = max((a - b).abs().max().item()
               for a, b in zip(tree_leaves(p), tree_leaves(rp)))
    print(f"  losses kernel {ls} plain {rls}: max diff {lerr}; grads max "
          f"diff {gerr[0]} (first batch), {gerr[1]} (next batch at the "
          f"kernel path's parameters after 2 steps); params after 2 steps "
          f"max diff {perr}")
    if not (lerr <= 1e-4 and max(gerr) <= 1e-4):
        raise AssertionError("hybrid training through K4 and K1 differs "
                             "from the plain path by more than 1e-4")


def phase_hybrid_training(dev, card):
    """Full-width recurrentgemma-2b DHP training; returns ({kernel:
    (launches fwd, bwd)}, the K4 shapes {(n_seqs, bucket): groups}, the
    K1 group tables by (n_seqs, bucket, spans), launches per group)."""
    import gc

    from repro_torch.api import ClusterSpec, Engine
    from repro_torch.data.pipeline import HeterogeneousLoader
    from repro_torch.training.optimizer import tree_leaves

    run = dict(dataset="openvid", global_batch=8, max_tokens=4096,
               tokens_per_frame=256)
    t0 = time.perf_counter()
    eng = Engine("recurrentgemma-2b", ClusterSpec.auto(mem_budget=4096),
                 seed=0)
    params = eng.state.params
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    c, h = eng.cfg, eng.cfg.hybrid
    print(f"  recurrentgemma-2b: {c.n_layers} layers {h.pattern} d_model "
          f"{c.d_model} lru_width {h.lru_width} heads {c.n_heads}/"
          f"{c.kv_heads}x{c.resolved_head_dim} window {h.window} d_ff "
          f"{c.d_ff} vocab {c.vocab}, {n_params} params "
          f"{c.param_dtype}, remat {c.remat}, init "
          f"{time.perf_counter() - t0:.1f} s")
    plans = []
    # each step's groups (n_seqs, bucket), its peak memory, the caching
    # allocator's retries (every cached block freed and the allocation
    # tried again) and the time the garbage collector held the
    # interpreter
    per_step = []
    execute = eng.execute
    gc_s = [0.0, None]

    def gc_clock(phase, info):
        if phase == "start":
            gc_s[1] = time.perf_counter()
        elif gc_s[1] is not None:
            gc_s[0] += time.perf_counter() - gc_s[1]

    def counted_execute(plan, data):
        torch.cuda.reset_peak_memory_stats(dev)
        retries = torch.cuda.memory_stats(dev).get("num_alloc_retries", 0)
        gc_s[0] = 0.0
        m = execute(plan, data)
        per_step.append(dict(
            groups=[k[3:5] for k in eng.executor.last_exe_keys],
            peak=torch.cuda.max_memory_allocated(dev), gc_ms=gc_s[0] * 1e3,
            alloc_retries=torch.cuda.memory_stats(dev).get(
                "num_alloc_retries", 0) - retries))
        return m
    eng.execute = counted_execute
    gc.callbacks.append(gc_clock)
    _zero_k4_k1_counts()
    try:
        hist = eng.train(steps=3, lookahead=True, plan_log=plans,
                         trace=True, **run)
    finally:
        eng.execute = execute
        gc.callbacks.remove(gc_clock)
    torch.cuda.synchronize()
    counts = _k4_k1_counts()
    peak = max(st["peak"] for st in per_step)

    tracer = eng.last_tracer
    if tracer.dropped:
        raise AssertionError(f"the tracer dropped {tracer.dropped} events")
    spans = [e for e in tracer.to_json()["traceEvents"]
             if e.get("name") == "execute"]
    groups = [(e["args"]["n_seqs"], e["args"]["bucket"], e["args"]["spans"])
              for e in spans]
    # each group's span (run synchronously under trace), in step order
    group_ms = iter(e["dur"] / 1e3 for e in spans)
    per_group = hybrid_launches(eng.cfg)
    want = {k: (f * len(groups), b * len(groups))
            for k, (f, b) in per_group.items()}
    if counts != want or not groups:
        raise AssertionError(f"K4/K1 launches {counts}, want {want} for "
                             f"{len(groups)} groups of {per_group}")
    for m, st in zip(hist, per_step):
        if not math.isfinite(m.loss):
            raise AssertionError(f"step {m.step}: loss {m.loss}")
        tok_s = m.tokens / m.step_time_s
        print(f"  hybrid train step {m.step}: loss={m.loss} "
              f"step_time_s={m.step_time_s} tokens={m.tokens} "
              f"tokens_per_s={tok_s} padding_efficiency="
              f"{m.padding_efficiency} degrees={m.degree_histogram} "
              f"groups={sum(m.degree_histogram.values())} "
              f"schedule_ms={m.schedule_ms} plan_overlap_ms="
              f"{m.plan_overlap_ms} (n_seqs, bucket)={st['groups']} "
              f"group_ms={[next(group_ms) for _ in st['groups']]} "
              f"peak_bytes={st['peak']} gc_ms={st['gc_ms']} "
              f"alloc_retries={st['alloc_retries']} ({card})")
    if len(hist) != 3:
        raise AssertionError(f"{len(hist)} training steps, want 3")
    if not all(torch.isfinite(t).all() for t in tree_leaves(
            eng.state.params)):
        raise AssertionError("parameters are not finite after 3 steps")
    print(f"  hybrid train max_memory_allocated_bytes = {peak} ({card})")
    print(f"  hybrid train group shapes (n_seqs, bucket, spans): {groups}")
    print(f"  hybrid train launches {counts} = {len(groups)} groups x "
          f"{per_group} (forward, backward)")

    # the tables of every group, rebuilt from the run's plans and batches
    loader = HeterogeneousLoader(run["dataset"], run["global_batch"],
                                 eng.cfg.vocab, seed=eng.seed,
                                 max_tokens=run["max_tokens"],
                                 tokens_per_frame=run["tokens_per_frame"])
    tables = {}
    for plan in plans:
        data = next(loader)
        spans_by_id = data.spans_by_id()
        for mb in plan.micro_batches:
            for g in mb.groups:
                b, _, _, bucket = eng.executor._group_batch(
                    [data.by_id(i) for i in g.seq_ids], g.degree,
                    spans=[spans_by_id.get(i) for i in g.seq_ids])
                key = (len(g.seq_ids), bucket, "modality_ids" in b)
                tables.setdefault(key, []).append(b.get("modality_ids"))
    if sorted(tables) != sorted(set(groups)) or \
            sum(map(len, tables.values())) != len(groups):
        raise AssertionError(f"rebuilt groups {sorted(tables)} differ from "
                             f"the run's {sorted(set(groups))}")

    profile_step(eng, run, card, "hybrid train",
                 {"k4": "k4_", "k4_fwd": "k4_fwd", "k4_bwd": "k4_bwd",
                  "k1": "packed_", "k1_fwd": "packed_fwd",
                  "k1_bwd": "packed_bwd", "k1_bwd_sum": "bwd_kv_reduce"})
    eng.close()
    del eng, params
    gc.collect()
    return counts, tables, per_group


def phase_hybrid_path(dev, card, tables, per_group):
    """K4 (fp32, as the gates make a and b) and K1 (bf16, D = 256,
    sliding 2048) forward and backward vs plain at every shape of the
    hybrid run, K1 on the first group's own span table of that shape."""
    gen = torch.Generator(device=dev).manual_seed(8)
    k4_rows, k1_rows = [], []
    shapes = {}
    for (n_seqs, bucket, _), groups in tables.items():
        shapes[(n_seqs, bucket)] = shapes.get((n_seqs, bucket), 0) + \
            len(groups)
    for (n_seqs, bucket), n_groups in sorted(shapes.items()):
        row = check_rglru(dev, card, gen, n_seqs, bucket, RG_WIDTH,
                          torch.float32, "train")
        row["launches"] = tuple(n * n_groups for n in per_group["k4"])
        k4_rows.append(row)
    for (n_seqs, bucket, spans), groups in sorted(tables.items()):
        span = groups[0]
        seg = np.zeros((n_seqs, bucket), np.int32)
        row = check_packed(dev, card, gen, bucket, torch.bfloat16, seg,
                           span, mode="sliding", window=RG_WINDOW,
                           tag="train", heads=RG_HEADS)
        row["launches"] = tuple(n * len(groups) for n in per_group["k1"])
        k1_rows.append(row)
        torch.cuda.empty_cache()
    return k4_rows, k1_rows


# ------------------------------------------------ ring context parallelism
#: the ring's function-level cases: (heads, mode, window, degrees)
RING_SHAPES = (((H, HKV, D), "causal", None, (2, 3, 4)),
               (RG_HEADS, "sliding", RG_WINDOW, (2, 3)))
#: phase 20's engine: ranks on the one card and the budget (tokens a
#: rank) at which the openvid stream's first plans hold degrees 2 and 3
#: (at 4 ranks no budget plans a degree 3 in its first three batches)
RING_RANKS, RING_BUDGET = 6, 1408
#: one batch's DHP plan (rings) against its static plan at degree 1 on
#: the same parameters: the loss within RING_LOSS_RTOL relative, the
#: gradient within RING_GRAD_RTOL (max over leaves of max|diff| /
#: max|g|). Two degree-1 runs gave the same loss bits (the forward is
#: deterministic) and gradients 0.0159 apart (K1's dQ atomics); the
#: rings read 1.77e-5 and 0.0296 (H100, PR 24); the planted ring faults
#: of tests/test_torch_cuda.py read 0.57-1.0 on dK / dV
RING_LOSS_RTOL = 1e-3
RING_GRAD_RTOL = 0.1


def _ring_rows(t, d):
    """[1, S, ...] -> the LocalRing's [d, S / d, ...]: row r is rank r's
    contiguous shard."""
    return t.reshape(d, t.shape[1] // d, *t.shape[2:])


def _ring_errs(got, want):
    """{name: (max|err| / max(1, |ref|), max|err| / max|ref|)}."""
    return {n: _scaled_err(got[n], want[n])[1:] for n in got}


def _ring_hold(what, errs):
    for name, (scaled, whole) in errs.items():
        tol = TOL[torch.bfloat16] if name == "o" else \
            GRAD_TOL[torch.bfloat16]
        if not (math.isfinite(scaled) and scaled <= tol
                and whole <= REL_TOL_BF16):
            raise AssertionError(f"{what}: {name} max|err|/max(1,|ref|) "
                                 f"{scaled} (limit {tol}), max|err|/max|ref| "
                                 f"{whole} (limit {REL_TOL_BF16})")


def ring_device_ms(fn, iters: int = 5):
    """{device ms a call, of it K1's kernels ("packed_" in the name), the
    kernels a call} of `fn`, from torch.profiler's trace of `iters`
    calls after one more: what the card spends beside the host's cost
    that `cuda_ms` includes."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [(ev.name, ev.time_range.elapsed_us() / 1e3)
           for ev in prof.events()
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        raise AssertionError("torch.profiler traced no device time")
    return dict(total=sum(t for _, t in evs) / iters,
                k1=sum(t for n, t in evs if "packed_" in n) / iters,
                kernels=len(evs) / iters)


def check_ring(dev, card, gen, seg, span, heads, mode, window, d):
    """ring_attention in a LocalRing of degree d on the card, forward (o,
    lse) and backward (dq, dk, dv), against K1 unsharded on the same
    inputs and against the same ring on the plain versions (CPU tensors);
    one hop's K1 backward under the merged o and lse against the plain
    backward; the ring's forward + backward ms beside K1 unsharded's."""
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed, flash_attention_packed_bwd,
        flash_attention_packed_bwd_ref)
    from repro_torch.parallel import LocalRing, ring_attention
    Hq, Hkv, Dh = heads
    pad = (-len(seg)) % d                # the bucket, a multiple of d
    seg = np.concatenate([seg, np.full(pad, -1, np.int32)])
    span = np.concatenate([span, np.full(pad, -1, np.int32)])
    S, S_loc = len(seg), len(seg) // d
    bf16 = torch.bfloat16
    q, do = (torch.randn(1, S, Hq, Dh, generator=gen, device=dev).to(bf16)
             for _ in range(2))
    k, v = (torch.randn(1, S, Hkv, Dh, generator=gen, device=dev).to(bf16)
            for _ in range(2))
    segt = torch.as_tensor(seg, device=dev)[None]
    spant = torch.as_tensor(span, device=dev)[None]
    kw = dict(mode=mode, window=window)

    def unsharded():
        o, lse = flash_attention_packed(q, k, v, segt, span_ids=spant,
                                        return_lse=True, **kw)
        return (o, lse) + tuple(flash_attention_packed_bwd(
            q, k, v, o, lse, do, segt, span_ids=spant, **kw))

    def ring(device):
        x = [_ring_rows(t, d).to(device) for t in (q, k, v, do, segt,
                                                   spant)]
        qs, ks, vs = (t.detach().requires_grad_(True) for t in x[:3])
        o, lse = ring_attention(qs, ks, vs, x[4], ring=LocalRing(d),
                                span_ids=x[5], return_lse=True, **kw)
        grads = torch.autograd.grad(o, (qs, ks, vs), x[3])
        return (o.detach(), lse) + grads

    def whole(out):
        """The ring's rows back in the unsharded layout."""
        o, lse, dq, dk, dv = (t.to(dev) for t in out)
        flat = lambda t: t.reshape(1, S, *t.shape[2:])  # noqa: E731
        return dict(o=flat(o), lse=lse.permute(1, 0, 2).reshape(1, Hq, S),
                    dq=flat(dq), dk=flat(dk), dv=flat(dv))

    want = dict(zip(("o", "lse", "dq", "dk", "dv"), unsharded()))
    n0 = (flash_attention_packed.launches,
          flash_attention_packed_bwd.launches)
    got = whole(ring(dev))
    torch.cuda.synchronize()
    launches = (flash_attention_packed.launches - n0[0],
                flash_attention_packed_bwd.launches - n0[1])
    if launches != (2 * d - 1,) * 2:     # hop 0 once, then two a hop
        raise AssertionError(f"ring d={d}: K1 launches {launches}, want "
                             f"{2 * d - 1} each way")
    plain = whole(ring("cpu"))
    names = ("o", "dq", "dk", "dv")
    tag = f"ring d={d} H={Hq} Hkv={Hkv} D={Dh} {mode} window={window}"
    errs = {"vs_k1": _ring_errs({n: got[n] for n in names}, want),
            "vs_plain_ring": _ring_errs({n: got[n] for n in names}, plain)}
    _ring_hold(f"{tag} against K1 unsharded", errs["vs_k1"])
    _ring_hold(f"{tag} against the ring on the plain versions",
               errs["vs_plain_ring"])
    fin = torch.isfinite(want["lse"])
    if not torch.equal(fin, torch.isfinite(got["lse"])):
        raise AssertionError(f"{tag}: rows with keys differ (LSE)")
    lse_err = (got["lse"][fin] - want["lse"][fin]).abs().max().item()
    if not lse_err <= 1e-3:
        raise AssertionError(f"{tag}: LSE off by {lse_err}")

    # one hop under the merged o and lse: the last rank's queries against
    # shard 0's keys (wrapped: offset -(d - 1) S_loc), kernel vs plain
    r = d - 1
    rows = lambda t: _ring_rows(t, d)    # noqa: E731
    hop = (rows(q)[r:], rows(k)[:1], rows(v)[:1],
           rows(got["o"])[r:].contiguous(),
           got["lse"].reshape(1, Hq, d, S_loc)[:, :, r].contiguous(),
           rows(do)[r:], rows(segt)[r:])
    hkw = dict(span_ids=rows(spant)[r:], kv_segment_ids=rows(segt)[:1],
               kv_span_ids=rows(spant)[:1], kv_offset=-r * S_loc, **kw)
    hop_k = flash_attention_packed_bwd(*hop, **hkw)
    hop_p = flash_attention_packed_bwd_ref(*hop, **hkw)
    errs["hop_bwd_vs_plain"] = _ring_errs(dict(zip(names[1:], hop_k)),
                                          dict(zip(names[1:], hop_p)))
    _ring_hold(f"{tag}: one hop's K1 backward under the merged o and lse",
               errs["hop_bwd_vs_plain"])

    ring_ms = cuda_ms(lambda: ring(dev), iters=5, warmup=1)
    k1_ms = cuda_ms(unsharded, iters=5, warmup=1)
    ring_dev = ring_device_ms(lambda: ring(dev))
    k1_dev = ring_device_ms(unsharded)
    row = dict(tag=tag, d=d, S=S, S_loc=S_loc, H=Hq, Hkv=Hkv, D=Dh,
               mode=mode, window=window, launches_fwd_bwd=launches,
               err=errs, lse_err=lse_err, ring_fwd_bwd_ms=ring_ms,
               k1_unsharded_fwd_bwd_ms=k1_ms,
               ring_fwd_bwd_device_ms=ring_dev,
               k1_unsharded_fwd_bwd_device_ms=k1_dev,
               max_abs_err=max(_scaled_err(got[n], want[n])[0]
                               for n in names))
    print(f"  ring {json.dumps(row)} ({card})")
    return row


def phase_ring(dev, card, tables):
    """Ring CP at function level, bf16, on one full-width openvid
    4096-token packed layout (phase 9's, with segments and spans)."""
    if (4096, True) not in tables:
        raise AssertionError(f"no 4096-token group with spans in phase 9's "
                             f"run: {sorted(tables)}")
    seg, span = tables[(4096, True)][0]
    gen = torch.Generator(device=dev).manual_seed(9)
    rows = []
    for heads, mode, window, degrees in RING_SHAPES:
        for d in degrees:
            rows.append(check_ring(dev, card, gen, seg, span, heads, mode,
                                   window, d))
            torch.cuda.empty_cache()
    return rows


def _max_rel_diff(a, b):
    """max over leaves of max|a - b| / max|b|."""
    from repro_torch.training.optimizer import tree_leaves
    return max(((x - y).abs().max() / y.abs().max().clamp_min(1e-30)).item()
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def phase_ring_training(dev, card):
    """Full-width internvl3-2b DHP training with RING_RANKS ranks on the
    one card, so that groups of degree > 1 run as rings: one batch's DHP
    plan against its static plan at degree 1 (twice), then 3 steps.
    Returns the K1 launches (forward, backward) of the 3 steps."""
    import gc

    from repro_torch.api import ClusterSpec, Engine
    from repro_torch.core.scheduler import static_plan
    from repro_torch.data.pipeline import HeterogeneousLoader
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed, flash_attention_packed_bwd)
    from repro_torch.training.optimizer import tree_leaves

    run = dict(dataset="openvid", global_batch=8, max_tokens=4096,
               tokens_per_frame=256)
    eng = Engine("internvl3-2b", ClusterSpec(devices=[dev] * RING_RANKS,
                                             mem_budget=RING_BUDGET), seed=0)
    params = eng.state.params
    L = eng.cfg.n_layers
    runs = 2 if eng.cfg.remat else 1

    # the stream's first batch before any update: its DHP plan against
    # its static plan at degree 1, run twice (K1's dQ atomics make the
    # two gradients differ; the forward is the same bits)
    data = next(HeterogeneousLoader(
        run["dataset"], run["global_batch"], eng.cfg.vocab, seed=eng.seed,
        max_tokens=run["max_tokens"],
        tokens_per_frame=run["tokens_per_frame"]))
    plan = eng.plan(data)
    flat = static_plan(data.infos, eng.cost_model, RING_RANKS, 4096.0)
    if any(g.degree != 1 for mb in flat.micro_batches for g in mb.groups):
        raise AssertionError("the static plan is not at degree 1")
    l1, g1 = eng.executor.run_plan(params, flat, data)
    l1b, g1b = eng.executor.run_plan(params, flat, data)
    spread = (abs(float(l1) - float(l1b)), _max_rel_diff(g1b, g1))
    del g1b
    ld, gd = eng.executor.run_plan(params, plan, data)
    keys = list(eng.executor.last_exe_keys)
    diff = (abs(float(ld) - float(l1)), _max_rel_diff(gd, g1))
    del gd, g1
    torch.cuda.empty_cache()
    rel = diff[0] / abs(float(l1))
    print(f"  ring batch 0: DHP plan {plan.degree_histogram} keys {keys} "
          f"loss {float(ld)}; static plan at degree 1 loss {float(l1)} and "
          f"{float(l1b)}: degree-1 spread loss {spread[0]} gradient "
          f"max|diff|/max|g| {spread[1]}; DHP vs degree 1 loss |diff| "
          f"{diff[0]} (relative {rel}) gradient max|diff|/max|g| {diff[1]} "
          f"({card})")
    if max(k[2] for k in keys) < 2:
        raise AssertionError(f"batch 0's plan holds no ring: {keys}")
    if not (math.isfinite(float(ld)) and rel <= RING_LOSS_RTOL):
        raise AssertionError(f"ring loss {float(ld)} against degree 1 "
                             f"{float(l1)}: relative {rel} > "
                             f"{RING_LOSS_RTOL}")
    if not diff[1] <= RING_GRAD_RTOL:
        raise AssertionError(f"ring gradient against degree 1: "
                             f"{diff[1]} > {RING_GRAD_RTOL}")

    plans, per_step = [], []
    execute = eng.execute

    def counted_execute(plan, data):
        torch.cuda.reset_peak_memory_stats(dev)
        n0 = (flash_attention_packed.launches,
              flash_attention_packed_bwd.launches)
        m = execute(plan, data)
        per_step.append(dict(
            keys=list(eng.executor.last_exe_keys),
            peak=torch.cuda.max_memory_allocated(dev),
            launches=(flash_attention_packed.launches - n0[0],
                      flash_attention_packed_bwd.launches - n0[1])))
        return m
    eng.execute = counted_execute
    flash_attention_packed.launches = 0
    flash_attention_packed_bwd.launches = 0
    try:
        hist = eng.train(steps=3, lookahead=True, plan_log=plans, **run)
    finally:
        eng.execute = execute
    torch.cuda.synchronize()
    counts = (flash_attention_packed.launches,
              flash_attention_packed_bwd.launches)
    if len(hist) != 3:
        raise AssertionError(f"{len(hist)} training steps, want 3")
    degrees = set()
    for m, st in zip(hist, per_step):
        if not math.isfinite(m.loss):
            raise AssertionError(f"ring step {m.step}: loss {m.loss}")
        hops = sum(2 * k[2] - 1 for k in st["keys"])
        want = (runs * L * hops, L * hops)
        if st["launches"] != want:
            raise AssertionError(f"ring step {m.step}: K1 launches "
                                 f"{st['launches']}, want {want} for "
                                 f"{st['keys']}")
        degrees |= set(m.degree_histogram)
        print(f"  ring train step {m.step}: loss={m.loss} step_time_s="
              f"{m.step_time_s} tokens={m.tokens} tokens_per_s="
              f"{m.tokens / m.step_time_s} padding_efficiency="
              f"{m.padding_efficiency} degrees={m.degree_histogram} "
              f"k1_launches_fwd_bwd={st['launches']} peak_bytes="
              f"{st['peak']} keys={st['keys']} ({card})")
    if not {2, 3} <= degrees:
        raise AssertionError(f"the plans' degrees {sorted(degrees)} lack 2 "
                             f"or 3")
    if sum(counts) == 0 or counts != tuple(
            sum(st["launches"][i] for st in per_step) for i in (0, 1)):
        raise AssertionError(f"K1 launches {counts} over the 3 steps")
    if not all(torch.isfinite(t).all() for t in tree_leaves(
            eng.state.params)):
        raise AssertionError("parameters are not finite after 3 steps")
    print(f"  ring train max_memory_allocated_bytes = "
          f"{max(st['peak'] for st in per_step)}; K1 launches {counts} "
          f"over 3 steps ({card})")
    eng.close()
    del eng, params
    gc.collect()
    return counts


# ------------------------------------------------ state-cache serving
STATE_ARCHS = ("mamba2-370m", "recurrentgemma-2b")
#: decode_step logits against forward, x max(1, |forward|) (the JAX
#: package's test_ssm_decode_equals_chunked_scan and
#: test_hybrid_decode_equals_forward)
DECODE_TOL = 2e-3
SLIDING_WINDOW = 16
#: (prompt length, new tokens) at slots=2: requests 2 and 3 wait for a
#: slot that an earlier request frees
STATE_PARITY_REQUESTS = ((21, 4), (5, 6), (1, 3), (9, 5))


def _all_kernel_counts():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_bwd
    counts = {"k2": flash_attention.launches,
              "k3": (ssd_chunk.launches, ssd_chunk_bwd.launches)}
    counts.update(_k4_k1_counts())
    return counts


def _zero_all_kernel_counts():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ssd_chunk import ssd_chunk, ssd_chunk_bwd
    for fn in (flash_attention, ssd_chunk, ssd_chunk_bwd):
        fn.launches = 0
    flash_attention.launches_by = {}
    _zero_k4_k1_counts()


def _parity_trace(vocab, rng):
    from repro_torch.serving.scheduler import ServeRequest
    return [ServeRequest(request_id=i,
                         tokens=rng.integers(0, vocab, size=L,
                                             dtype=np.int32),
                         max_new_tokens=n)
            for i, (L, n) in enumerate(STATE_PARITY_REQUESTS)]


def _decode_logits(params, cfg, toks, cache_len):
    """decode_step's logits [B, S, V] over toks [B, S] from a zero
    cache."""
    from repro_torch.models import model as tm
    cache = tm.init_cache(cfg, toks.shape[0], cache_len, device=toks.device)
    out = []
    for t in range(toks.shape[1]):
        logits, cache = tm.decode_step(params, cfg, cache, toks[:, t])
        out.append(logits)
    return torch.stack(out, dim=1)


def _forward_logits(params, cfg, toks):
    """forward's logits with one segment a row, so that attention runs
    K1 (K2 takes no head_dim of 256)."""
    from repro_torch.models import model as tm
    seg = torch.zeros(toks.shape, dtype=torch.int32, device=toks.device)
    with torch.no_grad():
        logits, _ = tm.forward(params, cfg, {"tokens": toks,
                                             "segment_ids": seg})
    return logits


def _scaled_max(got, want) -> float:
    got, want = got.double(), want.double()
    return ((got - want).abs() / want.abs().clamp_min(1.0)).max().item()


def phase_state_parity(dev, card):
    """Reduced mamba2-370m and recurrentgemma-2b (fp32, kernels on): the
    ServingEngine's streams (slots=2, a slot reused) against
    greedy_generate from a fresh cache and each prompt's last token, and
    80 decode_step logits (past the hybrid's window of 64) against
    forward through the kernels. Then reduced internvl3-2b as dense with
    a sliding window of SLIDING_WINDOW: streams against the exact-length
    prefill and greedy_generate, K2's launches in that run, and K2 vs
    plain at each exact length it ran. Returns (K2 launches, rows)."""
    from repro_torch.api import Engine
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import model as tm
    from repro_torch.serving.serve_step import greedy_generate

    rng = np.random.default_rng(1)
    for arch in STATE_ARCHS:
        cfg = get_config(arch).reduced().with_(attn_impl="cuda")
        eng = Engine(cfg, seed=0)
        params = eng.state.params
        trace = _parity_trace(cfg.vocab, rng)
        rep = eng.serving(slots=2).run(trace)
        for m in rep.requests:
            r = trace[m.request_id]
            cache = tm.init_cache(cfg, 1, rep.cache_len, device=dev)
            first = torch.tensor([int(r.tokens[-1])], device=dev)
            out, _ = greedy_generate(params, cfg, cache, first,
                                     r.max_new_tokens)
            if m.tokens != out[0].tolist():
                raise AssertionError(
                    f"{arch} request {m.request_id}: serving stream "
                    f"{m.tokens} != greedy_generate {out[0].tolist()}")
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, size=(2, 80)),
                               device=dev)
        dec = _decode_logits(params, cfg, toks, 96)
        _zero_all_kernel_counts()
        full = _forward_logits(params, cfg, toks)
        torch.cuda.synchronize()
        counts = _all_kernel_counts()
        err = _scaled_max(dec, full)
        ran = {k: v for k, v in counts.items() if v and v != (0, 0)}
        print(f"  {arch} parity: streams {[m.tokens for m in rep.requests]}"
              f" == greedy_generate; 80 decode steps vs forward "
              f"max|err|/max(1,|forward|) {err:.3e} (limit {DECODE_TOL}); "
              f"forward launched {ran} ({card})")
        if not math.isfinite(err) or err > DECODE_TOL:
            raise AssertionError(f"{arch}: decode_step vs forward {err} > "
                                 f"{DECODE_TOL}")
        need = ("k3",) if cfg.family == "ssm" else ("k4", "k1")
        if any(counts[k][0] == 0 for k in need):
            raise AssertionError(f"{arch}: forward did not launch {need}: "
                                 f"{counts}")

    cfg = get_config("internvl3-2b").reduced().with_(
        attn_impl="cuda", sliding_window=SLIDING_WINDOW)
    eng = Engine(cfg, seed=0)
    cfg, params = eng.cfg, eng.state.params
    trace = _parity_trace(cfg.vocab, rng)
    flash_attention.launches = 0
    rep = eng.serving(slots=2).run(trace)
    torch.cuda.synchronize()
    launches = flash_attention.launches
    lengths = [r.prompt_len for r in trace if r.prompt_len > 1]
    for m in rep.requests:
        r = trace[m.request_id]
        toks = torch.as_tensor(r.tokens, device=dev)[None].long()
        if r.prompt_len == 1:
            cache = tm.init_cache(cfg, 1, rep.cache_len, device=dev)
            out, _ = greedy_generate(params, cfg, cache, toks[:, 0],
                                     r.max_new_tokens)
            want = out[0].tolist()
        else:
            logits, cache = tm.prefill(
                params, cfg, {"tokens": toks},
                cache_len=min(SLIDING_WINDOW, rep.cache_len))
            first = torch.argmax(logits[:, 0], dim=-1)
            out, _ = greedy_generate(params, cfg, cache, first,
                                     r.max_new_tokens - 1)
            want = [int(first[0])] + out[0].tolist()
        if m.tokens != want:
            raise AssertionError(
                f"sliding request {m.request_id}: serving stream "
                f"{m.tokens} != exact prefill + greedy_generate {want}")
    print(f"  sliding {SLIDING_WINDOW} parity: streams "
          f"{[m.tokens for m in rep.requests]} == exact prefill + "
          f"greedy_generate; K2 launches {launches} ({card})")
    if launches != cfg.n_layers * len(lengths):
        raise AssertionError(
            f"{launches} K2 launches on the exact-length path, but "
            f"{len(lengths)} prompts of {cfg.n_layers} layers")
    gen = torch.Generator(device=dev).manual_seed(2)
    heads = (cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim)
    rows = []
    for L in sorted(set(lengths)):
        row = check_kernel(dev, card, gen, 1, L, torch.float32, "sliding",
                           SLIDING_WINDOW, heads=heads)
        row["launches"] = cfg.n_layers * lengths.count(L)
        rows.append(row)
    return launches, rows


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def phase_state_serving(dev, card):
    """Full-width mamba2-370m, then recurrentgemma-2b, bf16: the
    full-width trace through Engine(arch).serving(slots=4).run(); every
    request finishes with its tokens, in vocab; the kernels' launches in
    the run (none: decode is torch ops); Engine.serve's ms a token; the
    largest relative error of 64 decode logits against forward (printed,
    not held: bf16 rounds the two paths at different points)."""
    from repro_torch.api import Engine
    from repro_torch.serving.serve_step import make_slot_cache

    out = {}
    for arch in STATE_ARCHS:
        torch.cuda.empty_cache()
        collect_garbage(f"{arch} serving")
        t0 = time.perf_counter()
        eng = Engine(arch, seed=0)
        cfg, params = eng.cfg, eng.state.params
        torch.cuda.synchronize()
        print(f"  {arch} as {cfg.family}: {cfg.n_layers} layers d_model "
              f"{cfg.d_model}, {sum(t.numel() for t in _leaves(params)) / 1e9:.3f}"
              f" B params {cfg.param_dtype}, init "
              f"{time.perf_counter() - t0:.1f} s")
        trace = full_width_trace(cfg.vocab)
        srv = eng.serving(slots=4)
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_all_kernel_counts()
        rep = srv.run(trace)
        torch.cuda.synchronize()
        counts = _all_kernel_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        by_id = {m.request_id: m for m in rep.requests}
        for r in trace:
            m = by_id.get(r.request_id)
            if m is None or m.n_generated != r.max_new_tokens:
                raise AssertionError(f"{arch} request {r.request_id} did "
                                     f"not finish with {r.max_new_tokens} "
                                     f"tokens")
            if not all(0 <= t < cfg.vocab for t in m.tokens):
                raise AssertionError(f"{arch} request {r.request_id}: "
                                     f"token out of vocab: {m.tokens}")
        slot_bytes = _tree_bytes(make_slot_cache(cfg, rep.n_slots,
                                                 rep.cache_len,
                                                 device="meta"))
        _, served = eng.serve(batch=4, prompt_len=96, gen_tokens=32)
        gen = torch.Generator(device=dev).manual_seed(3)
        toks = torch.randint(0, cfg.vocab, (1, 64), generator=gen,
                             device=dev)
        dec = _decode_logits(params, cfg, toks, 64)
        full = _forward_logits(params, cfg, toks)
        if not (torch.isfinite(dec).all() and torch.isfinite(full).all()):
            raise AssertionError(f"{arch}: decode or forward logits are "
                                 f"not finite")
        stats = dict(requests=len(rep.requests), tokens=rep.total_tokens,
                     tokens_per_s=rep.tokens_per_s,
                     mean_ttft_s=rep.mean_ttft_s,
                     max_ttft_s=rep.max_ttft_s, wall_s=rep.wall_s,
                     decode_steps=rep.n_decode_steps,
                     prefill_chunks=rep.n_prefill_chunks,
                     n_slots=rep.n_slots, cache_len=rep.cache_len,
                     slot_cache_bytes=slot_bytes,
                     max_memory_allocated_bytes=peak,
                     kernel_launches=counts,
                     serve_ms_per_token=served["ms_per_token"],
                     serve_batch=served["batch"],
                     serve_prompt_len=served["prompt_len"],
                     decode_vs_forward_max_rel_err=_scaled_max(dec, full))
        for key, val in stats.items():
            print(f"  {arch} serving {key} = {val} ({card})")
        if rep.n_prefill_chunks:
            raise AssertionError(f"{arch}: a state-cache family was "
                                 f"prefilled")
        out[arch] = stats
        del eng, params, srv, dec, full
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------ the MoE family
MOE_ARCHS = ("granite-moe-1b-a400m", "olmoe-1b-7b")
MOE_TRAIN_ARCH = "granite-moe-1b-a400m"
#: granite-moe-1b-a400m's attention heads: 16 query heads over 8 KV heads
#: of 64
MOE_HEADS = (16, 8, 64)


def _moe_reference_stream(params, cfg, prompt, n_new, T, dev):
    """The reference's stream of one request: `prefill` of the whole
    prompt (B=1) against a T-row cache, the first token from its logits,
    then greedy_generate; a 1-token prompt decodes from a fresh cache."""
    from repro_torch.models import model as tm
    from repro_torch.serving.serve_step import greedy_generate
    toks = torch.as_tensor(prompt, device=dev)[None].long()
    if len(prompt) == 1:
        cache = tm.init_cache(cfg, 1, T, device=dev)
        out, _ = greedy_generate(params, cfg, cache, toks[:, 0], n_new)
        return out[0].tolist()
    logits, cache = tm.prefill(params, cfg, {"tokens": toks}, cache_len=T)
    first = torch.argmax(logits[:, 0], dim=-1)
    out, _ = greedy_generate(params, cfg, cache, first, n_new - 1)
    return [int(first[0])] + out[0].tolist()


def phase_moe_parity(dev, card):
    """Reduced granite-moe-1b-a400m, fp32, kernels on: the ServingEngine's
    streams (slots=2, a slot reused) equal the exact-length prefill +
    greedy_generate's, and K2 ran layers x prompts of more than one
    token on that path; then phase 8's two training steps through K1
    against the plain attention."""
    from repro_torch.api import Engine
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention

    cfg = get_config(MOE_TRAIN_ARCH).reduced().with_(attn_impl="cuda")
    eng = Engine(cfg, seed=0)
    trace = _parity_trace(cfg.vocab, np.random.default_rng(1))
    flash_attention.launches = 0
    rep = eng.serving(slots=2).run(trace)
    torch.cuda.synchronize()
    launches = flash_attention.launches
    for m in rep.requests:
        r = trace[m.request_id]
        want = _moe_reference_stream(eng.state.params, eng.cfg, r.tokens,
                                     r.max_new_tokens, rep.cache_len, dev)
        if m.tokens != want:
            raise AssertionError(
                f"MoE request {m.request_id}: serving stream {m.tokens} "
                f"!= exact prefill + greedy_generate {want}")
    n_exact = sum(r.prompt_len > 1 for r in trace)
    print(f"  {MOE_TRAIN_ARCH} reduced parity: streams "
          f"{[m.tokens for m in rep.requests]} == exact prefill + "
          f"greedy_generate; K2 launches {launches} ({card})")
    if launches != cfg.n_layers * n_exact:
        raise AssertionError(f"{launches} K2 launches on the exact-length "
                             f"path, but {n_exact} prompts of "
                             f"{cfg.n_layers} layers")
    phase_train_parity(dev, MOE_TRAIN_ARCH)


def moe_layer_breakdown(dev, card, cfg, T):
    """One MoE layer at a T-token bucket in bf16 (cfg's widths): moe_ffn
    forward and backward against its expert GEMMs alone on the buffers'
    shape, by events and device time; the difference is the routing, the
    dispatch (sort, gathers) and the combine."""
    from repro_torch.models.moe import (_capacity, _expert_mlps, init_moe,
                                        moe_ffn)
    from repro_torch.models.transformer import moe_kwargs
    m, D = cfg.moe, cfg.d_model
    gen = torch.Generator(device=dev).manual_seed(4)
    p = {k: v.requires_grad_(True) for k, v in init_moe(
        gen, D, m.n_experts, m.expert_ff, torch.bfloat16, dev).items()}
    x = torch.randn(1, T, D, generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_(True)
    dy = torch.randn_like(x)
    cap = _capacity(m.capacity_factor, min(T, m.dispatch_group), m.top_k,
                    m.n_experts)
    ex = torch.randn(m.n_experts, cap, D, generator=gen, device=dev).to(
        torch.bfloat16).requires_grad_(True)
    dex = torch.randn_like(ex)
    experts = [p["gate"], p["up"], p["down"]]

    def layer():
        out, _ = moe_ffn(p, x, **moe_kwargs(cfg))
        torch.autograd.grad(out, [x, *p.values()], dy)

    def gemms():
        torch.autograd.grad(_expert_mlps(p, ex), [ex, *experts], dex)

    def layer_fwd():
        with torch.no_grad():
            moe_ffn(p, x, **moe_kwargs(cfg))

    def gemms_fwd():
        with torch.no_grad():
            _expert_mlps(p, ex)
    row = dict(T=T, cap=cap, experts=m.n_experts, top_k=m.top_k)
    for name, fn in (("layer_fwd_bwd", layer), ("gemms_fwd_bwd", gemms),
                     ("layer_fwd", layer_fwd), ("gemms_fwd", gemms_fwd)):
        row[f"{name}_ms"] = cuda_ms(fn, iters=10, warmup=2)
        row[f"{name}_device_ms"], row[f"{name}_kernels"] = device_ms(
            fn, iters=5, warmup=1)
    for what in ("fwd_bwd", "fwd"):
        layer_ms, gemms_ms = (row[f"{part}_{what}_device_ms"]
                              for part in ("layer", "gemms"))
        row[f"dispatch_{what}_device_ms"] = (
            None if None in (layer_ms, gemms_ms) else layer_ms - gemms_ms)
    flops = 6.0 * m.n_experts * cap * D * m.expert_ff      # 3 GEMMs fwd
    row["gemms_bound_fwd_bwd_ms"] = 3 * flops / PEAK_FLOPS[
        torch.bfloat16] * 1e3
    print(f"  MoE layer {json.dumps(row)} ({card})")
    return row


def phase_moe_training(dev, card):
    """Full-width granite-moe-1b-a400m DHP training, bf16, packed through
    K1 at head_dim 64; returns (launches fwd, bwd, group tables by
    (bucket, spans), n_layers, the MoE layer's breakdown)."""
    from repro_torch.api import ClusterSpec, Engine
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed, flash_attention_packed_bwd)

    run = dict(dataset="openvid", global_batch=8, max_tokens=4096,
               tokens_per_frame=256)
    t0 = time.perf_counter()
    eng = Engine(MOE_TRAIN_ARCH, ClusterSpec.auto(mem_budget=4096), seed=0)
    cfg, params = eng.cfg, eng.state.params
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  {MOE_TRAIN_ARCH} as {cfg.family}: {cfg.n_layers} layers "
          f"d_model {cfg.d_model}, {cfg.moe.n_experts} experts of "
          f"{cfg.moe.expert_ff} top-{cfg.moe.top_k}, {n_params / 1e9:.3f} B "
          f"params {cfg.param_dtype} ({_tree_bytes(params)} bytes), init "
          f"{time.perf_counter() - t0:.1f} s")
    plans = []
    torch.cuda.reset_peak_memory_stats(dev)
    flash_attention_packed.launches = 0
    flash_attention_packed_bwd.launches = 0
    hist = eng.train(steps=3, lookahead=True, plan_log=plans, trace=True,
                     **run)
    torch.cuda.synchronize()
    n_fwd = flash_attention_packed.launches
    n_bwd = flash_attention_packed_bwd.launches
    peak = torch.cuda.max_memory_allocated(dev)

    tracer = eng.last_tracer
    if tracer.dropped:
        raise AssertionError(f"the tracer dropped {tracer.dropped} events")
    groups = [(e["args"]["bucket"], e["args"]["spans"])
              for e in tracer.to_json()["traceEvents"]
              if e.get("name") == "execute"]
    want = cfg.n_layers * len(groups)
    if cfg.remat or not (n_fwd == n_bwd == want and want > 0):
        raise AssertionError(f"K1 launches fwd {n_fwd} bwd {n_bwd}, want "
                             f"{want} each for {cfg.n_layers} layers x "
                             f"{len(groups)} groups (remat {cfg.remat})")
    for m in hist:
        if not math.isfinite(m.loss):
            raise AssertionError(f"step {m.step}: loss {m.loss}")
        print(f"  moe train step {m.step}: loss={m.loss} "
              f"step_time_s={m.step_time_s} tokens={m.tokens} "
              f"tokens_per_s={m.tokens / m.step_time_s} "
              f"padding_efficiency={m.padding_efficiency} "
              f"degrees={m.degree_histogram} "
              f"groups={sum(m.degree_histogram.values())} ({card})")
    if len(hist) != 3:
        raise AssertionError(f"{len(hist)} training steps, want 3")
    if not all(torch.isfinite(t).all() for t in _leaves(
            eng.state.params)):
        raise AssertionError("parameters are not finite after 3 steps")
    print(f"  moe train max_memory_allocated_bytes = {peak} ({card})")
    print(f"  moe train group shapes (bucket, spans): {groups}")
    tables = packed_tables(eng, plans, run, groups)
    # one more step under the profiler: the busy share; K1; the
    # dispatch's sorts, searches, gathers and scatters; every GEMM
    profile_step(eng, run, card, "moe train",
                 {"k1_fwd": "packed_fwd", "k1_bwd": "packed_bwd",
                  "k1_bwd_sum": "bwd_kv_reduce", "sort_cub": "Sort",
                  "sort_aten": "sort", "searchsorted": "searchsorted",
                  "scatter_gather": "scatter_gather",
                  "index_select": "indexSelect", "index_add": "indexFunc",
                  "gemm": "gemm", "nvjet": "nvjet"})
    eng.close()
    del eng, params
    torch.cuda.empty_cache()
    breakdown = moe_layer_breakdown(dev, card, cfg, max(b for b, _ in
                                                         groups))
    return n_fwd, n_bwd, tables, cfg.n_layers, breakdown


def decode_step_ops(srv, n_slots, T):
    """(device ms, kernels, host ms) of one slot decode step at the
    runtime's shapes on a zero slot cache (4 steps, the first dropped)."""
    from repro_torch.serving.serve_step import (make_slot_cache,
                                                make_slot_decode_step)
    slots = make_slot_cache(srv.cfg, n_slots, T, device=srv.device)
    step = make_slot_decode_step(srv.cfg)
    toks = torch.zeros(n_slots, 1, dtype=torch.long, device=srv.device)
    ms, kernels = device_ms(lambda: step(srv.params, slots, toks), iters=3,
                            warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        step(srv.params, slots, toks)
    torch.cuda.synchronize()
    del slots
    return ms, kernels, (time.perf_counter() - t0) / 3 * 1e3


def phase_moe_serving(dev, card):
    """Full-width granite-moe-1b-a400m, then olmoe-1b-7b, bf16: init's
    peak; full_width_trace through Engine(arch).serving(slots=4).run(),
    traced: every request finishes with 32 in-vocab tokens, every
    prompt prefilled once at its exact length through K2 (launches ==
    layers x prompts); tokens/s, TTFT, wall, peak memory; one slot decode
    step's device ops, device and host time; Engine.serve(batch=4,
    prompt_len=96, gen_tokens=32)'s ms a token. Returns {arch: (exact
    lengths, K2 launches, n_layers, heads)}."""
    from repro_torch.api import ClusterSpec, Engine
    from repro_torch.obs.trace import Tracer

    out = {}
    for arch in MOE_ARCHS:
        torch.cuda.empty_cache()
        collect_garbage(f"{arch} serving")
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        # a prompt prefills whole on one rank, so the per-rank budget
        # must hold the trace's longest (1500 tokens), as in the reference
        eng = Engine(arch, ClusterSpec.auto(mem_budget=4096), seed=0)
        cfg, params = eng.cfg, eng.state.params
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated(dev) - base
        pbytes = _tree_bytes(params)
        print(f"  {arch} as {cfg.family}: {cfg.n_layers} layers d_model "
              f"{cfg.d_model}, {cfg.moe.n_experts} experts of "
              f"{cfg.moe.expert_ff} top-{cfg.moe.top_k}, "
              f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B "
              f"params {cfg.param_dtype} ({pbytes} bytes), init {init_s:.1f}"
              f" s, init peak above the weights {init_peak - pbytes} bytes "
              f"({card})")
        trace = full_width_trace(cfg.vocab)
        srv = eng.serving(slots=4)
        tracer = Tracer()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_all_kernel_counts()
        rep = srv.run(trace, trace=tracer)
        torch.cuda.synchronize()
        counts = _all_kernel_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        if tracer.dropped:
            raise AssertionError(f"the tracer dropped {tracer.dropped} "
                                 f"events")
        events = tracer.to_json()["traceEvents"]
        exact = sorted(ev["args"]["length"] for ev in events
                       if ev["name"] == "prefill_exact")
        if exact != sorted(r.prompt_len for r in trace if r.prompt_len > 1):
            raise AssertionError(f"{arch}: exact-length prefills {exact}")
        if any(ev["name"] in ("prefill_batch", "prefill_chunk")
               for ev in events):
            raise AssertionError(f"{arch}: a prompt was chunked or padded")
        if counts["k2"] != cfg.n_layers * len(exact):
            raise AssertionError(f"{arch}: {counts['k2']} K2 launches, "
                                 f"want {cfg.n_layers} x {len(exact)}")
        by_id = {m.request_id: m for m in rep.requests}
        for r in trace:
            m = by_id.get(r.request_id)
            if m is None or m.n_generated != r.max_new_tokens:
                raise AssertionError(f"{arch} request {r.request_id} did "
                                     f"not finish with {r.max_new_tokens} "
                                     f"tokens")
            if not all(0 <= t < cfg.vocab for t in m.tokens):
                raise AssertionError(f"{arch} request {r.request_id}: "
                                     f"token out of vocab: {m.tokens}")
        step_ms, step_kernels, step_host_ms = decode_step_ops(
            srv, rep.n_slots, rep.cache_len)
        _, served = eng.serve(batch=4, prompt_len=96, gen_tokens=32)
        stats = dict(requests=len(rep.requests), tokens=rep.total_tokens,
                     tokens_per_s=rep.tokens_per_s,
                     mean_ttft_s=rep.mean_ttft_s,
                     max_ttft_s=rep.max_ttft_s, wall_s=rep.wall_s,
                     decode_steps=rep.n_decode_steps,
                     exact_prefills=len(exact), n_slots=rep.n_slots,
                     cache_len=rep.cache_len,
                     max_memory_allocated_bytes=peak,
                     kernel_launches=counts,
                     decode_step_device_ms=step_ms,
                     decode_step_device_ops=step_kernels,
                     decode_step_host_ms=step_host_ms,
                     serve_ms_per_token=served["ms_per_token"],
                     serve_prefill_s=served["prefill_s"],
                     serve_batch=served["batch"],
                     serve_prompt_len=served["prompt_len"])
        for key, val in stats.items():
            print(f"  {arch} serving {key} = {val} ({card})")
        out[arch] = (exact, counts["k2"], cfg.n_layers,
                     (cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim))
        del eng, params, srv
    torch.cuda.empty_cache()
    return out


def phase_moe_kernels(dev, card, tables, n_layers, served):
    """K1 at granite's heads (16:8, D = 64), bf16, forward and backward
    vs plain: one synthetic 4096-token row with 256-token frames, then
    each (bucket, spans) shape of the MoE training run on its own tables;
    K2 (bf16, causal, B = 1) vs plain at each exact length the MoE
    serving runs prefilled, at each arch's heads. Returns (K1 rows, the
    training path's K1 rows, K2 rows)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    bf16 = torch.bfloat16
    seg, span = packed_layout(4096, [1500, 900, 1200, 400], 256)
    synth = [check_packed(dev, card, gen, 4096, bf16, seg, span,
                          tag="d64", heads=MOE_HEADS)]
    path = []
    for (bucket, spans), groups in sorted(tables.items()):
        seg, span = groups[0]
        row = check_packed(dev, card, gen, bucket, bf16, seg, span,
                           tag="moe train", heads=MOE_HEADS)
        row["launches"] = n_layers * len(groups)
        path.append(row)
    k2 = []
    for arch, (lengths, _, layers, heads) in served.items():
        for L in sorted(set(lengths)):
            row = check_kernel(dev, card, gen, 1, L, bf16, "causal",
                               heads=heads)
            row["launches"] = layers * lengths.count(L)
            row["arch"] = arch
            k2.append(row)
    return synth, path, k2


# ------------------------------------------ the dense and VLM configs
#: the head groupings the six dense and VLM configs bring, (label, (query
#: heads, KV heads, head_dim)): chatglm3-6b and glm4-9b 32:2, minitron-4b
#: 24:8 (an odd group of 3), qwen3vl-8b 32:8, llama3-405b 128:8 at
#: head_dim 128; pixtral-12b 32:8 at 160 (5120 / 32 in the reference's
#: config, where the published model sets 128)
DENSE_HEADS = (("chatglm3/glm4", (32, 2, 128)), ("minitron", (24, 8, 128)),
               ("qwen3vl", (32, 8, 128)), ("llama3-405b", (128, 8, 128)),
               ("pixtral", (32, 8, 160)))
PIXTRAL_HEADS = (32, 8, 160)
#: K2's exact lengths held at every grouping (one row, causal)
DENSE_EXACT_LENGTHS = (96, 200, 600, 1500)
#: (arch, layers) of the full-width training runs: the whole models'
#: training state (14 bytes a parameter) would be 179 GB and 115 GB, so
#: the depth is cut to what one card holds beside a 4096-token group
#: with headroom (8 and 12 layers peaked at 77.1 and 79.5 GB on an H100
#: 80GB HBM3: some 5.3 and 3.7 GB a layer)
DENSE_TRAIN = (("pixtral-12b", 7), ("qwen3vl-8b", 10))
VLM_SERVE_ARCHS = ("pixtral-12b", "qwen3vl-8b")
#: (arch, layers or None for whole) of the short Engine.serve runs:
#: llama3-405b's 126 layers would be 810 GB in bf16
SHORT_SERVES = (("chatglm3-6b", None), ("glm4-9b", None),
                ("minitron-4b", None), ("llama3-405b", 2))
#: the VLM forward's logits through the kernels lie at most VLM_MARGIN
#: times as far (elementwise, max |err| / max(1, |ref|)) from the same
#: weights in fp32 as the plain attention path's bf16 logits do: two bf16
#: paths part by roundings that the head's 131072-wide product amplifies
#: (0.077 and 0.075 from fp32 on an H100 80GB HBM3, 700 W), beyond any
#: fixed limit near 2e-2; each of VLM_FAULTS must lie beyond the margin
VLM_MARGIN = 1.25
#: phases 27-38 took 80-150 s on an H100 80GB HBM3, 700 W
LATE_TIMEOUT_S = 600
#: the time limit of phases 39-42's process
AUDIO_TRAIN_TIMEOUT_S = 600
VLM_FAULTS = ("scale_at_192", "third_block_unwritten",
              "third_block_from_second")


def phase_dense_kernels(dev, card):
    """K1 (bf16, forward and backward) on one 4096-token row, causal,
    with and without 256-token frames, and K2 (bf16, causal) at 4x2048
    and at the exact lengths DENSE_EXACT_LENGTHS, vs their plain
    versions at every grouping of DENSE_HEADS, phase 7's and phase 3's
    limits; with ms, device_ms, plain, SDPA, the bound and the launch
    beside the SMs. 128 query heads run the plain versions a KV head at
    a time. Returns (K1 rows, K2 rows), each tagged with its grouping."""
    gen = torch.Generator(device=dev).manual_seed(6)
    bf16 = torch.bfloat16
    k1, k2 = [], []
    for label, heads in DENSE_HEADS:
        for frame in (256, None):
            seg, span = packed_layout(4096, [4096], frame)
            row = check_packed(dev, card, gen, 4096, bf16, seg, span,
                               tag=f"dense {label}", heads=heads,
                               detail=True)
            k1.append(dict(row, group=label))
            torch.cuda.empty_cache()
        for B, L in [(4, 2048)] + [(1, n) for n in DENSE_EXACT_LENGTHS]:
            row = check_kernel(dev, card, gen, B, L, bf16, heads=heads)
            k2.append(dict(row, group=label))
            torch.cuda.empty_cache()
    return k1, k2


def phase_dense_parity(dev):
    """Phase 8 for reduced chatglm3-6b (its 2D RoPE) and for reduced
    pixtral-12b at head_dim 160 over 4:2 heads (K1's fp32 kernels at
    D = 160)."""
    from repro_torch.configs import get_config
    phase_train_parity(dev, "chatglm3-6b")
    phase_train_parity(dev, "pixtral-12b at head_dim 160",
                       cfg=get_config("pixtral-12b").reduced().with_(
                           head_dim=160, kv_heads=2))


def phase_dense_training(dev, card):
    """Phase 9 for each (arch, depth) of DENSE_TRAIN, one after the
    other, the card emptied between; returns {arch: (launches fwd, bwd,
    group tables, n_layers)}."""
    out = {}
    for arch, depth in DENSE_TRAIN:
        torch.cuda.empty_cache()
        collect_garbage(f"{arch} train")
        out[arch] = phase_training(dev, card, arch, depth)
        torch.cuda.empty_cache()
    return out


def phase_dense_serving(dev, card):
    """Phase 5 and phase 6 for each arch of VLM_SERVE_ARCHS, whole;
    returns {arch: (K2 launches, path rows, n_layers)}."""
    out = {}
    for arch in VLM_SERVE_ARCHS:
        torch.cuda.empty_cache()
        collect_garbage(f"{arch} serving")
        torch.cuda.reset_peak_memory_stats(dev)
        launches, shapes, n_layers, heads = phase_serving(dev, card, arch)
        print(f"  {arch} serving max_memory_allocated_bytes (init "
              f"included) = {torch.cuda.max_memory_allocated(dev)} "
              f"({card})")
        torch.cuda.empty_cache()
        out[arch] = (launches, phase_path(dev, card, shapes, n_layers,
                                          heads), n_layers)
    return out


def phase_short_serves(dev, card):
    """Engine(arch).serve(batch=2, prompt_len=96, gen_tokens=8) for each
    (arch, depth) of SHORT_SERVES at full width: 8 in-vocab tokens a
    row, K2 launched once a layer (one batched prefill of both prompts),
    the prompts' last logits finite; parameters, init time, prefill
    time, ms a token and peak memory. Returns {arch: K2 launches}."""
    from repro_torch.api import Engine
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models.model import prefill
    out = {}
    for arch, depth in SHORT_SERVES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        cfg = get_config(arch)
        if depth is not None:
            cfg = cfg.with_(n_layers=depth)
        t0 = time.perf_counter()
        eng = Engine(cfg, seed=0)
        params = eng.state.params
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        gen = torch.Generator(device=dev).manual_seed(7)
        prompts = torch.randint(0, cfg.vocab, (2, 96), generator=gen,
                                device=dev)
        flash_attention.launches = 0
        toks, rep = eng.serve(prompts, gen_tokens=8)
        torch.cuda.synchronize()
        launches = flash_attention.launches
        logits, _ = prefill(params, eng.cfg, {"tokens": prompts})
        peak = torch.cuda.max_memory_allocated(dev)
        if launches != cfg.n_layers:
            raise AssertionError(f"{arch}: {launches} K2 launches, want "
                                 f"{cfg.n_layers} (a layer, one batched "
                                 f"prefill of 2 prompts)")
        if not torch.isfinite(logits).all():
            raise AssertionError(f"{arch}: prefill logits are not finite")
        if toks.shape != (2, 8) or not ((toks >= 0) & (toks < cfg.vocab)
                                        ).all():
            raise AssertionError(f"{arch}: decoded {toks}")
        stats = dict(layers=cfg.n_layers, d_model=cfg.d_model,
                     heads=f"{cfg.n_heads}:{cfg.kv_heads}",
                     head_dim=cfg.resolved_head_dim,
                     rope_frac=0.5 if cfg.rope_2d else 1.0,
                     params=sum(t.numel() for t in _leaves(params)),
                     param_bytes=_tree_bytes(params), init_s=init_s,
                     prefill_s=rep["prefill_s"],
                     ms_per_token=rep["ms_per_token"], k2_launches=launches,
                     logits_finite=True, tokens=toks.tolist(),
                     max_memory_allocated_bytes=peak)
        print(f"  {arch} serve {json.dumps(stats)} ({card})")
        out[arch] = launches
        del eng, params, logits
    torch.cuda.empty_cache()
    return out


def _planted_k2(fault):
    """K2 with one fault of the head_dim-160 layout planted around the
    sound kernel, as the model calls it: `scale_at_192` (the softmax
    scale taken at the tile's 192 columns: q times sqrt(160 / 192)),
    `third_block_unwritten` (output columns 128-159 zero) and
    `third_block_from_second` (columns 128-159 a copy of 64-95)."""
    from repro_torch.kernels.flash_attention import flash_attention

    def call(q, k, v, **kw):
        if fault == "scale_at_192":
            q = q * math.sqrt(160 / 192)
        o = flash_attention(q, k, v, **kw).clone()
        if fault == "third_block_unwritten":
            o[..., 128:160] = 0
        elif fault == "third_block_from_second":
            o[..., 128:160] = o[..., 64:96]
        return o
    return call


def phase_vlm_forward(dev, card):
    """pixtral-12b at full width and 2 layers, bf16, through `forward`
    with synthetic_batch's patches (2 rows of 1024 tokens, 256 patch
    embeddings a row through the connector), and the same weights in
    fp32 through the plain attention as the reference. The logits
    through the kernels (K2 at head_dim 160, a launch a layer) must be
    finite and lie, elementwise (max |err| / max(1, |fp32|)), at most
    VLM_MARGIN times as far from the reference as the plain attention
    path's bf16 logits do; each fault of VLM_FAULTS planted around K2
    must lie farther; the patches reach the logits. Returns K2's
    launches."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import attention
    from repro_torch.models import model as tm
    from repro_torch.training.optimizer import tree_map
    torch.cuda.empty_cache()
    cfg = get_config("pixtral-12b").with_(n_layers=2)
    params = tm.init_params(cfg, seed=0, device=dev)
    batch = synthetic_batch(cfg, 2, 1024, seed=0)
    flash_attention.launches = 0
    with torch.no_grad():
        got, _ = tm.forward(params, cfg, batch)
        torch.cuda.synchronize()
        launches = flash_attention.launches
        ref, _ = tm.forward(params, cfg.with_(attn_impl="reference"), batch)
        text, _ = tm.forward(params, cfg.with_(family="dense"),
                             {"tokens": batch["tokens"]})
        fp32 = cfg.with_(param_dtype="float32", attn_impl="reference")
        truth, _ = tm.forward(tree_map(lambda t: t.float(), params), fp32,
                              batch)
        faulty = {}
        for fault in VLM_FAULTS:
            attention.flash_attention = _planted_k2(fault)
            try:
                logits, _ = tm.forward(params, cfg, batch)
            finally:
                attention.flash_attention = flash_attention
            faulty[fault] = _scaled_max(logits, truth)
            del logits
    plain_err = _scaled_max(ref, truth)
    ratio = _scaled_max(got, truth) / plain_err
    fault_ratio = {f: e / plain_err for f, e in faulty.items()}
    moved = (text - got).float().abs()[:, :batch["patch_pos"].shape[1]]
    row = dict(layers=cfg.n_layers, d_model=cfg.d_model,
               heads=f"{cfg.n_heads}:{cfg.kv_heads}",
               head_dim=cfg.resolved_head_dim,
               vision_dim=cfg.vlm.vision_dim,
               patches=int(batch["patch_pos"].shape[1]),
               connector=list(params["connector"].shape),
               k2_launches=launches,
               kernel_vs_fp32_scaled=_scaled_max(got, truth),
               plain_vs_fp32_scaled=plain_err, ratio=ratio,
               margin=VLM_MARGIN, fault_vs_fp32_scaled=faulty,
               fault_ratio=fault_ratio,
               kernel_vs_plain_scaled=_scaled_max(got, ref),
               logits_max_abs=ref.float().abs().max().item(),
               patch_rows_moved=moved.max().item())
    print(f"  pixtral-12b VLM forward {json.dumps(row)} ({card})")
    if not torch.isfinite(got).all():
        raise AssertionError("VLM forward logits are not finite")
    if launches != cfg.n_layers:
        raise AssertionError(f"{launches} K2 launches, want {cfg.n_layers}")
    if not ratio <= VLM_MARGIN:
        raise AssertionError(
            f"VLM forward through the kernels {ratio} times as far from "
            f"the fp32 reference as the plain attention path (> "
            f"{VLM_MARGIN})")
    caught = {f: r for f, r in fault_ratio.items() if r > VLM_MARGIN}
    if caught != fault_ratio:
        raise AssertionError(f"planted K2 faults within the VLM check: "
                             f"{fault_ratio} (margin {VLM_MARGIN})")
    if not row["patch_rows_moved"] > 0:
        raise AssertionError("the patches did not reach the logits")
    del params, got, ref, text, truth
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------ the audio family
#: whisper-small's attention heads: 12:12 of 64
WHISPER_HEADS = (12, 12, 64)
WHISPER_FRAMES = 1500
#: (rows, query length) of K2 in full mode over WHISPER_FRAMES keys: the
#: encoder (one request's admission; forward's 2 rows; Engine.serve's
#: batch of 4) and the decoder's cross-attention (forward's 2 x 448; 1,
#: 96 and 448 a row beside)
AUDIO_SHAPES = ((1, 1500), (2, 1500), (4, 1500), (1, 1), (1, 96), (1, 448),
                (2, 448))
#: (rows, length) of K2 in causal mode at whisper's heads, bf16: the
#: decoder's self-attention in forward
AUDIO_CAUSAL = ((2, 448),)
#: faults planted around K2's fp32 kernel (the encoder's and the
#: cross-attention's from fp32 frames) in phase 38: the last key tile of
#: 64 never read (over 1500 frames the partial one of 28), and the
#: softmax scale taken at head_dim 128, not 64
AUDIO_FAULTS = ("last_key_tile_dropped", "scale_at_d128")
AUDIO_PARITY_PROMPTS = (21, 5, 1)
#: the audio forward's logits through the kernels lie at most this many
#: times as far (elementwise) from the same weights in fp32 as the plain
#: attention path's do, as VLM_MARGIN holds the VLM forward
AUDIO_MARGIN = 1.25


def phase_audio_kernels(dev, card):
    """K2 vs its plain version at whisper-small's heads: full mode at
    AUDIO_SHAPES over 1500 keys, fp32 (the kernel the encoder and the
    cross-attention run from fp32 frames) and bf16, and causal at
    AUDIO_CAUSAL in bf16 (the decoder's self-attention), phase 3's
    limits; ms, device_ms, plain, SDPA, the bound (for fp32 also the
    split-TF32 bound its kernel works against) and each launch."""
    gen = torch.Generator(device=dev).manual_seed(8)
    rows = [check_kernel(dev, card, gen, B, Sq, dtype, "full",
                         heads=WHISPER_HEADS, Sk=WHISPER_FRAMES)
            for dtype in (torch.float32, torch.bfloat16)
            for B, Sq in AUDIO_SHAPES]
    return rows + [check_kernel(dev, card, gen, B, S, torch.bfloat16,
                                heads=WHISPER_HEADS)
                   for B, S in AUDIO_CAUSAL]


def phase_audio_parity(dev, card):
    """Reduced whisper-small in fp32, kernels on: the ServingEngine's
    streams (slots=2, a slot reused) against greedy_generate from
    init_cache + prefill_cross_kv of serving_frames and each prompt's
    last token, as phase 4 holds the dense family; K2 launched once an
    encoder layer a request; 12 decode_step logits against forward
    through K2 (2e-3). Returns the run's K2 launches."""
    from repro_torch.api import Engine
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import model as tm
    from repro_torch.serving.scheduler import ServeRequest
    from repro_torch.serving.serve_step import greedy_generate

    cfg = get_config("whisper-small").reduced().with_(attn_impl="cuda")
    eng = Engine(cfg, seed=0)
    params = eng.state.params
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, size=L, dtype=np.int32)
               for L in AUDIO_PARITY_PROMPTS]
    n_new = 4
    frames = tm.serving_frames(cfg, 1, eng.seed, dev)

    def reference(prompt):
        cache = tm.prefill_cross_kv(
            params, cfg, frames,
            tm.init_cache(cfg, 1, len(prompt) + n_new + 1, device=dev))
        first = torch.as_tensor(prompt[-1:], device=dev).long()
        out, _ = greedy_generate(params, cfg, cache, first, n_new)
        return [int(t) for t in out[0].cpu()]

    trace = [ServeRequest(request_id=i, tokens=p, max_new_tokens=n_new)
             for i, p in enumerate(prompts)]
    flash_attention.launches = 0
    rep = eng.serving(slots=2).run(trace)
    torch.cuda.synchronize()
    launches = flash_attention.launches
    if launches != len(prompts) * cfg.encdec.n_enc_layers:
        raise AssertionError(f"{launches} K2 launches, want "
                             f"{cfg.encdec.n_enc_layers} a request")
    for m in rep.requests:
        want = reference(prompts[m.request_id])
        if m.tokens != want:
            raise AssertionError(f"request {m.request_id}: serving stream "
                                 f"{m.tokens} != greedy_generate {want}")
    print(f"  audio parity: {[m.tokens for m in rep.requests]} == "
          f"greedy_generate; K2 launches {launches}")
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic_batch(cfg, 2, 12, seed=0).items()}
    with torch.no_grad():
        full, _ = tm.forward(params, cfg, batch)
    cache = tm.prefill_cross_kv(params, cfg, batch["frames"],
                                tm.init_cache(cfg, 2, 16, device=dev))
    out = []
    for t in range(12):
        logits, cache = tm.decode_step(params, cfg, cache,
                                       batch["tokens"][:, t])
        out.append(logits)
    err = _scaled_max(torch.stack(out, dim=1), full)
    print(f"  audio decode vs forward: max|err|/max(1,|forward|) {err} "
          f"(limit 2e-3) ({card})")
    if not err <= 2e-3:
        raise AssertionError(f"audio decode vs forward {err} > 2e-3")
    eng.close()
    return launches


def phase_audio_serving(dev, card):
    """Full-width whisper-small, bf16, whole: full_width_trace through
    Engine.serving(slots=4).run(), traced: every request finishes with
    32 in-vocab tokens, none prefilled, each admission one encoder pass
    (an `encode` span; K2 launched once an encoder layer, no other
    kernel); tokens/s, TTFT, wall, peak memory, the slot cache's bytes,
    one encoder pass's time, one slot decode step's device ops; a decode
    step's logits finite; Engine.serve(batch=4, prompt_len=96,
    gen_tokens=32)'s ms a token and K2 launches (one encoder pass of 4
    rows). Every launch is of the fp32 kernel in full mode (serving
    draws fp32 frames). Returns (the run's K2 launches by kernel and
    mode, serve's)."""
    from repro_torch.api import Engine
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import model as tm
    from repro_torch.obs.trace import Tracer
    from repro_torch.serving.serve_step import make_slot_cache

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    eng = Engine("whisper-small", seed=0)
    cfg, params = eng.cfg, eng.state.params
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    enc_layers = cfg.encdec.n_enc_layers
    print(f"  whisper-small: {enc_layers} encoder and {cfg.n_layers} "
          f"decoder layers, d_model {cfg.d_model}, {cfg.n_heads}:"
          f"{cfg.kv_heads} heads of {cfg.resolved_head_dim}, "
          f"{cfg.encdec.n_audio_frames} frames, "
          f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f} B params "
          f"{cfg.param_dtype} ({_tree_bytes(params)} bytes), init "
          f"{init_s:.1f} s ({card})")
    trace = full_width_trace(cfg.vocab)
    srv = eng.serving(slots=4)
    tracer = Tracer()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_all_kernel_counts()
    rep = srv.run(trace, trace=tracer)
    torch.cuda.synchronize()
    counts = _all_kernel_counts()
    run_by = dict(flash_attention.launches_by)
    peak = torch.cuda.max_memory_allocated(dev)
    if tracer.dropped:
        raise AssertionError(f"the tracer dropped {tracer.dropped} events")
    events = tracer.to_json()["traceEvents"]
    encodes = sum(ev["name"] == "encode" for ev in events)
    if encodes != len(trace):
        raise AssertionError(f"{encodes} encoder passes for {len(trace)} "
                             f"requests")
    if any(ev["name"].startswith("prefill_") for ev in events):
        raise AssertionError("an audio prompt was prefilled")
    others = {k: v for k, v in counts.items() if k != "k2"}
    if counts["k2"] != enc_layers * len(trace) or any(
            n for v in others.values() for n in np.atleast_1d(v)):
        raise AssertionError(f"kernel launches {counts}, want K2 "
                             f"{enc_layers} x {len(trace)} alone")
    want_by = {"flash_fwd_f32_kernel full": enc_layers * len(trace)}
    if run_by != want_by:
        raise AssertionError(f"K2 launches by kernel {run_by}, want "
                             f"{want_by}")
    by_id = {m.request_id: m for m in rep.requests}
    for r in trace:
        m = by_id.get(r.request_id)
        if m is None or m.n_generated != r.max_new_tokens:
            raise AssertionError(f"request {r.request_id} did not finish "
                                 f"with {r.max_new_tokens} tokens")
        if not all(0 <= t < cfg.vocab for t in m.tokens):
            raise AssertionError(f"request {r.request_id}: token out of "
                                 f"vocab: {m.tokens}")
    slots = make_slot_cache(cfg, rep.n_slots, rep.cache_len, device=dev)
    slot_bytes = _tree_bytes({k: v for k, v in slots.items()
                              if k != "pos"})
    cross_bytes = _tree_bytes({k: slots[k] for k in ("cross_k",
                                                     "cross_v")})
    del slots
    frames = tm.serving_frames(cfg, 1, eng.seed, dev)
    cache = tm.init_cache(cfg, 1, 8, device=dev)
    encode_ms = cuda_ms(lambda: tm.prefill_cross_kv(params, cfg, frames,
                                                    cache), iters=5)
    encode_device_ms, _ = device_ms(
        lambda: tm.prefill_cross_kv(params, cfg, frames, cache), iters=5)
    cache = tm.prefill_cross_kv(params, cfg, frames, cache)
    logits, _ = tm.decode_step(params, cfg, cache, torch.as_tensor(
        trace[0].tokens[-1:], device=dev).long())
    if not torch.isfinite(logits).all():
        raise AssertionError("whisper-small decode logits are not finite")
    step_ms, step_kernels, step_host_ms = decode_step_ops(
        srv, rep.n_slots, rep.cache_len)
    flash_attention.launches = 0
    flash_attention.launches_by = {}
    toks, served = eng.serve(batch=4, prompt_len=96, gen_tokens=32)
    torch.cuda.synchronize()
    serve_launches = flash_attention.launches
    serve_by = dict(flash_attention.launches_by)
    if serve_by != {"flash_fwd_f32_kernel full": enc_layers}:
        raise AssertionError(f"Engine.serve: K2 launches {serve_by}, want "
                             f"{enc_layers} of the fp32 kernel (one "
                             f"encoder pass)")
    if not ((toks >= 0) & (toks < cfg.vocab)).all():
        raise AssertionError(f"Engine.serve decoded {toks}")
    stats = dict(requests=len(rep.requests), tokens=rep.total_tokens,
                 tokens_per_s=rep.tokens_per_s, mean_ttft_s=rep.mean_ttft_s,
                 max_ttft_s=rep.max_ttft_s, wall_s=rep.wall_s,
                 decode_steps=rep.n_decode_steps, encoder_passes=encodes,
                 n_slots=rep.n_slots, cache_len=rep.cache_len,
                 max_memory_allocated_bytes=peak,
                 slot_cache_bytes=slot_bytes,
                 slot_cross_kv_bytes=cross_bytes,
                 kernel_launches=counts, k2_launches_by=run_by,
                 encode_ms=encode_ms,
                 encode_device_ms=encode_device_ms,
                 decode_step_device_ms=step_ms,
                 decode_step_device_ops=step_kernels,
                 decode_step_host_ms=step_host_ms,
                 serve_ms_per_token=served["ms_per_token"],
                 serve_prefill_s=served["prefill_s"],
                 serve_k2_launches=serve_launches,
                 serve_k2_launches_by=serve_by,
                 logits_finite=True)
    for key, val in stats.items():
        print(f"  whisper-small serving {key} = {val} ({card})")
    eng.close()
    del eng, params, srv, cache, logits
    torch.cuda.empty_cache()
    return run_by, serve_by


def _recording_k2(seen):
    """K2 as the model calls it, each call's (B, Sq, Sk, H, Hkv, D, mode,
    dtype) added to `seen`."""
    from repro_torch.kernels.flash_attention import flash_attention

    def call(q, k, v, **kw):
        seen.add((*q.shape[:2], k.shape[1], q.shape[2], k.shape[2],
                  q.shape[3], kw.get("mode", "causal"),
                  str(q.dtype).split(".")[-1]))
        return flash_attention(q, k, v, **kw)
    return call


def _planted_k2_f32(fault):
    """K2 with one fault of AUDIO_FAULTS planted around the sound fp32
    kernel, as the model calls it (bf16 calls run sound):
    `last_key_tile_dropped` (the keys past the last whole tile of 64,
    or the last tile where all are whole, never read) and
    `scale_at_d128` (q times sqrt(D / 128))."""
    from repro_torch.kernels.flash_attention import flash_attention

    def call(q, k, v, **kw):
        if q.dtype == torch.float32:
            if fault == "last_key_tile_dropped":
                keep = (k.shape[1] - 1) // 64 * 64
                k, v = k[:, :keep].contiguous(), v[:, :keep].contiguous()
            elif fault == "scale_at_d128":
                q = q * math.sqrt(q.shape[-1] / 128)
        return flash_attention(q, k, v, **kw)
    return call


def phase_audio_forward(dev, card, held):
    """whisper-small at full width, bf16, through `forward` with
    synthetic_batch (2 rows of 448 tokens and 1500 frames): its frames
    in fp32 (the encoder and the cross-attention through K2's fp32
    kernel, the decoder's self-attention through the bf16 one), then
    in bf16 (every attention through the bf16 kernel); each held
    elementwise to at most AUDIO_MARGIN times the plain attention path's
    distance from the same weights and frames in fp32; K2's launches
    counted by kernel and mode (2 x 12 full and 12 causal a forward);
    every shape K2 was launched at one that phase 35 held against the
    plain version (`held`, its rows); each fault of AUDIO_FAULTS planted
    around the fp32 kernel beyond the margin; other frames move the
    logits. Returns {frames dtype: K2 launches by kernel and mode}."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import attention
    from repro_torch.models import model as tm
    from repro_torch.training.optimizer import tree_map
    torch.cuda.empty_cache()
    cfg = get_config("whisper-small")
    params = tm.init_params(cfg, seed=0, device=dev)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic_batch(cfg, 2, 448, seed=0).items()}
    n_enc, n_dec = cfg.encdec.n_enc_layers, cfg.n_layers
    want = {"float32": {"flash_fwd_f32_kernel full": n_enc + n_dec,
                        "flash_fwd_wg_kernel causal": n_dec},
            "bfloat16": {"flash_fwd_wg_kernel full": n_enc + n_dec,
                         "flash_fwd_wg_kernel causal": n_dec}}
    launches, rows, seen = {}, {}, set()
    with torch.no_grad():
        fp32 = cfg.with_(param_dtype="float32", attn_impl="reference")
        truth, _ = tm.forward(tree_map(lambda t: t.float(), params), fp32,
                              batch)
        for dt in (torch.float32, torch.bfloat16):
            b = dict(batch, frames=batch["frames"].to(dt))
            flash_attention.launches = 0
            flash_attention.launches_by = {}
            attention.flash_attention = _recording_k2(seen)
            try:
                got, _ = tm.forward(params, cfg, b)
                torch.cuda.synchronize()
            finally:
                attention.flash_attention = flash_attention
            name = str(dt).split(".")[-1]
            launches[name] = dict(flash_attention.launches_by)
            ref, _ = tm.forward(params, cfg.with_(attn_impl="reference"), b)
            plain_err = _scaled_max(ref, truth)
            rows[name] = dict(
                frames=name, k2_launches=flash_attention.launches,
                k2_launches_by=launches[name],
                kernel_vs_fp32_scaled=_scaled_max(got, truth),
                plain_vs_fp32_scaled=plain_err,
                ratio=_scaled_max(got, truth) / plain_err,
                kernel_vs_plain_scaled=_scaled_max(got, ref),
                finite=bool(torch.isfinite(got).all()))
            if dt == torch.float32:
                other = dict(batch, frames=batch["frames"].flip(0))
                moved, _ = tm.forward(params, cfg, other)
                rows[name]["frames_moved"] = (
                    moved - got).float().abs().max().item()
                faulty = {}
                for fault in AUDIO_FAULTS:
                    attention.flash_attention = _planted_k2_f32(fault)
                    try:
                        logits, _ = tm.forward(params, cfg, b)
                    finally:
                        attention.flash_attention = flash_attention
                    faulty[fault] = _scaled_max(logits, truth) / plain_err
                    del logits
                rows[name]["fault_ratio"] = faulty
            del got, ref
    held_at = {(r["B"], r["S"], r["Sk"], r["H"], r["Hkv"], r["D"],
                r["mode"], r["dtype"]) for r in held}
    for row in rows.values():
        print(f"  whisper-small forward {json.dumps(row)} ({card})")
        if not row["finite"]:
            raise AssertionError("audio forward logits are not finite")
        if row["k2_launches_by"] != want[row["frames"]]:
            raise AssertionError(f"K2 launches {row['k2_launches_by']}, "
                                 f"want {want[row['frames']]}")
        if not row["ratio"] <= AUDIO_MARGIN:
            raise AssertionError(
                f"audio forward ({row['frames']} frames) through the "
                f"kernels {row['ratio']} times as far from fp32 as the "
                f"plain attention path (> {AUDIO_MARGIN})")
    print(f"  whisper-small forward K2 shapes {sorted(seen)} ({card})")
    if not seen <= held_at:
        raise AssertionError(f"K2 launched at shapes phase 35 did not hold "
                             f"against plain: {sorted(seen - held_at)}")
    faulty = rows["float32"]["fault_ratio"]
    if not all(r > AUDIO_MARGIN for r in faulty.values()):
        raise AssertionError(f"planted fp32 K2 faults within the audio "
                             f"check: {faulty} (margin {AUDIO_MARGIN})")
    if not rows["float32"]["frames_moved"] > 0:
        raise AssertionError("the frames did not reach the logits")
    del params, truth
    torch.cuda.empty_cache()
    return launches


#: whisper-small's training batch: rows of WHISPER_TOKENS decoder tokens
#: over WHISPER_FRAMES frames; its K1 shapes are held against plain at
#: 1 row and at the batch's 8
WHISPER_TRAIN_ROWS = 8
WHISPER_TOKENS = 448
#: the depth of the full-width parity check and of the resume
AUDIO_TRAIN_DEPTH = 2
#: the audio training gradient through the kernels lies at most this
#: many times as far (per leaf, max|err| / max|fp32|) from the same
#: weights in fp32 as the plain attention path's, as AUDIO_MARGIN holds
#: the forward
AUDIO_GRAD_MARGIN = 1.25
#: the resumed run against the unbroken one: K1's bf16 dQ (the
#: decoder's) is summed by atomics in an order that varies between calls, so from the break on
#: the two runs' gradients differ in their last bits. Their losses may
#: stand this far apart (relative), and this share of the parameters may
#: differ at all. A resume with the moments zeroed on restore must go
#: beyond both, one with the step counter reset beyond the share (it
#: moves the losses about 1.3e-4, too close to the sound runs' 2.4e-5 to
#: set a limit between them) (phase_audio_resume)
RESUME_LOSS_RTOL = 2e-4
RESUME_DIFFER_SHARE = 0.02


def _k1_shape_keys(row, which) -> list:
    """The keys of `flash_attention_packed.launches_by_shape` under which
    the kernels of a `check_packed` row's dtype and head dim (`which` 0
    the forward, 1 the backward: fp32's at head_dim 64 its dK / dV
    kernel, then its dQ kernel) count their launches at the row's
    shape."""
    from repro_torch.kernels.flash_attention_packed import (bwd_kernels,
                                                            fwd_kernel)
    dtype = getattr(torch, row["dtype"])
    kernels = ((fwd_kernel(dtype, row["D"]),) if which == 0
               else bwd_kernels(dtype, row["D"]))
    return [f"{k} {row['mode']} {row['S']}x{row['Sk']}" for k in kernels]


def _planted_k1_tail(q, k, v, segment_ids, **kw):
    """K1 with the last 28 of 1500 keys (the partial 32-key tile) left
    out of every full-mode call over the frames: a fault planted around
    the sound kernel, for the gradient check to find."""
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed)
    if kw.get("mode") == "full" and k.shape[1] == WHISPER_FRAMES:
        kseg = kw.get("kv_segment_ids")
        kseg = (segment_ids if kseg is None else kseg).clone()
        kseg[:, 1472:] = -2
        kw = dict(kw, kv_segment_ids=kseg)
    return flash_attention_packed(q, k, v, segment_ids, **kw)


def phase_audio_train_kernels(dev, card):
    """K1 forward and backward vs plain (phase 7's limits, `check_packed`
    with device times and launches) at whisper-small's training shapes,
    12:12 heads of 64, for 1 row and WHISPER_TRAIN_ROWS: fp32 full at
    1500 x 1500 (the encoder), fp32 full at 448 over 1500 with the
    frames' own segment table (the cross-attention, Sq != Sk), bf16
    causal at 448 (the decoder). Each row's forward and backward stand
    side by side on one line: the kernels that ran, their device time
    (the backward's by kernel too) and launches."""
    from repro_torch.kernels.flash_attention_packed import (bwd_kernels,
                                                            fwd_kernel)
    gen = torch.Generator(device=dev).manual_seed(9)
    rows = []
    F, T = WHISPER_FRAMES, WHISPER_TOKENS
    for B in (1, WHISPER_TRAIN_ROWS):
        z = lambda n: np.zeros((B, n), np.int32)  # noqa: E731
        rows.append(check_packed(dev, card, gen, F, torch.float32, z(F),
                                 mode="full", tag="whisper encoder",
                                 heads=WHISPER_HEADS, detail=True))
        rows.append(check_packed(dev, card, gen, T, torch.float32, z(T),
                                 mode="full", kseg=z(F), Sk=F,
                                 tag="whisper cross", heads=WHISPER_HEADS,
                                 detail=True))
        rows.append(check_packed(dev, card, gen, T, torch.bfloat16, z(T),
                                 tag="whisper decoder", heads=WHISPER_HEADS,
                                 detail=True))
    for r in rows:
        dt = getattr(torch, r["dtype"])
        print(f"  K1 {r['tag']} {r['B']}x{r['S']} over {r['Sk']} "
              f"{r['dtype']}: fwd {fwd_kernel(dt, r['D'])} device_ms="
              f"{r['fwd_device_ms']} (SDPA {r['library_fwd_device_ms']}) "
              f"launch {json.dumps(r['launch']['fwd'])}; bwd "
              f"{'+'.join(bwd_kernels(dt, r['D']))} device_ms="
              f"{r['bwd_device_ms']} (SDPA {r['library_bwd_device_ms']}) by "
              f"kernel {json.dumps(r.get('bwd_device_ms_by_kernel'))} launch "
              f"{json.dumps(r['launch']['bwd'])} ({card})")
    return rows


def _grad_tree(params, cfg, batch):
    """(loss, gradient leaves) of `loss_fn` at `params`."""
    from repro_torch.training import value_and_grad
    from repro_torch.training.optimizer import tree_leaves
    _, loss, _, grads = value_and_grad(params, cfg, batch)
    return loss.item(), list(tree_leaves(grads))


def _leaf_dist(got, want) -> float:
    """Largest per-leaf max|got - want| / max|want| over the leaves."""
    return max(((a.double() - b.double()).abs().max()
                / b.double().abs().max().clamp_min(1e-30)).item()
               for a, b in zip(got, want))


def phase_audio_train_parity(dev, card):
    """Reduced whisper-small, fp32, one set of weights: the loss and
    every gradient leaf through the kernels (K1: fp32 full for the
    encoder and the cross-attention, fp32 causal for the decoder) vs
    through the plain attention (attn_impl="reference") within 1e-4,
    and one `make_train_step` step each (loss, grad_norm); K1's launches
    by kernel and mode."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed)
    from repro_torch.models import model as tm
    from repro_torch.training import AdamW, TrainState, make_train_step
    cfg = get_config("whisper-small").reduced().with_(attn_impl="cuda")
    params = tm.init_params(cfg, seed=0, device=dev)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic_batch(cfg, 4, 12, seed=1).items()}
    out = {}
    for impl in ("cuda", "reference"):
        c = cfg.with_(attn_impl=impl)
        flash_attention_packed.launches_by = {}
        loss, grads = _grad_tree(params, c, batch)
        by = dict(flash_attention_packed.launches_by)
        _, m = make_train_step(c, AdamW())(TrainState(params), batch)
        out[impl] = (loss, grads, {k: v.item() for k, v in m.items()}, by)
    (loss, g, m, by), (rloss, rg, rm, rby) = out["cuda"], out["reference"]
    n_enc, L = cfg.encdec.n_enc_layers, cfg.n_layers
    want = {"packed_fwd_f32_kernel full": n_enc + L,
            "packed_bwd_f32_kernel full": n_enc + L,
            "packed_bwd_f32_dq_kernel full": n_enc + L,
            "packed_fwd_f32_kernel causal": L,
            "packed_bwd_f32_kernel causal": L,
            "packed_bwd_f32_dq_kernel causal": L}
    gerr = max((a - b).abs().max().item() for a, b in zip(g, rg))
    row = dict(loss=loss, plain_loss=rloss, grad_max_diff=gerr,
               step=m, plain_step=rm, k1_launches_by=by)
    print(f"  whisper-small reduced training parity {json.dumps(row)} "
          f"({card})")
    if by != want or rby:
        raise AssertionError(f"K1 launches {by} (plain path {rby}), want "
                             f"{want}")
    if not (abs(loss - rloss) <= 1e-4 and gerr <= 1e-4
            and abs(m["grad_norm"] - rm["grad_norm"])
            <= 1e-4 * rm["grad_norm"]):
        raise AssertionError("audio training through the kernels differs "
                             "from the plain path by more than 1e-4")


def phase_audio_training(dev, card, held):
    """whisper-small at full width (12 + 12 layers), bf16 parameters,
    fp32 frames: 3 steps of `make_train_step` on one synthetic batch of
    WHISPER_TRAIN_ROWS x 448 tokens over 1500 frames, and a profiled
    fourth: step time, tokens/s (decoder tokens, frames beside), peak
    memory, busy share; K1's launches by kernel and mode and by shape,
    every shape one phase 39 held (`held`); the loss finite and falling.
    Then, depth cut to AUDIO_TRAIN_DEPTH + AUDIO_TRAIN_DEPTH layers on 2
    rows, the gradient through the kernels held to AUDIO_GRAD_MARGIN
    times the plain attention path's distance from the same weights in
    fp32, with the last partial key tile planted out of K1 beyond it.
    Returns (K1's launches by kernel and mode, by kernel, mode and
    shape), as the wrapper counted them in the 3 steps."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed)
    from repro_torch.models import attention
    from repro_torch.models import model as tm
    from repro_torch.training import AdamW, TrainState, make_train_step
    from repro_torch.training.optimizer import tree_leaves, tree_map
    torch.cuda.empty_cache()
    collect_garbage("audio train")
    cfg = get_config("whisper-small")
    n_enc, L = cfg.encdec.n_enc_layers, cfg.n_layers
    t0 = time.perf_counter()
    params = tm.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"  whisper-small: {n_enc} + {L} layers d_model {cfg.d_model}, "
          f"{cfg.n_heads}:{cfg.kv_heads} heads of {cfg.resolved_head_dim}, "
          f"vocab {cfg.vocab}, {n_params / 1e9:.3f} B params "
          f"{cfg.param_dtype}, init {time.perf_counter() - t0:.1f} s")
    B, T = WHISPER_TRAIN_ROWS, WHISPER_TOKENS
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic_batch(cfg, B, T, seed=0).items()}
    step = make_train_step(cfg, AdamW())
    state = TrainState(params)
    torch.cuda.reset_peak_memory_stats(dev)
    flash_attention.launches = 0
    flash_attention_packed.launches_by = {}
    flash_attention_packed.launches_by_shape = {}
    losses = []
    for i in range(3):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, batch)
        loss = m["loss"].item()                    # waits for the card
        dt = time.perf_counter() - t1
        losses.append(loss)
        print(f"  whisper-small train step {i}: loss={loss} "
              f"grad_norm={m['grad_norm'].item()} step_time_s={dt} "
              f"tokens={B * T} tokens_per_s={B * T / dt} "
              f"frames={B * WHISPER_FRAMES} frames_per_s="
              f"{B * WHISPER_FRAMES / dt} ({card})")
    peak = torch.cuda.max_memory_allocated(dev)
    by = dict(flash_attention_packed.launches_by)
    shapes = dict(flash_attention_packed.launches_by_shape)
    print(f"  whisper-small train max_memory_allocated_bytes = {peak} "
          f"({card})")
    print(f"  whisper-small train K1 launches {json.dumps(by)}; by shape "
          f"{json.dumps(shapes)}; K2 launches {flash_attention.launches}")
    # a step: the encoder's and the cross-attention's fp32 (from fp32
    # frames) in full mode, the decoder's bf16 causal, each way
    want = {"packed_fwd_f32_kernel full": 3 * (n_enc + L),
            "packed_bwd_f32_kernel full": 3 * (n_enc + L),
            "packed_bwd_f32_dq_kernel full": 3 * (n_enc + L),
            "packed_fwd_wg_kernel causal": 3 * L,
            "packed_bwd_kv_kernel causal": 3 * L}
    if by != want or flash_attention.launches:
        raise AssertionError(f"K1 launches {by}, want {want}; K2 "
                             f"{flash_attention.launches}, want 0")
    held_at = {key for r in held if r["B"] == B for i in (0, 1)
               for key in _k1_shape_keys(r, i)}
    if not set(shapes) <= held_at:
        raise AssertionError(f"K1 launched at shapes phase 39 did not "
                             f"hold: {sorted(set(shapes) - held_at)}")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"losses {losses}: not finite and falling")
    if not all(torch.isfinite(t).all() for t in tree_leaves(state.params)):
        raise AssertionError("parameters are not finite after 3 steps")

    def one_more():
        nonlocal state
        state, _ = step(state, batch)
    # the split-TF32 forward named apart from the CUDA-core one (head
    # dims 128 and 160; none launched here)
    profile_call(one_more, card, "whisper-small train",
                 {"k1_f32": "packed_fwd_f32_kernel",
                  "k1_f32_cc": "packed_fwd_f32_cc_kernel",
                  "k1_f32_bwd": "packed_bwd_f32",
                  "k1_bf16": "packed_fwd_wg", "k1_bf16_bwd": "packed_bwd_kv"})
    del state, params, batch, m
    torch.cuda.empty_cache()

    # the depth cut: the gradient through the kernels against fp32
    cut = cfg.with_(n_layers=AUDIO_TRAIN_DEPTH,
                    encdec=dataclasses.replace(
                        cfg.encdec, n_enc_layers=AUDIO_TRAIN_DEPTH))
    params = tm.init_params(cut, seed=0, device=dev)
    small = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic_batch(cut, 2, T, seed=1).items()}
    fp32 = cut.with_(param_dtype="float32", attn_impl="reference")
    _, truth = _grad_tree(tree_map(lambda t: t.float(), params), fp32, small)
    _, ref = _grad_tree(params, cut.with_(attn_impl="reference"), small)
    _, got = _grad_tree(params, cut, small)
    plain = _leaf_dist(ref, truth)
    row = dict(layers=f"{AUDIO_TRAIN_DEPTH} + {AUDIO_TRAIN_DEPTH}",
               rows=2, kernel_vs_fp32=_leaf_dist(got, truth),
               plain_vs_fp32=plain, kernel_vs_plain=_leaf_dist(got, ref),
               dtypes_as_params=all(
                   a.dtype == p.dtype
                   for a, p in zip(got, tree_leaves(params))))
    row["ratio"] = row["kernel_vs_fp32"] / plain
    attention.flash_attention_packed = _planted_k1_tail
    try:
        _, bad = _grad_tree(params, cut, small)
    finally:
        attention.flash_attention_packed = flash_attention_packed
    row["fault_last_tile_ratio"] = _leaf_dist(bad, truth) / plain
    print(f"  whisper-small depth-cut gradient {json.dumps(row)} ({card})")
    if not (row["ratio"] <= AUDIO_GRAD_MARGIN and row["dtypes_as_params"]):
        raise AssertionError(f"audio gradient through the kernels "
                             f"{row['ratio']} times as far from fp32 as "
                             f"the plain path (> {AUDIO_GRAD_MARGIN})")
    if not row["fault_last_tile_ratio"] > AUDIO_GRAD_MARGIN:
        raise AssertionError("a gradient without the last key tile passes "
                             "the audio gradient check")
    del params, truth, ref, got, bad
    torch.cuda.empty_cache()
    return by, shapes


def _resume_faults(state):
    """Two faults planted in a restored train state, each on its own
    copy: the moments zeroed, and the step counter reset to 0 (so the
    bias corrections start again)."""
    from repro_torch.training import AdamWState, TrainState
    from repro_torch.training.optimizer import tree_map

    def copy(fn, step):
        return TrainState(tree_map(torch.clone, state.params), AdamWState(
            step, tree_map(fn, state.opt.m), tree_map(fn, state.opt.v)))
    return {"moments_zeroed": copy(torch.zeros_like,
                                   state.opt.step.clone()),
            "step_reset": copy(torch.clone,
                               torch.zeros_like(state.opt.step))}


def phase_audio_resume(dev, card):
    """A checkpoint resume on the card: whisper-small at full width, depth
    cut to AUDIO_TRAIN_DEPTH + AUDIO_TRAIN_DEPTH layers, bf16, 2 rows:
    two `make_train_step` steps, `checkpoint.save`, `restore` into a new
    tree (bit for bit the state saved), then two more steps from the
    restored tree and two from the state that was saved (the unbroken
    run). K1's dQ is summed by atomics in an order that varies between
    calls, so the two runs' gradients differ in their last bits from the
    break on: the losses are held within RESUME_LOSS_RTOL and the share
    of parameters that differ at all within RESUME_DIFFER_SHARE. Two
    faults planted in copies of the restored state (`_resume_faults`)
    must go beyond them as RESUME_LOSS_RTOL says. Prints the file's size and the ms to save and
    to restore; returns the row."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models import model as tm
    from repro_torch.training import AdamW, TrainState, make_train_step
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import tree_leaves
    cfg = get_config("whisper-small")
    cfg = cfg.with_(n_layers=AUDIO_TRAIN_DEPTH, encdec=dataclasses.replace(
        cfg.encdec, n_enc_layers=AUDIO_TRAIN_DEPTH))
    step = make_train_step(cfg, AdamW())
    params = tm.init_params(cfg, seed=0, device=dev)
    batches = [{k: torch.as_tensor(v, device=dev) for k, v in
                synthetic_batch(cfg, 2, WHISPER_TOKENS, seed=s).items()}
               for s in range(4)]

    def run(state, bs):
        losses = []
        for b in bs:
            state, m = step(state, b)
            losses.append(m["loss"].item())
        return state, losses

    def flat(state):
        return [*tree_leaves(state.params), state.opt.step,
                *tree_leaves(state.opt.m), *tree_leaves(state.opt.v)]
    saved, l_first = run(TrainState(params), batches[:2])
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "whisper.npz")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save(path, {"params": saved.params, "opt": saved.opt},
                        meta={"format": 2, "step": 2})
        save_ms = (time.perf_counter() - t0) * 1e3
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        tree = checkpoint.restore(path, {"params": saved.params,
                                         "opt": saved.opt})
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
    resumed = TrainState(tree["params"], tree["opt"])
    # before the unbroken run's next step updates the moments in place
    exact = all(torch.equal(a, b) for a, b in zip(flat(resumed),
                                                  flat(saved)))
    faults = _resume_faults(resumed)
    straight, l_straight = run(saved, batches[2:])
    n_total = sum(t.numel() for t in tree_leaves(params))

    def against_unbroken(state):
        state, losses = run(state, batches[2:])
        differ = sum(int((a != b).sum()) for a, b in zip(
            tree_leaves(state.params), tree_leaves(straight.params)))
        return dict(losses=losses, loss_max_rel_diff=max(
            abs(a - b) / abs(b) for a, b in zip(losses, l_straight)),
            params_differing=differ, params_differing_share=differ / n_total)
    sound = against_unbroken(resumed)
    planted = {name: against_unbroken(st) for name, st in faults.items()}
    row = dict(layers=f"{AUDIO_TRAIN_DEPTH} + {AUDIO_TRAIN_DEPTH}",
               file_bytes=size, save_ms=save_ms, restore_ms=restore_ms,
               restored_bit_for_bit=exact, losses_before=l_first,
               losses_unbroken=l_straight, resumed=sound, params_total=n_total,
               loss_rtol=RESUME_LOSS_RTOL, differ_share=RESUME_DIFFER_SHARE,
               planted=planted)
    print(f"  whisper-small resume {json.dumps(row)} ({card})")

    def within(r):
        return (r["loss_max_rel_diff"] <= RESUME_LOSS_RTOL
                and r["params_differing_share"] <= RESUME_DIFFER_SHARE)
    if not (exact and within(sound)):
        raise AssertionError("the resumed run differs from the unbroken "
                             "one beyond the stated tolerance")
    caught = {name: r["params_differing_share"] > RESUME_DIFFER_SHARE
              for name, r in planted.items()}
    caught["moments_zeroed_loss"] = (
        planted["moments_zeroed"]["loss_max_rel_diff"] > RESUME_LOSS_RTOL)
    if not all(caught.values()):
        raise AssertionError(f"a planted resume fault passes the resume "
                             f"check: {caught}")
    del params, straight, saved, resumed, tree, faults
    torch.cuda.empty_cache()
    return row


def audio_train_phases(dev, card) -> dict:
    """Phases 39-42; returns what the kernels line takes from them."""
    phase = PhaseClock()
    phase("[39/42] K1 vs plain versions at whisper-small's training shapes "
          "(12:12 heads of 64: fp32 full 1500 x 1500 and 448 over 1500, "
          "bf16 causal 448; 1 and 8 rows)")
    rows = phase_audio_train_kernels(dev, card)
    phase("[40/42] audio training parity at reduced size (fp32)")
    phase_audio_train_parity(dev, card)
    phase("[41/42] full-width whisper-small training (bf16 parameters, "
          "fp32 frames) through make_train_step")
    by, shapes = phase_audio_training(dev, card, rows)
    phase("[42/42] a checkpoint resume on the card (whisper-small, "
          f"{AUDIO_TRAIN_DEPTH} + {AUDIO_TRAIN_DEPTH} layers)")
    resume = phase_audio_resume(dev, card)
    phase.end()
    return dict(rows=rows, launches_by=by, launches_by_shape=shapes,
                resume=resume)


def _dq_ms(row):
    """The device time per call of fp32's dQ kernel in a `check_packed`
    row (None where the profiler traced none)."""
    return next((ms for name, ms in row.get(
        "bwd_device_ms_by_kernel", {}).items()
        if "packed_bwd_f32_dq_kernel" in name), None)


def dq_entry(bwd, main_r, rows, launches):
    """The kernels line's entry of fp32's dQ kernel beside `bwd`, the
    whole backward's entry at the same shapes: its device time alone,
    the bound of dQ alone, the plain backward (which forms dq with dk and
    dv: there is no plain dQ apart)."""
    return {
        "name": bwd["name"] + "_dq",
        "route": "cuda",
        "source": bwd["source"],
        "replaces": bwd["replaces"],
        "launches": launches,
        "max_abs_err": max(r["err_abs"]["dq"] for r in rows),
        "ms": _dq_ms(main_r),
        "device_ms": _dq_ms(main_r),
        "plain_ms": main_r["plain_bwd_ms"],
        "plain_note": "the plain backward, dq with dk and dv",
        "bound_ms": main_r["bound_dq_ms"],
        "bound_by": main_r["bound_dq_by"],
        "bound_at": bwd["bound_at"],
        "bound_cuda_core_ms": main_r["bound_dq_cuda_core_ms"],
        "library_ms": None,
        "launch": dict(**main_r["launch"]["bwd_dq"],
                       sms=main_r["launch"]["sms"]),
        "shape": bwd["shape"],
        "path_shapes": [dict(rows=r["B"], Sq=r["S"], Sk=r["Sk"],
                             err=r["err"]["dq"], device_ms=_dq_ms(r),
                             bound_ms=r["bound_dq_ms"],
                             bound_cuda_core_ms=r[
                                 "bound_dq_cuda_core_ms"])
                        for r in rows],
    }


class PhaseClock:
    """`phase(header)` prints a phase's header line and, first, how long
    the phase before it took; `end()` closes the last."""

    def __init__(self):
        self.label, self.t0 = None, None

    def __call__(self, header: str) -> None:
        self.end()
        print(header)
        self.label, self.t0 = header.split("]")[0] + "]", time.perf_counter()

    def end(self) -> None:
        if self.label is not None:
            print(f"  {self.label} {time.perf_counter() - self.t0:.1f} s")
            self.label = None


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def late_phases(dev, card) -> dict:
    """Phases 27-38; returns what the kernels line takes from them."""
    phase = PhaseClock()
    phase("[27/42] K1 and K2 vs plain versions at the dense and VLM "
          "configs' head groupings (32:2, 24:8, 32:8, 128:8 at D=128; 32:8 "
          "at D=160)")
    dense_k1, dense_k2 = phase_dense_kernels(dev, card)
    phase("[28/42] dense and VLM training parity at reduced size (fp32): "
          "chatglm3-6b, pixtral-12b at head_dim 160")
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed)
    flash_attention_packed.launches_by = {}
    flash_attention_packed.launches_by_shape = {}
    phase_dense_parity(dev)
    parity_by = dict(flash_attention_packed.launches_by_shape)
    phase("[29-30/42] full-width DHP training (bf16), depth cut: "
          + ", ".join(f"{a} {n} layers" for a, n in DENSE_TRAIN))
    dense_train = phase_dense_training(dev, card)
    phase("[31/42] K1 at head_dim 160 vs plain versions at the pixtral-12b "
          "run's shapes")
    _, _, p_tables, p_layers = dense_train["pixtral-12b"]
    d160_path = phase_train_path(dev, card, p_tables, p_layers,
                                 heads=PIXTRAL_HEADS, tag="pixtral train")
    phase(f"[32/42] full-width serving (bf16): {', '.join(VLM_SERVE_ARCHS)}"
          f", K2 vs plain at each shape the runs launched")
    dense_served = phase_dense_serving(dev, card)
    phase("[33/42] Engine.serve at full width (bf16): "
          + ", ".join(a if n is None else f"{a} ({n} layers)"
                      for a, n in SHORT_SERVES))
    short_served = phase_short_serves(dev, card)
    phase("[34/42] the VLM forward with patches: pixtral-12b at full width, "
          "2 layers (bf16)")
    vlm_launches = phase_vlm_forward(dev, card)
    phase("[35/42] K2 vs plain versions at whisper-small's shapes (12:12 "
          "heads of 64; full over 1500 keys in fp32 and bf16, causal bf16)")
    audio_k2 = phase_audio_kernels(dev, card)
    phase("[36/42] audio serving parity at reduced size (fp32)")
    phase_audio_parity(dev, card)
    phase("[37/42] full-width whisper-small serving (bf16)")
    audio_served = phase_audio_serving(dev, card)
    phase("[38/42] the audio forward: whisper-small at full width (bf16; "
          "fp32 and bf16 frames)")
    audio_forward = phase_audio_forward(dev, card, audio_k2)
    phase.end()
    return dict(dense_k1=dense_k1, dense_k2=dense_k2, d160_path=d160_path,
                train_launches={a: t[:2] for a, t in dense_train.items()},
                served={a: t[:2] for a, t in dense_served.items()},
                short_served=short_served, vlm_launches=vlm_launches,
                audio_k2=audio_k2, audio_served=audio_served,
                audio_forward=audio_forward,
                dense_parity_launches_by_shape=parity_by)


LATE_FLAG = "--late-phases"
AUDIO_TRAIN_FLAG = "--audio-train-phases"
#: the phases each flag runs in a process of its own, and its time limit
APART = {LATE_FLAG: (late_phases, LATE_TIMEOUT_S),
         AUDIO_TRAIN_FLAG: (audio_train_phases, AUDIO_TRAIN_TIMEOUT_S)}


def run_apart(flag: str) -> dict:
    """The phases `flag` names (APART) in a process of their own on the
    same card (see the module docstring), after this one has released
    its cached memory; they print to this process's streams, and what
    they return comes back as JSON through the checkout's git-ignored
    build directory."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    out = os.path.join(ROOT, "build", "chip_smoke_"
                       + flag.lstrip("-").replace("-", "_") + ".json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    if os.path.exists(out):
        os.remove(out)
    sys.stdout.flush()
    sys.stderr.flush()
    subprocess.run([sys.executable, os.path.abspath(__file__), flag, out],
                   check=True, timeout=APART[flag][1])
    with open(out) as f:
        return json.load(f)


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
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    card = card_line()
    if sys.argv[1:2] and sys.argv[1] in APART:
        build.build_all()           # the first process built them all
        result = APART[sys.argv[1]][0](dev, card)
        with open(sys.argv[2], "w") as f:
            json.dump(result, f)
        return 0
    print(f"[1/42] device: {name}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(card)

    t0 = time.perf_counter()
    build.build_all()
    print(f"[2/42] build: {time.perf_counter() - t0:.1f} s for "
          f"{build.sources()}")
    for src, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    phase = PhaseClock()
    phase("[3/42] kernels vs plain versions")
    rows = phase_kernels(dev, card)
    phase("[4/42] parity at reduced size (fp32)")
    phase_parity(dev)
    phase("[5/42] full-width serving (bf16)")
    launches, shapes, n_layers, _ = phase_serving(dev, card)
    phase("[6/42] kernels vs plain versions at the serving run's shapes")
    path = phase_path(dev, card, shapes, n_layers)

    # the shape launched most often stands for the kernel; every shape
    # the run launched is listed with its own numbers
    main_row = max(path, key=lambda r: (r["launches"], r["B"] * r["S"]))
    usual = [r for r in rows if r["dtype"] == "bfloat16"
             and r["mode"] == "causal" and r["kv_offset"] == 0
             and r["S"] <= 256]
    keys = ("launches", "max_abs_err", "max_scaled_err", "ms", "device_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms",
            "library_device_ms")
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:295",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in path + usual),
        "ms": main_row["ms"],
        "device_ms": main_row["device_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library_device_ms": main_row["library_device_ms"],
        "shape": f"B={main_row['B']} S={main_row['S']} H={H} Hkv={HKV} "
                 f"D={D} bf16 causal",
        "path_shapes": [dict(rows=r["B"], bucket=r["S"],
                             **{k: r[k] for k in keys}) for r in path],
    }]

    phase("[7/42] packed kernel K1 vs plain versions")
    packed_rows = phase_packed(dev, card)
    phase("[8/42] training parity at reduced size (fp32)")
    phase_train_parity(dev)
    phase("[9/42] full-width DHP training (bf16)")
    collect_garbage("train")
    n_fwd, n_bwd, tables, n_layers = phase_training(dev, card)
    torch.cuda.empty_cache()
    phase("[10/42] K1 vs plain versions at the training run's shapes")
    train_rows = phase_train_path(dev, card, tables, n_layers)

    # the shape launched most often stands for each K1 kernel; every
    # shape the training run launched is listed with its own numbers
    main_k1 = max(train_rows, key=lambda r: (r["launches"], r["S"]))
    checked = packed_rows + train_rows
    for which, launches in (("fwd", n_fwd), ("bwd", n_bwd)):
        kernels.append({
            "name": "flash_attention_packed" + ("_bwd" if which == "bwd"
                                                else ""),
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      "flash_attention_packed.cu",
            # the Pallas K1 has no backward; the kernel computes the
            # gradient of K1's function as _attn_chunked_bwd
            # (src/repro/models/attention.py:253) writes it
            "replaces": "src/repro/kernels/flash_attention.py:208",
            "launches": launches,
            "max_abs_err": max(r[f"max_abs_err_{which}"] for r in checked
                               if r["dtype"] == "bfloat16"),
            "ms": main_k1[f"{which}_ms"],
            "plain_ms": main_k1[f"plain_{which}_ms"],
            "bound_ms": main_k1[f"bound_{which}_ms"],
            "bound_by": main_k1[f"bound_{which}_by"],
            "library_ms": main_k1[f"library_{which}_ms"],
            "shape": f"B=1 S={main_k1['S']} H={H} Hkv={HKV} D={D} bf16 "
                     f"causal spans={main_k1['spans']}",
            "path_shapes": [dict(
                bucket=r["S"], spans=r["spans"], launches=r["launches"],
                pairs=r["pairs"], err=r["err"], rel_err=r["rel_err"],
                ms=r[f"{which}_ms"],
                plain_ms=r[f"plain_{which}_ms"],
                bound_ms=r[f"bound_{which}_ms"],
                bound_by=r[f"bound_{which}_by"],
                library_ms=r[f"library_{which}_ms"]) for r in train_rows],
        })

    phase("[11/42] SSD chunk kernel K3 vs plain versions")
    ssd_rows = phase_ssd(dev, card)
    phase("[12/42] SSM training parity at reduced size (fp32)")
    phase_ssm_parity(dev)
    phase("[13/42] full-width mamba2-370m DHP training (bf16)")
    torch.cuda.empty_cache()
    collect_garbage("ssm train")
    s_fwd, s_bwd, ssm_shapes, ssm_layers, chunk = phase_ssm_training(dev,
                                                                     card)
    torch.cuda.empty_cache()
    phase("[14/42] K3 vs plain versions at the SSM training run's shapes")
    ssd_path = phase_ssd_path(dev, card, ssm_shapes, ssm_layers, chunk)

    # the shape launched most often stands for each K3 kernel; every
    # shape the SSM run launched is listed with its own numbers
    main_k3 = max(ssd_path, key=lambda r: (r["launches"], r["Bsz"] * r["S"]))
    for which, launches in (("fwd", s_fwd), ("bwd", s_bwd)):
        kernels.append({
            "name": "ssd_chunk" + ("_bwd" if which == "bwd" else ""),
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssd_chunk.cu",
            # the Pallas K3 cannot be differentiated; the backward kernel
            # computes the gradient of the function it computes
            "replaces": "src/repro/kernels/ssd_chunk.py:62",
            "launches": launches,
            "max_abs_err": max(r[f"max_abs_err_{which}"]
                               for r in ssd_rows + ssd_path
                               if r["dtype"] == "bfloat16"),
            "ms": main_k3[f"{which}_ms"],
            "device_ms": main_k3[f"{which}_device_ms"],
            "plain_ms": main_k3[f"plain_{which}_ms"],
            "bound_ms": main_k3[f"bound_{which}_ms"],
            "bound_by": main_k3[f"bound_{which}_by"],
            "library_ms": None,
            "shape": f"Bsz={main_k3['Bsz']} S={main_k3['S']} "
                     f"H={SSD_HEADS} N={SSD_N} P={SSD_P} c={chunk} bf16",
            "bound_tc_ms": main_k3[f"bound_tc_{which}_ms"],
            "bound_tc_by": main_k3[f"bound_tc_{which}_by"],
            "path_shapes": [dict(
                n_seqs=r["Bsz"], bucket=r["bucket"], launches=r["launches"],
                err=r["err"], ms=r[f"{which}_ms"],
                device_ms=r[f"{which}_device_ms"],
                plain_ms=r[f"plain_{which}_ms"],
                bound_ms=r[f"bound_{which}_ms"],
                bound_by=r[f"bound_{which}_by"],
                inter_chunk_fwd_bwd_ms=r["inter_chunk_fwd_bwd_ms"])
                for r in ssd_path],
        })
    phase("[15/42] RG-LRU scan kernel K4 vs plain versions")
    rg_rows = phase_rglru(dev, card)
    phase("[16/42] K1 at head_dim 256 vs plain versions")
    wide_rows = phase_packed_wide(dev, card)
    phase("[17/42] hybrid training parity at reduced size (fp32)")
    phase_hybrid_parity(dev)
    phase("[18/42] full-width recurrentgemma-2b DHP training (bf16)")
    torch.cuda.empty_cache()
    collect_garbage("hybrid train")
    counts, hy_tables, per_group = phase_hybrid_training(dev, card)
    torch.cuda.empty_cache()
    phase("[19/42] K4 and K1 vs plain versions at the hybrid run's shapes")
    k4_path, k1_path = phase_hybrid_path(dev, card, hy_tables, per_group)

    # the shape launched most often stands for each kernel; every shape
    # the hybrid run launched is listed with its own numbers
    main_k4 = max(k4_path, key=lambda r: (r["launches"], r["B"] * r["S"]))
    for i, which in enumerate(("fwd", "bwd")):
        kernels.append({
            "name": "rglru_scan" + ("_bwd" if which == "bwd" else ""),
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
            # the Pallas K4 cannot be differentiated; the backward kernel
            # computes the gradient of the function it computes
            "replaces": "src/repro/kernels/rglru_scan.py:52",
            "launches": counts["k4"][i],
            "max_abs_err": max(r[f"max_abs_err_{which}"]
                               for r in rg_rows + k4_path
                               if r["dtype"] == "float32"),
            "ms": main_k4[f"{which}_ms"],
            "device_ms": main_k4[f"{which}_device_ms"],
            "plain_ms": main_k4[f"plain_{which}_ms"],
            "bound_ms": main_k4[f"bound_{which}_ms"],
            "bound_by": main_k4[f"bound_{which}_by"],
            "library_ms": None,
            "shape": f"B={main_k4['B']} S={main_k4['S']} W={RG_WIDTH} "
                     f"fp32",
            "path_shapes": [dict(
                n_seqs=r["B"], bucket=r["S"], launches=r["launches"][i],
                err=r["err"], ms=r[f"{which}_ms"],
                device_ms=r[f"{which}_device_ms"],
                plain_ms=r[f"plain_{which}_ms"],
                bound_ms=r[f"bound_{which}_ms"],
                bound_by=r[f"bound_{which}_by"]) for r in k4_path],
        })
    main_wide = max(k1_path, key=lambda r: (r["launches"], r["B"] * r["S"]))
    for i, which in enumerate(("fwd", "bwd")):
        kernels.append({
            "name": "flash_attention_packed_d256" + (
                "_bwd" if which == "bwd" else ""),
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      "flash_attention_packed.cu",
            "replaces": "src/repro/kernels/flash_attention.py:208",
            "launches": counts["k1"][i],
            "max_abs_err": max(r[f"max_abs_err_{which}"]
                               for r in wide_rows + k1_path),
            "ms": main_wide[f"{which}_ms"],
            "plain_ms": main_wide[f"plain_{which}_ms"],
            "bound_ms": main_wide[f"bound_{which}_ms"],
            "bound_by": main_wide[f"bound_{which}_by"],
            "library_ms": main_wide[f"library_{which}_ms"],
            "shape": f"B={main_wide['B']} S={main_wide['S']} H=10 Hkv=1 "
                     f"D=256 bf16 sliding {RG_WINDOW} "
                     f"spans={main_wide['spans']}",
            "path_shapes": [dict(
                n_seqs=r["B"], bucket=r["S"], spans=r["spans"],
                launches=r["launches"][i], pairs=r["pairs"], err=r["err"],
                rel_err=r["rel_err"], ms=r[f"{which}_ms"],
                plain_ms=r[f"plain_{which}_ms"],
                bound_ms=r[f"bound_{which}_ms"],
                bound_by=r[f"bound_{which}_by"],
                library_ms=r[f"library_{which}_ms"]) for r in k1_path],
        })
    phase("[20/42] ring context parallelism (bf16): LocalRing vs K1 "
          "unsharded and vs the plain ring; full-width internvl3-2b at "
          f"{RING_RANKS} ranks on the one card")
    ring_rows = phase_ring(dev, card, tables)
    torch.cuda.empty_cache()
    collect_garbage("ring train")
    ring_counts = phase_ring_training(dev, card)
    torch.cuda.empty_cache()
    # the ring's own path: its launches (phase 20's engine run) and its
    # function-level cases beside the K1 entries of their head dim
    for entry in kernels:
        if entry["name"].startswith("flash_attention_packed"):
            wide = "d256" in entry["name"]
            which = 1 if entry["name"].endswith("_bwd") else 0
            entry["ring_launches"] = 0 if wide else ring_counts[which]
            entry["ring_path_shapes"] = [dict(
                d=r["d"], S=r["S"], mode=r["mode"], window=r["window"],
                launches=r["launches_fwd_bwd"][which],
                err=r["err"], ring_fwd_bwd_ms=r["ring_fwd_bwd_ms"],
                k1_unsharded_fwd_bwd_ms=r["k1_unsharded_fwd_bwd_ms"],
                ring_fwd_bwd_device_ms=r["ring_fwd_bwd_device_ms"],
                k1_unsharded_fwd_bwd_device_ms=r[
                    "k1_unsharded_fwd_bwd_device_ms"])
                for r in ring_rows if (r["D"] == 256) == wide]
    phase("[21/42] state-cache and sliding-window serving parity at "
          "reduced size (fp32)")
    torch.cuda.empty_cache()
    exact_launches, exact_rows = phase_state_parity(dev, card)
    kernels[0]["exact_prefill_launches"] = exact_launches
    kernels[0]["exact_prefill_shapes"] = [dict(
        rows=r["B"], length=r["S"], heads=f"{r['H']}:{r['Hkv']}",
        D=r["D"], dtype=r["dtype"], window=r["window"],
        **{k: r[k] for k in keys}) for r in exact_rows]
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"],
                                    *(r["max_abs_err"] for r in exact_rows))
    phase("[22/42] full-width state-cache serving (bf16): "
          f"{', '.join(STATE_ARCHS)}")
    phase_state_serving(dev, card)

    phase("[23/42] MoE serving and training parity at reduced size (fp32)")
    torch.cuda.empty_cache()
    phase_moe_parity(dev, card)
    phase(f"[24/42] full-width {MOE_TRAIN_ARCH} DHP training (bf16)")
    torch.cuda.empty_cache()
    collect_garbage("moe train")
    m_fwd, m_bwd, moe_tables, moe_layers, moe_layer = phase_moe_training(
        dev, card)
    phase(f"[25/42] full-width MoE serving (bf16): {', '.join(MOE_ARCHS)}")
    moe_served = phase_moe_serving(dev, card)
    phase("[26/42] K1 at head_dim 64 and K2 at the MoE exact lengths vs "
          "plain versions")
    d64_rows, d64_path, moe_k2 = phase_moe_kernels(dev, card, moe_tables,
                                                   moe_layers, moe_served)
    main_d64 = max(d64_path, key=lambda r: (r["launches"], r["S"]))
    for which, launches in (("fwd", m_fwd), ("bwd", m_bwd)):
        kernels.append({
            "name": "flash_attention_packed_d64" + (
                "_bwd" if which == "bwd" else ""),
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      "flash_attention_packed.cu",
            "replaces": "src/repro/kernels/flash_attention.py:208",
            "launches": launches,
            "max_abs_err": max(r[f"max_abs_err_{which}"]
                               for r in d64_rows + d64_path),
            "ms": main_d64[f"{which}_ms"],
            "plain_ms": main_d64[f"plain_{which}_ms"],
            "bound_ms": main_d64[f"bound_{which}_ms"],
            "bound_by": main_d64[f"bound_{which}_by"],
            "library_ms": main_d64[f"library_{which}_ms"],
            "shape": f"B=1 S={main_d64['S']} H=16 Hkv=8 D=64 bf16 causal "
                     f"spans={main_d64['spans']} ({MOE_TRAIN_ARCH})",
            "moe_layer": moe_layer,
            "path_shapes": [dict(
                bucket=r["S"], spans=r["spans"], launches=r["launches"],
                pairs=r["pairs"], err=r["err"], rel_err=r["rel_err"],
                ms=r[f"{which}_ms"], plain_ms=r[f"plain_{which}_ms"],
                bound_ms=r[f"bound_{which}_ms"],
                bound_by=r[f"bound_{which}_by"],
                library_ms=r[f"library_{which}_ms"]) for r in d64_path],
        })
    kernels[0]["moe_exact_prefill_launches"] = {
        arch: k2 for arch, (_, k2, _, _) in moe_served.items()}
    kernels[0]["moe_exact_prefill_shapes"] = [dict(
        arch=r["arch"], rows=r["B"], length=r["S"],
        heads=f"{r['H']}:{r['Hkv']}", D=r["D"], dtype=r["dtype"],
        **{k: r[k] for k in keys}) for r in moe_k2]
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"],
                                    *(r["max_abs_err"] for r in moe_k2))
    phase.end()
    late = run_apart(LATE_FLAG)
    dense_k1, dense_k2 = late["dense_k1"], late["dense_k2"]
    d160_path, dense_served = late["d160_path"], late["served"]
    p_fwd, p_bwd = late["train_launches"]["pixtral-12b"]

    # K1 at head_dim 160: pixtral-12b's training run; the shape launched
    # most often stands for each direction
    main_160 = max(d160_path, key=lambda r: (r["launches"], r["S"]))
    d160_rows = [r for r in dense_k1 if r["D"] == 160]
    for which, launches in (("fwd", p_fwd), ("bwd", p_bwd)):
        kernels.append({
            "name": "flash_attention_packed_d160" + (
                "_bwd" if which == "bwd" else ""),
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/"
                      "flash_attention_packed.cu",
            "replaces": "src/repro/kernels/flash_attention.py:208",
            "launches": launches,
            "max_abs_err": max(r[f"max_abs_err_{which}"]
                               for r in d160_rows + d160_path),
            "ms": main_160[f"{which}_ms"],
            "plain_ms": main_160[f"plain_{which}_ms"],
            "bound_ms": main_160[f"bound_{which}_ms"],
            "bound_by": main_160[f"bound_{which}_by"],
            "library_ms": main_160[f"library_{which}_ms"],
            "shape": f"B=1 S={main_160['S']} H=32 Hkv=8 D=160 bf16 causal "
                     f"spans={main_160['spans']} (pixtral-12b)",
            "path_shapes": [dict(
                bucket=r["S"], spans=r["spans"], launches=r["launches"],
                pairs=r["pairs"], err=r["err"], rel_err=r["rel_err"],
                ms=r[f"{which}_ms"], plain_ms=r[f"plain_{which}_ms"],
                bound_ms=r[f"bound_{which}_ms"],
                bound_by=r[f"bound_{which}_by"],
                library_ms=r[f"library_{which}_ms"]) for r in d160_path],
            "row_4096": [dict(
                spans=r["spans"], ms=r[f"{which}_ms"],
                device_ms=r[f"{which}_device_ms"],
                bound_ms=r[f"bound_{which}_ms"],
                library_ms=r[f"library_{which}_ms"]) for r in d160_rows],
        })
    # K1 at head_dim 128 over the new groupings: qwen3vl-8b's training
    # launches and the 4096-token rows, beside internvl3-2b's entries
    q_fwd, q_bwd = late["train_launches"]["qwen3vl-8b"]
    for entry in kernels:
        if entry["name"] in ("flash_attention_packed",
                             "flash_attention_packed_bwd"):
            which = "bwd" if entry["name"].endswith("_bwd") else "fwd"
            entry["qwen3vl_train_launches"] = q_fwd if which == "fwd" \
                else q_bwd
            entry["dense_rows_4096"] = [dict(
                group=r["group"], heads=f"{r['H']}:{r['Hkv']}",
                spans=r["spans"], err=r["err"], rel_err=r["rel_err"],
                ms=r[f"{which}_ms"], device_ms=r[f"{which}_device_ms"],
                plain_ms=r[f"plain_{which}_ms"],
                bound_ms=r[f"bound_{which}_ms"],
                library_ms=r[f"library_{which}_ms"])
                for r in dense_k1 if r["D"] == 128]
            entry["max_abs_err"] = max(
                entry["max_abs_err"], *(r[f"max_abs_err_{which}"]
                                        for r in dense_k1 if r["D"] == 128))
    # K2 at head_dim 160: pixtral-12b's serving run and VLM forward
    p_k2, p_path = dense_served["pixtral-12b"]
    main_k2 = max(p_path, key=lambda r: (r["launches"], r["B"] * r["S"]))
    k2_160 = [r for r in dense_k2 if r["D"] == 160]
    kernels.append({
        "name": "flash_attention_d160",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:295",
        "launches": p_k2,
        "vlm_forward_launches": late["vlm_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in p_path + k2_160),
        "ms": main_k2["ms"],
        "device_ms": main_k2["device_ms"],
        "plain_ms": main_k2["plain_ms"],
        "bound_ms": main_k2["bound_ms"],
        "bound_by": main_k2["bound_by"],
        "library_ms": main_k2["library_ms"],
        "library_device_ms": main_k2["library_device_ms"],
        "shape": f"B={main_k2['B']} S={main_k2['S']} H=32 Hkv=8 D=160 bf16 "
                 f"causal (pixtral-12b)",
        "path_shapes": [dict(rows=r["B"], bucket=r["S"],
                             **{k: r[k] for k in keys}) for r in p_path],
        "dense_shapes": [dict(rows=r["B"], length=r["S"],
                              **{k: r[k] for k in keys if k != "launches"})
                         for r in k2_160],
    })
    q_k2, q_path = dense_served["qwen3vl-8b"]
    kernels[0]["qwen3vl_launches"] = q_k2
    kernels[0]["qwen3vl_path_shapes"] = [dict(
        rows=r["B"], bucket=r["S"], **{k: r[k] for k in keys})
        for r in q_path]
    kernels[0]["short_serve_launches"] = late["short_served"]
    kernels[0]["dense_shapes"] = [dict(
        group=r["group"], heads=f"{r['H']}:{r['Hkv']}", rows=r["B"],
        length=r["S"], **{k: r[k] for k in keys if k != "launches"})
        for r in dense_k2 if r["D"] == 128]
    kernels[0]["max_abs_err"] = max(
        kernels[0]["max_abs_err"],
        *(r["max_abs_err"] for r in q_path + dense_k2 if r["D"] == 128))
    # K2 at head_dim 64, whisper-small's: each launch count is the one
    # its kernel and mode had in phases 37-38. fp32 frames (what serving
    # draws) run the fp32 kernel in full mode; bf16 frames (phase 38's
    # second forward) the bf16 one; the decoder's causal self-attention
    # runs the bf16 kernel in both forwards
    serve_by, serve_once_by = late["audio_served"]
    fwd_by = late["audio_forward"].values()

    def fwd_launches(key):
        return sum(by.get(key, 0) for by in fwd_by)
    for dtype, suffix, kname in (
            ("float32", "", "flash_fwd_f32_kernel"),
            ("bfloat16", "_bf16", "flash_fwd_wg_kernel")):
        rows = [r for r in late["audio_k2"]
                if r["dtype"] == dtype and r["mode"] == "full"]
        enc = next(r for r in rows if r["B"] == 1 and r["S"] == 1500)
        entry = {
            "name": "flash_attention_full_d64" + suffix,
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:295",
            **{k: enc[k] for k in keys if k != "launches"},
            "forward_launches": fwd_launches(f"{kname} full"),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "shape": f"B=1 Sq=1500 Sk=1500 H=12 Hkv=12 D=64 {dtype} full "
                     f"(whisper-small's encoder)",
            "path_shapes": [dict(rows=r["B"], Sq=r["S"], Sk=r["Sk"],
                                 **{k: r[k] for k in keys
                                    if k != "launches"}) for r in rows],
        }
        if dtype == "float32":
            # bound_ms at the kernel's split TF32, the CUDA-core one beside
            entry["bound_at"] = SPLIT_TF32_AT
            entry["bound_cuda_core_ms"] = enc["bound_cuda_core_ms"]
            for shape, r in zip(entry["path_shapes"], rows):
                shape["bound_cuda_core_ms"] = r["bound_cuda_core_ms"]
            # serving's encoder passes: one a request, one for serve()
            entry["launches"] = serve_by.get(f"{kname} full", 0)
            entry["serve_launches"] = serve_once_by.get(f"{kname} full", 0)
        else:
            entry["launches"] = entry["forward_launches"]
        kernels.append(entry)
    causal = [r for r in late["audio_k2"] if r["mode"] == "causal"]
    kernels[0]["whisper_forward_launches"] = fwd_launches(
        "flash_fwd_wg_kernel causal")
    kernels[0]["whisper_shapes"] = [dict(
        rows=r["B"], length=r["S"], heads=f"{r['H']}:{r['Hkv']}", D=r["D"],
        **{k: r[k] for k in keys if k != "launches"}) for r in causal]
    kernels[0]["max_abs_err"] = max(
        kernels[0]["max_abs_err"], *(r["max_abs_err"] for r in causal))
    # K1 at whisper-small's training shapes (phases 39-42): each shape
    # launched in the 3-step run stands for itself, its launches as the
    # wrapper counted them at that shape, its numbers taken at the run's
    # 8 rows
    audio = run_apart(AUDIO_TRAIN_FLAG)
    for tag, suffix, desc in (
            ("whisper encoder", "_f32_encoder",
             "fp32 full 1500 x 1500 (whisper-small's encoder)"),
            ("whisper cross", "_f32_cross",
             "fp32 full 448 over 1500 (whisper-small's cross-attention)"),
            ("whisper decoder", "_decoder",
             "bf16 causal 448 (whisper-small's decoder)")):
        rows = [r for r in audio["rows"] if r["tag"] == tag]
        main_r = max(rows, key=lambda r: r["B"])
        for i, which in enumerate(("fwd", "bwd")):
            entry = {
                "name": "flash_attention_packed_d64" + suffix + (
                    "_bwd" if which == "bwd" else ""),
                # the CUDA kernel (the backward's first) that ran
                "kernel": _k1_shape_keys(main_r, i)[0].split()[0],
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/"
                          "flash_attention_packed.cu",
                "replaces": "src/repro/kernels/flash_attention.py:208",
                "launches": audio["launches_by_shape"].get(
                    _k1_shape_keys(main_r, i)[0], 0),
                "max_abs_err": max(r[f"max_abs_err_{which}"] for r in rows),
                "ms": main_r[f"{which}_ms"],
                "device_ms": main_r[f"{which}_device_ms"],
                "plain_ms": main_r[f"plain_{which}_ms"],
                "bound_ms": main_r[f"bound_{which}_ms"],
                "bound_by": main_r[f"bound_{which}_by"],
                "library_ms": main_r[f"library_{which}_ms"],
                "library_device_ms": main_r[f"library_{which}_device_ms"],
                "launch": dict(**main_r["launch"][which],
                               sms=main_r["launch"]["sms"]),
                "shape": f"B={main_r['B']} H=12 Hkv=12 D=64 {desc}",
                "path_shapes": [dict(
                    rows=r["B"], Sq=r["S"], Sk=r["Sk"], err=r["err"],
                    ms=r[f"{which}_ms"], device_ms=r[f"{which}_device_ms"],
                    plain_ms=r[f"plain_{which}_ms"],
                    bound_ms=r[f"bound_{which}_ms"],
                    library_ms=r[f"library_{which}_ms"]) for r in rows],
            }
            if main_r["dtype"] == "float32":
                # bound_ms at the kernels' split TF32, the CUDA-core one
                # beside it
                entry["bound_at"] = SPLIT_TF32_AT
                entry["bound_cuda_core_ms"] = main_r[
                    f"bound_{which}_cuda_core_ms"]
                for shape, r in zip(entry["path_shapes"], rows):
                    shape["bound_cuda_core_ms"] = r[
                        f"bound_{which}_cuda_core_ms"]
            kernels.append(entry)
            if "bwd_device_ms_by_kernel" in main_r and which == "bwd":
                # fp32's split-TF32 backward: the entry above is the
                # whole backward (its dK / dV kernel's launches); its dQ
                # kernel stands here on its own clock
                entry["device_ms_by_kernel"] = main_r[
                    "bwd_device_ms_by_kernel"]
                kernels.append(dq_entry(
                    entry, main_r, rows, audio["launches_by_shape"].get(
                        _k1_shape_keys(main_r, 1)[1], 0)))
    # fp32's CUDA-core forward (head dims 128 and 160, where no
    # full-width path runs fp32) beside the split-TF32 one above. Its
    # launches are phase 28's, reduced pixtral-12b at head_dim 160, each
    # shape apart; its errors and times phase 7's fp32 rows (12:2 heads
    # of 128), the only ones timed
    from repro_torch.kernels.flash_attention_packed import F32_FWD_CC_KERNEL
    cc_rows = [r for r in packed_rows if r["dtype"] == "float32"]
    cc_r = max(cc_rows, key=lambda r: r["pairs"])
    cc_launches = {key.split(" ", 1)[1]: n for key, n in late[
        "dense_parity_launches_by_shape"].items()
        if key.split()[0] == F32_FWD_CC_KERNEL}
    kernels.append({
        "name": "flash_attention_packed_f32_cc",
        "kernel": F32_FWD_CC_KERNEL,
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_packed.cu",
        "replaces": "src/repro/kernels/flash_attention.py:208",
        "launches": sum(cc_launches.values()),
        "launches_at": "phase 28, reduced pixtral-12b's fp32 training "
                       "parity at D=160, not the timed shape",
        "launches_by_shape_d160": cc_launches,
        "max_abs_err": max(r["max_abs_err_fwd"] for r in cc_rows),
        "ms": cc_r["fwd_ms"],
        "plain_ms": cc_r["plain_fwd_ms"],
        "bound_ms": cc_r["bound_fwd_ms"],
        "bound_by": cc_r["bound_fwd_by"],
        "bound_at": "fp32 on the CUDA cores, 67 TFLOP/s",
        "library_ms": cc_r["library_fwd_ms"],
        "shape": f"B=1 S={cc_r['S']} H={H} Hkv={HKV} D={D} fp32 "
                 f"{cc_r['mode']} spans={cc_r['spans']} (phase 7)",
        "timed_shapes": [dict(
            S=r["S"], mode=r["mode"], spans=r["spans"], err=r["err"]["o"],
            ms=r["fwd_ms"], plain_ms=r["plain_fwd_ms"],
            bound_ms=r["bound_fwd_ms"], library_ms=r["library_fwd_ms"])
            for r in cc_rows],
    })
    print(f"  chip_smoke wall {time.perf_counter() - t_start:.1f} s "
          f"({card})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
