"""K1's limits against planted faults (bf16, and fp32 at whisper-small's
shapes), and K1's forward and backward timed against other source
trees, on one card.

    python3 k1_fault_check.py [--shape internvl|rg|pixtral|whisper ...]
                              [--out FILE]
    python3 k1_fault_check.py --time [--direction fwd|bwd|both]
                              [--shape internvl|rg|pixtral|whisper ...]
                              [--tree LABEL=DIR ...]
                              [--variant LABEL=TREE:EDIT[+EDIT...] ...]
                              [--rounds N] [--out FILE]

Four shapes, the main path's attention of four models (`--shape`,
given once or more; internvl by default):
  * internvl: internvl3-2b, 12 query heads over 2 KV heads of 128,
    causal with 256-token frames;
  * rg: recurrentgemma-2b, 10 query heads over one KV head of 256,
    sliding at window 2048 with 256-token frames after 32 text tokens;
  * pixtral: pixtral-12b, 32 query heads over 8 KV heads of 160 (tiles
    of 192 columns in shared memory, the upper 32 zero-filled), causal
    with 256-token frames;
  * whisper: whisper-small in training, fp32, 12:12 heads of 64, full
    mode: its encoder (1500 frames over 1500) and cross-attention (448
    tokens over 1500 frames). Its faults are planted in the fp32
    kernels at head_dim 64, all split TF32: `f32_fwd_*` in the forward
    (packed_fwd_f32_kernel), the other `f32_*` in the backward
    (packed_bwd_f32_kernel for dK and dV, packed_bwd_f32_dq_kernel for
    dQ); they are read at the fp32 limit, max|err| / max(1, |plain|) <=
    1e-4 (chip_smoke.py's TOL and GRAD_TOL), in the two whisper cases
    and in cases that reach the same kernels through other tables:
    causal with spans, sliding, GQA at 12:2, and a ring hop with its
    own key tables and kv_offset.

Both modes build edited copies of `flash_attention_packed.cu` with nvcc
in a temporary directory, one nvcc per copy, all at once, each with `-I`
at its tree's `csrc` for the headers it includes. The checkout itself
is never edited. Needs one NVIDIA GPU and nvcc; prints the
card's name and power limit.

Fault mode (the default): for each planted fault of FAULTS[shape], the
port's K1 wrappers run on that copy's library, forward and backward,
against the plain versions at the shape's heads over the packed layouts
of `cases(shape)` (internvl: 1024 and 4096 tokens in several segments;
rg: one 4096-token row with and without frames, and a two-row padded
group of 2048; pixtral: 1024 and 4096 tokens in several segments, every
mode; whisper: the cases of `cases`). For each of o, the LSE (on the
rows with a valid key; rows that disagree on having one count as an
infinite error), dq, dk, dv it prints, per case, max|err| / max(1, |plain|) (`elementwise`, the form
`chip_smoke.py` holds to 2e-2 for o and 4e-2 for the gradients in bf16,
1e-4 in fp32) and max|err| / max|plain| (`whole`, held to 2e-2 in
bf16); a value that is not finite counts as an infinite error. The
limit (bf16: whole, 2e-2; fp32: elementwise, 1e-4) is sound when every
"sound" reading lies below it and each fault reads above it, on a
tensor it must show in, in every case it must show in. Exits non-zero
otherwise.

Time mode: the checkout's tree is "change"; `--tree` adds another
checkout root (for example the parent commit unpacked with `git
archive`), and `--variant` a tree's source with the named EDITS applied
(measurements only: some drop work on purpose, and their errors show
it). Each is called through its C interface, `k1_forward` and / or
`k1_backward` (`--direction`, both by default), on the shape's main-path
row, one 4096-token openvid sequence with its 256-token frames in bf16
(whisper: WHISPER_TIMES, 1 and 8 rows of the encoder's 1500 x 1500 and
of the cross-attention's 448 over 1500, fp32, full, either direction;
the forward also at LONG_ROW, the longest packed row in fp32 at head_dim
64, 4096 tokens with frames at 12:2 causal), held to the plain
version (forward: max|err| / max|plain| of o, the LSE's largest error
on rows with keys, and whether two calls give the same o and LSE bits;
backward: max|err| / max|plain| of dq, dk, dv (fp32 also max|err| /
max(1, |plain|)), and whether two calls give the same bits: dk and dv,
in fp32 dq too), and timed in turns, forwards then backwards,
`--rounds` times (CUDA events, 10 calls after 2; fp32 also the
kernels' own time from torch.profiler, `device_ms`, and by kernel),
beside SDPA with the tables' boolean mask (fp32: SDPA in fp32 with TF32
off, without a mask in full mode) and `chip_smoke.py`'s bound
(`packed_bound`, forward or backward; fp32 at split TF32, the
kernels' own arithmetic, with the CUDA-core bound beside it).
The bf16 forward also prints `waves`: how far the last wave of its
blocks runs past a perfect balance over the card's SMs, modelled from
the row's live key tiles.
"""
import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
CU = os.path.join("src", "repro_torch", "kernels", "csrc",
                  "flash_attention_packed.cu")
REL_TOL_BF16 = 2e-2     # as in chip_smoke.py
TOL_F32 = 1e-4          # chip_smoke.py's fp32 limit (TOL, GRAD_TOL)
S = 4096                # the main path's row

#: shape -> query heads, KV heads, head_dim, the mode and window of the
#: model's attention, its vocabulary (for the data loader) and the dtype
#: it runs K1 in
SHAPES = {
    "internvl": dict(H=12, HKV=2, D=128, mode="causal", window=None,
                     vocab=151674, dtype="bfloat16"),
    "rg": dict(H=10, HKV=1, D=256, mode="sliding", window=2048,
               vocab=256000, dtype="bfloat16"),
    "pixtral": dict(H=32, HKV=8, D=160, mode="causal", window=None,
                    vocab=131072, dtype="bfloat16"),
    "whisper": dict(H=12, HKV=12, D=64, mode="full", window=None,
                    vocab=51865, dtype="float32"),
}
#: whisper's timed shapes: (rows, query rows) over its 1500 frames, the
#: encoder's and the cross-attention's at 1 row and at the training
#: batch's 8
WHISPER_TIMES = ((1, 1500), (8, 1500), (1, 448), (8, 448))
WHISPER_FRAMES = 1500


def limit(shape):
    """(reading, limit) a shape's faults are held to: fp32's elementwise
    1e-4, bf16's whole-tensor 2e-2."""
    return (("elementwise", TOL_F32) if SHAPES[shape]["dtype"] == "float32"
            else ("whole", REL_TOL_BF16))

#: fault name -> (the tensors it must show in, the tags of the cases it
#: must show in (None: every case), [(text, replacement)]); the backward
#: faults are planted in the bf16 kernel (packed_bwd_kv_kernel, every
#: head dim) and its group reduction, the forward ones (fwd_) in
#: packed_fwd_wg_kernel (every head dim)
_COMMON = {
    "sound": ((), None, []),
    "dq_drops_key_tile": (("dq",), None, [(
        "        if (row < Sq) red_add_v4(",
        "        if (row < Sq && k0 != 128) red_add_v4(")]),
    "bwd_skips_query_tile": (("dq", "dk", "dv"), None, [(
        "            FULL, qt < Sq && tile_live<SPANS>(",
        "            FULL, qt < Sq && qt != 192 && tile_live<SPANS>(")]),
    "dk_skips_query_tile": (("dk",), None, [(
        "        const uint64_t dsc = wg_desc(c0 + kk * 2048, SW_BLOCK, "
        "SW_GROUP);\n",
        "        const uint64_t dsc = wg_desc(c0 + kk * 2048, SW_BLOCK, "
        "SW_GROUP);\n        if (dk_warp && q0 == 192) continue;\n")]),
    "query_start_one_tile_late": (("dq", "dk", "dv"), None, [(
        "  i_lo = (i_lo / K_BQ) * K_BQ;\n",
        "  i_lo = (i_lo / K_BQ) * K_BQ + K_BQ;\n")]),
    "reduction_drops_a_head": (("dk", "dv"), None, [(
        "  for (int hh = 1; hh < G; ++hh) {",
        "  for (int hh = 1; hh < G - 1; ++hh) {")]),
    # the unmasked path taken one query tile past the window's edge (keys
    # within the window of the tile's first query but not its last): it
    # can show only where a row is longer than the window
    "unmasked_window_edge": (("dq", "dk", "dv"), ("past_window",), [(
        "                       kpos_w > q0 + K_BQ - 1 - p.window)));",
        "                       kpos_w > q0 - 1 - p.window)));")]),
    # the forward: key tile 2 (keys 128-191) never computed
    "fwd_drops_key_tile": (("o",), None, [(
        "        mine = (live_mine >> (j - live_base)) & 1u;",
        "        mine = (live_mine >> (j - live_base)) & 1u && j != 2;")]),
    # its unmasked path taken within the window of the rows' first row
    # but not their last: it can show only where a row is longer than
    # the window
    "fwd_unmasked_window_edge": (("o",), ("past_window",), [(
        "(p.mode != kSliding || kpos0 > r0 + 63 - p.window)));",
        "(p.mode != kSliding || kpos0 > r0 - 1 - p.window)));")]),
    # V read from the ring's other stage (the tile before, or the one
    # landing)
    "fwd_ring_stage_stale": (("o",), None, [(
        "smem_u32(ring + st * 2 * TB), va = ka + TB;",
        "smem_u32(ring + st * 2 * TB),\n"
        "                     va = smem_u32(ring + (st ^ 1) * 2 * TB) "
        "+ TB;")]),
    # the second warpgroup's rows formed from the first's queries
    "fwd_second_wg_reads_first_q": (("o",), None, [(
        "  const uint32_t qa = smem_u32(Qs + wg * TB);",
        "  const uint32_t qa = smem_u32(Qs);")]),
}
_CAUSAL = {
    # the unmasked path taken one query tile too far: the diagonal tile
    # (keys after some of its queries)
    "unmasked_causal_edge": (("dq", "dk", "dv"), ("causal",), [(
        "                     (kpos_w + 15 <= q0 &&",
        "                     (kpos_w + 15 <= q0 + K_BQ &&")]),
    # the forward's unmasked path one key tile past the diagonal: the tile
    # whose keys start at the rows' first (later keys than some rows)
    "fwd_unmasked_causal_edge": (("o",), ("causal",), [(
        "                    (kpos0 + W_BK - 1 <= r0 &&",
        "                    (kpos0 - 1 <= r0 &&")]),
}
#: faults of the fp32 forward at head_dim 64 (split TF32:
#: packed_fwd_f32_kernel), planted in its body; each must show in o or
#: the LSE (the backward, given that LSE, may show it too)
F32_FWD_FAULTS = {
    # S and P V in plain TF32: Q's and P's lo (registers) and K's and
    # V^T's lo (shared memory, once the block has split them) zeroed by
    # tests the compiler cannot fold,
    # so the build keeps the sound one's products and registers (K2's
    # deleted lo products gave a build whose P operands overwrote Q's lo
    # registers); the CPU replay (tests/test_torch_k1_f32_fwd_split.py)
    # reads 2.8e-4 in o at the encoder's shape
    "f32_fwd_lo_zeroed": (("o",), ("enc",), [
        ("      ql[kk][e] = lo_of(x, qh[kk][e]);",
         "      ql[kk][e] = Sq < 0 ? lo_of(x, qh[kk][e]) : 0u;"),
        ("                                    Kh + 3 * TF, tid);\n",
         "                                    Kh + 3 * TF, tid);\n"
         "    __syncthreads();\n"
         "    for (int i = tid; i < TF / 4; i += T_THREADS) {\n"
         "      reinterpret_cast<uint32_t*>(Kh + TF)[i] = Sq < 0 ? 1u : 0u;\n"
         "      reinterpret_cast<uint32_t*>(Kh + 3 * TF)[i] = "
         "Sq < 0 ? 1u : 0u;\n"
         "    }\n"),
        ("      split_acc(s, ph, pl);\n",
         "      split_acc(s, ph, pl);\n"
         "      for (int kk = 0; kk < NK; ++kk)\n"
         "        for (int e = 0; e < 4; ++e)\n"
         "          pl[kk][e] = Sq < 0 ? pl[kk][e] : 0u;\n")]),
    # the last key tile of each block's walk never formed (over 1500
    # frames the partial one of 28 keys)
    "f32_fwd_last_key_tile_skipped": (("o", "lse"), ("full",), [(
        "  const int jt_hi = (j_hi + T_KEYS - 1) / T_KEYS;",
        "  const int jt_hi = (j_hi + T_KEYS - 1) / T_KEYS - 1;")]),
    # V^T's keys in their own order, not in the order of P's A operand
    # (a key's probability meets another key's values): the shared split
    # helper takes the order as a parameter that only the forward's call
    # turns off
    "f32_fwd_v_keys_unpermuted": (("o",), None, [
        ("                                           unsigned char* "
         "tlo, int tid) {",
         "                                           unsigned char* "
         "tlo, int tid, bool perm = true) {"),
        ("      const int p = kap(r);",
         "      const int p = perm ? kap(r) : r;"),
        ("                                    Kh + 3 * TF, tid);",
         "                                    Kh + 3 * TF, tid, false);")]),
    # the LSE written in log2 units (the backward multiplies it by
    # log2(e) and would read it wrong)
    "f32_fwd_lse_log2": (("lse",), None, [(
        "          l[i] > 0.f ? m[i] * LN2 + logf(l[i]) : -INFINITY;",
        "          l[i] > 0.f ? m[i] + log2f(l[i]) : -INFINITY;")]),
    # query head h reads KV head h (clamped to the KV heads, so that
    # every read stays in the tensor), not h / (H / Hkv): shows where H
    # > Hkv
    "f32_fwd_gqa_head_map": (("o",), ("gqa",), [(
        "  const int hk = h / (p.H / p.Hkv);",
        "  const int hk = min(h, p.Hkv - 1);")]),
    # the pair mask skipped in a live tile whose keys are not all in the
    # rows' segment (a segment's edge; past Sk, the kv padding of the
    # last partial tile)
    "f32_fwd_unmasked_across_segments": (("o",), None, [(
        "      whole = __all_sync(FULL, one_seg && whole && kseg[lane] == "
        "seg_w &&\n                                   kseg[lane + 32] == "
        "seg_w);",
        "      whole = __all_sync(FULL, one_seg && whole);")]),
}
FAULTS = {
    "internvl": {**_COMMON, **_CAUSAL},
    # D = 160 alone: the third, half-used 64-column block of the tiles
    "pixtral": {
        **_COMMON,
        **_CAUSAL,
        # O's columns 128-159 formed from V's second block, not its third
        "fwd_v_third_block": (("o",), None, [(
            "          const uint32_t v3 = va + 2 * SW_BLOCK + kk * 2048;",
            "          const uint32_t v3 = va + SW_BLOCK + kk * 2048;")]),
        # dK / dV's columns 128-159 formed from the second block of Q /
        # dO, not the third
        "bwd_third_block": (("dk", "dv"), None, [(
            "          const uint32_t hi3 = c0 + 2 * SW_BLOCK + kk * 2048;",
            "          const uint32_t hi3 = c0 + SW_BLOCK + kk * 2048;")]),
        # dQ's third chunk (columns 128-159) never formed
        "dq_third_chunk_dropped": (("dq",), None, [(
            "      if (chunk >= DP / 64) break;",
            "      if (chunk >= DP / 64 || chunk == 2) break;")]),
        # the forward's zero-fill left out: Q's and K's upper 32 columns
        # read their first 8 again (the scores gain their product)
        "fwd_zero_fill_left_out": (("o",), None, [
            ("               qp < Sq && c < CH);",
             "               qp < Sq);"),
            ("      cp_async16(Ks + sw128<W_BK>(r, c), kb + off, "
             "kp < Sk && c < CH);",
             "      cp_async16(Ks + sw128<W_BK>(r, c), kb + off, "
             "kp < Sk);")]),
        # the backward's: K's, V's, Q's and dO's upper 32 columns
        "bwd_zero_fill_left_out": (("dq", "dk", "dv"), None, [
            ("    const bool in = kp < Sk && c < CH;",
             "    const bool in = kp < Sk;"),
            ("      const bool in = qp < Sq && c < CH;",
             "      const bool in = qp < Sq;")]),
        # the softmax scale taken at the tiles' 192 columns, not 160
        "fwd_scale_at_192": (("o",), None, [(
            "  const float sl2 = scale * 1.4426950408889634f;",
            "  const float sl2 = rsqrtf((float)DP) * 1.4426950408889634f;")]),
        "bwd_scale_at_192": (("dq", "dk", "dv"), None, [(
            "  const float scale = 1.f / sqrtf((float)D);\n"
            "  const int rows = p.B * p.Sq * p.H;",
            "  const float scale = 1.f / sqrtf((float)BwdKvTile<D>::DP);\n"
            "  const int rows = p.B * p.Sq * p.H;")]),
    },
    # fp32 at head_dim 64 (whisper-small): the split-TF32 backward
    "whisper": {
        "sound": ((), None, []),
        # dK += dS^T Q in plain TF32: dS^T's lo (registers) and Q^T's
        # lo (shared memory, between two barriers) zeroed by tests the
        # compiler cannot fold, so the build keeps the sound one's
        # products; the CPU replay (tests/test_torch_k1_f32_split.py)
        # reads 2.0e-4 in dk at the encoder's shape
        "f32_lo_dropped": (("dk",), ("enc",), [
            ("    split_acc(dp, dh, dl);\n    float tv[KD][4], tk[KD][4];",
             "    split_acc(dp, dh, dl);\n"
             "    for (int kk = 0; kk < NQ; ++kk)\n"
             "      for (int e = 0; e < 4; ++e)\n"
             "        dl[kk][e] = Sq < 0 ? dl[kk][e] : 0u;\n"
             "    float tv[KD][4], tk[KD][4];"),
            ("    fence_proxy_async();  // the split tiles are seen by "
             "wgmma's reads\n    __syncthreads();\n"
             "    // the next live tile, of this head or the next, lands "
             "meanwhile\n",
             "    __syncthreads();\n"
             "    for (int i = tid; i < TS / 4; i += T_THREADS)\n"
             "      reinterpret_cast<uint32_t*>(QTlo)[i] = Sq < 0 ? 1u : 0u;\n"
             "    fence_proxy_async();\n    __syncthreads();\n")]),
        # the dK / dV kernel's last query tile never formed (the partial
        # one over 1500 rows, the 14th of 448)
        "f32_last_query_tile_skipped": (("dk", "dv"), ("full",), [(
            "        const bool live = qt < Sq && tile_live<SPANS>(",
            "        const bool live = qt + T_STEP < Sq && tile_live<SPANS>(")]),
        # the dK / dV kernel's grid a block of 128 keys short: the last
        # keys' dk and dv never written
        "f32_last_key_tile_skipped": (("dk", "dv"), ("full",), [(
            "    const dim3 grid((p.Sk + T_BLOCK - 1) / T_BLOCK, p.Hkv, p.B);",
            "    const dim3 grid((p.Sk - 1) / T_BLOCK, p.Hkv, p.B);")]),
        # dO^T's queries in their own order, not in the order of P^T's A
        # operand (a query's probability meets another query's dO)
        "f32_dot_queries_unpermuted": (("dv",), None, [
            ("                                           unsigned char* "
             "tlo, int tid) {",
             "                                           unsigned char* "
             "tlo, int tid, bool perm = true) {"),
            ("      const int p = kap(r);",
             "      const int p = perm ? kap(r) : r;"),
            ("    split_step<T_STEP, true, true>(Ld, dOhi, dOlo, dOThi, dOTlo, "
             "tid);",
             "    split_step<T_STEP, true, true>(Ld, dOhi, dOlo, dOThi, dOTlo, "
             "tid, false);")]),
        # dS^T = P^T dP^T scale: delta = rowsum(dO o) never subtracted
        "f32_delta_skipped": (("dk",), None, [(
            "        dp[n][e] = pv * (dp[n][e] - c_delta[c]) * scale;",
            "        dp[n][e] = pv * dp[n][e] * scale;")]),
        # dS^T without the softmax scale 1/sqrt(64)
        "f32_ds_scale_dropped": (("dk",), None, [(
            "        dp[n][e] = pv * (dp[n][e] - c_delta[c]) * scale;",
            "        dp[n][e] = pv * (dp[n][e] - c_delta[c]);")]),
        # the dQ kernel's last live key tile adds nothing to dQ
        "f32_dq_last_key_tile_dropped": (("dq",), ("full",), [(
            "    acc_product(tq, dh, dl, smem_u32(KThi), smem_u32(KTlo));",
            "    if (jn < jt_hi)\n"
            "      acc_product(tq, dh, dl, smem_u32(KThi), smem_u32(KTlo));")]),
        **F32_FWD_FAULTS,
    },
    "rg": {
        **_COMMON,
        # D = 256 alone: O's upper 128 columns formed from the wrong
        # 64-wide block of V (a block stride of 1 for 2)
        "fwd_pv_upper_block": (("o",), None, [(
            "          const uint32_t vhi = va + 2 * SW_BLOCK + kk * 2048;",
            "          const uint32_t vhi = va + SW_BLOCK + kk * 2048;")]),
        # D = 256 alone: dK / dV's upper 128 columns formed from the
        # wrong 64-wide block of Q / dO (a block stride of 1 for 2)
        "block_stride_256": (("dk", "dv"), None, [(
            "          const uint32_t hi = c0 + 2 * SW_BLOCK + kk * 2048;",
            "          const uint32_t hi = c0 + SW_BLOCK + kk * 2048;")]),
        # D = 256 alone: each warpgroup's second 64-column chunk of dQ
        # (columns 128-255) never formed
        "dq_drops_second_chunk": (("dq",), None, [(
            "      if (chunk >= DP / 64) break;",
            "      if (chunk >= DP / 64 || j2 > 0) break;")]),
    },
}

#: measurement-only edits of this tree's kernel for `--time --variant`
#: (the fwd_ ones edit the forward, every head dim, the others the
#: backward)
EDITS = {
    "no_dq_adds": [("        if (row < Sq) red_add_v4(",
                    "        if (row < -1) red_add_v4(")],
    "no_dq": [("    for (int j2 = 0; j2 < (DP / 64 + 1) / 2; ++j2) {",
               "    for (int j2 = 0; j2 < 0; ++j2) {")],
    "unmasked": [(
        "      all_ok = __all_sync(FULL, all_ok && segq_s[lane] == seg_w &&\n"
        "                                    segq_s[lane + 32] == seg_w);",
        "      all_ok = p.B > 0;")],
    # as many blocks an SM as a two-stage ring of query tiles would allow
    # at D = 128 (D = 160 and 256 have one an SM whatever)
    "one_block_per_sm": [
        ("  static constexpr int MIN_BLOCKS = D > 128 ? 1 : 2;",
         "  static constexpr int MIN_BLOCKS = 1;"),
        ("      1024 + 4 * TB + K_BK * K_BQ * 2 +",
         "      1024 + 6 * TB + K_BK * K_BQ * 2 +")],
    # what the unmasked path bought: every tile tests every pair
    "fwd_masked": [("      bool whole = one_seg &&",
                    "      bool whole = false &&")],
    # what the pair mask still costs: every tile unmasked
    "fwd_unmasked": [(
        "      whole = __all_sync(FULL, whole && segk_s[lane] == seg_w &&\n"
        "                                   segk_s[lane + 32] == seg_w);",
        "      whole = p.B > 0;")],
    # what the ring bought: one stage, each tile loaded after the last
    # is computed
    "fwd_one_stage": [
        ("constexpr int W_STAGES = 2;", "constexpr int W_STAGES = 1;"),
        ("    if (jn < jt_hi) load_kv(jn, st ^ 1);", ""),
        ("    mine = mine_next;\n    st ^= 1;",
         "    mine = mine_next;\n    if (j < jt_hi) {\n"
         "      __syncthreads();\n      load_kv(j, 0);\n    }")],
    # one block an SM: up to 255 registers a thread, no spill (D = 256
    # has one an SM whatever)
    "fwd_one_block_per_sm": [(
        "__launch_bounds__(W_THREADS, FwdWgTile<D>::MIN_BLOCKS)",
        "__launch_bounds__(W_THREADS, 1)")],
    # a block of two warpgroups over the same 64 rows of two query heads
    # (H even, both heads of one KV head), sharing each K/V tile
    "fwd_two_heads": [
        ("Sk = p.Sk, h = blockIdx.x, b = blockIdx.z;",
         "Sk = p.Sk, h = 2 * blockIdx.x + wg, b = blockIdx.z;"),
        ("  const int q0 = ((Sq + W_BQ - 1) / W_BQ - 1 - (int)blockIdx.y) * "
         "W_BQ;",
         "  const int q0 = ((Sq + 63) / 64 - 1 - (int)blockIdx.y) * 64;"),
        ("  const int q1 = min(q0 + W_BQ, Sq);",
         "  const int q1 = min(q0 + 64, Sq);"),
        ("  const int r0 = q0 + 64 * wg;", "  const int r0 = q0;"),
        ("    const int r = i / CHP, c = i % CHP, qp = q0 + r;\n"
         "    cp_async16(Qs + (r / 64) * TB",
         "    const int r = i / CHP, c = i % CHP, qp = q0 + r % 64;\n"
         "    cp_async16(Qs + (r / 64) * TB"),
        ("               qb + (int64_t)(qp < Sq ? qp : q0) * q_stride +\n",
         "               qb + (r / 64 - wg) * D + (int64_t)(qp < Sq ? qp : "
         "q0) * q_stride +\n"),
        ("tile_live<SPANS>(p, b, q0 + 64, min(q0 + 128, Sq),",
         "tile_live<SPANS>(p, b, q0, min(q0 + 64, Sq),"),
        ("const dim3 grid(p.H, (p.Sq + W_BQ - 1) / W_BQ, p.B);",
         "const dim3 grid(p.H / 2, (p.Sq + 63) / 64, p.B);")],
    # what the order bought: the first query tiles issued first
    "fwd_light_first": [(
        "  const int q0 = ((Sq + W_BQ - 1) / W_BQ - 1 - (int)blockIdx.y) * "
        "W_BQ;",
        "  const int q0 = (int)blockIdx.y * W_BQ;")],
    # fp32 at head_dim 64: what splitting the walked tiles costs (the
    # shared split helper: the backward's two kernels and the forward;
    # the results are wrong)
    "f32_no_split_pass": [(
        "  for (int i = tid; i < ROWS * T_D / 4; i += T_THREADS) {",
        "  for (int i = tid; i < 0; i += T_THREADS) {")],
    # fp32 forward at head_dim 64: each tile's P V into a fresh
    # accumulator, added to O in fp32 registers, not into O on the
    # tensor cores
    "f32_fwd_fresh_accumulator": [
        ("        for (int e = 0; e < 4; ++e) acc[nd][e] *= corr[e >> 1];\n"
         "      pin(ph);\n      pin(pl);\n      pin(acc);",
         "        for (int e = 0; e < 4; ++e) tacc[nd][e] = 0.f;\n"
         "      pin(ph);\n      pin(pl);\n      pin(tacc);"),
        ("      uint32_t ph[NK][4], pl[NK][4];\n",
         "      uint32_t ph[NK][4], pl[NK][4];\n      float tacc[KD][4];\n"),
        ("      acc_product(acc, ph, pl, va, vla);",
         "      acc_product(tacc, ph, pl, va, vla);"),
        ("      wgmma_wait0();\n      pin(acc);\n    }",
         "      wgmma_wait0();\n      pin(tacc);\n"
         "      for (int nd = 0; nd < KD; ++nd)\n"
         "        for (int e = 0; e < 4; ++e)\n"
         "          acc[nd][e] = fmaf(acc[nd][e], corr[e >> 1], "
         "tacc[nd][e]);\n    }")],
    # fp32 forward: what splitting the K and V tiles costs: neither
    # split pass runs (o is wrong)
    "f32_fwd_no_split_pass": [(
        "    split_step<T_KEYS, true, false>(L, Kh, Kh + TF, nullptr, nullptr, "
        "tid);\n    split_step<T_KEYS, false, true>(L + TF, nullptr, nullptr, "
        "Kh + 2 * TF,\n                                    Kh + 3 * TF, "
        "tid);\n", "")],
    # fp32 at head_dim 64: what the lo products cost: each product as hi
    # hi' alone, the lo products deleted (plain TF32; measurements only):
    # the backward's products and, through the shared acc_product, the
    # forward's P V
    "f32_hi_products_only": [
        (f"    wgmma_tf32_ss<T_STEP>(&{acc}[0][0], wg_desc({a} + fo, 16, "
         f"SW_GROUP),\n                          wg_desc({b} + wo, 16, "
         f"SW_GROUP));\n", "")
        for acc, a, b in (("s", "al", "b"), ("s", "a", "bl"),
                          ("dp", "cl", "e"), ("dp", "c", "el"))] + [
        ("    wgmma_tf32<T_D>(&acc[0][0], l[kk], wg_desc(b + off, 16, "
         "SW_GROUP));\n", ""),
        ("    wgmma_tf32<T_D>(&acc[0][0], h[kk], wg_desc(bl + off, 16, "
         "SW_GROUP));\n", "")],
}

def plant(src: str, edits, what: str) -> str:
    """`src` with each (text, replacement) applied to its first match."""
    for text, new in edits:
        if text not in src:
            raise SystemExit(f"{what}: the text to edit is not in the source")
        src = src.replace(text, new, 1)
    return src


def csrc(root: str) -> str:
    """The kernels' source directory of the checkout at `root`."""
    return os.path.join(root, os.path.dirname(CU))


#: the kernels whose ptxas report (registers, spills) a build prints
PTXAS_KEYS = ("packed_bwd", "packed_fwd_wg", "packed_fwd_f32_kernel")


def build(sources: dict, tmp: str, roots: dict = None,
          keys=PTXAS_KEYS) -> dict:
    """label -> source text, built at once (one nvcc each), each copy
    including the headers of its tree's `csrc` (`roots`: label ->
    checkout root, this one by default); label -> loaded library."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    procs = {}
    for label, text in sources.items():
        cu, so = (os.path.join(tmp, f"{label}{ext}") for ext in (".cu", ".so"))
        with open(cu, "w") as f:
            f.write(text)
        inc = csrc((roots or {}).get(label, ROOT))
        procs[label] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", inc, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {label}:\n{log[-4000:]}")
        libs[label] = ctypes.CDLL(so)
        for line in ptxas_report(log, keys):
            print(f"{label}: {line}")
    return libs


def ptxas_report(log, keys=PTXAS_KEYS):
    """ptxas's registers, stack and spills of the entry functions whose
    (mangled) name holds one of `keys`, one line each."""
    out, name = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            key = next((k for k in keys if k in name), None)
        elif name and key and ("registers" in line or "spill" in line):
            # the kernel's name and template arguments, e.g.
            # packed_bwd_kv_kernelILi256ELb1EE: D = 256 with spans
            out.append(f"{name[name.find(key):][:36]} {line.strip()}")
    return out


# ------------------------------------------------------------ fault mode
def cases(shape):
    """(name, tags, segment table, span table or None, mode, window,
    extra): for internvl the layouts of chip_smoke.py phase 7 plus a
    long and a single segment, and sliding at 4096 tokens; for pixtral
    phase 7's 1024- and 4096-token layouts with frames, 1024 without,
    full and sliding at a window of 256; for rg a 4096-token row with
    and without frames and a two-row padded group (one segment a row, as
    the padded hybrid batch has) at the model's window, and a 4096-token
    row with frames at a window of 256; for whisper the encoder (1 x
    1500, "enc") and the cross-attention (2 x 448 over 1500 frames,
    "cross"), phase 7's 1024-token layout with spans causal, sliding at
    a window of 256 and causal at 12:2 heads ("gqa"), and its ring hop
    at 12:2 (the second half's queries over the first half's keys, their
    own tables, kv_offset -512; "hop"). `extra`: what a case sets beside
    the shape's heads (HKV; Sk, kseg, kspan, off: the key side's length
    and tables and kv_offset). The tags are the mode, those above and,
    where a row is longer than the window, "past_window"."""
    from chip_smoke import hybrid_tables, packed_layout
    out = []
    if shape == "whisper":
        F, z = WHISPER_FRAMES, lambda B, n: np.zeros((B, n), np.int32)
        seg, span = packed_layout(1024, [400, 300, 250], 128)
        kseg = seg[:512].copy()
        kseg[kseg < 0] = -2
        return [
            ("enc1500", {"full", "enc"}, z(1, F), None, "full", None, {}),
            ("cross2x448", {"full", "cross"}, z(2, 448), None, "full", None,
             dict(Sk=F, kseg=z(2, F))),
            ("causal1024_spans", {"causal"}, seg, span, "causal", None, {}),
            ("sliding1024_w256", {"sliding"}, seg, span, "sliding", 256,
             {}),
            ("gqa1024_causal", {"causal", "gqa"}, seg, span, "causal", None,
             dict(HKV=2)),
            ("hop512_gqa", {"causal", "gqa", "hop"}, seg[512:], span[512:],
             "causal", None, dict(HKV=2, Sk=512, kseg=kseg,
                                  kspan=span[:512], off=-512))]
    if shape == "pixtral":
        for n, lens in ((1024, [400, 300, 250]),
                        (4096, [1500, 900, 1200, 400])):
            out.append((f"S{n}_spansTrue",
                        *packed_layout(n, lens, 256, 32), "causal", None))
        out.append(("S1024_spansFalse",
                    *packed_layout(1024, [400, 300, 250]), "causal", None))
        out.append(("full1024", *packed_layout(1024, [400, 300, 250], 128),
                    "full", None))
        out.append(("sliding1024",
                    *packed_layout(1024, [400, 300, 250], 128), "sliding",
                    256))
    elif shape == "rg":
        window = SHAPES["rg"]["window"]
        for name, rows, n, frame, w in (
                ("rg4096_frames", 1, 4096, 256, window),
                ("rg4096_text", 1, 4096, None, window),
                ("rg2x2048_frames", 2, 2048, 256, window),
                ("rg4096_w256_frames", 1, 4096, 256, 256)):
            seg, span = hybrid_tables(rows, n, frame or 256)
            out.append((name, seg, span if frame else None, "sliding", w))
    else:
        for n, lens in ((1024, [400, 300, 250]),
                        (4096, [1500, 900, 1200, 400])):
            for frame in (None, 256):
                out.append((f"S{n}_spans{frame is not None}",
                            *packed_layout(n, lens, frame, 32), "causal",
                            None))
        out.append(("full1024", *packed_layout(1024, [400, 300, 250], 128),
                    "full", None))
        out.append(("sliding1024",
                    *packed_layout(1024, [400, 300, 250], 128), "sliding",
                    256))
        out.append(("sliding4096", *packed_layout(4096, [2600, 1200], 256),
                    "sliding", 256))
        out.append(("S4096_long", *packed_layout(4096, [2600, 1200], 256),
                    "causal", None))
        out.append(("S4096_one", *packed_layout(4096, [3900], 256, 64),
                    "causal", None))
    return [(name, {mode} | ({"past_window"} if window and
                              np.shape(seg)[-1] > window else set()),
             seg, span, mode, window, {})
            for name, seg, span, mode, window in out]


def readings(torch, shape):
    """One row of readings a case, through the port's wrappers and
    whatever library `build.load` hands them."""
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed, flash_attention_packed_bwd,
        flash_attention_packed_bwd_ref, flash_attention_packed_ref)
    D = SHAPES[shape]["D"]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    dt = getattr(torch, SHAPES[shape]["dtype"])
    t = lambda a: None if a is None else torch.as_tensor(a, device=dev)  # noqa: E731
    rows = []
    for name, tags, seg, span, mode, window, extra in cases(shape):
        H, HKV = SHAPES[shape]["H"], extra.get("HKV", SHAPES[shape]["HKV"])
        B, n = (1, len(seg)) if np.ndim(seg) == 1 else np.shape(seg)
        Sk = extra.get("Sk", n)
        q, do = (torch.randn(B, n, H, D, generator=gen, device=dev).to(dt)
                 for _ in range(2))
        k, v = (torch.randn(B, Sk, HKV, D, generator=gen, device=dev)
                .to(dt) for _ in range(2))
        segt = t(seg)
        kw = dict(mode=mode, window=window, span_ids=t(span),
                  kv_segment_ids=t(extra.get("kseg")),
                  kv_span_ids=t(extra.get("kspan")),
                  kv_offset=extra.get("off", 0))
        o, lse = flash_attention_packed(q, k, v, segt, return_lse=True, **kw)
        got = (o,) + tuple(flash_attention_packed_bwd(q, k, v, o, lse, do,
                                                      segt, **kw))
        ro, rlse = flash_attention_packed_ref(q, k, v, segt, **kw)
        want = (ro,) + tuple(flash_attention_packed_bwd_ref(
            q, k, v, ro, rlse, do, segt, **kw))
        row = {"case": name, "tags": sorted(tags), "lse": lse_errs(lse, rlse)}
        for name_t, a, r in zip(("o", "dq", "dk", "dv"), got, want):
            row[name_t] = errs(a, r)
        rows.append(row)
        del q, do, k, v, o, lse, got, want
        torch.cuda.empty_cache()
    return rows


def errs(a, r):
    """max|err| / max(1, |plain|) (`elementwise`) and max|err| /
    max|plain| (`whole`); a value that is not finite (a gradient never
    written) counts as an infinite error."""
    r = r.float()
    d = (a.float() - r).abs().nan_to_num(nan=float("inf"))
    return {"elementwise": (d / r.abs().clamp_min(1.0)).max().item(),
            "whole": d.max().item() / r.abs().max().item()}


def lse_errs(a, r):
    """`errs` of an LSE over the rows with a valid key; where the kernel
    and the plain version disagree on which rows have one (-inf), an
    infinite error."""
    import torch
    fin = torch.isfinite(r)
    if not torch.equal(torch.isfinite(a), fin):
        return {"elementwise": float("inf"), "whole": float("inf")}
    if not fin.any():
        return {"elementwise": 0.0, "whole": 0.0}
    return errs(a[fin], r[fin])


#: what fault mode reads, each case: the forward's o and LSE, the
#: backward's gradients (given that LSE)
READ = ("o", "lse", "dq", "dk", "dv")


def fault_mode(torch, tmp, shapes):
    from repro_torch.kernels import build as kbuild
    src = open(os.path.join(ROOT, CU)).read()
    # one build per distinct edited source: a fault of one name may sit
    # in another kernel at each shape (fwd_drops_key_tile)
    sources, label_of = {}, {}
    for shape in shapes:
        for fault, (_, _, edits) in FAULTS[shape].items():
            text = plant(src, edits, fault)
            label = next((lb for lb, t in sources.items() if t == text),
                         f"{shape}_{fault}")
            sources[label] = text
            label_of[shape, fault] = label
    libs = build(sources, tmp)
    result, ok = {}, True
    for shape in shapes:
        form, tol = limit(shape)
        for fault, (shows, tags, _) in FAULTS[shape].items():
            # the wrappers load "flash_attention_packed" through build.load
            kbuild._libs["flash_attention_packed"] = libs[
                label_of[shape, fault]]
            rows = readings(torch, shape)
            torch.cuda.synchronize()
            must = [r for r in rows
                    if tags is None or set(tags) & set(r["tags"])]
            for r in rows:
                print(json.dumps({"shape": shape, "fault": fault, **r}),
                      flush=True)
            for t in READ:
                whole = [r[t]["whole"] for r in must]
                elt = [r[t]["elementwise"] for r in must]
                print(f"{shape:8s} {fault:26s} {t:2s} whole "
                      f"{min(whole):.4g}-{max(whole):.4g}  elementwise "
                      f"{min(elt):.4g}-{max(elt):.4g}  ({len(must)} cases)")
            if fault == "sound":
                caught = [False]
                ok &= all(r[t][form] <= tol for r in rows for t in READ)
            else:
                caught = [max(r[t][form] for t in shows) > tol
                          for r in must]
                ok &= all(caught)
            result[f"{shape}:{fault}"] = {"rows": rows,
                                          "caught_in": sum(caught),
                                          "cases": len(must)}
    return {"ok": ok, "rel_tol_bf16": REL_TOL_BF16, "tol_f32": TOL_F32,
            "faults": result}


# ------------------------------------------------------------- time mode
def inputs(torch, shape):
    """The main path's row: one 4096-token openvid sequence with its
    frames (one segment: the packed and the padded tables agree), random
    bf16 q, k, v, dO (seed 0), o and LSE from K1."""
    from repro_torch.core.packing import flatten_group
    from repro_torch.data.pipeline import HeterogeneousLoader
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed)
    cfg = SHAPES[shape]
    H, HKV, D = cfg["H"], cfg["HKV"], cfg["D"]
    batch = next(HeterogeneousLoader("openvid", 8, cfg["vocab"], seed=0,
                                     max_tokens=S, tokens_per_frame=256))
    spans = batch.spans_by_id()
    info, toks = next((i, t) for i, t in zip(batch.infos, batch.tokens)
                      if len(t) == S)
    b, _ = flatten_group([toks], S, spans=[spans.get(info.seq_id)])
    dev = torch.device("cuda")
    seg = torch.as_tensor(b["segment_ids"][0], device=dev)
    span = torch.as_tensor(b["modality_ids"][0], device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, do = (torch.randn(1, S, H, D, generator=gen, device=dev).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(1, S, HKV, D, generator=gen, device=dev).bfloat16()
            for _ in range(2))
    kw = dict(mode=cfg["mode"], window=cfg["window"])
    o, lse = flash_attention_packed(q, k, v, seg, span_ids=span,
                                    return_lse=True, **kw)
    return dict(q=q, k=k, v=v, o=o, lse=lse, do=do, seg=seg, span=span,
                kseg=None, kw=kw, shape=shape)


def whisper_inputs(torch, B, Sq):
    """`B` rows of `Sq` queries over whisper-small's 1500 frames, one
    segment a row on each side (the encoder at Sq = 1500, the
    cross-attention at 448), random fp32 q, k, v, dO (seed 0), o and
    LSE from K1."""
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed)
    cfg = SHAPES["whisper"]
    H, HKV, D, F = cfg["H"], cfg["HKV"], cfg["D"], WHISPER_FRAMES
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q, do = (torch.randn(B, Sq, H, D, generator=gen, device=dev)
             for _ in range(2))
    k, v = (torch.randn(B, F, HKV, D, generator=gen, device=dev)
            for _ in range(2))
    seg = torch.zeros(B, Sq, dtype=torch.int32, device=dev)
    kseg = torch.zeros(B, F, dtype=torch.int32, device=dev)
    kw = dict(mode="full", window=None)
    o, lse = flash_attention_packed(q, k, v, seg, kv_segment_ids=kseg,
                                    return_lse=True, **kw)
    return dict(q=q, k=k, v=v, o=o, lse=lse, do=do, seg=seg, span=None,
                kseg=kseg, kw=kw, shape="whisper")


#: the longest row the main paths build, in fp32 at head_dim 64: one
#: 4096-token packed bucket with 256-token frames, 12:2 causal (the
#: forward's walk over up to 64 key tiles)
LONG_ROW = dict(H=12, HKV=2, D=64, mode="causal", window=None)


def long_row_inputs(torch):
    """LONG_ROW's row: random fp32 q, k, v (seed 0), one segment with
    256-token frames after every 32 text tokens."""
    from chip_smoke import packed_layout
    cfg = LONG_ROW
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(1, S, cfg["H"], cfg["D"], generator=gen, device=dev)
    k, v = (torch.randn(1, S, cfg["HKV"], cfg["D"], generator=gen,
                        device=dev) for _ in range(2))
    seg, span = packed_layout(S, [S], 256, 32)
    return dict(q=q, k=k, v=v, seg=torch.as_tensor(seg, device=dev),
                span=torch.as_tensor(span, device=dev), kseg=None,
                kw=dict(mode="causal", window=None), shape="whisper",
                cfg=cfg)


def _call_args(torch, x):
    """The tables and summaries of the rows, and their sizes, dtype and
    mode as k1_forward and k1_backward take them."""
    from repro_torch.kernels.flash_attention import MODES
    from repro_torch.kernels.flash_attention_packed import (_summaries,
                                                            _tables)
    cfg = x.get("cfg") or SHAPES[x["shape"]]
    q, k = x["q"], x["k"]
    B, Sq, Sk = q.shape[0], q.shape[1], k.shape[1]
    tables = [*_tables(q, k, x["seg"], x["span"], x["kseg"], None),
              _summaries(B, Sq, q.device), _summaries(B, Sk, q.device)]
    ints = [B, Sq, Sk, cfg["H"], cfg["HKV"], cfg["D"],
            int(q.dtype == torch.bfloat16), MODES[cfg["mode"]],
            int(cfg["window"] or 0), 0]
    return tables, ints


def _call(torch, fn, ptrs, ints, what):
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(*[None if t is None else t.data_ptr() for t in ptrs], *ints,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{what} returned {err}")


def forward(torch, lib, x):
    """o, lse through `lib`'s k1_forward."""
    q = x["q"]
    tables, ints = _call_args(torch, x)
    o = torch.empty_like(q)
    lse = torch.empty(ints[0], ints[3], ints[1], dtype=torch.float32,
                      device=q.device)
    _call(torch, lib.k1_forward, [q, x["k"], x["v"], o, lse, *tables], ints,
          "k1_forward")
    return o, lse


def backward(torch, lib, x):
    """dq, dk, dv through `lib`'s k1_backward. Trees from before the
    scratch pointer `work` (no k1_last_bwd_kv_launch) take none."""
    q, k = x["q"], x["k"]
    tables, ints = _call_args(torch, x)
    B, Sq, Sk, H, D = ints[0], ints[1], ints[2], ints[3], ints[5]
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(x["v"])
    delta = torch.empty(B, H, Sq, dtype=torch.float32, device=q.device)
    ptrs = [q, k, x["v"], x["o"], x["do"], x["lse"], delta, dq, dk, dv]
    if hasattr(lib, "k1_last_bwd_kv_launch"):
        work = 2 * B * Sk * H * D if q.dtype == torch.bfloat16 else 1
        ptrs.append(torch.empty(work, dtype=torch.float32, device=q.device))
    _call(torch, lib.k1_backward, ptrs + tables, ints, "k1_backward")
    return dq.to(q.dtype), dk, dv


def build_trees(tmp, trees, variants, cu=CU, edits=EDITS, keys=PTXAS_KEYS):
    """label -> library of each tree's source `cu` and of each variant (a
    tree's source with `edits` applied), built at once."""
    srcs = {label: open(os.path.join(root, cu)).read()
            for label, root in trees.items()}
    roots = dict(trees)
    for label, spec in variants.items():
        tree, names = spec.split(":")
        srcs[label] = plant(srcs[tree], [e for n in names.split("+")
                                         for e in edits[n]],
                            label)
        roots[label] = trees[tree]
    return build(srcs, tmp, roots, keys)


def _whole(a, r):
    return ((a.float() - r.float()).abs().max()
            / r.float().abs().max()).item()


def _readings_fwd(torch, libs, x, ref):
    """label -> whole error of o, the LSE's largest error on rows with
    keys, and whether two calls give the same bits."""
    ro, rlse = ref
    fin = torch.isfinite(rlse)
    rows = {}
    for label, lib in libs.items():
        (o, lse), (o2, lse2) = forward(torch, lib, x), forward(torch, lib, x)
        torch.cuda.synchronize()
        rows[label] = {
            "whole_err": {"o": _whole(o, ro)},
            "lse_err": (lse[fin] - rlse[fin]).abs().max().item(),
            "lse_rows_agree": bool(torch.equal(torch.isfinite(lse), fin)),
            "same_bits": bool(torch.equal(o, o2) and torch.equal(lse, lse2)),
            "ms": []}
    return rows


def _readings_bwd(torch, libs, x, ref):
    """label -> whole (and elementwise) errors of dq, dk, dv and whether
    two calls give the same dk and dv bits (`same_bits`) and dq's
    (`same_bits_dq`)."""
    rows = {}
    for label, lib in libs.items():
        got, again = backward(torch, lib, x), backward(torch, lib, x)
        torch.cuda.synchronize()
        e = {n: errs(a, r) for n, a, r in zip(("dq", "dk", "dv"), got, ref)}
        rows[label] = {
            "whole_err": {n: v["whole"] for n, v in e.items()},
            "elementwise_err": {n: v["elementwise"] for n, v in e.items()},
            "same_bits": bool(torch.equal(got[1], again[1])
                              and torch.equal(got[2], again[2])),
            "same_bits_dq": bool(torch.equal(got[0], again[0])),
            "ms": []}
    return rows


def waves(mask, H, slots, rows=128, keys=64):
    """The forward's blocks (one query head, `rows` query rows) as the
    card issues them, each taking one of `slots` block slots (SMs x
    blocks an SM) as one frees: the work of a block is its key tiles of
    `keys` with a valid pair (from the pair mask, [1, Sq, Sk]). For the
    heaviest query tiles first (as the kernel issues them) and the
    lightest first: the busiest slot's tiles beside the tiles of a
    perfect balance (all over `slots`); their ratio less 1 is the share
    the last wave adds. A model of the schedule, not a measurement."""
    import heapq
    _, Sq, Sk = mask.shape
    nq, nk = -(-Sq // rows), -(-Sk // keys)
    m = np.zeros((nq * rows, nk * keys), bool)
    m[:Sq, :Sk] = mask[0].cpu().numpy()
    work = m.reshape(nq, rows, nk, keys).any(axis=(1, 3)).sum(1)
    out = {"blocks": nq * H, "slots": slots, "tiles": int(work.sum()) * H,
           "balanced_tiles": float(work.sum()) * H / slots}
    for name, order in (("heavy_first", work[::-1]), ("light_first", work)):
        free = [0] * slots
        for w in np.repeat(order, H):
            heapq.heappush(free, heapq.heappop(free) + int(w))
        out[f"{name}_tiles"] = max(free)
        out[f"{name}_tail"] = max(free) / out["balanced_tiles"] - 1
    return out


def time_mode(torch, libs, shape, rounds, directions):
    """For each direction, every library held to the plain version and
    timed in turns (change, ..., ..., change), beside SDPA with the
    tables' boolean mask and chip_smoke.py's bound."""
    import torch.nn.functional as F
    from chip_smoke import cuda_ms, packed_bound
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed_bwd_ref, flash_attention_packed_ref,
        pair_mask, _tables)
    cfg = SHAPES[shape]
    H, HKV, D = cfg["H"], cfg["HKV"], cfg["D"]
    x = inputs(torch, shape)
    tabs = _tables(x["q"], x["k"], x["seg"], x["span"], None, None)
    mask = pair_mask(S, S, *tabs, **x["kw"])
    pairs = int(mask.sum())
    qt, kt, vt = (x[n].transpose(1, 2).contiguous().requires_grad_(True)
                  for n in ("q", "k", "v"))
    window = f" {cfg['window']}" if cfg["window"] else ""
    out = {"shape": f"B=1 S={S} H={H} Hkv={HKV} D={D} bf16 "
                    f"{cfg['mode']}{window} spans", "pairs": pairs}
    for direction in directions:
        ref_fn, readings_fn, call = (
            (flash_attention_packed_ref, _readings_fwd, forward)
            if direction == "fwd" else
            (flash_attention_packed_bwd_ref, _readings_bwd, backward))
        args = [x[n] for n in ("q", "k", "v")]
        if direction == "bwd":
            # the backward every library is given: the row's o and lse
            args += [x["o"], x["lse"], x["do"]]
        ref = ref_fn(*args, x["seg"], span_ids=x["span"], **x["kw"])
        rows = readings_fn(torch, libs, x, ref)
        del ref
        order = list(libs) + list(libs)[::-1]
        for _ in range(rounds):
            for label in order:
                rows[label]["ms"].append(cuda_ms(
                    lambda: call(torch, libs[label], x), iters=10,
                    warmup=2))
        if direction == "fwd":
            sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True),
                iters=10, warmup=2)
        else:
            o = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True)
            dot = x["do"].transpose(1, 2)
            sdpa = cuda_ms(lambda: torch.autograd.grad(
                o, (qt, kt, vt), dot, retain_graph=True), iters=10,
                warmup=2)
            del o
        bound, bound_by = packed_bound(1, S, S, H, HKV, D, torch.bfloat16,
                                       pairs, direction == "bwd", 2)
        for label, row in rows.items():
            print(f"{shape:8s} {direction} {label:24s} ms {row['ms']}  "
                  f"{ {k: v for k, v in row.items() if k != 'ms'} }")
        out[direction] = {"bound_ms": bound, "bound_by": bound_by,
                          "sdpa_ms": sdpa, "kernels": rows}
        if direction == "fwd":
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            out["fwd"]["waves"] = waves(mask, H,
                                        sms * (1 if D > 128 else 2))
            print(f"{shape:8s} fwd waves {out['fwd']['waves']}")
    return out


def time_whisper(torch, libs, rounds, directions):
    """Each direction at WHISPER_TIMES: every library held to the plain
    version and timed in turns (change, ..., ..., change), by events
    and by torch.profiler (each kernel apart), beside the plain version,
    SDPA in fp32 (TF32 off, full mode without a mask; events and
    device time) and chip_smoke.py's bounds (split TF32, and the fp32
    CUDA cores beside it). One row a shape and direction."""
    import torch.nn.functional as F
    from chip_smoke import (PEAK_TF32, SPLIT_TF32, cuda_ms, device_ms,
                            device_ms_by_kernel, packed_bound)
    from repro_torch.kernels.flash_attention_packed import (
        flash_attention_packed_bwd_ref, flash_attention_packed_ref)
    cfg = SHAPES["whisper"]
    H, HKV, D = cfg["H"], cfg["HKV"], cfg["D"]
    out = []
    for B, Sq in WHISPER_TIMES:
        x = whisper_inputs(torch, B, Sq)
        kw = dict(kv_segment_ids=x["kseg"], **x["kw"])
        qt, kt, vt = (x[n].transpose(1, 2).contiguous().requires_grad_(True)
                      for n in ("q", "k", "v"))
        pairs = B * Sq * WHISPER_FRAMES
        for direction in directions:
            bwd = direction == "bwd"
            args = [x[n] for n in ("q", "k", "v")]
            if bwd:
                args += [x[n] for n in ("o", "lse", "do")]
            ref_fn = (flash_attention_packed_bwd_ref if bwd
                      else flash_attention_packed_ref)
            call = backward if bwd else forward
            ref = ref_fn(*args, x["seg"], **kw)
            if bwd:
                rows = _readings_bwd(torch, libs, x, ref)
            else:
                rows = _readings_fwd(torch, libs, x, ref)
                for label, lib in libs.items():
                    rows[label]["elementwise_err"] = {
                        "o": errs(forward(torch, lib, x)[0], ref[0])[
                            "elementwise"]}
            plain_ms = cuda_ms(lambda: ref_fn(*args, x["seg"], **kw),
                               iters=3, warmup=1)
            del ref
            for row in rows.values():
                row["device_ms"], row["by_kernel"] = [], []
            order = list(libs) + list(libs)[::-1]
            for _ in range(rounds):
                for label in order:
                    fn = (lambda lib=libs[label]: call(torch, lib, x))
                    rows[label]["ms"].append(cuda_ms(fn, iters=10, warmup=2))
                    rows[label]["device_ms"].append(
                        device_ms(fn, iters=5, warmup=1)[0])
                    rows[label]["by_kernel"].append(
                        device_ms_by_kernel(fn, iters=5, warmup=1))
            if bwd:
                o = F.scaled_dot_product_attention(qt, kt, vt)
                dot = x["do"].transpose(1, 2)

                def sdpa():
                    return torch.autograd.grad(o, (qt, kt, vt), dot,
                                               retain_graph=True)
            else:
                def sdpa():
                    return F.scaled_dot_product_attention(qt, kt, vt)
            sdpa_ms = cuda_ms(sdpa, iters=10, warmup=2)
            sdpa_device_ms = device_ms(sdpa, iters=5, warmup=1)[0]
            shape = (B, Sq, WHISPER_FRAMES, H, HKV, D, torch.float32,
                     pairs, bwd, 1)
            bound, bound_by = packed_bound(*shape, SPLIT_TF32)
            r = {"direction": direction,
                 "shape": f"B={B} Sq={Sq} Sk={WHISPER_FRAMES} H={H} "
                          f"Hkv={HKV} D={D} fp32 full",
                 "bound_ms": bound, "bound_by": bound_by,
                 "bound_cuda_core_ms": packed_bound(*shape)[0],
                 "plain_ms": plain_ms, "sdpa_fp32_ms": sdpa_ms,
                 "sdpa_fp32_device_ms": sdpa_device_ms, "kernels": rows}
            if bwd:
                # the two kernels' own products: S and dP in each, 21
                # TF32 products a pair for the function's 15
                r["bound_two_kernel_split_tf32_ms"] = (
                    3 * 14.0 * D * pairs * H / PEAK_TF32 * 1e3)
            for label, row in rows.items():
                print(f"whisper {direction} {B}x{Sq} {label:20s} ms "
                      f"{row['ms']} device_ms {row['device_ms']} by_kernel "
                      f"{row['by_kernel'][-1]} err {row['elementwise_err']} "
                      f"same_bits {row['same_bits']}"
                      + (f" dq {row['same_bits_dq']}" if bwd else
                         f" lse_err {row['lse_err']}"))
            print(f"whisper {direction} {B}x{Sq} " + json.dumps(
                {k: v for k, v in r.items() if k != "kernels"}))
            out.append(r)
        del x, args, qt, kt, vt
        torch.cuda.empty_cache()
    if "fwd" in directions:
        out.append(time_long_row(torch, libs, rounds))
    return out


def time_long_row(torch, libs, rounds):
    """The forward at LONG_ROW: every library's o (elementwise) and LSE
    against the plain version, the same bits twice, and its time in
    turns (events and device time), beside the plain version, SDPA with
    the tables' boolean mask (fp32, TF32 off) and the bounds."""
    import torch.nn.functional as F
    from chip_smoke import SPLIT_TF32, cuda_ms, device_ms, packed_bound
    from repro_torch.kernels.flash_attention_packed import (
        _tables, flash_attention_packed_ref, pair_mask)
    cfg = LONG_ROW
    x = long_row_inputs(torch)
    kw = dict(span_ids=x["span"], **x["kw"])
    ref = flash_attention_packed_ref(x["q"], x["k"], x["v"], x["seg"], **kw)
    rows = _readings_fwd(torch, libs, x, ref)
    for label, lib in libs.items():
        rows[label]["elementwise_err"] = {
            "o": errs(forward(torch, lib, x)[0], ref[0])["elementwise"]}
        rows[label]["device_ms"] = []
    plain_ms = cuda_ms(lambda: flash_attention_packed_ref(
        x["q"], x["k"], x["v"], x["seg"], **kw), iters=3, warmup=1)
    del ref
    order = list(libs) + list(libs)[::-1]
    for _ in range(rounds):
        for label in order:
            fn = (lambda lib=libs[label]: forward(torch, lib, x))
            rows[label]["ms"].append(cuda_ms(fn, iters=10, warmup=2))
            rows[label]["device_ms"].append(device_ms(fn, iters=5,
                                                      warmup=1)[0])
    tabs = _tables(x["q"], x["k"], x["seg"], x["span"], None, None)
    mask = pair_mask(S, S, *tabs, mode="causal")
    qt, kt, vt = (x[n].transpose(1, 2).contiguous() for n in ("q", "k", "v"))

    def sdpa():
        return F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask[:, None], enable_gqa=True)
    pairs = int(mask.sum())
    shape = (1, S, S, cfg["H"], cfg["HKV"], cfg["D"], torch.float32, pairs,
             False, 2)
    bound, bound_by = packed_bound(*shape, SPLIT_TF32)
    r = {"direction": "fwd",
         "shape": f"B=1 S={S} H={cfg['H']} Hkv={cfg['HKV']} D={cfg['D']} "
                  f"fp32 causal spans",
         "pairs": pairs, "bound_ms": bound, "bound_by": bound_by,
         "bound_cuda_core_ms": packed_bound(*shape)[0],
         "plain_ms": plain_ms,
         "sdpa_fp32_ms": cuda_ms(sdpa, iters=10, warmup=2),
         "sdpa_fp32_device_ms": device_ms(sdpa, iters=5, warmup=1)[0],
         "kernels": rows}
    for label, row in rows.items():
        print(f"long row fwd {label:20s} ms {row['ms']} device_ms "
              f"{row['device_ms']} err {row['elementwise_err']} lse_err "
              f"{row['lse_err']} same_bits {row['same_bits']}")
    print("long row fwd " + json.dumps(
        {k: v for k, v in r.items() if k != "kernels"}))
    del x, qt, kt, vt, mask
    torch.cuda.empty_cache()
    return r


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--time", action="store_true",
                    help="time the kernels of trees and variants")
    ap.add_argument("--direction", choices=("fwd", "bwd", "both"),
                    default="both", help="what --time times")
    ap.add_argument("--shape", action="append", choices=sorted(SHAPES),
                    help="internvl (the default), rg, pixtral or "
                         "whisper; repeatable")
    ap.add_argument("--tree", action="append", default=[])
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out", help="write every reading to this JSON file")
    args = ap.parse_args()
    shapes = args.shape or ["internvl"]
    directions = (("fwd", "bwd") if args.direction == "both"
                  else (args.direction,))
    import torch
    if not torch.cuda.is_available():
        print("k1_fault_check: no CUDA device visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # the fp32 references
    torch.backends.cudnn.allow_tf32 = False
    from chip_smoke import card_line
    card = card_line()
    print(card)
    tmp = tempfile.mkdtemp()
    try:
        if args.time:
            trees = {"change": ROOT}
            trees.update(t.split("=", 1) for t in args.tree)
            libs = build_trees(tmp, trees, dict(v.split("=", 1)
                                                for v in args.variant))
            # the inputs' forward runs this tree's library too
            from repro_torch.kernels import build as kbuild
            kbuild._libs["flash_attention_packed"] = libs["change"]
            result = {"times": {
                shape: (time_whisper(torch, libs, args.rounds, directions)
                        if shape == "whisper" else
                        time_mode(torch, libs, shape, args.rounds,
                                  directions))
                for shape in shapes}}
        else:
            result = fault_mode(torch, tmp, shapes)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result["card"] = card
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    if "times" in result:
        summary = {"card": card, "times": {
            shape: ([{k: v for k, v in row.items() if k != "kernels"}
                     for row in r] if shape == "whisper" else
                    {d: ({k: v for k, v in r[d].items() if k != "kernels"}
                         if d in directions else r[d]) for d in r})
            for shape, r in result["times"].items()}}
    else:
        summary = {k: v for k, v in result.items() if k != "faults"}
        summary["caught"] = {f: f"{r['caught_in']}/{r['cases']}"
                             for f, r in result["faults"].items()
                             if not f.endswith(":sound")}
    print(json.dumps(summary))
    return 0 if result.get("ok", True) else 1


if __name__ == "__main__":
    sys.exit(main())
