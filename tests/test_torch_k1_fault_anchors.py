"""`k1_fault_check.py`'s planted faults and measurement edits against
the committed K1 source.

The script plants each fault by replacing a piece of text of
`csrc/flash_attention_packed.cu` (its first match) and builds the copy
on the card. An edit whose text has gone from the source, or occurs
twice, would plant nothing or plant it in the wrong place; these tests
catch that here, without a card, for every shape the script checks.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "k1_fault_check", os.path.join(ROOT, "k1_fault_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


K1 = _load_script()
SOURCE = open(os.path.join(ROOT, K1.CU)).read()
PLANTED = [(shape, name) for shape, faults in sorted(K1.FAULTS.items())
           for name in sorted(faults) if name != "sound"]


@pytest.mark.parametrize("shape,fault", PLANTED)
def test_planted_fault_text_occurs_once(shape, fault):
    _, _, edits = K1.FAULTS[shape][fault]
    assert edits
    for text, new in edits:
        assert SOURCE.count(text) == 1, (shape, fault, text)
        assert new != text


@pytest.mark.parametrize("edit", sorted(K1.EDITS))
def test_measurement_edit_text_occurs_once(edit):
    for text, _ in K1.EDITS[edit]:
        assert SOURCE.count(text) == 1, (edit, text)


@pytest.mark.parametrize("shape,fault", PLANTED)
def test_each_fault_must_show_in_some_case(shape, fault):
    """A fault is held to the limit in the cases whose tags it names; at
    recurrentgemma-2b's shape the window's edge needs a row longer than
    the window of 2048."""
    _, tags, _ = K1.FAULTS[shape][fault]
    cases = K1.cases(shape)
    must = [c for c in cases if tags is None or set(tags) & c[1]]
    assert must, (shape, fault)
    if fault == "unmasked_window_edge":
        assert all(seg.shape[-1] > window
                   for _, _, seg, _, _, window, _ in must)
    if fault in ("f32_lo_dropped", "f32_fwd_lo_zeroed"):
        # plain TF32 in dK's product, or in the forward's, misses 1e-4 at
        # the encoder's shape (tests/test_torch_k1_f32_split.py,
        # tests/test_torch_k1_f32_fwd_split.py), not necessarily elsewhere
        assert [c[0] for c in must] == ["enc1500"]
    if fault == "f32_fwd_gqa_head_map":
        # a wrong head map shows only where query heads share a KV head
        assert all(c[6].get("HKV", K1.SHAPES[shape]["HKV"])
                   < K1.SHAPES[shape]["H"] for c in must)


def test_wave_model_places_blocks_in_issue_order():
    """`waves` gives each block, in the order the card issues them, the
    slot that frees first: causal 256 x 256 at two heads has query tiles
    of 2 and 4 live key tiles; on 3 slots the heaviest first end
    together (4 tiles each), the lightest first leave one slot 6."""
    mask = torch.ones(1, 256, 256, dtype=torch.bool).tril()
    w = K1.waves(mask, 2, 3)
    assert (w["blocks"], w["tiles"], w["balanced_tiles"]) == (4, 12, 4.0)
    assert (w["heavy_first_tiles"], w["light_first_tiles"]) == (4, 6)
    assert w["heavy_first_tail"] == 0.0
    assert w["light_first_tail"] == pytest.approx(0.5)


def test_pixtral_shape_is_the_configs_heads():
    """The pixtral shape is pixtral-12b's attention: 32 query heads over
    8 KV heads of 5120 / 32 = 160, causal."""
    from repro_torch.configs import get_config
    cfg = get_config("pixtral-12b")
    shape = K1.SHAPES["pixtral"]
    assert (shape["H"], shape["HKV"], shape["D"]) == (
        cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim) == (32, 8, 160)
    assert shape["mode"] == "causal" and shape["vocab"] == cfg.vocab


@pytest.mark.parametrize("fault", ["fwd_v_third_block", "bwd_third_block"])
def test_third_block_faults_edit_the_head_dim_160_products(fault):
    """The third 64-column block's products exist only where the tiles
    are 192 columns wide (D = 160): the planted text is the first line
    of an `if constexpr (DP == 192)` block."""
    (text, _), = K1.FAULTS["pixtral"][fault][2]
    before = SOURCE[:SOURCE.index(text)].rstrip().splitlines()[-1]
    assert before.strip() == "if constexpr (DP == 192) {", fault


def test_fp32_cases_run_at_whisper_heads_and_gqa():
    """The whisper shape is whisper-small's attention in training (fp32,
    12:12 heads of 64, full), its cases the encoder's 1 x 1500 and the
    cross-attention's 448 over 1500 frames, causal with spans, sliding,
    GQA at 12:2 and a ring hop at 12:2 with its own key tables and a
    kv_offset; every fault planted there is an `f32_*` fault, held to
    fp32's elementwise 1e-4, as are the fp32 shapes' at head_dim 128 and
    160; the bf16 shapes' to bf16's whole-tensor 2e-2."""
    from repro_torch.configs import get_config
    cfg = get_config("whisper-small")
    shape = K1.SHAPES["whisper"]
    assert (shape["H"], shape["HKV"], shape["D"]) == (
        cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim) == (12, 12, 64)
    assert shape["dtype"] == "float32" and shape["mode"] == "full"
    got = {}
    for name, tags, seg, span, mode, window, extra in K1.cases("whisper"):
        B, Sq = (1, len(seg)) if seg.ndim == 1 else seg.shape
        got[name] = (B, Sq, extra.get("Sk", Sq), extra.get("HKV", 12),
                     mode, window, span is not None, extra.get("off", 0))
    assert got == {
        "enc1500": (1, 1500, 1500, 12, "full", None, False, 0),
        "cross2x448": (2, 448, 1500, 12, "full", None, False, 0),
        "causal1024_spans": (1, 1024, 1024, 12, "causal", None, True, 0),
        "sliding1024_w256": (1, 1024, 1024, 12, "sliding", 256, True, 0),
        "gqa1024_causal": (1, 1024, 1024, 2, "causal", None, True, 0),
        "hop512_gqa": (1, 512, 512, 2, "causal", None, True, -512)}
    faults = [f for f in K1.FAULTS["whisper"] if f != "sound"]
    assert all(f.startswith("f32_") for f in faults)
    fwd = [f for f in faults if f.startswith("f32_fwd_")]
    assert (len(faults) - len(fwd), len(fwd)) == (7, 6)
    assert K1.limit("whisper") == ("elementwise", 1e-4)
    f32 = {s for s in K1.SHAPES if K1.SHAPES[s]["dtype"] == "float32"}
    assert f32 == {"whisper", "internvl_f32", "pixtral_f32"}
    assert {K1.limit(s) for s in f32} == {("elementwise", 1e-4)}
    assert {K1.limit(s) for s in K1.SHAPES if s not in f32} == {
        ("whole", 2e-2)}


def _mma_section():
    """[start, end) of the mma.sync backward's section (head dims 128 and
    160) in SOURCE, and of its launch."""
    start = SOURCE.index("// Backward, fp32, D = 128 and 160: split TF32")
    end = SOURCE.index("// Forward, fp32, D = 64: split TF32")
    launch = SOURCE.index("    // split TF32 by mma.sync: each query head's")
    launch_end = SOURCE.index("Params make_params(")
    return (start, end), (launch, launch_end)


def test_fp32_faults_sit_in_the_split_tf32_backward():
    """Every backward `f32_*` fault of the whisper shape lies in the
    split-TF32 backward at head_dim 64: its section of the source (the two
    kernels and their helpers) or its launch, never in the mma.sync
    backward that head dims 128 and 160 run; the CUDA-core backward is
    gone from the source."""
    start = SOURCE.index("// Backward, fp32, D = 64: split TF32")
    (end, _), (mma_launch, _) = _mma_section()
    launch = SOURCE.index("  } else if constexpr (D == T_D) {\n"
                          "    // split TF32: dK and dV")
    launch_end = mma_launch
    assert "packed_bwd_f32_cc_kernel" not in SOURCE
    assert "bwd_f32_smem" not in SOURCE
    assert start < end and launch < launch_end
    for fault, (_, _, edits) in K1.FAULTS["whisper"].items():
        if fault.startswith("f32_fwd_"):
            continue
        for text, _ in edits:
            at = SOURCE.index(text)
            assert start < at < end or launch < at < launch_end, fault


def test_fp32_mma_faults_sit_in_the_mma_backward():
    """The fp32 shapes at head_dim 128 and 160 plant F32_MMA_FAULTS: each
    `f32_mma_*` fault's text lies in the mma.sync backward's section; the
    group sum's fault in bwd_kv_reduce_kernel, the sum both the bf16 and
    this backward launch. The four the design must catch are there: dK's
    product with its lo terms dropped, a walked tile skipped, the group
    sum missing a head, dQ dropping a key tile; each shows in a gradient
    (the forward is not this design's)."""
    (start, end), _ = _mma_section()
    assert K1.FAULTS["internvl_f32"] == K1.FAULTS["pixtral_f32"] == \
        K1.F32_MMA_FAULTS
    faults = K1.F32_MMA_FAULTS
    assert {"f32_mma_dk_lo_dropped", "f32_mma_walked_tile_skipped",
            "reduction_drops_a_head", "f32_mma_dq_drops_key_tile"} <= set(
                faults)
    reduce = SOURCE.index("__global__ void bwd_kv_reduce_kernel(")
    for fault, (shows, _, edits) in faults.items():
        if fault == "sound":
            continue
        assert shows and set(shows) <= {"dq", "dk", "dv"}, fault
        for text, _ in edits:
            at = SOURCE.index(text)
            if fault.startswith("f32_mma_"):
                assert start < at < end, fault
            else:
                assert fault == "reduction_drops_a_head"
                assert reduce < at < SOURCE.index("// Forward, bf16", reduce)


def test_fp32_mma_shapes_are_the_configs_heads():
    """internvl_f32 and pixtral_f32 are internvl3-2b's and pixtral-12b's
    attention heads (12:2 of 128, 32:8 of 160) in fp32; every case runs
    the shape's grouped heads (the group sum shows in each), the ring hop
    its own key tables at a kv_offset, the cross case Sq != Sk; each is
    timed on the row chip_smoke.py checks (phase 7's 1024-token full row,
    phase 27's 4096-token causal row with frames)."""
    from repro_torch.configs import get_config
    for shape, arch in (("internvl_f32", "internvl3-2b"),
                        ("pixtral_f32", "pixtral-12b")):
        cfg, s = get_config(arch), K1.SHAPES[shape]
        assert (s["H"], s["HKV"], s["D"]) == (
            cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim), shape
        assert s["dtype"] == "float32" and s["vocab"] == cfg.vocab
        cases = {c[0]: c for c in K1.cases(shape)}
        assert all(c[6].get("HKV", s["HKV"]) < s["H"]
                   for c in cases.values())
        hop, cross = cases["hop512"], cases["cross300x1024"]
        assert hop[6]["off"] == -512 and hop[6]["kseg"].shape == (512,)
        assert np.shape(cross[2])[-1] != cross[6]["Sk"]
        assert {"full", "causal", "sliding"} <= {c[4] for c in
                                                 cases.values()}
    assert K1.F32_ROWS == {
        "internvl_f32": (1024, [400, 300, 250], 128, "full"),
        "pixtral_f32": (4096, [4096], 256, "causal")}


def _forward_body():
    """[start, end) of the split-TF32 forward kernel's body in SOURCE."""
    start = SOURCE.index("packed_fwd_f32_kernel(const float*")
    end = SOURCE.index("// Launchers")
    assert SOURCE.index("packed_fwd_f32_cc_kernel(const float*") < start
    assert SOURCE.index("// Forward, fp32, D = 64: split TF32") < start
    return start, end


def test_fp32_forward_faults_sit_in_the_split_tf32_forward():
    """Every `f32_fwd_*` fault is planted in the body of the split-TF32
    forward (packed_fwd_f32_kernel), never in the CUDA-core forward that
    head dims 128 and 160 still run nor in the backward's kernels: each
    has an edit in that body, and any other edit lies in the split
    helper the forward shares with the backward (`split_step`), which
    the forward's own edit must then switch on. Each must show in o or
    the LSE, the forward's outputs."""
    start, end = _forward_body()
    helper = SOURCE.index("__device__ __forceinline__ void split_step(")
    helper_end = SOURCE.index("__device__ __forceinline__ void split_fixed(")
    fwd = {f: v for f, v in K1.FAULTS["whisper"].items()
           if f.startswith("f32_fwd_")}
    assert fwd == K1.F32_FWD_FAULTS
    for fault, (shows, _, edits) in fwd.items():
        assert set(shows) & {"o", "lse"} and set(shows) <= set(K1.READ)
        at = [SOURCE.index(text) for text, _ in edits]
        assert any(start < a < end for a in at), fault
        assert all(start < a < end or helper < a < helper_end
                   for a in at), fault


@pytest.mark.parametrize("edit", sorted(e for e in K1.EDITS
                                        if e.startswith("f32_fwd_")))
def test_fp32_forward_edits_sit_in_the_split_tf32_forward(edit):
    """The forward's measurement edits change its body alone."""
    start, end = _forward_body()
    for text, _ in K1.EDITS[edit]:
        assert start < SOURCE.index(text) < end, edit
