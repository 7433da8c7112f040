"""`k2_fault_check.py`'s planted faults and measurement edits against
the committed K2 source.

The script plants each fault by replacing a piece of text of
`csrc/flash_attention.cu` (its first match) and builds the copy on the
card. An edit whose text has gone from the source, or occurs twice,
would plant nothing or plant it in the wrong place; these tests catch
that here, without a card.
"""
import importlib.util
import os

import pytest
import torch

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _load_script():
    spec = importlib.util.spec_from_file_location(
        "k2_fault_check", os.path.join(ROOT, "k2_fault_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


K2 = _load_script()
SOURCE = open(os.path.join(ROOT, K2.CU)).read()
PLANTED = sorted(f for f in K2.FAULTS if f != "sound")


@pytest.mark.parametrize("fault", PLANTED)
def test_planted_fault_text_occurs_once(fault):
    _, edits = K2.FAULTS[fault]
    assert edits
    for text, new in edits:
        assert SOURCE.count(text) == 1, (fault, text)
        assert new != text


@pytest.mark.parametrize("edit", sorted(K2.EDITS))
def test_measurement_edit_text_occurs_once(edit):
    for text, _ in K2.EDITS[edit]:
        assert SOURCE.count(text) == 1, (edit, text)


@pytest.mark.parametrize("fault", PLANTED)
def test_each_fault_must_show_in_some_case(fault):
    """A fault is held to its dtype's limit in the cases of its dtype
    whose tags it names; the window's edge needs a row longer than the
    window, and plain TF32 whisper-small's 1500 keys."""
    tags, _ = K2.FAULTS[fault]
    must = [c for c in K2.CASES.values()
            if K2.case_dtype(c[5]) == K2.fault_dtype(fault)
            and (tags is None or tags & c[5])]
    assert must, fault
    if fault in ("unmasked_window_edge", "f32_max_correction_skipped"):
        assert all(S > window for _, S, _, window, _, _ in must
                   if window is not None)
    if fault == "f32_lo_dropped":
        assert [S for _, S, *_ in must] == [1500]


def _body(kernel):
    """[start, end) of a kernel's definition in the source: from its
    signature to the first closing brace at column 0."""
    start = SOURCE.index(f"{kernel}(const ")
    return start, SOURCE.index("\n}\n", start)


def test_faults_sit_in_the_bf16_kernel():
    """Every planted text lies inside the body of the kernel its dtype
    names: a bf16 fault in flash_fwd_wg_kernel's, an `f32_*` fault in
    flash_fwd_f32_kernel's; neither body holds the other."""
    bodies = {dt: _body(k) for dt, k in K2.KERNELS.items()}
    (a0, a1), (b0, b1) = bodies["bfloat16"], bodies["float32"]
    assert a1 < b0 or b1 < a0
    assert {K2.fault_dtype(f) for f in PLANTED} == set(bodies)
    for fault in PLANTED:
        start, end = bodies[K2.fault_dtype(fault)]
        for text, _ in K2.FAULTS[fault][1]:
            assert start < SOURCE.index(text) < end, fault


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_a_value_that_is_not_finite_reads_as_an_infinite_error(bad):
    """A fault that reads shared memory never written may give NaN; its
    error must read above the limit, not compare false."""
    ref = torch.ones(2, 3)
    out = ref.clone()
    out[1, 2] = bad
    errs = K2._errs(out, ref)
    assert errs["elementwise"] > K2.REL_TOL_BF16
    assert errs["whole"] > K2.REL_TOL_BF16
    assert min(errs.values()) > K2.REL_TOL_F32
    assert K2._errs(ref, ref) == {"elementwise": 0.0, "whole": 0.0}


def test_head_dim_160_cases_run_at_pixtral_heads():
    """The cases tagged d160 run at pixtral-12b's 32:8 heads of 160, the
    others at internvl3-2b's; each d160 fault must show in d160 cases
    only (the others run no D = 160 code)."""
    from repro_torch.configs import get_config
    cfg = get_config("pixtral-12b")
    pix = (cfg.n_heads, cfg.kv_heads, cfg.resolved_head_dim)
    assert pix == (32, 8, 160)
    for name, case in K2.CASES.items():
        want = pix if "d160" in case[5] else \
            K2.WHISPER_HEADS if "d64" in case[5] else (K2.H, K2.HKV, K2.D)
        assert K2.CASE_HEADS[name] == want, name
    d160 = [f for f in PLANTED if f.startswith("d160_")]
    assert len(d160) == 3
    for fault in d160:
        assert K2.FAULTS[fault][0] == {"d160"}, fault


def test_fp32_cases_run_at_whisper_heads_and_gqa():
    """The fp32 cases: whisper-small's 1x1500 full over its 1500 frames,
    causal at kv_offset 96 and sliding at window 128 at its 12:12 heads
    of 64, and a GQA case at 12:2 heads of 128; the bf16 cases stay
    bf16."""
    from repro_torch.configs import get_config
    cfg = get_config("whisper-small")
    assert K2.WHISPER_HEADS == (cfg.n_heads, cfg.kv_heads,
                                cfg.resolved_head_dim) == (12, 12, 64)
    f32 = {n: c for n, c in K2.CASES.items() if K2.case_dtype(c[5])
           == "float32"}
    got = sorted((c[:5], K2.CASE_HEADS[n]) for n, c in f32.items())
    assert got == sorted([
        ((1, 1500, "full", None, 0), (12, 12, 64)),
        ((4, 256, "causal", None, 96), (12, 12, 64)),
        ((2, 512, "sliding", 128, 0), (12, 12, 64)),
        ((2, 512, "causal", None, 0), (12, 2, 128))])
    assert all(n.startswith("f32_") for n in f32)
    assert all(not n.startswith("f32_") for n in K2.CASES if n not in f32)


def test_faults_are_read_in_the_cases_of_their_dtype():
    """must_show_in picks a fault's cases by its dtype, then its tags; a
    sound reading is held to its own dtype's limit."""
    rows = [{"case": n, "tags": sorted(c[5]), "dtype": K2.case_dtype(c[5])}
            for n, c in K2.CASES.items()]
    for fault in PLANTED:
        got = {r["case"] for r in K2.must_show_in(fault, rows)}
        assert got, fault
        assert {K2.case_dtype(K2.CASES[n][5]) for n in got} == \
            {K2.fault_dtype(fault)}, fault
    assert K2.must_show_in("drops_key_tile", rows) == \
        [r for r in rows if r["dtype"] == "bfloat16"]
    assert K2.limit("float32") == 1e-4 and K2.limit("bfloat16") == 2e-2


def test_time_shapes_hold_the_audio_shapes_in_fp32():
    """--time runs the fp32 full shapes of chip_smoke.py's AUDIO_SHAPES
    at whisper-small's heads over its frames beside the bf16 causal
    ones, so a parent tree's fp32 kernel is timed in the same call."""
    import chip_smoke
    f32 = [s for s in K2.TIME_SHAPES if s[4] == "float32"]
    assert [(B, Sq) for B, Sq, *_ in f32] == list(chip_smoke.AUDIO_SHAPES)
    assert {(Sk, heads, mode) for _, _, Sk, heads, _, mode in f32} == \
        {(1500, (12, 12, 64), "full")}
    assert [s[4:] for s in K2.TIME_SHAPES if s[4] != "float32"] == \
        [("bfloat16", "causal")] * 4
