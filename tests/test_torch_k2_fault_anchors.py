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
    """A fault is held to the limit in the cases whose tags it names; the
    window's edge needs a row longer than the window."""
    tags, _ = K2.FAULTS[fault]
    must = [c for c in K2.CASES.values() if tags is None or tags & c[5]]
    assert must, fault
    if fault == "unmasked_window_edge":
        assert all(S > window for _, S, _, window, _, _ in must)


def test_faults_sit_in_the_bf16_kernel():
    """Every planted text lies inside flash_fwd_wg_kernel's body, not in
    the fp32 kernel that shares some of its lines."""
    start = SOURCE.index("flash_fwd_wg_kernel(const bf16*")
    end = SOURCE.index("static long long g_launch[5]")
    for fault in PLANTED:
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
        want = pix if "d160" in case[5] else (K2.H, K2.HKV, K2.D)
        assert K2.CASE_HEADS[name] == want, name
    d160 = [f for f in PLANTED if f.startswith("d160_")]
    assert len(d160) == 3
    for fault in d160:
        assert K2.FAULTS[fault][0] == {"d160"}, fault
