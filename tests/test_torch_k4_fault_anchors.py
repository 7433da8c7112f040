"""`k4_fault_check.py`'s planted faults, measurement edits and timeline
stamps, and the planted faults of tests/test_torch_cuda.py's K4 cases,
against the committed K4 source.

Both plant a fault by editing a piece of text of `csrc/rglru_scan.cu`
(its first match) and build the copy on the card. An edit whose text has
gone from the source, or occurs twice, would plant nothing or plant it
in the wrong place; these tests catch that here, without a card.
"""
import importlib.util
import os

import pytest
import torch

# torch's first multi-threaded CPU exp of a process can be 1.5e-4 off
# under load (ROADMAP Queue 3): one single-element exp first avoids it
torch.exp(torch.zeros(1))

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


K4 = _load("k4_fault_check", os.path.join(ROOT, "k4_fault_check.py"))
CARD = _load("card_tests", os.path.join(os.path.dirname(__file__),
                                        "test_torch_cuda.py"))
SOURCE = open(os.path.join(ROOT, K4.CU)).read()
PLANTED = sorted(f for f in K4.FAULTS if f != "sound")
#: the forward's and the backward's kernels in the source: each from its
#: section's marker line to the next section's (the backward's is
#: followed by the launches)
_SECTIONS = [SOURCE.index(f"\n// ---- {name}\n")
             for name in ("forward", "backward", "launches")]
KERNELS = {"fwd": tuple(_SECTIONS[0:2]), "bwd": tuple(_SECTIONS[1:3])}


def test_the_sections_come_in_order_and_once():
    assert _SECTIONS == sorted(_SECTIONS)
    for name in ("forward", "backward", "launches"):
        assert SOURCE.count(f"\n// ---- {name}\n") == 1
    lo, hi = KERNELS["fwd"]
    assert "k4_fwd_lookback(" in SOURCE[lo:hi]
    lo, hi = KERNELS["bwd"]
    assert "k4_bwd_summary(" in SOURCE[lo:hi]
    assert "k4_bwd_apply(" in SOURCE[lo:hi]


@pytest.mark.parametrize("fault", PLANTED)
def test_planted_fault_text_occurs_once(fault):
    _, edits = K4.FAULTS[fault]
    assert edits
    for text, new in edits:
        assert SOURCE.count(text) == 1, (fault, text)
        assert new != text


@pytest.mark.parametrize("fault", PLANTED)
def test_planted_fault_sits_in_the_forward_kernel(fault):
    """Every planted text of the tool lies in k4_fwd_lookback, not in
    the backward's kernels that share the file."""
    assert fault.startswith("fwd_")
    lo, hi = KERNELS["fwd"]
    for text, _ in K4.FAULTS[fault][1]:
        assert lo < SOURCE.index(text) < hi, fault


@pytest.mark.parametrize("fault", PLANTED)
def test_each_fault_must_show_in_some_case(fault):
    """A fault names the cases it must show in; a fault of the tile's A
    alone shows only where the memory is long (a near 1)."""
    must, _ = K4.FAULTS[fault]
    assert must and set(must) <= set(K4.CASES), fault
    if "aggregate_a" in fault:
        assert all(K4.CASES[c][3] == K4.LONG for c in must)


@pytest.mark.parametrize("edit", sorted(K4.EDITS))
def test_measurement_edit_text_occurs_once(edit):
    for text, new in K4.EDITS[edit]:
        assert SOURCE.count(text) == 1, (edit, text)
        assert new != text


@pytest.mark.parametrize("stamp", [name for _, name, _ in K4.STAMPS])
def test_timeline_stamp_text_occurs_once_in_the_forward(stamp):
    """`--timeline` stamps right after each of these texts: each occurs
    once, inside the forward's section, and the stamped source keeps
    every stamp."""
    i, _, text = next(st for st in K4.STAMPS if st[1] == stamp)
    assert SOURCE.count(text) == 1, stamp
    lo, hi = KERNELS["fwd"]
    assert lo < SOURCE.index(text) < hi, stamp
    assert f"K4_STAMP({i});" in K4.timeline_source(SOURCE)


@pytest.mark.parametrize("fault", sorted(CARD.K4_FAULTS))
def test_card_test_fault_sits_in_its_direction(fault):
    """tests/test_torch_cuda.py replaces one whole line; the line occurs
    once, inside the forward's section (fwd_) or the backward's (bwd_),
    and what it must show in is that direction's output."""
    must, line, edited = CARD.K4_FAULTS[fault]
    assert SOURCE.count(line) == 1, fault
    assert line.endswith("\n") and edited.endswith("\n") and line != edited
    direction = fault.split("_")[0]
    lo, hi = KERNELS[direction]
    assert lo < SOURCE.index(line) < hi, fault
    assert set(must) <= ({"h"} if direction == "fwd" else {"da", "db"})


def test_the_card_tests_plant_two_forward_faults():
    assert sum(f.startswith("fwd_") for f in CARD.K4_FAULTS) == 2


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_a_value_that_is_not_finite_reads_as_an_infinite_error(bad):
    """A fault that reads a descriptor never written may give NaN; its
    error must read above the limit, not compare false."""
    ref = torch.ones(2, 3)
    out = ref.clone()
    out[1, 2] = bad
    assert K4._err(out, ref) > K4.K4_TOL
    assert K4._err(ref, ref) == 0.0
