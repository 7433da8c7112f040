"""`k3_fault_check.py`'s planted faults and measurement edits, and the
planted faults of tests/test_torch_cuda.py's K3 cases, against the
committed K3 source.

Both plant a fault by editing a piece of text of `csrc/ssd_chunk.cu`
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


K3 = _load("k3_fault_check", os.path.join(ROOT, "k3_fault_check.py"))
CARD = _load("card_tests", os.path.join(os.path.dirname(__file__),
                                        "test_torch_cuda.py"))
SOURCE = open(os.path.join(ROOT, K3.CU)).read()
PLANTED = sorted(f for f in K3.FAULTS if f != "sound")
#: the forward's and the backward's kernels in the source: each from its
#: section's first line to the next section's (the backward's is followed
#: by the launches)
_SECTIONS = [SOURCE.index("// " + "-" * n + " " + name) for n, name in (
    (66, "forward"), (65, "backward"), (61, "launches"))]
KERNELS = {"fwd": tuple(_SECTIONS[0:2]), "bwd": tuple(_SECTIONS[1:3])}


def _direction(name):
    return "fwd" if name.startswith("fwd_") else "bwd"


@pytest.mark.parametrize("fault", PLANTED)
def test_planted_fault_text_occurs_once(fault):
    _, edits = K3.FAULTS[fault]
    assert edits
    for text, new in edits:
        assert SOURCE.count(text) == 1, (fault, text)
        assert new != text


@pytest.mark.parametrize("fault", [f for f in PLANTED
                                   if _direction(f) == "bwd"])
def test_planted_fault_sits_in_the_backward_kernels(fault):
    """Every planted text of a backward fault lies in the backward's
    kernels, not in the forward that shares the file."""
    lo, hi = KERNELS["bwd"]
    for text, _ in K3.FAULTS[fault][1]:
        assert lo < SOURCE.index(text) < hi, fault


@pytest.mark.parametrize("fault", [f for f in PLANTED
                                   if _direction(f) == "fwd"])
def test_planted_fault_sits_in_the_forward_kernel(fault):
    """Every planted text of a forward fault (fwd_) lies in
    k3_fwd_heads, not in the backward's kernels."""
    lo, hi = KERNELS["fwd"]
    for text, _ in K3.FAULTS[fault][1]:
        assert lo < SOURCE.index(text) < hi, fault


@pytest.mark.parametrize("edit", sorted(K3.EDITS))
def test_measurement_edit_text_occurs_once(edit):
    for text, new in K3.EDITS[edit]:
        assert SOURCE.count(text) == 1, (edit, text)
        assert new != text


@pytest.mark.parametrize("fault", PLANTED)
def test_each_fault_must_show_in_some_gradient_and_case(fault):
    """A fault names the outputs or gradients it must show in (a
    forward fault, outputs of the forward); every case runs
    mamba2-370m's chunk (tile pair (2, 1) exists at c = 256: four 64-row
    tiles) and more than one head a group (so a group's second head and
    a head's neighbour exist)."""
    must, _ = K3.FAULTS[fault]
    assert must and set(must) <= set(K3.OUTS + K3.GRADS), fault
    if _direction(fault) == "fwd":
        assert set(must) <= set(K3.OUTS), fault
    assert K3.CHUNK // 64 >= 3
    assert K3.CASES and all(heads >= 2 and S % K3.CHUNK == 0
                            for _, S, heads in K3.CASES.values())


@pytest.mark.parametrize("fault", sorted(f for f in CARD.K3_FAULTS
                                         if f.startswith("bwd_")))
def test_card_test_backward_faults_sit_in_the_backward_kernels(fault):
    """tests/test_torch_cuda.py inserts a line after the first line of
    each anchor; the anchor occurs once, inside the backward's kernels,
    and the gradients it must show in are gradients."""
    must, anchor, line = CARD.K3_FAULTS[fault]
    assert SOURCE.count(anchor) == 1, fault
    lo, hi = KERNELS["bwd"]
    assert lo < SOURCE.index(anchor) < hi, fault
    assert set(must) <= set(K3.GRADS) and line.endswith("\n")


@pytest.mark.parametrize("fault", sorted(f for f in CARD.K3_FAULTS
                                         if f.startswith("fwd_")))
def test_card_test_forward_faults_sit_in_the_forward_kernel(fault):
    """As the backward's: each fwd_ anchor of tests/test_torch_cuda.py
    occurs once, inside k3_fwd_heads, and what it must show in is an
    output of the forward."""
    must, anchor, line = CARD.K3_FAULTS[fault]
    assert SOURCE.count(anchor) == 1, fault
    lo, hi = KERNELS["fwd"]
    assert lo < SOURCE.index(anchor) < hi, fault
    assert must and set(must) <= set(K3.OUTS) and line.endswith("\n")


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_a_value_that_is_not_finite_reads_as_an_infinite_error(bad):
    """A fault that reads shared memory never written may give NaN; its
    error must read above the limit, not compare false."""
    ref = torch.ones(2, 3)
    out = ref.clone()
    out[1, 2] = bad
    assert K3._whole(out, ref) > K3.K3_TOL
    assert K3._whole(ref, ref) == 0.0
