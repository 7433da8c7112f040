"""`k1_fault_check.py`'s planted faults and measurement edits against
the committed K1 source.

The script plants each fault by replacing a piece of text of
`csrc/flash_attention_packed.cu` (its first match) and builds the copy
on the card. An edit whose text has gone from the source, or occurs
twice, would plant nothing or plant it in the wrong place; these tests
catch that here, without a card, for both shapes the script checks.
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
                   for _, _, seg, _, _, window in must)


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
