"""The CUDA kernels against their plain versions on the card.

Marked `cuda`: they skip without an NVIDIA GPU (and need nvcc to build
the kernels). This file imports no JAX, so it runs on a machine with
only the port's requirements:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)

#: each output element lies within TOL * max(1, |plain|) of the plain
#: version's. bf16: the two round at different points, and one bf16 step
#: is up to 2^-7 of |o|; fp32: sums are taken in a different order
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
CASES = [("causal", None, 0), ("full", None, 0), ("sliding", 64, 0),
         ("causal", None, 50), ("causal", None, -30)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,D", [(2, 200, 200, 64),
                                       (2, 200, 200, 128),
                                       (1, 77, 150, 32),
                                       (3, 1, 1, 128)])
def test_flash_attention_kernel_matches_plain(card, dtype, B, Sq, Sk, D):
    rng = np.random.default_rng(0)
    q, k, v = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(card, dtype)
               for s in ((B, Sq, 12, D), (B, Sk, 2, D), (B, Sk, 2, D))]
    before = flash_attention.launches
    for mode, window, off in CASES:
        out = flash_attention(q, k, v, mode=mode, window=window,
                              kv_offset=off)
        ref = flash_attention_ref(q, k, v, mode=mode, window=window,
                                  kv_offset=off)
        torch.cuda.synchronize()
        ref = ref.float()
        err = ((out.float() - ref).abs() / ref.abs().clamp_min(1.0)).max()
        assert err.item() <= TOL[dtype], (mode, off, err.item())
    assert flash_attention.launches == before + len(CASES)
