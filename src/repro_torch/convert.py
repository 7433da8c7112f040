"""Parameter bridge from the JAX package.

`params_from_numpy(tree)` turns a JAX parameter pytree whose leaves were
made numpy arrays (`jax.tree.map(np.asarray, params)` on the JAX side)
into the port's parameter dict: the same keys, the same shapes and
layouts ([in, out] weights, stacked [L, ...] layer leaves), the same
values. bf16 leaves round-trip exactly through fp32. Both packages then
compute the same function, which is how the tests hold the port to the
reference. Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def tensor_from_numpy(arr, device="cpu") -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":          # ml_dtypes bfloat16
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)   # own a copy


def params_from_numpy(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """Nested dict of arrays -> nested dict of tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
