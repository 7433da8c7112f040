"""Checkpointing: flat .npz save/restore of trees of tensors, in the JAX
package's file format.

Each leaf is an npz entry named by its path, the parts joined by "::":
dict keys, sequence indices and NamedTuple field names (TrainState,
AdamWState). None holds no leaf. A JSON `meta` blob rides along under a
reserved key for the state that is not an array: the step counter and
the data loader's stream position. The file is written to `.tmp`, then
moved into place.

A bf16 leaf is stored as its raw 2-byte words (numpy type `|V2`), which
is what the JAX package's `np.asarray` of a bf16 array writes; the port
reads such an entry back as the bits of `torch.bfloat16`. So a file
written by either package restores in the other without `ml_dtypes`.
"""
from __future__ import annotations

import json
import os
from typing import Any, Iterator, Optional, Set, Tuple

import numpy as np
import torch

SEP = "::"
META_KEY = "__meta_json__"
#: numpy's type of a bf16 word, as the JAX package writes one
BF16_WORD = np.dtype("V2")


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _items(tree) -> Iterator[Tuple[str, Any]]:
    """(name part, subtree) of a node, in the JAX package's order."""
    if isinstance(tree, dict):
        return ((str(k), tree[k]) for k in sorted(tree))
    if _is_namedtuple(tree):
        return ((f, getattr(tree, f)) for f in tree._fields)
    return ((str(i), v) for i, v in enumerate(tree))


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def _flatten(tree, prefix: Tuple[str, ...] = ()):
    if tree is None:
        return
    if not _is_node(tree):
        yield SEP.join(prefix), tree
        return
    for name, sub in _items(tree):
        yield from _flatten(sub, prefix + (name,))


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_WORD)
    return t.numpy()


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A new tensor of `arr`'s values in `like`'s dtype, on its
    device."""
    if arr.dtype == BF16_WORD:
        t = torch.from_numpy(np.array(arr.view(np.int16))).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def save(path: str, tree: Any, meta: Optional[dict] = None) -> None:
    flat = {name: _to_numpy(leaf) for name, leaf in _flatten(tree)}
    if meta is not None:
        flat[META_KEY] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    tmp = path + ".tmp"
    np.savez(tmp, **flat)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def entries(path: str) -> Set[str]:
    """The names of a checkpoint's arrays (the meta blob's left out)."""
    with np.load(path) as data:
        return set(data.files) - {META_KEY}


def load_meta(path: str) -> Optional[dict]:
    """The JSON meta blob of a checkpoint, or None (old format)."""
    with np.load(path) as data:
        if META_KEY not in data.files:
            return None
        return json.loads(bytes(data[META_KEY].tobytes()).decode())


def restore(path: str, like: Any) -> Any:
    """A new tree of `like`'s structure from the file: every tensor leaf
    a new tensor in `like`'s dtype on its device (no storage shared
    with `like`); other leaves as numpy arrays."""
    with np.load(path) as data:
        def build(node, prefix):
            if node is None:
                return None
            if not _is_node(node):
                key = SEP.join(prefix)
                arr = data[key]
                assert tuple(arr.shape) == tuple(node.shape), (
                    key, arr.shape, tuple(node.shape))
                return (_to_tensor(arr, node)
                        if isinstance(node, torch.Tensor) else arr)
            if isinstance(node, dict):
                return {k: build(v, prefix + (str(k),))
                        for k, v in node.items()}
            subs = [build(v, prefix + (name,)) for name, v in _items(node)]
            return type(node)(*subs) if _is_namedtuple(node) \
                else type(node)(subs)
        return build(like, ())
