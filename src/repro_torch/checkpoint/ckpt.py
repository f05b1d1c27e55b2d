"""Reader of the reference's ``ckpt_<step>.npz`` checkpoints (numpy only).

Counterpart of the loading half of ``repro.checkpoint.ckpt``. A checkpoint
holds the leaves of a pytree as ``leaf_0 … leaf_{n-1}`` in the order
``jax.tree_util.tree_flatten`` visits them, plus a JSON ``__meta__`` entry.
That order is: dict keys in ``sorted()`` order at every level, list and
tuple items in order. The reader walks a template tree (nested dicts and
lists whose leaves carry the expected shape) in that same order and returns
the tree with torch tensors at the leaves.

``np.savez`` stores ``bfloat16`` leaves (``ml_dtypes``) as raw 2-byte void
records; they come back as ``torch.bfloat16`` by reinterpreting the bits.
"""

from __future__ import annotations

import json
import os
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _rebuild(tree: Any, leaves) -> Any:
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], leaves) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(item, leaves) for item in tree)
    return next(leaves)


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2:
            raise ValueError(f"unsupported raw leaf dtype {arr.dtype}")
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [
        int(f[len("ckpt_") : -len(".npz")])
        for f in os.listdir(directory)
        if f.startswith("ckpt_") and f.endswith(".npz")
    ]
    return max(steps) if steps else None


def _path(directory: str, step: Optional[int]) -> str:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    return os.path.join(directory, f"ckpt_{step:08d}.npz")


def load_metadata(directory: str, step: Optional[int] = None) -> dict:
    """The JSON metadata entry alone (no leaves are read)."""
    with np.load(_path(directory, step)) as blob:
        return json.loads(bytes(blob["__meta__"]).decode())


def load_checkpoint(directory: str, template: Any, step: Optional[int] = None) -> Tuple[Any, dict]:
    """Load into the structure of ``template``; returns (tree, metadata).

    Each template leaf is anything with a ``.shape`` (an array, a tensor);
    a stored leaf of another shape, or a leaf count that differs, raises."""
    path = _path(directory, step)
    with np.load(path) as blob:
        meta = json.loads(bytes(blob["__meta__"]).decode())
        expected = _leaves(template)
        stored = sum(1 for name in blob.files if name.startswith("leaf_"))
        if stored != len(expected):
            raise ValueError(f"{path}: {stored} leaves stored, template has {len(expected)}")
        restored = []
        for i, leaf in enumerate(expected):
            arr = blob[f"leaf_{i}"]
            if arr.shape != tuple(leaf.shape):
                want = tuple(leaf.shape)
                raise ValueError(f"{path}: leaf_{i} has shape {arr.shape}, expected {want}")
            restored.append(_to_tensor(arr))
    return _rebuild(template, iter(restored)), meta
