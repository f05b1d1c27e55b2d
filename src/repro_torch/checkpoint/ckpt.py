"""The reference's ``ckpt_<step>.npz`` checkpoints, written and read with
numpy only.

Counterpart of ``repro.checkpoint.ckpt``. A checkpoint holds the leaves of
a pytree as ``leaf_0 … leaf_{n-1}`` in the order
``jax.tree_util.tree_flatten`` visits them, plus a JSON ``__meta__`` entry.
That order is: dict keys in ``sorted()`` order at every level, list and
tuple items in order. The writer walks the tree in that order; the reader
walks a template tree (nested dicts and lists whose leaves carry the
expected shape) in that same order and returns the tree with torch tensors
at the leaves, so either package reads what the other wrote.

``np.savez`` stores ``bfloat16`` leaves (``ml_dtypes``) as raw 2-byte void
records. The writer stores a ``torch.bfloat16`` leaf the same way, and the
reader turns such a record back into ``torch.bfloat16`` by reinterpreting
the bits.
"""

from __future__ import annotations

import json
import os
import tempfile
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


def _to_numpy(leaf: Any) -> np.ndarray:
    if not torch.is_tensor(leaf):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        # the 2-byte void record np.savez writes for an ml_dtypes bfloat16 array
        return t.view(torch.int16).numpy().view(np.uint16).view("V2")
    return t.numpy()


def save_checkpoint(directory: str, step: int, tree: Any, metadata: Optional[dict] = None) -> str:
    """Write ``tree``'s leaves and ``metadata`` (plus ``step``) to
    ``<directory>/ckpt_<step:08d>.npz``; returns the path. The file appears
    whole or not at all: it is written to a temporary file in the same
    directory and renamed over the target, and the temporary file is removed
    if the write fails."""
    os.makedirs(directory, exist_ok=True)
    flat = {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(_leaves(tree))}
    meta = dict(metadata or {})
    meta["step"] = int(step)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8), **flat)
        os.replace(tmp, path)  # atomic on POSIX
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


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
