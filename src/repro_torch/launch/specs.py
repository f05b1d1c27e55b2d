"""Input specs for the model zoo, and trees of tensors made from them on an
explicit device.

Counterpart of ``repro.launch.specs``. A spec is a :class:`TensorSpec`
(shape and dtype, no storage) in place of the reference's
``jax.ShapeDtypeStruct``. :func:`zeros_like_spec` turns a nested dict of
specs (a batch, or a model's decode-cache tree) into zero tensors and
:func:`materialize` into a random batch, on the device the caller names.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.device import DeviceLike, resolve_device


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def spec(*shape: int, dtype: torch.dtype = torch.int32) -> TensorSpec:
    return TensorSpec(tuple(shape), dtype)


def train_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, Any]:
    """The train batch: ``tokens`` and ``labels`` (B, S) int32; the vlm and
    audio families give ``prefix_tokens`` of S to the stub frontend's
    ``embeds`` (B, prefix, d) bf16 and S − prefix to the text."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family in ("vlm", "audio"):
        p = cfg.prefix_tokens
        return {
            "tokens": spec(b, s - p),
            "labels": spec(b, s - p),
            "embeds": spec(b, p, cfg.d_model, dtype=torch.bfloat16),
        }
    return {"tokens": spec(b, s), "labels": spec(b, s)}


def prefill_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, Any]:
    """The prefill batch: :func:`train_specs` without the labels."""
    out = train_specs(cfg, shape)
    out.pop("labels")
    return out


def decode_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, Any]:
    """One decode step's batch: ``token`` and ``pos``, both (B, 1) int32."""
    del cfg
    b = shape.global_batch
    return {"token": spec(b, 1), "pos": spec(b, 1)}


def leaves(tree: Any):
    """The TensorSpecs of a nested dict of them, in order."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from leaves(v)
    else:
        yield tree


def zeros_like_spec(tree: Any, device: DeviceLike = None) -> Any:
    """Zero tensors of the specs' shapes and dtypes, on ``device``
    (``cuda`` unless the caller says ``cpu``)."""
    dev = resolve_device(device)
    if isinstance(tree, TensorSpec):
        return torch.zeros(tree.shape, dtype=tree.dtype, device=dev)
    if isinstance(tree, dict):
        return {k: zeros_like_spec(v, dev) for k, v in tree.items()}
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def materialize(generator: torch.Generator, tree: Any, device: DeviceLike = None) -> Any:
    """A random batch of the specs' shapes and dtypes on ``device`` (``cuda``
    unless the caller says ``cpu``), drawn from ``generator`` (on that
    device) leaf by leaf in sorted key order: integers uniform in [0, 100),
    floats 0.02·N(0, 1)."""
    dev = resolve_device(device)
    if isinstance(tree, TensorSpec):
        if tree.dtype.is_floating_point:
            x = torch.randn(tree.shape, generator=generator, device=dev)
            return (0.02 * x).to(tree.dtype)
        return torch.randint(0, 100, tree.shape, generator=generator, device=dev, dtype=tree.dtype)
    if isinstance(tree, dict):
        return {k: materialize(generator, tree[k], dev) for k in sorted(tree)}
    raise TypeError(f"not a spec tree: {type(tree).__name__}")
