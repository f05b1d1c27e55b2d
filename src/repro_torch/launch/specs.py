"""Input specs for the model zoo, and zero-filled trees on an explicit device.

Counterpart of ``repro.launch.specs``. A spec is a :class:`TensorSpec`
(shape and dtype, no storage) in place of the reference's
``jax.ShapeDtypeStruct``; :func:`zeros_like_spec` turns a nested dict of
specs (a batch, or a model's decode-cache tree) into zero tensors on the
device the caller names. The reference's ``materialize`` (random batches for
its dry-run) and ``train_specs`` have no caller in the port yet.
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


def prefill_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, Any]:
    """The prefill batch: ``tokens`` (B, S), plus the stub frontend's
    ``embeds`` (B, prefix, d) bf16 for the vlm and audio families."""
    b, s = shape.global_batch, shape.seq_len
    if cfg.family in ("vlm", "audio"):
        p = cfg.prefix_tokens
        return {"tokens": spec(b, s - p), "embeds": spec(b, p, cfg.d_model, dtype=torch.bfloat16)}
    return {"tokens": spec(b, s)}


def decode_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, Any]:
    """One decode step's batch: ``token`` and ``pos``, both (B, 1) int32."""
    del cfg
    b = shape.global_batch
    return {"token": spec(b, 1), "pos": spec(b, 1)}


def zeros_like_spec(tree: Any, device: DeviceLike = None) -> Any:
    """Zero tensors of the specs' shapes and dtypes, on ``device``
    (``cuda`` unless the caller says ``cpu``)."""
    dev = resolve_device(device)
    if isinstance(tree, TensorSpec):
        return torch.zeros(tree.shape, dtype=tree.dtype, device=dev)
    if isinstance(tree, dict):
        return {k: zeros_like_spec(v, dev) for k, v in tree.items()}
    raise TypeError(f"not a spec tree: {type(tree).__name__}")
