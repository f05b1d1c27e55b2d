"""Prefill and decode steps for a model-zoo ModelDef.

Counterpart of ``repro.launch.steps`` (its serving half). The reference's
factories return pure functions for ``jax.jit`` to compile; PyTorch runs
eagerly, so each factory returns the model's own function. The train step
and its optimizer wait for the zoo's training slice.
"""

from __future__ import annotations

from typing import Callable

from repro_torch.models.model_zoo import ModelDef


def make_prefill_step(model: ModelDef) -> Callable:
    """``(params, {"tokens"}) -> logits``: ``model.prefill_fn``."""
    return model.prefill_fn


def make_decode_step(model: ModelDef) -> Callable:
    """``(params, cache, {"token", "pos"}) -> (logits, cache)``:
    ``model.decode_fn``."""
    return model.decode_fn
