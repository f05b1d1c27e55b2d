"""Train, prefill and decode steps for a model-zoo ModelDef.

Counterpart of ``repro.launch.steps``. The reference's factories return pure
functions for ``jax.jit`` to compile; PyTorch runs eagerly, so the serving
factories return the model's own functions, and the train step updates the
parameter module and the optimizer state in place.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Sequence

import torch
from torch import nn

from repro_torch import optim
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.specs import TensorSpec
from repro_torch.models import spmd
from repro_torch.models.model_zoo import ModelDef


class Transform(NamedTuple):
    """``init(parameters) -> optimizer state``: the state is an
    :class:`~repro_torch.optim.Adam` or :class:`~repro_torch.optim.SGD`
    over those parameters, whose ``step(grads)`` updates them in place (the
    reference's ``GradientTransformation.init``)."""

    init: Callable[[Sequence[torch.Tensor]], object]
    kind: str = "adam"  # or "sgdm": what opt_state_shapes gives


def make_optimizer(cfg: ArchConfig, learning_rate: float = 3e-4, grad_clip: float = 1.0) -> Transform:
    """Clip by global norm, then Adam; or then SGD with momentum 0.9 for
    ``cfg.optimizer == "sgdm"``."""
    if cfg.optimizer == "sgdm":
        return Transform(
            lambda ps: optim.SGD(ps, learning_rate, momentum=0.9, max_norm=grad_clip), "sgdm"
        )
    return Transform(lambda ps: optim.Adam(ps, learning_rate, max_norm=grad_clip))


def _grads(loss: torch.Tensor, params: Sequence[torch.Tensor]):
    """d loss / d params, zeros for a parameter the loss does not reach (as
    ``jax.grad`` gives them)."""
    return torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)


def make_train_step(model: ModelDef, tx: Transform, num_microbatches: int = 1) -> Callable:
    """``train_step(params, opt_state, batch) -> loss``: the loss and its
    gradients by autograd, then one optimizer step, in place.
    ``opt_state`` is ``tx.init(list(params.parameters()))``; it carries the
    update, so ``tx`` is taken for the reference's signature only.

    ``num_microbatches`` > 1: the batch's leading axis splits into that many
    equal microbatches; their f32 gradients are summed one microbatch at a
    time (only one microbatch's activations live), divided by the count,
    and applied once; the loss is the microbatches' mean. This is the
    reference's ``lax.scan`` accumulator (on DTensors the microbatches
    interleave where that leaves the loss as it is: :func:`_microbatches`)."""
    if num_microbatches == 1:

        def train_step(params: nn.Module, opt_state, batch: Dict[str, torch.Tensor]):
            with spmd.spmd_scope(opt_state.params[0]):  # the backward and the update too
                loss = model.loss_fn(params, batch)
                opt_state.step(_grads(loss, opt_state.params))
                return loss.detach()

        return train_step

    def train_step(params: nn.Module, opt_state, batch: Dict[str, torch.Tensor]):
        size = {v.shape[0] for v in batch.values()}
        if len(size) != 1 or next(iter(size)) % num_microbatches:
            raise ValueError(
                f"batch sizes {sorted(size)} do not split into {num_microbatches} equal microbatches"
            )
        blocks = model.cfg.moe is not None
        micro = {k: _microbatches(v, num_microbatches, blocks) for k, v in batch.items()}
        ps = opt_state.params
        with spmd.spmd_scope(ps[0]):
            acc = [torch.zeros_like(p, dtype=torch.float32) for p in ps]
            loss_sum = torch.zeros((), dtype=torch.float32, device=ps[0].device)
            for i in range(num_microbatches):
                loss = model.loss_fn(params, {k: v[i] for k, v in micro.items()})
                torch._foreach_add_(acc, [g.float() for g in _grads(loss, ps)])
                loss_sum = loss_sum + loss.detach().float()  # a DTensor's: not into a plain 0-d
            torch._foreach_div_(acc, float(num_microbatches))
            opt_state.step(acc)
            return loss_sum / num_microbatches

    return train_step


def _microbatches(v: torch.Tensor, n: int, blocks: bool):
    """v's leading axis cut into n equal microbatches: contiguous blocks (the
    reference's reshape). A DTensor's interleave (rows i, i + n, ...), each
    keeping the batch's sharding instead of gathering it, unless ``blocks``:
    a MoE layer drops slots past the capacity of each microbatch's tokens,
    so which rows share a microbatch changes its loss, and its DTensors take
    the reference's blocks (the batch gathered). Elsewhere the loss is the
    mean of equal microbatches' means either way."""
    if spmd.is_dtensor(v) and not blocks:
        return v.unflatten(0, (-1, n)).unbind(1)
    return v.chunk(n)


def make_prefill_step(model: ModelDef) -> Callable:
    """``(params, {"tokens"}) -> logits``: ``model.prefill_fn``."""
    return model.prefill_fn


def make_decode_step(model: ModelDef) -> Callable:
    """``(params, cache, {"token", "pos"}) -> (logits, cache)``:
    ``model.decode_fn``."""
    return model.decode_fn


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return TensorSpec(tuple(tree.shape), torch.float32)


def opt_state_shapes(tx: Transform, param_shapes) -> tuple:
    """The reference's optimizer-state tree as TensorSpecs, allocating
    nothing (its ``jax.eval_shape(tx.init, param_shapes)``): the clip's
    ``()``, then Adam's ``{"step", "mu", "nu"}`` or, for ``sgdm``, SGD's
    ``{"step", "momentum"}``; ``step`` a 0-d int32, the moments float32 and
    shaped like the parameters. The dicts carry the reference's NamedTuple
    field names. The port's :class:`~repro_torch.optim.Adam` and
    :class:`~repro_torch.optim.SGD` hold the same tensors as lists in
    parameter order."""
    step = TensorSpec((), torch.int32)
    if tx.kind == "sgdm":
        return ((), {"step": step, "momentum": _f32(param_shapes)})
    return ((), {"step": step, "mu": _f32(param_shapes), "nu": _f32(param_shapes)})
