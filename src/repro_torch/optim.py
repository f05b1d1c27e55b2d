"""Gradient clipping, SGD and Adam, and the learning-rate schedules, written
out by hand.

Counterparts of ``repro.optim``:

* :class:`ClippedSGD`: ``chain(clip_by_global_norm(c), sgd(lr,
  momentum=μ))``, the optimizer of every local-SSL session and server fit,
  and its unclipped ``sgd(lr, momentum=μ)``, the optimizer of the
  iterative baselines (``max_norm=None``);
* :class:`SGD`: the reference's ``sgd`` with ``nesterov`` and
  ``weight_decay`` (``g ← g + wd·p`` before the momentum), optionally
  clipped first (:class:`ClippedSGD` is it with momentum and the clip);
* :class:`Adam`: the reference's ``adam`` (and ``adamw`` through
  ``weight_decay``), optionally clipped first: the zoo's train step;
* :func:`constant`, :func:`cosine_decay`, :func:`linear_warmup_cosine`:
  step → lr schedules, which every ``learning_rate`` argument here may be.

The arithmetic is the reference's, not PyTorch's:

* the clip factor is ``min(1, c / (‖g‖ + 1e-12))``
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6);
* the momentum trace is ``m ← μ·m + g`` from ``m = 0`` and the update is
  ``p ← p + (−lr·m)``: no dampening, the same rounding steps;
* Adam keeps f32 moments from zero, bias-corrects with ``1 − b^t`` where t
  counts this step, updates ``−lr·(m/bc1)/(√(v/bc2) + eps)`` (and with
  decay also ``−lr·wd·p``, decoupled), and reads ``lr`` from the schedule
  at the step count *before* this step.

Updates are multi-tensor (``torch._foreach_*``) in groups of at most
:data:`FOREACH_CHUNK` elements, so no second full-size list of temporaries
is ever held (at phi4-mini's width one would cost 4 GB).

:func:`clipped_sgd_stacked_` is the same step over parameters stacked on a
leading entry axis (the folds' stacked sessions): each entry is clipped by
its own global norm, and an entry whose ``commit`` is False keeps its
parameters and its momentum.
"""

from __future__ import annotations

import math
from typing import Callable, Iterator, List, Optional, Sequence, Tuple, Union

import torch

Schedule = Callable[[int], float]
LearningRate = Union[float, Schedule]
# elements a multi-tensor group of an update may cover (256 MiB of f32
# temporaries at most)
FOREACH_CHUNK = 1 << 26


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """√(Σ_leaves Σ x²) in float32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> None:
    """Scale ``grads`` in place by ``min(1, max_norm / (norm + 1e-12))``."""
    factor = torch.clamp(max_norm / (global_norm(grads) + 1e-12), max=1.0)
    for g in grads:
        g.mul_(factor)


@torch.no_grad()
def clipped_sgd_stacked_(
    params: Sequence[torch.Tensor],
    trace: Sequence[torch.Tensor],
    grads: Sequence[torch.Tensor],
    lr: float,
    momentum: float = 0.9,
    max_norm: Optional[float] = 5.0,
    commit: Optional[torch.Tensor] = None,
) -> None:
    """:meth:`ClippedSGD.step` of E entries at once, in place: leaves of
    shape (E, …), the global norm per entry over that entry's leaves only,
    and ``commit`` (E,) bool (None: every entry commits)."""
    e = params[0].shape[0]
    grads = [g.float() for g in grads]
    if max_norm is not None:
        sq = sum(g.square().reshape(e, -1).sum(1) for g in grads)
        factor = torch.clamp(max_norm / (torch.sqrt(sq) + 1e-12), max=1.0)
        grads = [g * factor.view(e, *([1] * (g.dim() - 1))) for g in grads]
    if commit is None:  # multi-tensor ops: a few launches for every leaf
        torch._foreach_mul_(trace, momentum)
        torch._foreach_add_(trace, grads)
        torch._foreach_add_(params, torch._foreach_mul(trace, -lr))
        return
    m_new = torch._foreach_add(torch._foreach_mul(trace, momentum), grads)
    p_new = torch._foreach_add(params, torch._foreach_mul(m_new, -lr))
    for p, m, pn, mn in zip(params, trace, p_new, m_new):
        c = commit.view(e, *([1] * (p.dim() - 1)))
        m.copy_(torch.where(c, mn, m))
        p.copy_(torch.where(c, pn, p))


# --------------------------------------------------------------- schedules --
def constant(value: float) -> Schedule:
    """lr = value at every step."""
    return lambda step: float(value)


def cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """``init · ((1 − α)·½(1 + cos(π·min(t, T)/T)) + α)``."""

    def schedule(step: int) -> float:
        t = min(float(step), decay_steps) / decay_steps
        return init_value * ((1 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t)) + alpha)

    return schedule


def linear_warmup_cosine(
    peak_value: float, warmup_steps: int, total_steps: int, end_value: float = 0.0
) -> Schedule:
    """Linear from 0 to ``peak`` over ``warmup_steps``, then a cosine from
    ``peak`` to ``end_value`` at ``total_steps``."""

    def schedule(step: int) -> float:
        t = float(step)
        if t < warmup_steps:
            return peak_value * t / max(1.0, warmup_steps)
        frac = min(max((t - warmup_steps) / max(1.0, total_steps - warmup_steps), 0.0), 1.0)
        return end_value + (peak_value - end_value) * 0.5 * (1.0 + math.cos(math.pi * frac))

    return schedule


def _lr(learning_rate: LearningRate, step: int) -> float:
    return float(learning_rate(step)) if callable(learning_rate) else float(learning_rate)


def _groups(*lists: Sequence[torch.Tensor]) -> Iterator[Tuple[List[torch.Tensor], ...]]:
    """The parallel lists cut into groups of at most FOREACH_CHUNK elements
    (a larger leaf is a group of its own)."""
    start, size = 0, 0
    n = len(lists[0])
    for i in range(n):
        size += lists[0][i].numel()
        if size >= FOREACH_CHUNK or i == n - 1:
            yield tuple(list(lst[start : i + 1]) for lst in lists)
            start, size = i + 1, 0


class _Optimizer:
    """A fixed parameter list, an optional clip by global norm first, and a
    step counter; ``step(grads)`` takes the gradients in parameter order
    (consumed: clipped in place where they are f32)."""

    def __init__(
        self, params: Sequence[torch.Tensor], learning_rate: LearningRate, max_norm: Optional[float]
    ) -> None:
        self.params: List[torch.Tensor] = list(params)
        self.learning_rate, self.max_norm = learning_rate, max_norm
        self.count = 0  # steps taken

    def _grads(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} parameters")
        grads = [g.float() for g in grads]
        if self.max_norm is not None:
            clip_by_global_norm_(grads, self.max_norm)
        return grads

    def _state(self) -> List[torch.Tensor]:
        return [torch.zeros_like(p, dtype=torch.float32) for p in self.params]


class SGD(_Optimizer):
    """The reference's ``sgd(lr, momentum, nesterov, weight_decay)``, after
    ``clip_by_global_norm(max_norm)`` unless ``max_norm`` is None:
    ``g ← g + wd·p``; ``m ← μ·m + g``; the step is ``μ·m + g`` (nesterov)
    or ``m``; ``p ← p − lr·step``."""

    def __init__(
        self,
        params: Sequence[torch.Tensor],
        learning_rate: LearningRate,
        momentum: float = 0.0,
        nesterov: bool = False,
        weight_decay: float = 0.0,
        max_norm: Optional[float] = None,
    ) -> None:
        super().__init__(params, learning_rate, max_norm)
        self.momentum, self.nesterov, self.weight_decay = momentum, nesterov, weight_decay
        self.trace = self._state() if momentum else None

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = self._grads(grads)
        lr = _lr(self.learning_rate, self.count)
        self.count += 1
        trace = self.trace if self.trace is not None else [None] * len(grads)
        for ps, gs, ms in _groups(self.params, grads, trace):
            if self.weight_decay:
                gs = torch._foreach_add(gs, [p.float() for p in ps], alpha=self.weight_decay)
            if self.momentum:
                torch._foreach_mul_(ms, self.momentum)
                torch._foreach_add_(ms, gs)
                if self.nesterov:
                    gs = torch._foreach_add(torch._foreach_mul(ms, self.momentum), gs)
                else:
                    gs = ms
            upd = torch._foreach_mul(gs, -lr)
            for p, u in zip(ps, upd):
                p.add_(u.to(p.dtype))


class Adam(_Optimizer):
    """The reference's ``adam(lr, b1, b2, eps, weight_decay)`` (AdamW when
    ``weight_decay`` > 0), after ``clip_by_global_norm(max_norm)`` unless
    ``max_norm`` is None. ``mu`` and ``nu`` are the f32 moments."""

    def __init__(
        self,
        params: Sequence[torch.Tensor],
        learning_rate: LearningRate,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: float = 0.0,
        max_norm: Optional[float] = None,
    ) -> None:
        super().__init__(params, learning_rate, max_norm)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.mu, self.nu = self._state(), self._state()

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = self._grads(grads)
        lr = _lr(self.learning_rate, self.count)  # the step before this one's
        self.count += 1
        bc1 = 1.0 - self.b1**self.count
        bc2 = 1.0 - self.b2**self.count
        for ps, gs, ms, vs in _groups(self.params, grads, self.mu, self.nu):
            torch._foreach_mul_(ms, self.b1)
            torch._foreach_add_(ms, gs, alpha=1.0 - self.b1)
            torch._foreach_mul_(vs, self.b2)
            torch._foreach_addcmul_(vs, gs, gs, value=1.0 - self.b2)
            # the group's one list of temporaries: √(v/bc2) + eps
            denom = torch._foreach_div(vs, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            f32 = all(p.dtype == torch.float32 for p in ps)
            if self.weight_decay and f32:
                torch._foreach_add_(ps, ps, alpha=-lr * self.weight_decay)
            if f32:
                torch._foreach_addcdiv_(ps, ms, denom, value=-lr / bc1)
                continue
            for p, m, den in zip(ps, ms, denom):
                u = (m / den) * (-lr / bc1)
                if self.weight_decay:
                    u -= lr * self.weight_decay * p.float()
                p.add_(u.to(p.dtype))


class ClippedSGD(SGD):
    """Clip by global norm (unless ``max_norm`` is None), then SGD with
    momentum: the optimizer of every local-SSL session, server fit and
    iterative baseline."""

    def __init__(
        self,
        params: Sequence[torch.Tensor],
        lr: float,
        momentum: float = 0.9,
        max_norm: Optional[float] = 5.0,
    ) -> None:
        super().__init__(params, lr, momentum=momentum, max_norm=max_norm)
