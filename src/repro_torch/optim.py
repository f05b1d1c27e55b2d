"""Gradient clipping and SGD with momentum, written out by hand.

Counterparts of ``repro.optim``'s ``chain(clip_by_global_norm(c),
sgd(lr, momentum=μ))``, the optimizer of every local-SSL session and server
fit, and of its unclipped ``sgd(lr, momentum=μ)``, the optimizer of the
iterative baselines (``max_norm=None``). Two details are the reference's,
not PyTorch's:

* the clip factor is ``min(1, c / (‖g‖ + 1e-12))``
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6);
* the momentum trace is ``m ← μ·m + g`` from ``m = 0`` and the update is
  ``p ← p + (−lr·m)``: no dampening, the same rounding steps.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """√(Σ_leaves Σ x²) in float32."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> None:
    """Scale ``grads`` in place by ``min(1, max_norm / (norm + 1e-12))``."""
    factor = torch.clamp(max_norm / (global_norm(grads) + 1e-12), max=1.0)
    for g in grads:
        g.mul_(factor)


class ClippedSGD:
    """Clip by global norm (unless ``max_norm`` is None), then SGD with
    momentum, over a fixed parameter list. ``step(grads)`` takes the
    gradients in parameter order."""

    def __init__(
        self,
        params: Sequence[torch.Tensor],
        lr: float,
        momentum: float = 0.9,
        max_norm: Optional[float] = 5.0,
    ) -> None:
        self.params: List[torch.Tensor] = list(params)
        self.lr, self.momentum, self.max_norm = lr, momentum, max_norm
        self.trace = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = [g.float() for g in grads]
        if self.max_norm is not None:
            clip_by_global_norm_(grads, self.max_norm)
        for p, m, g in zip(self.params, self.trace, grads):
            m.mul_(self.momentum).add_(g)
            p.add_((m * -self.lr).to(p.dtype))
