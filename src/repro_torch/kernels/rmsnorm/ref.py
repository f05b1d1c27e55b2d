"""Plain PyTorch version of the fused RMSNorm.

``x · rsqrt(mean(x²) + eps) · scale`` per row, in float32 (float64 for a
float64 x, so ``gradcheck`` can hold the backward), written in x's dtype: the reference's ``repro.kernels.rmsnorm.ref.rms_norm`` in the same
association. It is the oracle the CUDA kernel is held against and the route
a CPU tensor takes.

:func:`rms_norm_backward` is the backward's plain version, the explicit
formula the CUDA backward computes (the TPU kernel has none).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), scale (d,) → (..., d) in x's dtype."""
    ct = _compute_dtype(x)
    xf = x.to(ct)
    var = xf.square().mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.to(ct)).to(x.dtype)


def rms_norm_backward(
    x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, eps: float = 1e-6
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of :func:`rms_norm` for the output's gradient ``dy``,
    per row in f32 with r = rsqrt(mean(x²) + eps):

    * ``dx = r·(s·dy) − x·r³·mean(x·s·dy)``, rounded once to x's dtype;
    * ``dscale = Σ_rows dy·x·r``, in scale's dtype."""
    ct = _compute_dtype(x)
    xf, sf, dyf = x.to(ct), scale.to(ct), dy.to(ct)
    r = torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    g = sf * dyf
    mean_xg = (xf * g).mean(dim=-1, keepdim=True)
    dx = r * g - xf * (r * r * r * mean_xg)
    dscale = (dyf * xf * r).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dscale.to(scale.dtype)
