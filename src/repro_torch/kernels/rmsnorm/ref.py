"""Plain PyTorch version of the fused RMSNorm.

``x · rsqrt(mean(x²) + eps) · scale`` per row, in float32, written in x's
dtype: the reference's ``repro.kernels.rmsnorm.ref.rms_norm`` in the same
association. It is the oracle the CUDA kernel is held against and the route
a CPU tensor takes.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), scale (d,) → (..., d) in x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * scale.float()).to(x.dtype)
