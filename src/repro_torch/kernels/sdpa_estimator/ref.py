"""Plain PyTorch version of the Eq. 10 SDPA estimator.

``softmax(H_u H_oᴬᵀ / √d) H_oᴮ`` in float32 over a leading batch axis: the
oracle the CUDA kernel is held against, and the route a CPU tensor takes.
"""

from __future__ import annotations

import math

import torch


def sdpa_estimate_batched(
    h_u: torch.Tensor, h_o_a: torch.Tensor, h_o_b: torch.Tensor
) -> torch.Tensor:
    """h_u (B, N_u, d), h_o_a (B, N_o, d), h_o_b (B, N_o, d_b) → (B, N_u, d_b)."""
    h_u, h_o_a, h_o_b = h_u.float(), h_o_a.float(), h_o_b.float()
    scores = (h_u @ h_o_a.transpose(-1, -2)) / math.sqrt(h_u.shape[-1])
    return torch.softmax(scores, dim=-1) @ h_o_b


def sdpa_estimate(h_u: torch.Tensor, h_o_a: torch.Tensor, h_o_b: torch.Tensor) -> torch.Tensor:
    """h_u (N_u, d), h_o_a (N_o, d), h_o_b (N_o, d_b) → (N_u, d_b) f32."""
    return sdpa_estimate_batched(h_u[None], h_o_a[None], h_o_b[None])[0]
