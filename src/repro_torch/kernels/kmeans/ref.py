"""Plain PyTorch version of the k-means assignment.

``argmin_c (‖x‖² − 2x·μ_cᵀ + ‖μ_c‖²)`` in float32 over a leading batch axis,
with the reference's expansion and ``argmin``'s first-index tie rule: the
oracle the CUDA kernel is held against, and the route a CPU tensor takes.
"""

from __future__ import annotations

from typing import Tuple

import torch


def sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """(…, N, d), (…, C, d) → (…, N, C) squared distances, expanded."""
    x, centers = x.float(), centers.float()
    x2 = (x * x).sum(-1, keepdim=True)
    c2 = (centers * centers).sum(-1).unsqueeze(-2)
    return x2 - 2.0 * (x @ centers.transpose(-1, -2)) + c2


def kmeans_assign_min_batched(
    x: torch.Tensor, centers: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, N, d), centers (B, C, d) → assignments (B, N) int32 and the
    minimum distances (B, N) float32."""
    mind, idx = sq_dists(x, centers).min(-1)
    return idx.to(torch.int32), mind


def kmeans_assign_batched(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """x (B, N, d), centers (B, C, d) → (B, N) int32."""
    return sq_dists(x, centers).argmin(-1).to(torch.int32)


def kmeans_assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """x (N, d), centers (C, d) → (N,) int32."""
    return kmeans_assign_batched(x[None], centers[None])[0]


def kmeans_min_dist(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """x (N, d), centers (C, d) → (N,) float32: each row's least squared
    distance, expanded as :func:`sq_dists` does."""
    return sq_dists(x, centers).amin(-1)
