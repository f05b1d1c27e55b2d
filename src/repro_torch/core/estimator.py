"""Few-shot server machinery: Eq. 10 representation estimation.

Counterpart of ``repro.core.estimator``. ``sdpa_transform`` estimates
Ĥ_u^B = softmax(H_u^A H_o^Aᵀ / √d) H_o^B through the SDPA estimator's
wrapper, which launches the CUDA kernel for tensors on the card and runs the
plain version for tensors on the CPU. ``infer_prob`` (the Eq. 8-9 gate)
belongs to few-shot training and is not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.kernels.sdpa_estimator import ops


def sdpa_transform(h_u_a: torch.Tensor, h_o_a: torch.Tensor, h_o_b: torch.Tensor) -> torch.Tensor:
    """Ĥ_u^B = softmax(H_u^A H_o^Aᵀ / √d) H_o^B (Eq. 10).

    Shapes: h_u_a (N_u, d_a), h_o_a (N_o, d_a), h_o_b (N_o, d_b)."""
    return ops.sdpa_estimate(h_u_a, h_o_a, h_o_b)


def sdpa_transform_batched(
    h_u_a: torch.Tensor, h_o_a: torch.Tensor, h_o_b: torch.Tensor
) -> torch.Tensor:
    """Eq. 10 over a leading batch axis, as one kernel launch.

    Shapes: h_u_a (B, N_u, d_a), h_o_a (B, N_o, d_a), h_o_b (B, N_o, d_b)."""
    return ops.sdpa_estimate_batched(h_u_a, h_o_a, h_o_b)


def estimate_missing_parties(
    h_u_k: torch.Tensor, h_o_all: Sequence[torch.Tensor], k: int
) -> List[torch.Tensor]:
    """For party k's unaligned reps, estimate every other party's missing
    representation (the K-ary generalization of Eq. 10), in party order."""
    return [sdpa_transform(h_u_k, h_o_all[k], h_o_j) for j, h_o_j in enumerate(h_o_all) if j != k]
