"""Kernel dispatch for the serving path's Eq. 10 estimates.

Counterpart of the estimation half of ``repro.engine.dispatch``. The
reference routes through a ``use_kernels`` switch and a compile-session
cache; here the route follows the tensors' device (the CUDA kernel on the
card, the plain version on the CPU) and PyTorch runs eagerly, so neither the
switch nor the cache has a counterpart.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from repro_torch.core import estimator


def estimate_missing(
    h_u_k: torch.Tensor, h_o_all: Sequence[torch.Tensor], k: int
) -> List[torch.Tensor]:
    """Few-shot step ③': the K−1 other parties' representations of party
    k's rows, one Eq. 10 launch per missing party."""
    return estimator.estimate_missing_parties(h_u_k, h_o_all, k)


def estimate_missing_fused(
    h_u_k: torch.Tensor, h_o_all: Sequence[torch.Tensor], k: int
) -> List[torch.Tensor]:
    """All K−1 missing-party estimates for one query batch.

    When K−1 > 1 and the other parties' overlap reps share one shape, the
    estimates are ONE batched launch of width K−1: h_u and H_o^k are
    broadcast over the batch as stride-0 ``expand`` views (no copies; the
    kernel takes batch strides) and the K−1 value matrices are stacked.
    Otherwise each estimate is its own width-1 launch."""
    others = [j for j in range(len(h_o_all)) if j != k]
    if len(others) > 1 and len({tuple(h_o_all[j].shape) for j in others}) == 1:
        width = len(others)
        q = h_u_k.expand(width, *h_u_k.shape)
        a = h_o_all[k].expand(width, *h_o_all[k].shape)
        b = torch.stack([h_o_all[j] for j in others])
        return list(estimator.sdpa_transform_batched(q, a, b).unbind(0))
    return estimate_missing(h_u_k, h_o_all, k)
