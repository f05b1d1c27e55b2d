"""Kernel dispatch for step ③'s k-means, the Eq. 10 estimates and few-shot
step ③' (estimates + the Eq. 8-9 gate).

Counterpart of ``repro.engine.dispatch``. The reference routes through a
``use_kernels`` switch and a compile-session cache; here the route follows
the tensors' device (the CUDA kernels on the card, the plain versions on
the CPU) and PyTorch runs eagerly, so neither the switch nor the cache has
a counterpart.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

from repro_torch.core import clustering, estimator


def pseudo_labels(
    partial_grads: torch.Tensor,
    num_classes: int,
    kmeans_iters: int = 25,
    restarts: int = 4,
    *,
    draws: Optional[clustering.SeedingDraws] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Step ③ for one party: k-means over ∇_{H_o^k} L → Ŷ_o^k (N,) int64.
    On the card every assignment is a ``kmeans`` kernel launch
    (``kmeans_iters + 2`` of them)."""
    return clustering.gradient_pseudo_labels(
        partial_grads, num_classes, kmeans_iters, restarts, draws=draws, generator=generator
    )


def pseudo_labels_batched(
    partial_grads: torch.Tensor,
    num_classes: int,
    kmeans_iters: int = 25,
    restarts: int = 4,
    *,
    draws: Optional[clustering.SeedingDraws] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Step ③ for a stack of parties (B, N, d) → (B, N) int64, restarts and
    parties on one axis: each Lloyd iteration is one launch over B·R, the
    inertia one more, and the final assignment one over B."""
    return clustering.gradient_pseudo_labels_batched(
        partial_grads, num_classes, kmeans_iters, restarts, draws=draws, generator=generator
    )[0]


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


def fewshot_probs(
    server: Any,
    k: int,
    h_u_k: torch.Tensor,
    h_o_all: Sequence[torch.Tensor],
    threshold: float,
    estimates_out: Optional[list] = None,
) -> torch.Tensor:
    """Few-shot step ③' for party k at one seed (the S = 1 case of the
    reference's ``fewshot_probs_seeds``): estimate the K−1 missing parties
    of its unaligned reps h_u_k (Eq. 10, :func:`estimate_missing_fused`:
    one ``sdpa_estimator`` launch per party at K = 2), concatenate in party
    order with h_u_k in slot k, and gate with ``server``'s fitted f_c^k and
    f_c (Eq. 8-9). Returns p̂, float32 (N_u,); ``estimates_out`` (if given)
    receives the estimates, in party order."""
    ests = estimate_missing_fused(h_u_k, h_o_all, k)
    if estimates_out is not None:
        estimates_out.extend(ests)
    parts = [e.float() for e in ests]
    parts.insert(k, h_u_k.float())
    return estimator.infer_prob(
        server.aux_logits_fn(k),
        server.joint_logits_fn(),
        h_u_k.float(),
        torch.cat(parts, dim=-1),
        threshold,
    )
