"""Few-shot server machinery: Eq. 10 representation estimation and the
Eq. 8-9 gate.

Counterpart of ``repro.core.estimator``. ``sdpa_transform`` estimates
Ĥ_u^B = softmax(H_u^A H_o^Aᵀ / √d) H_o^B through the SDPA estimator's
wrapper, which launches the CUDA kernel for tensors on the card and runs the
plain version for tensors on the CPU; the kernel has no backward.
``sdpa_transform_differentiable`` is Eq. 10 in plain tensor ops, for the
one caller that differentiates through it (FedCVT's step). ``infer_prob``
gates a party's unaligned rows for pseudo-labeling (few-shot step ③').
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence

import torch

from repro_torch.kernels.sdpa_estimator import ops


def sdpa_transform(h_u_a: torch.Tensor, h_o_a: torch.Tensor, h_o_b: torch.Tensor) -> torch.Tensor:
    """Ĥ_u^B = softmax(H_u^A H_o^Aᵀ / √d) H_o^B (Eq. 10).

    Shapes: h_u_a (N_u, d_a), h_o_a (N_o, d_a), h_o_b (N_o, d_b)."""
    return ops.sdpa_estimate(h_u_a, h_o_a, h_o_b)


def sdpa_transform_differentiable(
    h_u_a: torch.Tensor, h_o_a: torch.Tensor, h_o_b: torch.Tensor
) -> torch.Tensor:
    """Eq. 10 with autograd through all three inputs, on any device.

    The counterpart of the reference's jnp route of ``sdpa_transform``
    (``repro/core/estimator.py``, without ``use_kernel``), which is what its
    FedCVT step differentiates: ``softmax(H_u H_oᴬᵀ / √d) H_oᴮ`` in the
    inputs' dtype. Shapes as :func:`sdpa_transform`."""
    scores = (h_u_a @ h_o_a.T) / math.sqrt(h_u_a.shape[-1])
    return torch.softmax(scores, dim=-1) @ h_o_b


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


@torch.no_grad()
def infer_prob(
    aux_logits_fn: Callable[[torch.Tensor], torch.Tensor],
    joint_logits_fn: Callable[[torch.Tensor], torch.Tensor],
    h_u_k: torch.Tensor,
    full_rep: torch.Tensor,
    threshold: float,
) -> torch.Tensor:
    """p̂_{u,i} = 1[ŷ^A = ŷ^{A,B}] · 1[p^A > t] · 1[p^{A,B} > t] · p^{A,B} (Eq. 9).

    ``aux_logits_fn`` is the local-only f_c^k on h_u_k (N_u, d_k),
    ``joint_logits_fn`` the joint f_c on the concatenated full_rep (N_u, Σd).
    Returns float32 (N_u,); argmax ties go to the lowest class index."""
    p_local = torch.softmax(aux_logits_fn(h_u_k).float(), dim=-1)
    p_joint = torch.softmax(joint_logits_fn(full_rep).float(), dim=-1)
    conf_local, conf_joint = p_local.amax(dim=-1), p_joint.amax(dim=-1)
    agree = p_local.argmax(dim=-1) == p_joint.argmax(dim=-1)
    gate = agree & (conf_local > threshold) & (conf_joint > threshold)
    return gate.float() * conf_joint
