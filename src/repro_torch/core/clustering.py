"""k-means over partial gradients → temporary labels (step ③, Alg. 1 l.28).

Counterpart of ``repro.core.clustering``: rows are cosine-normalised, each
restart is seeded by k-means++ and refined by Lloyd iterations (an empty
cluster keeps its centre, then every centre is renormalised), and the
restart with the lowest inertia wins. Restarts and parties batch on one
leading axis (B = K·R), the port's form of the reference's ``vmap``.

Every cluster assignment goes through
:mod:`repro_torch.kernels.kmeans.ops`: on the card each one is a launch of
the hand-written CUDA kernel (each Lloyd iteration's, batched over K·R; the
inertia's, which also takes the minimum distance; the final one, batched
over K), on the CPU the plain version. A run of ``iters`` Lloyd iterations
therefore makes ``iters + 2`` launches. The k-means++ seeding's masked
minimum stays in torch: it is a different function from the kernel's.

k-means++ draws. ``jax.random.choice(key, n, p=probs)`` is, in JAX 0.9,
``searchsorted(cumsum(p), cumsum(p)[-1]·(1−u), side="left")`` with one
uniform u, and the first centre is a uniform integer in [0, n). So a
restart's seeding takes one integer and C−1 uniforms
(:class:`SeedingDraws`), and applies the same inverse-CDF rule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.kmeans import ops, ref


@dataclass
class SeedingDraws:
    first: torch.Tensor  # (B, R) int64: first centre's row
    u: torch.Tensor  # (B, R, C-1) uniforms in [0, 1): the later picks


def draw_seeding(
    gen: torch.Generator, batch: int, restarts: int, n: int, num_clusters: int, device
) -> SeedingDraws:
    first = torch.randint(0, n, (batch, restarts), generator=gen, device=device)
    u = torch.rand(batch, restarts, num_clusters - 1, generator=gen, device=device)
    return SeedingDraws(first, u)


def assign_clusters(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """argmin_c ‖x_i − μ_c‖² → (N,) int32 (one kernel launch on the card)."""
    return ops.kmeans_assign(x, centers)


def normalize_rows(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def kmeanspp_init(
    xn: torch.Tensor, num_clusters: int, first: torch.Tensor, u: torch.Tensor
) -> torch.Tensor:
    """k-means++ seeding over a batch: xn (M, N, d), first (M,), u (M, C−1)
    → centres (M, C, d)."""
    m, n, _ = xn.shape
    rows = torch.arange(m, device=xn.device)
    centers = torch.zeros(m, num_clusters, xn.shape[2], device=xn.device, dtype=xn.dtype)
    centers[:, 0] = xn[rows, first]
    for i in range(1, num_clusters):
        d = ref.sq_dists(xn, centers)  # the centres chosen so far; the rest masked
        valid = torch.arange(num_clusters, device=xn.device) < i
        dmin = torch.where(valid, d, torch.inf).amin(-1).clamp_min(0.0)
        probs = dmin / torch.clamp(dmin.sum(-1, keepdim=True), min=1e-12)
        cum = torch.cumsum(probs, dim=-1)
        r = cum[:, -1:] * (1.0 - u[:, i - 1 : i])
        idx = torch.searchsorted(cum, r, side="left")[:, 0].clamp_max(n - 1)
        centers[:, i] = xn[rows, idx]
    return centers


def lloyd(xn: torch.Tensor, centers: torch.Tensor, num_iters: int) -> torch.Tensor:
    """``num_iters`` Lloyd iterations over a batch, one assignment launch
    each: xn (M, N, d), centres (M, C, d) → centres (M, C, d)."""
    num_clusters = centers.shape[1]
    for _ in range(num_iters):
        assign = ops.kmeans_assign_batched(xn, centers)
        onehot = F.one_hot(assign.long(), num_clusters).to(xn.dtype)  # (M, N, C)
        sums = onehot.transpose(1, 2) @ xn  # (M, C, d)
        counts = onehot.sum(1).unsqueeze(-1)
        new = sums / torch.clamp(counts, min=1.0)
        new = torch.where(counts > 0, new, centers)  # empty clusters stay put
        centers = normalize_rows(new)
    return centers


def normalized_search_batched(
    x: torch.Tensor, num_clusters: int, num_iters: int, restarts: int, draws: SeedingDraws
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The search of every restart of every batch entry at once.

    x (B, N, d) → (xn (B, N, d), all centres (B, R, C, d), inertias (B, R)).
    The restarts fold into the leading axis (B·R) for the seeding, the Lloyd
    iterations and the inertia's assignment."""
    b, n, d = x.shape
    xn = normalize_rows(x)
    xr = xn.repeat_interleave(restarts, dim=0)  # (B·R, N, d), restart-minor
    centers = kmeanspp_init(
        xr, num_clusters, draws.first.reshape(-1), draws.u.reshape(b * restarts, -1)
    )
    centers = lloyd(xr, centers, num_iters)
    _, mind = ops.kmeans_assign_min_batched(xr, centers)
    inertia = mind.sum(-1).reshape(b, restarts)
    return xn, centers.reshape(b, restarts, num_clusters, d), inertia


def gradient_pseudo_labels_batched(
    partial_grads: torch.Tensor,
    num_classes: int,
    num_iters: int = 25,
    restarts: int = 4,
    *,
    draws: Optional[SeedingDraws] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ŷ_o^k ← k-means(∇_{H_o^k} L, C) for a stack of gradient matrices:
    (B, N, d) → (labels (B, N) int64, lowest-inertia centres (B, C, d)).
    The seeding draws come from ``draws`` or, when absent, ``generator``."""
    b, n, _ = partial_grads.shape
    if draws is None:
        if generator is None:
            raise ValueError("give the k-means++ draws or a generator to draw them from")
        draws = draw_seeding(generator, b, restarts, n, num_classes, partial_grads.device)
    xn, centers, inertia = normalized_search_batched(
        partial_grads, num_classes, num_iters, restarts, draws
    )
    best = centers[torch.arange(b, device=xn.device), inertia.argmin(-1)]
    return ops.kmeans_assign_batched(xn, best).long(), best


def kmeans(
    x: torch.Tensor,
    num_clusters: int,
    num_iters: int = 25,
    restarts: int = 4,
    *,
    draws: Optional[SeedingDraws] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-restart cosine k-means of one matrix (N, d) → (labels, centres)."""
    labels, centers = gradient_pseudo_labels_batched(
        x[None], num_clusters, num_iters, restarts, draws=draws, generator=generator
    )
    return labels[0], centers[0]


def gradient_pseudo_labels(
    partial_grads: torch.Tensor,
    num_classes: int,
    num_iters: int = 25,
    restarts: int = 4,
    *,
    draws: Optional[SeedingDraws] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Ŷ_o^k for one party: (N, d) → (N,) int64."""
    return kmeans(
        partial_grads, num_classes, num_iters, restarts, draws=draws, generator=generator
    )[0]


def cluster_purity(pseudo: torch.Tensor, true: torch.Tensor, num_classes: int) -> float:
    """Fraction of rows whose cluster's majority true label is their own
    (a diagnostic; label-permutation invariant)."""
    conf = torch.zeros(num_classes, num_classes, dtype=torch.int64, device=pseudo.device)
    ones = torch.ones_like(pseudo, dtype=torch.int64)
    conf.index_put_((pseudo.long(), true.long()), ones, accumulate=True)
    return float(conf.amax(1).sum()) / pseudo.shape[0]


def align_pseudo_to_true(pseudo: torch.Tensor, true: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Greedy cluster → label matching (a diagnostic: clients never see true
    labels). The largest count of the confusion matrix is matched first,
    its row and column struck out, num_classes times; a cluster left over
    (an empty one) takes the remaining labels from the highest down, as the
    reference's ``pop()`` hands them out. Returns each row's matched label."""
    conf = torch.zeros(num_classes, num_classes, dtype=torch.int64)
    ones = torch.ones(pseudo.shape[0], dtype=torch.int64)
    conf.index_put_((pseudo.long().cpu(), true.long().cpu()), ones, accumulate=True)
    conf = conf.numpy()
    mapping = -np.ones(num_classes, np.int64)
    used = set()
    for _ in range(num_classes):
        i, j = np.unravel_index(np.argmax(conf), conf.shape)  # the first maximum, row-major
        mapping[i] = j
        conf[i, :] = -1
        conf[:, j] = -1
        used.add(j)
    remaining = [j for j in range(num_classes) if j not in used]
    for i in range(num_classes):
        if mapping[i] < 0:
            mapping[i] = remaining.pop()
    return torch.from_numpy(mapping).to(pseudo.device)[pseudo.long()]
