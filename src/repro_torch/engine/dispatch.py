"""Kernel dispatch for step ③'s k-means, the Eq. 10 estimates and few-shot
step ③' (estimates + the Eq. 8-9 gate).

Counterpart of ``repro.engine.dispatch``. The reference routes through a
``use_kernels`` switch and a compile-session cache; here the route follows
the tensors' device (the CUDA kernels on the card, the plain versions on
the CPU), so the switch has no counterpart; the folds' built closures sit
in ``engine.sessions`` (domain ``"sdpa"`` for :func:`estimate_missing_batched`).
A batch mesh (``engine.parallel``) shards the stacked forms slot by slot:
each slot's k-means search and Eq. 10 estimate is its own launch over its
slice, on its device.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch

from repro_torch.core import clustering, estimator
from repro_torch.engine import parallel, sessions


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
    mesh=None,
) -> torch.Tensor:
    """Step ③ for a stack of parties (B, N, d) → (B, N) int64, restarts and
    parties on one axis: each Lloyd iteration is one launch over B·R, the
    inertia one more, and the final assignment one over B.

    With a ``mesh`` each slot searches its slice of B (``kmeans_iters + 2``
    launches a slot); the caller pads B to a multiple of the slots and
    gives the padded ``draws`` (a generator would draw for the padding)."""

    def search(grads: torch.Tensor, d: Optional[clustering.SeedingDraws]) -> torch.Tensor:
        return clustering.gradient_pseudo_labels_batched(
            grads, num_classes, kmeans_iters, restarts, draws=d, generator=generator
        )[0]

    mesh = parallel.resolve_mesh(mesh, partial_grads.device)
    if mesh is not None and draws is None:
        raise ValueError("a sharded k-means search takes its seeding draws, padded with the batch")
    return parallel.shard_step(search, mesh)(partial_grads, draws)


def estimate_missing_fused(
    h_u_k: torch.Tensor, h_o_all: Sequence[torch.Tensor], k: int
) -> List[torch.Tensor]:
    """All K−1 missing-party estimates for one query batch: the one-entry
    case of :func:`estimate_missing_batched`. When K−1 > 1 and the other
    parties' overlap reps share one shape, the estimates are ONE launch of
    width K−1, h_u and H_o^k broadcast as stride-0 ``expand`` views (no
    copies; the kernel takes batch strides); otherwise each estimate is its
    own width-1 launch."""
    ests = estimate_missing_batched(h_u_k[None], [h[None] for h in h_o_all], k)
    return [e[0] for e in ests]


def estimate_missing_batched(
    h_u_stack: torch.Tensor, h_o_stacks: Sequence[torch.Tensor], k: int, mesh=None
) -> List[torch.Tensor]:
    """Few-shot step ③' estimates over a stacked entry axis (seeds and
    scenarios): ``h_u_stack`` (E, N_u, d_k) is party k's unaligned reps in
    every entry and ``h_o_stacks[j]`` (E, N_o, d_j) party j's overlap reps.
    Returns the K−1 other parties' estimates (E, N_u, d_j), in party order.

    When the other parties' overlap reps share one shape, all K−1 estimates
    are ONE launch: at E = 1 of width K−1 over stride-0 views of h_u and
    H_o^k (:func:`estimate_missing_fused`'s layout, so a single entry
    launches exactly what it did), at E > 1 of width (K−1)·E, party-major,
    with h_u and H_o^k repeated. Otherwise each missing party is one launch
    of width E.

    With a ``mesh`` each slot makes those launches over its slice of E
    (the caller pads E to a multiple of the slots)."""
    others = [j for j in range(len(h_o_stacks)) if j != k]
    fuse = len(others) > 1 and len({tuple(h_o_stacks[j].shape) for j in others}) == 1
    mesh = parallel.resolve_mesh(mesh, h_u_stack.device)
    fn = sessions.cached_session(
        "sdpa", ("estimate_missing", fuse, parallel.mesh_key(mesh)), lambda: _missing_fn(fuse)
    )
    return parallel.shard_step(fn, mesh)(h_u_stack, list(h_o_stacks), k, others)


def _missing_fn(fuse: bool):
    """The Eq. 10 estimate of the missing parties, fused or one launch a party."""

    def fused(h_u, h_o, k, others):
        width, e = len(others), h_u.shape[0]
        if e == 1:
            q = h_u[0].expand(width, *h_u.shape[1:])
            a = h_o[k][0].expand(width, *h_o[k].shape[1:])
            b = torch.stack([h_o[j][0] for j in others])
        else:
            q = h_u.repeat(width, 1, 1)
            a = h_o[k].repeat(width, 1, 1)
            b = torch.cat([h_o[j] for j in others])
        est = estimator.sdpa_transform_batched(q, a, b)
        return list(est.reshape(width, e, *est.shape[1:]).unbind(0))

    def per_party(h_u, h_o, k, others):
        return [estimator.sdpa_transform_batched(h_u, h_o[k], h_o[j]) for j in others]

    return fused if fuse else per_party


def gate(
    server: Any, k: int, h_u_k: torch.Tensor, estimates: Sequence[torch.Tensor], threshold: float
) -> torch.Tensor:
    """The Eq. 8-9 gate of party k's unaligned reps h_u_k: the K−1
    ``estimates`` concatenated in party order with h_u_k in slot k, gated
    with ``server``'s fitted f_c^k and f_c. Returns p̂, float32 (N_u,)."""
    parts = [e.float() for e in estimates]
    parts.insert(k, h_u_k.float())
    return estimator.infer_prob(
        server.aux_logits_fn(k),
        server.joint_logits_fn(),
        h_u_k.float(),
        torch.cat(parts, dim=-1),
        threshold,
    )


def fewshot_probs(
    server: Any,
    k: int,
    h_u_k: torch.Tensor,
    h_o_all: Sequence[torch.Tensor],
    threshold: float,
    estimates_out: Optional[list] = None,
) -> torch.Tensor:
    """Few-shot step ③' for party k at one seed (the S = 1 case of
    ``engine.batched.fewshot_probs_seeds``): estimate the K−1 missing parties
    of its unaligned reps h_u_k (Eq. 10, :func:`estimate_missing_fused`:
    one ``sdpa_estimator`` launch per party at K = 2), then :func:`gate`.
    Returns p̂, float32 (N_u,); ``estimates_out`` (if given) receives the
    estimates, in party order."""
    ests = estimate_missing_fused(h_u_k, h_o_all, k)
    if estimates_out is not None:
        estimates_out.extend(ests)
    return gate(server, k, h_u_k, ests, threshold)
