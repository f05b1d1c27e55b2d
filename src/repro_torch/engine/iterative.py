"""Iterative split-NN VFL sessions: the steps of the three baselines.

Counterpart of ``repro.engine.iterative`` at one seed:

* ``make_splitnn_step_fn``: one SplitNN iteration, reps up and
  rep-gradients down, as one joint backward over every party's extractor
  and the server classifier;
* ``make_fedcvt_step_fn``: the same iteration plus FedCVT-style cross-view
  training: each party's unaligned batch, completed with Eq. 10 estimates
  of the other parties' reps, joins the loss where its pseudo-label
  confidence clears a threshold;
* ``make_fedbcd_step_fn``: one FedBCD-p round [20], one rep exchange then
  ``q`` local updates on the stale rep-gradients (clients) and the stale
  reps (server);
* ``build_iteration_schedule`` / ``build_unaligned_schedule``: the
  numpy-seeded minibatch schedules, equal to the reference's index for
  index;
* ``run_iterative_session``: a Python loop of a step over a schedule, up
  to a commit horizon (``active_steps``, the fault path's dropout stall).

A step function updates the parties' extractors, the server classifier and
their momentum traces (unclipped SGD with momentum, ``optim.ClippedSGD``
with ``max_norm=None``) in place, and returns the step's loss; called with
``commit=False`` it only computes that loss at the current state. Only the
extractors and the classifier train: a client's local head rides in the
reference's carry with a zero gradient and stays unchanged, so here it is
left out. The reference's jitted ``lax.scan`` session, its compile cache
and its seed fold have no counterpart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import estimator
from repro_torch.core.server import concat_reps
from repro_torch.core.ssl import cross_entropy
from repro_torch.data.loader import epoch_batches
from repro_torch.optim import ClippedSGD

# step(xs, y, xs_u, commit=True) -> loss: minibatches of each party's aligned
# rows, their labels, and (FedCVT only) each party's unaligned minibatch;
# with commit=False the step updates nothing
Step = Callable[..., torch.Tensor]


@dataclass(frozen=True)
class IterHParams:
    """Optimizer hyper-parameters of one iterative session."""

    client_lr: float = 0.01
    server_lr: float = 0.01
    momentum: float = 0.9
    fedcvt_threshold: float = 0.95


def _optimizers(
    extractors: Sequence[nn.Module], classifier: nn.Module, hp: IterHParams
) -> Tuple[List[ClippedSGD], ClippedSGD]:
    """One unclipped SGD with momentum per extractor, one for the classifier."""
    clients = [
        ClippedSGD(list(e.parameters()), hp.client_lr, hp.momentum, max_norm=None)
        for e in extractors
    ]
    server = ClippedSGD(list(classifier.parameters()), hp.server_lr, hp.momentum, max_norm=None)
    return clients, server


def _joint_update(loss: torch.Tensor, opts: Sequence[ClippedSGD]) -> None:
    """One backward of ``loss`` over every optimizer's parameters, then each
    optimizer's step on its share of the gradients."""
    grads = torch.autograd.grad(loss, [p for opt in opts for p in opt.params])
    start = 0
    for opt in opts:
        opt.step(grads[start : start + len(opt.params)])
        start += len(opt.params)


def make_splitnn_step_fn(
    extractors: Sequence[nn.Module], classifier: nn.Module, hp: IterHParams
) -> Step:
    """One SplitNN iteration: mean CE of the classifier on the concatenated
    reps, differentiated jointly through every extractor and the classifier.
    The iteration's communication (reps up, rep-gradients down) is logged by
    the caller."""
    extractors = list(extractors)
    clients, server = _optimizers(extractors, classifier, hp)

    def step(xs, y, xs_u=None, commit=True):
        del xs_u
        with torch.set_grad_enabled(commit):
            reps = [e(x) for e, x in zip(extractors, xs)]
            loss = cross_entropy(classifier(concat_reps(reps)), y).mean()
        if commit:
            _joint_update(loss, [*clients, server])
        return loss.detach()

    return step


def make_fedcvt_step_fn(
    extractors: Sequence[nn.Module], classifier: nn.Module, hp: IterHParams
) -> Step:
    """SplitNN iteration + FedCVT-style cross-view expansion. For each party
    k, its unaligned batch's reps H_u^k are completed with Eq. 10 estimates
    of every other party j from this step's overlap reps (H_o^k as keys,
    H_o^j as values), differentiated through all three. Pseudo-labels and the
    mask ``max p > hp.fedcvt_threshold`` come from the detached logits; the
    masked CE ``Σ ce·mask / max(Σ mask, 1)`` joins the loss. An empty pool
    (zero-row batch) adds exactly 0. ``xs_u`` is required."""
    extractors = list(extractors)
    clients, server = _optimizers(extractors, classifier, hp)

    def step(xs, y, xs_u, commit=True):
        with torch.set_grad_enabled(commit):
            reps_o = [e(x) for e, x in zip(extractors, xs)]
            loss = cross_entropy(classifier(concat_reps(reps_o)), y).mean()
            for k, (e, x_u) in enumerate(zip(extractors, xs_u)):
                h_u = e(x_u)
                parts = [
                    h_u if j == k else estimator.sdpa_transform_differentiable(h_u, reps_o[k], o)
                    for j, o in enumerate(reps_o)
                ]
                logits_u = classifier(concat_reps(parts))
                p_u = torch.softmax(logits_u.detach(), dim=-1)
                conf, pseudo = p_u.max(dim=-1)
                mask = (conf > hp.fedcvt_threshold).float()
                ce = cross_entropy(logits_u, pseudo)
                loss = loss + (ce * mask).sum() / mask.sum().clamp(min=1.0)
        if commit:
            _joint_update(loss, [*clients, server])
        return loss.detach()

    return step


def make_fedbcd_step_fn(
    extractors: Sequence[nn.Module], classifier: nn.Module, hp: IterHParams, q: int
) -> Step:
    """One FedBCD-p communication round: fresh reps up and rep-gradients
    ∂L/∂H down once, then ``q`` local updates, each client on the surrogate
    ``Σ g ⊙ f_k(x; θ)`` with g fixed at round entry, the server on the
    round-entry reps. Returns the round-entry loss."""
    extractors = list(extractors)
    clients, server = _optimizers(extractors, classifier, hp)

    def step(xs, y, xs_u=None, commit=True):
        del xs_u
        with torch.no_grad():
            reps = [e(x) for e, x in zip(extractors, xs)]
            if not commit:
                return cross_entropy(classifier(concat_reps(reps)), y).mean()
        leaves = [r.requires_grad_(True) for r in reps]
        loss = cross_entropy(classifier(concat_reps(leaves)), y).mean()
        g_reps = torch.autograd.grad(loss, leaves)
        for e, opt, x, g in zip(extractors, clients, xs, g_reps):
            for _ in range(q):
                surrogate = (g * e(x)).sum()
                opt.step(torch.autograd.grad(surrogate, opt.params))
        stale = concat_reps([r.detach() for r in reps])
        for _ in range(q):
            loss_s = cross_entropy(classifier(stale), y).mean()
            server.step(torch.autograd.grad(loss_s, server.params))
        return loss.detach()

    return step


def build_iteration_schedule(seed: int, n: int, batch_size: int, iterations: int) -> np.ndarray:
    """(S, bs) int64 minibatch indices: shuffled epochs seeded ``seed + e``,
    drop-remainder, cut to exactly ``iterations`` rows (the reference's)."""
    bs = min(batch_size, n)
    if iterations <= 0:
        return np.zeros((0, bs), np.int64)
    rows: List[np.ndarray] = []
    e = 0
    while len(rows) < iterations:
        for b in epoch_batches(n, bs, seed + e):
            rows.append(b)
            if len(rows) == iterations:
                break
        e += 1
    return np.stack(rows).astype(np.int64)


def build_unaligned_schedule(
    seed: int, pool_sizes: Sequence[int], batch_size: int, iterations: int
) -> Tuple[np.ndarray, ...]:
    """Per-party (S, bs) int64 uniform draws from each private pool, from one
    ``RandomState(seed)`` in party order (FedCVT's unaligned batches). An
    empty pool draws nothing and gives (S, 0) rows."""
    rng = np.random.RandomState(seed)
    return tuple(
        np.zeros((iterations, 0), np.int64)
        if n_u == 0
        else rng.randint(0, n_u, size=(iterations, batch_size)).astype(np.int64)
        for n_u in pool_sizes
    )


def run_iterative_session(
    step: Step,
    xs: Sequence[torch.Tensor],
    y: torch.Tensor,
    schedule: np.ndarray,
    xs_u: Optional[Sequence[torch.Tensor]] = None,
    u_schedules: Optional[Sequence[np.ndarray]] = None,
    active_steps: Optional[int] = None,
) -> torch.Tensor:
    """Run ``step`` over every row of ``schedule`` (and, with ``xs_u``, the
    matching rows of ``u_schedules``); returns the (S,) losses on y's
    device. With ``active_steps`` only the first ``active_steps`` steps
    commit: each later step computes its loss at the frozen state (the
    reference's stalled round loop) and updates nothing."""
    dev = y.device
    idx = torch.from_numpy(schedule).to(dev)
    u_idx = None if xs_u is None else [torch.from_numpy(u).to(dev) for u in u_schedules]
    losses = []
    for i in range(idx.shape[0]):
        il = idx[i]
        xub = None if xs_u is None else [xu[ui[i]] for xu, ui in zip(xs_u, u_idx)]
        commit = active_steps is None or i < active_steps
        losses.append(step([x[il] for x in xs], y[il], xub, commit=commit))
    return torch.stack(losses) if losses else torch.zeros(0, device=dev)
