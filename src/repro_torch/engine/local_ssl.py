"""The local-SSL session of one party (Alg. 1 l.29-34).

Counterpart of ``repro.engine.local_ssl``: ``build_schedule`` is the same
numpy-seeded epoch×minibatch schedule (so equal ``seed0`` gives equal
indices), and ``train_party_ssl`` runs it as a Python loop of steps, each
one minibatch of Eq. (4) followed by clip-5 SGD with momentum. PyTorch runs
eagerly, so the reference's jitted ``lax.scan`` session and its compile
cache have no counterpart. The parties train one after another; the
reference's stacked K-party session comes with the port's folds.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core.ssl import SSLConfig, SSLDraws, draw_ssl, ssl_loss
from repro_torch.data.loader import epoch_batches
from repro_torch.optim import ClippedSGD

# Offset of the unlabeled draw stream from the labeled shuffle stream: the
# labeled epochs seed RandomState(seed0 + e), the unlabeled ones
# RandomState(seed0 + 7919·e + _UNLABELED_STREAM), so the two never share a
# seed (the reference's constant).
_UNLABELED_STREAM = 104729


@dataclass(frozen=True)
class SSLHParams:
    """Hyper-parameters of the local-SSL loop (paper defaults)."""

    epochs: int = 20
    batch_size: int = 32
    learning_rate: float = 0.01
    momentum: float = 0.9
    unlabeled_ratio: int = 2  # μ: unlabeled batch = μ × labeled batch
    grad_clip: float = 5.0


@dataclass
class PartyTask:
    """One party's local-SSL problem: its modules (trained in place) and its
    pseudo-labeled and private data.

    ``labeled_mask`` / ``unlabeled_mask`` are per-row validity masks (None:
    every row counts). ``step_valid`` is the fault path's (S,) per-step
    commit mask (None: every step commits): a step whose entry is 0 draws
    and computes as usual but leaves the parameters and the momentum as
    they were."""

    extractor: nn.Module
    head: nn.Module
    ssl_cfg: SSLConfig
    x_labeled: torch.Tensor  # (N_l, …) overlap rows
    y_pseudo: torch.Tensor  # (N_l,) cluster pseudo-labels
    x_unlabeled: torch.Tensor  # (N_u, …) party-private pool
    feature_mean: Optional[torch.Tensor] = None  # x̄ for FixMatch-tab
    labeled_mask: Optional[torch.Tensor] = None
    unlabeled_mask: Optional[torch.Tensor] = None
    step_valid: Optional[torch.Tensor] = None


class Schedule(NamedTuple):
    idx_labeled: np.ndarray  # (S, bs_l) int64
    idx_unlabeled: np.ndarray  # (S, bs_u) int64


def schedule_steps(n_labeled: int, hp: SSLHParams) -> int:
    """The number of steps :func:`build_schedule` flattens the epochs into."""
    bs_l = min(hp.batch_size, n_labeled)
    return hp.epochs * (n_labeled // bs_l) if bs_l else 0


def build_schedule(seed0: int, n_labeled: int, n_unlabeled: int, hp: SSLHParams) -> Schedule:
    """Flatten the epoch×minibatch loop into one (S, …) schedule.

    Labeled batches are shuffled epochs (drop-remainder); unlabeled batches
    are independent uniform draws, μ× larger, from a decorrelated stream.
    An empty private pool gives zero-width unlabeled batches."""
    bs_l = min(hp.batch_size, n_labeled)
    bs_u = min(hp.batch_size * hp.unlabeled_ratio, n_unlabeled)
    idx_l: List[np.ndarray] = []
    idx_u: List[np.ndarray] = []
    for e in range(hp.epochs):
        u_rng = np.random.RandomState(seed0 + 7919 * e + _UNLABELED_STREAM)
        for batch in epoch_batches(n_labeled, bs_l, seed0 + e):
            idx_l.append(batch)
            if n_unlabeled > 0:
                idx_u.append(u_rng.randint(0, n_unlabeled, size=bs_u))
            else:
                idx_u.append(np.zeros(0, np.int64))
    if not idx_l:
        return Schedule(np.zeros((0, bs_l), np.int64), np.zeros((0, bs_u), np.int64))
    return Schedule(np.stack(idx_l).astype(np.int64), np.stack(idx_u).astype(np.int64))


def seed_from(gen: torch.Generator) -> int:
    """An integer schedule seed in [0, 2³¹−1) drawn from ``gen``."""
    return int(torch.randint(0, 2**31 - 1, (), generator=gen, device=gen.device))


def train_party_ssl(
    task: PartyTask,
    hp: SSLHParams,
    seed0: int,
    *,
    generator: Optional[torch.Generator] = None,
    step_draws: Optional[Sequence[SSLDraws]] = None,
) -> Dict[str, float]:
    """One party's SSL session; trains ``task.extractor`` and ``task.head``
    in place and returns the last step's metrics.

    ``seed0`` seeds the schedule (as the reference's ``build_schedule``
    draws it from its key). Each step's augmentation draws come from
    ``step_draws[i]`` when given, else from ``generator``, which must live
    on the data's device. A step that ``task.step_valid`` marks 0 still
    draws its augmentation and computes its loss and metrics, but commits
    nothing (no optimizer step), as the reference's masked session."""
    sched = build_schedule(seed0, task.x_labeled.shape[0], task.x_unlabeled.shape[0], hp)
    steps = sched.idx_labeled.shape[0]
    if step_draws is None and generator is None and steps:
        raise ValueError("give the per-step draws or a generator to draw them from")
    if step_draws is not None and len(step_draws) != steps:
        raise ValueError(f"{len(step_draws)} step draws for a {steps}-step schedule")
    valid = None if task.step_valid is None else [v > 0 for v in task.step_valid.tolist()]
    if valid is not None and len(valid) != steps:
        raise ValueError(f"{len(valid)} step_valid entries for a {steps}-step schedule")
    dev = task.x_labeled.device
    idx_l = torch.from_numpy(sched.idx_labeled).to(dev)
    idx_u = torch.from_numpy(sched.idx_unlabeled).to(dev)
    params = [*task.extractor.parameters(), *task.head.parameters()]
    opt = ClippedSGD(params, hp.learning_rate, hp.momentum, hp.grad_clip)

    def logits_fn(x: torch.Tensor) -> torch.Tensor:
        return task.head(task.extractor(x))

    metrics: Dict[str, torch.Tensor] = {}
    for i in range(steps):
        il, iu = idx_l[i], idx_u[i]
        xb_l, xb_u = task.x_labeled[il], task.x_unlabeled[iu]
        draws = (
            step_draws[i]
            if step_draws is not None
            else draw_ssl(generator, task.ssl_cfg, xb_l.shape, xb_u.shape, dev)
        )
        commit = valid is None or valid[i]
        with torch.set_grad_enabled(commit):
            loss, metrics = ssl_loss(
                logits_fn,
                xb_l,
                task.y_pseudo[il],
                xb_u,
                task.ssl_cfg,
                draws,
                task.feature_mean,
                None if task.labeled_mask is None else task.labeled_mask[il],
                None if task.unlabeled_mask is None else task.unlabeled_mask[iu],
            )
        if commit:
            opt.step(torch.autograd.grad(loss, params))
    return {k: float(v) for k, v in metrics.items()}
