"""VFL server: label holder, partial gradients, classifier fits.

Counterpart of ``repro.core.server`` for steps ② and ⑥ and few-shot's aux
classifiers (②'). The server owns Y_o, θ_c and the θ_c^k and sends clients
only ∇_{H_o^k} L (and C) and p̂. A fit is a Python loop
over the numpy-seeded schedule of ``_fit_schedule`` (clip 5.0, SGD with
momentum 0.9). :func:`train_classifier_seeds` and
:func:`fit_aux_classifiers_seeds` are the folds' form: every entry draws its
heads and schedule seeds from its own CPU generator, in the single-seed
order, and the fits train stacked (``engine.batched.fit_sessions_batched``),
sharded over a batch mesh when one is given.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.core.ssl import cross_entropy
from repro_torch.data.loader import epoch_batches
from repro_torch.engine.batched import fit_sessions_batched
from repro_torch.engine.local_ssl import seed_from
from repro_torch.models.extractors import make_classifier
from repro_torch.optim import ClippedSGD


def concat_reps(reps: Sequence[torch.Tensor]) -> torch.Tensor:
    """h¹ ∘ … ∘ h^K (Eq. 2), party-major."""
    return torch.cat(list(reps), dim=-1)


@dataclass
class VFLServer:
    num_classes: int
    classifier: Optional[nn.Module] = None  # joint f_c
    aux_classifiers: List[nn.Module] = field(default_factory=list)  # f_c^k

    def _fresh_classifier(self, in_dim: int, generator: torch.Generator, device) -> nn.Module:
        return make_classifier(in_dim, self.num_classes).init_(generator).to(device)

    def _fit_fresh(
        self,
        h: torch.Tensor,
        labels: torch.Tensor,
        epochs: int,
        batch_size: int,
        learning_rate: float,
        generator: torch.Generator,
        seed0: Optional[int] = None,
    ) -> nn.Module:
        """A fresh head drawn from the CPU ``generator``, fitted on ``h``
        over the schedule of ``seed0`` (unless given, drawn next from the
        same generator)."""
        h = h.detach()
        clf, schedule = _fresh_fit(self, h, epochs, batch_size, generator, seed0)
        if schedule is not None:
            fit(clf, h, labels, schedule, learning_rate)
        return clf

    # ------------------------------------------------- step ②: partial grads
    def partial_gradients(
        self,
        reps: Sequence[torch.Tensor],
        labels: torch.Tensor,
        generator: Optional[torch.Generator] = None,
    ) -> List[torch.Tensor]:
        """∇_{H_o^k} mean CE(f_c(H¹∘…∘H^K), Y_o) for every k (Alg. 1 l.6),
        with θ_c initialised on first use from ``generator`` (the paper takes
        the partial gradients at the freshly initialised classifier)."""
        parts = [r.detach().requires_grad_(True) for r in reps]
        if self.classifier is None:
            if generator is None:
                raise ValueError("the classifier is not initialised: give a generator")
            self.classifier = self._fresh_classifier(
                sum(r.shape[-1] for r in reps), generator, reps[0].device
            )
        loss = cross_entropy(self.classifier(concat_reps(parts)), labels).mean()
        return list(torch.autograd.grad(loss, parts))

    # ------------------------------------------------ step ⑥: train classifier
    def train_classifier(
        self,
        reps: Sequence[torch.Tensor],
        labels: torch.Tensor,
        epochs: int = 50,
        batch_size: int = 32,
        learning_rate: float = 0.01,
        *,
        generator: torch.Generator,
        seed0: Optional[int] = None,
    ) -> "VFLServer":
        """Re-fit a freshly initialised f_c on the refreshed reps. The head's
        init and, unless given, the schedule seed come from the CPU
        ``generator``."""
        self.classifier = self._fit_fresh(
            concat_reps(reps), labels, epochs, batch_size, learning_rate, generator, seed0
        )
        return self

    # ----------------------------------- few-shot ②': aux classifiers f_c^k
    def fit_aux_classifiers(
        self,
        reps: Sequence[torch.Tensor],
        labels: torch.Tensor,
        epochs: int = 50,
        batch_size: int = 32,
        learning_rate: float = 0.01,
        *,
        generator: torch.Generator,
    ) -> "VFLServer":
        """θ_c^k ← argmin CE(f_c^k(H_o^k), Y_o) for every k (Alg. 2 l.2).
        Per party, in party order: the head's init, then the schedule seed,
        from the CPU ``generator`` (as the reference splits k0, k1 per
        party)."""
        self.aux_classifiers = [
            self._fit_fresh(h, labels, epochs, batch_size, learning_rate, generator) for h in reps
        ]
        return self

    def aux_logits_fn(self, k: int) -> Callable[[torch.Tensor], torch.Tensor]:
        return self.aux_classifiers[k]

    def joint_logits_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        return self.classifier

    @torch.no_grad()
    def predict_logits(self, reps: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.classifier(concat_reps(reps))


def fit_schedule(seed0: int, n: int, epochs: int, batch_size: int) -> Optional[np.ndarray]:
    """The fit's shuffled-epoch schedule (drop-remainder), (S, bs) int64, or
    None for a no-op fit. Equal ``seed0`` gives the reference's indices."""
    bs = min(batch_size, n)
    rows = [idx for e in range(epochs) for idx in epoch_batches(n, bs, seed0 + e)] if bs else []
    if not rows:
        return None
    return np.stack(rows).astype(np.int64)


def fit(
    model: nn.Module, x: torch.Tensor, y: torch.Tensor, schedule: np.ndarray, lr: float
) -> nn.Module:
    """Minibatch cross-entropy fit over ``schedule`` (in place), clip 5.0 +
    SGD with momentum 0.9."""
    params = list(model.parameters())
    opt = ClippedSGD(params, lr, momentum=0.9, max_norm=5.0)
    idx = torch.from_numpy(schedule).to(x.device)
    for i in range(idx.shape[0]):
        loss = cross_entropy(model(x[idx[i]]), y[idx[i]]).mean()
        opt.step(torch.autograd.grad(loss, params))
    return model


def _fresh_fit(
    server: VFLServer,
    h: torch.Tensor,
    epochs: int,
    batch_size: int,
    generator: torch.Generator,
    seed0: Optional[int] = None,
) -> tuple:
    """A fresh head over ``h`` and its schedule (None: a no-op fit): the
    head's init, then, unless ``seed0`` is given, the schedule seed, drawn
    from ``generator`` in that order."""
    clf = server._fresh_classifier(h.shape[-1], generator, h.device)
    seed0 = seed_from(generator) if seed0 is None else seed0
    return clf, fit_schedule(seed0, h.shape[0], epochs, batch_size)


def train_classifier_seeds(
    servers: Sequence[VFLServer],
    reps_per_seed: Sequence[Sequence[torch.Tensor]],
    labels_per_seed: Sequence[torch.Tensor],
    epochs: int = 50,
    batch_size: int = 32,
    learning_rate: float = 0.01,
    *,
    generators: Sequence[torch.Generator],
    mesh=None,
) -> None:
    """:meth:`VFLServer.train_classifier` for every entry of a fold: entry
    e's fresh f_c and schedule come from ``generators[e]``, and the fits
    train stacked (over ``mesh``'s slots, when given)."""
    hs = [concat_reps(reps).detach() for reps in reps_per_seed]
    fresh = [_fresh_fit(srv, h, epochs, batch_size, g) for srv, h, g in zip(servers, hs, generators)]
    fit_sessions_batched(
        [c for c, _ in fresh], hs, labels_per_seed, [s for _, s in fresh], learning_rate, mesh
    )
    for srv, (clf, _) in zip(servers, fresh):
        srv.classifier = clf


def fit_aux_classifiers_seeds(
    servers: Sequence[VFLServer],
    reps_per_seed: Sequence[Sequence[torch.Tensor]],
    labels_per_seed: Sequence[torch.Tensor],
    epochs: int = 50,
    batch_size: int = 32,
    learning_rate: float = 0.01,
    *,
    generators: Sequence[torch.Generator],
    mesh=None,
) -> None:
    """:meth:`VFLServer.fit_aux_classifiers` for every entry of a fold: entry
    e's f_c^k and schedules come from ``generators[e]`` party by party, and
    all S·C·K fits train stacked (one session a shape, over ``mesh``'s
    slots when given)."""
    models, xs, ys, scheds = [], [], [], []
    for srv, reps, labels, g in zip(servers, reps_per_seed, labels_per_seed, generators):
        fresh = [_fresh_fit(srv, h.detach(), epochs, batch_size, g) for h in reps]
        srv.aux_classifiers = [c for c, _ in fresh]
        models += srv.aux_classifiers
        xs += [h.detach() for h in reps]
        ys += [labels] * len(reps)
        scheds += [s for _, s in fresh]
    fit_sessions_batched(models, xs, ys, scheds, learning_rate, mesh)
