"""Shuffled minibatch indices, seeded through numpy.

Copies of ``repro.data.loader.epoch_batches`` and ``batch_iterator``: the
same ``RandomState`` draws give the same index arrays, so the port's
training schedules equal the reference's bit for bit once both are given the
same integer seed.
"""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

import numpy as np
import torch


def epoch_batches(
    n: int, batch_size: int, seed: int, drop_remainder: bool = True
) -> Iterator[np.ndarray]:
    """Yield index arrays for one shuffled epoch."""
    perm = np.random.RandomState(seed).permutation(n)
    end = (n // batch_size) * batch_size if drop_remainder else n
    for s in range(0, end, batch_size):
        yield perm[s : s + batch_size]


def batch_iterator(
    arrays: Sequence[torch.Tensor],
    batch_size: int,
    epochs: int,
    seed: int = 0,
    drop_remainder: bool = True,
) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Shuffled minibatches over aligned arrays for ``epochs`` epochs, epoch
    e shuffled by :func:`epoch_batches` with seed ``seed + e``."""
    n = arrays[0].shape[0]
    for e in range(epochs):
        for idx in epoch_batches(n, batch_size, seed + e, drop_remainder):
            yield tuple(a[torch.from_numpy(idx).to(a.device)] for a in arrays)
