"""Shuffled minibatch indices, seeded through numpy.

A copy of ``repro.data.loader.epoch_batches``: the same ``RandomState`` draws
give the same index arrays, so the port's training schedules equal the
reference's bit for bit once both are given the same integer seed.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


def epoch_batches(
    n: int, batch_size: int, seed: int, drop_remainder: bool = True
) -> Iterator[np.ndarray]:
    """Yield index arrays for one shuffled epoch."""
    perm = np.random.RandomState(seed).permutation(n)
    end = (n // batch_size) * batch_size if drop_remainder else n
    for s in range(0, end, batch_size):
        yield perm[s : s + batch_size]
