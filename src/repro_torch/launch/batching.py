"""The fixed-shape serving batcher.

Counterpart of ``repro.launch.batching``. Ragged requests are padded to the
engine's ``capacity`` and carry a boolean row mask, so every forward sees
one batch shape. PyTorch runs eagerly, so the fixed shape no longer avoids
recompiles; it keeps the step's work and memory constant per batch and
leaves the shape fixed for a later CUDA-graph capture.
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class MaskedBatch(NamedTuple):
    """Per-party feature blocks padded to capacity on dim 0, plus the mask
    separating real rows (True) from padding."""

    xs: Tuple[torch.Tensor, ...]  # K tensors, each (capacity, ...)
    mask: torch.Tensor  # (capacity,) bool
    n: int  # number of valid rows


def pad_to_capacity(xs: Sequence[torch.Tensor], capacity: int) -> MaskedBatch:
    """Zero-pad every per-party block of an ``n``-row request to ``capacity``
    rows (the mask, not the values, carries validity)."""
    n = int(xs[0].shape[0])
    if n > capacity:
        raise ValueError(
            f"request of {n} rows exceeds capacity {capacity}; split it with chunk_requests first"
        )
    for x in xs[1:]:
        if int(x.shape[0]) != n:
            raise ValueError("every party block must carry the same rows")
    padded = tuple(F.pad(x, (0, 0) * (x.dim() - 1) + (0, capacity - n)) for x in xs)
    mask = torch.arange(capacity, device=xs[0].device) < n
    return MaskedBatch(padded, mask, n)


def chunk_requests(xs: Sequence[torch.Tensor], capacity: int) -> List[Tuple[torch.Tensor, ...]]:
    """Split a request into capacity-sized chunks (the last one short)."""
    n = int(xs[0].shape[0])
    return [tuple(x[i : i + capacity] for x in xs) for i in range(0, max(n, 1), capacity)]


def percentile(samples: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (linear interpolation, numpy semantics)."""
    return float(np.percentile(np.asarray(samples, np.float64), q))


class LatencyRecorder:
    """Wall-clock samples → p50/p99/throughput summary."""

    def __init__(self) -> None:
        self.samples_s: List[float] = []
        self.rows = 0

    def record(self, seconds: float, rows: int) -> None:
        self.samples_s.append(float(seconds))
        self.rows += int(rows)

    def summary(self) -> dict:
        if not self.samples_s:
            raise ValueError("no latency samples recorded")
        total = sum(self.samples_s)
        return {
            "batches": len(self.samples_s),
            "rows": self.rows,
            "p50_ms": percentile(self.samples_s, 50) * 1e3,
            "p99_ms": percentile(self.samples_s, 99) * 1e3,
            "mean_ms": total / len(self.samples_s) * 1e3,
            "rows_per_s": self.rows / total if total > 0 else float("inf"),
        }


def _wait(t: torch.Tensor) -> None:
    """Block until ``t`` is computed: CUDA launches return before the card
    has run them."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def drive(
    step: Callable[[MaskedBatch], torch.Tensor],
    requests: Sequence[Sequence[torch.Tensor]],
    capacity: int,
    warmup: int = 1,
) -> Tuple[List[torch.Tensor], LatencyRecorder]:
    """Run a request stream through a fixed-shape step: chunk → pad → call,
    timing each step (to its end on the card) after ``warmup`` untimed
    calls. Returns (per-request outputs of the valid rows, recorder)."""
    rec = LatencyRecorder()
    if requests and warmup > 0:
        first = pad_to_capacity(chunk_requests(requests[0], capacity)[0], capacity)
        for _ in range(warmup):
            _wait(step(first))
    outs: List[torch.Tensor] = []
    for req in requests:
        parts = []
        for chunk in chunk_requests(req, capacity):
            batch = pad_to_capacity(chunk, capacity)
            _wait(batch.xs[0])  # padding is not part of the step's time
            t0 = time.perf_counter()
            out = step(batch)
            _wait(out)
            rec.record(time.perf_counter() - t0, batch.n)
            parts.append(out[: batch.n])
        outs.append(torch.cat(parts, dim=0) if len(parts) > 1 else parts[0])
    return outs, rec
