"""Vertical (feature-space) partitioning for VFL, over tensors.

Counterpart of ``repro.data.vertical`` (paper §5.1): images split into
vertical strips along W or a grid of patches, tabular features into
contiguous blocks, and ``make_vfl_partition`` samples N_o aligned rows and
deals the rest out as party-private pools, optionally padding the aligned
block to a fixed capacity under a validity mask. The row indices come from
the same numpy ``RandomState`` as the reference's, so equal inputs give
equal splits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclass
class VerticalSplit:
    """The VFL view of one dataset (the reference's fields).

    ``aligned[k]`` are party k's features of the N_o overlapping rows,
    row-aligned across parties; ``labels`` (N_o,) stay with the server;
    ``unaligned[k]`` is party k's private pool; ``test_aligned`` /
    ``test_labels`` the held-out aligned split. ``unaligned_labels`` serve
    diagnostics only. ``aligned_mask`` (float32, one per aligned row) marks
    the real overlap rows (1) and the cyclic padding (0) of a split built
    with an ``overlap_capacity``; None means every aligned row is real."""

    aligned: List[torch.Tensor]
    labels: torch.Tensor
    unaligned: List[torch.Tensor]
    test_aligned: List[torch.Tensor]
    test_labels: torch.Tensor
    num_classes: int
    unaligned_labels: Optional[List[torch.Tensor]] = None
    aligned_mask: Optional[torch.Tensor] = None


def split_image_halves(x: torch.Tensor, num_parties: int = 2) -> List[torch.Tensor]:
    """Split (N, H, W, C) images into vertical strips along W (paper: halves)."""
    w = x.shape[2]
    widths = [w // num_parties] * num_parties
    widths[-1] += w - sum(widths)
    return list(torch.split(x, widths, dim=2))


def split_image_patches(x: torch.Tensor, grid: Sequence[int] = (2, 2)) -> List[torch.Tensor]:
    """Split (N, H, W, C) images into a ``grid = (rows, cols)`` of patches,
    row by row: K = rows·cols parties each hold one (the last row and
    column take the remainder). The patches are views of ``x``."""
    rows, cols = grid
    h, w = x.shape[1], x.shape[2]
    hs = [h // rows] * rows
    hs[-1] += h - sum(hs)
    ws = [w // cols] * cols
    ws[-1] += w - sum(ws)
    return [p for strip in torch.split(x, hs, dim=1) for p in torch.split(strip, ws, dim=2)]


def split_features(x: torch.Tensor, sizes: Sequence[int]) -> List[torch.Tensor]:
    """Split an (N, D) feature matrix into contiguous blocks of given sizes."""
    if sum(sizes) != x.shape[1]:
        raise ValueError(f"feature sizes {tuple(sizes)} do not sum to {x.shape[1]}")
    return list(torch.split(x, list(sizes), dim=1))


def _splitter(
    x: torch.Tensor,
    num_parties: int,
    feature_sizes: Optional[Sequence[int]],
    image_grid: Optional[Sequence[int]] = None,
):
    if x.dim() == 4:
        if image_grid is not None:
            if image_grid[0] * image_grid[1] != num_parties:
                raise ValueError(f"image grid {tuple(image_grid)} is not {num_parties} parties")
            return lambda a: split_image_patches(a, image_grid)
        return lambda a: split_image_halves(a, num_parties)
    if feature_sizes is None:
        base = x.shape[1] // num_parties
        feature_sizes = [base] * num_parties
        feature_sizes[-1] += x.shape[1] - base * num_parties
    return lambda a: split_features(a, feature_sizes)


def make_vfl_partition(
    x: torch.Tensor,
    y: torch.Tensor,
    overlap_size: int,
    num_parties: int = 2,
    test_fraction: float = 0.2,
    feature_sizes: Optional[Sequence[int]] = None,
    seed: int = 0,
    num_classes: Optional[int] = None,
    image_grid: Optional[Sequence[int]] = None,
    overlap_capacity: Optional[int] = None,
) -> VerticalSplit:
    """Sample N_o aligned rows; split the rest evenly into private pools.

    The row order is ``RandomState(seed).permutation(n)``, the test rows
    first, as the reference's. With ``overlap_capacity`` the aligned block
    always holds ``capacity`` rows: the N_o real rows, then cyclic
    duplicates of them, with ``aligned_mask`` marking the real ones; the
    pools start after the full capacity, so members of one family that
    differ only in N_o get the same pools. N_o equal to every training row
    leaves the pools empty. The parts are contiguous copies on ``x``'s
    device."""
    n = x.shape[0]
    perm = np.random.RandomState(seed).permutation(n)
    n_test = int(n * test_fraction)
    rest = perm[n_test:]
    if overlap_size > len(rest):
        raise ValueError(f"not enough rows ({len(rest)}) for an overlap of {overlap_size}")
    aligned_mask = None
    if overlap_capacity is None:
        aligned = rest[:overlap_size]
        pool = rest[overlap_size:]
    else:
        capacity = int(overlap_capacity)
        if not overlap_size <= capacity <= len(rest):
            raise ValueError(
                f"capacity {capacity} must lie between the overlap {overlap_size} and the "
                f"{len(rest)} training rows"
            )
        pad = capacity - overlap_size
        aligned = np.concatenate([rest[:overlap_size], rest[np.arange(pad) % overlap_size]])
        aligned_mask = (torch.arange(capacity, device=x.device) < overlap_size).float()
        pool = rest[capacity:]
    per = len(pool) // num_parties

    def rows(idx: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(idx, dtype=torch.long, device=x.device)

    split = _splitter(x, num_parties, feature_sizes, image_grid)
    aligned_idx, test_idx = rows(aligned), rows(perm[:n_test])
    party_idx = [rows(pool[k * per : (k + 1) * per]) for k in range(num_parties)]
    return VerticalSplit(
        aligned=[p.contiguous() for p in split(x[aligned_idx])],
        labels=y[aligned_idx],
        unaligned=[split(x[idx])[k].contiguous() for k, idx in enumerate(party_idx)],
        test_aligned=[p.contiguous() for p in split(x[test_idx])],
        test_labels=y[test_idx],
        num_classes=int(y.max()) + 1 if num_classes is None else num_classes,
        unaligned_labels=[y[idx] for idx in party_idx],
        aligned_mask=aligned_mask,
    )


def split_from_numpy(split: Any, device: DeviceLike = None) -> VerticalSplit:
    """The port's :class:`VerticalSplit` of a reference split, read field by
    field through ``numpy.asarray`` (features float32, labels int64) and
    placed on ``device``; a padded split's ``aligned_mask`` comes along as
    float32."""
    dev = resolve_device(device)

    def feats(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    def labels(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.int64)).to(dev)

    pool_labels = split.unaligned_labels
    mask = getattr(split, "aligned_mask", None)
    return VerticalSplit(
        aligned=[feats(a) for a in split.aligned],
        labels=labels(split.labels),
        unaligned=[feats(a) for a in split.unaligned],
        test_aligned=[feats(a) for a in split.test_aligned],
        test_labels=labels(split.test_labels),
        num_classes=int(split.num_classes),
        unaligned_labels=None if pool_labels is None else [labels(a) for a in pool_labels],
        aligned_mask=None if mask is None else feats(mask),
    )
