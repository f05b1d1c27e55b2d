"""Weak/strong augmentations for local SSL, with the draws as arguments.

Counterpart of ``repro.core.augment``, NHWC images and flat tabular rows:

* image weak α(x): horizontal flip (axis W), then an integer translation as
  ``roll`` followed by zeroing the wrapped edge;
* image strong A(x): α(x), cutout (keeps ``|r−cy| > s//2 or |c−cx| > s//2``),
  a per-sample per-channel affine colour jitter, Gaussian noise;
* tabular FixMatch-tab (Eq. 5-6): ``m ⊗ x + (1−m) ⊗ x̄`` with one Bernoulli
  keep-mask shared by the weak and strong views, plus ``σ·n`` on the strong;
* tokens, FixMatch-tab generalised to token sequences: the weak view masks
  each token to ``mask_id`` 0 with probability r_m; the strong view masks
  where the weak one does and also where a second Bernoulli(1 − 0.4) draw
  fails. The views keep the input's dtype (a split's tokens are float32).

Every random choice (flips, shifts, cutout centres, jitter, noise, masks)
is an argument, so a test can hand in the reference's own draws; the
``draw_*`` functions make them from a ``torch.Generator`` for training.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import torch


# ------------------------------------------------------------------ draws --
@dataclass
class ImageWeakDraws:
    flip: torch.Tensor  # (n,) bool
    dy: torch.Tensor  # (n,) int64 in [-max_shift, max_shift]
    dx: torch.Tensor  # (n,) int64 in [-max_shift, max_shift]


@dataclass
class ImageStrongDraws:
    weak: ImageWeakDraws
    cy: torch.Tensor  # (n,) int64 in [0, H)
    cx: torch.Tensor  # (n,) int64 in [0, W)
    gain: torch.Tensor  # (n, 1, 1, C) uniform in [-1, 1)
    bias: torch.Tensor  # (n, 1, 1, C) uniform in [-1, 1)
    noise: torch.Tensor  # (n, H, W, C) standard normal


@dataclass
class TabPairDraws:
    keep: torch.Tensor  # (n, d) bool: m_i = 1 keeps x_i
    noise: torch.Tensor  # (n, d) standard normal


@dataclass
class TokenPairDraws:
    keep_weak: torch.Tensor  # (n, S) bool: the weak view keeps the token
    keep_strong: torch.Tensor  # (n, S) bool: keep_weak & a second Bernoulli(1 − 0.4)


def draw_image_weak(
    gen: torch.Generator, n: int, max_shift: int, device: torch.device
) -> ImageWeakDraws:
    def shift() -> torch.Tensor:
        return torch.randint(-max_shift, max_shift + 1, (n,), generator=gen, device=device)

    flip = torch.rand(n, generator=gen, device=device) < 0.5
    return ImageWeakDraws(flip=flip, dy=shift(), dx=shift())


def draw_image_strong(
    gen: torch.Generator, shape: Sequence[int], max_shift: int, device: torch.device
) -> ImageStrongDraws:
    n, h, w, c = shape

    def uniform() -> torch.Tensor:
        return 2.0 * torch.rand(n, 1, 1, c, generator=gen, device=device) - 1.0

    weak = draw_image_weak(gen, n, max_shift, device)
    cy = torch.randint(0, h, (n,), generator=gen, device=device)
    cx = torch.randint(0, w, (n,), generator=gen, device=device)
    gain, bias = uniform(), uniform()
    noise = torch.randn(n, h, w, c, generator=gen, device=device)
    return ImageStrongDraws(weak, cy, cx, gain, bias, noise)


def draw_tab_keep(
    gen: torch.Generator, shape: Sequence[int], mask_ratio: float, device: torch.device
) -> torch.Tensor:
    return torch.rand(tuple(shape), generator=gen, device=device) < 1.0 - mask_ratio


def draw_tab_pair(
    gen: torch.Generator, shape: Sequence[int], mask_ratio: float, device: torch.device
) -> TabPairDraws:
    keep = draw_tab_keep(gen, shape, mask_ratio, device)
    return TabPairDraws(keep, torch.randn(tuple(shape), generator=gen, device=device))


def draw_token_keep(
    gen: torch.Generator, shape: Sequence[int], mask_ratio: float, device: torch.device
) -> torch.Tensor:
    """The weak token view's keep-mask: Bernoulli(1 − r_m) per token."""
    return draw_tab_keep(gen, shape, mask_ratio, device)


def draw_token_pair(
    gen: torch.Generator,
    shape: Sequence[int],
    mask_ratio: float,
    device: torch.device,
    strong_ratio: float = 0.4,
) -> TokenPairDraws:
    keep_w = draw_token_keep(gen, shape, mask_ratio, device)
    keep_s = keep_w & (torch.rand(tuple(shape), generator=gen, device=device) < 1.0 - strong_ratio)
    return TokenPairDraws(keep_w, keep_s)


# ------------------------------------------------------------------ images --
def rand_flip(x: torch.Tensor, flip: torch.Tensor) -> torch.Tensor:
    """Flip the rows with ``flip`` along W (NHWC axis 2)."""
    return torch.where(flip[:, None, None, None], x.flip(2), x)


def rand_translate(x: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """Per-image ``roll`` by (dy, dx) over (H, W), then zero the rows and
    columns that wrapped around (crop-with-pad)."""
    n, h, w, _ = x.shape
    rows = torch.arange(h, device=x.device)
    cols = torch.arange(w, device=x.device)
    src_r = (rows[None, :] - dy[:, None]) % h  # roll: out[i] = in[(i - s) mod h]
    src_c = (cols[None, :] - dx[:, None]) % w
    batch = torch.arange(n, device=x.device)[:, None, None]
    rolled = x[batch, src_r[:, :, None], src_c[:, None, :]]
    row_ok = torch.where(dy[:, None] >= 0, rows >= dy[:, None], rows < h + dy[:, None])
    col_ok = torch.where(dx[:, None] >= 0, cols >= dx[:, None], cols < w + dx[:, None])
    mask = row_ok[:, :, None] & col_ok[:, None, :]
    return rolled * mask[..., None]


def cutout(x: torch.Tensor, cy: torch.Tensor, cx: torch.Tensor, size: int = 8) -> torch.Tensor:
    n, h, w, _ = x.shape
    rows = torch.arange(h, device=x.device)[None, :, None]
    cols = torch.arange(w, device=x.device)[None, None, :]
    keep = ((rows - cy[:, None, None]).abs() > size // 2) | (
        (cols - cx[:, None, None]).abs() > size // 2
    )
    return x * keep[..., None]


def weak_augment_image(x: torch.Tensor, d: ImageWeakDraws) -> torch.Tensor:
    return rand_translate(rand_flip(x, d.flip), d.dy, d.dx)


def strong_augment_image(
    x: torch.Tensor,
    d: ImageStrongDraws,
    cutout_size: int = 8,
    jitter: float = 0.25,
    noise: float = 0.1,
) -> torch.Tensor:
    y = weak_augment_image(x, d.weak)
    y = cutout(y, d.cy, d.cx, cutout_size)
    y = y * (1.0 + jitter * d.gain) + jitter * d.bias
    return y + noise * d.noise


# ----------------------------------------------------------------- tabular --
def tab_augment_pair(
    x: torch.Tensor, feature_mean: torch.Tensor, d: TabPairDraws, sigma: float = 0.1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """FixMatch-tab (Eq. 5-6): (weak, strong) sharing one mask."""
    weak = torch.where(d.keep, x, feature_mean)
    return weak, weak + sigma * d.noise


def weak_augment_tab(
    x: torch.Tensor, feature_mean: torch.Tensor, keep: torch.Tensor
) -> torch.Tensor:
    return torch.where(keep, x, feature_mean)


# ------------------------------------------------------------------ tokens --
def token_augment_pair(
    x: torch.Tensor, d: TokenPairDraws, mask_id: int = 0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weak, strong) token views of x (B, S), ``mask_id`` where masked."""
    fill = torch.full((), mask_id, dtype=x.dtype, device=x.device)
    return torch.where(d.keep_weak, x, fill), torch.where(d.keep_strong, x, fill)


def weak_augment_tokens(x: torch.Tensor, keep: torch.Tensor, mask_id: int = 0) -> torch.Tensor:
    return torch.where(keep, x, torch.full((), mask_id, dtype=x.dtype, device=x.device))
