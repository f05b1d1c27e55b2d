"""Per-party representation extractors f_k and server classifiers f_c.

Counterpart of ``repro.models.extractors``. The reference builds pure
``(init, apply)`` pairs over parameter pytrees; here each model is an
``nn.Module`` and :mod:`repro_torch.bridge` carries the reference's
parameters into it under the reference's key names.

Public inputs keep the reference's layout: images are NHWC
``(N, H, W, C)``. The CNN moves to NCHW once at its entry, because that is
what ``F.conv2d`` takes, and pools back to ``(N, C)`` at its exit.

Parity hazards the CNN reproduces on purpose:

* XLA ``"SAME"`` padding: a stride-2 3×3 conv over an even size pads
  ``(0, 1)``, not ``(1, 1)`` (:func:`same_pads`);
* GroupNorm with ``gcd(8, C)`` groups, population variance, eps 1e-5;
* the strided identity shortcut ``h[:, ::2, ::2]`` when a stage keeps its
  width.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` split of the padding along one spatial axis."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv_same(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """``conv`` (no padding of its own) over NCHW ``x`` with XLA SAME pads."""
    kh, kw = conv.kernel_size
    sh, sw = conv.stride
    top, bottom = same_pads(x.shape[2], kh, sh)
    left, right = same_pads(x.shape[3], kw, sw)
    return conv(F.pad(x, (left, right, top, bottom)))


def _he_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """He-normal ``weight``, drawn on the generator's device."""
    with torch.no_grad():
        draw = torch.randn(
            weight.shape, generator=generator, dtype=torch.float32, device=generator.device
        )
        weight.copy_(draw * math.sqrt(2.0 / fan_in))


def _group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(math.gcd(8, channels), channels, eps=1e-5)


class Dense(nn.Module):
    """``Linear`` layers with ReLU between them (MLP extractor, classifier)."""

    def __init__(self, dims: Sequence[int]) -> None:
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(dims[i], dims[i + 1]) for i in range(len(dims) - 1))

    def init_(self, generator: torch.Generator) -> "Dense":
        """He-normal weights, zero biases (the reference's ``_he`` init)."""
        for layer in self.layers:
            _he_(layer.weight, layer.in_features, generator)
            nn.init.zeros_(layer.bias)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class ResBlock(nn.Module):
    """Pre-activation residual block of the WideResNet-style CNN."""

    def __init__(self, c_in: int, width: int, stride: int) -> None:
        super().__init__()
        self.stride = stride
        self.gn1 = _group_norm(c_in)
        self.conv1 = nn.Conv2d(c_in, width, 3, stride=stride, bias=False)
        self.gn2 = _group_norm(width)
        self.conv2 = nn.Conv2d(width, width, 3, bias=False)
        self.proj = None
        if c_in != width:
            self.proj = nn.Conv2d(c_in, width, 1, stride=stride, bias=False)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.gn1(h))
        if self.proj is not None:
            # contiguous: the CPU build's oneDNN backward of a strided 1x1
            # conv over a channels-last input crashes (torch 2.13 CPU)
            shortcut = _conv_same(y.contiguous(), self.proj)
        elif self.stride != 1:
            shortcut = h[:, :, :: self.stride, :: self.stride]
        else:
            shortcut = h
        y = F.relu(self.gn2(_conv_same(y, self.conv1)))
        return shortcut + _conv_same(y, self.conv2)


class CNNExtractor(nn.Module):
    """WideResNet-style residual CNN over NHWC images → ``(N, rep_dim)``."""

    def __init__(
        self,
        in_channels: int,
        rep_dim: int = 128,
        widths: Sequence[int] = (32, 64, 128),
        blocks_per_stage: int = 2,
    ) -> None:
        super().__init__()
        self.blocks_per_stage = blocks_per_stage
        self.stem = nn.Conv2d(in_channels, widths[0], 3, bias=False)
        blocks: List[ResBlock] = []
        prev = widths[0]
        for s, width in enumerate(widths):
            for b in range(blocks_per_stage):
                blocks.append(ResBlock(prev, width, 2 if (b == 0 and s > 0) else 1))
                prev = width
        self.blocks = nn.ModuleList(blocks)
        self.out_gn = _group_norm(prev)
        self.head = nn.Linear(prev, rep_dim)

    def init_(self, generator: torch.Generator) -> "CNNExtractor":
        """He-normal convs and head, unit/zero GroupNorm affine, zero bias."""
        for conv in self.modules():
            if isinstance(conv, nn.Conv2d):
                k = conv.kernel_size[0] * conv.kernel_size[1]
                _he_(conv.weight, k * conv.in_channels, generator)
        for gn in self.modules():
            if isinstance(gn, nn.GroupNorm):
                nn.init.ones_(gn.weight)
                nn.init.zeros_(gn.bias)
        _he_(self.head.weight, self.head.in_features, generator)
        nn.init.zeros_(self.head.bias)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _conv_same(x.permute(0, 3, 1, 2), self.stem)
        for block in self.blocks:
            h = block(h)
        h = F.relu(self.out_gn(h)).mean(dim=(2, 3))  # global average pool
        return self.head(h)


def make_mlp_extractor(in_dim: int, rep_dim: int = 64, hidden: Sequence[int] = (128, 128)) -> Dense:
    """Tabular party extractor (the reference's ``make_mlp_extractor``)."""
    return Dense((in_dim, *hidden, rep_dim))


def make_cnn_extractor(
    in_channels: int,
    rep_dim: int = 128,
    widths: Sequence[int] = (32, 64, 128),
    blocks_per_stage: int = 2,
) -> CNNExtractor:
    """Image party extractor (the reference's ``make_cnn_extractor``)."""
    return CNNExtractor(in_channels, rep_dim, widths, blocks_per_stage)


def make_classifier(in_dim: int, num_classes: int, hidden: Sequence[int] = ()) -> Dense:
    """Server head f_c over the party-major concatenated representations."""
    return Dense((in_dim, *hidden, num_classes))
