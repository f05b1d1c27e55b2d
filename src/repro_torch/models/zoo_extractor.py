"""Any ported zoo architecture as a VFL representation extractor f_k.

Counterpart of ``repro.models.zoo_extractor``. For sequence data each party
holds a token-range slice; its backbone encodes the slice and mean-pools the
final hidden states (in f32) into a ``rep_dim`` representation through
``rep_head`` (d, rep_dim). The backbone is the family's own module
(``model_zoo.make_backbone``): a decoder (MLA and vlm included), a Mamba2
stack or the hybrid. The module has the port's extractor interface:
``init_(generator)`` and ``forward(x)`` over (B, S) token ids, returning
(B, rep_dim). A split carries its tokens as float32 (``split_from_numpy``
casts every feature); ``forward`` casts them back to int32, exactly for ids
below 2²⁴.

:class:`ZooExtractorSpec` (kind ``zoo``) is what the protocol takes in
place of an ``ExtractorSpec``: ``run_one_shot(seed, split, [spec] * K,
[SSLConfig(modality="token")] * K, ...)`` trains the extractors by local
SSL, on the card through the RMSNorm kernel's forward and backward. A zoo
extractor never stacks with another (``sessions.module_spec`` describes
none), and ``save_artifact`` refuses its spec.

It passes tokens only, so an audio backbone, whose forward needs the
encoder's frame embeddings, is refused with a ``ValueError`` when the
extractor is made; the reference's extractor accepts one and fails with a
``KeyError`` at its first forward.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.model_zoo import build_model, make_backbone


class ZooExtractor(nn.Module):
    def __init__(self, cfg: ArchConfig, rep_dim: int = 64, device=None) -> None:
        super().__init__()
        if cfg.family == "audio":
            raise ValueError(
                f"{cfg.name}: the zoo extractor passes tokens only, and the audio family's "
                "forward needs frame embeddings (batch['embeds']) for its encoder"
            )
        self.rep_dim = rep_dim
        self.model = build_model(cfg)
        self.backbone = make_backbone(cfg, device)
        self.rep_head = nn.Parameter(torch.empty(cfg.d_model, rep_dim, device=device))

    def init_(self, generator: torch.Generator) -> "ZooExtractor":
        """The backbone by the zoo's init rules, then ``rep_head`` N(0, 0.02²)."""
        L.init_params(self.backbone, generator)
        with torch.no_grad():
            self.rep_head.normal_(0.0, 0.02, generator=generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.model.hidden_fn(self.backbone, {"tokens": x.to(torch.int32)})
        return h.float().mean(dim=1) @ self.rep_head


def make_zoo_extractor(cfg: ArchConfig, rep_dim: int = 64, device: DeviceLike = None):
    """The extractor over a zoo backbone, its parameters allocated (not yet
    drawn: see ``init_``) on ``device`` (``cuda`` unless the caller says
    ``cpu``); x is (B, S) token ids."""
    return ZooExtractor(cfg, rep_dim, resolve_device(device))


@dataclass(frozen=True)
class ZooExtractorSpec:
    """A party's zoo extractor, declared: the protocol builds it with
    :meth:`build` as it builds an ``ExtractorSpec``'s."""

    cfg: ArchConfig
    rep_dim: int = 64
    kind = "zoo"  # a class constant, not a field: the spec's kind is fixed

    def build(self, feature_shape: Sequence[int]) -> ZooExtractor:
        """The extractor (on the CPU; the client moves it) for (B, S) token
        rows; ``feature_shape`` is (S,), which the backbone does not fix."""
        del feature_shape
        return ZooExtractor(self.cfg, self.rep_dim)
