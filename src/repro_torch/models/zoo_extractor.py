"""Any ported zoo architecture as a VFL representation extractor f_k.

Counterpart of ``repro.models.zoo_extractor``. For sequence data each party
holds a token-range slice; its backbone encodes the slice and mean-pools the
final hidden states (in f32) into a ``rep_dim`` representation through
``rep_head`` (d, rep_dim). The backbone is the family's own module
(``model_zoo.make_backbone``): a decoder (MLA and vlm included), a Mamba2
stack or the hybrid. The module has the port's extractor interface:
``init_(generator)`` and ``forward(x)`` over (B, S) token ids, returning
(B, rep_dim).

It passes tokens only, so an audio backbone, whose forward needs the
encoder's frame embeddings, is refused with a ``ValueError`` when the
extractor is made; the reference's extractor accepts one and fails with a
``KeyError`` at its first forward.

On the card the forward norms through the RMSNorm kernel, which has no
backward yet: call it without grad there (training a zoo extractor on the
card waits for the training slice).
"""

from __future__ import annotations

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
