"""VFL client: representation extractor + local head, trained by SSL.

Counterpart of ``repro.core.client``. The client never sees true labels: its
local model (extractor f_k → head) trains by semi-supervised learning on the
gradient-cluster pseudo-labels (Alg. 1 l.28-34). The modules are the port's
``nn.Module``s and train in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
from torch import nn

from repro_torch.checkpoint.artifact import ExtractorSpec
from repro_torch.core.ssl import SSLConfig
from repro_torch.engine.local_ssl import PartyTask
from repro_torch.models.extractors import make_classifier


@dataclass
class VFLClient:
    index: int
    extractor: nn.Module
    head: nn.Module
    ssl_cfg: SSLConfig
    feature_mean: Optional[torch.Tensor]  # x̄ for FixMatch-tab

    @torch.no_grad()
    def extract(self, x: torch.Tensor) -> torch.Tensor:
        """The representation a client uploads (no autograd graph)."""
        return self.extractor(x)

    @torch.no_grad()
    def local_logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.extractor(x))

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return self.local_logits(x).argmax(-1)


def make_client(
    index: int,
    spec: ExtractorSpec,
    feature_shape: Sequence[int],
    num_classes: int,
    ssl_cfg: SSLConfig,
    generator: torch.Generator,
    device: torch.device,
    local_data_for_mean: Optional[torch.Tensor] = None,
) -> VFLClient:
    """Build the extractor of ``spec`` for inputs of trailing shape
    ``feature_shape`` and a linear head, He-normal from the CPU
    ``generator``, on ``device``. x̄ is the mean of the party's local rows,
    and None for an empty pool (whose mean would be NaN) or non-tabular
    data."""
    extractor = spec.build(feature_shape).init_(generator).to(device)
    head = make_classifier(spec.rep_dim, num_classes).init_(generator).to(device)
    fm = None
    if (
        local_data_for_mean is not None
        and local_data_for_mean.dim() == 2
        and local_data_for_mean.shape[0] > 0
    ):
        fm = local_data_for_mean.float().mean(0)
    return VFLClient(index, extractor, head, ssl_cfg, fm)


def ssl_task_for(
    client: VFLClient,
    x_labeled: torch.Tensor,
    y_pseudo: torch.Tensor,
    x_unlabeled: torch.Tensor,
    labeled_mask: Optional[torch.Tensor] = None,
    unlabeled_mask: Optional[torch.Tensor] = None,
    step_valid: Optional[torch.Tensor] = None,
) -> PartyTask:
    """This client's local-SSL problem, for the engine."""
    return PartyTask(
        extractor=client.extractor,
        head=client.head,
        ssl_cfg=client.ssl_cfg,
        x_labeled=x_labeled,
        y_pseudo=y_pseudo,
        x_unlabeled=x_unlabeled,
        feature_mean=client.feature_mean,
        labeled_mask=labeled_mask,
        unlabeled_mask=unlabeled_mask,
        step_valid=step_valid,
    )
