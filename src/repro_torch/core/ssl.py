"""Local semi-supervised learning (step ④): FixMatch and FixMatch-tab.

Counterpart of ``repro.core.ssl``. One minibatch of Eq. (4),

    l_ssl = l_s(X_o, Ŷ_o) + λ_u · l_u(X_u),
    l_u   = 1[max q > τ] · CE(p(y | A(x_u)), argmax q),  q = p(y | α(x_u)),

with masked means ``Σ ce·m / max(Σ m, 1)`` wherever a validity mask is
given. Three modalities: ``"image"`` (FixMatch's flip / translate weak view
and cutout / jitter / noise strong view), ``"tabular"`` (FixMatch-tab,
Eq. 5-6) and ``"token"`` (token masking to id 0 at r_m, the strong view
masking more: a zoo backbone as the extractor; it reads no feature mean). The FixMatch targets q are computed under ``torch.no_grad()``. The
augmentation draws arrive as an :class:`SSLDraws` argument
(:func:`draw_ssl` makes them from a ``torch.Generator``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import augment


@dataclass(frozen=True)
class SSLConfig:
    modality: str = "image"  # "image" | "tabular" | "token"
    lambda_u: float = 1.0  # λ_u in Eq. (4)
    confidence_threshold: float = 0.95  # τ (FixMatch default)
    mask_ratio: float = 0.2  # r_m (paper: 0.2)
    sigma: float = 0.1  # σ (paper: 0.1)
    max_shift: int = 4
    cutout_size: int = 8


@dataclass
class SSLDraws:
    """The random draws of one SSL minibatch.

    Image: ``labeled`` is an :class:`~augment.ImageWeakDraws`, ``unlabeled``
    a (weak, strong) pair of image draws. Tabular: ``labeled`` is the
    weak view's keep-mask and ``unlabeled`` a :class:`~augment.TabPairDraws`.
    Token: ``labeled`` is the weak view's keep-mask and ``unlabeled`` a
    :class:`~augment.TokenPairDraws`."""

    labeled: Any
    unlabeled: Any


def draw_ssl(
    gen: torch.Generator,
    cfg: SSLConfig,
    labeled_shape: Sequence[int],
    unlabeled_shape: Sequence[int],
    device: torch.device,
) -> SSLDraws:
    if cfg.modality == "image":
        labeled = augment.draw_image_weak(gen, labeled_shape[0], cfg.max_shift, device)
        weak = augment.draw_image_weak(gen, unlabeled_shape[0], cfg.max_shift, device)
        strong = augment.draw_image_strong(gen, unlabeled_shape, cfg.max_shift, device)
        return SSLDraws(labeled, (weak, strong))
    if cfg.modality == "tabular":
        keep = augment.draw_tab_keep(gen, labeled_shape, cfg.mask_ratio, device)
        return SSLDraws(keep, augment.draw_tab_pair(gen, unlabeled_shape, cfg.mask_ratio, device))
    if cfg.modality == "token":
        keep = augment.draw_token_keep(gen, labeled_shape, cfg.mask_ratio, device)
        return SSLDraws(keep, augment.draw_token_pair(gen, unlabeled_shape, cfg.mask_ratio, device))
    raise ValueError(f"unsupported SSL modality {cfg.modality!r}")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row −log softmax(logits)[label]."""
    return F.cross_entropy(logits, labels.long(), reduction="none")


def augment_views(
    x_labeled: torch.Tensor,
    x_unlabeled: torch.Tensor,
    cfg: SSLConfig,
    draws: SSLDraws,
    feature_mean: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(labeled weak view, unlabeled weak view, unlabeled strong view)."""
    if cfg.modality == "image":
        weak, strong = draws.unlabeled
        return (
            augment.weak_augment_image(x_labeled, draws.labeled),
            augment.weak_augment_image(x_unlabeled, weak),
            augment.strong_augment_image(x_unlabeled, strong, cfg.cutout_size),
        )
    if cfg.modality == "tabular":
        if feature_mean is None:
            raise ValueError("tabular SSL needs the party's feature mean x̄")
        xl = augment.weak_augment_tab(x_labeled, feature_mean, draws.labeled)
        weak_u, strong_u = augment.tab_augment_pair(
            x_unlabeled, feature_mean, draws.unlabeled, cfg.sigma
        )
        return xl, weak_u, strong_u
    if cfg.modality == "token":
        weak_u, strong_u = augment.token_augment_pair(x_unlabeled, draws.unlabeled)
        return augment.weak_augment_tokens(x_labeled, draws.labeled), weak_u, strong_u
    raise ValueError(f"unsupported SSL modality {cfg.modality!r}")


def _masked_mean(values: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return values.mean()
    m = mask.to(values.dtype)
    return (values * m).sum() / torch.clamp(m.sum(), min=1.0)


def ssl_loss(
    logits_fn: Callable[[torch.Tensor], torch.Tensor],
    x_labeled: torch.Tensor,
    y_labeled: torch.Tensor,
    x_unlabeled: torch.Tensor,
    cfg: SSLConfig,
    draws: SSLDraws,
    feature_mean: Optional[torch.Tensor] = None,
    labeled_mask: Optional[torch.Tensor] = None,
    unlabeled_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One minibatch of Eq. (4). Returns (loss, metrics); the metrics are
    detached tensors (reading them would wait for the device)."""
    xl, weak_u, strong_u = augment_views(x_labeled, x_unlabeled, cfg, draws, feature_mean)
    l_s = _masked_mean(cross_entropy(logits_fn(xl), y_labeled), labeled_mask)

    with torch.no_grad():
        q = torch.softmax(logits_fn(weak_u), dim=-1)
        conf, pseudo = q.max(dim=-1)
        mask = (conf > cfg.confidence_threshold).float()
        if unlabeled_mask is not None:
            mask = mask * unlabeled_mask.float()
    ce_u = cross_entropy(logits_fn(strong_u), pseudo)
    l_u = (ce_u * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    loss = l_s + cfg.lambda_u * l_u
    # an empty unlabeled batch (a full-overlap party) reports rate 0
    metrics = {
        "loss": loss.detach(),
        "l_s": l_s.detach(),
        "l_u": l_u.detach(),
        "pseudo_mask_rate": mask.sum() / max(mask.shape[0], 1),
    }
    return loss, metrics
