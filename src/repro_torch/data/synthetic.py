"""Structured synthetic datasets, drawn from a seeded ``torch.Generator``.

Counterparts of ``repro.data.synthetic.make_tabular_credit`` (the
UCI-credit-like ``credit/*`` task), ``make_cluster_tabular`` (the hardened
``hard/*`` task), ``make_image_classification`` (CIFAR-like class
templates plus noise), ``make_token_stream`` (the zoo's language-model
batches) and ``make_sequence_classification`` (token sequences whose class
is a topic: the zoo backbone as a VFL extractor), with the same formulas
and defaults. PyTorch cannot
replay JAX's random streams, so the values differ from the reference's for
the same seed; shapes, label balance and class structure do not. Parity
tests carry the reference's own data across instead
(:func:`repro_torch.data.vertical.split_from_numpy`), or feed the
deterministic part of a generator the reference's own draws
(:func:`tabular_credit_from_draws`, :func:`token_stream_from_draws`,
:func:`sequence_classification_from_draws`).
"""

from __future__ import annotations

from typing import Tuple

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device


def _generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def tabular_credit_from_draws(
    latent: torch.Tensor,
    mix: torch.Tensor,
    w: torch.Tensor,
    flip_u: torch.Tensor,
    num_classes: int = 2,
    label_noise: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deterministic part of :func:`make_tabular_credit`: features
    ``latent @ (mix / √D + I/2)`` and a label from a logistic model over both
    parties' blocks (``x @ w`` plus the cross-party term ``x₂·x₁₂``), cut at
    the logits' quantiles, flipped where ``flip_u < label_noise``.

    latent (N, D), mix (D, D) and w (D,) are standard normal draws, flip_u
    (N,) uniform on [0, 1). The cuts interpolate linearly, as ``jnp.median``
    and ``jnp.quantile`` do (``torch.median`` would take the lower middle)."""
    d = mix.shape[0]
    mix = mix / math.sqrt(d) + 0.5 * torch.eye(d, device=mix.device)
    x = latent @ mix
    logits = x @ w + 0.25 * (x[:, 2] * x[:, 12])
    if num_classes == 2:
        y = (logits > torch.quantile(logits, 0.5)).long()
    else:
        qs = torch.linspace(0, 1, num_classes + 1, device=x.device)[1:-1]
        y = (logits[:, None] > torch.quantile(logits, qs)[None, :]).sum(1)
    y = torch.where(flip_u < label_noise, (y + 1) % num_classes, y)
    return x.float(), y


def make_tabular_credit(
    num_samples: int,
    *,
    seed: int = 0,
    device: DeviceLike = None,
    num_features: int = 23,
    num_classes: int = 2,
    label_noise: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Correlated features whose label depends on features of BOTH parties'
    blocks (the first 10 and the rest), as in the FATE split the paper uses.
    Returns x (N, num_features) float32 and y (N,) int64."""
    dev = resolve_device(device)
    g = _generator(seed, dev)
    latent = torch.randn(num_samples, num_features, generator=g, device=dev)
    mix = torch.randn(num_features, num_features, generator=g, device=dev)
    w = torch.randn(num_features, generator=g, device=dev)
    flip_u = torch.rand(num_samples, generator=g, device=dev)
    return tabular_credit_from_draws(latent, mix, w, flip_u, num_classes, label_noise)


def make_cluster_tabular(
    num_samples: int,
    *,
    seed: int = 0,
    device: DeviceLike = None,
    num_informative: int = 24,
    num_nuisance: int = 16,
    num_clusters: int = 12,
    num_classes: int = 2,
    cluster_std: float = 0.3,
    nuisance_std: float = 2.0,
    label_noise: float = 0.15,
    separation: float = 3.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A mixture of compact, well-separated clusters with nuisance columns
    interleaved into every party's block and ``label_noise`` flips.
    Returns x (N, informative + nuisance) float32 and y (N,) int64."""
    dev = resolve_device(device)
    g = _generator(seed, dev)
    centers = torch.randn(num_clusters, num_informative, generator=g, device=dev)
    centers = (
        separation
        * centers
        / torch.linalg.vector_norm(centers, dim=1, keepdim=True)
        * (num_informative / 8) ** 0.5
    )
    z = torch.randint(0, num_clusters, (num_samples,), generator=g, device=dev)
    x_inf = centers[z] + cluster_std * torch.randn(
        num_samples, num_informative, generator=g, device=dev
    )
    x_nui = nuisance_std * torch.randn(num_samples, num_nuisance, generator=g, device=dev)
    y = (torch.arange(num_clusters, device=dev) % num_classes)[z]
    flip = torch.rand(num_samples, generator=g, device=dev) < label_noise
    y = torch.where(flip, (y + 1) % num_classes, y)
    hi, hn = num_informative // 2, num_nuisance // 2
    x = torch.cat([x_inf[:, :hi], x_nui[:, :hn], x_inf[:, hi:], x_nui[:, hn:]], dim=1)
    return x.float(), y


def make_image_classification(
    num_samples: int,
    *,
    seed: int = 0,
    device: DeviceLike = None,
    num_classes: int = 10,
    image_size: int = 32,
    channels: int = 3,
    template_strength: float = 1.0,
    cross_half_fraction: float = 0.35,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Class-conditional low-frequency templates plus noise, NHWC.

    ``cross_half_fraction`` of each template lives in a component that is
    label-informative only when both halves are seen (sign-coupled across
    the vertical midline). Returns x (N, H, W, C) float32, y (N,) int64."""
    dev = resolve_device(device)
    g = _generator(seed, dev)
    h = w = image_size
    coarse = torch.randn(num_classes, channels, 4, 4, generator=g, device=dev)
    templates = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    templates = templates.permute(0, 2, 3, 1)  # NHWC
    cross = torch.randn(num_classes, h, w // 2, channels, generator=g, device=dev)
    sign = (-1.0) ** torch.arange(num_classes, device=dev, dtype=torch.float32)
    cross_full = torch.cat([cross, cross * sign[:, None, None, None]], dim=2)
    templates = (1 - cross_half_fraction) * templates + cross_half_fraction * cross_full
    labels = torch.randint(0, num_classes, (num_samples,), generator=g, device=dev)
    x = template_strength * templates[labels]
    x += torch.randn(num_samples, h, w, channels, generator=g, device=dev)
    x /= 1.0 + template_strength
    return x.float(), labels


def token_stream_from_draws(u: torch.Tensor, vocab_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deterministic part of :func:`make_token_stream`: Zipf-like ids
    ``clip(int(u^-0.7 − 1), 0, V − 1)`` of uniform draws u (B, S + 1) on
    [1e-6, 1), in f32 → (tokens, labels), each (B, S) int32, the labels the
    next token."""
    ids = (u.float() ** -0.7 - 1.0).to(torch.int32).clamp(0, vocab_size - 1)
    return ids[:, :-1], ids[:, 1:]


def make_token_stream(
    generator: torch.Generator, batch: int, seq_len: int, vocab_size: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A synthetic LM batch on the generator's device: Zipf-like token ids
    and labels = the next token, each (batch, seq_len) int32."""
    u = torch.rand(batch, seq_len + 1, generator=generator, device=generator.device)
    return token_stream_from_draws(1e-6 + (1.0 - 1e-6) * u, vocab_size)


def sequence_classification_from_draws(
    topics: torch.Tensor,
    labels: torch.Tensor,
    base: torch.Tensor,
    pick: torch.Tensor,
    use_topic: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deterministic part of :func:`make_sequence_classification`: row
    i's token j is ``topics[labels[i], pick[i, j]]`` where ``use_topic``,
    else ``base[i, j]``. topics (C, V // 4) ids in [1, V), labels (N,) in
    [0, C), base (N, S) in [1, V), pick (N, S) in [0, V // 4), use_topic
    (N, S) bool → (x (N, S) int32, labels (N,) int64)."""
    topic_tok = topics[labels.long()].gather(1, pick.long())
    return torch.where(use_topic, topic_tok, base).to(torch.int32), labels.long()


def make_sequence_classification(
    num_samples: int,
    *,
    seed: int = 0,
    device: DeviceLike = None,
    seq_len: int = 32,
    vocab_size: int = 64,
    num_classes: int = 4,
    topic_strength: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token sequences whose class is a 'topic': each class over-samples a
    class-specific token subset, spread over the whole sequence so that both
    halves of a row are informative (the VFL-on-LM scenario). Returns x
    (N, S) int32 and y (N,) int64."""
    dev = resolve_device(device)
    g = _generator(seed, dev)
    topics = torch.randint(1, vocab_size, (num_classes, vocab_size // 4), generator=g, device=dev)
    labels = torch.randint(0, num_classes, (num_samples,), generator=g, device=dev)
    base = torch.randint(1, vocab_size, (num_samples, seq_len), generator=g, device=dev)
    pick = torch.randint(0, vocab_size // 4, (num_samples, seq_len), generator=g, device=dev)
    use_topic = torch.rand(num_samples, seq_len, generator=g, device=dev) < topic_strength
    return sequence_classification_from_draws(topics, labels, base, pick, use_topic)


def numpy_train_test_split(x, y, test_fraction: float = 0.2, seed: int = 0):
    """((x_train, y_train), (x_test, y_test)): the first ``int(n ·
    test_fraction)`` rows of ``np.random.RandomState(seed).permutation(n)``
    are the test set, the rest the training set, as in the reference."""
    n = x.shape[0]
    perm = torch.from_numpy(np.random.RandomState(seed).permutation(n))
    n_test = int(n * test_fraction)
    te, tr = perm[:n_test], perm[n_test:]
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    te, tr = te.to(x.device), tr.to(x.device)
    return (x[tr], y[tr]), (x[te], y[te])
