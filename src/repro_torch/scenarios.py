"""Named VFL conditions the port runs, with the reference's parameters.

A port-local copy of the parts of ``repro.scenarios`` that the port's
training path needs: :class:`ScenarioSpec`, the ``hard/overlap-32`` and
``hard/overlap-64`` entries of ``repro/scenarios/catalog.py`` (the parity and
acceptance configurations),
and :func:`build`, which draws the data with the port's own generators
(:mod:`repro_torch.data.synthetic`, seeded ``1000 + seed`` as the reference
seeds its key) and partitions it with ``seed``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.checkpoint.artifact import ExtractorSpec
from repro_torch.core.ssl import SSLConfig
from repro_torch.data import synthetic
from repro_torch.data.vertical import VerticalSplit, make_vfl_partition
from repro_torch.device import DeviceLike, resolve_device

GENERATORS: Dict[str, Callable] = {
    "cluster_tabular": synthetic.make_cluster_tabular,
    "image_classification": synthetic.make_image_classification,
}


@dataclass(frozen=True)
class ScenarioSpec:
    """One named condition (the reference's fields that the port uses)."""

    name: str
    modality: str  # "tabular" | "image"
    generator: str  # key into GENERATORS
    overlap: int  # N_o
    num_samples: int
    num_parties: int = 2
    gen_params: Tuple[Tuple[str, Any], ...] = ()
    feature_sizes: Optional[Tuple[int, ...]] = None  # tabular block sizes
    rep_dim: int = 16
    hidden: Tuple[int, ...] = (64,)  # MLP extractor widths
    widths: Tuple[int, ...] = (8, 16)  # CNN stage widths
    blocks_per_stage: int = 1
    ssl_params: Tuple[Tuple[str, Any], ...] = ()
    budgets: Tuple[Tuple[str, int], ...] = ()  # training-budget hints

    def budget(self, key: str, default: int) -> int:
        return dict(self.budgets).get(key, default)


@dataclass
class ScenarioBundle:
    spec: ScenarioSpec
    split: VerticalSplit
    extractors: List[ExtractorSpec]
    ssl_cfgs: List[SSLConfig]


def _hard_overlap(n_o: int) -> ScenarioSpec:
    """The hardened limited-overlap task: wide clusters, nuisance dims,
    label flips, N_o = ``n_o`` of 3000 rows."""
    return ScenarioSpec(
        name=f"hard/overlap-{n_o}",
        modality="tabular",
        generator="cluster_tabular",
        overlap=n_o,
        num_samples=3000,
        gen_params=(
            ("num_informative", 24),
            ("num_nuisance", 16),
            ("num_clusters", 12),
            ("cluster_std", 0.3),
            ("nuisance_std", 2.0),
            ("label_noise", 0.15),
        ),
        feature_sizes=(20, 20),
        rep_dim=16,
        ssl_params=(("confidence_threshold", 0.8),),
        budgets=(("client_epochs", 80), ("server_epochs", 40), ("iterations", 400)),
    )


HARD_OVERLAP_32 = _hard_overlap(32)
HARD_OVERLAP_64 = _hard_overlap(64)

CATALOG: Dict[str, ScenarioSpec] = {s.name: s for s in (HARD_OVERLAP_32, HARD_OVERLAP_64)}


def extractor_specs_for(spec: ScenarioSpec) -> Tuple[ExtractorSpec, ...]:
    """The per-party extractor specs a scenario implies."""
    if spec.modality == "image":
        e = ExtractorSpec(
            "cnn", spec.rep_dim, widths=spec.widths, blocks_per_stage=spec.blocks_per_stage
        )
    else:
        e = ExtractorSpec("mlp", spec.rep_dim, hidden=spec.hidden)
    return (e,) * spec.num_parties


def ssl_configs_for(spec: ScenarioSpec) -> List[SSLConfig]:
    return [SSLConfig(modality=spec.modality, **dict(spec.ssl_params))] * spec.num_parties


def build(spec: ScenarioSpec, seed: int = 0, device: DeviceLike = None) -> ScenarioBundle:
    """Draw the scenario's data on ``device``, partition it vertically, and
    list its per-party extractor specs and SSL configs."""
    dev = resolve_device(device)
    x, y = GENERATORS[spec.generator](
        spec.num_samples, seed=1000 + seed, device=dev, **dict(spec.gen_params)
    )
    split = make_vfl_partition(
        x,
        y,
        overlap_size=spec.overlap,
        num_parties=spec.num_parties,
        feature_sizes=spec.feature_sizes,
        seed=seed,
    )
    return ScenarioBundle(spec, split, list(extractor_specs_for(spec)), ssl_configs_for(spec))
