"""The scenario registry: named, fully parameterised VFL conditions.

Counterpart of ``repro.scenarios.registry``. A scenario names the whole
experimental condition: the synthetic generator and its knobs, how many
parties hold which feature block (or image strip or patch), how many rows
overlap, each party's extractor and its SSL recipe, and the training
budgets. Specs are frozen dataclasses with the reference's fields, so a spec
of the port and the reference's spec of the same name compare field for
field; ``spec.smoke()`` is the same condition shrunk for quick runs.

:func:`build` draws the data with the port's own generators
(:mod:`repro_torch.data.synthetic`, seeded ``1000 + seed`` as the reference
seeds its key) on the caller's device, partitions it with ``seed``, and
lists the per-party extractor specs and SSL configs.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from repro_torch.checkpoint.artifact import ExtractorSpec
from repro_torch.core.ssl import SSLConfig
from repro_torch.data import synthetic
from repro_torch.data.vertical import VerticalSplit, make_vfl_partition
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.scenarios.faults import FaultSpec

GENERATORS: Dict[str, Callable] = {
    "tabular_credit": synthetic.make_tabular_credit,
    "cluster_tabular": synthetic.make_cluster_tabular,
    "image_classification": synthetic.make_image_classification,
}


@dataclass(frozen=True)
class ScenarioSpec:
    """One named condition; every field is a hashable value."""

    name: str
    modality: str  # "tabular" | "image"
    generator: str  # key into GENERATORS
    overlap: int  # N_o
    num_samples: int
    # fixed aligned-block capacity of the equal-shape overlap family: the
    # split holds this many aligned rows (the real overlap first, cyclic
    # duplicates after, a validity mask alongside)
    overlap_capacity: Optional[int] = None
    num_parties: int = 2
    gen_params: Tuple[Tuple[str, Any], ...] = ()
    feature_sizes: Optional[Tuple[int, ...]] = None  # tabular block sizes
    image_grid: Optional[Tuple[int, int]] = None  # (rows, cols) patches
    rep_dim: int = 16
    hidden: Tuple[int, ...] = (64,)  # MLP extractor widths
    widths: Tuple[int, ...] = (8, 16)  # CNN stage widths
    blocks_per_stage: int = 1
    ssl_params: Tuple[Tuple[str, Any], ...] = ()
    fewshot_threshold: Optional[float] = None  # Eq. 9 gate t (None: the default)
    fault: Optional[FaultSpec] = None  # an injected party fault (not run by the port yet)
    budgets: Tuple[Tuple[str, int], ...] = ()  # training-budget hints
    tags: Tuple[str, ...] = ()
    smoke_overlap: int = 32
    smoke_samples: int = 2000
    description: str = ""

    def budget(self, key: str, default: int) -> int:
        return dict(self.budgets).get(key, default)

    def smoke(self) -> "ScenarioSpec":
        """The same condition at a capped overlap and row count; the
        equal-shape capacity shrinks with the overlap cap."""
        capacity = self.overlap_capacity
        if capacity is not None:
            capacity = min(capacity, self.smoke_overlap)
        return replace(
            self,
            overlap=min(self.overlap, self.smoke_overlap),
            num_samples=min(self.num_samples, self.smoke_samples),
            overlap_capacity=capacity,
        )


@dataclass
class ScenarioBundle:
    spec: ScenarioSpec
    split: VerticalSplit
    extractors: List[ExtractorSpec]
    ssl_cfgs: List[SSLConfig]


#: the registry: name → spec
CATALOG: Dict[str, ScenarioSpec] = {}


def register(spec: ScenarioSpec) -> ScenarioSpec:
    if spec.name in CATALOG:
        raise ValueError(f"scenario {spec.name!r} already registered")
    if spec.generator not in GENERATORS:
        raise ValueError(f"unknown generator {spec.generator!r}")
    CATALOG[spec.name] = spec
    return spec


def get(name: str) -> ScenarioSpec:
    try:
        return CATALOG[name]
    except KeyError:
        known = ", ".join(sorted(CATALOG))
        raise KeyError(f"unknown scenario {name!r}; registered: {known}") from None


def names() -> List[str]:
    return sorted(CATALOG)


def by_tag(tag: str) -> List[ScenarioSpec]:
    return [CATALOG[n] for n in sorted(CATALOG) if tag in CATALOG[n].tags]


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


def build(
    name_or_spec: Union[str, ScenarioSpec],
    seed: int = 0,
    smoke: bool = False,
    device: DeviceLike = None,
) -> ScenarioBundle:
    """Draw the scenario's data on ``device``, partition it vertically, and
    list its per-party extractor specs and SSL configs."""
    spec = name_or_spec if isinstance(name_or_spec, ScenarioSpec) else get(name_or_spec)
    if smoke:
        spec = spec.smoke()
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
        num_classes=int(y.max()) + 1,
        image_grid=spec.image_grid,
        overlap_capacity=spec.overlap_capacity,
    )
    return ScenarioBundle(spec, split, list(extractor_specs_for(spec)), ssl_configs_for(spec))
