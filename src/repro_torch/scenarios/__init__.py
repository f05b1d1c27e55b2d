"""Scenario registry and catalog: named, parameterised VFL conditions.

Counterpart of ``repro.scenarios``. Importing the package registers the
27-entry catalog; ``grouping`` partitions built scenarios into the groups
one folded sweep can stack. ``CATALOG`` is the registry's
mapping of name to spec; ``HARD_OVERLAP_32`` and ``HARD_OVERLAP_64`` are the
parity and acceptance configurations.
"""

from repro_torch.scenarios import catalog  # noqa: F401  (registers the catalog)
from repro_torch.scenarios.faults import FaultSpec
from repro_torch.scenarios.grouping import (
    ScenarioGroup,
    bundles_fold_compatible,
    fold_signature,
    group_scenarios,
    partition,
    split_signature,
)
from repro_torch.scenarios.registry import (
    CATALOG,
    GENERATORS,
    ScenarioBundle,
    ScenarioSpec,
    build,
    by_tag,
    extractor_specs_for,
    get,
    names,
    register,
    ssl_configs_for,
)

HARD_OVERLAP_32 = get("hard/overlap-32")
HARD_OVERLAP_64 = get("hard/overlap-64")

__all__ = [
    "CATALOG",
    "FaultSpec",
    "GENERATORS",
    "HARD_OVERLAP_32",
    "HARD_OVERLAP_64",
    "ScenarioBundle",
    "ScenarioGroup",
    "ScenarioSpec",
    "build",
    "bundles_fold_compatible",
    "by_tag",
    "extractor_specs_for",
    "fold_signature",
    "get",
    "group_scenarios",
    "names",
    "partition",
    "register",
    "split_signature",
    "ssl_configs_for",
]
