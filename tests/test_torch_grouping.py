"""The port's scenario partitioner against the reference's.

``group_scenarios`` on all 27 catalog names at smoke sizes gives the
reference's partition, name for name (``test_scenario_batched.py:315``);
the partitioner's fixed-subset properties hold (exact cover by
fold-compatible groups, deterministic, order-preserving); an architecture
change or a masked split never merges; the fault family is one group.
"""

import dataclasses
import random

import pytest

from repro import scenarios as jscen
from repro_torch import scenarios
from repro_torch.checkpoint.artifact import ExtractorSpec
from repro_torch.scenarios import grouping

from test_torch_catalog import one_torch_thread  # noqa: F401 (autouse fixture)

NAMES = scenarios.names()
_BUILT: dict = {}


def entry(name):
    """Built catalog entry (spec, bundle) at smoke sizes on the CPU, cached."""
    if name not in _BUILT:
        bundle = scenarios.build(name, seed=0, smoke=True, device="cpu")
        _BUILT[name] = (bundle.spec, bundle)
    return _BUILT[name]


@pytest.fixture(scope="module")
def catalog():
    return [entry(n) for n in NAMES]


def test_the_catalog_partition_is_the_references_name_for_name(catalog):
    assert NAMES == jscen.names() and len(NAMES) == 27
    ref = jscen.group_scenarios(
        [(b.spec, b) for b in (jscen.build(n, seed=0, smoke=True) for n in NAMES)]
    )
    got = scenarios.group_scenarios(catalog)
    assert [g.names for g in got] == [g.names for g in ref]
    assert [g.indices for g in got] == [g.indices for g in ref]


def test_known_catalog_groups(catalog):
    groups = scenarios.group_scenarios(catalog)
    group_of = {n: gi for gi, g in enumerate(groups) for n in g.names}
    family = ["credit/overlap-32", "credit/overlap-64", "credit/overlap-128",
              "credit/overlap-256", "credit/label-noise"]
    assert len({group_of[n] for n in family}) == 1
    assert group_of["hard/overlap-32"] != group_of["hard/overlap-64"]
    assert group_of["hard/overlap-32-eq"] == group_of["hard/overlap-64-eq"]
    assert group_of["hard/overlap-64-eq"] != group_of["hard/overlap-64"]
    faults = [n for n in NAMES if n.startswith("fault/")]
    assert len(faults) == 9 and len({group_of[n] for n in faults}) == 1
    assert groups[group_of["fault/none"]].size == 9  # faults stay out of the signature
    for loner in ("credit/feature-skew", "credit/parties-4", "credit/parties-8",
                  "image/halves", "image/patch-4"):
        assert sum(1 for n in NAMES if group_of[n] == group_of[loner]) == 1


def _fixed_subsets():
    """The full catalog, every singleton, and seeded random subsets."""
    rng = random.Random(0)
    subsets = [list(NAMES)] + [[n] for n in NAMES]
    for _ in range(15):
        subsets.append(rng.sample(NAMES, rng.randint(1, len(NAMES))))
    return subsets


@pytest.mark.parametrize("index", range(len(_fixed_subsets())))
def test_partitioner_properties_on_fixed_subsets(index):
    subset = _fixed_subsets()[index]
    entries = [entry(n) for n in subset]
    groups = scenarios.group_scenarios(entries)
    # an exact cover by groups whose members stack with their head
    assert sorted(i for g in groups for i in g.indices) == list(range(len(entries)))
    for g in groups:
        assert g.names == [entries[i][0].name for i in g.indices]
        head = entries[g.indices[0]][1]
        for i in g.indices[1:]:
            assert grouping.bundles_fold_compatible(entries[i][1], head)
            assert grouping.split_signature(entries[i][1].split) == grouping.split_signature(
                head.split
            )
    # deterministic, groups in first-occurrence order, members in input order
    again = scenarios.group_scenarios(entries)
    assert [g.indices for g in again] == [g.indices for g in groups]
    assert [g.indices[0] for g in groups] == sorted(g.indices[0] for g in groups)
    assert all(g.indices == sorted(g.indices) for g in groups)


def test_partition_none_and_distinct_signatures_are_singletons():
    assert grouping.partition(["a", None, "a", "b", None]) == [[0, 2], [1], [3], [4]]
    assert grouping.partition([]) == []
    assert grouping.fold_signature(*entry("hard/overlap-32")) is not None


def test_arch_mismatch_falls_out_as_singleton():
    spec, bundle = entry("credit/overlap-32")
    other = dataclasses.replace(bundle, extractors=[ExtractorSpec("mlp", 16, hidden=(32,))] * 2)
    groups = scenarios.group_scenarios([(spec, bundle), (spec, other)])
    assert [g.indices for g in groups] == [[0], [1]]
    assert not grouping.bundles_fold_compatible(bundle, other)


def test_a_masked_split_never_stacks_with_an_unmasked_one():
    spec, masked = entry("hard/overlap-64-eq")
    unmasked = dataclasses.replace(masked, split=dataclasses.replace(masked.split, aligned_mask=None))
    assert grouping.split_signature(masked.split) != grouping.split_signature(unmasked.split)
    assert not grouping.bundles_fold_compatible(masked, unmasked)
    groups = scenarios.group_scenarios([(spec, masked), (spec, unmasked)])
    assert [g.size for g in groups] == [1, 1]
