"""Scenario-group partitioner for the scenario-axis fold.

Counterpart of ``repro.scenarios.grouping``. The folds treat their stacked
axis as anonymous, so any set of (scenario, seed) entries that share one
shape and one party semantics can ride it. Two scenarios stack when, party
position by party position, the engine's own precondition holds across the
pair (``engine.local_ssl.parties_are_homogeneous``: equal extractor specs,
SSL configs and feature shapes), their built splits share every shape and
the class count, and their training budgets and gate threshold match. A
scenario whose own parties differ (``credit/feature-skew``) may still fold
with a twin: each entry then takes its own engine path inside the fold.

:func:`fold_signature` is the hashable image of that relation; faults are
per-entry data and stay out of it, so the nine ``fault/*`` members stack
into one group. :func:`partition` buckets signatures in first-occurrence
order; :func:`group_scenarios` combines the two and re-checks every
multi-member bucket with :func:`bundles_fold_compatible`, so a signature
collision can only split a group, never merge a wrong one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Hashable, List, Optional, Sequence, Tuple

from repro_torch.engine.local_ssl import parties_are_homogeneous
from repro_torch.scenarios.registry import ScenarioBundle, ScenarioSpec


def split_signature(split) -> tuple:
    """Every shape of a built split and its class count (the stacking
    precondition on the data side; the one ``run_seeds`` checks)."""
    mask = split.aligned_mask
    return (
        tuple(tuple(x.shape) for x in split.aligned),
        tuple(tuple(x.shape) for x in split.unaligned),
        tuple(tuple(x.shape) for x in split.test_aligned),
        tuple(split.labels.shape),
        tuple(split.test_labels.shape),
        split.num_classes,
        # a masked split never stacks with an unmasked one of equal shapes:
        # the mask changes the SSL loss
        None if mask is None else tuple(mask.shape),
    )


def fold_signature(spec: ScenarioSpec, bundle: ScenarioBundle) -> Optional[Hashable]:
    """Hashable stack key of one built scenario: equal signatures mean the
    entries may share one folded axis. The party-wise extractor spec is the
    port's form of the reference's ``model_key``. None when the key is not
    hashable: such entries never group."""
    sig = (
        tuple(zip(bundle.extractors, bundle.ssl_cfgs)),
        split_signature(bundle.split),
        spec.budgets,
        spec.fewshot_threshold,
    )
    try:
        hash(sig)
    except TypeError:
        return None
    return sig


def partition(signatures: Sequence[Optional[Hashable]]) -> List[List[int]]:
    """Order-preserving partition of indices by signature: groups in
    first-occurrence order, members in input order, a None signature always
    its own singleton."""
    groups: List[List[int]] = []
    by_sig: dict = {}
    for i, sig in enumerate(signatures):
        if sig is None:
            groups.append([i])
            continue
        bucket = by_sig.get(sig)
        if bucket is None:
            bucket = by_sig[sig] = []
            groups.append(bucket)
        bucket.append(i)
    return groups


def bundles_fold_compatible(a: ScenarioBundle, b: ScenarioBundle) -> bool:
    """The engine's precondition across two scenarios, party position by
    party position: the ground truth behind :func:`fold_signature`."""
    if len(a.extractors) != len(b.extractors):
        return False
    if split_signature(a.split) != split_signature(b.split):
        return False
    return all(
        parties_are_homogeneous([ea, eb], [ca, cb], [tuple(xa.shape), tuple(xb.shape)])
        for ea, eb, ca, cb, xa, xb in zip(
            a.extractors, b.extractors, a.ssl_cfgs, b.ssl_cfgs, a.split.aligned, b.split.aligned
        )
    )


@dataclass
class ScenarioGroup:
    """One stackable bucket of built scenarios (indices into the input list,
    in input order). ``size == 1`` runs through the same folded path."""

    indices: List[int]
    names: List[str]
    signature: Optional[Hashable]

    @property
    def size(self) -> int:
        return len(self.indices)


def group_scenarios(entries: Sequence[Tuple[ScenarioSpec, ScenarioBundle]]) -> List[ScenarioGroup]:
    """Partition built scenarios into stackable groups: bucket by
    :func:`fold_signature`, then check every member of a bucket against its
    first with :func:`bundles_fold_compatible`; a member that fails becomes
    a singleton after its would-be group."""
    sigs = [fold_signature(spec, bundle) for spec, bundle in entries]
    groups: List[ScenarioGroup] = []
    for idxs in partition(sigs):
        head = entries[idxs[0]][1]
        kept = [i for i in idxs if i == idxs[0] or bundles_fold_compatible(entries[i][1], head)]
        demoted = [i for i in idxs if i not in kept]
        for members, sig in [(kept, sigs[idxs[0]])] + [([i], None) for i in demoted]:
            groups.append(
                ScenarioGroup(
                    indices=list(members), names=[entries[i][0].name for i in members], signature=sig
                )
            )
    return groups
