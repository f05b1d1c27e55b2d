"""The runner registry: one typed dispatch surface for every VFL method.

Counterpart of ``repro.core.runners``. ``run_seeds`` /
``run_scenarios_seeds`` look up a runner's seed-batched impl, and the
stateful kwargs a fold must refuse, through :func:`resolve`;
``benchmarks/torch_frontier.py`` resolves its method names (the
``"iterative"`` alias for vanilla SplitNN included) through :func:`get`.

A :class:`RunnerEntry` is a method's contract: the single-seed runner (the
S = 1 case of its impl), the impl, the config family it takes
(``ProtocolConfig`` or ``IterativeConfig``), the ledger policy (every impl
logs one prototype ledger; orchestration copies it per result), the
stateful kwargs that cannot thread through a fold, serving eligibility, and
``folds``: whether the impl stacks its entries (the protocol runners) or
loops over them (the iterative baselines, whose stacked fold is still to
come). Unregistered runners work everywhere through the per-seed loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple, Union

from repro_torch.core import baselines, protocol

# per-seed state kwargs: one live object cannot serve S folded seeds
STATE_KWARGS: FrozenSet[str] = frozenset({"clients", "server", "ledger", "clients_per_seed", "servers"})

#: every impl logs its ledger once; orchestration copies it per result
LEDGER_PROTOTYPE = "prototype"


@dataclass(frozen=True)
class RunnerEntry:
    """One method's dispatch contract (see the module doc)."""

    name: str  # canonical method name
    runner: Callable  # single-seed entry
    seeds_impl: Callable  # seed-batched impl
    kind: str  # "protocol" | "iterative" (config family)
    ledger_policy: str = LEDGER_PROTOTYPE
    stateful_kwargs: FrozenSet[str] = STATE_KWARGS
    servable: bool = True  # the result exports as a TrainedVFLModel
    aliases: Tuple[str, ...] = ()
    folds: bool = True  # the impl stacks its entries into one program


_BY_NAME: Dict[str, RunnerEntry] = {}
_BY_RUNNER: Dict[Callable, RunnerEntry] = {}


def register(entry: RunnerEntry) -> RunnerEntry:
    for name in (entry.name,) + entry.aliases:
        if name in _BY_NAME:
            raise ValueError(f"runner name {name!r} already registered")
        _BY_NAME[name] = entry
    _BY_RUNNER[entry.runner] = entry
    return entry


def resolve(runner_or_name: Union[str, Callable]) -> Optional[RunnerEntry]:
    """The entry of a runner or method name; None when unregistered (the
    caller then takes the per-seed loop)."""
    if isinstance(runner_or_name, str):
        return _BY_NAME.get(runner_or_name)
    return _BY_RUNNER.get(runner_or_name)


def get(name: str) -> RunnerEntry:
    """Like :func:`resolve`, by name only, raising on an unknown name."""
    entry = _BY_NAME.get(name)
    if entry is None:
        known = ", ".join(sorted(_BY_NAME))
        raise KeyError(f"unknown runner {name!r}; registered: {known}")
    return entry


def names(include_aliases: bool = False) -> List[str]:
    if include_aliases:
        return sorted(_BY_NAME)
    return sorted({e.name for e in _BY_NAME.values()})


def reject_stateful_kwargs(
    entry_label: str, runner_kwargs: dict, entry: Optional[RunnerEntry] = None
) -> None:
    """Refuse per-seed state kwargs at the multi-seed entries (the entry's
    ``stateful_kwargs``, :data:`STATE_KWARGS` for unregistered runners)."""
    banned = entry.stateful_kwargs if entry is not None else STATE_KWARGS
    stateful = sorted(banned & set(runner_kwargs))
    if stateful:
        raise ValueError(
            f"{entry_label} does not accept per-seed state kwargs {stateful}: one object "
            f"cannot serve every seed; call the runner or its *_seeds entry directly instead"
        )


# ---------------------------------------------------------------- catalog
RUNNERS: Tuple[RunnerEntry, ...] = tuple(
    register(e)
    for e in (
        RunnerEntry("one_shot", protocol.run_one_shot, protocol._one_shot_seeds, kind="protocol"),
        RunnerEntry("few_shot", protocol.run_few_shot, protocol._few_shot_seeds, kind="protocol"),
        RunnerEntry(
            "few_shot_finetune",
            protocol.run_few_shot_finetune,
            protocol._few_shot_finetune_seeds,
            kind="protocol",
        ),
        RunnerEntry(
            "vanilla", baselines.run_vanilla, baselines.run_vanilla_seeds, kind="iterative",
            aliases=("iterative",), folds=False,
        ),
        RunnerEntry(
            "fedcvt", baselines.run_fedcvt, baselines.run_fedcvt_seeds, kind="iterative", folds=False
        ),
        RunnerEntry(
            "fedbcd", baselines.run_fedbcd, baselines.run_fedbcd_seeds, kind="iterative", folds=False
        ),
    )
)
