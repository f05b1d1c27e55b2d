"""Declarative party faults (the reference's ``repro.scenarios.faults``,
copied: the module is pure data).

A :class:`FaultSpec` attaches to a ``ScenarioSpec`` and names ONE party
fault: ``dropout`` (the party disappears at a named protocol stage),
``straggler`` (it completes ``epoch_fraction`` of its SSL epochs),
``dp_upload`` (its uploads carry Gaussian noise of ``dp_sigma`` × their
std) or ``representation_only`` (it never runs local SSL). The runners
apply a spec through ``repro_torch.core.faults``.
"""
from __future__ import annotations

from dataclasses import dataclass

KINDS = ("dropout", "straggler", "dp_upload", "representation_only")

#: named dropout stages, in protocol order
STAGES = ("pre_upload", "pre_ssl", "post_ssl", "pre_round2")

# Protocol event points, in execution order. A dropout at stage s means
# the party is gone for every event point >= _STAGE_THRESHOLD[s]:
#   POINT_UPLOAD1  step ① overlap-representation upload (+ ② grads down)
#   POINT_SSL      step ④ local SSL (also few-shot ⑤' masked SSL)
#   POINT_UPLOAD2  step ⑤ refreshed-representation upload
#   POINT_ROUND2   every few-shot round-2 event (①' h_u up, ④' probs
#                  down, ⑤' SSL, ⑥' final upload)
#   POINT_EVAL     test-time representation extraction
POINT_UPLOAD1 = 0
POINT_SSL = 1
POINT_UPLOAD2 = 2
POINT_ROUND2 = 3
POINT_EVAL = 4

_STAGE_THRESHOLD = {
    "pre_upload": POINT_UPLOAD1,
    "pre_ssl": POINT_SSL,
    "post_ssl": POINT_UPLOAD2,
    "pre_round2": POINT_ROUND2,
}

#: fraction of the iterative baselines' round loop a dropout at each
#: stage lets complete before the party goes silent (the iterative
#: protocol has no stage structure, so stages map onto loop progress)
ITERATIVE_DROP_FRACTION = {
    "pre_upload": 0.0,
    "pre_ssl": 0.25,
    "post_ssl": 0.5,
    "pre_round2": 0.75,
}


@dataclass(frozen=True)
class FaultSpec:
    """One declarative party fault. Frozen so ``ScenarioSpec`` stays
    hashable; validation happens at construction, not injection time."""

    kind: str
    party: int = 1
    #: dropout only: the named protocol stage the party disappears at
    stage: str = "pre_ssl"
    #: straggler only: fraction of the SSL epoch budget completed
    epoch_fraction: float = 1.0
    #: dp_upload only: noise scale as a multiple of the upload's std
    dp_sigma: float = 0.0
    #: dropout only (iterative baselines): timeout probes the server
    #: sends before abandoning the dropped party
    retry_rounds: int = 3

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"fault kind {self.kind!r} not in {KINDS}")
        if self.party < 0:
            raise ValueError(f"fault party {self.party} must be >= 0")
        if self.kind == "dropout":
            if self.stage not in STAGES:
                raise ValueError(
                    f"dropout stage {self.stage!r} not in {STAGES}")
            if self.retry_rounds < 1:
                raise ValueError(
                    f"retry_rounds {self.retry_rounds} must be >= 1")
        if self.kind == "straggler" \
                and not 0.0 <= self.epoch_fraction <= 1.0:
            raise ValueError(
                f"epoch_fraction {self.epoch_fraction} not in [0, 1]")
        if self.kind == "dp_upload" and self.dp_sigma < 0.0:
            raise ValueError(f"dp_sigma {self.dp_sigma} must be >= 0")

    def drops(self, party: int, point: int) -> bool:
        """Is ``party`` gone at protocol event ``point`` (a POINT_*
        constant)? Only dropout faults ever make a party vanish."""
        return (self.kind == "dropout" and self.party == party
                and _STAGE_THRESHOLD[self.stage] <= point)

    def skips_ssl(self, party: int) -> bool:
        """Does ``party`` run ZERO local SSL steps? True for a dropout
        at/before the SSL point and for representation-only parties."""
        if self.kind == "representation_only" and self.party == party:
            return True
        return self.drops(party, POINT_SSL)

    def parties_survived(self, num_parties: int) -> int:
        """How many parties still participate at eval time. Stragglers,
        DP-noised, and representation-only parties degrade but survive;
        a dropout is gone (any stage threshold <= POINT_EVAL)."""
        return num_parties - 1 if self.kind == "dropout" else num_parties

    def iterative_active_steps(self, iterations: int) -> int:
        """How many round-loop steps the iterative baselines complete
        before a dropout stalls them (``iterations`` when no dropout)."""
        if self.kind != "dropout":
            return iterations
        return int(ITERATIVE_DROP_FRACTION[self.stage] * iterations)
