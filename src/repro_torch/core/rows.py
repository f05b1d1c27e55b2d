"""One typed result-row schema for every benchmark surface.

Counterpart of ``repro.core.rows``. ``VFLResult.summary_row()`` and the
frontier's per-(scenario, method, seed) rows are built by
:func:`training_row` (serving rows by :func:`serving_row`) over one
:class:`ResultRow` core, so every gate reads one shape:

    kind         "train" | "serving"
    metric_name  what ``metric`` measures ("auc", "accuracy", "p50_ms", …)
    metric       the headline scalar (gates compare this field)

Training rows add the paper's communication columns (``comm_bytes``,
``comm_times``) and the whitelisted execution diagnostics
(:data:`DIAGNOSTIC_KEYS`). Free-form ``context`` keys flatten into the
emitted dict but may never shadow a core key: a clash raises.
``device_fold`` is the slot count of the batch mesh that a protocol fold's
SSL sessions ran stacked over (``ProtocolConfig.mesh``), 1 without a mesh,
on the per-party loop and in the iterative baselines.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional

KINDS = ("train", "serving")

#: execution diagnostics a training row forwards from a result
DIAGNOSTIC_KEYS = (
    "iterations", "engine_path", "seed_fold", "scenario_fold", "device_fold", "kernel_fold",
    "kernel_fallback", "sdpa_fold",
    # fault diagnostics
    "parties_survived", "fault_kind", "fault_stage", "degraded_metric", "fault_retry_rounds",
    "fault_retry_bytes", "fault_modeled",
)

CORE_KEYS = ("kind", "metric_name", "metric", "comm_bytes", "comm_times")


@dataclass(frozen=True)
class ResultRow:
    """The typed row core every benchmark surface serializes through."""

    kind: str
    metric_name: str
    metric: float
    comm_bytes: Optional[int] = None
    comm_times: Optional[int] = None
    context: Mapping[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"row kind {self.kind!r} not in {KINDS}")
        clash = sorted(set(self.context) & set(CORE_KEYS))
        if clash:
            raise ValueError(f"context keys {clash} would shadow typed row fields; rename them")

    def as_dict(self) -> Dict[str, Any]:
        row: Dict[str, Any] = {
            "kind": self.kind,
            "metric_name": self.metric_name,
            "metric": float(self.metric),
        }
        if self.comm_bytes is not None:
            row["comm_bytes"] = int(self.comm_bytes)
        if self.comm_times is not None:
            row["comm_times"] = int(self.comm_times)
        row.update(self.context)
        return row


def training_row(result, **context) -> Dict[str, Any]:
    """The JSON-ready summary of one training result (metric, comm bytes,
    comm times), its whitelisted diagnostics and the caller's context.
    ``result`` is any ``VFLResult``-shaped object."""
    diags = {k: result.diagnostics[k] for k in DIAGNOSTIC_KEYS if k in result.diagnostics}
    clash = sorted(set(diags) & set(context))
    if clash:
        raise ValueError(f"context keys {clash} collide with forwarded diagnostics")
    return ResultRow(
        kind="train",
        metric_name=result.metric_name,
        metric=float(result.metric),
        comm_bytes=int(result.ledger.total_bytes()),
        comm_times=int(result.ledger.comm_times()),
        context={**diags, **context},
    ).as_dict()


def serving_row(metric_name: str, metric: float, **context) -> Dict[str, Any]:
    """One serving-benchmark row (``metric`` is the gated headline, e.g. p50
    latency in ms); batch size, throughput and parity travel as context."""
    return ResultRow(
        kind="serving", metric_name=metric_name, metric=float(metric), context=context
    ).as_dict()
