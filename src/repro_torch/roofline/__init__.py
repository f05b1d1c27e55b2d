"""Roofline terms of the model zoo on the port's card (counterpart of
``repro.roofline``): the analytic terms of ``analysis``, and
``trace_analysis``, the counterpart of the reference's HLO analysis, which
counts a traced step's per-device dot FLOPs, traffic and collective bytes."""

from repro_torch.roofline.analysis import HW, Hardware, active_params, model_flops, roofline_terms
from repro_torch.roofline.trace_analysis import TraceCost, TraceCounter

__all__ = [
    "HW",
    "Hardware",
    "TraceCost",
    "TraceCounter",
    "active_params",
    "model_flops",
    "roofline_terms",
]
