"""Analytic roofline terms of the model zoo on the port's card (counterpart
of ``repro.roofline``; its HLO analysis has no counterpart here)."""

from repro_torch.roofline.analysis import HW, Hardware, active_params, model_flops, roofline_terms

__all__ = ["HW", "Hardware", "active_params", "model_flops", "roofline_terms"]
