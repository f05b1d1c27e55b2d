from repro_torch.kernels.sdpa_estimator import ops, ref

__all__ = ["ops", "ref"]
