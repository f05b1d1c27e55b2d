from repro_torch.kernels.rmsnorm import ops, ref

__all__ = ["ops", "ref"]
