from repro_torch.kernels.kmeans import ops, ref

__all__ = ["ops", "ref"]
