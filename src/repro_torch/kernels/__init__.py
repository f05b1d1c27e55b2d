"""Hand-written CUDA kernels for the port's hot spots.

Each kernel directory mirrors ``repro.kernels.<name>``: ``csrc/*.cu`` (the
kernel, with a plain C entry point), ``ops.py`` (the checked wrapper that
launches it on a CUDA tensor and takes the plain version on a CPU tensor)
and ``ref.py`` (the plain PyTorch version). :mod:`._build` compiles the
sources with ``nvcc`` at first use; importing a kernel module builds
nothing.

* ``kmeans`` — step ③'s cluster assignment (distance + argmin);
* ``sdpa_estimator`` — Eq. 10 flash-style SDPA estimation;
* ``rmsnorm`` — the model zoo's fused RMSNorm (2L + 1 per forward);
* ``decode_attention`` — the model zoo's GQA flash-decode (one per layer
  per decode step), reading the zoo's KV cache in place.
"""
