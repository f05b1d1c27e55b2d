"""PyTorch / CUDA port of the one-shot / few-shot VFL system.

The JAX package ``repro`` is the reference; this package mirrors its module
names so each piece has an obvious counterpart (``repro.launch.vfl_serve``
↔ ``repro_torch.launch.vfl_serve`` and so on). It imports ``torch``, numpy
and the standard library only, never ``jax`` and nothing of ``repro``.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`). PyTorch runs eagerly, so
the reference's compile-session cache (``engine/sessions.py``), ``jit`` and
input donation have no counterpart here.

The Pallas TPU kernels on the ported path are hand-written CUDA kernels
under ``kernels/<name>/csrc``, built with ``nvcc`` at first use
(:mod:`repro_torch.kernels._build`).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
