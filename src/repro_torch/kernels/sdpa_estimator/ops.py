"""Public wrappers of the Eq. 10 SDPA estimator kernel.

Counterparts of ``repro.kernels.sdpa_estimator.ops.sdpa_estimate_batched``
and ``sdpa_estimate``, with their signatures. Inputs are cast to float32 (as
the reference op does) and checked; then

* a CPU tensor takes the plain version (:mod:`.ref`);
* a CUDA tensor launches the hand-written kernel
  (``csrc/sdpa_estimator.cu``) on the current stream, or raises. There is no
  fallback: a build failure, a refused launch or an unsupported shape is an
  error.

The kernel takes batch and row strides, so a batch axis broadcast with
``expand`` (stride 0) reaches it without a copy; only the last dimension of
each input must be contiguous. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sdpa_estimator import ref

MAX_WIDTH = 256  # widest d and d_b the kernel takes
MAX_BATCH = 65535  # the kernel's grid puts the batch on gridDim.y
LAUNCHES = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load_library("sdpa_estimator").sdpa_estimator_f32
        fn.argtypes = (
            [ctypes.c_void_p] * 4
            + [ctypes.c_int] * 5
            + [ctypes.c_longlong] * 6
            + [ctypes.c_float, ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(h_u: torch.Tensor, h_o_a: torch.Tensor, h_o_b: torch.Tensor) -> None:
    for name, t in (("h_u", h_u), ("h_o_a", h_o_a), ("h_o_b", h_o_b)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be (B, N, d), got shape {tuple(t.shape)}")
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
        if t.device != h_u.device:
            raise ValueError(f"{name} is on {t.device}, h_u on {h_u.device}")
        if t.shape[2] > 1 and t.stride(2) != 1:
            raise ValueError(f"{name}'s last dimension must be contiguous")
    b, _, d = h_u.shape
    if h_o_a.shape[0] != b or h_o_b.shape[0] != b:
        raise ValueError(f"batch sizes differ: {h_u.shape[0]}, {h_o_a.shape[0]}, {h_o_b.shape[0]}")
    if h_o_a.shape[2] != d:
        raise ValueError(f"h_o_a width {h_o_a.shape[2]} != h_u width {d}")
    if h_o_b.shape[1] != h_o_a.shape[1]:
        raise ValueError(f"h_o_b rows {h_o_b.shape[1]} != h_o_a rows {h_o_a.shape[1]}")
    if h_o_a.shape[1] < 1:
        raise ValueError("the overlap set H_o is empty: nothing to attend over")
    for name, width in (("d", d), ("d_b", h_o_b.shape[2])):
        if not 1 <= width <= MAX_WIDTH:
            raise ValueError(f"{name}={width} is outside the kernel's 1..{MAX_WIDTH}")
    if not 1 <= b <= MAX_BATCH:
        raise ValueError(f"batch {b} is outside 1..{MAX_BATCH}")


def sdpa_estimate_batched(
    h_u: torch.Tensor, h_o_a: torch.Tensor, h_o_b: torch.Tensor
) -> torch.Tensor:
    """Eq. 10 per batch entry as ONE launch.

    h_u (B, N_u, d), h_o_a (B, N_o, d), h_o_b (B, N_o, d_b) →
    (B, N_u, d_b) f32. Scale 1/√d of the true d."""
    global LAUNCHES
    _check(h_u, h_o_a, h_o_b)
    h_u, h_o_a, h_o_b = h_u.float(), h_o_a.float(), h_o_b.float()
    if h_u.device.type == "cpu":
        return ref.sdpa_estimate_batched(h_u, h_o_a, h_o_b)
    if h_u.device.type != "cuda":
        raise ValueError(f"no SDPA route for device {h_u.device}")
    b, nu, d = h_u.shape
    no, db = h_o_b.shape[1], h_o_b.shape[2]
    out = torch.empty((b, nu, db), device=h_u.device, dtype=torch.float32)
    if nu == 0:
        return out
    fn = _kernel()
    ptrs = (h_u.data_ptr(), h_o_a.data_ptr(), h_o_b.data_ptr(), out.data_ptr())
    strides = (*h_u.stride()[:2], *h_o_a.stride()[:2], *h_o_b.stride()[:2])
    err = _build.call(fn, h_u.device, *ptrs, b, nu, no, d, db, *strides, 1.0 / math.sqrt(d))
    if err != 0:
        raise RuntimeError(f"sdpa_estimator launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out


def sdpa_estimate(h_u: torch.Tensor, h_o_a: torch.Tensor, h_o_b: torch.Tensor) -> torch.Tensor:
    """Eq. 10 for one entry: (N_u, d), (N_o, d), (N_o, d_b) → (N_u, d_b) f32.
    The width-1 case of :func:`sdpa_estimate_batched`."""
    return sdpa_estimate_batched(h_u[None], h_o_a[None], h_o_b[None])[0]
