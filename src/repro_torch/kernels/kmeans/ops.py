"""Public wrappers of the k-means assignment kernel.

Counterparts of ``repro.kernels.kmeans.ops.kmeans_assign_batched`` and
``kmeans_assign``, with their signatures, plus the minimum distance the
inertia needs. Inputs are checked; then

* a CPU tensor takes the plain version (:mod:`.ref`);
* a CUDA tensor launches the hand-written kernel (``csrc/kmeans_assign.cu``)
  on the current stream, or raises. There is no fallback: a build failure,
  a refused launch or an unsupported input is an error.

float32 and bfloat16 inputs reach the kernel as they are (the arithmetic is
float32, as the reference op casts); any other float type is cast to
float32 first. The kernel takes batch and row strides, so a batch axis
broadcast with ``expand`` (stride 0) needs no copy; only the last dimension
of each input must be contiguous. ``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.kmeans import ref

MAX_BATCH = 65535  # the kernel's grid puts the batch on gridDim.y
LAUNCHES = 0

_fns: dict = {}


def _kernel(dtype: torch.dtype):
    name = "kmeans_assign_bf16" if dtype == torch.bfloat16 else "kmeans_assign_f32"
    if name not in _fns:
        fn = getattr(_build.load_library("kmeans"), name)
        fn.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return _fns[name]


def _check(x: torch.Tensor, centers: torch.Tensor) -> None:
    for name, t in (("x", x), ("centers", centers)):
        if not torch.is_tensor(t):
            raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be (B, rows, d), got shape {tuple(t.shape)}")
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
    if centers.device != x.device:
        raise ValueError(f"centers are on {centers.device}, x on {x.device}")
    if centers.shape[0] != x.shape[0]:
        raise ValueError(f"batch sizes differ: {x.shape[0]} and {centers.shape[0]}")
    if centers.shape[2] != x.shape[2]:
        raise ValueError(f"centers width {centers.shape[2]} != x width {x.shape[2]}")
    if centers.shape[1] < 1 or x.shape[2] < 1:
        raise ValueError("need at least one center and one feature")
    if not 1 <= x.shape[0] <= MAX_BATCH:
        raise ValueError(f"batch {x.shape[0]} is outside 1..{MAX_BATCH}")


def _launch(x: torch.Tensor, centers: torch.Tensor, want_min: bool):
    global LAUNCHES
    if x.dtype != centers.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        x, centers = x.float(), centers.float()
    if x.stride(2) != 1 or centers.stride(2) != 1:
        raise ValueError("the last dimension of x and centers must be contiguous")
    b, n, d = x.shape
    out = torch.empty((b, n), device=x.device, dtype=torch.int32)
    mind = torch.empty((b, n), device=x.device, dtype=torch.float32) if want_min else None
    if n == 0:
        return out, mind
    fn = _kernel(x.dtype)
    strides = (*x.stride()[:2], *centers.stride()[:2])
    err = _build.call(
        fn,
        x.device,
        x.data_ptr(),
        centers.data_ptr(),
        out.data_ptr(),
        None if mind is None else mind.data_ptr(),
        b,
        n,
        centers.shape[1],
        d,
        *strides,
    )
    if err != 0:
        raise RuntimeError(f"kmeans launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out, mind


def _route(x: torch.Tensor, centers: torch.Tensor, want_min: bool):
    _check(x, centers)
    if x.device.type == "cpu":
        if want_min:
            return ref.kmeans_assign_min_batched(x, centers)
        return ref.kmeans_assign_batched(x, centers), None
    if x.device.type != "cuda":
        raise ValueError(f"no k-means route for device {x.device}")
    return _launch(x, centers, want_min)


def kmeans_assign_batched(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """argmin_c ‖x_{b,i} − μ_{b,c}‖² per batch entry as ONE launch.

    x (B, N, d), centers (B, C, d) → (B, N) int32; ties go to the lowest
    centre index."""
    return _route(x, centers, want_min=False)[0]


def kmeans_assign_min_batched(
    x: torch.Tensor, centers: torch.Tensor
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """As :func:`kmeans_assign_batched`, also returning each row's minimum
    squared distance (B, N) float32 from the same launch."""
    return _route(x, centers, want_min=True)


def kmeans_assign(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """x (N, d), centers (C, d) → (N,) int32: the width-1 case of
    :func:`kmeans_assign_batched`."""
    return kmeans_assign_batched(x[None], centers[None])[0]
